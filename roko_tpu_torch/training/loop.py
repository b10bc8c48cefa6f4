"""Train and eval steps and the epoch loop of the port.

Counterpart of ``roko_tpu/training/loop.py`` for one process on one
device: Adam (``torch.optim.Adam(lr, eps=1e-8)``, the math of
``optax.adam``), cross-entropy over the 5 classes at each of the 90
window columns (:63-80), per-epoch validation accuracy, early stopping on
it with patience, best-k checkpoints at epoch boundaries, resume from
``latest``, and the guard (:132-193, :786-808): each step computes the
gradients first, the host checks the loss and their finiteness, and only
a good step's update is applied; repeated bad steps roll back to the last
good checkpoint.

On a CUDA device every step runs the recurrence through its kernels:
``gru_fwd`` and ``gru_bwd`` (``models/fused_gru.py``) for ``kind="gru"``,
``lingru_fwd`` and ``lingru_bwd`` (``models/fused_lingru.py``) for
``kind="lingru"``; with ``compute_dtype="bfloat16"`` their bf16 twins
(``gru_fwd_bf16`` and ``gru_bwd_bf16``, ``lingru_fwd_bf16`` and
``lingru_bwd_bf16``), evaluation included. The parameters, their
gradients and Adam stay float32 in either dtype, as in the reference
(params cast inside ``apply``). Dropout masks of step ``k`` come
from a generator seeded by (seed, rollbacks, k), so a resumed run draws
the masks an uninterrupted one would have drawn.

Not ported yet: mid-epoch checkpoints (``save_every_steps``), several
processes or devices, and device tracing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from roko_tpu_torch.config import GuardConfig, ModelConfig, TrainConfig
from roko_tpu_torch.infer import resolve_device, use_float32_matmuls
from roko_tpu_torch.models.model import RokoModel
from roko_tpu_torch.training.checkpoint import CheckpointManager
from roko_tpu_torch.training.data import HDF5Dataset, epoch_rng
from roko_tpu_torch.training.engine import Batch
from roko_tpu_torch.training.guard import RollbackRequested, TrainGuard, guard_line


def loss_and_stats(
    logits: torch.Tensor, y: torch.Tensor, w: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, correct, total): the mean over real rows (weight ``w``) of
    each row's mean cross-entropy over its columns, the count of correct
    columns of real rows, and the count of their columns."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, y.long().unsqueeze(-1)).squeeze(-1)
    per_row = -ll.mean(dim=-1)
    loss = (per_row * w).sum() / torch.clamp(w.sum(), min=1.0)
    correct = ((logits.argmax(dim=-1) == y) * w[:, None]).sum()
    total = w.sum() * y.shape[1]
    return loss, correct, total


def make_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def to_device(batch: Batch, device: torch.device) -> Tuple[torch.Tensor, ...]:
    x, y, w = batch
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device, non_blocking=True)
        for a in (x, y, w)
    )


def grad_step(
    model: RokoModel, x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
    generator: Optional[torch.Generator],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward and backward in training mode, the gradients left on the
    parameters (float32 in every compute dtype). Returns (loss, finite):
    ``finite`` is a device bool covering the loss and every gradient."""
    model.train()
    model.zero_grad(set_to_none=True)
    logits = model(x, generator=generator)
    loss, _, _ = loss_and_stats(logits, y, w)
    loss.backward()
    flags = [torch.isfinite(loss)]
    flags += [torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None]
    return loss.detach(), torch.stack(flags).all()


def params_finite(model: torch.nn.Module) -> bool:
    return bool(torch.stack([torch.isfinite(p).all() for p in model.parameters()]).all())


@torch.no_grad()
def evaluate(model: RokoModel, dataset, batch_size: int,
             device: torch.device) -> Tuple[float, float]:
    """(column accuracy, mean per-window loss) over ``dataset`` in stored
    order; leaves the model in eval mode."""
    model.eval()
    correct = torch.zeros((), device=device)
    total = torch.zeros((), device=device)
    loss_sum = torch.zeros((), device=device)
    rows = torch.zeros((), device=device)
    for batch in dataset.batches(batch_size):
        x, y, w = to_device(batch, device)
        loss, c, t = loss_and_stats(model(x), y, w)
        loss_sum += loss * w.sum()
        rows += w.sum()
        correct += c
        total += t
    acc = float(correct / torch.clamp(total, min=1.0))
    return acc, float(loss_sum / torch.clamp(rows, min=1.0))


def _step_seed(seed: int, rollbacks: int, step: int) -> int:
    a, b = np.random.SeedSequence([seed, rollbacks, step]).generate_state(2, np.uint32)
    return (int(a) << 32) | int(b)


@dataclasses.dataclass
class TrainResult:
    model: RokoModel
    #: steps taken, skipped ones included
    step: int
    #: one entry per trained epoch: epoch, train_loss, val_acc, val_loss,
    #: seconds, steps, windows_per_s
    history: List[Dict[str, float]]
    guard_counters: Dict[str, int]


def check_trainable(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` trains: full precision weights, computing in
    float32 or bfloat16. int8 is a conversion at load
    (``roko_tpu/training/loop.py:341-349``)."""
    if cfg.quantize is not None:
        raise ValueError(
            f"quantize={cfg.quantize!r} is an inference-only "
            "conversion: train full precision, then quantize at load "
            "time (--quantize int8 on inference/polish)"
        )


def train(
    train_data: Union[str, Any],
    out_dir: str,
    val_data: Union[str, Any, None] = None,
    *,
    model_cfg: ModelConfig = ModelConfig(),
    train_cfg: TrainConfig = TrainConfig(),
    guard_cfg: GuardConfig = GuardConfig(),
    device: Union[str, torch.device] = "cuda",
    resume: bool = True,
    init_params: Optional[Dict[str, torch.Tensor]] = None,
    log: Callable[[str], None] = print,
) -> TrainResult:
    """Train on ``train_data`` (a training HDF5 file or directory, or a
    dataset object such as :class:`~roko_tpu_torch.training.data.InMemoryDataset`)
    and write checkpoints to ``out_dir``; ``val_data`` likewise, or
    ``train_cfg.val_fraction`` holds windows out. A fresh run starts from
    ``init_params`` (a reference-layout state_dict) or from an init drawn
    with ``train_cfg.seed``; with ``resume`` it continues from the
    newest checkpoint in ``out_dir`` that verifies. Refuses int8 configs
    (:func:`check_trainable`); a bfloat16 one trains in bf16 compute and
    writes float32 checkpoints that load in any mode."""
    check_trainable(model_cfg)
    dev = resolve_device(device)
    use_float32_matmuls()
    tcfg, gcfg = train_cfg, guard_cfg
    seed = tcfg.seed
    bs = tcfg.batch_size

    train_ds = HDF5Dataset(train_data) if isinstance(train_data, str) else train_data
    val_ds = HDF5Dataset(val_data) if isinstance(val_data, str) else val_data
    holdout_ppm = 0
    if val_ds is None and tcfg.val_fraction > 0:
        holdout_ppm = int(round(tcfg.val_fraction * 1e6))
        train_ds, val_ds = train_ds.split_holdout(tcfg.val_fraction, seed)
        log(f"held out {len(val_ds)} of {len(train_ds) + len(val_ds)} "
            "windows for validation (--val-fraction)")
    log(f"train windows: {len(train_ds)}"
        + (f", val windows: {len(val_ds)}" if val_ds is not None else " (no val set)"))
    if val_ds is None:
        log("no val set: early stopping disabled, running all epochs")
    pipe = {"seed": seed, "val_ppm": holdout_ppm, "fingerprint": train_ds.fingerprint()}
    steps_per_epoch = max(1, train_ds.steps_per_epoch(bs))
    manager = CheckpointManager(out_dir, keep=tcfg.keep_checkpoints, log=log)
    guard = TrainGuard(gcfg, log) if gcfg.enabled else None

    def run(attempt: int) -> TrainResult:
        history: List[Dict[str, float]] = []
        if init_params is not None:
            model = RokoModel(model_cfg)
            model.load_state_dict(init_params, strict=True)
        else:
            model = RokoModel(model_cfg, torch.Generator().manual_seed(seed))
        model.to(dev).train()
        optimizer = make_optimizer(model, tcfg.lr)
        hstep, start_epoch, best_acc, bad_epochs, rollbacks = 0, 0, -1.0, 0, 0
        restored = manager.restore_latest() if (resume or attempt > 0) else None
        if restored is not None:
            dstate = restored["data_state"]
            if dstate["pipe"] != pipe:
                diff = ", ".join(f"{k}: {dstate['pipe'].get(k)} -> {v}"
                                 for k, v in pipe.items() if dstate["pipe"].get(k) != v)
                raise RuntimeError(
                    "refusing to resume: the data stream changed since the "
                    f"checkpoint ({diff}); restore the original seed/corpus or "
                    "start fresh with --no-resume")
            model.load_state_dict(restored["model"], strict=True)
            optimizer.load_state_dict(restored["optimizer"])
            hstep = int(restored["step"])
            start_epoch = int(dstate["epoch"])
            best_acc = float(restored["early_stop"]["best_acc"])
            bad_epochs = int(restored["early_stop"]["bad_epochs"])
            rollbacks = int(dstate["rollbacks"])
            if guard is not None and dstate["guard"] is not None:
                guard.load_state(dstate["guard"])
            log(f"resumed from step {hstep} (epoch {start_epoch}, best val_acc "
                f"{best_acc:.5f}, {bad_epochs} stale epochs)")
        # a rollback re-seeds the dropout stream, so a transient fault does
        # not replay on the same masks; a resume keeps the stream it had
        jitter = rollbacks + attempt
        drop_gen = torch.Generator(device=dev)

        for epoch in range(start_epoch, tcfg.epochs):
            t0 = time.perf_counter()
            running = torch.zeros((), device=dev)
            n_applied = n_batches = 0
            for batch in train_ds.batches(bs, rng=epoch_rng(seed, epoch)):
                x, y, w = to_device(batch, dev)
                drop_gen.manual_seed(_step_seed(seed, jitter, hstep))
                loss, finite = grad_step(model, x, y, w, drop_gen)
                if guard is None:
                    optimizer.step()
                    running += loss
                    n_applied += 1
                else:
                    loss_h, finite_h = torch.stack([loss, finite.to(loss.dtype)]).tolist()
                    if guard.check(hstep, loss_h, bool(finite_h)):
                        optimizer.step()
                        if not params_finite(model):
                            guard.params_nonfinite(hstep)
                        running += loss
                        n_applied += 1
                hstep += 1
                n_batches += 1
                if tcfg.log_every_steps and n_batches % tcfg.log_every_steps == 0:
                    rate = n_batches / max(time.perf_counter() - t0, 1e-9)
                    eta = (steps_per_epoch - n_batches) / max(rate, 1e-9)
                    log(f"  epoch {epoch} step {n_batches}/{steps_per_epoch} "
                        f"({rate * bs:.0f} windows/s, eta {eta:.0f}s)")
            train_loss = float(running) / max(n_applied, 1)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0

            acc, vloss = evaluate(model, val_ds if val_ds is not None else train_ds, bs, dev)
            note = f" [{guard.summary()}]" if guard is not None and guard.events else ""
            log(f"epoch {epoch}: train_loss {train_loss:.4f} val_acc {acc:.5f} "
                f"val_loss {vloss:.4f} ({dt:.1f}s, {n_batches} steps, "
                f"{n_batches * bs / max(dt, 1e-9):.0f} windows/s)" + note)
            history.append(dict(
                epoch=epoch, train_loss=train_loss, val_acc=acc, val_loss=vloss,
                seconds=dt, steps=n_batches, windows_per_s=n_batches * bs / max(dt, 1e-9),
            ))
            if acc > best_acc:
                best_acc, bad_epochs = acc, 0
            else:
                bad_epochs += 1
            manager.save(hstep, {
                "model": model.state_dict(),
                "optimizer": optimizer.state_dict(),
                "step": hstep,
                "epoch": epoch,
                "early_stop": {"best_acc": best_acc, "bad_epochs": bad_epochs},
                "data_state": {
                    "epoch": epoch + 1,
                    "rollbacks": jitter,
                    "guard": guard.state_dict() if guard is not None else None,
                    "pipe": pipe,
                },
            }, acc)
            if val_ds is not None and bad_epochs >= tcfg.patience:
                log(f"early stop at epoch {epoch} (best val_acc {best_acc:.5f})")
                break
        if guard is not None and guard.events:
            log(guard.summary())
        return TrainResult(model, hstep, history,
                           dict(guard.counters) if guard is not None else {})

    attempt = 0
    while True:
        try:
            return run(attempt)
        except RollbackRequested as rb:
            if not manager.has_checkpoint():
                raise RuntimeError(
                    f"guard requested rollback ({rb.reason} at step {rb.step}) but "
                    "no checkpoint exists yet; cannot recover a run that failed "
                    "before its first save") from rb
            guard.note_rollback()
            attempt += 1
            if attempt > gcfg.max_rollbacks:
                raise RuntimeError(
                    f"giving up after {gcfg.max_rollbacks} rollbacks (last: "
                    f"{rb.reason} at step {rb.step}); the fault replays "
                    "deterministically: inspect the data or config") from rb
            log(guard_line("rollback", reason=rb.reason, step=rb.step,
                           rollbacks=attempt, max_rollbacks=gcfg.max_rollbacks))
