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
``lingru_bwd_bf16``), evaluation included; ``kind="transformer"`` runs
plain matrix products and launches none of them. The parameters, their
gradients and Adam stay float32 in either dtype, as in the reference
(params cast inside ``apply``). Dropout masks of step ``k`` come
from a generator seeded by (seed, rollbacks, k), so a resumed run draws
the masks an uninterrupted one would have drawn.

The data plane follows ``roko_tpu/training/loop.py:354-460``: the corpus
is a :class:`~roko_tpu_torch.datapipe.ShardedDataset` (preloaded, or
streamed span by span with ``TrainConfig.in_memory=False``), or a dataset
object seen through the same shard spec; ``DataConfig`` gives the shards
(the step's batch is ``batch_size / shards``), the stream seed, block and
mix sizes, readahead and a pinned manifest; a producer thread stages
``TrainConfig.prefetch`` batches on the device. With
``GuardConfig.save_every_steps`` the loop also saves ``latest`` inside an
epoch with the data position (:500-900), and a resume fast-forwards to
the next batch; a resume refuses a changed shard spec, stream seed, block
or mix size, val fraction or corpus, and a batch size changed inside an
epoch. ``trace_dir`` traces the first trained epoch
(``utils/profiling.device_trace``).

Not ported yet: several processes or devices (ROADMAP queue item A8).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from roko_tpu_torch.config import DataConfig, GuardConfig, ModelConfig, TrainConfig
from roko_tpu_torch.datapipe.dataset import ShardedDataset
from roko_tpu_torch.datapipe.engine import Batch, prefetch
from roko_tpu_torch.infer import resolve_device, use_float32_matmuls
from roko_tpu_torch.models.model import RokoModel
from roko_tpu_torch.training.checkpoint import CheckpointManager
from roko_tpu_torch.training.guard import RollbackRequested, TrainGuard, guard_line
from roko_tpu_torch.utils.profiling import device_trace


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
    for batch in dataset.batches(batch_size, pad_to=batch_size):
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


def _resume_refusal(saved: Dict[str, Any], now: Dict[str, Any], mid_epoch: bool) -> Optional[str]:
    """The changed fields of the data-stream spec, or None. The batch size
    counts only inside an epoch: the saved position is in batches, and at
    an epoch boundary it is 0 in any unit."""
    keys = [k for k in now if k in saved and (mid_epoch or k != "local_bs")]
    diff = ", ".join(f"{k}: {saved[k]} -> {now[k]}" for k in keys if saved[k] != now[k])
    return diff or None


def train(
    train_data: Union[str, Any],
    out_dir: str,
    val_data: Union[str, Any, None] = None,
    *,
    model_cfg: ModelConfig = ModelConfig(),
    train_cfg: TrainConfig = TrainConfig(),
    guard_cfg: GuardConfig = GuardConfig(),
    data_cfg: DataConfig = DataConfig(),
    device: Union[str, torch.device] = "cuda",
    resume: bool = True,
    init_params: Optional[Dict[str, torch.Tensor]] = None,
    trace_dir: Optional[str] = None,
    log: Callable[[str], None] = print,
) -> TrainResult:
    """Train on ``train_data`` (a training HDF5 file or directory, or a
    dataset object such as :class:`~roko_tpu_torch.training.data.InMemoryDataset`)
    and write checkpoints to ``out_dir``; ``val_data`` likewise, or
    ``train_cfg.val_fraction`` holds windows out. A fresh run starts from
    ``init_params`` (a reference-layout state_dict) or from an init drawn
    with ``train_cfg.seed``; with ``resume`` it continues from the
    newest checkpoint in ``out_dir`` that verifies, inside an epoch too.
    Refuses int8 configs (:func:`check_trainable`); a bfloat16 one trains
    in bf16 compute and writes float32 checkpoints that load in any mode.
    ``trace_dir`` writes a device trace of the first trained epoch."""
    check_trainable(model_cfg)
    dev = resolve_device(device)
    use_float32_matmuls()
    tcfg, gcfg, dcfg = train_cfg, guard_cfg, data_cfg
    seed = tcfg.seed

    # -- the data plane: one process reads shard shard_id of shards
    shards = dcfg.shards if dcfg.shards > 0 else 1
    shard_id = dcfg.shard_id if dcfg.shard_id >= 0 else 0
    data_seed = dcfg.seed if dcfg.seed >= 0 else seed
    if tcfg.batch_size % shards:
        raise ValueError(f"batch_size {tcfg.batch_size} not divisible by {shards} data shards")
    local_bs = tcfg.batch_size // shards
    spec = dict(num_shards=shards, shard_id=shard_id, seed=data_seed,
                block_size=dcfg.block_size, mix_blocks=dcfg.mix_blocks,
                prefetch_blocks=dcfg.input_prefetch)
    if isinstance(train_data, str):
        train_ds = ShardedDataset(train_data, **spec, preload=tcfg.in_memory,
                                  manifest_path=dcfg.manifest, log=log)
    else:
        train_ds = train_data.sharded(**spec)
    if shards > 1 and train_ds.num_blocks < 4 * shards:
        log(f"WARNING: only {train_ds.num_blocks} span block(s) for {shards} data shards: "
            "shard balance is block-granular; lower --data-block-size (or grow the "
            "corpus) so that every shard owns several blocks")
    val_ds = (ShardedDataset(val_data, seed=data_seed, block_size=dcfg.block_size,
                             prefetch_blocks=dcfg.input_prefetch, preload=tcfg.in_memory)
              if isinstance(val_data, str) else val_data)
    corpus_fp = train_ds.fingerprint()
    holdout_ppm = 0
    if val_ds is None and tcfg.val_fraction > 0:
        holdout_ppm = int(round(tcfg.val_fraction * 1e6))
        train_ds, val_ds = train_ds.split_holdout(tcfg.val_fraction, data_seed)
        log(f"held out {len(val_ds)} of {len(train_ds) + len(val_ds)} "
            "windows for validation (--val-fraction)")
    log(f"train windows: {len(train_ds)}"
        + (f", val windows: {len(val_ds)}" if val_ds is not None else " (no val set)")
        + (f" [shard {shard_id}/{shards}: {train_ds.local_rows()} local rows, corpus "
           f"{corpus_fp[:12]}]" if shards > 1 else ""))
    if val_ds is None:
        log("no val set: early stopping disabled, running all epochs")
    # what the epoch stream is a pure function of; a resume refuses a change
    pipe = {"shards": shards, "shard_id": shard_id, "seed": data_seed,
            "block_size": dcfg.block_size, "mix": dcfg.mix_blocks, "local_bs": local_bs,
            "val_ppm": holdout_ppm, "fingerprint": corpus_fp}
    steps_per_epoch = max(1, train_ds.steps_per_epoch(local_bs))
    manager = CheckpointManager(out_dir, keep=tcfg.keep_checkpoints, log=log)
    guard = TrainGuard(gcfg, log) if gcfg.enabled else None

    def place(batch: Batch) -> Tuple[torch.Tensor, ...]:
        return to_device(batch, dev)

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
        start_batch, start_applied, loss_sum = 0, 0, 0.0
        restored = manager.restore_latest() if (resume or attempt > 0) else None
        if restored is not None:
            dstate = restored["data_state"]
            saved = dstate["pipe"]
            start_batch = int(dstate.get("batch", 0))
            if "shards" in saved:
                diff = _resume_refusal(saved, pipe, start_batch > 0)
            else:  # the layout before the data plane: seed, holdout, corpus digest
                diff = _resume_refusal(saved, {
                    "seed": data_seed, "val_ppm": holdout_ppm,
                    "fingerprint": train_ds.legacy_fingerprint()}, False)
            if diff:
                raise RuntimeError(
                    "refusing to resume: the data-stream spec changed since the "
                    f"checkpoint ({diff}); the stream would diverge from the trained "
                    "prefix: restore the original sharding, seed and corpus, or start "
                    "fresh with --no-resume")
            model.load_state_dict(restored["model"], strict=True)
            optimizer.load_state_dict(restored["optimizer"])
            hstep = int(restored["step"])
            start_epoch = int(dstate["epoch"])
            start_applied = int(dstate.get("applied", 0))
            loss_sum = dstate.get("loss_sum", 0.0)
            best_acc = float(restored["early_stop"]["best_acc"])
            bad_epochs = int(restored["early_stop"]["bad_epochs"])
            gstate = dstate["guard"]
            rollbacks = int(dstate["rollbacks"] if "rollbacks" in dstate
                            else gstate["rollbacks"])
            if guard is not None and gstate is not None:
                guard.load_state(gstate)
            log(f"resumed from step {hstep} (epoch {start_epoch}, batch {start_batch}, "
                f"best val_acc {best_acc:.5f}, {bad_epochs} stale epochs)")
        # a rollback re-seeds the dropout stream, so a transient fault does
        # not replay on the same masks; a resume keeps the stream it had
        jitter = rollbacks + attempt
        drop_gen = torch.Generator(device=dev)

        def data_state(epoch: int, batch: int, applied: int, running) -> Dict[str, Any]:
            g = guard.state_dict() if guard is not None else {
                "ema": float("nan"), "var": 0.0, "good_steps": 0, "consecutive_bad": 0}
            return {"epoch": epoch, "batch": batch, "applied": applied,
                    "loss_sum": torch.as_tensor(running).detach().cpu(),
                    "guard": {**g, "rollbacks": jitter}, "pipe": pipe}

        def state(epoch: int, dstate: Dict[str, Any]) -> Dict[str, Any]:
            return {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                    "step": hstep, "epoch": epoch,
                    "early_stop": {"best_acc": best_acc, "bad_epochs": bad_epochs},
                    "data_state": dstate}

        for epoch in range(start_epoch, tcfg.epochs):
            t0 = time.perf_counter()
            skip = start_batch if epoch == start_epoch else 0
            # epoch e's stream, fast-forwarded to batch `skip` without
            # reading the skipped blocks; the last batch padded
            batches = train_ds.iterator(epoch, local_bs, pad_to=local_bs, start_batch=skip)
            first = epoch == start_epoch
            running = torch.as_tensor(loss_sum if first else 0.0, dtype=torch.float32).to(dev)
            n_applied = start_applied if first else 0
            n_batches = skip
            with device_trace(trace_dir if first else None, dev), contextlib.closing(
                    prefetch(batches, tcfg.prefetch, place)) as staged:
                for x, y, w in staged:
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
                        rate = (n_batches - skip) / max(time.perf_counter() - t0, 1e-9)
                        eta = (steps_per_epoch - n_batches) / max(rate, 1e-9)
                        log(f"  epoch {epoch} step {n_batches}/{steps_per_epoch} "
                            f"({rate * local_bs:.0f} windows/s, eta {eta:.0f}s)")
                    # the epoch's last batch skips the mid save: the
                    # epoch-boundary save follows at once
                    if (gcfg.save_every_steps and n_batches % gcfg.save_every_steps == 0
                            and n_batches < steps_per_epoch):
                        manager.save_latest(state(epoch - 1, data_state(
                            epoch, n_batches, n_applied, running)))
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            train_loss = float(running) / max(n_applied, 1)
            dt = time.perf_counter() - t0
            trained = n_batches - skip

            # with no val set, the whole corpus: the metric does not depend
            # on the shard spec
            eval_ds = val_ds if val_ds is not None else train_ds.unsharded()
            acc, vloss = evaluate(model, eval_ds, tcfg.batch_size, dev)
            note = f" [{guard.summary()}]" if guard is not None and guard.events else ""
            log(f"epoch {epoch}: train_loss {train_loss:.4f} val_acc {acc:.5f} "
                f"val_loss {vloss:.4f} ({dt:.1f}s, {n_batches} steps, "
                f"{trained * local_bs / max(dt, 1e-9):.0f} windows/s)" + note)
            history.append(dict(
                epoch=epoch, train_loss=train_loss, val_acc=acc, val_loss=vloss,
                seconds=dt, steps=trained, windows_per_s=trained * local_bs / max(dt, 1e-9),
            ))
            if acc > best_acc:
                best_acc, bad_epochs = acc, 0
            else:
                bad_epochs += 1
            manager.save(hstep, state(epoch, data_state(epoch + 1, 0, 0, 0.0)), acc)
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
