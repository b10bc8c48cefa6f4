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

Several processes train one model with data parallelism
(``roko_tpu/training/loop.py:212-260, 337-460``; ``MeshConfig.dp``, one
process per card, ``parallel/``): each rank reads shard ``rank`` of
``world`` and its local batch is its rows of the global batch, their
concatenation in rank order. A step equals one process's step at the
global batch: the loss divides by the global weight sum, the gradients
are all-reduced as a sum in one flat buffer in parameter order, the loss
and the finite flag are all-reduced before the guard reads them (so every
rank skips or rolls back in lockstep), and each rank draws the dropout
masks of the whole global batch and keeps its rows
(``models.layers.GlobalSlice``). The replicas start from rank 0's
parameters and stay equal; evaluation all-reduces its sums; rank 0 alone
logs and writes checkpoints, and every rank waits for each write before
it goes on.

On a dp x tp x sp grid (``parallel/mesh.py``) the transformer is split
over tp (``parallel/tp.py``) and sp (its columns, ``parallel/ring.py``):
the batch is split over dp only, every rank of a tp x sp block reading
its dp group's rows, and each sp rank sums its columns' log-likelihood
over all ``window_cols`` columns, so the ranks' losses sum to the global
one. The gradient of each parameter is summed over the axes it is
partial over (:func:`reduce_step`); a checkpoint holds the full tensors,
gathered over tp (``training/checkpoint.py``), and a resume cuts them
again, so a grid's checkpoint loads in one process and the other way
round.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from roko_tpu_torch.config import DataConfig, GuardConfig, MeshConfig, ModelConfig, TrainConfig
from roko_tpu_torch.datapipe.dataset import ShardedDataset
from roko_tpu_torch.datapipe.engine import Batch, prefetch
from roko_tpu_torch.datapipe.manifest import crosscheck_corpus, crosscheck_fingerprint
from roko_tpu_torch.infer import resolve_device, use_float32_matmuls
from roko_tpu_torch.models.layers import GlobalSlice
from roko_tpu_torch.models.model import RokoModel
from roko_tpu_torch.parallel import distributed
from roko_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_,
    group_broadcast_,
    group_reduce_,
    make_mesh,
    shard_batch,
)
from roko_tpu_torch.parallel.tp import gather_state_dict, param_specs, shard_state_dict
from roko_tpu_torch.training.checkpoint import (
    CheckpointManager,
    gather_optimizer_state,
    shard_optimizer_state,
)
from roko_tpu_torch.training.guard import RollbackRequested, TrainGuard, guard_line
from roko_tpu_torch.utils.profiling import device_trace


def loss_and_stats(
    logits: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
    w_total: Optional[torch.Tensor] = None, cols: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, correct, total): the mean over real rows (weight ``w``) of
    each row's mean cross-entropy over its columns, the count of correct
    columns of real rows, and the count of their columns. ``w_total``
    replaces ``w.sum()`` as the loss's denominator: a data-parallel rank
    passes the global batch's, so the ranks' losses sum to its loss.
    ``cols`` replaces the row's column count in its mean: an sp rank holds
    a block of the columns and passes the window's count."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, y.long().unsqueeze(-1)).squeeze(-1)
    per_row = -ll.mean(dim=-1) if cols is None else -ll.sum(dim=-1) / cols
    denom = w.sum() if w_total is None else w_total
    loss = (per_row * w).sum() / torch.clamp(denom, min=1.0)
    correct = ((logits.argmax(dim=-1) == y) * w[:, None]).sum()
    total = w.sum() * y.shape[1]
    return loss, correct, total


def split_columns(model: RokoModel, y: torch.Tensor) -> Tuple[torch.Tensor, Optional[int]]:
    """(this rank's columns of the labels ``y``, the window's column count
    when the model computes a block of them, else None)."""
    return (y[:, model.columns], y.shape[1]) if model.column_split else (y, None)


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
    generator: Optional[torch.Generator], mesh: Optional[Mesh] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward and backward in training mode, the gradients left on the
    parameters (float32 in every compute dtype). Returns (loss, finite):
    ``finite`` is a device bool covering the loss and every gradient.

    On a ``mesh`` whose steps reduce (:attr:`Mesh.collective`), ``x``,
    ``y`` and ``w`` are this rank's dp group's rows of the global batch
    and the step is the global batch's: the dropout masks are drawn for
    the global batch (:class:`GlobalSlice`), the loss divides by ``w.sum()``
    summed over dp, and the loss and the gradients are reduced by
    :func:`reduce_step`. Every rank returns the same loss and flag, and
    holds the gradients of its part of the parameters."""
    model.train()
    model.zero_grad(set_to_none=True)
    if mesh is None or not mesh.collective:
        logits = model(x, generator=generator)
        loss, _, _ = loss_and_stats(logits, y, w)
        loss.backward()
        flags = [torch.isfinite(loss)]
        flags += [torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None]
        return loss.detach(), torch.stack(flags).all()
    y, cols = split_columns(model, y)
    if generator is not None:
        generator = GlobalSlice(generator, mesh.d, mesh.dp,
                                *((mesh.s, mesh.sp) if cols is not None else (0, 1)))
    logits = model(x, generator=generator)
    w_total = group_reduce_(w.sum().reshape(1), mesh.dp_group)
    loss, _, _ = loss_and_stats(logits, y, w, w_total=w_total[0], cols=cols)
    loss.backward()
    return reduce_step(model, loss.detach(), mesh)


def reduce_step(model: RokoModel, loss: torch.Tensor, mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum this rank's loss and gradients over the axes they are partial
    over, one flat buffer per group in parameter order, and return
    (global loss, finite). The transformer's are partial over dp (rows) and
    sp (columns): summed over the dp x sp group; then the loss and the
    gradient of each parameter replicated over tp are tp rank 0's (a
    broadcast: equal on the CPU, but on a card the embedding's backward
    sums with atomics, and tp peers would drift apart in the last bits).
    The gru and lingru kinds' are partial over dp only: summed over dp,
    then the first rank's of the tp x sp block. The finite flag is a min
    over the whole run, so every rank skips or rolls back in step."""
    named = [(n, p) for n, p in model.named_parameters() if p.grad is not None]
    flat = torch.cat([loss.reshape(1)] + [p.grad.reshape(-1) for _, p in named])
    d, t, s = mesh.d, mesh.t, mesh.s
    if model.cfg.kind == "transformer":
        group_reduce_(flat, mesh.dp_sp_group)
        if mesh.tp > 1:
            specs = param_specs(model.cfg, dict(named))
            spans, offset = [(0, 1)], 1
            for n, p in named:
                if specs[n] is None:
                    spans.append((offset, offset + p.numel()))
                offset += p.numel()
            rep = group_broadcast_(torch.cat([flat[a:b] for a, b in spans]), mesh.tp_group,
                                   mesh.rank_of(d, 0, s))
            at = 0
            for a, b in spans:
                flat[a:b] = rep[at : at + b - a]
                at += b - a
    else:
        group_reduce_(flat, mesh.dp_group)
        if mesh.tp > 1:
            group_broadcast_(flat, mesh.tp_group, mesh.rank_of(d, 0, s))
        if mesh.sp > 1:
            group_broadcast_(flat, mesh.sp_group, mesh.rank_of(d, t, 0))
    offset = 1
    for _, p in named:
        p.grad.copy_(flat[offset : offset + p.numel()].view_as(p.grad))
        offset += p.numel()
    finite = all_reduce_(mesh, torch.isfinite(flat).all().to(torch.float32).reshape(1), "min")
    return flat[0], finite[0] > 0


def replicate_(model: RokoModel, mesh: Mesh) -> None:
    """Make every rank's parameters and buffers, in place, those of the
    first rank holding the same part: rank 0's for a tensor replicated
    over tp, the first rank of the dp x sp group for a tp part."""
    if not mesh.collective:
        return
    state = model.state_dict()
    specs = param_specs(model.cfg, state)
    with torch.no_grad():
        for name, t in state.items():
            if specs[name] is None or mesh.tp == 1:
                group_broadcast_(t, mesh.group, 0)
            else:
                group_broadcast_(t, mesh.dp_sp_group, mesh.rank_of(0, mesh.t, 0))


def params_finite(model: torch.nn.Module) -> bool:
    return bool(torch.stack([torch.isfinite(p).all() for p in model.parameters()]).all())


@torch.no_grad()
def evaluate(model: RokoModel, dataset, batch_size: int,
             device: torch.device, mesh: Optional[Mesh] = None) -> Tuple[float, float]:
    """(column accuracy, mean per-window loss) over ``dataset`` in stored
    order; leaves the model in eval mode. On a ``mesh``, each rank reads
    the same batches of ``batch_size`` and evaluates its dp group's rows
    of each (its columns of them, when the model splits the columns), and
    the sums are reduced over the ranks that hold different parts."""
    model.eval()
    correct = torch.zeros((), device=device)
    total = torch.zeros((), device=device)
    loss_sum = torch.zeros((), device=device)
    rows = torch.zeros((), device=device)
    for batch in dataset.batches(batch_size, pad_to=batch_size):
        if mesh is not None:
            batch = shard_batch(mesh, batch)
        x, y, w = to_device(batch, device)
        y, cols = split_columns(model, y)
        loss, c, t = loss_and_stats(model(x), y, w, cols=cols)
        loss_sum += loss * w.sum()
        if not model.column_split or mesh.s == 0:  # a row counts once over its blocks
            rows += w.sum()
        correct += c
        total += t
    if mesh is not None and mesh.collective:
        group = mesh.dp_sp_group if model.column_split else mesh.dp_group
        sums = group_reduce_(torch.stack([correct, total, loss_sum, rows]), group)
        correct, total, loss_sum, rows = sums.unbind()
    acc = float(correct / torch.clamp(total, min=1.0))
    return acc, float(loss_sum / torch.clamp(rows, min=1.0))


def _step_seed(seed: int, rollbacks: int, step: int) -> int:
    a, b = np.random.SeedSequence([seed, rollbacks, step]).generate_state(2, np.uint32)
    return (int(a) << 32) | int(b)


def _crosscheck(ds) -> None:
    """Refuse a run whose ranks read different corpora (no-op in one
    process): the manifest's fingerprint, or a dataset object's."""
    manifest = getattr(ds, "manifest", None)
    if manifest is not None:
        crosscheck_fingerprint(manifest)
    elif hasattr(ds, "fingerprint"):
        crosscheck_corpus(ds.fingerprint(), 1, len(ds), type(ds).__name__)


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
    mesh_cfg: MeshConfig = MeshConfig(),
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
    ``trace_dir`` writes a device trace of the first trained epoch.

    In a run of several processes (``parallel.distributed.initialize``
    from ``ROKO_*``, called here) every rank calls this with the same
    arguments; ``mesh_cfg``'s dp x tp x sp grid must cover them all. The
    data shards are the dp groups."""
    check_trainable(model_cfg)
    dev = resolve_device(device)
    distributed.initialize(device=dev)
    dev = distributed.device_of_rank(dev)
    mesh = make_mesh(mesh_cfg)
    #: the dp groups, each reading one shard of the corpus
    nproc = mesh.dp
    if not distributed.is_primary():
        log = lambda s: None  # noqa: E731 (rank 0 alone logs)
    use_float32_matmuls()
    tcfg, gcfg, dcfg = train_cfg, guard_cfg, data_cfg
    seed = tcfg.seed

    # -- the data plane: one process reads shard shard_id of shards; in a
    # run of several processes the shards are the dp groups
    shards = dcfg.shards if dcfg.shards > 0 else nproc
    shard_id = dcfg.shard_id if dcfg.shard_id >= 0 else mesh.d
    data_seed = dcfg.seed if dcfg.seed >= 0 else seed
    if nproc > 1:
        if shards != nproc:
            raise ValueError(f"--data-shards {shards} on a run of {nproc} dp groups: shards "
                             "must equal the dp size (one shard per dp group)")
        if shard_id != mesh.d:
            raise ValueError(f"--data-shard-id {shard_id} conflicts with this process's dp "
                             f"place {mesh.d} of {nproc}; leave it at -1 (auto)")
    if tcfg.batch_size % shards:
        raise ValueError(f"batch_size {tcfg.batch_size} not divisible by {shards} data shards")
    local_bs = tcfg.batch_size // shards
    #: the rows of one step, over every rank
    step_rows = local_bs * nproc
    spec = dict(num_shards=shards, shard_id=shard_id, seed=data_seed,
                block_size=dcfg.block_size, mix_blocks=dcfg.mix_blocks,
                prefetch_blocks=dcfg.input_prefetch)
    if isinstance(train_data, str):
        train_ds = ShardedDataset(train_data, **spec, preload=tcfg.in_memory,
                                  manifest_path=dcfg.manifest, log=log)
    else:
        train_ds = train_data.sharded(**spec)
    _crosscheck(train_ds)  # no-op in one process
    if shards > 1 and train_ds.num_blocks < 4 * shards:
        log(f"WARNING: only {train_ds.num_blocks} span block(s) for {shards} data shards: "
            "shard balance is block-granular; lower --data-block-size (or grow the "
            "corpus) so that every shard owns several blocks")
    val_ds = (ShardedDataset(val_data, seed=data_seed, block_size=dcfg.block_size,
                             prefetch_blocks=dcfg.input_prefetch, preload=tcfg.in_memory)
              if isinstance(val_data, str) else val_data)
    if val_ds is not None:
        # ranks that disagree on the val corpus would take different
        # early-stop and guard branches: a hang, not a metric blip
        _crosscheck(val_ds)
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
    # (the shard id is pinned in one process only: the ranks share one file)
    pipe = {"shards": shards, "shard_id": shard_id if nproc == 1 else -1, "seed": data_seed,
            "block_size": dcfg.block_size, "mix": dcfg.mix_blocks, "local_bs": local_bs,
            "val_ppm": holdout_ppm, "fingerprint": corpus_fp}
    steps_per_epoch = max(1, train_ds.steps_per_epoch(local_bs))
    manager = CheckpointManager(out_dir, keep=tcfg.keep_checkpoints, log=log)
    guard = TrainGuard(gcfg, log) if gcfg.enabled else None

    def place(batch: Batch) -> Tuple[torch.Tensor, ...]:
        return to_device(batch, dev)

    def write(save: Callable[[Dict[str, Any]], None], make: Callable[[], Dict[str, Any]]) -> None:
        """Every rank makes the state (its full tensors are gathered over
        tp, a collective), rank 0 writes it, and every rank waits until it
        has."""
        st = make()
        if distributed.is_primary():
            save(st)
        distributed.barrier()

    def run(attempt: int) -> TrainResult:
        history: List[Dict[str, float]] = []
        if init_params is not None:
            model = RokoModel(model_cfg, mesh=mesh)
            model.load_state_dict(shard_state_dict(model_cfg, init_params, mesh), strict=True)
        else:
            model = RokoModel(model_cfg, torch.Generator().manual_seed(seed), mesh=mesh)
        model.to(dev).train()
        optimizer = make_optimizer(model, tcfg.lr)
        names = [n for n, _ in model.named_parameters()]  # the optimizer's order
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
            model.load_state_dict(shard_state_dict(model_cfg, restored["model"], mesh),
                                  strict=True)
            optimizer.load_state_dict(shard_optimizer_state(
                model_cfg, restored["optimizer"], names, mesh))
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
        replicate_(model, mesh)
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
            return {"model": gather_state_dict(model_cfg, model.state_dict(), mesh),
                    "optimizer": gather_optimizer_state(model_cfg, optimizer.state_dict(),
                                                        names, mesh),
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
            traced = trace_dir if first and distributed.is_primary() else None
            with device_trace(traced, dev), contextlib.closing(
                    prefetch(batches, tcfg.prefetch, place)) as staged:
                for x, y, w in staged:
                    drop_gen.manual_seed(_step_seed(seed, jitter, hstep))
                    loss, finite = grad_step(model, x, y, w, drop_gen, mesh)
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
                            f"({rate * step_rows:.0f} windows/s, eta {eta:.0f}s)")
                    # the epoch's last batch skips the mid save: the
                    # epoch-boundary save follows at once
                    if (gcfg.save_every_steps and n_batches % gcfg.save_every_steps == 0
                            and n_batches < steps_per_epoch):
                        write(manager.save_latest, lambda: state(epoch - 1, data_state(
                            epoch, n_batches, n_applied, running)))
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            train_loss = float(running) / max(n_applied, 1)
            dt = time.perf_counter() - t0
            trained = n_batches - skip

            # with no val set, the whole corpus: the metric does not depend
            # on the shard spec
            eval_ds = val_ds if val_ds is not None else train_ds.unsharded()
            acc, vloss = evaluate(model, eval_ds, tcfg.batch_size, dev, mesh)
            note = f" [{guard.summary()}]" if guard is not None and guard.events else ""
            log(f"epoch {epoch}: train_loss {train_loss:.4f} val_acc {acc:.5f} "
                f"val_loss {vloss:.4f} ({dt:.1f}s, {n_batches} steps, "
                f"{trained * step_rows / max(dt, 1e-9):.0f} windows/s)" + note)
            history.append(dict(
                epoch=epoch, train_loss=train_loss, val_acc=acc, val_loss=vloss,
                seconds=dt, steps=trained, windows_per_s=trained * step_rows / max(dt, 1e-9),
            ))
            if acc > best_acc:
                best_acc, bad_epochs = acc, 0
            else:
                bad_epochs += 1
            write(lambda st: manager.save(hstep, st, acc),
                  lambda: state(epoch, data_state(epoch + 1, 0, 0, 0.0)))
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
