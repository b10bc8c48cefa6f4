"""Inference and consensus stitching: the port's main path.

Counterpart of ``roko_tpu/infer.py`` (``VoteBoard`` :163,
``run_inference`` :401, ``polish_to_fasta`` :599; in a run of several
processes each polishes its share of the contigs, :415-440). Window batches run the
model forward and an argmax on the device; the class ids come back to
the host and vote per (contig, position, insertion slot); each contig is
stitched from its votes:

- positions sorted by (pos, ins);
- leading insertion-slot predictions dropped;
- majority class per slot, ties to the lowest class; GAP skipped;
- draft prefix and suffix outside the voted span kept;
- draft positions with no votes inside the span omitted.

Eager PyTorch has no fixed-shape executables, so ``run_inference``
needs no batch padding. The streaming polish's session still pads to a
ladder of batch sizes (``pad_windows``, ``tail_rungs``, ``rung_for``,
``roko_tpu/infer.py:57-92``): its batcher packs windows into steps of
those sizes, and the kernels run at a few known shapes. The ragged step
of the service masks a top-rung slab instead (``mask_rows``).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from roko_tpu_torch import constants as C
from roko_tpu_torch.data.hdf5 import Batch, iter_inference_windows, load_contigs
from roko_tpu_torch.io.fasta import read_fasta, write_fasta
from roko_tpu_torch.models.model import RokoModel
from roko_tpu_torch.models.quant import maybe_quantize
from roko_tpu_torch.parallel.ring import gather_columns
from roko_tpu_torch.utils.profiling import device_trace

_SLOTS = C.MAX_INS + 1  # ins 0..3


def pad_windows(x: np.ndarray, batch_size: int) -> np.ndarray:
    """Zero-pad a window batch to exactly ``batch_size`` rows."""
    n = x.shape[0]
    if n == batch_size:
        return x
    if n > batch_size:
        raise ValueError(f"batch of {n} windows exceeds pad target {batch_size}")
    pad = batch_size - n
    return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])


def mask_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with its rows at or past ``n`` zeroed, in place: the ragged
    step's mask (``roko_tpu/infer.py:108-137``). Zero rows are what
    :func:`pad_windows` appends, so a masked top-rung slab gives the class
    ids of the first ``n`` rows padded to the top rung."""
    x[n:] = 0
    return x


def tail_rungs(ladder: Sequence[int], batch_size: int, dp: int) -> Tuple[int, ...]:
    """Padded batch sizes available to a short (tail or partial) batch:
    the ladder's rungs below ``batch_size`` that divide the dp axis, plus
    ``batch_size`` itself."""
    rungs = {r for r in ladder if 0 < r < batch_size and r % dp == 0}
    rungs.add(batch_size)
    return tuple(sorted(rungs))


def rung_for(rungs: Sequence[int], n: int) -> int:
    """Smallest rung >= n (the top rung caps it)."""
    for r in rungs:
        if n <= r:
            return r
    return rungs[-1]


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "false; ask for the CPU explicitly (device='cpu', --device cpu)"
        )
    return dev


def use_float32_matmuls() -> None:
    """The port's one matrix-product precision policy. TF32 off for matrix
    products and cuDNN: the reference computes in float32, and TF32 keeps
    about three digits. And no reduced-precision reduction in bfloat16
    products: cuBLAS may otherwise sum a bf16 GEMM's partial products in
    bf16, where the reference sums them in f32. The flags are
    process-wide: every thread of the process, and every later user of
    it, inherits them. Inference, the streaming polish's session, the
    trainer and ``chip_smoke.py`` call this; nothing in the port turns
    them back on."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


class VoteBoard:
    """Per-contig vote accumulator, on the host.

    Below ``sparse_threshold`` draft bases a contig votes into a dense
    ``uint16[len * 4 slots, 5]`` board. At or above it, the ins=0 slots
    keep a dense ``uint16[len, 5]`` board and the rare insertion slots a
    dict, about a quarter of the memory. Both give identical stitches.
    Counts are uint16 and every scatter is checked so that a count can
    never wrap."""

    #: a slot at this count aborts the run (uint16 wraps at 65536)
    SAT_LIMIT = 65_000
    #: the most one scatter may add to one slot without risking a wrap
    _WRAP_HEADROOM = 2**16 - SAT_LIMIT
    #: wider flat-slot spans scatter with np.add.at instead of a bincount
    _BINCOUNT_SPAN_CAP = 2_000_000

    def __init__(self, contigs: Dict[str, str], sparse_threshold: int = 2**25):
        self.contigs = contigs
        self.sparse_threshold = sparse_threshold
        self._votes: Dict[str, np.ndarray] = {}
        self._ins: Dict[str, Dict[int, np.ndarray]] = {}

    def _is_sparse(self, contig: str) -> bool:
        return len(self.contigs[contig]) >= self.sparse_threshold

    def _board(self, contig: str) -> np.ndarray:
        b = self._votes.get(contig)
        if b is None:
            n = len(self.contigs[contig])
            if self._is_sparse(contig):
                b = np.zeros((n, C.NUM_CLASSES), np.uint16)
                self._ins[contig] = {}
            else:
                b = np.zeros((n * _SLOTS, C.NUM_CLASSES), np.uint16)
            self._votes[contig] = b
        return b

    def _check_increment(self, inc_max: int, contig: str) -> None:
        if inc_max > self._WRAP_HEADROOM:
            raise RuntimeError(
                f"vote scatter on contig {contig!r} would add {inc_max} "
                f"votes to one slot in a single call (> headroom "
                f"{self._WRAP_HEADROOM}); the feed duplicates positions "
                "within window rows — refusing to risk a uint16 wrap."
            )

    def _check_saturation(self, touched_max: int, contig: str) -> None:
        if touched_max >= self.SAT_LIMIT:
            raise RuntimeError(
                f"vote board saturation on contig {contig!r}: a slot "
                f"reached {touched_max} of {2**16 - 1} possible uint16 "
                "votes. The window stride/overlap configuration packs "
                "too many windows per draft base; widen --window-stride "
                "or reduce region overlap."
            )

    def _scatter(self, board: np.ndarray, flat: np.ndarray,
                 preds: np.ndarray, contig: str) -> None:
        """``board[flat, preds] += 1`` with the wrap checks."""
        lo, hi = int(flat.min()), int(flat.max()) + 1
        if hi - lo > self._BINCOUNT_SPAN_CAP:
            comb = flat.astype(np.int64) * C.NUM_CLASSES + preds
            _, mult = np.unique(comb.ravel(), return_counts=True)
            self._check_increment(int(mult.max()), contig)
            np.add.at(board, (flat, preds), 1)
            self._check_saturation(int(board[flat, preds].max()), contig)
            return
        comb = (flat.astype(np.int64) - lo) * C.NUM_CLASSES + preds
        counts = np.bincount(
            comb.ravel(), minlength=(hi - lo) * C.NUM_CLASSES
        ).reshape(-1, C.NUM_CLASSES)
        self._check_increment(int(counts.max()), contig)
        region = board[lo:hi]
        region += counts.astype(np.uint16)
        self._check_saturation(int(region.max()), contig)

    def add(
        self, contigs: List[str], positions: np.ndarray, preds: np.ndarray
    ) -> None:
        """positions int64[B,90,2] (pos, ins); preds int[B,90]. Rows are
        grouped by contig and scattered at most 512 at a time, so one
        scatter adds at most 512 votes to a slot, inside the headroom."""
        groups: Dict[str, List[int]] = {}
        for i, name in enumerate(contigs):
            groups.setdefault(name, []).append(i)
        for name, rows in groups.items():
            for chunk in range(0, len(rows), 512):
                self._add_rows(name, positions, preds, rows[chunk : chunk + 512])

    def _add_rows(self, name: str, positions: np.ndarray,
                  preds: np.ndarray, rows: List[int]) -> None:
        board = self._board(name)
        idx = np.asarray(rows)
        pos = positions[idx]
        prd = np.asarray(preds)[idx]
        if not self._is_sparse(name):
            flat = pos[:, :, 0] * _SLOTS + pos[:, :, 1]
            self._scatter(board, flat.ravel(), prd.ravel(), name)
            return
        ins_mask = pos[:, :, 1] != 0
        base = ~ins_mask
        if base.any():
            self._scatter(board, pos[:, :, 0][base], prd[base], name)
        flat = pos[:, :, 0][ins_mask] * _SLOTS + pos[:, :, 1][ins_mask]
        if flat.size:
            ins_map = self._ins[name]
            comb = flat * C.NUM_CLASSES + prd[ins_mask]
            uniq, cnt = np.unique(comb, return_counts=True)
            for u, votes in zip(uniq.tolist(), cnt.tolist()):
                slot, p = divmod(u, C.NUM_CLASSES)
                counts = ins_map.get(slot)
                if counts is None:
                    counts = ins_map[slot] = np.zeros(C.NUM_CLASSES, np.uint16)
                total = int(counts[p]) + votes
                self._check_saturation(total, name)
                counts[p] = total

    def _covered_and_counts(self, contig: str):
        """(covered flat slot ids sorted by (pos, ins), vote counts [n,5])."""
        board = self._votes[contig]
        if not self._is_sparse(contig):
            covered = np.flatnonzero(board.sum(axis=1))
            return covered, board[covered]
        base_pos = np.flatnonzero(board.sum(axis=1))
        base_slots = base_pos * _SLOTS
        ins_map = self._ins[contig]
        if not ins_map:
            return base_slots, board[base_pos]
        ins_slots = np.fromiter(ins_map.keys(), np.int64, len(ins_map))
        ins_counts = np.stack([ins_map[s] for s in ins_slots.tolist()])
        covered = np.concatenate([base_slots, ins_slots])
        counts = np.concatenate([board[base_pos], ins_counts])
        order = np.argsort(covered, kind="stable")
        return covered[order], counts[order]

    def stitch(self, contig: str) -> str:
        """Consensus for one contig; the draft unchanged when it has no
        votes, or only insertion-slot votes."""
        draft = self.contigs[contig]
        if contig not in self._votes:
            return draft
        covered, counts = self._covered_and_counts(contig)
        is_base_slot = covered % _SLOTS == 0
        if not is_base_slot.any():
            return draft
        start = int(np.argmax(is_base_slot))  # first (pos, ins=0) entry
        covered, counts = covered[start:], counts[start:]
        pos_of = covered // _SLOTS
        bases = np.argmax(counts, axis=1)  # ties -> lowest class
        keep = bases != C.ENCODED_GAP
        alphabet = np.frombuffer(C.ALPHABET[: C.NUM_CLASSES].encode(), np.uint8)
        body = alphabet[bases[keep]].tobytes().decode()
        return draft[: int(pos_of[0])] + body + draft[int(pos_of[-1]) + 1 :]

    def stitch_all(self) -> Dict[str, str]:
        return {name: self.stitch(name) for name in self.contigs}


def predict(model: RokoModel, x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Forward + argmax, enqueued on ``device``: uint8[B,200,90] ->
    int32[B,90] class ids, still on the device. The model runs in its
    compute dtype, quantized first when its config asks for int8 (a no-op
    once it is). A model that computes a block of the columns (sp above
    1) gathers the logits of its sp group first, through the host."""
    maybe_quantize(model)
    xt = torch.from_numpy(np.ascontiguousarray(x)).to(device, non_blocking=True)
    with torch.inference_mode():
        logits = model(xt)
        if model.column_split:
            logits = gather_columns(logits, model.mesh)
        return logits.argmax(dim=-1).to(torch.int32)


def run_inference(
    batches: Iterable[Batch],
    contigs: Dict[str, str],
    model: RokoModel,
    *,
    device: str | torch.device = "cuda",
    log: Callable[[str], None] = print,
    trace_dir: Optional[str] = None,
    cfg=None,
    cascade_stats: Optional[dict] = None,
) -> Dict[str, str]:
    """Predict every window of ``batches`` (``(names, positions, examples)``
    tuples), vote, and stitch each contig: ``{contig: polished}``;
    ``trace_dir`` writes a device trace of the loop. ``cfg`` (a
    ``RokoConfig``) brings its ``compile`` section: the kernel build
    cache, and a kernel bundle whose libraries load in place of nvcc
    (``BundleMismatch`` when it does not match ``model``'s config); and
    its ``cascade`` section (``roko_tpu/infer.py:492-542``): when enabled,
    a router (``cascade/``) decides per batch which windows reach the
    model, and ``cascade_stats`` (a dict) receives its ``stats()``.

    One-deep pipeline: batch k+1's forward is enqueued on the device
    before the host blocks on batch k's class ids and votes them, so
    voting overlaps the device's work. The cascaded loop has none (what
    reaches the device depends on tier 1's decision); at threshold 0
    every window escalates in its batch, and the FASTA is the plain
    path's byte for byte. The model runs in its resolved
    ``cfg.compute_dtype``, and is quantized here, once, when
    ``cfg.quantize`` asks for int8 (``models/quant.py``)."""
    dev = resolve_device(device)
    if cfg is not None:
        from roko_tpu_torch.compile import enable_persistent_cache, load_bundle

        enable_persistent_cache(cfg.compile)
        if cfg.compile.bundle_dir:
            load_bundle(cfg.compile.bundle_dir, cfg, log=log)
    use_float32_matmuls()
    maybe_quantize(model).to(dev).eval()
    board = VoteBoard(contigs)
    n_windows = 0
    t0 = time.perf_counter()
    if cfg is not None and cfg.cascade.enabled:
        # built against the quantized weights tier 2 predicts with, so the
        # cache keys and the calibration identity match what runs
        from roko_tpu_torch.cascade import build_router

        router = build_router(cfg, params=model, device=dev)

        def tier2_predict(xe: np.ndarray) -> np.ndarray:
            return predict(model, xe, dev).cpu().numpy()

        with device_trace(trace_dir, dev):
            for names, positions, x in batches:
                board.add(names, positions, router.route(np.asarray(x), tier2_predict))
                n_windows += len(names)
        dt = max(time.perf_counter() - t0, 1e-9)
        s = router.stats()
        if cascade_stats is not None:
            cascade_stats.update(s)
        log(
            f"inference: {n_windows} windows in {dt:.1f}s on {dev} "
            f"({n_windows / dt:.0f} windows/s) — cascade escalated "
            f"{s['escalated']}/{s['windows']} ({100 * s['escalation_fraction']:.1f}%), "
            f"cache hit rate {100 * s['cache_hit_rate']:.1f}%"
        )
        return board.stitch_all()
    pending = None
    with device_trace(trace_dir, dev):
        for names, positions, x in batches:
            preds = predict(model, x, dev)
            if pending is not None:
                board.add(pending[0], pending[1], pending[2].cpu().numpy())
                n_windows += len(pending[0])
            pending = (names, positions, preds)
        if pending is not None:
            board.add(pending[0], pending[1], pending[2].cpu().numpy())
            n_windows += len(pending[0])
    dt = max(time.perf_counter() - t0, 1e-9)
    log(
        f"inference: {n_windows} windows in {dt:.1f}s on {dev} "
        f"({n_windows / dt:.0f} windows/s, "
        f"{n_windows * C.WINDOW_STRIDE / dt:.0f} bases/s)"
    )
    return board.stitch_all()


def polish_to_fasta(
    data_path: str,
    model: RokoModel,
    out_path: str,
    *,
    device: str | torch.device = "cuda",
    batch_size: int = 128,
    log: Callable[[str], None] = print,
    trace_dir: Optional[str] = None,
    cfg=None,
) -> Dict[str, str]:
    """Polish every contig of a feature HDF5 and write the FASTA (``cfg``
    as :func:`run_inference`'s); in a
    run of several processes each dp group reads only the windows of its
    contigs (:func:`polish_windows_to_fasta`, whose dict it returns)."""
    return polish_windows_to_fasta(
        load_contigs(data_path),
        lambda only: iter_inference_windows(data_path, batch_size, contig_filter=only),
        model, out_path, device=device, log=log, trace_dir=trace_dir, cfg=cfg,
    )


def polish_windows_to_fasta(
    contigs: Dict[str, str],
    windows: Callable[[Optional[set]], Iterable[Batch]],
    model: RokoModel,
    out_path: str,
    *,
    device: str | torch.device = "cuda",
    log: Callable[[str], None] = print,
    trace_dir: Optional[str] = None,
    cfg=None,
) -> Dict[str, str]:
    """Polish ``contigs`` (``{name: draft}`` in the draft's order) from
    ``windows(only)``, the window batches of the contigs in ``only`` (None:
    all), and write the FASTA. Returns ``{name: polished}`` of the contigs
    this process polished (all of them in a run of one process).

    One process writes the contigs in the draft's order. In a run of
    several processes (``parallel.distributed``, initialized here from
    ``ROKO_*``) the work is split by contig over the dp groups of the
    model's mesh (``model.mesh``; without one, every process is a dp
    group), as ``roko_tpu/infer.py:415-440, 599-633`` splits it: group d
    polishes ``sorted(contigs)[d::dp]``, reading only their windows, its
    tp x sp ranks running the same batches through the split forward; the
    group's first rank (t = 0, s = 0) writes them to ``out_path.part{d}``;
    after a barrier rank 0 merges the parts with the names sorted, as
    ``roko_tpu/infer.py:629`` orders them, and deletes them, and every
    rank waits for the merge. Votes stay with the group that owns the
    contig, so nothing is reduced across groups."""
    from roko_tpu_torch.parallel import distributed
    from roko_tpu_torch.parallel.mesh import make_mesh

    dev = resolve_device(device)
    distributed.initialize(device=dev)
    if distributed.world_size() == 1:
        polished = run_inference(windows(None), contigs, model, device=dev, log=log,
                                 trace_dir=trace_dir, cfg=cfg)
        write_fasta(out_path, list(polished.items()))
        return polished
    mesh = model.mesh if model.mesh is not None else make_mesh()
    rank = distributed.rank()
    mine = set(sorted(contigs)[mesh.d :: mesh.dp])
    polished = run_inference(
        windows(mine), {k: v for k, v in contigs.items() if k in mine}, model,
        device=distributed.device_of_rank(dev),
        log=log if rank == 0 else (lambda s: None),
        trace_dir=trace_dir if rank == 0 else None, cfg=cfg,
    )
    if mesh.t == 0 and mesh.s == 0:
        write_fasta(f"{out_path}.part{mesh.d}", list(polished.items()))
    distributed.barrier()
    if rank == 0:
        merged: Dict[str, str] = {}
        for p in range(mesh.dp):
            merged.update(read_fasta(f"{out_path}.part{p}"))
        write_fasta(out_path, [(name, merged[name]) for name in sorted(merged)])
        for p in range(mesh.dp):
            os.remove(f"{out_path}.part{p}")
    distributed.barrier()
    return polished
