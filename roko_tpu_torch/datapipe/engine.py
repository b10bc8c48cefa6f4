"""Shuffle, shard and batch engine: a global shuffle without a global read.

The port's copy of ``roko_tpu/datapipe/engine.py``. The epoch stream over
a table of span blocks is a pure function of (rng, num_shards, shard_id):

1. block order: one seeded permutation of all blocks, then one
   row-permutation seed per block drawn in canonical block order, so every
   shard consumes the generator identically;
2. shard assignment: block ``b`` belongs to shard ``b % num_shards``; the
   shard streams cover the corpus disjointly and their union is the
   1-shard stream as a multiset;
3. mix groups: each shard pools ``mix_blocks`` consecutive blocks of its
   permuted sequence and permutes their rows once more across the pool,
   so a batch mixes rows of several corpus regions;
4. batches: the rows cut into batches; the last one short, padded with
   zero-weight rows (``pad_to``) or dropped, and with ``min_batches`` the
   count made up with all-padding batches so every shard takes the same
   number of steps.

A shard reads only its own blocks, holds at most a few mix groups of rows
at a time (:class:`ReadStats` counts it), and fast-forwards to a sample in
O(spans skipped): a mix group wholly before the start is never read. The
generator is consumed exactly as the reference consumes it, so the same
seed gives the same batches, row for row.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

#: blocks whose rows one mix group permutes together (8 blocks of 256 rows)
DEFAULT_MIX_BLOCKS = 8

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray]


class ReadStats:
    """Rows read from the source and the most rows resident at once (read
    and not yet handed out in a batch, those waiting in the prefetch queue
    included): the proof that the shuffle never holds the corpus. The two
    counters move in different threads; int increments are atomic under
    the GIL, and a high-water mark tolerates the benign race."""

    def __init__(self) -> None:
        self.rows_read = 0
        self.rows_emitted = 0
        self.blocks_read = 0
        self.batches = 0
        self.max_resident_rows = 0

    def note_read(self, rows: int) -> None:
        self.rows_read += int(rows)
        self.blocks_read += 1
        self._note_resident()

    def note_emitted(self, rows: int) -> None:
        self.rows_emitted += int(rows)

    def _note_resident(self) -> None:
        resident = self.rows_read - self.rows_emitted
        if resident > self.max_resident_rows:
            self.max_resident_rows = int(resident)

    def note_batch(self) -> None:
        self.batches += 1
        self._note_resident()


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One shard's epoch: its blocks in stream order and the row seeds of
    every block (any shard's rows follow from the schedule alone)."""

    mine: Tuple[int, ...]
    seeds: Optional[np.ndarray]  # None: no shuffle
    counts: Tuple[int, ...]  # rows per block after any holdout

    def row_order(self, block: int, kept: Optional[np.ndarray] = None) -> np.ndarray:
        """The order of ``block``'s rows (indices into its span); ``kept``
        restricts it to a subset."""
        base = np.asarray(kept) if kept is not None else np.arange(self.counts[block])
        if self.seeds is None:
            return base
        perm = np.random.default_rng(int(self.seeds[block])).permutation(len(base))
        return base[perm]


def epoch_schedule(
    counts: Sequence[int],
    rng: Optional[np.random.Generator],
    *,
    num_shards: int = 1,
    shard_id: int = 0,
) -> Schedule:
    """One epoch's schedule; the generator is consumed identically for
    every (num_shards, shard_id)."""
    if not 0 <= shard_id < num_shards:
        raise ValueError(f"shard_id {shard_id} outside [0, {num_shards})")
    n = len(counts)
    if rng is None:
        order = np.arange(n)
        seeds = None
    else:
        order = rng.permutation(n)
        seeds = rng.integers(0, np.iinfo(np.int64).max, size=n, dtype=np.int64)
    mine = tuple(int(b) for b in order if b % num_shards == shard_id)
    return Schedule(mine=mine, seeds=seeds, counts=tuple(int(c) for c in counts))


def shard_row_counts(counts: Sequence[int], num_shards: int) -> List[int]:
    """Each shard's rows (the canonical modulo assignment)."""
    totals = [0] * num_shards
    for b, c in enumerate(counts):
        totals[b % num_shards] += int(c)
    return totals


def batches_per_epoch(
    counts: Sequence[int], batch_size: int, num_shards: int = 1, *,
    drop_remainder: bool = False,
) -> int:
    """The step count every shard emits: the most batches of any shard."""
    per = [rows // batch_size if drop_remainder else -(-rows // batch_size)
           for rows in shard_row_counts(counts, num_shards)]
    return max(per) if per else 0


def _zero_batch(batch_size: int, row_template: Tuple[tuple, str, tuple, str]) -> Batch:
    x_shape, x_dtype, y_shape, y_dtype = row_template
    x = np.zeros((batch_size,) + tuple(x_shape), np.dtype(x_dtype))
    y = np.zeros((batch_size,) + tuple(y_shape), np.dtype(y_dtype or np.int32))
    return x, y, np.zeros(batch_size, np.float32)


def prefetch(iterator, size: int, place: Callable = lambda item: item) -> Iterator:
    """``place(item)`` for each item of ``iterator``, run in a producer
    thread that keeps up to ``size`` placed items ahead of the consumer
    (the reference's ``training/data.py::prefetch_to_device``). ``size``
    0 runs in the caller's thread. The producer's error is raised on the
    consumer's side; a consumer that stops early stops the producer."""
    if size <= 0:
        for item in iterator:
            yield place(item)
        return

    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if not put(place(item)):
                    return
        except BaseException as e:
            put(e)
            return
        put(end)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break


def iter_span_batches(
    counts: Sequence[int],
    read_rows: Callable[[int, np.ndarray], Tuple[np.ndarray, np.ndarray]],
    batch_size: int,
    *,
    rng: Optional[np.random.Generator] = None,
    num_shards: int = 1,
    shard_id: int = 0,
    kept: Optional[Sequence[Optional[np.ndarray]]] = None,
    drop_remainder: bool = False,
    pad_to: Optional[int] = None,
    skip_batches: int = 0,
    start_samples: Optional[int] = None,
    min_batches: Optional[int] = None,
    prefetch_groups: int = 0,
    mix_blocks: int = DEFAULT_MIX_BLOCKS,
    stats: Optional[ReadStats] = None,
    row_template: Optional[Tuple[tuple, str, tuple, str]] = None,
    cleanup: Optional[Callable[[], None]] = None,
) -> Iterator[Batch]:
    """Yield ``(x, y, weight)`` batches of this shard's slice of the
    epoch stream.

    ``read_rows(block, order)`` returns the block's rows in ``order``: the
    only place data moves, so ``skip_batches`` / ``start_samples`` skip
    whole mix groups by counting them. ``kept`` restricts each block to a
    subset of its rows (a holdout view). ``min_batches`` (with ``pad_to``
    and ``row_template``) makes up the batch count with all-padding
    batches. ``prefetch_groups`` > 0 reads mix groups in a producer
    thread, that many ahead. ``cleanup`` runs when the block generator
    ends or is closed, in the thread that read, so it never races a read.
    """
    eff_counts = (
        [len(k) if k is not None else int(c) for c, k in zip(counts, kept)]
        if kept is not None
        else [int(c) for c in counts]
    )
    sched = epoch_schedule(eff_counts, rng, num_shards=num_shards, shard_id=shard_id)
    start = int(start_samples) if start_samples is not None else skip_batches * batch_size
    width = max(1, mix_blocks)
    groups = [sched.mine[i : i + width] for i in range(0, len(sched.mine), width)]

    def group_rows(group) -> Tuple[np.ndarray, np.ndarray]:
        """Read one mix group and permute its rows across its blocks."""
        xs, ys = [], []
        for b in group:
            if sched.counts[b] == 0:
                continue
            order = sched.row_order(b, kept[b] if kept is not None else None)
            x, y = read_rows(b, order)
            if stats is not None:
                stats.note_read(len(order))
            xs.append(x)
            ys.append(y)
        x = xs[0] if len(xs) == 1 else np.concatenate(xs)
        y = ys[0] if len(ys) == 1 else np.concatenate(ys)
        if sched.seeds is not None and len(xs) > 1:
            perm = np.random.default_rng(
                np.random.SeedSequence([int(sched.seeds[group[0]]), 1])
            ).permutation(len(x))
            x, y = x[perm], y[perm]
        return x, y

    def blocks() -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        try:
            pos = 0
            for group in groups:
                size = sum(sched.counts[b] for b in group)
                if size == 0:
                    continue
                if pos + size <= start:
                    pos += size  # fast-forward: the whole group is skipped unread
                    continue
                x, y = group_rows(group)
                if pos < start:
                    # the cut prefix was read but is never emitted
                    if stats is not None:
                        stats.note_emitted(start - pos)
                    x, y = x[start - pos :], y[start - pos :]
                pos += size
                yield x, y
        finally:
            if cleanup is not None:
                cleanup()

    emitted = 0
    buf_x: List[np.ndarray] = []
    buf_y: List[np.ndarray] = []
    held = 0

    def cut(n: int) -> Tuple[np.ndarray, np.ndarray]:
        nonlocal buf_x, buf_y, held
        x = buf_x[0] if len(buf_x) == 1 else np.concatenate(buf_x)
        y = buf_y[0] if len(buf_y) == 1 else np.concatenate(buf_y)
        buf_x = [x[n:]] if len(x) > n else []
        buf_y = [y[n:]] if len(y) > n else []
        held = max(0, len(x) - n)
        return x[:n], y[:n]

    def emit(x, y, w, real_rows) -> Batch:
        nonlocal emitted
        emitted += 1
        if stats is not None:
            stats.note_emitted(real_rows)
            stats.note_batch()
        return x, y, w

    for x, y in prefetch(blocks(), prefetch_groups):
        buf_x.append(x)
        buf_y.append(y)
        held += len(x)
        while held >= batch_size:
            xb, yb = cut(batch_size)
            yield emit(xb, yb, np.ones(batch_size, np.float32), batch_size)
    if held:
        xb, yb = cut(held)
        real = len(xb)
        if drop_remainder:
            pass
        elif pad_to is not None:
            pad = pad_to - len(xb)
            w = np.concatenate([np.ones(len(xb), np.float32), np.zeros(pad, np.float32)])
            if pad > 0:
                xb = np.concatenate([xb, np.zeros((pad,) + xb.shape[1:], xb.dtype)])
                yb = np.concatenate([yb, np.zeros((pad,) + yb.shape[1:], yb.dtype)])
            yield emit(xb, yb, w, real)
        else:
            yield emit(xb, yb, np.ones(len(xb), np.float32), real)
    if min_batches is not None and emitted < min_batches:
        if pad_to is None or row_template is None:
            raise ValueError("min_batches needs pad_to and row_template to make "
                             "padding batches")
        while emitted < min_batches:
            yield emit(*_zero_batch(pad_to, row_template), 0)
