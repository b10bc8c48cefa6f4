"""Shuffle and batch engine of the training data stream, one shard.

The port's copy of ``roko_tpu/datapipe/engine.py`` (``epoch_schedule``
:104, ``batches_per_epoch`` :139, ``iter_span_batches`` :171) for a
single data shard. The stream over a table of spans (blocks of at most
256 consecutive rows) is a pure function of the epoch's numpy generator:

1. one seeded permutation of the blocks, then one row-permutation seed per
   block drawn in canonical block order;
2. the permuted blocks pooled into mix groups of ``MIX_BLOCKS`` (8), the rows
   of a group permuted once more across its blocks;
3. the rows cut into batches; the last batch padded to the batch size
   with zero-weight rows.

The generator is consumed exactly as the reference consumes it, so the
same seed gives the same batches, row for row.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

#: rows of one span block
BLOCK_SIZE = 256
#: blocks whose rows one mix group permutes together
MIX_BLOCKS = 8

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray]


def epoch_schedule(
    counts: Sequence[int], rng: Optional[np.random.Generator]
) -> Tuple[Tuple[int, ...], Optional[np.ndarray]]:
    """(block order, per-block row-permutation seeds or None)."""
    n = len(counts)
    if rng is None:
        return tuple(range(n)), None
    order = rng.permutation(n)
    seeds = rng.integers(0, np.iinfo(np.int64).max, size=n, dtype=np.int64)
    return tuple(int(b) for b in order), seeds


def batches_per_epoch(counts: Sequence[int], batch_size: int) -> int:
    """Batches in one epoch, the last one padded."""
    return -(-sum(int(c) for c in counts) // batch_size)


def _row_order(block: int, count: int, seeds: Optional[np.ndarray],
               kept: Optional[np.ndarray]) -> np.ndarray:
    base = np.asarray(kept) if kept is not None else np.arange(count)
    if seeds is None:
        return base
    return base[np.random.default_rng(int(seeds[block])).permutation(len(base))]


def iter_span_batches(
    counts: Sequence[int],
    read_rows: Callable[[int, np.ndarray], Tuple[np.ndarray, np.ndarray]],
    batch_size: int,
    *,
    rng: Optional[np.random.Generator] = None,
    kept: Optional[Sequence[Optional[np.ndarray]]] = None,
) -> Iterator[Batch]:
    """Yield ``(x, y, weight)`` batches of one epoch's stream, the last
    one padded to ``batch_size``.

    ``read_rows(block, order)`` returns the block's rows in ``order``;
    ``kept`` restricts each block to a subset of its rows (a holdout
    view)."""
    counts = (
        [len(k) if k is not None else int(c) for c, k in zip(counts, kept)]
        if kept is not None
        else [int(c) for c in counts]
    )
    order, seeds = epoch_schedule(counts, rng)
    groups = [order[i : i + MIX_BLOCKS] for i in range(0, len(order), MIX_BLOCKS)]

    def group_rows(group) -> Tuple[np.ndarray, np.ndarray]:
        xs, ys = [], []
        for b in group:
            if counts[b] == 0:
                continue
            x, y = read_rows(b, _row_order(
                b, counts[b], seeds, kept[b] if kept is not None else None))
            xs.append(x)
            ys.append(y)
        x = xs[0] if len(xs) == 1 else np.concatenate(xs)
        y = ys[0] if len(ys) == 1 else np.concatenate(ys)
        if seeds is not None and len(xs) > 1:
            perm = np.random.default_rng(
                np.random.SeedSequence([int(seeds[group[0]]), 1])
            ).permutation(len(x))
            x, y = x[perm], y[perm]
        return x, y

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

    for group in groups:
        if sum(counts[b] for b in group) == 0:
            continue
        x, y = group_rows(group)
        buf_x.append(x)
        buf_y.append(y)
        held += len(x)
        while held >= batch_size:
            xb, yb = cut(batch_size)
            yield xb, yb, np.ones(batch_size, np.float32)
    if held:
        xb, yb = cut(held)
        pad = batch_size - len(xb)
        w = np.concatenate([np.ones(len(xb), np.float32), np.zeros(pad, np.float32)])
        xb = np.concatenate([xb, np.zeros((pad,) + xb.shape[1:], xb.dtype)])
        yb = np.concatenate([yb, np.zeros((pad,) + yb.shape[1:], yb.dtype)])
        yield xb, yb, w
