"""Training datasets of the port: labelled windows in host memory, cut
into span blocks that the engine (``engine.py``) shuffles and batches.

- :class:`HDF5Dataset` reads training HDF5 files (a file or a directory
  of them) as ``roko_tpu.datapipe.ShardedDataset`` does with one
  shard: files in basename order, groups in file order, 256-row spans
  per group (``Manifest.spans``, ``roko_tpu/datapipe/manifest.py:195``),
  the rows preloaded (the reference's default ``in_memory``). Its
  ``split_holdout`` keeps rows in place and masks them
  (``roko_tpu/datapipe/dataset.py:291-326``).
- :class:`InMemoryDataset` holds flat ``(X, Y)`` arrays, 256-row spans
  over them, as ``roko_tpu.training.data.InMemoryDataset`` (:24-111);
  its ``split_holdout`` copies the rows of a seeded permutation. It needs
  no ``h5py``.

Both yield ``(x uint8[B,200,90], y int32[B,90], weight float32[B])``;
the last batch is padded to ``B`` with rows of weight 0. Epoch ``e`` of
a run seeded ``s`` shuffles with :func:`epoch_rng` ``(s, e)``, whether or
not the run was resumed.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from roko_tpu_torch.data.hdf5 import hdf5_files, read_training_groups
from roko_tpu_torch.training import engine
from roko_tpu_torch.training.engine import BLOCK_SIZE, Batch


def epoch_rng(seed: int, epoch: int) -> np.random.Generator:
    """The shuffle generator of one epoch
    (``roko_tpu/datapipe/dataset.py:249-253``)."""
    return np.random.default_rng(np.random.SeedSequence([seed, epoch]))


def _holdout_size(fraction: float, n: int) -> int:
    if not 0.0 < fraction < 1.0:
        raise ValueError(f"val fraction must be in (0, 1), got {fraction}")
    n_val = max(1, round(fraction * n))
    if n_val >= n:
        raise ValueError(f"val fraction {fraction} leaves no training windows (N={n})")
    return n_val


class _SpanDataset:
    """Rows in blocks: ``_counts`` rows per block, ``_read_rows`` reads
    one, ``_kept`` optionally restricts each block to some of its rows."""

    _kept: Optional[List[Optional[np.ndarray]]] = None

    def _counts(self) -> List[int]:
        raise NotImplementedError

    def _read_rows(self, block: int, order: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def _effective_counts(self) -> List[int]:
        counts = self._counts()
        if self._kept is None:
            return counts
        return [len(k) if k is not None else c for c, k in zip(counts, self._kept)]

    def __len__(self) -> int:
        return sum(self._effective_counts())

    def steps_per_epoch(self, batch_size: int) -> int:
        return engine.batches_per_epoch(self._effective_counts(), batch_size)

    def batches(
        self, batch_size: int, *, rng: Optional[np.random.Generator] = None
    ) -> Iterator[Batch]:
        """The stream of ``(x, y, weight)`` batches; shuffled by ``rng``,
        in stored order without it (evaluation)."""
        return engine.iter_span_batches(
            self._counts(), self._read_rows, batch_size, rng=rng, kept=self._kept
        )

    def fingerprint(self) -> str:
        """Identity of the corpus the stream is a function of; a resume
        refuses a different one."""
        raise NotImplementedError


class HDF5Dataset(_SpanDataset):
    def __init__(self, path: str):
        self.paths: List[str] = hdf5_files(path)
        #: per file: [(group, rows)]
        self.groups: List[List[Tuple[str, int]]] = []
        self._arrays = []  # (x, y) per (file, group) in span order
        self._spans: List[Tuple[int, int, int]] = []  # (array index, start, count)
        for p in self.paths:
            file_groups = []
            for g, x, y in read_training_groups(p):
                file_groups.append((g, len(x)))
                for start in range(0, len(x), BLOCK_SIZE):
                    self._spans.append(
                        (len(self._arrays), start, min(BLOCK_SIZE, len(x) - start)))
                self._arrays.append((x, y))
            self.groups.append(file_groups)
        if not self._spans:
            raise ValueError(f"no training windows found under {path!r}")

    def _counts(self) -> List[int]:
        return [c for _, _, c in self._spans]

    def _read_rows(self, block: int, order: np.ndarray):
        a, start, _ = self._spans[block]
        x, y = self._arrays[a]
        sel = start + order
        return x[sel], y[sel]

    def fingerprint(self) -> str:
        blob = json.dumps([
            [os.path.basename(p), os.path.getsize(p), groups]
            for p, groups in zip(self.paths, self.groups)
        ])
        return hashlib.sha256(blob.encode()).hexdigest()

    def split_holdout(self, fraction: float, seed: int) -> Tuple["HDF5Dataset", "HDF5Dataset"]:
        """(train, val) views: a seeded permutation of all rows holds out
        ``max(1, round(fraction * N))`` of them, each view keeping the
        rows' stored order."""
        if self._kept is not None:
            raise ValueError("cannot split an already-split dataset view")
        n = len(self)
        n_val = _holdout_size(fraction, n)
        perm = np.random.default_rng(seed).permutation(n)
        val_mask = np.zeros(n, bool)
        val_mask[perm[:n_val]] = True
        kept_train, kept_val = [], []
        off = 0
        for c in self._counts():
            m = val_mask[off : off + c]
            kept_val.append(np.nonzero(m)[0].astype(np.int64))
            kept_train.append(np.nonzero(~m)[0].astype(np.int64))
            off += c
        train, val = copy.copy(self), copy.copy(self)
        train._kept, val._kept = kept_train, kept_val
        return train, val


class InMemoryDataset(_SpanDataset):
    def __init__(self, X: np.ndarray, Y: np.ndarray):
        if len(X) != len(Y):
            raise ValueError(f"{len(X)} windows but {len(Y)} label rows")
        self.X = np.ascontiguousarray(X, dtype=np.uint8)
        self.Y = np.ascontiguousarray(Y, dtype=np.int32)
        self._starts = list(range(0, len(X), BLOCK_SIZE))
        self._block_counts = [min(BLOCK_SIZE, len(X) - s) for s in self._starts]

    def _counts(self) -> List[int]:
        return list(self._block_counts)

    def _read_rows(self, block: int, order: np.ndarray):
        sel = self._starts[block] + order
        return self.X[sel], self.Y[sel]

    def fingerprint(self) -> str:
        h = hashlib.sha256(repr((self.X.shape, self.Y.shape)).encode())
        h.update(self.X.data)
        h.update(self.Y.data)
        return h.hexdigest()

    def split_holdout(self, fraction: float, seed: int) -> Tuple["InMemoryDataset", "InMemoryDataset"]:
        """(train, val) copies: a seeded permutation holds out
        ``max(1, round(fraction * N))`` windows; both keep the
        permutation's order."""
        n_val = _holdout_size(fraction, len(self))
        perm = np.random.default_rng(seed).permutation(len(self))
        val_idx, train_idx = perm[:n_val], perm[n_val:]
        return (InMemoryDataset(self.X[train_idx], self.Y[train_idx]),
                InMemoryDataset(self.X[val_idx], self.Y[val_idx]))
