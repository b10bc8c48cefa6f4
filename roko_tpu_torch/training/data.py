"""Training datasets of the port, both views of the data plane
(``roko_tpu_torch/datapipe``):

- :class:`HDF5Dataset` is a :class:`~roko_tpu_torch.datapipe.ShardedDataset`
  with its rows preloaded (the reference's default ``in_memory``): files
  in basename order, groups in file order, 256-row spans per group. Its
  ``split_holdout`` keeps rows in place and masks them.
- :class:`InMemoryDataset` holds flat ``(X, Y)`` arrays cut into 256-row
  spans, as ``roko_tpu.training.data.InMemoryDataset`` (:24-111) does; its
  ``split_holdout`` copies the rows of a seeded permutation. It needs no
  ``h5py``.

Both yield ``(x uint8[B,200,90], y int32[B,90], weight float32[B])`` and
pad a last short batch to ``B`` with rows of weight 0. Epoch ``e`` of a
stream seeded ``s`` shuffles with :func:`epoch_rng` ``(s, e)``, whether or
not the run was resumed. Either takes another shard spec through
``sharded`` (what the train loop applies from ``DataConfig``).
"""

from __future__ import annotations

import hashlib
from typing import List, Tuple

import numpy as np

from roko_tpu_torch.datapipe.dataset import ShardedDataset, SpanDataset, epoch_rng, holdout_size
from roko_tpu_torch.datapipe.manifest import DEFAULT_BLOCK_SIZE

__all__ = ["HDF5Dataset", "InMemoryDataset", "epoch_rng"]


class HDF5Dataset(ShardedDataset):
    """Training HDF5 files (a file or a directory of them), one shard,
    preloaded."""

    pad_last = True

    def __init__(self, path: str):
        super().__init__(path, preload=True)


class InMemoryDataset(SpanDataset):
    pad_last = True

    def __init__(self, X: np.ndarray, Y: np.ndarray, block_size: int = DEFAULT_BLOCK_SIZE):
        if len(X) != len(Y):
            raise ValueError(f"{len(X)} windows but {len(Y)} label rows")
        self.X = np.ascontiguousarray(X, dtype=np.uint8)
        self.Y = np.ascontiguousarray(Y, dtype=np.int32)
        self._recut(block_size)

    def _recut(self, block_size: int) -> None:
        self.block_size = block_size
        n = len(self.X)
        self._starts = list(range(0, n, block_size))
        self._block_counts = [min(block_size, n - s) for s in self._starts]

    def _counts(self) -> List[int]:
        return list(self._block_counts)

    def _reader(self):
        def read_rows(block: int, order: np.ndarray):
            sel = self._starts[block] + order
            return self.X[sel], self.Y[sel]

        return read_rows, None

    def _row_template(self):
        return (self.X.shape[1:], str(self.X.dtype), self.Y.shape[1:], "int32")

    def fingerprint(self) -> str:
        h = hashlib.sha256(repr((self.X.shape, self.Y.shape)).encode())
        h.update(self.X.data)
        h.update(self.Y.data)
        return h.hexdigest()

    legacy_fingerprint = fingerprint

    def split_holdout(self, fraction: float, seed: int) -> Tuple["InMemoryDataset", "InMemoryDataset"]:
        """(train, val) copies: a seeded permutation holds out ``max(1,
        round(fraction * N))`` windows; both keep the permutation's order.
        The train copy keeps this dataset's shard spec, the val copy is
        unsharded."""
        n_val = holdout_size(fraction, len(self))
        perm = np.random.default_rng(seed).permutation(len(self))
        val_idx, train_idx = perm[:n_val], perm[n_val:]
        train = InMemoryDataset(self.X[train_idx], self.Y[train_idx], self.block_size)
        val = InMemoryDataset(self.X[val_idx], self.Y[val_idx], self.block_size)
        for view in (train, val):
            view.seed, view.mix_blocks = self.seed, self.mix_blocks
        return train.sharded(num_shards=self.num_shards, shard_id=self.shard_id,
                             seed=self.seed), val
