"""Out-of-core training data: batches streamed from HDF5 without loading
the corpus into memory. The port's copy of
``roko_tpu/training/lazy_data.py`` (:29-128).

:class:`StreamingDataset` cuts the groups of its files into chunks of
``chunk_size`` consecutive rows; ``batches`` is the stream of a 1-shard
:class:`~roko_tpu_torch.datapipe.ShardedDataset` read span by span with
chunks as its blocks: a seeded chunk permutation, per-chunk row
permutations, mix groups, and a bounded readahead of
``min(4, buffer_chunks)`` mix groups. Skipped chunks are never read. The
reference's shuffle-buffer reader ``legacy_batches``, kept there only for
its bench's ``input`` suite, is not ported (ROADMAP queue item A11b).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from roko_tpu_torch.datapipe.dataset import ShardedDataset
from roko_tpu_torch.datapipe.engine import Batch


class StreamingDataset:
    """Streams ``(examples, labels)`` from one HDF5 file or a directory."""

    def __init__(self, path: str, chunk_size: int = 256, buffer_chunks: int = 16):
        self.chunk_size = chunk_size
        self.buffer_chunks = buffer_chunks
        self._ds = ShardedDataset(path, block_size=chunk_size,
                                  prefetch_blocks=min(4, buffer_chunks))
        self.files = list(self._ds.paths)

    def __len__(self) -> int:
        return len(self._ds)

    def batches(
        self,
        batch_size: int,
        *,
        rng: Optional[np.random.Generator] = None,
        drop_remainder: bool = False,
        pad_to: Optional[int] = None,
        skip_batches: int = 0,
    ) -> Iterator[Batch]:
        """``(x, y, weight)`` batches, the contract of
        ``InMemoryDataset.batches``."""
        return self._ds.batches(batch_size, rng=rng, drop_remainder=drop_remainder,
                                pad_to=pad_to, skip_batches=skip_batches)
