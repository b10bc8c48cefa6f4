"""The datasets the training loop consumes, and the sample-granular
checkpointable iterator: the port's copy of
``roko_tpu/datapipe/dataset.py`` (:28-396).

:class:`SpanDataset` is a table of row blocks seen through a shard spec
(``num_shards``, ``shard_id``, ``seed``, ``mix_blocks``) and an optional
holdout view; its stream is a pure function of the spec and the epoch.
:class:`ShardedDataset` is the one over an HDF5 file set, indexed by a
manifest (``manifest.py``), with its rows preloaded or read span by span
(``h5py`` is imported only there). ``training/data.py`` keeps the
in-memory one.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from roko_tpu_torch.datapipe import engine as _engine
from roko_tpu_torch.datapipe.engine import Batch
from roko_tpu_torch.datapipe.io import open_h5
from roko_tpu_torch.datapipe.manifest import (
    DEFAULT_BLOCK_SIZE,
    Manifest,
    load_or_build_manifest,
)

Reader = Tuple[Callable[[int, np.ndarray], Tuple[np.ndarray, np.ndarray]],
               Optional[Callable[[], None]]]


def holdout_size(fraction: float, n: int) -> int:
    """Rows a ``fraction`` holdout takes out of ``n``: ``max(1,
    round(fraction * n))``, leaving at least one."""
    if not 0.0 < fraction < 1.0:
        raise ValueError(f"val fraction must be in (0, 1), got {fraction}")
    n_val = max(1, round(fraction * n))
    if n_val >= n:
        raise ValueError(f"val fraction {fraction} leaves no training windows (N={n})")
    return n_val


class SpanDataset:
    """Row blocks through a shard spec. A subclass gives ``_counts`` (rows
    per block), ``_reader`` (a block reader and its cleanup) and
    ``_row_template``; ``_kept`` restricts each block to some of its rows.

    ``batches`` yields ``(x, y, weight)``; ``iterator`` wraps it in a
    :class:`CheckpointableIterator`. With ``pad_last`` (the port's
    in-memory and HDF5 datasets) a last short batch is padded to the batch
    size unless ``pad_to`` says otherwise."""

    num_shards = 1
    shard_id = 0
    seed = 0
    mix_blocks = _engine.DEFAULT_MIX_BLOCKS
    prefetch_blocks = 0
    pad_last = False
    _kept: Optional[List[Optional[np.ndarray]]] = None

    def _counts(self) -> List[int]:
        raise NotImplementedError

    def _reader(self) -> Reader:
        raise NotImplementedError

    def _row_template(self) -> Tuple[tuple, str, tuple, str]:
        raise NotImplementedError

    def _recut(self, block_size: int) -> None:
        raise NotImplementedError

    def fingerprint(self) -> str:
        """The identity of the corpus the stream is a function of."""
        raise NotImplementedError

    # -- sizes ----------------------------------------------------------

    def _effective_counts(self) -> List[int]:
        counts = self._counts()
        if self._kept is None:
            return counts
        return [len(k) if k is not None else c for c, k in zip(counts, self._kept)]

    def __len__(self) -> int:
        """Kept rows of all shards."""
        return sum(self._effective_counts())

    @property
    def num_blocks(self) -> int:
        return len(self._counts())

    def local_rows(self) -> int:
        """Rows this shard owns (the same every epoch)."""
        return _engine.shard_row_counts(self._effective_counts(), self.num_shards)[self.shard_id]

    def steps_per_epoch(self, batch_size: int, *, drop_remainder: bool = False) -> int:
        """The batches every shard emits an epoch (the most of any shard)."""
        return _engine.batches_per_epoch(self._effective_counts(), batch_size,
                                         self.num_shards, drop_remainder=drop_remainder)

    # -- views ----------------------------------------------------------

    def sharded(self, *, num_shards: int = 1, shard_id: int = 0, seed: int = 0,
                block_size: Optional[int] = None, mix_blocks: Optional[int] = None,
                prefetch_blocks: Optional[int] = None) -> "SpanDataset":
        """A view of the same rows through another shard spec."""
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} outside [0, num_shards={num_shards})")
        view = copy.copy(self)
        view.num_shards, view.shard_id, view.seed = num_shards, shard_id, seed
        if mix_blocks is not None:
            view.mix_blocks = mix_blocks
        if prefetch_blocks is not None:
            view.prefetch_blocks = prefetch_blocks
        if block_size is not None and block_size != self.block_size:
            if self._kept is not None:
                raise ValueError("cannot recut the blocks of a holdout view")
            view._recut(block_size)
        return view

    def unsharded(self) -> "SpanDataset":
        """A 1-shard view of the same rows: what evaluation reads, so the
        metric does not depend on the train shard spec."""
        if self.num_shards == 1:
            return self
        view = copy.copy(self)
        view.num_shards, view.shard_id = 1, 0
        return view

    # -- reading --------------------------------------------------------

    def batches(
        self,
        batch_size: int,
        *,
        rng: Optional[np.random.Generator] = None,
        drop_remainder: bool = False,
        pad_to: Optional[int] = None,
        skip_batches: int = 0,
        start_samples: Optional[int] = None,
        stats: Optional[_engine.ReadStats] = None,
        equalize: Optional[bool] = None,
    ) -> Iterator[Batch]:
        """This shard's stream of ``(x, y, weight)`` batches, shuffled by
        ``rng`` (stored order without it). ``equalize`` (default: on with
        several shards and ``pad_to``) makes up the batch count to
        :meth:`steps_per_epoch` with zero-weight batches. The fast-forward
        of ``skip_batches`` / ``start_samples`` reads no skipped block."""
        if pad_to is None and self.pad_last and not drop_remainder:
            pad_to = batch_size
        if equalize is None:
            equalize = self.num_shards > 1 and pad_to is not None
        min_batches = None
        if equalize:
            start = int(start_samples) if start_samples is not None else skip_batches * batch_size
            min_batches = (self.steps_per_epoch(batch_size, drop_remainder=drop_remainder)
                           - start // batch_size)
        read_rows, cleanup = self._reader()
        yield from _engine.iter_span_batches(
            self._counts(), read_rows, batch_size,
            rng=rng, num_shards=self.num_shards, shard_id=self.shard_id, kept=self._kept,
            drop_remainder=drop_remainder, pad_to=pad_to, skip_batches=skip_batches,
            start_samples=start_samples, min_batches=min_batches,
            prefetch_groups=self._prefetch_groups(), mix_blocks=self.mix_blocks, stats=stats,
            row_template=self._row_template(), cleanup=cleanup,
        )

    def _prefetch_groups(self) -> int:
        """Mix groups read ahead in a thread: none for rows in memory."""
        return 0

    def epoch_rng(self, epoch: int) -> np.random.Generator:
        """The shuffle generator of epoch ``epoch``: (seed, epoch), the same
        whether or not the run was interrupted inside it."""
        return epoch_rng(self.seed, epoch)

    def iterator(self, epoch: int, batch_size: int, *, shuffle: bool = True,
                 pad_to: Optional[int] = None, drop_remainder: bool = False,
                 start_batch: int = 0, start_samples: Optional[int] = None,
                 stats: Optional[_engine.ReadStats] = None) -> "CheckpointableIterator":
        return CheckpointableIterator(
            self, epoch, batch_size, shuffle=shuffle, pad_to=pad_to,
            drop_remainder=drop_remainder, start_batch=start_batch,
            start_samples=start_samples, stats=stats,
        )


def epoch_rng(seed: int, epoch: int) -> np.random.Generator:
    """The shuffle generator of one epoch of a stream seeded ``seed``."""
    return np.random.default_rng(np.random.SeedSequence([seed, epoch]))


class ShardedDataset(SpanDataset):
    """A shard of an HDF5 file set (a file, a directory, or a list of
    paths and globs), indexed by its manifest. ``preload`` reads every
    (file, group) into host memory once; otherwise blocks are read from
    the files as the stream reaches them, ``prefetch_blocks`` mix groups
    ahead. Both give the same stream, bit for bit."""

    def __init__(
        self,
        path: Union[str, Sequence[str]],
        *,
        num_shards: int = 1,
        shard_id: int = 0,
        seed: int = 0,
        block_size: Optional[int] = None,
        prefetch_blocks: int = 2,
        mix_blocks: int = _engine.DEFAULT_MIX_BLOCKS,
        preload: bool = False,
        manifest_path: Optional[str] = None,
        require_labels: bool = True,
        log=None,
        manifest: Optional[Manifest] = None,
        paths: Optional[List[str]] = None,
        opener=None,
    ) -> None:
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} outside [0, num_shards={num_shards})")
        if manifest is None:
            manifest, paths = load_or_build_manifest(
                path, manifest_path=manifest_path,
                block_size=block_size or DEFAULT_BLOCK_SIZE,
                require_labels=require_labels, log=log,
            )
            # span.file_idx indexes manifest.files: the paths in that order
            by_name = {os.path.basename(p): p for p in paths}
            paths = [by_name[fe.name] for fe in manifest.files]
        self.manifest = manifest
        self.paths: List[str] = list(paths or [])
        #: ``opener(path, mode) -> file-like`` behind every span read
        #: (``io.py``); None: local paths and the scheme registry
        self._opener = opener
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.seed = seed
        self.prefetch_blocks = prefetch_blocks
        self.mix_blocks = mix_blocks
        self.block_size = block_size or manifest.block_size
        self._spans = manifest.spans(self.block_size)
        self._kept = None
        self._arrays: Optional[Dict[Tuple[int, str], Tuple[np.ndarray, np.ndarray]]] = None
        if preload:
            self._preload()

    def _preload(self) -> None:
        """Every (file, group) into host memory, read once."""
        arrays: Dict[Tuple[int, str], Tuple[np.ndarray, np.ndarray]] = {}
        for fi, p in enumerate(self.paths):
            with open_h5(p, opener=self._opener) as fd:
                for g, _rows in self.manifest.files[fi].groups:
                    x = np.ascontiguousarray(fd[g]["examples"][()])
                    y = np.ascontiguousarray(fd[g]["labels"][()], np.int32)
                    arrays[(fi, g)] = (x, y)
        self._arrays = arrays

    def _counts(self) -> List[int]:
        return [s.count for s in self._spans]

    def _recut(self, block_size: int) -> None:
        self.block_size = block_size
        self._spans = self.manifest.spans(block_size)

    def _row_template(self) -> Tuple[tuple, str, tuple, str]:
        m = self.manifest  # labels always surface as int32
        return (m.x_shape, m.x_dtype, m.y_shape, "int32")

    def _prefetch_groups(self) -> int:
        return 0 if self._arrays is not None else self.prefetch_blocks

    def _reader(self) -> Reader:
        fds: dict = {}

        def read_rows(b: int, order: np.ndarray):
            span = self._spans[b]
            if self._arrays is not None:
                x, y = self._arrays[(span.file_idx, span.group)]
                sel = span.start + order
                return x[sel], y[sel]
            fd = fds.get(span.file_idx)
            if fd is None:
                fd = fds[span.file_idx] = open_h5(self.paths[span.file_idx],
                                                  opener=self._opener)
            g = fd[span.group]
            lo, hi = span.start, span.start + span.count
            # one contiguous read of the block, then the permutation in memory
            x = np.asarray(g["examples"][lo:hi])
            y = np.asarray(g["labels"][lo:hi], np.int32)
            return x[order], y[order]

        def close_fds():
            for fd in fds.values():
                fd.close()
            fds.clear()

        return read_rows, close_fds

    def fingerprint(self) -> str:
        return self.manifest.fingerprint

    def legacy_fingerprint(self) -> str:
        """The corpus digest the port's checkpoints held before the
        manifest (basename, size and groups of each file), so that their
        resume still checks the corpus."""
        blob = json.dumps([[fe.name, fe.size, [list(g) for g in fe.groups]]
                           for fe in self.manifest.files])
        return hashlib.sha256(blob.encode()).hexdigest()

    def split_holdout(self, fraction: float, seed: int) -> Tuple["ShardedDataset", "ShardedDataset"]:
        """(train, val) views: a seeded permutation of all rows holds out
        ``max(1, round(fraction * N))`` of them, each view keeping the
        rows' stored order. The val view is unsharded; the train view
        keeps this dataset's shard spec."""
        if self._kept is not None:
            raise ValueError("cannot split an already-split dataset view")
        n = len(self)
        n_val = holdout_size(fraction, n)
        perm = np.random.default_rng(seed).permutation(n)
        val_mask = np.zeros(n, bool)
        val_mask[perm[:n_val]] = True
        kept_train: List[Optional[np.ndarray]] = []
        kept_val: List[Optional[np.ndarray]] = []
        off = 0
        for c in self._counts():
            m = val_mask[off : off + c]
            kept_val.append(np.nonzero(m)[0].astype(np.int64))
            kept_train.append(np.nonzero(~m)[0].astype(np.int64))
            off += c
        train, val = copy.copy(self), copy.copy(self)
        train._kept, val._kept = kept_train, kept_val
        val.num_shards, val.shard_id = 1, 0
        return train, val


class CheckpointableIterator:
    """An epoch iterator whose ``state()`` (``{"epoch", "batch",
    "samples"}``) is its exact position in the shard's stream;
    :meth:`restore` continues from it bit for bit, reading no skipped
    block."""

    def __init__(self, dataset: SpanDataset, epoch: int, batch_size: int, *,
                 shuffle: bool = True, pad_to: Optional[int] = None,
                 drop_remainder: bool = False, start_batch: int = 0,
                 start_samples: Optional[int] = None, stats=None) -> None:
        self.dataset = dataset
        self.epoch = int(epoch)
        self.batch_size = int(batch_size)
        self._samples = (int(start_samples) if start_samples is not None
                         else start_batch * batch_size)
        self._batch = self._samples // batch_size
        self._gen = dataset.batches(
            batch_size, rng=dataset.epoch_rng(epoch) if shuffle else None, pad_to=pad_to,
            drop_remainder=drop_remainder, start_samples=self._samples, stats=stats,
        )

    def __iter__(self) -> "CheckpointableIterator":
        return self

    def __next__(self) -> Batch:
        batch = next(self._gen)
        self._batch += 1
        self._samples += self.batch_size
        return batch

    def state(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "batch": self._batch, "samples": self._samples}

    @staticmethod
    def restore(dataset: SpanDataset, state: Dict[str, int], batch_size: int,
                **kw) -> "CheckpointableIterator":
        return CheckpointableIterator(dataset, int(state["epoch"]), batch_size,
                                      start_samples=int(state["samples"]), **kw)
