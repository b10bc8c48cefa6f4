"""The training data plane of the port (``roko_tpu/datapipe``):

- ``manifest.py``: the index of an HDF5 file set, spans of rows with
  sizes and a content fingerprint, persisted in a sidecar both packages
  read;
- ``engine.py``: the shuffle, shard and batch engine over a table of row
  blocks, its fast-forward, its bounded prefetch and its read accounting;
- ``dataset.py``: :class:`ShardedDataset` and the checkpointable iterator;
- ``io.py``: the opener seam behind every read.

Nothing here imports ``h5py`` at module level: the engine, the shards,
the fast-forward and the prefetch run from in-memory spans on a machine
without it.
"""

from roko_tpu_torch.datapipe.dataset import CheckpointableIterator, ShardedDataset, SpanDataset
from roko_tpu_torch.datapipe.engine import ReadStats, epoch_schedule, iter_span_batches
from roko_tpu_torch.datapipe.io import (
    open_input,
    open_output,
    register_opener,
    register_writer,
    registered_schemes,
)
from roko_tpu_torch.datapipe.manifest import (
    MANIFEST_BASENAME,
    Manifest,
    ManifestError,
    ManifestMismatch,
    build_manifest,
    crosscheck_fingerprint,
    load_or_build_manifest,
    resolve_file_set,
)

__all__ = [
    "CheckpointableIterator", "ShardedDataset", "SpanDataset", "ReadStats",
    "epoch_schedule", "iter_span_batches", "open_input", "open_output", "register_opener",
    "register_writer", "registered_schemes", "MANIFEST_BASENAME", "Manifest",
    "ManifestError", "ManifestMismatch", "build_manifest", "crosscheck_fingerprint",
    "load_or_build_manifest",
    "resolve_file_set",
]
