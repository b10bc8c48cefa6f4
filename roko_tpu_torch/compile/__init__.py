"""Cold start of the port (``roko_tpu/compile``): the kernel build cache
(:mod:`cache`), kernel bundles (:mod:`bundle`) and the ladder warmup
(:mod:`warmup`).

Every start of a worker used to pay nvcc for the kernels its model
launches. The build cache keeps the libraries (named by a hash of their
sources and flags) on disk, so a later start loads them; a bundle
carries them beside the identity they were built for, so a worker
started from it runs no nvcc at all and refuses a bundle built for
another model, card or toolchain (:class:`BundleMismatch`). Nothing here
imports torch at module level."""

from roko_tpu_torch.compile.bundle import (
    BUNDLE_MANIFEST,
    BundleMismatch,
    BundleMissing,
    bundle_digest,
    bundle_identity,
    check_bundle,
    export_bundle,
    load_bundle,
    read_manifest,
    wrap_predict,
)
from roko_tpu_torch.compile.cache import (
    cache_counters,
    cache_entry_count,
    cache_total_bytes,
    enable_persistent_cache,
    resolve_cache_dir,
)
from roko_tpu_torch.compile.warmup import WarmupReport, warmup_ladder

__all__ = [
    "BUNDLE_MANIFEST",
    "BundleMismatch",
    "BundleMissing",
    "WarmupReport",
    "bundle_digest",
    "bundle_identity",
    "cache_counters",
    "cache_entry_count",
    "cache_total_bytes",
    "check_bundle",
    "enable_persistent_cache",
    "export_bundle",
    "load_bundle",
    "read_manifest",
    "resolve_cache_dir",
    "warmup_ladder",
    "wrap_predict",
]
