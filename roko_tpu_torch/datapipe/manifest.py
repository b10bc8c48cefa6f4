"""Index layer: a persistent manifest over a training HDF5 file set.

The port's copy of ``roko_tpu/datapipe/manifest.py``. The manifest
records, per file, its basename, byte size, content digests and per-group
row counts, and cuts the (file, group, row range) span table at
``block_size`` rows, the unit the engine (``engine.py``) permutes. Shard
assignment, epoch order and fast-forward are pure functions of (manifest,
num_shards, shard_id, seed), so a killed and resumed run replays bit for
bit.

Two digests per file: ``sha256`` over the whole content, paid once when
the manifest is built, and ``sample_sha256`` over the size and the first,
middle and last MiB, cheap enough to check at every open.

The sidecar ``roko_datapipe_manifest.json`` (beside a directory's files,
or ``<file>.manifest.json`` beside a single file) has the reference's
bytes: each package loads the other's, with equal fingerprints. A stale
default sidecar is rebuilt with a loud log line; a pinned manifest
(``manifest_path=``, ``--data-manifest``) that no longer matches the files
is refused with the per-file diff.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from roko_tpu_torch.datapipe.io import (
    abort_output,
    open_h5,
    open_input,
    open_output,
    path_scheme,
)

MANIFEST_BASENAME = "roko_datapipe_manifest.json"
MANIFEST_VERSION = 1
#: bytes hashed per stripe by the open-time sample digest
SAMPLE_BYTES = 1 << 20
#: rows of one span block
DEFAULT_BLOCK_SIZE = 256


class ManifestError(RuntimeError):
    """The manifest cannot be built or loaded (no inputs, inconsistent
    geometry, unreadable file)."""


class ManifestMismatch(ManifestError):
    """The file set on disk does not match the manifest; the message
    holds the per-file diff."""


def _is_remote(path: str) -> bool:
    return path_scheme(path) not in ("", "file")


def resolve_file_set(spec: Union[str, Sequence[str]]) -> List[str]:
    """A file, a directory, or a list of paths and globs -> the file set,
    sorted by basename (the order every host agrees on), symlinked
    duplicates dropped. A URL names one file and passes through."""
    from roko_tpu_torch.data.hdf5 import file_identity, hdf5_files

    specs = [spec] if isinstance(spec, str) else list(spec)
    if not specs:
        raise ManifestError("empty input file-set spec")
    found: List[str] = []
    for s in specs:
        if _is_remote(s):
            found.append(s)
        elif os.path.isdir(s) or os.path.isfile(s):
            found.extend(hdf5_files(s))
        else:
            matches = sorted(_glob.glob(s))
            if not matches:
                raise ManifestError(f"no HDF5 inputs match {s!r}")
            for m in matches:
                found.extend(hdf5_files(m))
    out: List[str] = []
    seen: set = set()
    for p in sorted(found, key=lambda p: (os.path.basename(p), p)):
        ident = p if _is_remote(p) else file_identity(p)
        if ident in seen:
            continue
        seen.add(ident)
        out.append(p)
    if not out:
        raise ManifestError(f"no HDF5 inputs under {spec!r}")
    return out


def _file_size(path: str) -> int:
    if not _is_remote(path):
        return os.path.getsize(path)
    with open_input(path) as f:
        return f.seek(0, os.SEEK_END)


def _sample_digest(path: str) -> str:
    """sha256 over the size and the first, middle and last SAMPLE_BYTES."""
    size = _file_size(path)
    h = hashlib.sha256(str(size).encode())
    with open_input(path) as f:
        offsets = {0, max(0, size // 2 - SAMPLE_BYTES // 2), max(0, size - SAMPLE_BYTES)}
        for off in sorted(offsets):
            f.seek(off)
            h.update(f.read(SAMPLE_BYTES))
    return h.hexdigest()


def _full_digest(path: str) -> str:
    h = hashlib.sha256()
    with open_input(path) as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class FileEntry:
    name: str  # basename: the identity across hosts, whose roots differ
    size: int
    sha256: str  # whole content, at build time
    sample_sha256: str  # the cheap open-time check
    groups: Tuple[Tuple[str, int], ...]  # (group name, rows)


@dataclasses.dataclass(frozen=True)
class Span:
    """One block of consecutive rows inside (file, group): the unit the
    engine permutes and the reader reads."""

    file_idx: int
    group: str
    start: int
    count: int


@dataclasses.dataclass(frozen=True)
class Manifest:
    files: Tuple[FileEntry, ...]
    block_size: int
    labeled: bool
    x_shape: Tuple[int, ...]  # one row's example shape
    x_dtype: str
    y_shape: Tuple[int, ...]  # one row's label shape (() when unlabelled)
    y_dtype: str

    @property
    def total_rows(self) -> int:
        return sum(r for fe in self.files for _, r in fe.groups)

    @property
    def fingerprint(self) -> str:
        """The corpus identity: a digest over the file entries, content
        digests included; independent of the block size."""
        blob = json.dumps(
            [[fe.name, fe.size, fe.sha256, list(map(list, fe.groups))] for fe in self.files],
            sort_keys=True,
        )
        return hashlib.sha256(blob.encode()).hexdigest()

    def spans(self, block_size: Optional[int] = None) -> List[Span]:
        """The span table cut at ``block_size`` rows (default: the
        manifest's own)."""
        bs = block_size or self.block_size
        out: List[Span] = []
        for fi, fe in enumerate(self.files):
            for g, rows in fe.groups:
                for start in range(0, rows, bs):
                    out.append(Span(fi, g, start, min(bs, rows - start)))
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": MANIFEST_VERSION,
            "block_size": self.block_size,
            "labeled": self.labeled,
            "x_shape": list(self.x_shape),
            "x_dtype": self.x_dtype,
            "y_shape": list(self.y_shape),
            "y_dtype": self.y_dtype,
            "fingerprint": self.fingerprint,
            "files": [
                {
                    "name": fe.name,
                    "size": fe.size,
                    "sha256": fe.sha256,
                    "sample_sha256": fe.sample_sha256,
                    "groups": [[g, r] for g, r in fe.groups],
                }
                for fe in self.files
            ],
        }

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "Manifest":
        files = tuple(
            FileEntry(
                name=f["name"],
                size=int(f["size"]),
                sha256=f["sha256"],
                sample_sha256=f["sample_sha256"],
                groups=tuple((g, int(r)) for g, r in f["groups"]),
            )
            for f in raw["files"]
        )
        return Manifest(
            files=files,
            block_size=int(raw["block_size"]),
            labeled=bool(raw["labeled"]),
            x_shape=tuple(raw["x_shape"]),
            x_dtype=raw["x_dtype"],
            y_shape=tuple(raw["y_shape"]),
            y_dtype=raw["y_dtype"],
        )

    def save(self, path: str) -> None:
        """Atomic write: tmp, fsync, rename (a remote path through
        :func:`open_output`)."""
        if _is_remote(path):
            fh = open_output(path, "w")
            try:
                json.dump(self.to_dict(), fh, indent=1, sort_keys=True)
            except BaseException:
                abort_output(fh)
                raise
            fh.close()
            return
        tmp = f"{path}.tmp.{os.getpid()}"  # ranks of one run may save at once
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> "Manifest":
        try:
            with open_input(path) as f:
                raw = json.loads(f.read().decode("utf-8"))
        except (OSError, ValueError) as e:
            raise ManifestError(f"unreadable manifest {path}: {e}") from None
        if raw.get("version") != MANIFEST_VERSION:
            raise ManifestError(
                f"manifest {path} has version {raw.get('version')!r}; "
                f"this build reads version {MANIFEST_VERSION}"
            )
        return Manifest.from_dict(raw)

    def verify_files(self, paths: Sequence[str]) -> None:
        """Raise :class:`ManifestMismatch` with the per-file diff (missing,
        extra, changed in size or sampled content) unless ``paths`` is
        the manifest's file set."""
        by_name = {os.path.basename(p): p for p in paths}
        missing = [fe.name for fe in self.files if fe.name not in by_name]
        known = {fe.name for fe in self.files}
        extra = sorted(n for n in by_name if n not in known)
        changed: List[str] = []
        for fe in self.files:
            p = by_name.get(fe.name)
            if p is None:
                continue
            size = _file_size(p)
            if size != fe.size:
                changed.append(f"{fe.name} (size {fe.size} -> {size})")
            elif _sample_digest(p) != fe.sample_sha256:
                changed.append(f"{fe.name} (content digest changed)")
        if missing or extra or changed:
            parts = []
            if missing:
                parts.append("missing: " + ", ".join(missing))
            if extra:
                parts.append("extra: " + ", ".join(extra))
            if changed:
                parts.append("changed: " + ", ".join(changed))
            raise ManifestMismatch(
                "file set does not match manifest "
                f"(fingerprint {self.fingerprint[:12]}): " + "; ".join(parts)
            )


def _scan_file(path: str, require_labels: bool) -> Tuple[FileEntry, Dict[str, Any]]:
    from roko_tpu_torch.data.hdf5 import data_group_names

    groups: List[Tuple[str, int]] = []
    geom: Dict[str, Any] = {}
    with open_h5(path) as fd:
        for g in data_group_names(fd):
            ex = fd[g]["examples"]
            if require_labels and "labels" not in fd[g]:
                raise ManifestError(f"{path}:{g} has no labels")
            groups.append((g, int(ex.shape[0])))
            row_geom = {"x_shape": tuple(ex.shape[1:]), "x_dtype": str(ex.dtype)}
            if "labels" in fd[g]:
                lb = fd[g]["labels"]
                row_geom["y_shape"] = tuple(lb.shape[1:])
                row_geom["y_dtype"] = str(lb.dtype)
            if not geom:
                geom = row_geom
            elif geom != row_geom:
                raise ManifestError(
                    f"inconsistent row geometry across the file set: "
                    f"{path}:{g} has {row_geom}, earlier groups {geom}"
                )
    entry = FileEntry(
        name=os.path.basename(path),
        size=_file_size(path),
        sha256=_full_digest(path),
        sample_sha256=_sample_digest(path),
        groups=tuple(groups),
    )
    return entry, geom


def build_manifest(
    spec: Union[str, Sequence[str]],
    *,
    block_size: int = DEFAULT_BLOCK_SIZE,
    require_labels: bool = True,
    log=None,
) -> Tuple[Manifest, List[str]]:
    """Scan the resolved file set into a fresh manifest: one full hash
    per file."""
    paths = resolve_file_set(spec)
    names = [os.path.basename(p) for p in paths]
    if len(set(names)) != len(names):
        dup = sorted({n for n in names if names.count(n) > 1})
        raise ManifestError(
            "duplicate basenames in the file set (the manifest's cross-host "
            f"identity is the basename): {', '.join(dup)}"
        )
    # every resolved file gets an entry, one with no groups too: files[i]
    # stays aligned with the path list
    entries: List[FileEntry] = []
    geom: Dict[str, Any] = {}
    for p in paths:
        entry, g = _scan_file(p, require_labels)
        entries.append(entry)
        if not g:
            continue
        if not geom:
            geom = g
        elif geom != g:
            raise ManifestError(
                f"inconsistent row geometry across the file set at {p}: {g} vs {geom}"
            )
    if not geom or not any(fe.groups for fe in entries):
        raise ManifestError(f"no training groups found under {spec!r}")
    manifest = Manifest(
        files=tuple(entries),
        block_size=block_size,
        labeled="y_dtype" in geom,
        x_shape=geom["x_shape"],
        x_dtype=geom["x_dtype"],
        y_shape=geom.get("y_shape", ()),
        y_dtype=geom.get("y_dtype", ""),
    )
    if log is not None:
        log(
            f"datapipe: indexed {len(manifest.files)} file(s), "
            f"{manifest.total_rows} rows, {len(manifest.spans())} spans "
            f"(block {manifest.block_size}), fingerprint {manifest.fingerprint[:12]}"
        )
    return manifest, paths


def default_manifest_path(spec: Union[str, Sequence[str]]) -> Optional[str]:
    """The sidecar of a simple spec: inside a directory, beside a single
    file (or URL); none for a list or glob unless pinned."""
    if isinstance(spec, str):
        if _is_remote(spec):
            return spec + ".manifest.json"
        if os.path.isdir(spec):
            return os.path.join(spec, MANIFEST_BASENAME)
        if os.path.isfile(spec):
            return spec + ".manifest.json"
    return None


def _manifest_exists(mpath: str) -> bool:
    if not _is_remote(mpath):
        return os.path.exists(mpath)
    try:
        open_input(mpath).close()
        return True
    except (OSError, ValueError):
        return False


def load_or_build_manifest(
    spec: Union[str, Sequence[str]],
    *,
    manifest_path: Optional[str] = None,
    block_size: int = DEFAULT_BLOCK_SIZE,
    require_labels: bool = True,
    log=None,
) -> Tuple[Manifest, List[str]]:
    """A persisted manifest that matches the files, else a fresh one
    (persisted when it can be). A pinned ``manifest_path`` that does not
    match refuses; the default sidecar is rebuilt with a log line."""
    pinned = manifest_path is not None
    mpath = manifest_path or default_manifest_path(spec)
    paths = resolve_file_set(spec)
    if mpath and _manifest_exists(mpath):
        try:
            manifest = Manifest.load(mpath)
            manifest.verify_files(paths)
        except ManifestError as e:
            if pinned:
                raise
            if log is not None:
                log(
                    f"datapipe: manifest {mpath} is stale or unreadable for the "
                    f"file set on disk ({e}); rebuilding the index"
                )
        else:
            if manifest.block_size != block_size:
                manifest = dataclasses.replace(manifest, block_size=block_size)
            return manifest, paths
    manifest, paths = build_manifest(
        paths, block_size=block_size, require_labels=require_labels, log=log
    )
    if mpath:
        try:
            manifest.save(mpath)
        except (OSError, ValueError) as e:  # a read-only corpus: the index stays in RAM
            if log is not None:
                log(f"datapipe: could not persist manifest at {mpath}: {e}")
    return manifest, paths


def crosscheck_corpus(fingerprint: str, n_files: int, n_rows: int, names: str) -> None:
    """Every process of a run must see the same corpus, or the shard
    assignment is undefined: gathers each rank's ``[hi, lo, files, rows]``
    (the fingerprint's first 64 bits as two int32s) as CPU tensors and
    raises :class:`ManifestMismatch` on every rank when one differs. A run
    of one process has nothing to compare."""
    from roko_tpu_torch.parallel import distributed

    if distributed.world_size() <= 1:
        return
    import numpy as np
    import torch

    mine = np.asarray([*fingerprint32_pair(fingerprint), n_files, n_rows], np.int64)
    allv = distributed.all_gather_cpu(torch.from_numpy(mine)).numpy()
    bad = [i for i in range(allv.shape[0]) if not np.array_equal(allv[i], mine)]
    if bad:
        raise ManifestMismatch(
            f"hosts disagree on the training file set: process "
            f"{distributed.rank()} fingerprint {fingerprint[:12]} "
            f"({n_files} files, {n_rows} rows: {names}) differs from process(es) {bad}. "
            "Every host must see the identical corpus — sync the files or pin a shared "
            "manifest with --data-manifest, then compare each host's refusal line to see "
            "the per-host diff."
        )


def crosscheck_fingerprint(manifest: Manifest, log=None) -> None:
    """Multi-process agreement check of ``roko_tpu/datapipe/manifest.py:515-540``:
    every process must have computed the same corpus fingerprint
    (:func:`crosscheck_corpus`). No-op in one process."""
    crosscheck_corpus(manifest.fingerprint, len(manifest.files), manifest.total_rows,
                      ", ".join(fe.name for fe in manifest.files))


def fingerprint32_pair(fingerprint: str) -> Tuple[int, int]:
    """A fingerprint's first 64 bits as two signed int32s, as the
    reference's ``Manifest.fingerprint32_pair`` gives them."""
    v = int(fingerprint[:16], 16)
    hi, lo = (v >> 32) & 0xFFFFFFFF, v & 0xFFFFFFFF
    return (hi - (1 << 32) if hi >= 1 << 31 else hi,
            lo - (1 << 32) if lo >= 1 << 31 else lo)
