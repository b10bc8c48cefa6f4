"""Kernel bundles: a model's built kernel libraries on disk, with the
identity they were built for (the port's counterpart of
``roko_tpu/compile/bundle.py``).

The reference serializes one XLA executable per ladder rung. Eager
PyTorch has no such executable: the port's only compiled artifacts are
the nvcc-built kernel libraries (``kernels.py``). So the port's bundle
is the reference's manifest, identity and digest, plus the libraries the
model's kind and dtype launch::

    <bundle>/manifest.json              identity + digest + rungs + libraries
    <bundle>/lib/gru_fwd-<hash>.so      the library, with its sha256 in the manifest

``python -m roko_tpu_torch compile`` builds the libraries, copies them
in, runs every rung of the ladder once through a randomly initialised
model, and writes the manifest last (atomically), so a crashed export
never looks loadable. On the CPU it writes an identity-only bundle with
no libraries. A loading process (``PolishSession.warmup``, the streaming
polish, ``infer.run_inference``) checks the identity digest and every
library's sha256, then points ``kernels.library`` at the bundle's
copies: no nvcc runs. Any difference refuses with :class:`BundleMismatch`
naming what differs, never a quiet rebuild.

The identity covers what the kernels and the correctness of their
outputs depend on: the full ``ModelConfig`` (its window geometry and its
resolved ``compute_dtype`` and ``quantize`` included), the mesh
``(dp, tp, sp)``, the platform, the card's name and compute capability,
the torch and CUDA versions (in place of the reference's jax version) and
the digest of each kernel's sources and nvcc flags. It holds no path and
no per-process value, so identical workers accept each other's bundle.

Nothing here imports torch at module level: the registry reads manifests
in the supervisor, which never touches the card.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence

BUNDLE_MANIFEST = "manifest.json"
BUNDLE_VERSION = 1
LIB_DIR = "lib"

Log = Callable[[str], None]


class BundleMismatch(RuntimeError):
    """A kernel bundle does not match the running process. Carrying on
    would run kernels built for a different model, card or toolchain, or
    build them anew behind the operator's back, so loading refuses."""


class BundleMissing(BundleMismatch, FileNotFoundError):
    """The directory holds no manifest: not a bundle (a
    :class:`BundleMismatch` and, as the reference raises, a
    ``FileNotFoundError``)."""


def _canonical(obj: Any) -> Any:
    """JSON-normalise (tuples -> lists) so identity comparison and digests
    are stable across load/dump round trips."""
    return json.loads(json.dumps(obj, sort_keys=True))


def _mesh_sizes(cfg, mesh) -> Dict[str, int]:
    if mesh is None:
        from roko_tpu_torch.parallel.mesh import mesh_shape

        mesh = mesh_shape(cfg.mesh)
    if not isinstance(mesh, (tuple, list)):
        mesh = (mesh.dp, mesh.tp, mesh.sp)
    dp, tp, sp = (int(v) for v in mesh)
    return {"dp": dp, "tp": tp, "sp": sp}


def _device_identity(backend: Optional[str], device_kind: Optional[str]):
    import torch

    platform = backend or ("cuda" if torch.cuda.is_available() else "cpu")
    capability = None
    if platform == "cuda":
        if device_kind is None:
            device_kind = torch.cuda.get_device_name(0)
        major, minor = torch.cuda.get_device_capability(0)
        capability = f"{major}.{minor}"
    return platform, device_kind or "cpu", capability


def bundle_identity(cfg, mesh=None, *, backend: Optional[str] = None,
                    device_kind: Optional[str] = None) -> Dict[str, Any]:
    """Everything the bundled kernels (and the correctness of their
    outputs) depend on. ``mesh`` is a ``(dp, tp, sp)`` tuple or a
    ``parallel.mesh.Mesh`` (default: ``cfg.mesh`` over this run's
    processes); ``backend`` and ``device_kind`` default to this process's
    card, or the CPU without one."""
    import torch

    from roko_tpu_torch import kernels

    platform, kind, capability = _device_identity(backend, device_kind)
    model = cfg.model.resolve(platform)
    return _canonical({
        "bundle_version": BUNDLE_VERSION,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": platform,
        "device_kind": kind,
        "compute_capability": capability,
        "mesh": _mesh_sizes(cfg, mesh),
        # compute_dtype="auto" digests as the dtype it resolves to here
        # (float32 on cuda and cpu): an "auto" session and an explicit one
        # run the same kernels and share a digest; quantize rides along
        "model": dataclasses.asdict(model),
        "kernels": {n: kernels.source_digest(n) for n in kernels.inference_kernels(model)},
    })


def bundle_digest(identity: Dict[str, Any]) -> str:
    """sha256 over the canonical identity JSON."""
    blob = json.dumps(_canonical(identity), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


def _identity_diff(ours: Any, theirs: Any, prefix: str = "") -> list:
    """Field-level diff between two identities, ``field: bundle=.. run=..``."""
    if isinstance(ours, dict) and isinstance(theirs, dict):
        out = []
        for key in sorted(set(ours) | set(theirs)):
            out += _identity_diff(ours.get(key, "<absent>"), theirs.get(key, "<absent>"),
                                  f"{prefix}{key}.")
        return out
    if ours != theirs:
        return [f"{prefix[:-1]}: bundle={theirs!r} run={ours!r}"]
    return []


def _sha256_file(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _write_json_atomic(path: str, obj: Dict[str, Any]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def export_bundle(
    out_dir: str,
    cfg,
    *,
    mesh=None,
    ladder: Optional[Sequence[int]] = None,
    device: str = "cuda",
    log: Log = print,
) -> Optional[Dict[str, Any]]:
    """Build the libraries ``cfg.model`` launches on ``device``, copy them
    into ``out_dir/lib/``, run every rung of the ladder once through a
    randomly initialised model, and write the manifest last; returns it.
    On the CPU the bundle holds the identity and the rungs, no library.
    ``mesh`` a ``parallel.mesh.Mesh`` of several ranks runs the rungs on
    one session over them: every rank builds, rank 0 alone writes and
    returns the manifest, and the other ranks follow and return None."""
    import torch

    from roko_tpu_torch import kernels
    from roko_tpu_torch.config import resolve_ladder, validate_ladder
    from roko_tpu_torch.infer import resolve_device
    from roko_tpu_torch.models.model import RokoModel
    from roko_tpu_torch.parallel import distributed
    from roko_tpu_torch.serve.session import PolishSession

    dev = distributed.device_of_rank(resolve_device(device))
    grid = mesh if hasattr(mesh, "rank") else None  # a session's Mesh, not sizes
    dp = _mesh_sizes(cfg, mesh)["dp"]
    rungs = resolve_ladder(cfg.serve, dp) if ladder is None else tuple(sorted(set(ladder)))
    if not rungs:
        raise ValueError("bundle ladder must name at least one batch size")
    validate_ladder(rungs, dp)
    identity = bundle_identity(cfg, mesh, backend=dev.type)
    leader = grid is None or grid.rank == 0
    if leader:
        os.makedirs(out_dir, exist_ok=True)
        # a stale manifest must not describe what is about to change
        try:
            os.unlink(os.path.join(out_dir, BUNDLE_MANIFEST))
        except OSError:
            pass
    t0 = time.perf_counter()
    libraries: Dict[str, Dict[str, Any]] = {}
    if dev.type == "cuda":
        names = list(identity["kernels"])
        kernels.build(names)
    model = RokoModel(cfg.model, generator=torch.Generator().manual_seed(0), mesh=grid)
    session = PolishSession(model, cfg, device=dev, mesh=grid, ladder=rungs)
    if not leader:
        session.follow()
        return None
    if dev.type == "cuda":
        os.makedirs(os.path.join(out_dir, LIB_DIR), exist_ok=True)
        for name in names:
            src = kernels.library_path(name)
            rel = os.path.join(LIB_DIR, src.name)
            tmp = os.path.join(out_dir, rel + ".tmp")
            shutil.copyfile(src, tmp)
            os.replace(tmp, os.path.join(out_dir, rel))
            libraries[name] = {"file": rel, "sha256": _sha256_file(os.path.join(out_dir, rel)),
                               "bytes": os.path.getsize(os.path.join(out_dir, rel))}
            log(f"compile: {name} -> {rel}")
    shape = (cfg.model.window_rows, cfg.model.window_cols)
    per_rung: Dict[str, float] = {}
    try:
        for rung in rungs:
            t_r = time.perf_counter()
            session.predict(_zeros(rung, shape))
            per_rung[str(rung)] = round(time.perf_counter() - t_r, 3)
            log(f"compile: rung {rung} ran in {per_rung[str(rung)]:.2f}s")
    finally:
        session.stop()
    manifest = {
        "bundle_version": BUNDLE_VERSION,
        "identity": identity,
        "digest": bundle_digest(identity),
        "rungs": list(rungs),
        "rung_seconds": per_rung,
        "libraries": libraries,
        "created_unix": int(time.time()),
    }
    _write_json_atomic(os.path.join(out_dir, BUNDLE_MANIFEST), manifest)
    log(f"compile: bundle {out_dir} ready — {len(libraries)} librar"
        f"{'y' if len(libraries) == 1 else 'ies'}, {len(rungs)} rung(s) in "
        f"{time.perf_counter() - t0:.1f}s, digest {manifest['digest'][:12]}")
    return manifest


def _zeros(rung: int, shape):
    import numpy as np

    return np.zeros((rung,) + tuple(shape), np.uint8)


def read_manifest(bundle_dir: str) -> Dict[str, Any]:
    """The bundle's manifest (:class:`BundleMissing` naming the missing
    file when the directory is not a bundle)."""
    path = os.path.join(bundle_dir, BUNDLE_MANIFEST)
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise BundleMissing(
            f"{bundle_dir!r} is not a kernel bundle (no {BUNDLE_MANIFEST}); "
            "create one with `python -m roko_tpu_torch compile <out_dir>`") from None


def check_bundle(
    bundle_dir: str,
    cfg,
    *,
    mesh=None,
    rungs: Optional[Sequence[int]] = None,
    require_all: bool = False,
    backend: Optional[str] = None,
) -> Dict[str, Any]:
    """Every check :func:`load_bundle` makes, without installing anything:
    the manifest exists (else :class:`BundleMissing`), the identity digest
    is this process's (else :class:`BundleMismatch` naming each differing
    field), with ``require_all`` every requested rung is there, on a card
    the bundle carries every library the model launches, and every
    library it lists is present with its recorded sha256. Returns
    ``{"manifest", "paths": {kernel: library path}, "rungs": [...]}``."""
    manifest = read_manifest(bundle_dir)
    theirs = manifest.get("identity", {})
    ours = bundle_identity(cfg, mesh, backend=backend)
    if bundle_digest(ours) != manifest.get("digest") or bundle_digest(theirs) != manifest.get(
            "digest"):
        diff = _identity_diff(ours, theirs)
        raise BundleMismatch(
            f"kernel bundle {bundle_dir!r} was built for a different program; refusing to "
            "load it (mismatched kernels would give wrong results, and rebuilding them "
            "would hide it). Differing fields:\n  "
            + "\n  ".join(diff or ["<digest mismatch only>"])
            + "\nRe-export with `python -m roko_tpu_torch compile` under the current "
            "config and card, or drop --bundle.")
    have = {int(r) for r in manifest.get("rungs", [])}
    want = set(int(r) for r in rungs) if rungs is not None else set(have)
    missing = sorted(want - have)
    if missing and require_all:
        raise BundleMismatch(
            f"kernel bundle {bundle_dir!r} has rungs {sorted(have)} but this ladder needs "
            f"{sorted(want)} (missing {missing}); re-export with `python -m roko_tpu_torch "
            f"compile --ladder {','.join(str(r) for r in sorted(want))}`")
    libs = manifest.get("libraries", {})
    if ours["backend"] == "cuda":
        lacking = [n for n in ours["kernels"] if n not in libs]
        if lacking:
            raise BundleMismatch(f"kernel bundle {bundle_dir!r} carries no library for "
                                 f"{lacking}, which this model launches")
    paths: Dict[str, Path] = {}
    for name, entry in sorted(libs.items()):
        path = Path(bundle_dir) / entry["file"]
        if not path.is_file():
            raise BundleMismatch(f"kernel bundle {bundle_dir!r}: library {entry['file']} "
                                 f"of {name} is missing")
        got = _sha256_file(path)
        if got != entry["sha256"]:
            raise BundleMismatch(
                f"kernel bundle {bundle_dir!r}: library {entry['file']} of {name} has "
                f"sha256 {got[:12]}, the manifest says {entry['sha256'][:12]}; the file "
                "changed since export, refusing to load it")
        paths[name] = path
    return {"manifest": manifest, "paths": paths, "rungs": sorted(want & have)}


def load_bundle(
    bundle_dir: str,
    cfg,
    *,
    mesh=None,
    rungs: Optional[Sequence[int]] = None,
    require_all: bool = False,
    log: Log = print,
) -> Dict[str, Any]:
    """Check the bundle (:func:`check_bundle`) and, on a card, point
    ``kernels.library`` at its libraries, so no nvcc runs in this process.
    Returns what :func:`check_bundle` returns. ``rungs`` None checks every
    rung the bundle has; otherwise a rung it lacks is refused with
    ``require_all`` and runs as usual without (the batch paths' one-off
    tail shapes)."""
    from roko_tpu_torch import kernels

    t0 = time.perf_counter()
    checked = check_bundle(bundle_dir, cfg, mesh=mesh, rungs=rungs, require_all=require_all)
    if checked["manifest"]["identity"]["backend"] == "cuda":
        kernels.install_bundle(os.path.abspath(bundle_dir), checked["paths"])
    log(f"kernel bundle: {len(checked['paths'])} librar"
        f"{'y' if len(checked['paths']) == 1 else 'ies'} {sorted(checked['paths'])} and rungs "
        f"{checked['rungs']} from {bundle_dir} checked in {time.perf_counter() - t0:.2f}s "
        f"(digest {checked['manifest']['digest'][:12]})")
    return checked


def verify_main(bundle_dir: str, cfg_json_path: str, device: str = "cuda") -> None:
    """Child half of ``python -m roko_tpu_torch compile``'s check: in this
    fresh process, load the bundle (no nvcc may run) and run every rung on
    a zero batch through a randomly initialised model."""
    import torch

    from roko_tpu_torch.compile.cache import cache_counters
    from roko_tpu_torch.config import RokoConfig
    from roko_tpu_torch.infer import resolve_device
    from roko_tpu_torch.models.model import RokoModel
    from roko_tpu_torch.serve.session import PolishSession

    with open(cfg_json_path) as f:
        cfg = RokoConfig.from_json(f.read())
    dev = resolve_device(device)
    manifest = read_manifest(bundle_dir)
    rungs = [int(r) for r in manifest["rungs"]]
    # this one process stands in for every rank of the grid the bundle
    # names: its libraries and rungs are what one rank loads and runs
    grid = manifest["identity"]["mesh"]
    load_bundle(bundle_dir, cfg, mesh=(grid["dp"], grid["tp"], grid["sp"]), rungs=rungs,
                require_all=True, log=lambda m: None)
    session = PolishSession(RokoModel(cfg.model, generator=torch.Generator().manual_seed(0)),
                            cfg, device=dev, ladder=rungs)
    shape = (cfg.model.window_rows, cfg.model.window_cols)
    for rung in rungs:
        session.predict(_zeros(rung, shape))
    hits, misses = cache_counters()
    if misses:
        raise SystemExit(f"verify: {misses} kernel(s) were built with nvcc; the bundle "
                         "should have carried them")
    print(f"verified {len(rungs)} rung(s): {rungs}")


def wrap_predict(step: Callable, execs: Dict[int, Callable]) -> Callable:
    """Dispatch by batch rows: ``execs[rows]`` when the batch has a rung
    there, ``step`` otherwise (the reference's AOT routing)."""
    if not execs:
        return step

    def predict(params, x):
        fn = execs.get(int(x.shape[0]))
        return fn(params, x) if fn is not None else step(params, x)

    return predict
