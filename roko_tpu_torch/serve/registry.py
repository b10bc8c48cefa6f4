"""Model registry: named model versions for the serving fleet (the
port's copy of ``roko_tpu/serve/registry.py``).

A *model version* is the pair the fleet actually runs: a kernel bundle
(the kernel libraries and the identity they were built for, identified by
its digest — ``compile/bundle.py``) plus the params it runs (identified
by a sha256-per-file manifest: the port's checkpoints are ``.pth`` files
or ``train``'s checkpoint directories, whose bytes are hashed as the
reference hashes its own). The registry is a directory of one JSON entry
per name::

    <registry>/<name>.json
        {"name", "bundle_dir", "bundle_digest",
         "params_path", "params_manifest": {"tree_digest", "files"},
         "model": {kind, compute_dtype, quantize}, "registered_unix"}

written atomically by ``python -m roko_tpu_torch compile --register
NAME``. Resolution RE-VERIFIES both halves
against the disk before a rollout may use them: a bundle whose manifest
digest drifted, or params whose bytes no longer hash to the registered
manifest, refuse loudly with the differing detail named
(:class:`RegistryMismatch`) — the same refuse-don't-guess contract as
``BundleMismatch`` and the resume journal. A half-written entry can
never resolve (atomic rename), and a resolved entry pins exactly which
bytes every rolled worker will run.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time
from typing import Any, Callable, Dict, List, Optional

from roko_tpu_torch.compile.bundle import read_manifest

Log = Callable[[str], None]

_FORMAT = 1

#: registry entry names double as filenames and metric label values
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


class RegistryError(RuntimeError):
    """A registry operation cannot proceed (unknown name, bad name,
    re-register without --force, unreadable entry)."""


class RegistryMismatch(RegistryError):
    """A registered version no longer matches the bytes on disk —
    rolling a fleet onto it would serve an unaudited model. Refused,
    never served on faith."""


#: the default registry, beside the kernel build directory
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "roko_tpu_torch_registry",
)


def default_registry_dir() -> str:
    """Layering mirrors the kernel build cache: ``ROKO_REGISTRY`` env >
    config/CLI value > ``build/roko_tpu_torch_registry`` beside the
    package."""
    env = os.environ.get("ROKO_REGISTRY")
    if env:
        return env
    return DEFAULT_DIR


def resolve_registry_dir(explicit: Optional[str] = None) -> str:
    env = os.environ.get("ROKO_REGISTRY")
    return env or explicit or default_registry_dir()


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def params_manifest(params_path: str) -> Dict[str, Any]:
    """``{"tree_digest", "files": {rel: {sha256, bytes}}}`` over a
    checkpoint directory (or a single params file, a torch ``.pth``):
    whatever ``python -m roko_tpu_torch serve MODEL`` accepts."""
    entries: Dict[str, Dict[str, Any]] = {}
    if os.path.isfile(params_path):
        entries[os.path.basename(params_path)] = {
            "sha256": _sha256_file(params_path),
            "bytes": os.path.getsize(params_path),
        }
    elif os.path.isdir(params_path):
        for dirpath, dirnames, filenames in os.walk(params_path):
            dirnames.sort()
            for name in sorted(filenames):
                path = os.path.join(dirpath, name)
                rel = os.path.relpath(path, params_path)
                entries[rel] = {
                    "sha256": _sha256_file(path),
                    "bytes": os.path.getsize(path),
                }
    else:
        raise RegistryError(
            f"params path {params_path!r} does not exist; a registered "
            "version must pin the exact checkpoint bytes it serves"
        )
    if not entries:
        raise RegistryError(
            f"params path {params_path!r} is empty; nothing to pin"
        )
    lines = [f"{rel}:{entries[rel]['sha256']}" for rel in sorted(entries)]
    return {
        "tree_digest": hashlib.sha256("\n".join(lines).encode()).hexdigest(),
        "files": entries,
    }


def _verify_params(params_path: str, manifest: Dict[str, Any]) -> None:
    """Re-hash the params against the registered manifest; any drift —
    missing, truncated, mutated, or ADDED file — raises
    RegistryMismatch. Extra files matter as much as changed ones: the
    checkpoint loader picks the best/latest step dynamically across
    whatever the directory holds, so an unregistered step dir dropped
    in later would ship unaudited bytes through a 'verified' rollout."""
    want = manifest.get("files", {})
    if os.path.isdir(params_path):
        have = set()
        for dirpath, dirnames, filenames in os.walk(params_path):
            dirnames.sort()
            for name in sorted(filenames):
                have.add(
                    os.path.relpath(
                        os.path.join(dirpath, name), params_path
                    )
                )
        extra = sorted(have - set(want))
        if extra:
            raise RegistryMismatch(
                f"registered params dir {params_path!r} grew "
                f"{len(extra)} file(s) not in the manifest (e.g. "
                f"{extra[0]!r}) — the loader would pick checkpoint "
                "steps dynamically, so unaudited bytes could ship; "
                "re-register the version"
            )
    root = params_path if os.path.isdir(params_path) else os.path.dirname(
        params_path
    )
    for rel, entry in sorted(want.items()):
        path = (
            params_path
            if os.path.isfile(params_path)
            and rel == os.path.basename(params_path)
            else os.path.join(root, rel)
        )
        if not os.path.isfile(path):
            raise RegistryMismatch(
                f"registered params file {rel!r} is missing under "
                f"{params_path!r}"
            )
        if os.path.getsize(path) != entry["bytes"]:
            raise RegistryMismatch(
                f"registered params file {rel!r} is "
                f"{os.path.getsize(path)} bytes, manifest says "
                f"{entry['bytes']} — checkpoint changed since registration"
            )
        if _sha256_file(path) != entry["sha256"]:
            raise RegistryMismatch(
                f"registered params file {rel!r} sha256 mismatch — "
                "checkpoint changed since registration; re-register "
                "the version"
            )


def _entry_path(registry_dir: str, name: str) -> str:
    if not _NAME_RE.match(name or ""):
        raise RegistryError(
            f"bad model version name {name!r}: use letters, digits, "
            "'.', '_', '-' (max 64 chars, no leading punctuation)"
        )
    return os.path.join(registry_dir, f"{name}.json")


def register_model(
    registry_dir: str,
    name: str,
    bundle_dir: str,
    params_path: Optional[str] = None,
    *,
    force: bool = False,
    log: Log = print,
) -> Dict[str, Any]:
    """Pin (bundle digest, params manifest) under ``name``. The bundle
    must be a checked export (its manifest carries the digest);
    ``params_path`` is optional — a bundle-only version rolls out
    against the fleet's incumbent checkpoint. Re-registering an
    existing name refuses unless ``force`` (an operator overwriting a
    version under a fleet's feet should have to say so)."""
    path = _entry_path(registry_dir, name)
    manifest = read_manifest(bundle_dir)  # refuses a non-bundle loudly
    entry: Dict[str, Any] = {
        "format": _FORMAT,
        "name": name,
        "bundle_dir": os.path.abspath(bundle_dir),
        "bundle_digest": manifest["digest"],
        "rungs": manifest.get("rungs", []),
        "model": (manifest.get("identity") or {}).get("model", {}),
        "params_path": (
            os.path.abspath(params_path) if params_path else None
        ),
        "params_manifest": (
            params_manifest(params_path) if params_path else None
        ),
        "registered_unix": int(time.time()),
    }
    if os.path.exists(path) and not force:
        try:
            with open(path) as f:
                have = json.load(f)
        except (OSError, ValueError) as e:
            raise RegistryError(
                f"existing registry entry {path!r} is unreadable ({e}); "
                "pass --force to overwrite it"
            ) from None
        same = (
            have.get("bundle_digest") == entry["bundle_digest"]
            and (have.get("params_manifest") or {}).get("tree_digest")
            == (entry["params_manifest"] or {}).get("tree_digest")
            and have.get("params_path") == entry["params_path"]
        )
        if not same:
            raise RegistryError(
                f"model version {name!r} is already registered with a "
                "different bundle/params identity; pick a new name or "
                "pass --force to overwrite"
            )
    os.makedirs(registry_dir, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(entry, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    pdigest = (entry["params_manifest"] or {}).get("tree_digest", "")
    log(
        f"registry: {name} -> bundle {entry['bundle_digest'][:12]} "
        f"params {pdigest[:12] or '(incumbent)'} ({path})"
    )
    return entry


def resolve_model(
    registry_dir: str, name: str, *, verify: bool = True
) -> Dict[str, Any]:
    """Load ``name``'s entry; with ``verify`` (the default, and what
    every rollout uses) re-check the on-disk bundle digest and re-hash
    the params against the registered manifest first."""
    path = _entry_path(registry_dir, name)
    try:
        with open(path) as f:
            entry = json.load(f)
    except FileNotFoundError:
        known = ", ".join(sorted(e["name"] for e in list_models(registry_dir)))
        raise RegistryError(
            f"no model version {name!r} in registry {registry_dir!r}"
            + (f" (known: {known})" if known else " (registry is empty)")
            + "; register one with `python -m roko_tpu_torch compile --register NAME`"
        ) from None
    except ValueError as e:
        raise RegistryError(
            f"registry entry {path!r} is unreadable ({e}); re-register"
        ) from None
    if verify:
        manifest = read_manifest(entry["bundle_dir"])
        if manifest.get("digest") != entry.get("bundle_digest"):
            raise RegistryMismatch(
                f"model version {name!r} pins bundle digest "
                f"{entry.get('bundle_digest', '?')[:12]} but "
                f"{entry['bundle_dir']!r} now holds "
                f"{manifest.get('digest', '?')[:12]} — the bundle was "
                "re-exported since registration; re-register the version"
            )
        if entry.get("params_path"):
            _verify_params(entry["params_path"], entry["params_manifest"])
    return entry


def list_models(registry_dir: str) -> List[Dict[str, Any]]:
    """Every readable entry, sorted by name (unreadable/half-written
    files are skipped — listing is an inventory, not a gate)."""
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(registry_dir))
    except OSError:
        return out
    for fname in names:
        if not fname.endswith(".json"):
            continue
        try:
            with open(os.path.join(registry_dir, fname)) as f:
                entry = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(entry, dict) and entry.get("name"):
            out.append(entry)
    return out
