"""Checkpoints of the port: ``torch.save`` files with an integrity chain.

Torch-native counterpart of ``roko_tpu/training/checkpoint.py``, with
its rules:

- a checkpoint is a directory holding ``state.pt`` (model and Adam
  ``state_dict``, step, epoch, early-stopping counters, data position and
  guard state) and ``metrics.json`` (its val accuracy);
- every save commits a ``roko_manifest.json`` (sha256 and size per file
  and a digest over them) atomically after the write (:43-136), so a
  save killed midway leaves a directory without a committed manifest,
  never a silently truncated one;
- the manager keeps the best ``keep`` checkpoints by val accuracy, named
  by step, plus ``latest``, overwritten at every save;
- :meth:`CheckpointManager.restore_latest` walks ``latest`` and then the
  numbered ones newest first, skips any that does not verify with a
  ``ROKO_GUARD event=ckpt_corrupt`` line, and raises
  :class:`CheckpointIntegrityError` when checkpoints exist but none
  verifies;
- :func:`load_params` returns the best checkpoint's model state_dict.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from roko_tpu_torch.training.guard import guard_line

#: committed last, atomically: its presence is the commit record
MANIFEST_NAME = "roko_manifest.json"
STATE_NAME = "state.pt"
METRICS_NAME = "metrics.json"


class CheckpointIntegrityError(RuntimeError):
    """Checkpoints exist but none verifies: refuse to train from scratch
    over them."""


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _manifest_entries(ckpt_dir: str) -> Dict[str, Dict[str, Any]]:
    entries: Dict[str, Dict[str, Any]] = {}
    for dirpath, dirnames, filenames in os.walk(ckpt_dir):
        dirnames.sort()
        for name in sorted(filenames):
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, ckpt_dir)
            if rel == MANIFEST_NAME:
                continue
            entries[rel] = {"sha256": _sha256_file(path), "bytes": os.path.getsize(path)}
    return entries


def _tree_digest(entries: Dict[str, Dict[str, Any]]) -> str:
    lines = [f"{rel}:{entries[rel]['sha256']}" for rel in sorted(entries)]
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


def write_manifest(ckpt_dir: str) -> str:
    """Hash every file under ``ckpt_dir`` and commit the manifest
    atomically (tmp, fsync, rename, fsync of the directory). Call only
    after the checkpoint's files are written."""
    entries = _manifest_entries(ckpt_dir)
    manifest = {"version": 1, "tree_digest": _tree_digest(entries), "files": entries}
    path = os.path.join(ckpt_dir, MANIFEST_NAME)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dir_fd = os.open(ckpt_dir, os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)
    return path


def verify_manifest(ckpt_dir: str) -> Tuple[str, str]:
    """``("ok" | "corrupt" | "unverified", detail)`` for ``ckpt_dir``
    against its committed manifest; "unverified" means no manifest."""
    path = os.path.join(ckpt_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        return "unverified", "no manifest"
    try:
        with open(path) as f:
            manifest = json.load(f)
        files = manifest["files"]
        digest = manifest["tree_digest"]
    except (OSError, ValueError, KeyError) as e:
        return "corrupt", f"unreadable manifest ({e})"
    if _tree_digest(files) != digest:
        return "corrupt", "manifest tree digest mismatch"
    for rel, want in sorted(files.items()):
        fpath = os.path.join(ckpt_dir, rel)
        if not os.path.exists(fpath):
            return "corrupt", f"missing file {rel}"
        size = os.path.getsize(fpath)
        if size != want["bytes"]:
            return "corrupt", f"truncated file {rel} ({size} != {want['bytes']} bytes)"
        if _sha256_file(fpath) != want["sha256"]:
            return "corrupt", f"sha256 mismatch on {rel}"
    return "ok", f"{len(files)} files verified"


def _default_log(msg: str) -> None:
    print(msg, file=sys.stderr)


class CheckpointManager:
    """Best ``keep`` checkpoints by val accuracy plus ``latest``."""

    def __init__(self, directory: str, keep: int = 3,
                 log: Optional[Callable[[str], None]] = None):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self._log = log if log is not None else _default_log
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: Union[str, int]) -> str:
        return os.path.join(self.directory, str(name))

    def _steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit())

    def _val_acc(self, step: int) -> float:
        try:
            with open(os.path.join(self._path(step), METRICS_NAME)) as f:
                return float(json.load(f)["val_acc"])
        except (OSError, ValueError, KeyError):
            return float("-inf")

    def _write(self, name: Union[str, int], state: Dict[str, Any], val_acc: float) -> None:
        """Write into a fresh directory, move it into place, then commit
        its manifest."""
        final = self._path(name)
        tmp = f"{final}.tmp.{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE_NAME))
        with open(os.path.join(tmp, METRICS_NAME), "w") as f:
            json.dump({"val_acc": float(val_acc)}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        write_manifest(final)

    def save(self, step: int, state: Dict[str, Any], val_acc: float) -> None:
        """Save ``state`` as checkpoint ``step`` and as ``latest``, then
        keep the best ``keep`` numbered ones (newer first on ties)."""
        self._write(step, state, val_acc)
        self._write("latest", state, val_acc)
        ranked = sorted(self._steps(), key=lambda s: (self._val_acc(s), s), reverse=True)
        for s in ranked[self.keep :]:
            shutil.rmtree(self._path(s), ignore_errors=True)

    def _candidates(self) -> List[Tuple[Union[str, int], str]]:
        out: List[Tuple[Union[str, int], str]] = []
        if os.path.isdir(self._path("latest")):
            out.append(("latest", self._path("latest")))
        out.extend((s, self._path(s)) for s in reversed(self._steps()))
        return out

    def _load(self, path: str) -> Dict[str, Any]:
        return torch.load(os.path.join(path, STATE_NAME), map_location="cpu",
                          weights_only=True)

    def restore_latest(self) -> Optional[Dict[str, Any]]:
        """The newest checkpoint that verifies, or None when there is
        none at all. A candidate without a manifest is taken only when no
        checkpoint of the directory has one (otherwise its save was
        killed before the commit)."""
        cands = self._candidates()
        uses_manifests = any(
            os.path.exists(os.path.join(p, MANIFEST_NAME)) for _, p in cands
        )
        for _, path in cands:
            status, detail = verify_manifest(path)
            if status == "corrupt" or (status == "unverified" and uses_manifests):
                self._log(guard_line("ckpt_corrupt", checkpoint=path,
                                     detail=repr(detail), action="fallback"))
                continue
            try:
                return self._load(path)
            except Exception as e:  # a verified file that still does not load
                self._log(guard_line("ckpt_restore_failed", checkpoint=path,
                                     error=repr(e), action="fallback"))
        if cands:
            raise CheckpointIntegrityError(
                f"checkpoints exist under {self.directory} but none verifies or "
                "loads; refusing to train from scratch over them (inspect or "
                "delete the directory to restart)"
            )
        return None

    def best_step(self) -> Optional[int]:
        steps = self._steps()
        if not steps:
            return None
        return max(steps, key=lambda s: (self._val_acc(s), s))

    def restore_best(self) -> Optional[Dict[str, Any]]:
        """The best numbered checkpoint; raises when it does not verify."""
        step = self.best_step()
        if step is None:
            return None
        path = self._path(step)
        status, detail = verify_manifest(path)
        if status != "ok":
            raise CheckpointIntegrityError(f"best checkpoint {path} fails verification ({detail})")
        return self._load(path)

    def has_checkpoint(self) -> bool:
        return bool(self._candidates())


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """The model state_dict of a checkpoint directory: its best numbered
    checkpoint, else ``latest``."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{path} is not a checkpoint directory")
    mgr = CheckpointManager(path)
    state = mgr.restore_best() or mgr.restore_latest()
    if state is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    return state["model"]
