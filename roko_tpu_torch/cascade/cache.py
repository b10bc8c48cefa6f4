"""Content-addressed window cache of the cascade (the port's copy of
``roko_tpu/cascade/cache.py``).

A window's polished predictions are a pure function of (the window's
bytes, the params that predict them, the quantize mode, and the
cascade's own decision identity). The cache key is the sha256 over
exactly those inputs, so a hit under another params digest cannot
happen: a change of weights changes every key. The in-memory tier is a
byte-capped LRU; the optional on-disk sidecar pins its identity in
``meta.json`` (opening it under another identity refuses with the
differing fields) and writes each entry atomically (tmp file, then
``os.replace``), so a worker SIGKILLed mid-write never publishes a torn
entry, which is what lets a distributed polish's workers share one cache
directory.

Numpy only at import: :func:`params_digest` imports torch when called.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np

#: per-entry bookkeeping overhead charged against the byte cap (key
#: string + OrderedDict node); keeps the cap honest for tiny entries
ENTRY_OVERHEAD = 128


class CascadeMismatch(RuntimeError):
    """A cascade artifact (cache sidecar, calibration, tier model) does
    not match the running process's params digest / quantize mode /
    registry version. Serving it would scatter predictions from a
    DIFFERENT model into the output — wrong bases, not wrong speed —
    so the cascade refuses, in the BundleMismatch drift-diff shape."""

    def __init__(self, what: str, where: str, diff: Dict[str, Tuple[Any, Any]]):
        lines = [
            f"{key}: artifact={theirs!r} run={ours!r}"
            for key, (theirs, ours) in sorted(diff.items())
        ]
        super().__init__(
            f"cascade {what} at {where!r} belongs to a different run; "
            "refusing to use it (a mismatched cascade artifact would "
            "produce wrong bases, not just wrong speed). Differing "
            "fields:\n  " + "\n  ".join(lines or ["<identity mismatch>"])
            + "\nDelete the artifact or rerun with the matching "
            "params/quantize/registry version."
        )
        self.diff = diff


def params_digest(params: Any) -> str:
    """sha256 over a state_dict's tensors (a ``torch.nn.Module`` gives its
    own): names sorted, each tensor framed by its name, dtype and shape,
    then its bytes read on the host, so a model hashes the same on the
    CPU and on the card. An int8-quantized model's ``_q``/``_scale``
    entries hash differently from their float source by construction.

    The JAX package hashes its params tree instead (``repr`` of the tree
    structure, then each leaf): the two digests never agree, so a cache
    or calibration that ``roko_tpu`` wrote is refused here with
    :class:`CascadeMismatch` naming ``params_digest``, never used
    silently."""
    import torch

    sd = params.state_dict() if hasattr(params, "state_dict") else params
    h = hashlib.sha256()
    for name in sorted(sd):
        t = sd[name].detach().to("cpu").contiguous()
        h.update(f"{name}|{str(t.dtype)[6:]}|{tuple(t.shape)}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def cache_identity(
    *,
    params_digest: str,
    quantize: Optional[str],
    tier: str,
    threshold: float,
    method: str,
    temperature: float,
    tier_version: Optional[str] = None,
) -> Dict[str, Any]:
    """Everything a cached prediction depends on. The params digest +
    quantize mode cover the reference tier; tier/threshold/method/
    temperature cover the cascade DECISION (a window kept by tier 1 at
    threshold 0.02 may be escalated at 0.5, so the decision identity
    must ride in the key or thresholds would cross-contaminate)."""
    return {
        "params_digest": str(params_digest),
        "quantize": quantize or "none",
        "tier": str(tier),
        "tier_version": tier_version or "none",
        "threshold": float(threshold),
        "method": str(method),
        "temperature": float(temperature),
    }


def window_key(window_bytes: bytes, identity: Dict[str, Any]) -> str:
    """sha256 hex over the window's raw bytes + the cache identity."""
    h = hashlib.sha256()
    h.update(json.dumps(identity, sort_keys=True).encode())
    h.update(b"\x00")
    h.update(window_bytes)
    return h.hexdigest()


class WindowCache:
    """Thread-safe byte-capped LRU: key (hex digest) -> int32 preds."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._data: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @staticmethod
    def _cost(key: str, preds: np.ndarray) -> int:
        return len(key) + int(preds.nbytes) + ENTRY_OVERHEAD

    def get(self, key: str) -> Optional[np.ndarray]:
        with self._lock:
            preds = self._data.get(key)
            if preds is None:
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return preds

    def put(self, key: str, preds: np.ndarray) -> None:
        preds = np.ascontiguousarray(preds, dtype=np.int32)
        cost = self._cost(key, preds)
        if cost > self.max_bytes:
            return  # an entry larger than the whole cap never fits
        with self._lock:
            old = self._data.pop(key, None)
            if old is not None:
                self._bytes -= self._cost(key, old)
            self._data[key] = preds
            self._bytes += cost
            while self._bytes > self.max_bytes and self._data:
                k, v = self._data.popitem(last=False)
                self._bytes -= self._cost(k, v)
                self.evictions += 1

    def __len__(self) -> int:
        return len(self._data)

    @property
    def bytes(self) -> int:
        return self._bytes

    def stats(self) -> Dict[str, int]:
        return {
            "entries": len(self._data),
            "bytes": self._bytes,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }


class DiskWindowCache:
    """Shared on-disk sidecar: one file per key under two-level hex
    fanout, written atomically. ``meta.json`` pins the cache identity
    (journal discipline); an identity drift on open refuses loudly.

    Concurrency model: many processes may read and write the same
    directory. Writes go to a pid-suffixed tmp file then ``os.replace``
    — a reader either sees a complete entry or no entry, never a torn
    one (the property a SIGKILL mid-write must keep).
    Entries under a different identity cannot be *served* even if the
    directory is reused wrongly, because the identity is inside every
    key — meta.json exists to fail FAST and loudly, not as the only
    line of defense."""

    META = "meta.json"

    def __init__(self, root: str, identity: Dict[str, Any]):
        self.root = root
        self.identity = json.loads(json.dumps(identity, sort_keys=True))
        self.hits = 0
        self.misses = 0
        os.makedirs(root, exist_ok=True)
        meta_path = os.path.join(root, self.META)
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    have = json.load(f)
            except (OSError, ValueError):
                raise CascadeMismatch(
                    "cache sidecar", root, {"meta.json": ("<unreadable>", "valid")}
                ) from None
            if have != self.identity:
                diff = {
                    k: (have.get(k, "<absent>"), self.identity.get(k, "<absent>"))
                    for k in sorted(set(have) | set(self.identity))
                    if have.get(k, "<absent>") != self.identity.get(k, "<absent>")
                }
                raise CascadeMismatch("cache sidecar", root, diff)
        else:
            tmp = f"{meta_path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(self.identity, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, meta_path)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key[:2], key + ".npy")

    def get(self, key: str) -> Optional[np.ndarray]:
        try:
            with open(self._path(key), "rb") as f:
                preds = np.load(f, allow_pickle=False)
        except (OSError, ValueError):
            self.misses += 1  # absent OR torn-looking: both are misses
            return None
        self.hits += 1
        return np.ascontiguousarray(preds, dtype=np.int32)

    def put(self, key: str, preds: np.ndarray) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                np.save(f, np.ascontiguousarray(preds, dtype=np.int32),
                        allow_pickle=False)
                f.flush()
            os.replace(tmp, path)
        except OSError:
            # best-effort sidecar: a full disk degrades to a smaller
            # cache, never to a failed polish
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def stats(self) -> Dict[str, int]:
        entries = 0
        total = 0
        for sub in os.listdir(self.root):
            d = os.path.join(self.root, sub)
            if len(sub) != 2 or not os.path.isdir(d):
                continue
            for name in os.listdir(d):
                if name.endswith(".npy"):
                    entries += 1
                    try:
                        total += os.path.getsize(os.path.join(d, name))
                    except OSError:
                        pass
        return {
            "entries": entries,
            "bytes": total,
            "hits": self.hits,
            "misses": self.misses,
        }
