"""The kernel build cache: the port's persistent compile cache.

The reference keeps JAX's persistent XLA cache on disk
(``roko_tpu/compile/cache.py``). The port's only compiled artifacts are
the nvcc-built kernel libraries, which ``kernels.py`` names by a hash of
their sources and flags; so its cache is the directory they are built
into, and any later process that needs the same library loads it from
there instead of running nvcc.

- :func:`resolve_cache_dir` — the layered resolution: the
  ``ROKO_COMPILE_CACHE`` env var (a path, or ``off``/``0``/``none`` to
  turn the cache off) > ``CompileConfig.cache_dir`` > the default
  ``build/roko_tpu_torch/`` beside the package.
- :func:`enable_persistent_cache` — fixes this process's build directory
  once (the first caller's wins). With the cache off, the process builds
  into a fresh temporary directory of its own, removed at exit, so every
  start is a miss.
- :func:`cache_counters` — this process's hits (a library it needed was
  already built) and misses (it ran nvcc), which ``/metrics`` renders as
  ``roko_compile_cache_hits`` / ``_misses``.
- :func:`cache_entry_count` / :func:`cache_total_bytes` — the disk
  inventory.

Pure Python: nothing here imports torch or builds anything.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Callable, Optional, Tuple

Log = Callable[[str], None]

#: env var: a build directory, or one of :data:`_OFF_VALUES` to turn the
#: cache off
ENV_CACHE = "ROKO_COMPILE_CACHE"

_OFF_VALUES = frozenset({"", "0", "off", "none", "disable", "disabled"})

DEFAULT_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "roko_tpu_torch"

_lock = threading.Lock()
_active_dir: Optional[str] = None
_configured = False
_hits = 0
_misses = 0


def record(hit: bool) -> None:
    """Count one library this process needed: found built, or built."""
    global _hits, _misses
    with _lock:
        if hit:
            _hits += 1
        else:
            _misses += 1


def cache_counters() -> Tuple[int, int]:
    """(hits, misses) of the kernel build cache in this process:
    monotonic; snapshot before and after a phase to attribute counts."""
    return _hits, _misses


def resolve_cache_dir(ccfg=None) -> Optional[str]:
    """The build directory the layered config resolves to, or ``None`` when
    the cache is off: ``ROKO_COMPILE_CACHE`` > ``CompileConfig`` > default."""
    env = os.environ.get(ENV_CACHE)
    if env is not None:
        if env.strip().lower() in _OFF_VALUES:
            return None
        return os.path.expanduser(env)
    if ccfg is not None and not ccfg.enabled:
        return None
    if ccfg is not None and ccfg.cache_dir:
        return os.path.expanduser(ccfg.cache_dir)
    return str(DEFAULT_DIR)


def enable_persistent_cache(ccfg=None, *, log: Optional[Log] = None) -> str:
    """Fix this process's kernel build directory (idempotent: the first
    caller's wins, as one process has one cache) and return it. With the
    cache off it is a fresh temporary directory, removed at exit.
    Creates the directory; builds nothing."""
    global _active_dir, _configured
    with _lock:
        if _configured:
            want = resolve_cache_dir(ccfg)
            if log is not None and want is not None and want != _active_dir:
                log(f"compile cache already configured at {_active_dir!r}; "
                    f"ignoring later request for {want!r}")
            return _active_dir  # type: ignore[return-value]
        d = resolve_cache_dir(ccfg)
        if d is None:
            d = tempfile.mkdtemp(prefix="roko-kernels-")
            atexit.register(shutil.rmtree, d, True)
            what = f"off (fresh build directory {d})"
        else:
            os.makedirs(d, exist_ok=True)
            what = d
        _active_dir = d
        _configured = True
    if log is not None:
        log(f"kernel build cache: {what}")
    return d


def active_cache_dir() -> Optional[str]:
    """The directory :func:`enable_persistent_cache` fixed (None before)."""
    return _active_dir


def _entry_files(cache_dir: str):
    try:
        names = os.listdir(cache_dir)
    except OSError:
        return
    for name in names:
        if name.endswith(".so"):  # a half-written build ends in .tmp
            yield os.path.join(cache_dir, name)


def cache_entry_count(cache_dir: Optional[str] = None) -> int:
    """Built libraries on disk (0 for a missing directory)."""
    d = cache_dir or _active_dir
    if not d:
        return 0
    return sum(1 for _ in _entry_files(d))


def cache_total_bytes(cache_dir: Optional[str] = None) -> int:
    """Bytes the built libraries occupy."""
    d = cache_dir or _active_dir
    if not d:
        return 0
    total = 0
    for path in _entry_files(d):
        try:
            total += os.stat(path).st_size
        except OSError:
            continue
    return total


def _reset_for_tests() -> None:
    """Forget the process's build directory and counters, so a test can
    exercise resolution again."""
    global _configured, _active_dir, _hits, _misses
    with _lock:
        _configured = False
        _active_dir = None
        _hits = _misses = 0
