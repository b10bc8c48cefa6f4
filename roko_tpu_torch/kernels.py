"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each kernel is one ``csrc/*.cu`` file with a plain C interface (it may
include the shared headers ``csrc/*.cuh``). It is compiled for
``sm_90a`` on first use into the kernel build cache
(``compile/cache.py``: ``ROKO_COMPILE_CACHE``, else
``CompileConfig.cache_dir``, else ``build/roko_tpu_torch/`` beside the
package), under a name that carries a hash of the sources and the flags,
so an edited source is rebuilt and an unchanged one is loaded as it is.
A process that loaded a kernel bundle (``compile/bundle.py``) loads the
bundle's copies instead, through the same checked route, and never runs
nvcc for a kernel the bundle lacks. Nothing here runs at import time: the
CPU tests import every module of the package on a machine without nvcc.
Beside the build, the checks every kernel wrapper makes before a launch.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

from roko_tpu_torch.compile import cache

_PKG = Path(__file__).resolve().parent

#: where the libraries are built: None until the first build asks the
#: kernel build cache (``cache.enable_persistent_cache``) for this
#: process's directory; a test may point it elsewhere
BUILD_DIR: Optional[Path] = None

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: kernel name -> (source under the package, C entry point, argtypes)
KERNELS = {
    "gru_fwd": (
        "csrc/gru_fwd.cu",
        "roko_gru_fwd",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    ),
    "gru_bwd": (
        "csrc/gru_bwd.cu",
        "roko_gru_bwd",
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    ),
    "lingru_fwd": (
        "csrc/lingru_fwd.cu",
        "roko_lingru_fwd",
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    ),
    "lingru_bwd": (
        "csrc/lingru_bwd.cu",
        "roko_lingru_bwd",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    ),
    "gru_fwd_bf16": (
        "csrc/gru_fwd_bf16.cu",
        "roko_gru_fwd_bf16",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    ),
    "lingru_fwd_bf16": (
        "csrc/lingru_fwd_bf16.cu",
        "roko_lingru_fwd_bf16",
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    ),
    "gru_bwd_bf16": (
        "csrc/gru_bwd_bf16.cu",
        "roko_gru_bwd_bf16",
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    ),
    "lingru_bwd_bf16": (
        "csrc/lingru_bwd_bf16.cu",
        "roko_lingru_bwd_bf16",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    ),
}

#: kernel name -> the dtype of every tensor it takes (the bf16 backward
#: kernels write their f32 sums and scratch into f32 buffers the wrapper
#: allocates; their inputs are all bf16)
DTYPES = {name: torch.bfloat16 if name.endswith("_bf16") else torch.float32 for name in KERNELS}

_loaded: Dict[str, ctypes.CDLL] = {}
#: the file each loaded library came from
_loaded_from: Dict[str, Path] = {}
#: kernels counted in the build cache's hits and misses (once a process)
_counted: set = set()
#: kernel name -> its library in a loaded bundle; once a bundle is
#: installed (``_bundle_dir``), a kernel it lacks is refused, not built
_bundle_paths: Dict[str, Path] = {}
_bundle_dir: Optional[str] = None


def build_dir() -> Path:
    """This process's kernel build directory (fixed on first use)."""
    global BUILD_DIR
    if BUILD_DIR is None:
        BUILD_DIR = Path(cache.enable_persistent_cache())
    return Path(BUILD_DIR)


def nvcc_path() -> str:
    """nvcc from ``CUDA_HOME``, then PyTorch's idea of the CUDA home, then
    ``PATH``; it is often not on ``PATH`` where the toolkit is."""
    homes = [os.environ.get("CUDA_HOME")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME

        homes.append(CUDA_HOME)
    except ImportError:
        pass
    for home in homes:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, "
            "torch.utils.cpp_extension.CUDA_HOME/bin and PATH); the CUDA "
            "kernels are built from source on first use"
        )
    return found


def source_digest(name: str) -> str:
    """sha256 of kernel ``name``'s source, the shared headers of ``csrc/``
    and the flags: what its library's name carries."""
    src = (_PKG / KERNELS[name][0]).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted((_PKG / "csrc").glob("*.cuh")))
    return hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()


def library_path(name: str) -> Path:
    """The library of kernel ``name`` in the build directory, named by its
    :func:`source_digest`."""
    return build_dir() / f"{name}-{source_digest(name)[:16]}.so"


def inference_kernels(model_cfg, backend: str = "cuda") -> tuple:
    """The kernels a forward of ``model_cfg`` launches on a card: the
    recurrence of its kind in its resolved compute dtype (int8 weights
    dequantize into it); none for the transformer, whose products are
    library calls."""
    if model_cfg.kind == "transformer":
        return ()
    dtype = model_cfg.resolve(backend).compute_dtype
    base = "gru_fwd" if model_cfg.kind == "gru" else "lingru_fwd"
    return (base + "_bf16",) if dtype == "bfloat16" else (base,)


@contextlib.contextmanager
def _build_locks(names: Iterable[str]):
    """Hold an exclusive file lock beside each named library (in name
    order, so two processes never wait on each other crosswise): the
    ranks of one session, started at once, build a missing library once,
    and the others wait and then load it."""
    with contextlib.ExitStack() as stack:
        for name in sorted(names):
            f = stack.enter_context(open(library_path(name).with_suffix(".lock"), "w"))
            fcntl.flock(f, fcntl.LOCK_EX)
        yield


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named kernel (default: all) whose library is missing,
    one nvcc per source, all started together, under a file lock a library
    (:func:`_build_locks`): of processes building at once, one runs nvcc
    and the rest load what it published. Returns ``{name: {"seconds": wall
    time, "ptxas": nvcc's resource report}}`` for the kernels it compiled.
    Raises with nvcc's stderr when one fails."""
    names = list(KERNELS if names is None else names)
    refused = [n for n in names if _bundle_dir is not None and n not in _bundle_paths]
    if refused:
        raise RuntimeError(
            f"kernel bundle {_bundle_dir!r} carries no library for {refused}; a process "
            "that loaded a bundle never builds a kernel with nvcc (export a bundle for "
            "this model's kind and dtype with `python -m roko_tpu_torch compile`)")
    names = [n for n in names if n not in _bundle_paths]
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        _count(names, todo)
        return {}
    build_dir().mkdir(parents=True, exist_ok=True)
    with _build_locks(todo):
        # another process may have published them while this one waited
        todo = [n for n in todo if not library_path(n).exists()]
        _count(names, todo)
        return _compile(todo) if todo else {}


def _count(names, todo) -> None:
    """One build-cache hit or miss a kernel, the first time a process asks."""
    for n in names:
        if n not in _counted:
            _counted.add(n)
            cache.record(hit=n not in todo)


def _compile(todo) -> Dict[str, dict]:
    """nvcc for each of ``todo``, all at once, each published atomically."""
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        target = library_path(name)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_PKG / KERNELS[name][0])]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            ),
            tmp,
            target,
        )
    report: Dict[str, dict] = {}
    failures = []
    for name, (proc, tmp, target) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{err}{out}")
            continue
        # atomic publish: a process building the same source at the same
        # time loads either nothing or a complete library
        os.replace(tmp, target)
        report[name] = {
            "seconds": time.perf_counter() - t0,
            "ptxas": (err + out).strip(),
        }
    if failures:
        raise RuntimeError("\n".join(failures))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``: the bundle's copy when a
    bundle carries it, else the build directory's, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = _bundle_paths.get(name)
        if path is None:
            build([name])
            path = library_path(name)
        lib = ctypes.CDLL(str(path))
        entry = getattr(lib, KERNELS[name][1])
        entry.argtypes = KERNELS[name][2]
        entry.restype = ctypes.c_int
        lib.roko_cuda_error_string.argtypes = [ctypes.c_int]
        lib.roko_cuda_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
        _loaded_from[name] = Path(path)
    return lib


def forward_launches() -> Dict[str, int]:
    """This process's launch counts of the inference kernels, by name (the
    wrappers' counters)."""
    from roko_tpu_torch.models import fused_gru as fg
    from roko_tpu_torch.models import fused_lingru as fl

    return {"gru_fwd": fg.gru_recurrence.launches,
            "gru_fwd_bf16": fg.gru_recurrence.launches_bf16,
            "lingru_fwd": fl.lingru_scan.launches,
            "lingru_fwd_bf16": fl.lingru_scan.launches_bf16}


def install_bundle(bundle_dir: str, paths: Dict[str, Path]) -> None:
    """Point :func:`library` at a bundle's libraries (``{name: path}``,
    already checked by ``compile.bundle.load_bundle``). Refuses a kernel
    that this process has already loaded from anywhere else, and a
    second, different bundle: one kernel never loads from two files in
    one process."""
    global _bundle_dir
    if _bundle_dir is not None and _bundle_dir != bundle_dir:
        raise RuntimeError(f"kernel bundle {_bundle_dir!r} is already loaded in this "
                           f"process; refusing a second one ({bundle_dir!r})")
    clash = [n for n, p in paths.items()
             if n in _loaded_from and _loaded_from[n] != Path(p)]
    if clash:
        raise RuntimeError(
            f"kernels {clash} are already loaded from {[str(_loaded_from[n]) for n in clash]}; "
            f"refusing to load them again from bundle {bundle_dir!r}")
    _bundle_dir = bundle_dir
    _bundle_paths.update({n: Path(p) for n, p in paths.items()})


def device_kind(t: torch.Tensor, name: str) -> str:
    """``"cuda"`` or ``"cpu"``: where a wrapper runs ``name`` for ``t``
    (its kernel, or its plain version); raises for any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
    return t.device.type


def check_inputs(name: str, **tensors: torch.Tensor) -> None:
    """What every kernel takes: its dtype (``DTYPES``), contiguous, on one
    CUDA device."""
    device = next(iter(tensors.values())).device
    dtype = DTYPES[name]
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{arg} is on {t.device}, {name}'s first input on {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} takes {str(dtype)[6:]}; {arg} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors; {arg} is not")


def stream(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise when a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.roko_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} ({msg})")
