"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each kernel is one ``csrc/*.cu`` file with a plain C interface (it may
include the shared headers ``csrc/*.cuh``). It is compiled for
``sm_90a`` into ``build/roko_tpu_torch/`` beside the package on first
use, under a name that carries a hash of the sources and the flags, so
an edited source is rebuilt and an unchanged one is loaded as it is.
Nothing here runs at import time: the CPU tests import every module of
the package on a machine without nvcc. Beside the build, the checks
every kernel wrapper makes before a launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parent / "build" / "roko_tpu_torch"

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
}

_loaded: Dict[str, ctypes.CDLL] = {}


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


def library_path(name: str) -> Path:
    """The library of kernel ``name``, named by a hash of its source, the
    shared headers of ``csrc/`` and the flags."""
    src = (_PKG / KERNELS[name][0]).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted((_PKG / "csrc").glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named kernel (default: all) whose library is missing,
    one nvcc per source, all started together. Returns
    ``{name: {"seconds": wall time, "ptxas": nvcc's resource report}}`` for
    the kernels it compiled. Raises with nvcc's stderr when one fails."""
    names = list(KERNELS if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
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
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        entry = getattr(lib, KERNELS[name][1])
        entry.argtypes = KERNELS[name][2]
        entry.restype = ctypes.c_int
        lib.roko_cuda_error_string.argtypes = [ctypes.c_int]
        lib.roko_cuda_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def device_kind(t: torch.Tensor, name: str) -> str:
    """``"cuda"`` or ``"cpu"``: where a wrapper runs ``name`` for ``t``
    (its kernel, or its plain version); raises for any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
    return t.device.type


def check_inputs(name: str, **tensors: torch.Tensor) -> None:
    """What every kernel takes: float32, contiguous, on one CUDA device."""
    device = next(iter(tensors.values())).device
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{arg} is on {t.device}, {name}'s first input on {device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} takes float32; {arg} is {t.dtype}")
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
