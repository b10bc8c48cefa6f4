"""Build the native extractor's shared library.

``python -m roko_tpu_torch.native.build`` compiles ``src/*.cc`` with
``g++ -O3`` into ``build/roko_tpu_torch/`` beside the package, never next
to the sources. It links only zlib. The library is a plain C-ABI ``.so``
loaded through ctypes, so nothing about it depends on the Python version.
Its name carries a digest of the sources and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"
BUILD_DIR = HERE.parent.parent / "build" / "roko_tpu_torch"

SOURCES = ("bgzf.cc", "bam.cc", "extract.cc", "align.cc", "capi.cc")
HEADERS = ("bgzf.h", "bam.h", "extract.h", "align.h")
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall")


def library_path() -> Path:
    """The library for the current sources and flags."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode() + b"\0" + (SRC / name).read_bytes())
    return BUILD_DIR / f"roko_native-{h.hexdigest()[:16]}.so"


def compile_command(out: Path) -> List[str]:
    return ["g++", *CXXFLAGS, "-o", str(out), *[str(SRC / s) for s in SOURCES], "-lz"]


def build(verbose: bool = False) -> Path:
    """Compile the library and return its path. Raises ``RuntimeError``
    with g++'s output when the build fails."""
    target = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a temp path and an atomic rename: region workers may race to
    # build, and a half-written library must never be loaded
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = compile_command(tmp)
    if verbose:
        print(" ".join(cmd))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ could not build the native extractor (rc {proc.returncode}):\n"
                f"$ {' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
        os.replace(tmp, target)
    finally:
        if tmp.exists():
            tmp.unlink()
    return target


def ensure_built(verbose: bool = False) -> Path:
    target = library_path()
    return target if target.exists() else build(verbose=verbose)


def toolchain() -> Dict[str, object]:
    """What this machine offers the build: g++'s version line, whether
    ``zlib.h`` is found, and whether ``-lz`` finds ``libz.so``."""
    probe = "#include <zlib.h>\nint main() { return zlibVersion()[0] == 0; }\n"
    out: Dict[str, object] = {}
    try:
        ver = subprocess.run(["g++", "--version"], capture_output=True, text=True)
    except FileNotFoundError:
        return {"gxx": None}
    out["gxx"] = ver.stdout.splitlines()[0] if ver.stdout else ver.stderr.strip()
    with tempfile.TemporaryDirectory() as td:
        src = Path(td) / "probe.cc"
        src.write_text(probe)
        out["zlib_h"] = subprocess.run(
            ["g++", "-fsyntax-only", str(src)], capture_output=True).returncode == 0
        out["libz_so"] = subprocess.run(
            ["g++", str(src), "-o", str(Path(td) / "probe"), "-lz"],
            capture_output=True).returncode == 0
    return out


if __name__ == "__main__":
    print(f"built {build(verbose=True)}")
    sys.exit(0)
