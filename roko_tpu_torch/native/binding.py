"""ctypes binding of the native extractor (a C ABI and ctypes keep the
build to one g++ call). A ``ctypes.CDLL`` call releases the GIL, so region
jobs in a thread pool extract in parallel."""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional

import numpy as np

from roko_tpu_torch.config import ReadFilterConfig, WindowConfig
from roko_tpu_torch.features.extract import Window
from roko_tpu_torch.native import build as _build

ABI_VERSION = 2


class _RokoResult(ctypes.Structure):
    _fields_ = [
        ("n_windows", ctypes.c_int64),
        ("positions", ctypes.POINTER(ctypes.c_int64)),
        ("matrix", ctypes.POINTER(ctypes.c_uint8)),
    ]


_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[Exception] = None
_lib_lock = threading.Lock()


def load() -> ctypes.CDLL:
    """The library, built on first use. A failed build or load is
    remembered and raised again, so a failing g++ does not run per region."""
    global _lib, _load_error
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _load_error is not None:
            raise _load_error
        try:
            _lib = _load_locked()
        except Exception as e:
            _load_error = e
            raise
        return _lib


def _load_locked() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.ensure_built()))
    lib.roko_native_abi_version.restype = ctypes.c_int
    lib.roko_last_error.restype = ctypes.c_char_p
    lib.roko_extract_windows.restype = ctypes.c_int
    lib.roko_extract_windows.argtypes = [
        ctypes.c_char_p,  # bam path
        ctypes.c_char_p,  # contig
        ctypes.c_int64,  # start
        ctypes.c_int64,  # end
        ctypes.c_uint64,  # seed
        ctypes.c_int,  # rows
        ctypes.c_int,  # cols
        ctypes.c_int,  # stride
        ctypes.c_int,  # max_ins
        ctypes.c_int,  # min_mapq
        ctypes.c_int,  # filter_flag
        ctypes.c_int,  # require_proper_pair
        ctypes.c_char_p,  # ref_seq (NULL when ref_rows == 0)
        ctypes.c_int64,  # ref_len
        ctypes.c_int64,  # ref_off (absolute position of ref_seq[0])
        ctypes.c_int,  # ref_rows
        ctypes.POINTER(_RokoResult),
    ]
    lib.roko_free_result.argtypes = [ctypes.POINTER(_RokoResult)]
    if lib.roko_native_abi_version() != ABI_VERSION:
        raise RuntimeError("native extractor ABI mismatch; rebuild")
    return lib


def is_available() -> bool:
    try:
        load()
        return True
    except Exception:
        return False


def extract_windows_arrays(
    bam_path: str,
    contig: str,
    start: int,
    end: int,
    seed: int,
    window_cfg: Optional[WindowConfig] = None,
    filter_cfg: Optional[ReadFilterConfig] = None,
    ref_seq: Optional[str] = None,
    ref_seq_offset: int = 0,
):
    """Stacked windows of ``[start, end)``: (positions int64[N,cols,2],
    matrix uint8[N,rows,cols]). ``ref_seq`` (the draft from absolute
    position ``ref_seq_offset``, covering at least ``[start, end)``) is
    required when ``window_cfg.ref_rows > 0``."""
    wcfg = window_cfg or WindowConfig()
    fcfg = filter_cfg or ReadFilterConfig()
    if wcfg.ref_rows > 0 and ref_seq is None:
        raise ValueError("ref_rows > 0 requires ref_seq")
    ref_b = ref_seq.encode() if (ref_seq and wcfg.ref_rows > 0) else None
    lib = load()
    res = _RokoResult()
    rc = lib.roko_extract_windows(
        bam_path.encode(),
        contig.encode(),
        start,
        end,
        seed & (2**64 - 1),
        wcfg.rows,
        wcfg.cols,
        wcfg.stride,
        wcfg.max_ins,
        fcfg.min_mapq,
        fcfg.filter_flag,
        1 if fcfg.require_proper_pair else 0,
        ref_b,
        len(ref_b) if ref_b is not None else 0,
        ref_seq_offset,
        wcfg.ref_rows,
        ctypes.byref(res),
    )
    if rc != 0:
        msg = lib.roko_last_error().decode(errors="replace")
        raise RuntimeError(f"native extractor failed ({rc}): {msg}")
    try:
        n = int(res.n_windows)
        if n == 0:
            pos = np.empty((0, wcfg.cols, 2), np.int64)
            mat = np.empty((0, wcfg.rows, wcfg.cols), np.uint8)
        else:
            pos = np.ctypeslib.as_array(res.positions, shape=(n, wcfg.cols, 2)).copy()
            mat = np.ctypeslib.as_array(res.matrix, shape=(n, wcfg.rows, wcfg.cols)).copy()
    finally:
        lib.roko_free_result(ctypes.byref(res))
    return pos, mat


def extract_windows(
    bam_path: str,
    contig: str,
    start: int,
    end: int,
    seed: int,
    window_cfg: Optional[WindowConfig] = None,
    filter_cfg: Optional[ReadFilterConfig] = None,
    ref_seq: Optional[str] = None,
    ref_seq_offset: int = 0,
) -> List[Window]:
    """The windows of :func:`extract_windows_arrays` one by one, bitwise
    equal to ``roko_tpu_torch.features.extract.extract_windows``."""
    pos, mat = extract_windows_arrays(
        bam_path, contig, start, end, seed, window_cfg, filter_cfg,
        ref_seq, ref_seq_offset,
    )
    return [Window(positions=pos[i], matrix=mat[i]) for i in range(pos.shape[0])]
