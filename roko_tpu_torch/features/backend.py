"""Extractor backend selection: the C++ extractor
(``roko_tpu_torch.native``) when it builds and loads, else the Python one.
Both give bitwise-equal windows for a seed. ``ROKO_TPU_FORCE_PY_EXTRACTOR=1``
forces the Python extractor."""

from __future__ import annotations

import os
from typing import List

import numpy as np

from roko_tpu_torch.config import ReadFilterConfig, WindowConfig
from roko_tpu_torch.features.extract import Window, extract_windows
from roko_tpu_torch.io.bam import BamReader


def _native_available() -> bool:
    if os.environ.get("ROKO_TPU_FORCE_PY_EXTRACTOR", "") == "1":
        return False
    from roko_tpu_torch.native import binding

    return binding.is_available()


def selected() -> str:
    """The backend region jobs use: ``"native"`` or ``"python"``."""
    return "native" if _native_available() else "python"


def extract_region_windows(
    bam_path: str,
    contig: str,
    start: int,
    end: int,
    seed: int,
    window_cfg: WindowConfig,
    filter_cfg: ReadFilterConfig,
    ref_seq=None,
    ref_seq_offset: int = 0,
) -> List[Window]:
    if _native_available():
        from roko_tpu_torch.native import binding

        return binding.extract_windows(
            bam_path, contig, start, end, seed, window_cfg, filter_cfg,
            ref_seq=ref_seq, ref_seq_offset=ref_seq_offset,
        )
    with BamReader(bam_path) as reader:
        return list(
            extract_windows(
                reader, contig, start, end, seed, window_cfg, filter_cfg,
                ref_seq=ref_seq, ref_seq_offset=ref_seq_offset,
            )
        )


def extract_region_arrays(
    bam_path: str,
    contig: str,
    start: int,
    end: int,
    seed: int,
    window_cfg: WindowConfig,
    filter_cfg: ReadFilterConfig,
    ref_seq=None,
    ref_seq_offset: int = 0,
):
    """Stacked form: (positions int64[N,cols,2], matrix uint8[N,rows,cols]).
    Two contiguous buffers a region cross a process boundary far faster
    than N per-window arrays."""
    if _native_available():
        from roko_tpu_torch.native import binding

        return binding.extract_windows_arrays(
            bam_path, contig, start, end, seed, window_cfg, filter_cfg,
            ref_seq=ref_seq, ref_seq_offset=ref_seq_offset,
        )
    windows = extract_region_windows(
        bam_path, contig, start, end, seed, window_cfg, filter_cfg,
        ref_seq=ref_seq, ref_seq_offset=ref_seq_offset,
    )
    if not windows:
        return (
            np.empty((0, window_cfg.cols, 2), np.int64),
            np.empty((0, window_cfg.rows, window_cfg.cols), np.uint8),
        )
    return (
        np.stack([w.positions for w in windows]),
        np.stack([w.matrix for w in windows]),
    )
