"""Pileup-window feature tensorizer.

Builds the 200x90 uint8 feature windows with the exact semantics of the
reference extractor (ref: generate.cpp:28-158):

- every covered position in the region contributes a column, plus up to
  MAX_INS insertion-slot columns discovered from reads with insertions;
- a window is emitted whenever 90 columns are queued, then the queue
  slides by 30 (60-column overlap — each position lands in <= 3 windows);
- the 200 rows are reads sampled WITH replacement from the reads that
  have at least one non-UNKNOWN base in the window; a row shows the
  read's base per column, GAP where the read is aligned-but-absent at an
  insertion slot / deleted, and UNKNOWN outside the read's alignment
  bounds (ref: generate.cpp:126-146);
- values 0-5 encode forward-strand bases, +6 for reverse strand.

Deviations from the reference, both deliberate:
- sampling uses a seedable SplitMix64 stream (ref uses ``srand(time)``,
  gen.cpp:11 — nondeterministic);
- a window whose valid-read set is empty is skipped instead of invoking
  ``rand() % 0`` (undefined behaviour in the reference).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from roko_tpu_torch import constants as C
from roko_tpu_torch.config import ReadFilterConfig, WindowConfig
from roko_tpu_torch.features.pileup import pileup_columns
from roko_tpu_torch.io.bam import BamReader
from roko_tpu_torch.utils.rng import SplitMix64

#: column key: (reference position, insertion slot)
PosKey = Tuple[int, int]


@dataclass
class Window:
    positions: np.ndarray  # int64 [cols, 2]
    matrix: np.ndarray  # uint8 [rows, cols]


def _encode_nibble_base(ch: str) -> int:
    code = C.CHAR_TO_CODE.get(ch)
    if code is None:
        raise ValueError(f"unexpected base {ch!r} in read sequence")
    return code


def _encode_draft_base(ch: str) -> int:
    code = C.CHAR_TO_CODE.get(ch)
    if code is None:
        raise ValueError(f"unexpected base {ch!r} in draft sequence")
    return code


def extract_windows(
    reader: BamReader,
    contig: str,
    start: int,
    end: int,
    seed: int,
    window_cfg: Optional[WindowConfig] = None,
    filter_cfg: Optional[ReadFilterConfig] = None,
    ref_seq: Optional[str] = None,
    ref_seq_offset: int = 0,
) -> Iterator[Window]:
    """Yield feature windows for draft positions in ``[start, end)``.

    When ``window_cfg.ref_rows > 0`` the first ref_rows rows of every
    window carry the DRAFT base per column — GAP at insertion slots,
    forward-strand encoding (the reference's REF_ROWS block,
    generate.cpp:109-119) — and ``ref_seq`` is required: the draft
    contig starting at absolute position ``ref_seq_offset`` and covering
    at least ``[start, end)``. The offset lets region workers receive
    just their slice instead of the whole contig (per-job IPC stays
    O(region), not O(contig)). The remaining rows are the usual sampled
    reads.
    """
    wcfg = window_cfg or WindowConfig()
    rows, cols, stride, max_ins = wcfg.rows, wcfg.cols, wcfg.stride, wcfg.max_ins
    ref_rows = wcfg.ref_rows
    if not 0 <= ref_rows <= rows:
        raise ValueError("ref_rows must be in [0, rows]")
    if ref_rows > 0 and (
        ref_seq is None
        or ref_seq_offset > start
        or len(ref_seq) < end - ref_seq_offset
    ):
        raise ValueError(
            "ref_rows > 0 needs the draft sequence covering [start, end)"
        )
    rng = SplitMix64(seed)

    pos_queue: List[PosKey] = []
    align_info: Dict[PosKey, Dict[int, int]] = {}
    align_bounds: Dict[int, Tuple[int, int]] = {}
    strand_fwd: Dict[int, bool] = {}

    gap, unknown = C.ENCODED_GAP, C.ENCODED_UNKNOWN

    for rpos, entries in pileup_columns(reader, contig, start, end, filter_cfg):
        if rpos < start:
            continue
        if rpos >= end:
            break

        for e in entries:
            if e.is_refskip:
                continue
            rid = e.read_id
            if rid not in align_bounds:
                # NB: the reference stores htslib's exclusive bam_endpos but
                # tests `pos > bounds.second` (generate.cpp:135), so the
                # one-past-the-end position counts as in-bounds GAP. Kept.
                align_bounds[rid] = (e.record.reference_start, e.record.reference_end)
                strand_fwd[rid] = not e.record.is_reverse

            key = (rpos, 0)
            info = align_info.get(key)
            if info is None:
                info = align_info[key] = {}
                pos_queue.append(key)
            if e.is_del:
                info.setdefault(rid, gap)
            else:
                seq = e.record.seq
                info.setdefault(rid, _encode_nibble_base(seq[e.qpos]))
                for i in range(1, min(e.indel, max_ins) + 1):
                    ikey = (rpos, i)
                    iinfo = align_info.get(ikey)
                    if iinfo is None:
                        iinfo = align_info[ikey] = {}
                        pos_queue.append(ikey)
                    iinfo.setdefault(rid, _encode_nibble_base(seq[e.qpos + i]))

        # emit windows while enough columns are queued
        while len(pos_queue) >= cols:
            window_keys = pos_queue[:cols]

            valid_set = {
                rid
                for key in window_keys
                for rid, code in align_info[key].items()
                if code != unknown
            }
            if valid_set:
                valid = sorted(valid_set)
                n_valid = len(valid)
                matrix = np.empty((rows, cols), dtype=np.uint8)
                if ref_rows > 0:
                    draft = [
                        gap
                        if ins != 0
                        else _encode_draft_base(ref_seq[p - ref_seq_offset])
                        for p, ins in window_keys
                    ]
                    matrix[:ref_rows] = np.array(draft, dtype=np.uint8)
                row_cache: Dict[int, np.ndarray] = {}
                for r in range(ref_rows, rows):
                    rid = valid[rng.next_below(n_valid)]
                    row = row_cache.get(rid)
                    if row is None:
                        fwd = strand_fwd[rid]
                        b_lo, b_hi = align_bounds[rid]
                        vals = []
                        for key in window_keys:
                            code = align_info[key].get(rid)
                            if code is None:
                                p = key[0]
                                code = unknown if (p < b_lo or p > b_hi) else gap
                            vals.append(code if fwd else code + C.STRAND_OFFSET)
                        row = row_cache[rid] = np.array(vals, dtype=np.uint8)
                    matrix[r] = row
                positions = np.array(window_keys, dtype=np.int64)
                yield Window(positions=positions, matrix=matrix)
            # (empty valid set: reference would do rand()%0 — UB; we skip
            # the window and still slide, keeping forward progress.)

            for key in pos_queue[:stride]:
                align_info.pop(key, None)
            del pos_queue[:stride]
    # positions left in the queue (< one window) are dropped, as in the
    # reference (generate.cpp: the while-loop is the only emitter).
