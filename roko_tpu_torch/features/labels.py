"""Truth labeling from a truth-genome-to-draft alignment BAM.

Medaka-style labeler with the exact semantics of the reference
(ref: roko/labels.py): truth alignments are filtered/clipped with a
4-case overlap resolution, then each alignment's ``aligned pairs`` walk
emits one label over the ``ACGT*N`` alphabet per ``(position,
insertion-slot)`` of the draft.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

from roko_tpu_torch import constants as C
from roko_tpu_torch.io.bam import BamReader, BamRecord


class Region(NamedTuple):
    name: str
    start: int
    end: int


@dataclass
class TargetAlign:
    """A truth alignment with clippable effective bounds
    (ref: roko/labels.py:17-22)."""

    align: BamRecord
    start: int
    end: int
    keep: bool = True

    @property
    def reference_length(self) -> int:
        return self.align.reference_length


def get_aligns(
    reader: BamReader, ref_name: str, start: int = 0, end: Optional[int] = None
) -> List[TargetAlign]:
    """Overlapping, mapped, non-secondary truth alignments sorted by start
    (ref: roko/labels.py:24-50)."""
    filtered = []
    for r in reader.fetch(ref_name, start, end):
        if r.is_unmapped or r.is_secondary:
            continue
        filtered.append(TargetAlign(r, r.reference_start, r.reference_end, True))
    filtered.sort(key=lambda e: e.align.reference_start)
    return filtered


def _get_overlap(first: TargetAlign, second: TargetAlign) -> Optional[Tuple[int, int]]:
    if second.start < first.end:
        return second.start, first.end
    return None


def filter_aligns(
    aligns: List[TargetAlign],
    len_threshold: float = 2.0,
    ol_threshold: float = 0.5,
    min_len: int = 1000,
) -> List[TargetAlign]:
    """4-case overlap resolution (ref: roko/labels.py:60-118):

    1. len_ratio < t and ol >= t: drop both
    2. len_ratio < t and ol <  t: split the overlap between the two
    3. len_ratio >= t and ol >= t: drop the shorter
    4. len_ratio >= t and ol <  t: clip the LATER-STARTING alignment to
       begin at the overlap end (which may be the longer one — reference
       behaviour, ref: roko/labels.py:115)
    """
    for i, j in itertools.combinations(aligns, 2):
        first, second = sorted((i, j), key=lambda r: r.align.reference_start)
        ol = _get_overlap(first, second)
        if ol is None:
            continue
        ol_start, ol_end = ol

        shorter, longer = sorted((i, j), key=lambda r: r.reference_length)
        len_ratio = longer.reference_length / shorter.reference_length
        ol_fraction = (ol_end - ol_start) / shorter.reference_length

        if len_ratio < len_threshold:
            if ol_fraction >= ol_threshold:
                shorter.keep = False
                longer.keep = False
            else:
                first.end = ol_start
                second.start = ol_end
        else:
            if ol_fraction >= ol_threshold:
                shorter.keep = False
            else:
                second.start = ol_end

    filtered = [a for a in aligns if a.keep and a.end - a.start >= min_len]
    filtered.sort(key=lambda e: e.start)
    return filtered


def get_pos_and_labels(
    target: TargetAlign, region: Region
) -> Tuple[List[Tuple[int, int]], List[int]]:
    """Walk the alignment's aligned pairs and emit ``((pos, ins), label)``
    within the clipped span (ref: roko/labels.py:141-189). Insertion count
    increments on query-only pairs; a ``None`` query base labels GAP; bases
    outside ``ACGT*`` label UNKNOWN."""
    start = max(region.start, target.start)
    end = min(region.end, target.end) if region.end is not None else target.end

    align = target.align
    query = align.query_sequence
    if query is None:
        return [], []

    all_pos: List[Tuple[int, int]] = []
    all_labels: List[int] = []

    cur_pos: Optional[int] = None
    ins_count = 0

    def before_span(pair):
        qp, rp = pair
        return rp is None or rp < start

    pairs = itertools.dropwhile(before_span, align.get_aligned_pairs())
    for qp, rp in pairs:
        if rp is not None and rp >= end:
            break
        if rp is None:
            ins_count += 1
        else:
            ins_count = 0
            cur_pos = rp
        all_pos.append((cur_pos, ins_count))

        qbase = query[qp].upper() if qp is not None else C.GAP
        all_labels.append(C.ENCODING.get(qbase, C.ENCODED_UNKNOWN))

    return all_pos, all_labels
