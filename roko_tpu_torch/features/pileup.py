"""Column pileup engine over a coordinate-sorted BAM.

Reimplements the subset of htslib's ``bam_mplp_*`` machinery the feature
extractor needs (ref: models.cpp:73-146, htslib sam.c pileup engine):
for every covered reference position, the set of overlapping filtered
reads with, per read, the query offset, deletion state, and the length of
any indel that follows the position. Reads receive serial ids in file
order — the analogue of htslib's ``bam1_t::id`` — which
the tensorizer uses to track a read across columns.

This is the readable reference implementation and test oracle; the C++
extractor in ``roko_tpu_torch/native`` mirrors it for the hot path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

from roko_tpu_torch import constants as C
from roko_tpu_torch.config import ReadFilterConfig
from roko_tpu_torch.io.bam import BamReader, BamRecord


@dataclass
class PileupEntry:
    """One read's state at one reference column."""

    read_id: int
    qpos: int  # query offset of the base at this column (M) or of the
    #          # last aligned base before a deletion (D/N columns)
    is_del: bool
    is_refskip: bool
    indel: int  # >0: insertion of this length follows the column;
    #           # <0: deletion of this length follows; 0 otherwise
    record: BamRecord


def passes_filter(rec: BamRecord, cfg: ReadFilterConfig) -> bool:
    """Read filter policy (ref: models.cpp:25-27, include/models.h:22-23)."""
    if rec.flag & cfg.filter_flag:
        return False
    if (
        cfg.require_proper_pair
        and rec.flag & C.FLAG_PAIRED
        and not rec.flag & C.FLAG_PROPER_PAIR
    ):
        return False
    if rec.mapq < cfg.min_mapq:
        return False
    return True


def _column_states(rec: BamRecord) -> List[Tuple[int, bool, bool, int]]:
    """Per reference column covered by ``rec`` (from ``rec.pos``), the
    tuple ``(qpos, is_del, is_refskip, indel)`` with htslib pileup
    semantics: ``indel`` is set on the last column before an I/D op."""
    states: List[Tuple[int, bool, bool, int]] = []
    qpos = 0
    for op, length in rec.cigar:
        if op in (C.CIGAR_M, C.CIGAR_EQ, C.CIGAR_X):
            for i in range(length):
                states.append((qpos + i, False, False, 0))
            qpos += length
        elif op == C.CIGAR_I:
            if states:
                q, d, rs, _ = states[-1]
                states[-1] = (q, d, rs, length)
            qpos += length
        elif op == C.CIGAR_D:
            if states:
                q, d, rs, ind = states[-1]
                states[-1] = (q, d, rs, ind if ind > 0 else -length)
            for _ in range(length):
                # qpos of the base preceding the deletion, as htslib does
                states.append((max(qpos - 1, 0), True, False, 0))
        elif op == C.CIGAR_N:
            for _ in range(length):
                states.append((max(qpos - 1, 0), True, True, 0))
        elif op == C.CIGAR_S:
            qpos += length
        # H, P consume nothing
    return states


def pileup_columns(
    reader: BamReader,
    contig: str,
    start: int,
    end: int,
    filter_cfg: Optional[ReadFilterConfig] = None,
) -> Iterator[Tuple[int, List[PileupEntry]]]:
    """Yield ``(rpos, entries)`` for every position covered by at least one
    filtered read overlapping ``[start, end)``, in ascending position
    order. Like htslib's multi-pileup over a region iterator, columns can
    extend OUTSIDE ``[start, end)`` (reads overlap the region boundary);
    callers clip, exactly as the reference extractor does
    (ref: generate.cpp:47-49). Entry order within a column is read file
    order (htslib adds reads to the pileup in iterator order)."""
    if filter_cfg is None:
        filter_cfg = ReadFilterConfig()

    # Reads overlapping the region, filtered, ids in file order.
    reads: List[Tuple[int, BamRecord, List[Tuple[int, bool, bool, int]]]] = []
    next_id = 0
    for rec in reader.fetch(contig, start, end):
        if not passes_filter(rec, filter_cfg):
            continue
        reads.append((next_id, rec, _column_states(rec)))
        next_id += 1

    if not reads:
        return

    # Sweep columns. Reads are already sorted by start position.
    lo = min(r.pos for _, r, _ in reads)
    hi = max(r.pos + len(states) for _, r, states in reads)
    active: List[int] = []  # indices into `reads`
    nxt = 0
    for rpos in range(lo, hi):
        while nxt < len(reads) and reads[nxt][1].pos <= rpos:
            active.append(nxt)
            nxt += 1
        entries: List[PileupEntry] = []
        still_active: List[int] = []
        for idx in active:
            rid, rec, states = reads[idx]
            col = rpos - rec.pos
            if col >= len(states):
                continue  # read exhausted
            still_active.append(idx)
            if col < 0:
                continue
            qpos, is_del, is_refskip, indel = states[col]
            entries.append(
                PileupEntry(
                    read_id=rid,
                    qpos=qpos,
                    is_del=is_del,
                    is_refskip=is_refskip,
                    indel=indel,
                    record=rec,
                )
            )
        active = still_active
        if entries:
            yield rpos, entries
        if not active and nxt >= len(reads):
            return
