"""BAM reader/writer with BAI linear-index region queries.

Implements the BAM binary format (SAM spec §4) directly over
:mod:`roko_tpu_torch.io.bgzf` — no htslib. Provides what the framework needs:

- :class:`BamReader` — header parse, sequential iteration, and
  ``fetch(contig, start, end)`` region queries using the BAI linear index
  (replaces htslib's ``sam_itr_querys`` used at ref: models.cpp:77 and the
  pysam ``fetch`` used at ref: roko/labels.py:38);
- :class:`BamRecord` — flags/cigar/seq accessors plus
  :meth:`BamRecord.get_aligned_pairs` with pysam-compatible semantics
  (insertions AND soft-clips yield ``(qpos, None)``; deletions and ref
  skips yield ``(None, rpos)``) as consumed by ref: roko/labels.py:135;
- :class:`BamWriter` — writes coordinate-sorted BAM plus a ``.bai`` index
  (used by the test fixtures and the read simulator).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from roko_tpu_torch import constants as C
from roko_tpu_torch.io.bgzf import BgzfReader, BgzfWriter

_BAM_MAGIC = b"BAM\x01"
_BAI_MAGIC = b"BAI\x01"

#: BAM 4-bit seq codes: "=ACMGRSVTWYHKDBN"
_SEQ_CODES = "=ACMGRSVTWYHKDBN"
_CHAR_TO_NIBBLE = {c: i for i, c in enumerate(_SEQ_CODES)}
for _c in "acgtn":
    _CHAR_TO_NIBBLE[_c] = _CHAR_TO_NIBBLE[_c.upper()]

#: linear-index interval width (16 kb, SAM spec §5.1.3)
_LINEAR_SHIFT = 14


def reg2bin(beg: int, end: int) -> int:
    """Compute the BAI distributed bin for a [beg, end) interval
    (SAM spec §5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> List[int]:
    """All bins that may hold records overlapping [beg, end)
    (SAM spec §5.3 list-of-bins recurrence)."""
    end -= 1
    bins = [0]
    for base, shift in (
        (1, 26), (9, 23), (73, 20), (585, 17), (4681, 14)
    ):
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


@dataclass
class BamRecord:
    name: str
    flag: int
    tid: int
    pos: int  # 0-based leftmost coordinate
    mapq: int
    cigar: Tuple[Tuple[int, int], ...]  # (op, length) with op in 0..8
    seq: str
    qual: bytes
    next_tid: int = -1
    next_pos: int = -1
    tlen: int = 0
    tags: bytes = b""

    # -- derived ------------------------------------------------------------
    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & C.FLAG_UNMAP)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & C.FLAG_SECONDARY)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & C.FLAG_REVERSE)

    @property
    def reference_start(self) -> int:
        return self.pos

    @property
    def reference_end(self) -> int:
        """One past the last aligned reference position (htslib
        ``bam_endpos``: pos+1 when the cigar consumes no reference)."""
        n = sum(l for op, l in self.cigar if C.CIGAR_CONSUMES_REF[op])
        return self.pos + n if n > 0 else self.pos + 1

    @property
    def reference_length(self) -> int:
        return self.reference_end - self.reference_start

    @property
    def query_sequence(self) -> Optional[str]:
        return self.seq if self.seq else None

    def get_aligned_pairs(self) -> List[Tuple[Optional[int], Optional[int]]]:
        """pysam-compatible aligned pairs: M/=/X -> (qpos, rpos);
        I and S -> (qpos, None); D and N -> (None, rpos); H/P -> nothing."""
        pairs: List[Tuple[Optional[int], Optional[int]]] = []
        qpos, rpos = 0, self.pos
        for op, length in self.cigar:
            if op in (C.CIGAR_M, C.CIGAR_EQ, C.CIGAR_X):
                for i in range(length):
                    pairs.append((qpos + i, rpos + i))
                qpos += length
                rpos += length
            elif op in (C.CIGAR_I, C.CIGAR_S):
                for i in range(length):
                    pairs.append((qpos + i, None))
                qpos += length
            elif op in (C.CIGAR_D, C.CIGAR_N):
                for i in range(length):
                    pairs.append((None, rpos + i))
                rpos += length
            # H, P: consume nothing visible
        return pairs

    def overlaps(self, start: int, end: int) -> bool:
        return self.pos < end and self.reference_end > start


def _encode_record(rec: BamRecord) -> bytes:
    name_b = rec.name.encode() + b"\x00"
    n_cigar = len(rec.cigar)
    l_seq = len(rec.seq)
    bin_ = reg2bin(rec.pos, rec.reference_end)
    fixed = struct.pack(
        "<iiBBHHHiiii",
        rec.tid,
        rec.pos,
        len(name_b),
        rec.mapq,
        bin_,
        n_cigar,
        rec.flag,
        l_seq,
        rec.next_tid,
        rec.next_pos,
        rec.tlen,
    )
    cigar_b = b"".join(
        struct.pack("<I", (length << 4) | op) for op, length in rec.cigar
    )
    seq_b = bytearray()
    for i in range(0, l_seq, 2):
        hi = _CHAR_TO_NIBBLE.get(rec.seq[i], 15)
        lo = _CHAR_TO_NIBBLE.get(rec.seq[i + 1], 15) if i + 1 < l_seq else 0
        seq_b.append((hi << 4) | lo)
    qual_b = rec.qual if len(rec.qual) == l_seq else b"\xff" * l_seq
    body = fixed + name_b + cigar_b + bytes(seq_b) + qual_b + rec.tags
    return struct.pack("<i", len(body)) + body


def _find_cg_tag(tags: bytes) -> Optional[List[int]]:
    """Scan the tag region for a ``CG:B,I`` array — the real CIGAR of a
    read whose op count overflows the 16-bit n_cigar field (SAM spec
    §4.2.2). Returns raw (len<<4|op) words or None."""
    off = 0
    n = len(tags)
    while off + 3 <= n:
        t0, t1, typ = tags[off : off + 3]
        off += 3
        ch = chr(typ)
        if ch in "AcC":
            off += 1
        elif ch in "sS":
            off += 2
        elif ch in "iIf":
            off += 4
        elif ch in "ZH":
            end = tags.find(b"\x00", off)
            if end < 0:  # truncated string tag: give up gracefully
                return None
            off = end + 1
        elif ch == "B":
            if off + 5 > n:
                return None
            elem = chr(tags[off])
            count = struct.unpack_from("<I", tags, off + 1)[0]
            esize = {"c": 1, "C": 1, "s": 2, "S": 2}.get(elem, 4)
            if t0 == ord("C") and t1 == ord("G") and elem == "I":
                if off + 5 + 4 * count > n:
                    return None
                return list(struct.unpack_from(f"<{count}I", tags, off + 5))
            off += 5 + esize * count
        else:
            return None
    return None


def _decode_record(body: bytes) -> BamRecord:
    (
        tid,
        pos,
        l_read_name,
        mapq,
        _bin,
        n_cigar,
        flag,
        l_seq,
        next_tid,
        next_pos,
        tlen,
    ) = struct.unpack_from("<iiBBHHHiiii", body, 0)
    off = 32
    name = body[off : off + l_read_name - 1].decode()
    off += l_read_name
    cigar = []
    for _ in range(n_cigar):
        v = struct.unpack_from("<I", body, off)[0]
        cigar.append((v & 0xF, v >> 4))
        off += 4
    seq_chars = []
    for i in range(l_seq):
        byte = body[off + (i >> 1)]
        nib = (byte >> 4) if i % 2 == 0 else (byte & 0xF)
        seq_chars.append(_SEQ_CODES[nib])
    off += (l_seq + 1) // 2
    qual = body[off : off + l_seq]
    off += l_seq
    tags = body[off:]
    # ultralong-read CIGAR overflow: placeholder "<l_seq>S<ref_len>N" with
    # the real CIGAR in a CG:B,I tag
    if (
        len(cigar) == 2
        and cigar[0] == (C.CIGAR_S, l_seq)
        and cigar[1][0] == C.CIGAR_N
    ):
        cg = _find_cg_tag(tags)
        if cg is not None:
            cigar = [(v & 0xF, v >> 4) for v in cg]
    return BamRecord(
        name=name,
        flag=flag,
        tid=tid,
        pos=pos,
        mapq=mapq,
        cigar=tuple(cigar),
        seq="".join(seq_chars),
        qual=qual,
        next_tid=next_tid,
        next_pos=next_pos,
        tlen=tlen,
        tags=tags,
    )


class BamReader:
    def __init__(self, path: str):
        self.path = path
        self._bgzf = BgzfReader(path)
        magic = self._bgzf.read(4)
        if magic != _BAM_MAGIC:
            raise ValueError(f"{path}: not a BAM file")
        l_text = struct.unpack("<i", self._bgzf.read(4))[0]
        self.header_text = self._bgzf.read(l_text).decode(errors="replace")
        n_ref = struct.unpack("<i", self._bgzf.read(4))[0]
        self.references: List[Tuple[str, int]] = []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", self._bgzf.read(4))[0]
            name = self._bgzf.read(l_name)[:-1].decode()
            l_ref = struct.unpack("<i", self._bgzf.read(4))[0]
            self.references.append((name, l_ref))
        self.tid_by_name: Dict[str, int] = {
            n: i for i, (n, _) in enumerate(self.references)
        }
        self._first_record_voffset = self._bgzf.tell_virtual()
        self._index = None
        self._warned_no_index = False

    # -- raw iteration ------------------------------------------------------
    def _read_record(self) -> Optional[BamRecord]:
        size_b = self._bgzf.read(4)
        if len(size_b) < 4:
            return None
        block_size = struct.unpack("<i", size_b)[0]
        body = self._bgzf.read(block_size)
        if len(body) < block_size:
            raise ValueError(f"{self.path}: truncated record")
        return _decode_record(body)

    def __iter__(self) -> Iterator[BamRecord]:
        self._bgzf.seek_virtual(self._first_record_voffset)
        while True:
            rec = self._read_record()
            if rec is None:
                return
            yield rec

    # -- indexed fetch ------------------------------------------------------
    def _load_index(self):
        """Parse the full ``.bai``: per ref, (bins: {bin -> [(chunk_beg,
        chunk_end)]}, linear ioffsets). Returns None (with a one-time
        warning) when no index exists — fetch then falls back to a full
        scan from the first record, O(file) per region."""
        if self._index is not None:
            return self._index
        bai_path = self.path + ".bai"
        if not os.path.exists(bai_path):
            if not self._warned_no_index:
                self._warned_no_index = True
                import warnings

                warnings.warn(
                    f"{self.path}: no .bai index — every fetch() scans "
                    "from the first record (O(file size) per region). "
                    "Write the BAM through BamWriter to get an index.",
                    stacklevel=3,
                )
            return None
        with open(bai_path, "rb") as fh:
            data = fh.read()
        if data[:4] != _BAI_MAGIC:
            raise ValueError(f"{bai_path}: not a BAI index")
        off = 4
        n_ref = struct.unpack_from("<i", data, off)[0]
        off += 4
        index: List[Tuple[Dict[int, List[Tuple[int, int]]], List[int]]] = []
        for _ in range(n_ref):
            n_bin = struct.unpack_from("<i", data, off)[0]
            off += 4
            bins: Dict[int, List[Tuple[int, int]]] = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    beg, cend = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((beg, cend))
                if bin_id == 37450:
                    # samtools' metadata pseudo-bin (SAM spec §5.2): its
                    # two "chunks" are (file range, mapped/unmapped
                    # counts), NOT virtual offsets. reg2bins can never
                    # return 37450 (real bins top out at 37448), but
                    # storing it would still poison any future whole-bin
                    # consumer — drop it explicitly.
                    continue
                bins[bin_id] = chunks
            n_intv = struct.unpack_from("<i", data, off)[0]
            off += 4
            ioffsets = list(struct.unpack_from(f"<{n_intv}Q", data, off))
            off += 8 * n_intv
            index.append((bins, ioffsets))
        self._index = index
        return index

    def _linear_min_voffset(self, ioffsets: List[int], start: int) -> int:
        """Smallest useful virtual offset from the linear index: records
        overlapping ``start`` cannot begin before it."""
        if not ioffsets:
            return 0
        i = min(start >> _LINEAR_SHIFT, len(ioffsets) - 1)
        while i >= 0 and ioffsets[i] == 0:
            i -= 1
        return ioffsets[i] if i >= 0 else 0

    def _region_chunks(
        self, tid: int, start: int, end: int
    ) -> Optional[List[Tuple[int, int]]]:
        """htslib-style region query: candidate bins' chunks, pruned by
        the linear index, merged when overlapping/adjacent. None when no
        index (or an old linear-only index) is available."""
        index = self._load_index()
        if index is None or tid >= len(index):
            return None
        bins, ioffsets = index[tid]
        if not bins:
            return None  # linear-only .bai (our own pre-bin writer)
        min_voff = self._linear_min_voffset(ioffsets, start)
        chunks = []
        for b in reg2bins(start, end):
            for beg, cend in bins.get(b, ()):
                if cend > min_voff:
                    chunks.append((max(beg, min_voff), cend))
        chunks.sort()
        merged: List[Tuple[int, int]] = []
        for beg, cend in chunks:
            if merged and beg <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], cend))
            else:
                merged.append((beg, cend))
        return merged

    def fetch(
        self, contig: str, start: int = 0, end: Optional[int] = None
    ) -> Iterator[BamRecord]:
        """Yield mapped records overlapping ``[start, end)`` on ``contig``
        in file (coordinate) order. With a binned ``.bai`` the read is
        restricted to the region's chunk list (htslib semantics, ref:
        Dependencies/htslib-1.9/htslib/sam.h bin+chunk query); a
        linear-only index gives a tight start offset; no index falls
        back to a full scan (with a warning)."""
        if contig not in self.tid_by_name:
            raise KeyError(f"unknown contig {contig!r}")
        tid = self.tid_by_name[contig]
        if end is None:
            end = self.references[tid][1]

        chunks = self._region_chunks(tid, start, end)
        if chunks is not None:
            yield from self._fetch_chunks(chunks, tid, start, end)
            return

        voffset = self._first_record_voffset
        index = self._load_index()
        if index is not None and tid < len(index):
            lin = self._linear_min_voffset(index[tid][1], start)
            if lin:
                voffset = lin
        self._bgzf.seek_virtual(voffset)

        while True:
            rec = self._read_record()
            if rec is None:
                return
            if rec.tid != tid:
                # coordinate-sorted: a later tid means we're past our contig
                if rec.tid > tid or rec.tid < 0:
                    return
                continue
            if rec.pos >= end:
                return
            if rec.is_unmapped:
                continue
            if rec.reference_end > start:
                yield rec

    def _fetch_chunks(
        self, chunks: List[Tuple[int, int]], tid: int, start: int, end: int
    ) -> Iterator[BamRecord]:
        for beg, cend in chunks:
            self._bgzf.seek_virtual(beg)
            while self._bgzf.tell_virtual() < cend:
                rec = self._read_record()
                if rec is None:
                    return
                if rec.tid != tid:
                    if rec.tid > tid or rec.tid < 0:
                        return  # coordinate-sorted: past our contig
                    continue
                if rec.pos >= end:
                    return  # coordinate-sorted: past the region
                if rec.is_unmapped:
                    continue
                if rec.reference_end > start:
                    yield rec

    def close(self) -> None:
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BamWriter:
    """Writes a coordinate-sorted BAM and its ``.bai`` with the full
    bin+chunk structure plus the linear index (SAM spec §5.1.3/§5.3 —
    the same layout htslib emits), so :class:`BamReader` and the native
    extractor can restrict region fetches to the relevant chunks."""

    def __init__(self, path: str, references: Sequence[Tuple[str, int]]):
        self.path = path
        self.references = list(references)
        self._bgzf = BgzfWriter(path)
        header_lines = ["@HD\tVN:1.6\tSO:coordinate"] + [
            f"@SQ\tSN:{n}\tLN:{l}" for n, l in self.references
        ]
        text = ("\n".join(header_lines) + "\n").encode()
        self._bgzf.write(_BAM_MAGIC)
        self._bgzf.write(struct.pack("<i", len(text)) + text)
        self._bgzf.write(struct.pack("<i", len(self.references)))
        for name, length in self.references:
            nb = name.encode() + b"\x00"
            self._bgzf.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", length))
        # index accumulators: per ref, interval -> min voffset (linear)
        # and bin -> [(chunk_beg, chunk_end)] (distributed bins)
        self._ioffsets: List[Dict[int, int]] = [dict() for _ in self.references]
        self._bins: List[Dict[int, List[List[int]]]] = [
            dict() for _ in self.references
        ]
        self._last_key: Optional[Tuple[int, int]] = None

    def write(self, rec: BamRecord) -> None:
        if rec.tid >= 0:
            key = (rec.tid, rec.pos)
            if self._last_key is not None and key < self._last_key:
                raise ValueError("records must be written in coordinate order")
            self._last_key = key
        voffset = self._bgzf.tell_virtual()
        self._bgzf.write(_encode_record(rec))
        if rec.tid >= 0 and not rec.is_unmapped:
            rec_end = max(rec.reference_end, rec.pos + 1)
            for iv in range(rec.pos >> _LINEAR_SHIFT, (rec_end - 1 >> _LINEAR_SHIFT) + 1):
                self._ioffsets[rec.tid].setdefault(iv, voffset)
            # extend the bin's open chunk when records are contiguous in
            # the file (htslib merges exactly this way), else open one
            vend = self._bgzf.tell_virtual()
            chunks = self._bins[rec.tid].setdefault(
                reg2bin(rec.pos, rec_end), []
            )
            if chunks and chunks[-1][1] == voffset:
                chunks[-1][1] = vend
            else:
                chunks.append([voffset, vend])

    def close(self) -> None:
        self._bgzf.close()
        with open(self.path + ".bai", "wb") as fh:
            fh.write(_BAI_MAGIC)
            fh.write(struct.pack("<i", len(self.references)))
            for tid in range(len(self.references)):
                bins = self._bins[tid]
                fh.write(struct.pack("<i", len(bins)))
                for bin_id in sorted(bins):
                    chunks = bins[bin_id]
                    fh.write(struct.pack("<Ii", bin_id, len(chunks)))
                    for beg, cend in chunks:
                        fh.write(struct.pack("<QQ", beg, cend))
                ivs = self._ioffsets[tid]
                n_intv = (max(ivs) + 1) if ivs else 0
                fh.write(struct.pack("<i", n_intv))
                for i in range(n_intv):
                    fh.write(struct.pack("<Q", ivs.get(i, 0)))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_sorted_bam(
    path: str,
    references: Sequence[Tuple[str, int]],
    records: Sequence[BamRecord],
) -> None:
    """Sort ``records`` by (tid, pos) and write BAM + BAI."""
    recs = sorted(records, key=lambda r: (r.tid if r.tid >= 0 else 1 << 30, r.pos))
    with BamWriter(path, references) as w:
        for r in recs:
            w.write(r)
