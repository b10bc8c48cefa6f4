"""SAM text reader — the plain-text sibling of :mod:`roko_tpu_torch.io.bam`.

The reference consumes alignments through htslib, which transparently
reads SAM text as well as BAM (Dependencies/htslib-1.9/sam.c
``sam_read1``); callers never know which container they were handed.
This module gives the framework the same property: :class:`SamReader`
yields the same :class:`~roko_tpu_torch.io.bam.BamRecord` objects as
:class:`~roko_tpu_torch.io.bam.BamReader`, so every downstream stage (pileup,
extractor, labeler) works off either container unchanged.

Field semantics follow the SAM spec v1 (mandatory 11 columns + typed
aux tags) with htslib's conventions: 1-based POS converted to 0-based,
``*`` sentinels mapped to the BAM in-memory encodings (empty cigar/seq,
0xff qual), ``=``/``*`` RNEXT resolved against the @SQ-declared
references, and aux tags re-encoded into BAM binary tag bytes (ints take
the smallest width that fits, as htslib's ``sam_parse1`` does).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

from roko_tpu_torch import constants as C
from roko_tpu_torch.io.bam import BamRecord

_CIGAR_OP_BY_CHAR = {c: i for i, c in enumerate(C.CIGAR_OPS)}


class SamError(ValueError):
    pass


def _parse_cigar(text: str) -> Tuple[Tuple[int, int], ...]:
    if text == "*":
        return ()
    ops: List[Tuple[int, int]] = []
    n = 0
    seen_digit = False
    for ch in text:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
            seen_digit = True
            continue
        op = _CIGAR_OP_BY_CHAR.get(ch)
        if op is None or not seen_digit:
            raise SamError(f"bad CIGAR {text!r}")
        ops.append((op, n))
        n = 0
        seen_digit = False
    if seen_digit:
        raise SamError(f"bad CIGAR {text!r} (trailing length)")
    return tuple(ops)


# B-array subtypes: struct code + value range check is delegated to
# struct.pack itself (it raises for out-of-range, which we wrap)
_B_SUBTYPES = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}


def _encode_int_tag(tag: bytes, value: int) -> bytes:
    """Smallest-width BAM int encoding, mirroring htslib sam_parse1."""
    if value >= 0:
        if value <= 0xFF:
            return tag + b"C" + struct.pack("<B", value)
        if value <= 0x7FFF:
            return tag + b"s" + struct.pack("<h", value)
        if value <= 0xFFFF:
            return tag + b"S" + struct.pack("<H", value)
        if value <= 0x7FFFFFFF:
            return tag + b"i" + struct.pack("<i", value)
        if value <= 0xFFFFFFFF:
            return tag + b"I" + struct.pack("<I", value)
        raise SamError(f"integer tag value {value} exceeds 32 bits")
    if value >= -0x80:
        return tag + b"c" + struct.pack("<b", value)
    if value >= -0x8000:
        return tag + b"s" + struct.pack("<h", value)
    if value >= -0x80000000:
        return tag + b"i" + struct.pack("<i", value)
    raise SamError(f"integer tag value {value} exceeds 32 bits")


def _encode_tag(field: str) -> bytes:
    try:
        name, typ, val = field.split(":", 2)
    except ValueError:
        raise SamError(f"bad aux field {field!r}") from None
    if len(name) != 2:
        raise SamError(f"bad aux tag name in {field!r}")
    tag = name.encode()
    try:
        if typ == "A":
            if len(val) != 1:
                raise SamError(f"bad A tag {field!r}")
            return tag + b"A" + val.encode()
        if typ == "i":
            return _encode_int_tag(tag, int(val))
        if typ == "f":
            return tag + b"f" + struct.pack("<f", float(val))
        if typ == "Z":
            return tag + b"Z" + val.encode() + b"\x00"
        if typ == "H":
            bytes.fromhex(val)  # validate hex digits (pairs)
            return tag + b"H" + val.encode() + b"\x00"
        if typ == "B":
            parts = val.split(",")
            sub = parts[0]
            code = _B_SUBTYPES.get(sub)
            if code is None:
                raise SamError(f"bad B subtype in {field!r}")
            conv = float if sub == "f" else int
            vals = [conv(p) for p in parts[1:]]
            return (
                tag
                + b"B"
                + sub.encode()
                + struct.pack("<i", len(vals))
                + struct.pack(f"<{len(vals)}{code}", *vals)
            )
    except (ValueError, struct.error) as e:
        raise SamError(f"bad aux field {field!r}: {e}") from None
    raise SamError(f"unknown aux type {typ!r} in {field!r}")


class SamReader:
    """Iterate a SAM text file as :class:`BamRecord` objects.

    Exposes the same surface the pipeline uses on :class:`BamReader`:
    ``references`` (from @SQ lines, in order), ``tid_by_name``, and
    ``header_text``. No random access — SAM text has no index; region
    queries should go through a coordinate-sorted BAM
    (:func:`roko_tpu_torch.io.bam.write_sorted_bam`).
    """

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rt", encoding="utf-8", errors="replace")
        self.references: List[Tuple[str, int]] = []
        header_lines: List[str] = []
        self._first_line: str | None = None
        try:
            for line in self._fh:
                if line.startswith("@"):
                    header_lines.append(line)
                    if line.startswith("@SQ"):
                        fields = dict(
                            f.split(":", 1)
                            for f in line.rstrip("\n").split("\t")[1:]
                            if ":" in f
                        )
                        try:
                            self.references.append(
                                (fields["SN"], int(fields["LN"]))
                            )
                        except (KeyError, ValueError):
                            raise SamError(
                                f"{path}: bad @SQ line {line!r}"
                            ) from None
                    continue
                if line.strip() == "":
                    continue  # same permissive blank-line skip as __iter__
                self._first_line = line
                break
        except BaseException:
            self._fh.close()
            raise
        self.header_text = "".join(header_lines)
        self.tid_by_name: Dict[str, int] = {
            n: i for i, (n, _) in enumerate(self.references)
        }

    def _parse_line(self, line: str, lineno: int) -> BamRecord:
        # trailing tabs produce empty fields (seen in htslib fixtures) —
        # drop them rather than mis-parse as an aux tag
        fields = [f for f in line.rstrip("\r\n").split("\t") if f != ""]
        if len(fields) < 11:
            raise SamError(
                f"{self.path}:{lineno}: {len(fields)} fields (need 11)"
            )
        (qname, flag_s, rname, pos_s, mapq_s, cigar_s,
         rnext, pnext_s, tlen_s, seq, qual) = fields[:11]
        try:
            flag = int(flag_s)
            pos = int(pos_s) - 1
            mapq = int(mapq_s)
            pnext = int(pnext_s) - 1
            tlen = int(tlen_s)
        except ValueError:
            raise SamError(
                f"{self.path}:{lineno}: non-numeric mandatory field"
            ) from None
        if rname == "*":
            tid = -1
        else:
            tid = self.tid_by_name.get(rname, -2)
            if tid == -2:
                raise SamError(
                    f"{self.path}:{lineno}: RNAME {rname!r} not in @SQ"
                )
        if rnext == "*":
            next_tid = -1
        elif rnext == "=":
            next_tid = tid
        else:
            next_tid = self.tid_by_name.get(rnext, -2)
            if next_tid == -2:
                raise SamError(
                    f"{self.path}:{lineno}: RNEXT {rnext!r} not in @SQ"
                )
        seq_str = "" if seq == "*" else seq
        if qual == "*":
            qual_b = b"\xff" * len(seq_str)
        else:
            qual_b = bytes((ord(c) - 33) & 0xFF for c in qual)
            if seq_str and len(qual_b) != len(seq_str):
                raise SamError(
                    f"{self.path}:{lineno}: SEQ/QUAL length mismatch"
                )
        tags = b"".join(_encode_tag(f) for f in fields[11:])
        return BamRecord(
            name=qname,
            flag=flag,
            tid=tid,
            pos=pos,
            mapq=mapq,
            cigar=_parse_cigar(cigar_s),
            seq=seq_str,
            qual=qual_b,
            next_tid=next_tid,
            next_pos=pnext,
            tlen=tlen,
            tags=tags,
        )

    def __iter__(self) -> Iterator[BamRecord]:
        lineno = self.header_text.count("\n")
        if self._first_line is not None:
            lineno += 1
            yield self._parse_line(self._first_line, lineno)
            self._first_line = None
        for line in self._fh:
            lineno += 1
            if line.strip() == "":
                continue  # permissive: blank trailing lines
            yield self._parse_line(line, lineno)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
