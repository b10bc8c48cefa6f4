"""BGZF (blocked gzip) reader/writer.

BGZF is the container format under BAM/BAI: a series of gzip members, each
at most 64 KiB uncompressed, carrying a BSIZE extra field so readers can
seek to a block boundary without inflating. Virtual file offsets are
``(compressed_offset << 16) | within_block_offset`` (SAM spec §4.1).

Self-contained on top of :mod:`zlib`; no htslib.
"""

from __future__ import annotations

import struct
import zlib
from typing import BinaryIO

#: gzip magic + deflate + FEXTRA flag
_HEADER_PREFIX = b"\x1f\x8b\x08\x04"
#: fixed 28-byte empty terminator block (SAM spec §4.1.2)
EOF_MARKER = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

#: maximum uncompressed payload per block
MAX_BLOCK_DATA = 65280


class BgzfError(ValueError):
    pass


def _compress_block(data: bytes, level: int = 6) -> bytes:
    comp = zlib.compressobj(level, zlib.DEFLATED, -15)
    payload = comp.compress(data) + comp.flush()
    # header = 12 fixed bytes + 6 extra-field bytes; trailer = crc32 + isize.
    bsize = 18 + len(payload) + 8
    if bsize > 65536:
        raise BgzfError("BGZF block too large after compression")
    header = (
        _HEADER_PREFIX
        + b"\x00\x00\x00\x00"  # mtime
        + b"\x00\xff"  # XFL, OS
        + struct.pack("<H", 6)  # XLEN
        + b"BC"
        + struct.pack("<H", 2)  # SLEN
        + struct.pack("<H", bsize - 1)
    )
    trailer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data) & 0xFFFFFFFF)
    return header + payload + trailer


class BgzfWriter:
    def __init__(self, fileobj_or_path, level: int = 6):
        if isinstance(fileobj_or_path, (str, bytes)):
            self._fh: BinaryIO = open(fileobj_or_path, "wb")
            self._owns = True
        else:
            self._fh = fileobj_or_path
            self._owns = False
        self._level = level
        self._buf = bytearray()

    # -- virtual offset of the next byte to be written ----------------------
    def tell_virtual(self) -> int:
        return (self._fh.tell() << 16) | len(self._buf)

    def write(self, data: bytes) -> None:
        self._buf.extend(data)
        while len(self._buf) >= MAX_BLOCK_DATA:
            self._flush_block(MAX_BLOCK_DATA)

    def flush(self) -> None:
        while self._buf:
            self._flush_block(min(len(self._buf), MAX_BLOCK_DATA))

    def _flush_block(self, n: int) -> None:
        chunk = bytes(self._buf[:n])
        del self._buf[:n]
        self._fh.write(_compress_block(chunk, self._level))

    def close(self) -> None:
        self.flush()
        self._fh.write(EOF_MARKER)
        if self._owns:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BgzfReader:
    """Sequential reader with virtual-offset seek (for BAI chunk starts)."""

    def __init__(self, fileobj_or_path):
        if isinstance(fileobj_or_path, (str, bytes)):
            self._fh: BinaryIO = open(fileobj_or_path, "rb")
            self._owns = True
        else:
            self._fh = fileobj_or_path
            self._owns = False
        self._block: bytes = b""
        self._block_coffset = 0  # compressed offset of current block
        self._within = 0  # cursor within the current (uncompressed) block
        self._eof = False

    def _load_block_at(self, coffset: int) -> bool:
        """Read the block starting at compressed offset ``coffset``.
        Returns False at physical EOF."""
        self._fh.seek(coffset)
        header = self._fh.read(18)
        if len(header) == 0:
            return False
        if len(header) < 18 or header[:4] != _HEADER_PREFIX:
            raise BgzfError(f"bad BGZF header at offset {coffset}")
        xlen = struct.unpack_from("<H", header, 10)[0]
        # scan extra subfields for BC/BSIZE
        if xlen >= 6:
            extra = header[12:18] + self._fh.read(xlen - 6)
        else:
            extra = header[12 : 12 + xlen]
        bsize = None
        off = 0
        while off + 4 <= len(extra):
            si1, si2, slen = extra[off], extra[off + 1], struct.unpack_from("<H", extra, off + 2)[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack_from("<H", extra, off + 4)[0] + 1
                break
            off += 4 + slen
        if bsize is None:
            raise BgzfError(f"no BSIZE field in BGZF block at {coffset}")
        payload_len = bsize - (12 + xlen) - 8
        payload = self._fh.read(payload_len)
        trailer = self._fh.read(8)
        if len(payload) != payload_len or len(trailer) != 8:
            raise BgzfError("truncated BGZF block")
        crc, isize = struct.unpack("<II", trailer)
        data = zlib.decompress(payload, -15)
        if len(data) != isize or (zlib.crc32(data) & 0xFFFFFFFF) != crc:
            raise BgzfError(f"BGZF block checksum mismatch at {coffset}")
        self._block = data
        self._block_coffset = coffset
        self._within = 0
        return True

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            if self._within >= len(self._block):
                coffset = self._fh.tell()
                if not self._load_block_at(coffset):
                    break
                if not self._block:  # empty EOF block — keep reading (may be mid-file)
                    continue
            take = min(n, len(self._block) - self._within)
            out.extend(self._block[self._within : self._within + take])
            self._within += take
            n -= take
        return bytes(out)

    def seek_virtual(self, voffset: int) -> None:
        coffset, within = voffset >> 16, voffset & 0xFFFF
        if not self._load_block_at(coffset):
            raise BgzfError(f"virtual offset {voffset:#x} beyond EOF")
        if within > len(self._block):
            raise BgzfError(f"virtual offset {voffset:#x} beyond block end")
        self._within = within

    def tell_virtual(self) -> int:
        if self._within >= len(self._block):
            # cursor is logically at the start of the next block
            return self._fh.tell() << 16
        return (self._block_coffset << 16) | self._within

    def close(self) -> None:
        if self._owns:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
