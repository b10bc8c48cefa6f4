"""SplitMix64: the row-sampling generator of both feature extractors,
Python and C++ (copy of ``roko_tpu/utils/rng.py``).

roko's own extractor seeds libc ``rand`` from the clock (gen.cpp:11), so
its windows differ run to run. Here every region derives a stable seed
from (user seed, contig, region start) and both extractors draw from this
generator, so their windows are bitwise equal.
"""

from __future__ import annotations

import zlib

_MASK = (1 << 64) - 1


class SplitMix64:
    """Sebastiano Vigna's SplitMix64 (public domain reference algorithm)."""

    def __init__(self, seed: int):
        self.state = seed & _MASK

    def next_u64(self) -> int:
        self.state = (self.state + 0x9E3779B97F4A7C15) & _MASK
        z = self.state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        return (z ^ (z >> 31)) & _MASK

    def next_below(self, n: int) -> int:
        """Uniform-ish draw in [0, n) by modulo (bias < 2**-50 for the
        n <= a-few-thousand draws used here; determinism matters more)."""
        return self.next_u64() % n


def derive_region_seed(base_seed: int, contig: str, start: int) -> int:
    """Stable per-region seed, so results do not depend on how workers are
    scheduled: the crc32 of the contig name and the region start are each
    mixed in through the SplitMix64 finalizer (the C++ side can compute
    the same). Equal to ``roko_tpu.utils.rng.derive_region_seed``."""
    h = SplitMix64(base_seed)
    h.state = (h.state ^ zlib.crc32(contig.encode())) & _MASK
    h.next_u64()
    h.state = (h.state ^ start) & _MASK
    return h.next_u64()
