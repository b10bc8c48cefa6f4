"""Banded unit-cost global alignment with exact edit-op counts (the
port's copy of ``roko_tpu/eval/align.py``).

Two implementations with identical semantics (including tie-breaking:
diagonal preferred over a gap at equal cost, deletion preferred over
insertion), so the pure-Python one is the test oracle for the C++ hot
path in native/src/align.cc:

- :func:`banded_align_py` — reference implementation, plain Python DP.
- :func:`banded_align` — dispatches to the native library when it is
  available (built on demand, same build as the feature extractor) and
  falls back to the Python DP otherwise. Host code: no device path.

Tie-breaking matters here: equal-cost alignments can decompose the
same edit distance differently (two substitutions vs an
insertion+deletion pair never tie, but gap placement around repeats
does), and the assess report promises native-vs-Python bit-equality
the way the extractor does (tests/test_torch_assess.py).
"""

from __future__ import annotations

from dataclasses import dataclass

# Default DP working-set cap: one traceback byte per cell.
MAX_CELLS = 256_000_000


@dataclass
class AlignResult:
    match: int
    sub: int
    ins: int  # bases present only in ``b``
    dele: int  # bases of ``a`` missing from ``b``
    hit_band_edge: bool
    #: error events in a-coordinates, only when requested (collect_ops)
    ops: "list[tuple[str, int]] | None" = None

    @property
    def errors(self) -> int:
        return self.sub + self.ins + self.dele


def banded_align_py(
    a: bytes,
    b: bytes,
    pad: int,
    max_cells: int = MAX_CELLS,
    *,
    collect_ops: bool = False,
) -> AlignResult:
    """Python reference DP; see module docstring. Raises MemoryError
    when ``(len(a)+1) * band_width`` exceeds ``max_cells``.

    With ``collect_ops`` the result's ``ops`` lists the error events in
    ``a``-coordinates, ordered by position: ``("sub", i)`` — ``a[i]``
    substituted; ``("del", i)`` — ``a[i]`` missing from ``b``;
    ``("ins", i)`` — extra ``b`` base(s) aligned before ``a[i]`` (i may
    equal ``len(a)`` for a trailing insertion). Matches are omitted.
    The assess tool uses this only on the (few) segments whose native
    counts show errors, so the hot path stays in C++."""
    la, lb = len(a), len(b)
    if la == 0 or lb == 0:
        res = AlignResult(0, 0, lb, la, False)
        if collect_ops:
            res.ops = (
                [("ins", 0)] * lb if lb else []
            ) + ([("del", i) for i in range(la)])
        return res
    dlo = min(0, lb - la) - pad
    dhi = max(0, lb - la) + pad
    width = dhi - dlo + 1
    if (la + 1) * width > max_cells:
        raise MemoryError("alignment working set exceeds max_cells")

    INF = 1 << 60
    DIAG, UP, LEFT, NONE = 1, 2, 3, 0
    prev = [INF] * width
    moves = [bytearray(width) for _ in range(la + 1)]
    for w in range(width):
        j = dlo + w
        if 0 <= j <= lb:
            prev[w] = j
            moves[0][w] = LEFT if j else NONE
    for i in range(1, la + 1):
        cur = [INF] * width
        row = moves[i]
        ai = a[i - 1]
        for w in range(width):
            j = i + dlo + w
            if j < 0 or j > lb:
                continue
            best = prev[w + 1] + 1 if w + 1 < width and prev[w + 1] < INF else INF
            mv = UP
            if w >= 1 and cur[w - 1] < INF and cur[w - 1] + 1 < best:
                best = cur[w - 1] + 1
                mv = LEFT
            if j >= 1 and prev[w] < INF:
                c = prev[w] + (0 if ai == b[j - 1] else 1)
                if c <= best:
                    best = c
                    mv = DIAG
            if j == 0:
                best = i
                mv = UP
            cur[w] = best
            row[w] = mv if best < INF else NONE
        prev = cur

    end_w = lb - la - dlo
    if not (0 <= end_w < width) or prev[end_w] >= INF:
        raise RuntimeError("band does not contain the end cell")

    res = AlignResult(0, 0, 0, 0, False)
    ops: list = [] if collect_ops else None  # type: ignore[assignment]
    i, w = la, end_w
    while i > 0 or i + dlo + w > 0:
        j = i + dlo + w
        if (w == 0 or w == width - 1) and i > 0 and j > 0:
            res.hit_band_edge = True
        mv = moves[i][w]
        if mv == DIAG:
            if a[i - 1] == b[j - 1]:
                res.match += 1
            else:
                res.sub += 1
                if collect_ops:
                    ops.append(("sub", i - 1))
            i -= 1
        elif mv == UP:
            res.dele += 1
            if collect_ops:
                ops.append(("del", i - 1))
            i -= 1
            w += 1
        elif mv == LEFT:
            res.ins += 1
            if collect_ops:
                ops.append(("ins", i))
            w -= 1
        else:
            raise RuntimeError("corrupt traceback")
    if collect_ops:
        ops.reverse()
        res.ops = ops
    return res


def banded_align(
    a: bytes, b: bytes, pad: int, max_cells: int = MAX_CELLS
) -> AlignResult:
    """Native-if-available banded alignment (semantics of
    :func:`banded_align_py`)."""
    from roko_tpu_torch.native import binding

    if binding.is_available():
        m, s, i, d, edge = binding.align_counts(a, b, pad, max_cells)
        return AlignResult(m, s, i, d, edge)
    return banded_align_py(a, b, pad, max_cells)


def align_with_band_growth(
    a: bytes,
    b: bytes,
    *,
    pad: int = 16,
    max_pad: int = 4096,
    max_cells: int = MAX_CELLS,
) -> AlignResult:
    """Run :func:`banded_align`, doubling the band padding until the
    result is provably optimal by the Ukkonen bound: once the in-band
    cost satisfies ``errors <= pad``, every alignment of that cost or
    cheaper fits entirely inside the band (an alignment with ``e``
    errors deviates at most ``e`` diagonals from the ``[0, lb-la]``
    hull), so the in-band optimum IS the global optimum. Band-edge
    contact alone is neither necessary nor sufficient — fuzzing found
    no-contact results 1-2 above the true distance (ADVICE r3) — so it
    is no longer the stop condition. Returns with ``hit_band_edge``
    True only when ``max_pad`` or the cell budget capped growth before
    the bound held, i.e. the counts are an upper bound, so callers can
    count capped segments honestly."""
    pad = max(1, pad)  # pad=0 would double to 0 forever
    while True:
        try:
            res = banded_align(a, b, pad, max_cells)
        except MemoryError:
            # shrink until the working set fits; the result is then
            # explicitly marked band-capped
            while pad > 16:
                pad //= 2
                try:
                    res = banded_align(a, b, pad, max_cells)
                except MemoryError:
                    continue
                res.hit_band_edge = True
                return res
            raise  # even the narrowest band does not fit
        if res.errors <= pad:
            res.hit_band_edge = False  # provably exact, even on contact
            return res
        if pad >= max_pad:
            res.hit_band_edge = True  # upper bound, not provably exact
            return res
        pad *= 2
