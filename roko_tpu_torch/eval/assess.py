"""Polished-vs-truth assembly assessment (the port's copy of
``roko_tpu/eval/assess.py``).

Produces the metrics of roko's published comparison table — total
error, mismatch, deletion, insertion rates and Qscore — which roko
obtains from the external ``pomoxis assess_assembly`` tool. Having the
evaluator in the package makes the accuracy metric self-measurable.

Method (dnadiff-style anchor decomposition, not a translation of any
tool): contigs are paired by name or by shared unique-k-mer content
(either orientation), then each pair is decomposed into collinear
unique-16-mer anchors (numpy rolling hash -> unique-in-both ->
longest-increasing-subsequence chain) and the short inter-anchor
segments are globally aligned with the banded unit-cost DP
(eval/align.py; C++ hot path). Anchored bases count as matches; edit
ops come from exact tracebacks, so rates are alignment-derived like
pomoxis', not k-mer estimates.

Conventions: rates are per truth base (``errors / truth_len``);
``Qscore = -10 log10(total_error_rate)``, infinite for a perfect
match. Deletion = truth base missing from the polished sequence;
insertion = polished base absent from truth. ``N`` bases in the truth
break anchors and compare as mismatches in aligned segments; their
count is surfaced per contig (``truth_n``) and in the report so
unknown-truth artefacts are distinguishable from polishing errors.
"""

from __future__ import annotations

import json
import math
from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from roko_tpu_torch.eval.align import AlignResult, align_with_band_growth

K = 16  # anchor k-mer size (fits 2 bits/base in int32; unique-in-both)
MIN_ANCHOR_SPACING = 50  # thin anchors to one per this many truth bases
PAIRING_SAMPLE_STRIDE = 8  # k-mer subsample stride for contig pairing

_COMP = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")


def revcomp(seq: bytes) -> bytes:
    return seq.translate(_COMP)[::-1]


def _kmer_codes(seq: bytes, k: int = K) -> Tuple[np.ndarray, np.ndarray]:
    """(codes, positions) of all ACGT-only k-mers, 2-bit rolling encode.
    Positions with any non-ACGT base are dropped (N's break anchors)."""
    if not 1 <= k <= 32:
        raise ValueError(f"k must be in [1, 32] (2 bits/base in int64), got {k}")
    arr = np.frombuffer(seq.upper(), dtype=np.uint8)
    n = arr.size
    if n < k:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    code2 = np.full(n, 255, np.uint8)
    for v, base in enumerate(b"ACGT"):
        code2[arr == base] = v
    valid = code2 != 255
    codes = np.zeros(n - k + 1, np.int64)
    ok = np.ones(n - k + 1, bool)
    for t in range(k):
        codes = (codes << 2) | code2[t : n - k + 1 + t]
        ok &= valid[t : n - k + 1 + t]
    pos = np.nonzero(ok)[0]
    return codes[pos], pos


def _unique_kmers(seq: bytes, k: int = K) -> Tuple[np.ndarray, np.ndarray]:
    """(codes, positions) of k-mers occurring exactly once in ``seq``."""
    codes, pos = _kmer_codes(seq, k)
    if codes.size == 0:
        return codes, pos
    uniq, first, counts = np.unique(codes, return_index=True, return_counts=True)
    keep = counts == 1
    return uniq[keep], pos[first[keep]]


def _lis_chain(tpos: np.ndarray, ppos: np.ndarray) -> List[Tuple[int, int]]:
    """Longest strictly-increasing chain of (truth_pos, polished_pos)
    anchor pairs: input sorted by tpos (unique), LIS on ppos."""
    tails: List[int] = []  # ppos of chain tails
    tails_idx: List[int] = []
    parent = np.full(len(ppos), -1, np.int64)
    for i, p in enumerate(ppos):
        j = bisect_left(tails, p)
        if j == len(tails):
            tails.append(p)
            tails_idx.append(i)
        else:
            tails[j] = p
            tails_idx[j] = i
        parent[i] = tails_idx[j - 1] if j > 0 else -1
    chain: List[Tuple[int, int]] = []
    i = tails_idx[-1] if tails_idx else -1
    while i >= 0:
        chain.append((int(tpos[i]), int(ppos[i])))
        i = parent[i]
    chain.reverse()
    return chain


def _anchors(truth: bytes, polished: bytes, k: int = K) -> List[Tuple[int, int]]:
    """Collinear non-overlapping (truth_pos, polished_pos) anchors."""
    tc, tp = _unique_kmers(truth, k)
    pc, pp = _unique_kmers(polished, k)
    if tc.size == 0 or pc.size == 0:
        return []
    # _unique_kmers outputs are unique by construction; skip the re-dedup
    shared, ti, pi = np.intersect1d(
        tc, pc, assume_unique=True, return_indices=True
    )
    if shared.size == 0:
        return []
    tpos, ppos = tp[ti], pp[pi]
    order = np.argsort(tpos, kind="stable")
    tpos, ppos = tpos[order], ppos[order]
    # thin: ~one anchor per MIN_ANCHOR_SPACING truth bases keeps the LIS
    # cheap on megabase contigs without losing chain resolution. Bucket
    # firsts instead of a greedy running-distance walk: vectorised O(n)
    # (the Python loop was the profile's hottest line on multi-Mb
    # contigs), and the later >=k non-overlap filter bounds closeness
    # across bucket edges. Anchors are exact matches by construction, so
    # thinning strategy affects segmentation, never counts.
    if tpos.size > 2:
        buckets = tpos // MIN_ANCHOR_SPACING  # tpos sorted -> buckets sorted
        keep = np.concatenate([[True], np.diff(buckets) != 0])
        tpos, ppos = tpos[keep], ppos[keep]
    chain = _lis_chain(tpos, ppos)
    # enforce non-overlap in BOTH sequences so anchor k-mers can be
    # counted as k matches each without double counting
    out: List[Tuple[int, int]] = []
    last_t, last_p = -(10**18), -(10**18)
    for t, p in chain:
        if t >= last_t + k and p >= last_p + k:
            out.append((t, p))
            last_t, last_p = t, p
    return out


@dataclass
class ContigAssessment:
    truth_name: str
    polished_name: Optional[str]  # None: truth contig had no partner
    truth_len: int
    polished_len: int = 0
    reverse_complemented: bool = False
    match: int = 0
    sub: int = 0
    ins: int = 0
    dele: int = 0
    anchors: int = 0
    band_capped_segments: int = 0
    #: 'N' bases in the truth contig: they break anchors and compare as
    #: mismatches in aligned segments (the polished sequence is ACGT
    #: only), so up to this many reported errors may be unknown-truth
    #: artefacts rather than polishing mistakes
    truth_n: int = 0
    #: merged truth-space error rows (start, end, kind, count), only
    #: when assessed with collect_errors (the --bed CLI path)
    error_intervals: Optional[List[Tuple[int, int, str, int]]] = None

    @property
    def errors(self) -> int:
        return self.sub + self.ins + self.dele

    @property
    def error_rate(self) -> float:
        return self.errors / self.truth_len if self.truth_len else 0.0

    def rate(self, n: int) -> float:
        return n / self.truth_len if self.truth_len else 0.0

    @property
    def qscore(self) -> float:
        if self.truth_len == 0:
            return 0.0
        if self.errors == 0:
            return math.inf
        return -10.0 * math.log10(self.error_rate)


@dataclass
class AssessResult:
    contigs: List[ContigAssessment] = field(default_factory=list)

    @property
    def truth_len(self) -> int:
        return sum(c.truth_len for c in self.contigs)

    def _total(self, attr: str) -> int:
        return sum(getattr(c, attr) for c in self.contigs)

    @property
    def error_rate(self) -> float:
        t = self.truth_len
        return self._total("errors") / t if t else 0.0

    @property
    def qscore(self) -> float:
        if self.error_rate == 0.0:
            return math.inf
        return -10.0 * math.log10(self.error_rate)

    def summary(self) -> Dict[str, object]:
        t = self.truth_len or 1
        q = self.qscore
        return {
            "contigs": len(self.contigs),
            "truth_len": self.truth_len,
            "total_error_pct": round(100.0 * self.error_rate, 4),
            "mismatch_pct": round(100.0 * self._total("sub") / t, 4),
            "deletion_pct": round(100.0 * self._total("dele") / t, 4),
            "insertion_pct": round(100.0 * self._total("ins") / t, 4),
            "qscore": None if math.isinf(q) else round(q, 2),
            "band_capped_segments": self._total("band_capped_segments"),
            "truth_n_bases": self._total("truth_n"),
            "unpaired_truth_contigs": [
                c.truth_name for c in self.contigs if c.polished_name is None
            ],
        }


def assess_pair(
    truth: bytes,
    polished: bytes,
    *,
    k: int = K,
    truth_name: str = "truth",
    polished_name: str = "polished",
    try_revcomp: bool = True,
    collect_errors: bool = False,
) -> ContigAssessment:
    """Assess one polished contig against one truth contig.

    ``collect_errors`` additionally fills ``error_intervals`` with
    merged truth-space (start, end, kind, count) rows — only segments
    whose (native-counted) result shows errors are re-walked through
    the Python traceback, so the hot path stays in C++."""
    # normalise case: soft-masked (lowercase) regions are sequence, not
    # differences — anchoring already uppercases, the DP must agree
    truth = truth.upper()
    polished = polished.upper()
    fwd_anchors = _anchors(truth, polished, k)
    anchors, seq, rc = fwd_anchors, polished, False
    # only pay for the reverse-complement pass when forward anchoring is
    # weak; a correctly-oriented contig anchors near the thinning density
    dense = len(fwd_anchors) >= max(4, len(truth) // (4 * MIN_ANCHOR_SPACING))
    if try_revcomp and not dense:
        rc_seq = revcomp(polished)
        rc_anchors = _anchors(truth, rc_seq, k)
        if len(rc_anchors) > len(fwd_anchors):
            anchors, seq, rc = rc_anchors, rc_seq, True
    out = ContigAssessment(
        truth_name=truth_name,
        polished_name=polished_name,
        truth_len=len(truth),
        polished_len=len(polished),
        reverse_complemented=rc,
        anchors=len(anchors),
        truth_n=truth.count(b"N"),
    )
    rows: Optional[List[Tuple[int, int, str, int]]] = (
        [] if collect_errors else None
    )
    if not anchors:
        # no common unique k-mers: align whole-vs-whole (tiny contigs)
        # or give up and count the truth as fully missing (honest
        # worst case; a band over megabases would be meaningless).
        # _segment degrades to the worst case on MemoryError, so a
        # pathological pair can't abort the whole report.
        if len(truth) * 2 < 1 << 20 and len(seq) * 2 < 1 << 20:
            _add(out, _segment(truth, seq, 0, rows))
        else:
            out.dele += len(truth)
            out.ins += len(seq)
            if collect_errors:
                rows.append((0, len(truth), "del", len(truth)))
                if seq:
                    rows.append((0, min(1, len(truth)), "ins", len(seq)))
        out.error_intervals = rows
        return out
    # prefix + inter-anchor segments + suffix; anchor k-mers are exact
    # matches by construction
    t_prev, p_prev = 0, 0
    for ti, pi in anchors:
        _add(out, _segment(truth[t_prev:ti], seq[p_prev:pi], t_prev, rows))
        out.match += k
        t_prev, p_prev = ti + k, pi + k
    _add(out, _segment(truth[t_prev:], seq[p_prev:], t_prev, rows))
    out.error_intervals = rows
    return out


# cells budget for the pure-Python position re-walk: far below the C++
# MAX_CELLS because each cell is an interpreted loop iteration (~50M
# cells ~ tens of seconds); bigger error-bearing segments fall back to
# coarse per-kind span rows instead of exact positions
_OPS_MAX_CELLS = 50_000_000


def _segment(
    a: bytes,
    b: bytes,
    t_offset: int = 0,
    rows: Optional[List[Tuple[int, int, str, int]]] = None,
) -> AlignResult:
    if not a and not b:
        return AlignResult(0, 0, 0, 0, False)
    pad = max(16, abs(len(a) - len(b)) + 16)
    try:
        res = align_with_band_growth(a, b, pad=pad)
    except MemoryError:
        # an anchor-free stretch too long for even the narrowest band
        # (multi-Mb structural divergence): degrade to the honest worst
        # case instead of aborting the whole report, and flag it capped
        res = AlignResult(0, 0, len(b), len(a), True)
        if rows is not None:
            _coarse_rows(rows, res, t_offset, len(a))
        return res
    if rows is not None and res.errors:
        # re-walk only error-bearing segments through the Python oracle
        # (identical tie-breaking -> identical path) to get exact
        # positions; oversized segments degrade to coarse span rows
        ops = _segment_ops(a, b, pad)
        if ops is None:
            _coarse_rows(rows, res, t_offset, len(a))
        else:
            rows.extend(
                (s + t_offset, e + t_offset, kind, n)
                for s, e, kind, n in merge_error_events(ops)
            )
    return res


def _coarse_rows(
    rows: List[Tuple[int, int, str, int]],
    res: AlignResult,
    t_offset: int,
    la: int,
) -> None:
    """Per-kind whole-segment rows when exact positions are unavailable:
    counts stay reconcilable with the report even without loci."""
    span_end = t_offset + max(1, la)
    if res.sub:
        rows.append((t_offset, span_end, "sub", res.sub))
    if res.dele:
        rows.append((t_offset, span_end, "del", res.dele))
    if res.ins:
        rows.append((t_offset, min(t_offset + 1, span_end), "ins", res.ins))


def _segment_ops(a: bytes, b: bytes, pad: int) -> Optional[List[Tuple[str, int]]]:
    """Exact error events for a segment, or None when the interpreted DP
    would exceed the cells budget (caller degrades to coarse rows)."""
    from roko_tpu_torch.eval.align import banded_align_py

    pad = max(1, pad)
    while True:
        width = abs(len(b) - len(a)) + 2 * pad + 1
        if (len(a) + 1) * width > _OPS_MAX_CELLS:
            return None
        try:
            r = banded_align_py(a, b, pad, collect_ops=True)
        except MemoryError:
            return None
        # same Ukkonen stop rule as align_with_band_growth: errors <= pad
        # proves in-band optimality; edge contact alone does not
        if r.errors <= pad or pad >= 4096:
            return r.ops or []
        pad *= 2


def merge_error_events(
    events: Optional[List[Tuple[str, int]]],
) -> List[Tuple[int, int, str, int]]:
    """Per-base (kind, truth_pos) events -> merged, sorted
    (start, end, kind, count) rows. sub/del runs merge into half-open
    intervals; insertions at the same point stack their count into one
    zero-advance row reported as [pos, pos+1) (the truth base the extra
    sequence precedes)."""
    if not events:
        return []
    events = sorted(events, key=lambda e: (e[1], e[0]))
    rows: List[Tuple[int, int, str, int]] = []
    for kind, pos in events:
        if rows:
            s, e, pkind, n = rows[-1]
            if pkind == kind and (
                (kind in ("sub", "del") and pos == e)
                or (kind == "ins" and pos == s)
            ):
                rows[-1] = (s, e if kind == "ins" else pos + 1, kind, n + 1)
                continue
        rows.append((pos, pos + 1, kind, 1))
    return rows


def _add(out: ContigAssessment, r: AlignResult) -> None:
    out.match += r.match
    out.sub += r.sub
    out.ins += r.ins
    out.dele += r.dele
    if r.hit_band_edge:
        out.band_capped_segments += 1


def _pair_contigs(
    truth: Dict[str, bytes], polished: Dict[str, bytes], k: int = K
) -> List[Tuple[str, Optional[str]]]:
    """(truth_name, polished_name) pairs: by identical names when they
    all line up, else greedy best shared-unique-k-mer matching (both
    orientations, subsampled for speed)."""
    if set(truth) == set(polished):
        return [(n, n) for n in truth]
    t_sets = {
        n: set(_unique_kmers(s, k)[0][::PAIRING_SAMPLE_STRIDE].tolist())
        for n, s in truth.items()
    }
    scores: List[Tuple[int, str, str]] = []
    for pn, ps in polished.items():
        cand = set(_unique_kmers(ps, k)[0][::PAIRING_SAMPLE_STRIDE].tolist())
        cand |= set(
            _unique_kmers(revcomp(ps), k)[0][::PAIRING_SAMPLE_STRIDE].tolist()
        )
        for tn, ts in t_sets.items():
            shared = len(ts & cand)
            if shared:
                scores.append((shared, tn, pn))
    scores.sort(reverse=True)
    pairs: List[Tuple[str, Optional[str]]] = []
    used_t, used_p = set(), set()
    for _, tn, pn in scores:
        if tn in used_t or pn in used_p:
            continue
        pairs.append((tn, pn))
        used_t.add(tn)
        used_p.add(pn)
    for tn in truth:
        if tn not in used_t:
            pairs.append((tn, None))
    return pairs


def assess_fastas(
    truth: Dict[str, bytes],
    polished: Dict[str, bytes],
    *,
    k: int = K,
    collect_errors: bool = False,
) -> AssessResult:
    """Assess every truth contig against its best polished partner.

    Truth contigs with no partner are reported as fully deleted
    (polished assembly simply lacks them); extra polished contigs are
    ignored, matching the per-truth-base rate convention."""
    # no .upper() here: assess_pair normalises case itself, and
    # _kmer_codes (pairing) uppercases internally — doubling the copies
    # of multi-megabase contigs buys nothing
    res = AssessResult()
    for tn, pn in _pair_contigs(truth, polished, k):
        if pn is None:
            res.contigs.append(
                ContigAssessment(
                    truth_name=tn,
                    polished_name=None,
                    truth_len=len(truth[tn]),
                    dele=len(truth[tn]),
                    truth_n=truth[tn].upper().count(b"N"),
                    error_intervals=(
                        [(0, len(truth[tn]), "del", len(truth[tn]))]
                        if collect_errors
                        else None
                    ),
                )
            )
        else:
            res.contigs.append(
                assess_pair(
                    truth[tn],
                    polished[pn],
                    k=k,
                    truth_name=tn,
                    polished_name=pn,
                    collect_errors=collect_errors,
                )
            )
    return res


def format_report(res: AssessResult) -> str:
    """Human-readable table in the shape of roko's published
    comparison (total / mismatch / deletion / insertion / Qscore)."""
    lines = []
    hdr = (
        f"{'contig':<20} {'len':>10} {'err%':>8} {'mis%':>8} "
        f"{'del%':>8} {'ins%':>8} {'Q':>7}"
    )
    lines.append(hdr)
    lines.append("-" * len(hdr))

    def q(c) -> str:
        v = c.qscore
        return "inf" if math.isinf(v) else f"{v:.2f}"

    for c in res.contigs:
        name = c.truth_name + ("(rc)" if c.reverse_complemented else "")
        lines.append(
            f"{name:<20} {c.truth_len:>10} {100 * c.error_rate:>8.4f} "
            f"{100 * c.rate(c.sub):>8.4f} {100 * c.rate(c.dele):>8.4f} "
            f"{100 * c.rate(c.ins):>8.4f} {q(c):>7}"
        )
    s = res.summary()
    lines.append("-" * len(hdr))
    lines.append(
        f"{'TOTAL':<20} {s['truth_len']:>10} {s['total_error_pct']:>8.4f} "
        f"{s['mismatch_pct']:>8.4f} {s['deletion_pct']:>8.4f} "
        f"{s['insertion_pct']:>8.4f} "
        f"{'inf' if s['qscore'] is None else s['qscore']:>7}"
    )
    if s["band_capped_segments"]:
        lines.append(
            f"note: {s['band_capped_segments']} segment(s) hit the band cap; "
            "rates there are upper bounds"
        )
    if s["truth_n_bases"]:
        lines.append(
            f"note: truth contains {s['truth_n_bases']} N base(s); each "
            "aligned N counts as a mismatch (unknown truth, not "
            "necessarily a polishing error)"
        )
    return "\n".join(lines)


def write_bed(res: AssessResult, path: str) -> None:
    """Truth-space error loci as BED: ``contig  start  end  kind  count``
    (0-based half-open). ``sub``/``del`` rows span the affected truth
    bases; an ``ins`` row marks the truth base the extra polished
    sequence precedes ([pos, pos+1), count = inserted bases). Requires
    an AssessResult produced with ``collect_errors=True``."""
    with open(path, "w") as f:
        for c in res.contigs:
            if c.error_intervals is None:
                raise ValueError(
                    f"{c.truth_name}: no error intervals collected — "
                    "assess with collect_errors=True"
                )
            for start, end, kind, count in c.error_intervals:
                if kind == "ins" and end > c.truth_len:
                    # trailing insertion: anchor the row to the last base
                    start, end = max(0, c.truth_len - 1), c.truth_len
                f.write(f"{c.truth_name}\t{start}\t{end}\t{kind}\t{count}\n")


def write_json(res: AssessResult, path: str) -> None:
    doc = {
        "summary": res.summary(),
        "contigs": [
            {
                "truth": c.truth_name,
                "polished": c.polished_name,
                "truth_len": c.truth_len,
                "polished_len": c.polished_len,
                "reverse_complemented": c.reverse_complemented,
                "match": c.match,
                "mismatch": c.sub,
                "deletion": c.dele,
                "insertion": c.ins,
                "anchors": c.anchors,
                "band_capped_segments": c.band_capped_segments,
                "truth_n": c.truth_n,
                "error_rate": c.error_rate,
                "qscore": None if math.isinf(c.qscore) else c.qscore,
            }
            for c in res.contigs
        ],
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
