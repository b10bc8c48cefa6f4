"""Synthetic-data simulation: genomes, noisy reads with exact
alignments, and draft derivation with known truth CIGARs.

roko itself has no counterpart (it assumes external assemblers and
aligners). This is the port's copy of ``roko_tpu/sim.py``: the same
``random.Random`` calls in the same order, so a seed gives byte-identical
projects in both packages. The tests and ``chip_smoke.py`` drive the real
pipeline over data built here, with no samtools, pysam or aligner.

Key property: reads are simulated WITH their exact alignments (errors
are introduced together with matching CIGAR ops), and a draft derived
from a truth genome carries the exact truth-to-draft CIGAR — so
self-consistent BAMs exist without running an aligner, and labels are
exact by construction (`compose_read_to_draft` re-maps truth-space
reads onto the draft the way pomoxis mini_align would align them).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

from roko_tpu_torch import constants as C
from roko_tpu_torch.io.bam import BamRecord

BASES = "ACGT"

# Effective per-position indel rates are capped here no matter how long
# the homopolymer run: beyond ~0.4 a simulated read decays into gap
# soup that no longer resembles a sequencing error profile.
_HP_RATE_CAP = 0.4


def random_seq(rng: random.Random, n: int) -> str:
    return "".join(rng.choice(BASES) for _ in range(n))


def random_genome(rng: random.Random, n: int, hp_extend: float = 0.0) -> str:
    """Random genome with geometric homopolymer run lengths: each base
    repeats with probability ``hp_extend`` per extra copy (0 = i.i.d.
    bases, which almost never produces the >=5-base runs real genomes
    carry). ``hp_extend=0.45`` gives mean run ~1.8 with runs of 8+
    appearing at genome scale — the substrate the homopolymer error
    model (``hp_indel_bias``) needs to be adversarial."""
    if hp_extend <= 0.0:
        return random_seq(rng, n)
    out: List[str] = []
    while len(out) < n:
        b = rng.choice(BASES)
        if out and out[-1] == b:  # runs are shaped by hp_extend alone
            continue
        out.append(b)
        while len(out) < n and rng.random() < hp_extend:
            out.append(b)
    return "".join(out)


def _run_lengths(seq: str) -> List[int]:
    """run[i] = length of the homopolymer run containing position i."""
    n = len(seq)
    out = [1] * n
    i = 0
    while i < n:
        j = i
        while j < n and seq[j] == seq[i]:
            j += 1
        for k in range(i, j):
            out[k] = j - i
        i = j
    return out


def _hp_factor(run_len: int, bias: float) -> float:
    return 1.0 + bias * (run_len - 1)


def mutate(
    rng: random.Random,
    seq: str,
    sub_rate: float = 0.0,
    ins_rate: float = 0.0,
    del_rate: float = 0.0,
    max_indel: int = 3,
) -> str:
    """Apply random substitutions/insertions/deletions — used to derive a
    'draft' from a 'truth' genome or noisy reads from a template."""
    out = []
    i = 0
    while i < len(seq):
        r = rng.random()
        if r < del_rate:
            i += rng.randint(1, max_indel)
            continue
        b = seq[i]
        if r < del_rate + sub_rate:
            b = rng.choice([x for x in BASES if x != seq[i]])
        out.append(b)
        if rng.random() < ins_rate:
            out.append(random_seq(rng, rng.randint(1, max_indel)))
        i += 1
    return "".join(out)


def align_to_ref(query: str, ref: str, ref_start: int) -> Tuple[int, Tuple[Tuple[int, int], ...]]:
    """Trivial gapless alignment helper: full-length M at ref_start."""
    return ref_start, ((C.CIGAR_M, len(query)),)


def make_record(
    name: str,
    tid: int,
    pos: int,
    seq: str,
    cigar: Sequence[Tuple[int, int]],
    flag: int = 0,
    mapq: int = 60,
) -> BamRecord:
    return BamRecord(
        name=name,
        flag=flag,
        tid=tid,
        pos=pos,
        mapq=mapq,
        cigar=tuple(cigar),
        seq=seq,
        qual=b"I" * len(seq),
    )


def cigar_from_string(s: str) -> Tuple[Tuple[int, int], ...]:
    """Parse '5M2I3M' into ((M,5),(I,2),(M,3))."""
    out: List[Tuple[int, int]] = []
    num = ""
    for ch in s:
        if ch.isdigit():
            num += ch
        else:
            out.append((C.CIGAR_OPS.index(ch), int(num)))
            num = ""
    return tuple(out)


def query_len_for_cigar(cigar: Sequence[Tuple[int, int]]) -> int:
    return sum(l for op, l in cigar if C.CIGAR_CONSUMES_QUERY[op])


def simulate_reads(
    rng: random.Random,
    ref: str,
    tid: int,
    coverage: int = 30,
    read_len: int = 200,
    sub_rate: float = 0.02,
    ins_rate: float = 0.01,
    del_rate: float = 0.01,
    hp_indel_bias: float = 0.0,
) -> List[BamRecord]:
    """Simulate noisy reads from `ref` with known (exact) alignments: errors
    are introduced with matching CIGAR ops, so the BAM is self-consistent
    without needing an aligner.

    ``hp_indel_bias`` turns on the homopolymer error mode (nanopore's
    dominant error class, which the uniform model underrepresents): at a
    position inside a run of length L the indel rates scale by
    ``1 + bias*(L-1)`` (capped), and biased
    insertions EXTEND the run (same base) instead of drawing a random
    one — reproducing the run-length ambiguity that makes consensus
    polishing hard."""
    n_reads = max(1, coverage * len(ref) // read_len)
    runs = _run_lengths(ref) if hp_indel_bias > 0 else None
    records = []
    for ridx in range(n_reads):
        start = rng.randrange(0, max(1, len(ref) - read_len))
        end = min(len(ref), start + read_len)
        seq_parts: List[str] = []
        cigar: List[Tuple[int, int]] = []

        def push(op: int, length: int):
            if length <= 0:
                return
            if cigar and cigar[-1][0] == op:
                cigar[-1] = (op, cigar[-1][1] + length)
            else:
                cigar.append((op, length))

        i = start
        while i < end:
            if runs is not None:
                f = _hp_factor(runs[i], hp_indel_bias)
                del_i = min(_HP_RATE_CAP, del_rate * f)
                ins_i = min(_HP_RATE_CAP, ins_rate * f)
            else:
                del_i, ins_i = del_rate, ins_rate
            r = rng.random()
            if r < del_i and i > start:
                d = rng.randint(1, 2)
                d = min(d, end - i)
                push(C.CIGAR_D, d)
                i += d
                continue
            b = ref[i]
            if r < del_i + sub_rate:
                b = rng.choice([x for x in BASES if x != ref[i]])
            seq_parts.append(b)
            push(C.CIGAR_M, 1)
            if rng.random() < ins_i:
                if runs is not None and runs[i] > 1:
                    ins = ref[i] * rng.randint(1, 2)  # run extension
                else:
                    ins = random_seq(rng, rng.randint(1, 2))
                seq_parts.append(ins)
                push(C.CIGAR_I, len(ins))
            i += 1
        seq = "".join(seq_parts)
        if not seq:
            continue
        flag = C.FLAG_REVERSE if rng.random() < 0.5 else 0
        records.append(
            make_record(f"read{ridx}", tid, start, seq, cigar, flag=flag, mapq=60)
        )
    return records


def mutate_with_cigar(
    rng: random.Random,
    truth: str,
    sub_rate: float = 0.0,
    ins_rate: float = 0.0,
    del_rate: float = 0.0,
    max_indel: int = 2,
    hp_indel_bias: float = 0.0,
) -> Tuple[str, Tuple[Tuple[int, int], ...]]:
    """Derive a 'draft' from ``truth`` and return the exact truth-to-draft
    alignment CIGAR (query = truth, reference = draft).

    Op mapping from the edit script: a substitution stays M; dropping a
    truth base from the draft means truth has a base the draft lacks -> I
    (query-only); extra bases inserted into the draft -> D (ref-only).
    ``hp_indel_bias`` applies the homopolymer error mode (see
    :func:`simulate_reads`) — assembler drafts inherit the read error
    profile, so draft errors concentrate in runs too.
    """
    out: List[str] = []
    cigar: List[Tuple[int, int]] = []
    runs = _run_lengths(truth) if hp_indel_bias > 0 else None

    def push(op: int, length: int = 1):
        if length <= 0:
            return
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + length)
        else:
            cigar.append((op, length))

    for i, ch in enumerate(truth):
        if runs is not None:
            f = _hp_factor(runs[i], hp_indel_bias)
            del_i = min(_HP_RATE_CAP, del_rate * f)
            ins_i = min(_HP_RATE_CAP, ins_rate * f)
        else:
            del_i, ins_i = del_rate, ins_rate
        r = rng.random()
        if r < del_i:  # draft lacks this truth base
            push(C.CIGAR_I)
            continue
        b = ch
        if r < del_i + sub_rate:
            b = rng.choice([x for x in BASES if x != ch])
        out.append(b)
        push(C.CIGAR_M)
        if rng.random() < ins_i:  # draft gains extra bases
            if runs is not None and runs[i] > 1:
                ins = ch * rng.randint(1, max_indel)  # run extension
            else:
                ins = random_seq(rng, rng.randint(1, max_indel))
            out.append(ins)
            push(C.CIGAR_D, len(ins))
    return "".join(out), tuple(cigar)


def truth_to_draft_map(cigar: Sequence[Tuple[int, int]]) -> List[int]:
    """Per truth position, the draft position it aligns to, or -1 for
    truth-only bases (I ops). CIGAR orientation as mutate_with_cigar."""
    t2d: List[int] = []
    d = 0
    for op, length in cigar:
        if op == C.CIGAR_M:
            for _ in range(length):
                t2d.append(d)
                d += 1
        elif op == C.CIGAR_I:  # truth-only
            t2d.extend([-1] * length)
        elif op == C.CIGAR_D:  # draft-only
            d += length
    return t2d


def compose_read_to_draft(
    read_pos_t: int,
    read_cigar: Sequence[Tuple[int, int]],
    t2d: Sequence[int],
) -> Optional[Tuple[int, Tuple[Tuple[int, int], ...]]]:
    """Re-map a read aligned to truth (at ``read_pos_t`` with
    ``read_cigar``) onto the draft via the truth->draft map.

    Returns (draft_pos, cigar) or None when the read never touches a
    mapped draft base. Leading/trailing query bases that end up unmapped
    become soft clips; draft-only bases inside the span become D.
    """
    events: List[Tuple[int, int]] = []  # (op, length) pre-merge

    def push(op: int, length: int = 1):
        if length <= 0:
            return
        if events and events[-1][0] == op:
            events[-1] = (op, events[-1][1] + length)
        else:
            events.append((op, length))

    t = read_pos_t
    start_d = None
    last_d = None

    def advance_draft(to_d: int):
        nonlocal last_d
        if last_d is not None and to_d > last_d + 1:
            push(C.CIGAR_D, to_d - last_d - 1)  # draft-only bases between
        last_d = to_d

    for op, length in read_cigar:
        if op in (C.CIGAR_M, C.CIGAR_EQ, C.CIGAR_X):
            for _ in range(length):
                d = t2d[t] if t < len(t2d) else -1
                if d < 0:
                    push(C.CIGAR_I)  # aligned to a truth-only base
                else:
                    if start_d is None:
                        start_d = d
                    advance_draft(d)
                    push(C.CIGAR_M)
                t += 1
        elif op == C.CIGAR_I:
            push(C.CIGAR_I, length)
        elif op == C.CIGAR_D:
            for _ in range(length):
                d = t2d[t] if t < len(t2d) else -1
                if d >= 0:
                    if start_d is None:
                        # deletion before any aligned base: skip, the
                        # alignment will start at the next M
                        pass
                    else:
                        advance_draft(d)
                        push(C.CIGAR_D)
                t += 1
        elif op == C.CIGAR_S:
            push(C.CIGAR_S, length)

    if start_d is None:
        return None
    # leading I (query bases before the first draft-aligned base) -> S
    out: List[Tuple[int, int]] = []
    for i, (op, length) in enumerate(events):
        if op == C.CIGAR_M:
            out.extend(events[i:])
            break
        if op in (C.CIGAR_I, C.CIGAR_S):
            out.append((C.CIGAR_S, length))
        # leading D: drop
    # trailing I/D/S run -> one S (I and S carry query bases with nowhere
    # left to align; D's are dropped — keeping one would strand a
    # deletion next to the clip, e.g. '...M D S', which SAM forbids and
    # the pileup would misread as a spurious deletion column)
    trailing_s = 0
    while out and out[-1][0] in (C.CIGAR_I, C.CIGAR_D, C.CIGAR_S):
        op, length = out.pop()
        if op != C.CIGAR_D:
            trailing_s += length
    if trailing_s:
        out.append((C.CIGAR_S, trailing_s))
    # merge any S+S introduced above
    merged: List[Tuple[int, int]] = []
    for op, length in out:
        if merged and merged[-1][0] == op:
            merged[-1] = (op, merged[-1][1] + length)
        else:
            merged.append((op, length))
    return start_d, tuple(merged)


def build_synthetic_project(
    out_dir: str,
    *,
    seed: int = 7,
    genome_len: int = 10_000,
    contig: str = "ctg",
    coverage: int = 30,
    read_len: int = 400,
    draft_sub: float = 0.005,
    draft_ins: float = 0.003,
    draft_del: float = 0.003,
    read_sub: float = 0.02,
    read_ins: float = 0.01,
    read_del: float = 0.01,
    hp_indel_bias: float = 0.0,
    hp_extend: float = 0.0,
) -> Dict[str, str]:
    """Write a complete synthetic polishing project into ``out_dir``:

    - ``truth.fasta``   — the ground-truth genome
    - ``draft.fasta``   — an error-bearing draft derived from it
    - ``reads.bam(.bai)`` — noisy truth-space reads re-mapped onto the
      draft via exact CIGAR composition (what an aligner would produce)
    - ``truth.bam(.bai)`` — the truth-to-draft alignment for training
      labels

    Returns a dict of the file paths plus the contig name.

    ``hp_indel_bias`` + ``hp_extend`` switch the project to the
    homopolymer error regime: a run-rich truth genome
    (:func:`random_genome`) with indels concentrated in runs in both
    the draft and the reads — the adversarial proxy for real nanopore
    data.
    """
    import os

    from roko_tpu_torch.io.bam import write_sorted_bam
    from roko_tpu_torch.io.fasta import write_fasta

    rng = random.Random(seed)
    truth = random_genome(rng, genome_len, hp_extend)
    draft, cig = mutate_with_cigar(
        rng, truth, sub_rate=draft_sub, ins_rate=draft_ins, del_rate=draft_del,
        hp_indel_bias=hp_indel_bias,
    )
    t2d = truth_to_draft_map(cig)
    reads_t = simulate_reads(
        rng, truth, 0, coverage=coverage, read_len=read_len,
        sub_rate=read_sub, ins_rate=read_ins, del_rate=read_del,
        hp_indel_bias=hp_indel_bias,
    )
    reads_d = []
    for r in reads_t:
        res = compose_read_to_draft(r.pos, r.cigar, t2d)
        if res is None:
            continue
        pos_d, cigar_d = res
        reads_d.append(
            make_record(r.name, 0, pos_d, r.seq, cigar_d, flag=r.flag, mapq=60)
        )

    os.makedirs(out_dir, exist_ok=True)
    paths = {
        "truth_fasta": os.path.join(out_dir, "truth.fasta"),
        "draft_fasta": os.path.join(out_dir, "draft.fasta"),
        "reads_bam": os.path.join(out_dir, "reads.bam"),
        "truth_bam": os.path.join(out_dir, "truth.bam"),
        "contig": contig,
    }
    write_fasta(paths["truth_fasta"], [(contig, truth)])
    write_fasta(paths["draft_fasta"], [(contig, draft)])
    refs = [(contig, len(draft))]
    write_sorted_bam(paths["reads_bam"], refs, reads_d)
    write_sorted_bam(
        paths["truth_bam"], refs, [make_record("truth", 0, 0, truth, cig)]
    )
    return paths
