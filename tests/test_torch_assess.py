"""The port's assess tool (``roko_tpu_torch.eval``, the native aligner's
``align_counts`` binding and ``python -m roko_tpu_torch assess``) against
``roko_tpu``'s on the same inputs: bitwise-equal aligner counts, equal
assessment fields, and byte-equal report, ``--json`` and ``--bed``."""

import dataclasses
import random

import pytest

from roko_tpu.cli import main as ref_main
from roko_tpu.eval import align as ref_align
from roko_tpu.eval import assess as ref_assess
from roko_tpu.native import binding as ref_binding
from roko_tpu_torch import cli
from roko_tpu_torch.eval import align, assess
from roko_tpu_torch.io.fasta import write_fasta
from roko_tpu_torch.native import binding
from tests.test_assess import mutate, rand_seq
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _pairs():
    """The aligner cases of ``tests/test_assess.py``: fixed edits, band
    edges, unrelated pairs and planted mutations, with several pads."""
    yield b"ACGT", b"ACGT", 4
    yield b"ACGT", b"ACTT", 4
    yield b"ACGTACGT", b"ACGACGT", 4
    yield b"ACGACGT", b"ACGTACGT", 4
    yield b"", b"ACG", 4
    yield b"ACG", b"", 4
    edge_a = b"ACGTACGTAC" + b"GGGG" + b"TTCCAGTACG"
    edge_b = b"ACGTACGTAC" + b"TTCCAGTACG"
    yield edge_a, edge_b, 0
    yield edge_a, edge_b, 8
    rng = random.Random(23)
    for _ in range(10):
        yield rand_seq(rng, rng.randrange(1, 60)), rand_seq(rng, rng.randrange(1, 60)), 80
    rng = random.Random(11)
    for _ in range(15):
        a = rand_seq(rng, rng.randrange(1, 400))
        b = (mutate(rng, a, rng.randrange(0, 3), rng.randrange(0, 3), rng.randrange(0, 3),
                    spacing=30) if len(a) > 240 else rand_seq(rng, rng.randrange(1, 400)))
        yield a, b, rng.choice([4, 16, 64])


@pytest.mark.parametrize("case", range(len(list(_pairs()))))
def test_align_counts_bitwise_equal_to_reference_and_oracle(case):
    a, b, pad = list(_pairs())[case]
    got = binding.align_counts(a, b, pad, 10**8)
    oracle = align.banded_align_py(a, b, pad)
    assert got == ref_binding.align_counts(a, b, pad, 10**8)
    assert got == (oracle.match, oracle.sub, oracle.ins, oracle.dele, oracle.hit_band_edge)
    with_ops = align.banded_align_py(a, b, pad, collect_ops=True)
    want = ref_align.banded_align_py(a, b, pad, collect_ops=True)
    assert dataclasses.asdict(with_ops) == dataclasses.asdict(want)
    assert dataclasses.asdict(align.banded_align(a, b, pad)) == dataclasses.asdict(
        ref_align.banded_align(a, b, pad))


def test_align_counts_keeps_the_max_cells_contract():
    with pytest.raises(MemoryError):
        binding.align_counts(b"A" * 1000, b"A" * 1000, 500, 1000)
    with pytest.raises(MemoryError):
        align.banded_align_py(b"A" * 1000, b"A" * 1000, 500, 1000)


def _fields(res):
    return [dataclasses.asdict(c) for c in res.contigs]


def _cases():
    """(truth, polished) FASTA dicts: planted mutations, a reverse
    complement, soft-masked truth, N bases, names that differ, unpaired
    contigs, and an anchor-free tiny pair."""
    rng = random.Random(7)
    t = rand_seq(rng, 20_000)
    yield "planted", {"ctg": t}, {"ctg": mutate(rng, t, n_sub=12, n_ins=5, n_del=8)}
    t = rand_seq(random.Random(5), 10_000)
    yield "revcomp", {"ctg": t}, {"ctg": ref_assess.revcomp(mutate(rng, t, 6, 0, 0))}
    masked = bytearray(rand_seq(random.Random(31), 5_000))
    masked[2000:2600] = bytes(masked[2000:2600]).lower()
    yield "soft_masked", {"ctg": bytes(masked)}, {"ctg": bytes(masked).upper()}
    with_n = bytearray(rand_seq(random.Random(41), 3_000))
    with_n[1000:1005] = b"NNNNN"
    yield "truth_n", {"ctg": bytes(with_n)}, {"ctg": bytes(with_n).replace(b"N", b"A")}
    rng = random.Random(9)
    t1, t2 = rand_seq(rng, 8_000), rand_seq(rng, 6_000)
    yield "renamed", {"chrA": t1, "chrB": t2}, {
        "contig_2": mutate(rng, t2, 3, 1, 1), "contig_1": mutate(rng, t1, 2, 2, 2)}
    rng = random.Random(13)
    t1, t2 = rand_seq(rng, 4_000), rand_seq(rng, 3_000)
    yield "unpaired", {"a": t1, "b": t2}, {"a_polished": mutate(rng, t1, 1, 0, 0)}
    rng = random.Random(3)
    yield "tiny", {"s": rand_seq(rng, 12)}, {"s": rand_seq(rng, 14)}


CASES = {name: (truth, polished) for name, truth, polished in _cases()}


@pytest.mark.parametrize("collect_errors", [False, True], ids=["counts", "errors"])
@pytest.mark.parametrize("name", list(CASES))
def test_assess_fastas_field_equal_to_reference(name, collect_errors):
    truth, polished = CASES[name]
    got = assess.assess_fastas(truth, polished, collect_errors=collect_errors)
    want = ref_assess.assess_fastas(truth, polished, collect_errors=collect_errors)
    assert _fields(got) == _fields(want)
    assert got.summary() == want.summary()
    assert assess.format_report(got) == ref_assess.format_report(want)
    if name == "planted":
        assert (got.contigs[0].sub, got.contigs[0].ins, got.contigs[0].dele) == (12, 5, 8)


def test_merge_error_events_equal_to_reference():
    events = [("del", 10), ("del", 11), ("del", 12), ("sub", 20), ("sub", 22),
              ("ins", 30), ("ins", 30), ("sub", 21), ("ins", 5)]
    assert assess.merge_error_events(events) == ref_assess.merge_error_events(events)


@pytest.mark.parametrize("name", ["planted", "renamed", "unpaired"])
def test_cli_assess_stdout_json_and_bed_byte_equal_to_reference(tmp_path, capsys, name):
    truth, polished = CASES[name]
    tf, pf = tmp_path / "truth.fasta", tmp_path / "polished.fasta"
    write_fasta(str(tf), [(n, s.decode()) for n, s in truth.items()])
    write_fasta(str(pf), [(n, s.decode()) for n, s in polished.items()])
    jf, bf = tmp_path / "r.json", tmp_path / "r.bed"
    argv = ["assess", str(pf), str(tf), "--json", str(jf), "--bed", str(bf)]
    assert ref_main(argv) == 0
    want = capsys.readouterr().out, jf.read_bytes(), bf.read_bytes()
    jf.unlink()
    bf.unlink()
    assert cli.main(argv) == 0
    got = capsys.readouterr().out, jf.read_bytes(), bf.read_bytes()
    assert got == want
    assert "TOTAL" in got[0] and got[2]
