"""The port's BGZF, BAM and SAM I/O (``roko_tpu_torch/io``) against
``roko_tpu/io`` on the same inputs: BGZF blocks and files byte-equal,
``write_sorted_bam`` output and its ``.bai`` byte-equal, each package's
``BamReader`` reading the other's BAM with equal records and equal region
fetches, and ``SamReader`` parsing to equal records."""

import dataclasses
import random

import pytest

from roko_tpu import sim as jsim
from roko_tpu.io import bam as jbam
from roko_tpu.io import bgzf as jbgzf
from roko_tpu.io import sam as jsam
from roko_tpu_torch.io import bam as pbam
from roko_tpu_torch.io import bgzf as pbgzf
from roko_tpu_torch.io import sam as psam


def _bytes(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _fields(rec):
    return dataclasses.astuple(rec)


def _port_record(rec):
    return pbam.BamRecord(**dataclasses.asdict(rec))


@pytest.mark.parametrize("size,seed", [(0, 0), (17, 1), (65280, 2), (200_000, 3)])
@pytest.mark.parametrize("level", [1, 6])
def test_bgzf_blocks_and_files_byte_equal(tmp_path, size, seed, level):
    rnd = random.Random(seed)
    # half random bytes, half a repeated text: both compress differently
    data = bytes(rnd.randrange(256) for _ in range(size // 2)) + b"ACGT" * (size // 8)
    chunk = data[: pbgzf.MAX_BLOCK_DATA]
    assert pbgzf._compress_block(chunk, level) == jbgzf._compress_block(chunk, level)
    paths = {}
    for name, mod in (("port", pbgzf), ("ref", jbgzf)):
        paths[name] = str(tmp_path / f"{name}.bgzf")
        with mod.BgzfWriter(paths[name], level=level) as w:
            for i in range(0, len(data), 7919):  # writes that straddle blocks
                w.write(data[i : i + 7919])
    assert _bytes(paths["port"]) == _bytes(paths["ref"])
    assert pbgzf.EOF_MARKER == jbgzf.EOF_MARKER
    with pbgzf.BgzfReader(paths["ref"]) as r:
        assert r.read(len(data) + 5) == data


def test_bgzf_virtual_offsets_agree(tmp_path):
    data = bytes(range(256)) * 600  # three blocks
    path = str(tmp_path / "x.bgzf")
    offsets = []
    with jbgzf.BgzfWriter(path) as w:
        for i in range(0, len(data), 10_000):
            offsets.append((w.tell_virtual(), i))
            w.write(data[i : i + 10_000])
    for voff, i in offsets:
        with pbgzf.BgzfReader(path) as r, jbgzf.BgzfReader(path) as j:
            r.seek_virtual(voff)
            j.seek_virtual(voff)
            assert r.read(12_345) == j.read(12_345) == data[i : i + 12_345]
            assert r.tell_virtual() == j.tell_virtual()


def _records(seed: int, n_contigs: int, unmapped: int):
    """Reads of ``n_contigs`` simulated contigs (ref simulator), a few
    unmapped ones, and long reads that span several BAI bins."""
    rnd = random.Random(seed)
    refs, recs = [], []
    for tid in range(n_contigs):
        ref = jsim.random_seq(rnd, rnd.randrange(3000, 40_000))
        refs.append((f"ctg{tid}", len(ref)))
        recs += jsim.simulate_reads(rnd, ref, tid, coverage=4, read_len=rnd.choice((150, 400)))
        start = rnd.randrange(0, len(ref) // 2)
        recs.append(jsim.make_record(f"long{tid}", tid, start, ref[start:],
                                     ((0, len(ref) - start),), mapq=rnd.randrange(60)))
    for i in range(unmapped):
        recs.append(jbam.BamRecord(name=f"u{i}", flag=0x4, tid=-1, pos=-1, mapq=0,
                                   cigar=(), seq="ACGTN"[i % 5] * 9, qual=b"\x1e" * 9))
    rnd.shuffle(recs)
    return refs, recs


@pytest.mark.parametrize("seed,n_contigs,unmapped", [(1, 1, 0), (2, 3, 4), (3, 2, 1)])
def test_write_sorted_bam_and_bai_byte_equal(tmp_path, seed, n_contigs, unmapped):
    refs, recs = _records(seed, n_contigs, unmapped)
    jbam.write_sorted_bam(str(tmp_path / "ref.bam"), refs, recs)
    pbam.write_sorted_bam(str(tmp_path / "port.bam"), refs, [_port_record(r) for r in recs])
    for suffix in (".bam", ".bam.bai"):
        assert _bytes(tmp_path / f"port{suffix}") == _bytes(tmp_path / f"ref{suffix}")


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_bam_readers_read_each_others_files(tmp_path, writer):
    refs, recs = _records(7, 3, 2)
    path = str(tmp_path / f"{writer}.bam")
    if writer == "ref":
        jbam.write_sorted_bam(path, refs, recs)
    else:
        pbam.write_sorted_bam(path, refs, [_port_record(r) for r in recs])
    with pbam.BamReader(path) as p, jbam.BamReader(path) as j:
        assert p.references == j.references == refs
        assert p.header_text == j.header_text
        got = [_fields(r) for r in p]
        assert got == [_fields(r) for r in j]
        assert len(got) == len(recs)
        rnd = random.Random(11)
        for name, length in refs:
            for _ in range(6):
                start = rnd.randrange(0, length)
                end = min(length, start + rnd.choice((1, 500, 20_000)))
                fp = [_fields(r) for r in p.fetch(name, start, end)]
                assert fp == [_fields(r) for r in j.fetch(name, start, end)]
            assert [_fields(r) for r in p.fetch(name)] == [_fields(r) for r in j.fetch(name)]
        with pytest.raises(KeyError):
            list(p.fetch("nope", 0, 10))


def test_bam_record_derived_fields_agree():
    rec = jsim.make_record("r", 0, 100, "ACGTACGTAC", jsim.cigar_from_string("2S3M2I1M4D2M1N1M"))
    port = _port_record(rec)
    assert port.get_aligned_pairs() == rec.get_aligned_pairs()
    assert (port.reference_end, port.reference_length) == (rec.reference_end, rec.reference_length)
    assert pbam.reg2bins(5, 300_000) == jbam.reg2bins(5, 300_000)


_SAM = (
    "@HD\tVN:1.6\tSO:unsorted\n"
    "@SQ\tSN:chr1\tLN:5000\n"
    "@SQ\tSN:chr2\tLN:800\n"
    "@PG\tID:x\n"
    "r1\t0\tchr1\t11\t60\t5M1I4M2D3M\t=\t200\t190\tACGTACGTACGTA\tIIIIIIIIIIIII\t"
    "NM:i:3\tAS:i:-200\tXS:Z:hello world\tBC:B:c,1,-2,3\tXf:f:1.5\tXa:A:q\tXh:H:1AE3\n"
    "r2\t16\tchr2\t1\t3\t3S7M\tchr1\t5\t0\tacgtnACGTA\t*\tXi:i:70000\tXn:i:-40000\n"
    "r3\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\t!!!!\n"
    "r4\t2048\tchr1\t4000\t60\t*\t*\t0\t0\t*\t*\n"
    "\n"
)


def test_sam_reader_parses_equal(tmp_path):
    path = tmp_path / "x.sam"
    path.write_text(_SAM)
    with psam.SamReader(str(path)) as p, jsam.SamReader(str(path)) as j:
        assert p.references == j.references == [("chr1", 5000), ("chr2", 800)]
        assert p.header_text == j.header_text
        got = [_fields(r) for r in p]
        assert got == [_fields(r) for r in j]
        assert len(got) == 4


@pytest.mark.parametrize("line", [
    "r\t0\tchr1\t1\t60\t4M\t*\t0\t0\tACGT\tIII\n",  # SEQ/QUAL lengths differ
    "r\t0\tchrX\t1\t60\t4M\t*\t0\t0\tACGT\tIIII\n",  # RNAME not in @SQ
    "r\t0\tchr1\t1\t60\t4Q\t*\t0\t0\tACGT\tIIII\n",  # bad CIGAR
    "r\t0\tchr1\n",  # too few fields
])
def test_sam_reader_refuses_as_reference(tmp_path, line):
    path = tmp_path / "bad.sam"
    path.write_text("@SQ\tSN:chr1\tLN:100\n" + line)
    for mod in (psam, jsam):
        with mod.SamReader(str(path)) as r, pytest.raises(mod.SamError):
            list(r)
