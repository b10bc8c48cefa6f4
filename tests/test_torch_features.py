"""The port's feature extraction (``roko_tpu_torch/features``, ``utils/rng``,
``native``, ``data/hdf5``'s writer) against ``roko_tpu`` on the same
inputs: region seeds, pileup columns, the Python extractor (draft rows
included), the native extractor bitwise equal to the port's Python one and
to ``roko_tpu.native``, labels, and ``run_features`` in inference and
training mode (one and two workers, BAM and SAM input) with every dataset
and attr equal and each package's reader reading the other's file."""

import dataclasses
import random

import h5py
import numpy as np
import pytest

from roko_tpu import config as jconfig
from roko_tpu import constants as JC
from roko_tpu import sim as jsim
from roko_tpu.data import hdf5 as jhdf5
from roko_tpu.features import labels as jlabels
from roko_tpu.features import pipeline as jpipeline
from roko_tpu.features.extract import extract_windows as j_extract
from roko_tpu.features.pileup import pileup_columns as j_pileup
from roko_tpu.io.bam import BamReader as JBamReader
from roko_tpu.io.bam import write_sorted_bam as j_write_sorted_bam
from roko_tpu.native import binding as jnative
from roko_tpu.utils import rng as jrng
from roko_tpu_torch import config as pconfig
from roko_tpu_torch import constants as C
from roko_tpu_torch.data import hdf5 as phdf5
from roko_tpu_torch.features import backend as pbackend
from roko_tpu_torch.features import labels as plabels
from roko_tpu_torch.features import pipeline as ppipeline
from roko_tpu_torch.features.extract import extract_windows as p_extract
from roko_tpu_torch.features.pileup import pileup_columns as p_pileup
from roko_tpu_torch.io.bam import BamReader as PBamReader
from roko_tpu_torch.io.bam import BamRecord as PBamRecord
from roko_tpu_torch.native import binding as pnative
from roko_tpu_torch.native import build as pbuild
from roko_tpu_torch.utils import rng as prng

QUIET = dict(log=lambda *a: None)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """A 6 kb sim project, a copy of its reads with degraded reads (low
    mapq, secondary, duplicate, paired but not proper), and the reads as
    SAM text."""
    root = tmp_path_factory.mktemp("torch_features")
    paths = jsim.build_synthetic_project(str(root / "sim"), genome_len=6000, seed=5)
    with JBamReader(paths["reads_bam"]) as r:
        refs, recs = r.references, list(r)
    flags = (JC.FLAG_SECONDARY, JC.FLAG_DUP, JC.FLAG_PAIRED, JC.FLAG_PAIRED | JC.FLAG_PROPER_PAIR)
    for i, rec in enumerate(recs):
        if i % 6 == 0:
            recs[i] = dataclasses.replace(rec, mapq=3 + i % 9)
        elif i % 6 == 1:
            recs[i] = dataclasses.replace(rec, flag=rec.flag | flags[i % 4])
    degraded = str(root / "degraded.bam")
    j_write_sorted_bam(degraded, refs, recs)
    sam = str(root / "reads.sam")
    with JBamReader(paths["reads_bam"]) as r, open(sam, "w") as fh:
        fh.write(r.header_text)
        for rec in r:
            cigar = "".join(f"{n}{JC.CIGAR_OPS[op]}" for op, n in rec.cigar) or "*"
            qual = "".join(chr(q + 33) for q in rec.qual)
            fh.write(f"{rec.name}\t{rec.flag}\t{refs[rec.tid][0]}\t{rec.pos + 1}\t{rec.mapq}\t"
                     f"{cigar}\t*\t0\t0\t{rec.seq}\t{qual}\n")
    return dict(paths, root=root, degraded=degraded, sam=sam, refs=refs)


# -- constants, config, region seeds -------------------------------------------


@pytest.mark.parametrize("name", [
    "ALPHABET", "ENCODING", "ENCODED_GAP", "ENCODED_UNKNOWN", "STRAND_OFFSET", "REF_ROWS",
    "REGION_SIZE", "REGION_OVERLAP", "MIN_MAPQ", "FLAG_PAIRED", "FLAG_PROPER_PAIR",
    "FLAG_UNMAP", "FLAG_REVERSE", "FLAG_SECONDARY", "FILTER_FLAG", "CHAR_TO_CODE",
    "CIGAR_OPS", "CIGAR_CONSUMES_QUERY", "CIGAR_CONSUMES_REF", "CIGAR_S", "CIGAR_EQ",
])
def test_constants_match_reference(name):
    assert getattr(C, name) == getattr(JC, name)


@pytest.mark.parametrize("cls", ["WindowConfig", "ReadFilterConfig", "RegionConfig"])
def test_feature_config_defaults_match_reference(cls):
    assert dataclasses.asdict(getattr(pconfig, cls)()) == dataclasses.asdict(
        getattr(jconfig, cls)())


def test_features_config_holds_rokoconfig_sections():
    ref, port = jconfig.RokoConfig(), pconfig.FeaturesConfig()
    for section in ("window", "read_filter", "region"):
        assert dataclasses.asdict(getattr(port, section)) == dataclasses.asdict(
            getattr(ref, section))


@pytest.mark.parametrize("block", range(4))
def test_region_seeds_and_stream_match_reference(block):
    rnd = random.Random(block)
    for _ in range(250):
        seed = rnd.choice((0, 1, 2**63 - 1, 2**64 - 1, rnd.getrandbits(64)))
        contig = rnd.choice(("ctg", "chr1", "", "contig_" + str(rnd.getrandbits(20)), "ü"))
        start = rnd.choice((0, 100_000, 2**32 + 7, rnd.getrandbits(40)))
        assert prng.derive_region_seed(seed, contig, start) == jrng.derive_region_seed(
            seed, contig, start)
    a, b = prng.SplitMix64(block), jrng.SplitMix64(block)
    assert [a.next_below(997) for _ in range(500)] == [b.next_below(997) for _ in range(500)]


@pytest.mark.parametrize("length,size,overlap", [
    (1, 100_000, 300), (250_000, 100_000, 300), (10_000, 1000, 100), (3001, 1000, 0)])
def test_generate_regions_match_reference(length, size, overlap):
    got = list(ppipeline.generate_regions(length, "c", pconfig.RegionConfig(size, overlap)))
    want = list(jpipeline.generate_regions(length, "c", jconfig.RegionConfig(size, overlap)))
    assert [tuple(r) for r in got] == [tuple(r) for r in want]


# -- pileup and the Python extractor --------------------------------------------


def _entry(e):
    return (e.read_id, e.qpos, e.is_del, e.is_refskip, e.indel, e.record.name)


@pytest.mark.parametrize("bam", ["reads_bam", "degraded"])
@pytest.mark.parametrize("start,end", [(0, 1500), (2000, 2500), (5900, 7000)])
def test_pileup_columns_match_reference(project, bam, start, end):
    with PBamReader(project[bam]) as p, JBamReader(project[bam]) as j:
        got = [(pos, [_entry(e) for e in es]) for pos, es in p_pileup(p, "ctg", start, end)]
        want = [(pos, [_entry(e) for e in es]) for pos, es in j_pileup(j, "ctg", start, end)]
    assert got == want and got


def _windows_equal(got, want):
    assert len(got) == len(want) and len(got) > 0
    for g, w in zip(got, want):
        assert g.positions.dtype == w.positions.dtype == np.int64
        assert g.matrix.dtype == w.matrix.dtype == np.uint8
        np.testing.assert_array_equal(g.positions, w.positions)
        np.testing.assert_array_equal(g.matrix, w.matrix)


def _cfgs(ref_rows=0, rows=C.WINDOW_ROWS, cols=C.WINDOW_COLS, stride=C.WINDOW_STRIDE,
          min_mapq=C.MIN_MAPQ, proper=True):
    return ((pconfig.WindowConfig(rows, cols, stride, C.MAX_INS, ref_rows),
             pconfig.ReadFilterConfig(min_mapq, C.FILTER_FLAG, proper)),
            (jconfig.WindowConfig(rows, cols, stride, C.MAX_INS, ref_rows),
             jconfig.ReadFilterConfig(min_mapq, C.FILTER_FLAG, proper)))


CASES = {
    "default": dict(bam="reads_bam", start=0, end=6000, seed=3, cfg={}),
    "subregion": dict(bam="reads_bam", start=1234, end=3400, seed=9, cfg={}),
    "degraded": dict(bam="degraded", start=0, end=6000, seed=4, cfg={}),
    "no-proper-pair": dict(bam="degraded", start=0, end=4000, seed=4,
                           cfg=dict(proper=False, min_mapq=0)),
    "ref-rows": dict(bam="reads_bam", start=500, end=4500, seed=2, cfg=dict(ref_rows=3)),
    "geometry": dict(bam="reads_bam", start=0, end=3000, seed=1,
                     cfg=dict(rows=50, cols=30, stride=10)),
}


def _draft(project):
    with open(project["draft_fasta"]) as fh:
        return "".join(line.strip() for line in fh if not line.startswith(">"))


@pytest.mark.parametrize("case", CASES)
def test_python_extractor_matches_reference(project, case):
    c = CASES[case]
    (pw, pf), (jw, jf) = _cfgs(**c["cfg"])
    ref_seq = _draft(project)[c["start"]:] if pw.ref_rows else None
    kw = dict(ref_seq=ref_seq, ref_seq_offset=c["start"])
    with PBamReader(project[c["bam"]]) as p, JBamReader(project[c["bam"]]) as j:
        got = list(p_extract(p, "ctg", c["start"], c["end"], c["seed"], pw, pf, **kw))
        want = list(j_extract(j, "ctg", c["start"], c["end"], c["seed"], jw, jf, **kw))
    _windows_equal(got, want)
    if pw.ref_rows:
        assert (got[0].matrix[: pw.ref_rows] < C.STRAND_OFFSET).all()


# -- the native extractor --------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_native_extractor_bitwise_equal_to_python_and_reference(project, case):
    c = CASES[case]
    (pw, pf), (jw, jf) = _cfgs(**c["cfg"])
    ref_seq = _draft(project)[c["start"]:] if pw.ref_rows else None
    args = (project[c["bam"]], "ctg", c["start"], c["end"], c["seed"])
    kw = dict(ref_seq=ref_seq, ref_seq_offset=c["start"])
    native = pnative.extract_windows(*args, pw, pf, **kw)
    with PBamReader(project[c["bam"]]) as p:
        _windows_equal(native, list(p_extract(p, *args[1:], pw, pf, **kw)))
    _windows_equal(native, jnative.extract_windows(*args, jw, jf, **kw))
    pos, mat = pnative.extract_windows_arrays(*args, pw, pf, **kw)
    assert pos.shape == (len(native), pw.cols, 2) and mat.shape == (len(native), pw.rows, pw.cols)


def test_native_extractor_refuses_like_reference(project):
    with pytest.raises(RuntimeError, match="native extractor failed"):
        pnative.extract_windows(project["reads_bam"], "nope", 0, 100, 1)
    with pytest.raises(ValueError, match="ref_rows"):
        pnative.extract_windows(project["reads_bam"], "ctg", 0, 100, 1,
                                pconfig.WindowConfig(ref_rows=2))
    empty = pnative.extract_windows_arrays(project["reads_bam"], "ctg", 0, 0, 1)
    assert empty[0].shape == (0, C.WINDOW_COLS, 2) and empty[1].shape == (0, C.WINDOW_ROWS,
                                                                            C.WINDOW_COLS)


def test_native_build_compiles_only_port_sources_into_build_dir(tmp_path, monkeypatch):
    root = pbuild.HERE.parent.parent
    lib = pbuild.ensure_built()
    assert lib == pbuild.library_path() and lib.exists()
    assert lib.parent == root / "build" / "roko_tpu_torch"
    assert pnative.load()._name == str(lib)
    cmd = pbuild.compile_command(lib)
    sources = [a for a in cmd if a.endswith(".cc")]
    assert sorted(sources) == sorted(str(p) for p in (root / "roko_tpu_torch/native/src").glob("*.cc"))
    assert cmd[cmd.index("-o") + 1] == str(lib) and cmd[-1] == "-lz"
    assert not list(pbuild.SRC.glob("*.so"))
    # the name follows the sources' bytes, not their times
    copy = tmp_path / "src"
    copy.mkdir()
    for p in pbuild.SRC.iterdir():
        (copy / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(pbuild, "SRC", copy)
    assert pbuild.library_path() == lib
    (copy / "capi.cc").write_bytes((copy / "capi.cc").read_bytes() + b"\n")
    assert pbuild.library_path() != lib


def test_backend_selection(monkeypatch):
    assert pbackend.selected() == "native"
    monkeypatch.setenv("ROKO_TPU_FORCE_PY_EXTRACTOR", "1")
    assert pbackend.selected() == "python"


# -- labels ------------------------------------------------------------------------


def _targets(mod_labels, rec_cls, spans):
    out = []
    for i, (pos, length) in enumerate(spans):
        rec = rec_cls(name=f"t{i}", flag=0, tid=0, pos=pos, mapq=60,
                      cigar=((JC.CIGAR_M, length),), seq="A" * length, qual=b"I" * length)
        out.append(mod_labels.TargetAlign(rec, rec.reference_start, rec.reference_end, True))
    return out


def _aligns(aligns):
    return [(a.align.name, a.start, a.end, a.keep) for a in aligns]


@pytest.mark.parametrize("spans", [
    [(0, 2000), (500, 2000)],  # similar lengths, big overlap: drop both
    [(0, 3000), (2500, 3000)],  # similar lengths, small overlap: split
    [(0, 10000), (1000, 1200)],  # different lengths, big overlap: drop the shorter
    [(0, 10000), (9500, 3000)],  # different lengths, small overlap: clip the later
    [(0, 900), (5000, 4000), (8000, 500), (8500, 9000)],  # min_len and a chain
])
def test_filter_aligns_matches_reference(spans):
    from roko_tpu.io.bam import BamRecord as JBamRecord

    got = plabels.filter_aligns(_targets(plabels, PBamRecord, spans))
    want = jlabels.filter_aligns(_targets(jlabels, JBamRecord, spans))
    assert _aligns(got) == _aligns(want)


@pytest.mark.parametrize("region", [(0, None), (100, 3000), (2999, 3001), (5000, 6000)])
def test_labels_match_reference(project, region):
    start, end = region
    with PBamReader(project["truth_bam"]) as p, JBamReader(project["truth_bam"]) as j:
        got = plabels.get_aligns(p, "ctg", start, end)
        want = jlabels.get_aligns(j, "ctg", start, end)
    assert _aligns(got) == _aligns(want) and got
    got, want = plabels.filter_aligns(got), jlabels.filter_aligns(want)
    assert _aligns(got) == _aligns(want)
    for g, w in zip(got, want):
        r = (plabels.Region("ctg", start, end), jlabels.Region("ctg", start, end))
        assert plabels.get_pos_and_labels(g, r[0]) == jlabels.get_pos_and_labels(w, r[1])


def test_labels_of_insertions_gaps_and_n_match_reference():
    from roko_tpu.io.bam import BamRecord as JBamRecord

    kw = dict(name="t", flag=0, tid=0, pos=10, mapq=60,
              cigar=((JC.CIGAR_S, 2), (JC.CIGAR_M, 3), (JC.CIGAR_I, 2), (JC.CIGAR_M, 2),
                     (JC.CIGAR_D, 3), (JC.CIGAR_M, 4)),
              seq="TTACNGTacRTGA", qual=b"I" * 13)
    got = plabels.TargetAlign(PBamRecord(**kw), 10, 22, True)
    want = jlabels.TargetAlign(JBamRecord(**kw), 10, 22, True)
    for s, e in ((0, None), (11, 17), (12, 13)):
        assert plabels.get_pos_and_labels(got, plabels.Region("ctg", s, e)) == \
            jlabels.get_pos_and_labels(want, jlabels.Region("ctg", s, e))


# -- run_features ------------------------------------------------------------------


def _dump(path):
    """Every group's datasets (values, dtype, chunks) and attrs."""
    out = {}
    with h5py.File(path, "r") as fd:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = (obj[()], obj.dtype, obj.chunks)
            else:
                out[name] = {k: (v.item() if hasattr(v, "item") else v)
                             for k, v in obj.attrs.items()}
        fd.visititems(visit)
    return out


def _assert_same_file(got_path, want_path):
    got, want = _dump(got_path), _dump(want_path)
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            assert g == w, k
        else:
            np.testing.assert_array_equal(g[0], w[0])
            assert g[1:] == w[1:], k


@pytest.mark.parametrize("mode,workers,reads", [
    ("infer", 1, "reads_bam"), ("infer", 2, "reads_bam"), ("infer", 1, "sam"),
    ("train", 1, "reads_bam"), ("train", 2, "sam"),
])
def test_run_features_matches_reference(project, tmp_path, mode, workers, reads):
    bam_y = project["truth_bam"] if mode == "train" else None
    # regions of 2 kb: several region jobs, and more than one flush
    pcfg = pconfig.FeaturesConfig(region=pconfig.RegionConfig(2000, 300))
    jcfg = jconfig.RokoConfig(region=jconfig.RegionConfig(2000, 300))
    got, want = str(tmp_path / "port.hdf5"), str(tmp_path / "ref.hdf5")
    n = ppipeline.run_features(project["draft_fasta"], project[reads], got, bam_y=bam_y,
                               workers=workers, seed=8, config=pcfg, flush_every=2, **QUIET)
    m = jpipeline.run_features(project["draft_fasta"], project[reads], want, bam_y=bam_y,
                               workers=workers, seed=8, config=jcfg, flush_every=2, **QUIET)
    assert n == m > 100
    _assert_same_file(got, want)

    # each package's reader reads the other's file
    if mode == "infer":
        for reader in (phdf5.iter_inference_windows, jhdf5.iter_inference_windows):
            a, b = list(reader(got, 64)), list(reader(want, 64))
            assert len(a) == len(b) == -(-n // 64)
            for x, y in zip(a, b):
                assert list(x[0]) == list(y[0])
                np.testing.assert_array_equal(x[1], y[1])
                np.testing.assert_array_equal(x[2], y[2])
        assert phdf5.load_contigs(want) == jhdf5.load_contigs(got) == phdf5.load_contigs(got)
    else:
        xs, ys = jhdf5.load_training_arrays(got)
        np.testing.assert_array_equal(xs, jhdf5.load_training_arrays(want)[0])
        np.testing.assert_array_equal(ys, jhdf5.load_training_arrays(want)[1])
        groups = list(phdf5.read_training_groups(want))
        np.testing.assert_array_equal(np.concatenate([g[1] for g in groups]), xs)
        np.testing.assert_array_equal(np.concatenate([g[2] for g in groups]), ys)


def test_region_stream_matches_reference(project):
    with ppipeline.open_region_stream(project["draft_fasta"], project["reads_bam"], workers=2,
                                      seed=1, **QUIET) as p, \
            jpipeline.open_region_stream(project["draft_fasta"], project["reads_bam"],
                                         workers=2, seed=1, **QUIET) as j:
        assert p.refs == j.refs and p.region_counts == j.region_counts
        for a, b in zip(p.results, j.results):
            assert a[0] == b[0]
            for x, y in zip(a[1:], b[1:]):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("url", ["gs://bucket/reads.bam", "s3://b/r.bam", "https://h/r.bam"])
def test_remote_inputs_refused(project, tmp_path, url):
    """A store URL of the reads is no longer refused: it downloads (with
    its ``.bai``) through the object-store client, and the features equal
    those of the local file. The stub store serves ``gs://`` and ``s3://``
    through its endpoint, and ``https://h`` through a transport that
    sends that host's requests to the stub."""
    from roko_tpu_torch.datapipe import io as dio
    from roko_tpu_torch.datapipe import store

    key = url.split("://", 1)[1].split("/", 1)[1] if url.startswith("https") else \
        url.split("://", 1)[1]
    bucket = tmp_path / "bucket"
    (bucket / key).parent.mkdir(parents=True, exist_ok=True)
    for suffix in ("", ".bai"):
        (bucket / (key + suffix)).write_bytes(open(project["reads_bam"] + suffix, "rb").read())
    srv = store.StubObjectStore(str(bucket)).start()

    def transport(method, target, headers, body, timeout):
        return store.http_transport(method, target.replace("https://h", srv.url), headers,
                                    body, timeout)

    saved = store._default_store, dict(dio._OPENERS), dict(dio._WRITERS)
    store.install(store.ObjectStore(timeout_s=5.0, endpoint=srv.url, transport=transport,
                                    cache_dir=str(tmp_path / "cache")))
    try:
        n = ppipeline.run_features(project["draft_fasta"], url, str(tmp_path / "o.hdf5"),
                                   seed=3, **QUIET)
    finally:
        srv.shutdown()
        srv.server_close()
        store._default_store = saved[0]
        for registry, old in ((dio._OPENERS, saved[1]), (dio._WRITERS, saved[2])):
            registry.clear()
            registry.update(old)
    m = ppipeline.run_features(project["draft_fasta"], project["reads_bam"],
                               str(tmp_path / "local.hdf5"), seed=3, **QUIET)
    assert n == m > 100
    _assert_same_file(str(tmp_path / "o.hdf5"), str(tmp_path / "local.hdf5"))
