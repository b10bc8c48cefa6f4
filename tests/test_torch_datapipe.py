"""The port's data plane (``roko_tpu_torch/datapipe``) against
``roko_tpu.datapipe`` on the same files and seeds: file-set resolution,
the manifest and its sidecar (interchangeable both ways), the refusals of
a pinned manifest, each shard's stream batch for batch for several shard
counts, seeds and block/mix sizes, the shard properties (partition,
equalised steps, fast-forward with its read count, preload against
streaming, the checkpointable iterator, the holdout), the prefetch, and
the opener seam. The mirror of ``tests/test_datapipe.py``."""

import json
import os

import numpy as np
import pytest

from roko_tpu import constants as JC
from roko_tpu.data.hdf5 import hdf5_files as ref_hdf5_files
from roko_tpu.datapipe import CheckpointableIterator as RefIterator
from roko_tpu.datapipe import ReadStats as RefReadStats
from roko_tpu.datapipe import ShardedDataset as RefSharded
from roko_tpu.datapipe import build_manifest as ref_build_manifest
from roko_tpu.datapipe import load_or_build_manifest as ref_load_or_build
from roko_tpu.datapipe import resolve_file_set as ref_resolve
from roko_tpu.datapipe.manifest import Manifest as RefManifest
from roko_tpu_torch.data.hdf5 import DataWriter, hdf5_files
from roko_tpu_torch.datapipe import (
    MANIFEST_BASENAME,
    CheckpointableIterator,
    Manifest,
    ManifestMismatch,
    ReadStats,
    crosscheck_fingerprint,
    ShardedDataset,
    build_manifest,
    load_or_build_manifest,
    resolve_file_set,
)
from roko_tpu_torch.datapipe import engine, io
from roko_tpu_torch.training.data import InMemoryDataset
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROWS, COLS = 4, 6  # the stream does not care about the window's shape


def _write_file(path, rng, n, tag):
    X = rng.integers(0, JC.FEATURE_VOCAB, (n, ROWS, COLS)).astype(np.uint8)
    Y = (X.sum(axis=1) % JC.NUM_CLASSES).astype(np.int64)
    pos = [np.stack([np.arange(COLS), np.zeros(COLS)], 1)] * n
    with DataWriter(str(path), infer=False) as w:
        w.write_contigs([(tag, "ACGT" * 10)])
        w.store(tag, pos, list(X), list(Y))
    return X, Y


def _corpus(tmp_path, seed=0, sizes=(40, 56, 24)):
    rng = np.random.default_rng(seed)
    d = tmp_path / "corpus"
    d.mkdir(exist_ok=True)
    for i, n in enumerate(sizes):
        _write_file(d / f"part{i}.hdf5", rng, n, f"c{i}")
    return str(d)


def _rows(ds, epoch, bs, **kw):
    """Real rows of one epoch stream, as bytes."""
    out = []
    for x, _y, w in ds.batches(bs, rng=ds.epoch_rng(epoch), pad_to=bs, **kw):
        out.extend(r.tobytes() for r in x[: int(w.sum())])
    return out


def _assert_same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for (gx, gy, gw), (wx, wy, ww) in zip(got, want):
        for g, r in ((gx, wx), (gy, wy), (gw, ww)):
            assert g.dtype == r.dtype and g.shape == r.shape and np.array_equal(g, r)


# -- the file set ------------------------------------------------------------

def test_hdf5_files_sorts_by_basename_and_dedupes_symlinks(tmp_path):
    rng = np.random.default_rng(1)
    d = tmp_path / "d"
    d.mkdir()
    for name in ("b.hdf5", "a.hdf5", "c.h5"):
        _write_file(d / name, rng, 8, name.split(".")[0])
    os.symlink(d / "a.hdf5", d / "zz-alias.hdf5")
    (d / "notes.txt").write_text("ignored")
    got = hdf5_files(str(d))
    assert [os.path.basename(f) for f in got] == ["a.hdf5", "b.hdf5", "c.h5"]
    assert got == ref_hdf5_files(str(d))


def test_resolve_file_set_globs_lists_and_errors(tmp_path):
    d = _corpus(tmp_path)
    for spec in (d, [os.path.join(d, "part*.hdf5")], [os.path.join(d, "part1.hdf5"), d]):
        assert resolve_file_set(spec) == ref_resolve(spec)
    assert [os.path.basename(p) for p in resolve_file_set([os.path.join(d, "part1.hdf5"), d])] \
        == ["part0.hdf5", "part1.hdf5", "part2.hdf5"]
    with pytest.raises(Exception, match="no HDF5 inputs"):
        resolve_file_set(os.path.join(d, "nope*.hdf5"))


# -- the manifest --------------------------------------------------------------

def test_manifest_roundtrip_and_fingerprint_match_reference(tmp_path):
    d = _corpus(tmp_path)
    m1, paths = build_manifest(d, block_size=16)
    r1, rpaths = ref_build_manifest(d, block_size=16)
    assert paths == rpaths
    assert m1.to_dict() == r1.to_dict() and m1.fingerprint == r1.fingerprint
    m1.save(str(tmp_path / "m.json"))
    assert Manifest.load(str(tmp_path / "m.json")) == m1
    assert m1.total_rows == 120
    assert [(s.file_idx, s.group, s.start, s.count) for s in m1.spans()] == [
        (s.file_idx, s.group, s.start, s.count) for s in r1.spans()]
    assert build_manifest(d, block_size=32)[0].fingerprint == m1.fingerprint


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_sidecar_is_interchangeable(tmp_path, writer):
    """The sidecar one package writes beside the corpus loads in the
    other without a rebuild, with the same fingerprint, and the bytes of
    the two packages' sidecars are equal."""
    d = _corpus(tmp_path)
    sidecar = os.path.join(d, MANIFEST_BASENAME)
    first, second = ((load_or_build_manifest, ref_load_or_build) if writer == "port"
                     else (ref_load_or_build, load_or_build_manifest))
    m1, _ = first(d, block_size=16)
    written = open(sidecar, "rb").read()
    logs = []
    m2, _ = second(d, block_size=16, log=logs.append)
    assert not logs  # loaded, not rebuilt
    assert m2.fingerprint == m1.fingerprint
    assert open(sidecar, "rb").read() == written
    # the other package writes the same bytes
    os.remove(sidecar)
    second(d, block_size=16)
    assert open(sidecar, "rb").read() == written
    # a single file's sidecar sits beside it
    one = os.path.join(d, "part1.hdf5")
    first(one)
    assert os.path.exists(one + ".manifest.json")
    assert second(one, log=logs.append)[0].fingerprint == first(one)[0].fingerprint and not logs


def test_pinned_manifest_refuses_mutated_file(tmp_path):
    d = _corpus(tmp_path)
    m, _ = build_manifest(d)
    mpath = str(tmp_path / "pinned.json")
    m.save(mpath)
    ShardedDataset(d, manifest_path=mpath)
    victim = os.path.join(d, "part1.hdf5")
    with open(victim, "r+b") as f:
        f.seek(os.path.getsize(victim) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(ManifestMismatch, match="part1.hdf5"):
        ShardedDataset(d, manifest_path=mpath)
    with pytest.raises(Exception, match="part1.hdf5"):  # the reference refuses it too
        RefSharded(d, manifest_path=mpath)


def test_manifest_diff_names_missing_and_extra(tmp_path):
    d = _corpus(tmp_path)
    m, _ = build_manifest(d)
    os.unlink(os.path.join(d, "part0.hdf5"))
    _write_file(tmp_path / "corpus" / "part9.hdf5", np.random.default_rng(2), 8, "c9")
    with pytest.raises(ManifestMismatch) as ei:
        m.verify_files(resolve_file_set(d))
    msg = str(ei.value)
    assert "missing: part0.hdf5" in msg and "extra: part9.hdf5" in msg
    with pytest.raises(Exception) as ej:
        RefManifest.from_dict(m.to_dict()).verify_files(ref_resolve(d))
    assert str(ej.value) == msg


def test_fingerprint_crosscheck_is_a_no_op_in_one_process(tmp_path):
    """Without a process group there is nothing to compare; the check
    across processes is ``tests/test_torch_multiprocess.py``'s."""
    from roko_tpu_torch.datapipe.manifest import crosscheck_corpus, fingerprint32_pair
    from roko_tpu_torch.parallel import distributed

    m, _ = build_manifest(_corpus(tmp_path))
    assert not distributed.is_initialized()
    crosscheck_fingerprint(m)
    crosscheck_corpus("0" * 64, 1, 0, "nothing")
    assert fingerprint32_pair(m.fingerprint) == RefManifest.from_dict(
        m.to_dict()).fingerprint32_pair()


def test_stale_sidecar_manifest_rebuilds_loudly(tmp_path):
    d = _corpus(tmp_path)
    m1, _ = load_or_build_manifest(d, log=lambda s: None)
    _write_file(tmp_path / "corpus" / "part2.hdf5", np.random.default_rng(3), 30, "c2new")
    logs = []
    m2, _ = load_or_build_manifest(d, log=logs.append)
    assert m2.fingerprint != m1.fingerprint and any("stale" in line for line in logs)
    assert m2.fingerprint == ref_load_or_build(d)[0].fingerprint
    sidecar = os.path.join(d, MANIFEST_BASENAME)
    with open(sidecar, "w") as f:
        f.write("{not json")
    logs = []
    assert load_or_build_manifest(d, log=logs.append)[0].fingerprint == m2.fingerprint
    assert any("unreadable" in line for line in logs)
    with open(sidecar, "w") as f:
        f.write("{not json")
    with pytest.raises(Exception, match="unreadable manifest"):
        load_or_build_manifest(d, manifest_path=sidecar)


# -- the streams ---------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _corpus(tmp_path_factory.mktemp("torch_datapipe"), seed=4, sizes=(100, 150, 70))


@pytest.mark.parametrize("block,mix", [(16, 2), (32, 8)])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("num_shards", [1, 2, 3])
def test_each_shard_stream_matches_reference(corpus, num_shards, seed, block, mix):
    """Every shard's batches (x, y, w), two epochs, equalised and padded as
    the train loop reads them, and unpadded, are the reference's."""
    for shard in range(num_shards):
        kw = dict(num_shards=num_shards, shard_id=shard, seed=seed, block_size=block,
                  mix_blocks=mix)
        port, ref = ShardedDataset(corpus, **kw), RefSharded(corpus, **kw)
        assert (len(port), port.local_rows(), port.num_blocks) == (
            len(ref), ref.local_rows(), ref.num_blocks)
        assert port.steps_per_epoch(8) == ref.steps_per_epoch(8)
        for epoch in (0, 1):
            _assert_same_batches(port.iterator(epoch, 8, pad_to=8),
                                 ref.iterator(epoch, 8, pad_to=8))
        _assert_same_batches(port.batches(8, rng=port.epoch_rng(2)),
                             ref.batches(8, rng=ref.epoch_rng(2)))


@pytest.mark.parametrize("num_shards", [2, 3])
def test_shard_union_partitions_global_stream(corpus, num_shards):
    glob = _rows(ShardedDataset(corpus, seed=11, block_size=16), 2, 8)
    assert len(glob) == 320
    shard_rows = [_rows(ShardedDataset(corpus, seed=11, block_size=16, num_shards=num_shards,
                                       shard_id=s), 2, 8, equalize=False)
                  for s in range(num_shards)]
    union = sum(shard_rows, [])
    assert sorted(union) == sorted(glob) and len(set(union)) == len(union)


def test_equalized_steps_across_unbalanced_shards(tmp_path):
    d = tmp_path / "uneven"
    d.mkdir()
    _write_file(d / "a.hdf5", np.random.default_rng(5), 48, "a")  # 3 blocks of 16
    for s in (0, 1):
        port = ShardedDataset(str(d), seed=0, block_size=16, num_shards=2, shard_id=s)
        ref = RefSharded(str(d), seed=0, block_size=16, num_shards=2, shard_id=s)
        assert port.local_rows() == (32, 16)[s] and port.steps_per_epoch(8) == 4
        got = list(port.batches(8, rng=port.epoch_rng(0), pad_to=8))
        assert len(got) == 4 and sum(int(w.sum()) for _, _, w in got) == (32, 16)[s]
        _assert_same_batches(got, ref.batches(8, rng=ref.epoch_rng(0), pad_to=8))


@pytest.mark.parametrize("skip", [3, 10])
def test_skip_batches_reads_what_the_reference_reads(corpus, skip):
    """The fast-forward gives the reference's batches and reads the same
    rows: the skipped mix groups are never read."""
    port = ShardedDataset(corpus, seed=2, block_size=16, mix_blocks=2)
    ref = RefSharded(corpus, seed=2, block_size=16, mix_blocks=2)
    p_stats, r_stats = ReadStats(), RefReadStats()
    got = list(port.batches(8, rng=port.epoch_rng(0), pad_to=8, skip_batches=skip,
                            stats=p_stats))
    _assert_same_batches(got, ref.batches(8, rng=ref.epoch_rng(0), pad_to=8,
                                          skip_batches=skip, stats=r_stats))
    assert p_stats.rows_read == r_stats.rows_read <= (320 - skip * 8) + 2 * 16
    full = _rows(port, 0, 8)
    assert [r.tobytes() for x, _, w in got for r in x[: int(w.sum())]] == full[skip * 8:]


def test_preload_and_stream_bit_identical(corpus):
    a = _rows(ShardedDataset(corpus, seed=3, block_size=16, preload=True), 0, 8)
    b = _rows(ShardedDataset(corpus, seed=3, block_size=16), 0, 8)
    assert a == b and len(a) == 320


def test_global_shuffle_never_materializes_corpus(corpus):
    port = ShardedDataset(corpus, seed=1, block_size=16, prefetch_blocks=1, mix_blocks=2)
    stats = ReadStats()
    n = sum(int(w.sum()) for _, _, w in port.batches(8, rng=port.epoch_rng(0), pad_to=8,
                                                     stats=stats))
    assert n == 320 and stats.rows_read == 320 and stats.batches == 40
    assert stats.max_resident_rows <= 7 * 16 < 320


def test_checkpointable_iterator_state_restore_matches_reference(corpus):
    port = ShardedDataset(corpus, seed=9, block_size=16, num_shards=2, shard_id=1)
    ref = RefSharded(corpus, seed=9, block_size=16, num_shards=2, shard_id=1)
    it, rit = port.iterator(4, 8, pad_to=8), ref.iterator(4, 8, pad_to=8)
    for _ in range(3):
        next(it), next(rit)
    assert it.state() == rit.state() == {"epoch": 4, "batch": 3, "samples": 24}
    _assert_same_batches(CheckpointableIterator.restore(port, it.state(), 8, pad_to=8),
                         RefIterator.restore(ref, rit.state(), 8, pad_to=8))
    # sample granularity: a start inside a batch
    _assert_same_batches(port.iterator(4, 8, pad_to=8, start_samples=20),
                         ref.iterator(4, 8, pad_to=8, start_samples=20))
    x, _, _ = next(port.iterator(4, 8, pad_to=8, start_samples=20))
    assert [r.tobytes() for r in x] == _rows(port, 4, 8)[20:28]


def test_split_holdout_matches_reference(corpus):
    port = ShardedDataset(corpus, seed=0, block_size=16, num_shards=2, shard_id=0)
    ref = RefSharded(corpus, seed=0, block_size=16, num_shards=2, shard_id=0)
    (pt, pv), (rt, rv) = port.split_holdout(0.25, 3), ref.split_holdout(0.25, 3)
    assert (len(pt), len(pv), pv.num_shards, pt.num_shards) == (len(rt), len(rv), 1, 2)
    _assert_same_batches(pt.iterator(1, 8, pad_to=8), rt.iterator(1, 8, pad_to=8))
    _assert_same_batches(pv.batches(8, pad_to=8), rv.batches(8, pad_to=8))
    _assert_same_batches(pt.unsharded().batches(8, pad_to=8),
                         rt.unsharded().batches(8, pad_to=8))
    all_rows = set(_rows(ShardedDataset(corpus, seed=0, block_size=16), 0, 8))
    va, tr = set(_rows(pv, 0, 8)), set(_rows(pt.unsharded(), 0, 8))
    assert va | tr == all_rows and not va & tr


def test_prefetch_yields_the_same_batches(corpus):
    """The engine's readahead thread changes when blocks are read, not
    what is emitted."""
    X = np.random.default_rng(6).integers(0, 12, (700, ROWS, COLS)).astype(np.uint8)
    ds = InMemoryDataset(X, X.sum(axis=1) % 5, block_size=32)
    read, _ = ds._reader()
    streams = [list(engine.iter_span_batches(ds._counts(), read, 16,
                                             rng=np.random.default_rng(8), pad_to=16,
                                             prefetch_groups=depth, mix_blocks=3))
               for depth in (0, 2)]
    _assert_same_batches(*streams)
    _assert_same_batches(*(
        ShardedDataset(corpus, seed=5, block_size=16, prefetch_blocks=depth).iterator(
            0, 8, pad_to=8) for depth in (2, 0)))


def test_in_memory_dataset_shards_like_the_sharded_dataset(corpus):
    """An in-memory corpus through a shard spec streams what the HDF5 one
    does when its rows sit in one group."""
    X, Y = _write_file(os.path.join(os.path.dirname(corpus), "flat.hdf5"),
                       np.random.default_rng(9), 200, "f")
    path = os.path.join(os.path.dirname(corpus), "flat.hdf5")
    for shard in (0, 1):
        mem = InMemoryDataset(X, Y).sharded(num_shards=2, shard_id=shard, seed=4,
                                            block_size=16, mix_blocks=3)
        ref = RefSharded(path, num_shards=2, shard_id=shard, seed=4, block_size=16,
                         mix_blocks=3)
        _assert_same_batches(mem.iterator(1, 8, pad_to=8), ref.iterator(1, 8, pad_to=8))


# -- the opener seam -------------------------------------------------------------

def test_open_input_local_file_scheme_and_registry(tmp_path):
    p = tmp_path / "blob.bin"
    p.write_bytes(b"roko")
    assert io.path_scheme("gs://b/k") == "gs" and io.path_scheme(str(p)) == ""
    with io.open_input("file://" + str(p)) as f:
        assert f.read() == b"roko"
    with pytest.raises(ValueError, match="A10"):
        io.open_input("gs://bucket/corpus.hdf5")
    with pytest.raises(ValueError, match="registered schemes"):
        io.open_input("mem://x")
    seen = []
    io.register_opener("mem", lambda path, mode: seen.append(path) or open(p, mode))
    try:
        with io.open_input("mem://x") as f:
            assert f.read() == b"roko" and seen == ["mem://x"]
        assert io.registered_schemes()["input"] == ("mem",)
    finally:
        io.register_opener("mem", None)
    with pytest.raises(ValueError, match="cannot register"):
        io.register_opener("file", open)


def test_sharded_dataset_streams_through_injected_opener(corpus):
    opened = []

    def counting(path, mode):
        opened.append(path)
        return io.local_open(path, mode)

    via = ShardedDataset(corpus, seed=1, block_size=16, opener=counting)
    assert _rows(via, 0, 8) == _rows(ShardedDataset(corpus, seed=1, block_size=16), 0, 8)
    assert sorted(set(map(os.path.basename, opened))) == ["part0.hdf5", "part1.hdf5",
                                                         "part2.hdf5"]
    assert json.loads(open(os.path.join(corpus, MANIFEST_BASENAME)).read())["version"] == 1
