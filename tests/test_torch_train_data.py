"""The port's training data stream against the JAX package: batch for
batch equal to ``roko_tpu.datapipe.ShardedDataset`` (one shard) over one
and two HDF5 files, two epochs, with and without ``split_holdout``, and
``InMemoryDataset`` equal to ``roko_tpu.training.data.InMemoryDataset``."""

import numpy as np
import pytest

from roko_tpu import constants as JC
from roko_tpu.data.hdf5 import DataWriter
from roko_tpu.datapipe import ShardedDataset
from roko_tpu.training.data import InMemoryDataset as JaxInMemoryDataset
from roko_tpu_torch.data.hdf5 import hdf5_files
from roko_tpu_torch.training.data import HDF5Dataset, InMemoryDataset, epoch_rng
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROWS, COLS = 4, 6  # the stream does not care about the window's shape
BS = 32


def _write_file(path, rng, sizes):
    """One training file with a group per contig of the given sizes."""
    with DataWriter(str(path), infer=False) as w:
        w.write_contigs([(f"c{i}", "ACGT" * 10) for i in range(len(sizes))])
        for i, n in enumerate(sizes):
            X = rng.integers(0, JC.FEATURE_VOCAB, (n, ROWS, COLS)).astype(np.uint8)
            Y = (X.sum(axis=1) % JC.NUM_CLASSES).astype(np.int64)
            pos = [np.stack([np.arange(COLS), np.zeros(COLS)], 1)] * n
            w.store(f"c{i}", pos, list(X), list(Y))


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train_data")
    rng = np.random.default_rng(3)
    (root / "two").mkdir()
    _write_file(root / "two" / "b.hdf5", rng, (300, 45))
    _write_file(root / "two" / "a.hdf5", rng, (530,))
    _write_file(root / "one.hdf5", rng, (700, 90))
    return {"one": str(root / "one.hdf5"), "two": str(root / "two")}


def _assert_same_stream(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for (gx, gy, gw), (wx, wy, ww) in zip(got, want):
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy) and np.array_equal(gw, ww)
        assert gx.dtype == wx.dtype and gy.dtype == wy.dtype and gw.dtype == ww.dtype


@pytest.mark.parametrize("corpus", ["one", "two"])
@pytest.mark.parametrize("seed", [0, 5])
def test_epoch_stream_matches_sharded_dataset(corpora, corpus, seed):
    path = corpora[corpus]
    port, ref = HDF5Dataset(path), ShardedDataset(path, seed=seed)
    assert len(port) == len(ref)
    assert port.steps_per_epoch(BS) == ref.steps_per_epoch(BS)
    for epoch in (0, 1):
        _assert_same_stream(port.batches(BS, rng=epoch_rng(seed, epoch)),
                            ref.iterator(epoch, BS, pad_to=BS))
    # evaluation order: unshuffled
    _assert_same_stream(port.batches(BS), ref.batches(BS, pad_to=BS))


@pytest.mark.parametrize("corpus", ["one", "two"])
def test_holdout_streams_match_sharded_dataset(corpora, corpus):
    path = corpora[corpus]
    p_train, p_val = HDF5Dataset(path).split_holdout(0.2, 7)
    r_train, r_val = ShardedDataset(path, seed=7).split_holdout(0.2, 7)
    assert (len(p_train), len(p_val)) == (len(r_train), len(r_val))
    for epoch in (0, 1):
        _assert_same_stream(p_train.batches(BS, rng=epoch_rng(7, epoch)),
                            r_train.iterator(epoch, BS, pad_to=BS))
    _assert_same_stream(p_val.batches(BS), r_val.batches(BS, pad_to=BS))


def test_file_order_and_fingerprint(corpora):
    assert [p.rsplit("/", 1)[1] for p in hdf5_files(corpora["two"])] == ["a.hdf5", "b.hdf5"]
    assert HDF5Dataset(corpora["two"]).fingerprint() == HDF5Dataset(corpora["two"]).fingerprint()
    assert HDF5Dataset(corpora["two"]).fingerprint() != HDF5Dataset(corpora["one"]).fingerprint()
    with pytest.raises(ValueError, match="val fraction"):
        HDF5Dataset(corpora["one"]).split_holdout(1.0, 0)


@pytest.mark.parametrize("n", [1000, 77])
def test_in_memory_dataset_matches_reference(n):
    rng = np.random.default_rng(n)
    X = rng.integers(0, JC.FEATURE_VOCAB, (n, ROWS, COLS)).astype(np.uint8)
    Y = (X.sum(axis=1) % JC.NUM_CLASSES).astype(np.int64)
    port, ref = InMemoryDataset(X, Y), JaxInMemoryDataset(X, Y)
    for seed in (0, 3):
        _assert_same_stream(port.batches(BS, rng=np.random.default_rng(seed)),
                            ref.batches(BS, rng=np.random.default_rng(seed), pad_to=BS))
    (pt, pv), (rt, rv) = port.split_holdout(0.1, 2), ref.split_holdout(0.1, 2)
    assert np.array_equal(pt.X, rt.X) and np.array_equal(pv.Y, rv.Y)
    _assert_same_stream(pt.batches(BS, rng=epoch_rng(0, 1)),
                        rt.batches(BS, rng=epoch_rng(0, 1), pad_to=BS))
