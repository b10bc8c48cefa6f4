"""The port's out-of-core dataset (``training/lazy_data.py``) and ``train
--no-memory`` against ``roko_tpu``: ``StreamingDataset.batches`` equal to
the reference's on the same file and generator, every example once, and
a streamed training run bit-identical to the preloaded one. The mirror of
``tests/test_lazy_data.py``."""

import numpy as np
import pytest
import torch

from roko_tpu import constants as JC
from roko_tpu.training.lazy_data import StreamingDataset as RefStreaming
from roko_tpu_torch import cli
from roko_tpu_torch.config import ModelConfig, TrainConfig
from roko_tpu_torch.data.hdf5 import DataWriter
from roko_tpu_torch.training import loop
from roko_tpu_torch.training.lazy_data import StreamingDataset
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = ModelConfig(embed_dim=8, read_mlp=(8, 4), hidden_size=16, num_layers=2)


def _write(path, n, seed, rows=JC.WINDOW_ROWS, cols=JC.WINDOW_COLS, groups=1):
    rng = np.random.default_rng(seed)
    X = rng.integers(0, JC.FEATURE_VOCAB, (n, rows, cols)).astype(np.uint8)
    Y = (X.sum(axis=1) % JC.NUM_CLASSES).astype(np.int64)
    pos = [np.stack([np.arange(cols), np.zeros(cols)], 1)] * n
    with DataWriter(str(path), infer=False) as w:
        w.write_contigs([(f"c{g}", "ACGT" * 100) for g in range(groups)])
        per = -(-n // groups)
        for g in range(groups):
            sl = slice(g * per, (g + 1) * per)
            w.store(f"c{g}", pos[sl], list(X[sl]), list(Y[sl]))
    return X, Y


def _same(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for g, r in zip(a, b):
            assert g.dtype == r.dtype and np.array_equal(g, r)


@pytest.mark.parametrize("chunk,buffer", [(16, 2), (8, 16)])
def test_streaming_batches_match_reference(tmp_path, chunk, buffer):
    _write(tmp_path / "t.hdf5", 150, 1, rows=4, cols=6, groups=3)
    path = str(tmp_path / "t.hdf5")
    port = StreamingDataset(path, chunk_size=chunk, buffer_chunks=buffer)
    ref = RefStreaming(path, chunk_size=chunk, buffer_chunks=buffer)
    assert len(port) == len(ref) == 150 and port.files == ref.files
    for seed, kw in ((0, dict(pad_to=16)), (3, {}), (None, {}),
                     (5, dict(pad_to=16, skip_batches=4)), (5, dict(drop_remainder=True))):
        rngs = [None if seed is None else np.random.default_rng(seed) for _ in range(2)]
        _same(port.batches(16, rng=rngs[0], **kw), ref.batches(16, rng=rngs[1], **kw))


def test_streaming_covers_every_example_once(tmp_path):
    X, _ = _write(tmp_path / "t.hdf5", 70, 2, rows=4, cols=6)
    ds = StreamingDataset(str(tmp_path / "t.hdf5"), chunk_size=16, buffer_chunks=2)
    seen = []
    for xb, _yb, wb in ds.batches(16, rng=np.random.default_rng(0), pad_to=16):
        assert xb.shape[0] == 16
        seen.extend(r.tobytes() for r in xb[: int(wb.sum())])
    assert sorted(seen) == sorted(r.tobytes() for r in X)


def test_no_memory_training_is_bit_identical_to_preloaded(tmp_path):
    """``in_memory=False`` streams the same batches as the preloaded
    corpus, so the trained parameters are equal bit for bit."""
    _write(tmp_path / "train.hdf5", 48, 3)
    path = str(tmp_path / "train.hdf5")
    results = [
        loop.train(path, str(tmp_path / f"ck{mem}"), model_cfg=TINY,
                   train_cfg=TrainConfig(batch_size=16, epochs=1, lr=3e-3, in_memory=mem),
                   device="cpu", log=lambda s: None)
        for mem in (True, False)
    ]
    assert results[0].step == results[1].step == 3
    for (k, a), b in zip(results[0].model.state_dict().items(),
                         results[1].model.state_dict().values()):
        assert torch.equal(a, b), k
    assert results[0].history[0]["train_loss"] == results[1].history[0]["train_loss"]


def test_cli_memory_flags_reach_config():
    parser = cli.build_parser()
    for argv, want in ((["--no-memory"], False), (["--memory"], True), ([], True)):
        args = parser.parse_args(["train", "in.hdf5", "out", *argv])
        assert cli._build_config(args).train.in_memory is want
