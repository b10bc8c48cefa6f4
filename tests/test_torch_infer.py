"""The port's host side against the JAX package: vote board and stitch,
HDF5 window reader, FASTA writer, and the device rule of the entry
points."""

import numpy as np
import pytest

import torch

from roko_tpu.data.hdf5 import DataWriter
from roko_tpu.data.hdf5 import iter_inference_windows as jax_iter_windows
from roko_tpu.data.hdf5 import load_contigs as jax_load_contigs
from roko_tpu.infer import VoteBoard as JaxVoteBoard
from roko_tpu.io.fasta import write_fasta as jax_write_fasta
from roko_tpu_torch import constants as C
from roko_tpu_torch.data.hdf5 import iter_inference_windows, load_contigs
from roko_tpu_torch.infer import VoteBoard, resolve_device
from roko_tpu_torch.io.fasta import read_fasta, write_fasta
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

A, Cc, G, T, GAP = range(5)
BOARDS = {"dense": 10**9, "sparse": 0}


def _vote(board, contig, triples):
    positions = np.array([[(p, i) for p, i, _ in triples]], np.int64)
    preds = np.array([[b for _, _, b in triples]], np.int32)
    board.add([contig], positions, preds)


def _both(threshold, contigs):
    return (VoteBoard(contigs, sparse_threshold=threshold),
            JaxVoteBoard(contigs, sparse_threshold=threshold))


# each case: (draft, [vote rows]) covering one stitch rule
EDGE_CASES = {
    "leading_insertion": ("AAAAAAAAAA", [[(2, 1, G), (3, 0, T), (4, 0, Cc)]]),
    "gap_skipped": ("AAAAAAAAAA", [[(2, 0, Cc), (3, 0, GAP), (4, 0, T)]]),
    "zero_coverage": ("AAAAAAAAAA", [[(2, 0, Cc), (6, 0, T)]]),
    "tie_lowest_class": ("AAAA", [[(1, 0, T)], [(1, 0, G)], [(2, 1, Cc)], [(2, 1, A)],
                                  [(2, 0, G)]]),
    "insertions": ("ACGTACGT", [[(2, 0, T), (2, 1, A), (2, 2, Cc), (3, 0, G)]]),
    "only_insertions": ("ACGT", [[(1, 1, G), (2, 2, T)]]),
}


@pytest.mark.parametrize("board", list(BOARDS))
@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_stitch_edge_cases_match_reference(case, board):
    draft, rows = EDGE_CASES[case]
    port, ref = _both(BOARDS[board], {"c": draft, "untouched": "GATTACA"})
    for row in rows:
        _vote(port, "c", row)
        _vote(ref, "c", row)
    assert port.stitch_all() == ref.stitch_all()


@pytest.mark.parametrize("board", list(BOARDS))
def test_random_votes_match_reference(board):
    """Windows over two contigs with insertion slots, GAP votes and an
    uncovered stretch, in batches that mix the contigs."""
    rng = np.random.default_rng(21)
    contigs = {"a": "".join(rng.choice(list("ACGT"), 700)), "b": "ACGT" * 60}
    cols = {}
    for name, seq in contigs.items():
        c = []
        for pos in range(len(seq)):
            if 300 <= pos < 340 and name == "a":
                continue  # zero coverage inside the span
            c.append((pos, 0))
            for ins in range(1, C.MAX_INS + 1):
                if rng.random() > 0.15:
                    break
                c.append((pos, ins))
        cols[name] = np.array(c, np.int64)
    names, windows = [], []
    for name, c in cols.items():
        for s in range(0, len(c) - C.WINDOW_COLS + 1, C.WINDOW_STRIDE):
            names.append(name)
            windows.append(c[s : s + C.WINDOW_COLS])
    positions = np.stack(windows)
    preds = rng.integers(0, C.NUM_CLASSES, positions.shape[:2]).astype(np.int32)
    order = rng.permutation(len(names))
    port, ref = _both(BOARDS[board], contigs)
    for chunk in np.array_split(order, 5):
        sub = [names[i] for i in chunk]
        port.add(sub, positions[chunk], preds[chunk])
        ref.add(sub, positions[chunk], preds[chunk])
    assert port.stitch_all() == ref.stitch_all()


@pytest.mark.parametrize("board", list(BOARDS))
def test_saturation_raises_like_reference(board):
    for cls in (VoteBoard, JaxVoteBoard):
        b = cls({"c": "AAAAAAAAAA"}, sparse_threshold=BOARDS[board])
        b.SAT_LIMIT = 5
        for _ in range(4):
            _vote(b, "c", [(2, 0, Cc), (2, 1, G)])
        with pytest.raises(RuntimeError, match="saturation.*window stride"):
            _vote(b, "c", [(2, 0, Cc)])
        with pytest.raises(RuntimeError, match="saturation"):
            _vote(b, "c", [(2, 1, G)])


def test_duplicate_positions_refused():
    b = VoteBoard({"c": "AAAAAAAAAA"})
    with pytest.raises(RuntimeError, match="duplicates positions"):
        _vote(b, "c", [(2, 0, Cc)] * 600)


def _write_features(path, rng):
    """Two contigs in three groups whose names sort out of genome order."""
    with DataWriter(str(path), infer=True) as w:
        w.write_contigs([("c", "ACGT" * 300), ("b", "TTGCA" * 20)])
        for contig, starts in (("c", (1000, 200)), ("b", (0,))):
            for start in starts:
                n = 13
                pos = np.stack([
                    np.stack([np.arange(C.WINDOW_COLS) + start + i,
                              np.zeros(C.WINDOW_COLS)], 1)
                    for i in range(n)
                ]).astype(np.int64)
                x = rng.integers(0, C.FEATURE_VOCAB,
                                 (n, C.WINDOW_ROWS, C.WINDOW_COLS)).astype(np.uint8)
                w.store(contig, pos, x, None)
                w.write()


@pytest.mark.parametrize("slab", [5, 4096])
def test_hdf5_reader_matches_reference(tmp_path, slab):
    path = tmp_path / "f.hdf5"
    _write_features(path, np.random.default_rng(3))
    assert load_contigs(str(path)) == jax_load_contigs(str(path))
    got = list(iter_inference_windows(str(path), 8, slab=slab))
    want = list(jax_iter_windows(str(path), 8, slab=slab))
    assert len(got) == len(want) == 5
    for (n1, p1, x1), (n2, p2, x2) in zip(got, want):
        assert n1 == n2
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(x1, x2)


def test_fasta_bytes_match_reference(tmp_path):
    records = [("a", "ACGT" * 45), ("b", ""), ("c", "G" * 80), ("d", "T" * 81)]
    write_fasta(str(tmp_path / "port.fa"), records)
    jax_write_fasta(str(tmp_path / "ref.fa"), records)
    assert (tmp_path / "port.fa").read_bytes() == (tmp_path / "ref.fa").read_bytes()
    assert read_fasta(str(tmp_path / "port.fa")) == records


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
