"""Two processes of the port through its command line, on the CPU over
gloo: the counterpart of ``tests/test_multiprocess.py``.

``python -m roko_tpu_torch train --dp 2``, then ``inference --dp 2``
and ``polish --dp 2`` (``tests/torch_dp_worker.py``, mode ``cli``): rank
0 alone writes the checkpoint, each rank polishes its contigs, and rank 0
merges the parts into a FASTA byte-identical to the port's one-process
run and to ``roko_tpu.infer.polish_to_fasta`` with the same parameters,
then removes the parts (with the names sorted when the draft's are not,
as the reference merges); ``polish`` runs staged and refuses
``--keep-hdf5`` and ``--resume``, with the reference's messages. The
corpus check refuses ranks that read different files.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest

from roko_tpu.config import MeshConfig as JaxMeshConfig
from roko_tpu.config import ModelConfig as JaxModelConfig
from roko_tpu.config import RokoConfig as JaxRokoConfig
from roko_tpu.infer import polish_to_fasta as ref_polish_to_fasta
from roko_tpu.parallel.mesh import make_mesh as ref_make_mesh
from roko_tpu_torch import cli
from roko_tpu_torch import constants as C
from roko_tpu_torch.config import ModelConfig
from roko_tpu_torch.data.hdf5 import DataWriter
from roko_tpu_torch.infer import polish_to_fasta, polish_windows_to_fasta
from roko_tpu_torch.io.fasta import read_fasta
from roko_tpu_torch.models.convert import jax_from_state_dict
from roko_tpu_torch.models.model import RokoModel
from roko_tpu_torch.sim import build_synthetic_project
from roko_tpu_torch.training.checkpoint import load_params, verify_manifest
from tests import torch_dp_worker as W
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

MODEL_FLAGS = ["--hidden-size", "16", "--num-layers", "1"]
CONTIGS = [("ctgA", "ACGT" * 60), ("ctgB", "TTGCA" * 50), ("ctgC", "GATTACA" * 20)]


def _positions(n, offset):
    return [np.stack([np.arange(C.WINDOW_COLS) + offset + 7 * (i % 3),
                      np.zeros(C.WINDOW_COLS)], 1).astype(np.int64) for i in range(n)]


def _corpora(tmp_path):
    """train.hdf5 (32 labelled windows), other.hdf5 (another 24), and
    infer.hdf5: windows of ctgA and ctgB, none of ctgC."""
    rng = np.random.default_rng(0)
    paths = {}
    for name, n in (("train", 32), ("other", 24)):
        X = rng.integers(0, C.FEATURE_VOCAB, (n, C.WINDOW_ROWS, C.WINDOW_COLS), dtype=np.uint8)
        Y = (X.sum(axis=1) % C.NUM_CLASSES).astype(np.int64)
        paths[name] = str(tmp_path / f"{name}.hdf5")
        with DataWriter(paths[name], infer=False) as w:
            w.write_contigs(CONTIGS[:1])
            w.store("ctgA", _positions(n, 0), list(X), list(Y))
    X = rng.integers(0, C.FEATURE_VOCAB, (40, C.WINDOW_ROWS, C.WINDOW_COLS), dtype=np.uint8)
    paths["infer"] = str(tmp_path / "infer.hdf5")
    with DataWriter(paths["infer"], infer=True) as w:
        w.write_contigs(CONTIGS)
        w.store("ctgA", _positions(20, 0), list(X[:20]), None)
        w.store("ctgB", _positions(20, 40), list(X[20:]), None)
    return paths


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp")
    paths = _corpora(tmp)
    project = build_synthetic_project(str(tmp / "sim"), seed=13, genome_len=4000)
    out = tmp / "run"
    out.mkdir()
    logs = W.launch("cli", str(out), paths["train"], paths["other"], paths["infer"],
                    project["draft_fasta"], project["reads_bam"], *MODEL_FLAGS)
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in (0, 1)]
    return {"paths": paths, "out": out, "ranks": ranks, "logs": logs, "project": project}


def test_two_processes_train_then_polish(run):
    assert [r["world"] for r in run["ranks"]] == [2, 2]
    assert all(r["rc_train"] == 0 and r["rc_infer"] == 0 for r in run["ranks"])
    assert (run["out"] / "polished.fasta").exists()


def test_one_checkpoint_written_once(run):
    """Rank 0 writes each checkpoint (the epoch's step and ``latest``);
    rank 1 writes none; the checkpoint verifies."""
    assert run["ranks"][0]["writes"] == ["2", "latest"]
    assert run["ranks"][1]["writes"] == []
    ckpt = run["out"] / "ckpt"
    assert sorted(p.name for p in ckpt.iterdir()) == ["2", "latest"]
    assert verify_manifest(str(ckpt / "latest"))[0] == "ok"


def test_fasta_equals_one_process_and_reference(run, tmp_path):
    params = load_params(str(run["out"] / "ckpt"))
    model = RokoModel(ModelConfig(hidden_size=16, num_layers=1, d_model=32))
    model.load_state_dict(params, strict=True)
    one = tmp_path / "one.fasta"
    polish_to_fasta(run["paths"]["infer"], model, str(one), device="cpu", batch_size=16,
                    log=lambda s: None)
    got = (run["out"] / "polished.fasta").read_bytes()
    assert got == one.read_bytes()
    assert got.count(b">") == 3  # ctgC, with no windows, keeps its draft
    ref = tmp_path / "ref.fasta"
    cfg = JaxRokoConfig(model=JaxModelConfig(hidden_size=16, num_layers=1),
                        mesh=JaxMeshConfig(dp=1))
    ref_polish_to_fasta(run["paths"]["infer"], jax_from_state_dict(params), str(ref), cfg,
                        batch_size=16, mesh=ref_make_mesh(cfg.mesh, jax.devices()[:1]),
                        log=lambda *a: None)
    assert got == ref.read_bytes()


def test_several_processes_write_the_contigs_sorted_by_name(run, tmp_path):
    """C3: a draft whose names are not sorted (ctgB, ctgA, ctgC, in memory:
    through an HDF5 file the draft's order is h5py's, sorted by name, in
    both packages). One process writes the draft's order; two ranks write
    the names sorted, the order ``roko_tpu/infer.py:629`` writes, byte-
    identical to ``roko_tpu``'s FASTA, whose contigs come sorted from the
    HDF5. ``polish_windows_to_fasta`` returns the contigs each process
    polished, in one process all of them."""
    params = load_params(str(run["out"] / "ckpt"))
    model = RokoModel(ModelConfig(hidden_size=16, num_layers=1, d_model=32))
    model.load_state_dict(params, strict=True)
    contigs, windows = W.unsorted_draft(run["paths"]["infer"])
    one = tmp_path / "one.fasta"
    returned = polish_windows_to_fasta(contigs, windows, model, str(one), device="cpu",
                                       log=lambda s: None)
    assert [n for n, _ in read_fasta(str(one))] == ["ctgB", "ctgA", "ctgC"]
    assert returned == dict(read_fasta(str(one)))
    ref = tmp_path / "ref.fasta"
    cfg = JaxRokoConfig(model=JaxModelConfig(hidden_size=16, num_layers=1),
                        mesh=JaxMeshConfig(dp=1))
    ref_polish_to_fasta(run["paths"]["infer"], jax_from_state_dict(params), str(ref), cfg,
                        batch_size=16, mesh=ref_make_mesh(cfg.mesh, jax.devices()[:1]),
                        log=lambda *a: None)
    assert [n for n, _ in read_fasta(str(ref))] == ["ctgA", "ctgB", "ctgC"]
    assert (run["out"] / "unsorted.fasta").read_bytes() == ref.read_bytes()
    assert dict(read_fasta(str(ref))) == returned
    by_rank = [r["unsorted_returned"] for r in run["ranks"]]
    assert [sorted(d) for d in by_rank] == [["ctgA", "ctgC"], ["ctgB"]]
    assert {**by_rank[0], **by_rank[1]} == returned


def test_polish_runs_staged_split_by_contig(run, tmp_path, capsys):
    """``polish --dp 2`` writes what one process's ``polish --staged``
    writes; rank 0 alone reports it."""
    assert [r["rc_polish"] for r in run["ranks"]] == [0, 0]
    one = tmp_path / "one.fasta"
    assert cli.main(["polish", run["project"]["draft_fasta"], run["project"]["reads_bam"],
                     str(run["out"] / "ckpt"), str(one), "--staged", "--b", "16",
                     "--device", "cpu", *MODEL_FLAGS]) == 0
    assert (run["out"] / "polish.fasta").read_bytes() == one.read_bytes()
    said = [log.count("wrote polished contigs to") for log in run["logs"]]
    assert said == [2, 0]  # inference and polish, on rank 0


def test_polish_refuses_keep_hdf5_and_resume_on_two_processes(run):
    for r in run["ranks"]:
        assert r["refused"]["--keep-hdf5"].startswith(
            "polish --keep-hdf5 is single-host only: every pod process would write")
        assert r["refused"]["--resume"].startswith(
            "polish --resume is a streaming-engine feature (the journal rides the")
    assert not (run["out"] / "kept.hdf5").exists()


def test_fasta_parts_removed(run):
    assert sorted(p.name for p in run["out"].iterdir() if ".part" in p.name) == []


def test_mismatched_corpus_refused(run):
    """Rank 1 indexed another file set: both ranks refuse, each naming
    the other."""
    m0, m1 = (r["mismatch"] for r in run["ranks"])
    assert m0 and m1
    assert "hosts disagree on the training file set: process 0" in m0
    assert "differs from process(es) [1]" in m0 and "train.hdf5" in m0
    assert "differs from process(es) [0]" in m1 and "other.hdf5" in m1


def test_mid_epoch_resume_on_two_processes(tmp_path):
    """Two ranks stopped together inside the second epoch resume from
    rank 0's ``latest`` at the next batch, and end bitwise where an
    uninterrupted run of two ranks ends."""
    W.launch("resume", str(tmp_path))
    import torch

    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in (0, 1)]
    for r in ranks:
        assert r["steps"] == (8, 8)
        assert all(torch.equal(r["full"][n], r["resumed"][n]) for n in r["full"])
        assert all(torch.equal(r["full"][n], ranks[0]["full"][n]) for n in r["full"])
    assert any("resumed from step 6 (epoch 1, batch 2," in line for line in ranks[0]["log"])
    assert ranks[1]["log"] == []  # rank 0 alone logs
