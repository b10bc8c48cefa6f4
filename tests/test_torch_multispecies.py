"""Wiring of the port's multi-species protocol
(``roko_tpu_torch/examples/multispecies_protocol.py``; counterpart of
``tests/test_multispecies.py``): training reads a DIRECTORY of
per-species HDF5 files with a separate ``--val`` species driving early
stopping, and the held-out species flows through inference. The
example's ``main`` runs its stages through ``python -m roko_tpu_torch``
with ``--device cpu``; the test adds ``--config`` with a tiny model to
its ``train`` and ``inference`` stages, so the run stays small. The
species it simulates and the windows it extracts are held to what
``roko_tpu`` makes with the reference example's seeds (sim seed 1000 + i,
features seed 10 + i, the test species' features seed 99), and its
verdict to ``roko_tpu``'s assess of its polish. Accuracy is
``tests/test_torch_end_to_end.py``'s business."""

import json
import os

import numpy as np

from roko_tpu.eval.assess import assess_fastas as ref_assess_fastas
from roko_tpu.features.pipeline import run_features as ref_run_features
from roko_tpu.sim import build_synthetic_project as ref_build_synthetic_project
from roko_tpu_torch.data.hdf5 import hdf5_files, iter_inference_windows, read_training_groups
from roko_tpu_torch.datapipe.dataset import ShardedDataset
from roko_tpu_torch.examples import multispecies_protocol as protocol
from roko_tpu_torch.examples.synthetic_e2e import run_cli
from roko_tpu_torch.io.fasta import read_fasta
from roko_tpu_torch.training.checkpoint import verify_manifest
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = {"model": {"embed_dim": 8, "read_mlp": [8, 4], "hidden_size": 16, "num_layers": 2}}
SPECIES = dict(genome_len=2000, coverage=10)


def _training_arrays(path):
    groups = list(read_training_groups(path))
    return np.concatenate([g[1] for g in groups]), np.concatenate([g[2] for g in groups])


def _reference_species(root, i, role, labelled):
    """Species ``i`` of the reference example, through ``roko_tpu``'s sim
    and feature extraction with that example's seeds."""
    p = ref_build_synthetic_project(os.path.join(root, role), seed=1000 + i, contig=f"ctg_{role}",
                                    **SPECIES)
    out = os.path.join(root, f"{role}.hdf5")
    ref_run_features(p["draft_fasta"], p["reads_bam"], out,
                     bam_y=p["truth_bam"] if labelled else None,
                     seed=10 + i if labelled else 99, log=lambda *a: None)
    return p, out


def test_multispecies_train_val_test_wiring(tmp_path, monkeypatch):
    wd = str(tmp_path / "work")
    config = tmp_path / "tiny.json"
    config.write_text(json.dumps(TINY))
    stages = []

    def tiny_run_cli(argv):
        stages.append(list(argv))
        run_cli(argv + (["--config", str(config)] if argv[0] in ("train", "inference") else []))

    monkeypatch.setattr(protocol, "run_cli", tiny_run_cli)
    rc = protocol.main(["--workdir", wd, "--train-species", "2", "--genome-len",
                        str(SPECIES["genome_len"]), "--coverage", str(SPECIES["coverage"]),
                        "--epochs", "2", "--lr", "1e-3", "--device", "cpu"])

    train_dir, val_h5 = os.path.join(wd, "train"), os.path.join(wd, "val.hdf5")
    assert [s[0] for s in stages] == ["features"] * 4 + ["train", "inference"]
    train = stages[4]
    assert train[1:3] == [train_dir, os.path.join(wd, "ckpt")]
    assert train[train.index("--val") + 1] == val_h5 and "--no-resume" in train
    assert train[train.index("--device") + 1] == "cpu"
    # the train directory holds one file per species, the val species its
    # own, and the directory reader sees every training file
    assert [os.path.basename(f) for f in hdf5_files(train_dir)] == ["train0.hdf5",
                                                                    "train1.hdf5"]
    one = sum(len(g[1]) for g in read_training_groups(os.path.join(train_dir, "train0.hdf5")))
    assert len(ShardedDataset(train_dir, preload=True)) > one > 0
    assert sum(len(g[1]) for g in read_training_groups(val_h5)) > 0

    ckpt = os.path.join(wd, "ckpt")
    assert "latest" in os.listdir(ckpt) and len(os.listdir(ckpt)) >= 2
    for name in os.listdir(ckpt):
        assert verify_manifest(os.path.join(ckpt, name))[0] == "ok", name
    (name, seq), = read_fasta(os.path.join(wd, "test_polished.fasta"))
    assert name == "ctg_test" and len(seq) > 0 and set(seq) <= set("ACGT")

    # each species' windows and labels are the reference example's
    ref_root = str(tmp_path / "reference")
    port_files = {"train0": os.path.join(train_dir, "train0.hdf5"),
                  "train1": os.path.join(train_dir, "train1.hdf5"), "val": val_h5}
    for i, role in enumerate(["train0", "train1", "val"]):
        _, want = _reference_species(ref_root, i, role, labelled=True)
        for got_a, want_a in zip(_training_arrays(port_files[role]), _training_arrays(want)):
            np.testing.assert_array_equal(got_a, want_a)
    ref_test, want = _reference_species(ref_root, 3, "test", labelled=False)
    got_w = list(iter_inference_windows(os.path.join(wd, "test_infer.hdf5"), 64))
    want_w = list(iter_inference_windows(want, 64))
    assert len(got_w) == len(want_w) > 0
    for (n1, p1, x1), (n2, p2, x2) in zip(got_w, want_w):
        assert list(n1) == list(n2)
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(x1, x2)

    # the example's verdict is the reference assess's of its polish
    truth = {n: s.encode() for n, s in read_fasta(ref_test["truth_fasta"])}
    draft = {n: s.encode() for n, s in read_fasta(ref_test["draft_fasta"])}
    better = (ref_assess_fastas(truth, {name: seq.encode()}).error_rate
              < ref_assess_fastas(truth, draft).error_rate)
    assert rc == (0 if better else 1)
