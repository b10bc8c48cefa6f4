"""End to end on the CPU: sim features made by ``roko_tpu``, one ``.pth``
of each kind, and the polished FASTA of ``python -m roko_tpu_torch
inference --device cpu`` (``--model-kind gru`` and ``lingru``)
byte-identical to ``roko_tpu.infer.polish_to_fasta``."""

import numpy as np
import pytest

import jax
import torch

from roko_tpu.config import ModelConfig as JaxModelConfig, RokoConfig
from roko_tpu.features.pipeline import run_features
from roko_tpu.infer import polish_to_fasta as jax_polish_to_fasta
from roko_tpu.models import RokoModel as JaxRokoModel
from roko_tpu.models.convert import load_torch_checkpoint
from roko_tpu.sim import build_synthetic_project
from roko_tpu_torch import cli
from roko_tpu_torch.models.convert import state_dict_from_jax
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

# default front-end widths, so both CLIs reach it with
# --hidden-size 16 --num-layers 2
CFG = JaxModelConfig(hidden_size=16, num_layers=2)
CFG_LIN = JaxModelConfig(kind="lingru", hidden_size=16, num_layers=2)
SMALL = ["--hidden-size", "16", "--num-layers", "2", "--device", "cpu"]


def make_project(root):
    """Sim features (3 kb draft), and random JAX params written as a .pth."""
    paths = build_synthetic_project(str(root / "sim"), genome_len=3000, seed=11)
    h5 = str(root / "infer.hdf5")
    n = run_features(paths["draft_fasta"], paths["reads_bam"], h5, seed=5,
                     log=lambda *a: None)
    params = jax.tree.map(np.asarray, JaxRokoModel(CFG).init(jax.random.PRNGKey(4)))
    pth = str(root / "model.pth")
    torch.save(state_dict_from_jax(params), pth)
    return {"root": root, "h5": h5, "pth": pth, "windows": n}


def lingru_pth(root):
    """Random ``kind="lingru"`` JAX params (numpy) and their port .pth."""
    params = jax.tree.map(np.asarray, JaxRokoModel(CFG_LIN).init(jax.random.PRNGKey(6)))
    pth = str(root / "lingru.pth")
    torch.save(state_dict_from_jax(params), pth)
    return params, pth


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    return make_project(tmp_path_factory.mktemp("torch_cli"))


def test_cli_fasta_byte_identical_to_reference(project, capsys):
    root = project["root"]
    assert project["windows"] > 100
    want = str(root / "jax.fasta")
    cfg = RokoConfig(model=CFG)  # dp spans the 8 CPU test devices
    jax_polish_to_fasta(project["h5"], load_torch_checkpoint(project["pth"], CFG),
                        want, cfg, batch_size=16, log=lambda *a: None)

    got = str(root / "port.fasta")
    rc = cli.main(["inference", project["h5"], project["pth"], got, "--b", "16",
                   "--hidden-size", "16", "--num-layers", "2", "--device", "cpu"])
    assert rc == 0
    assert "windows/s" in capsys.readouterr().out
    with open(got, "rb") as a, open(want, "rb") as b:
        got_bytes, want_bytes = a.read(), b.read()
    assert len(got_bytes) > 2000
    assert got_bytes == want_bytes


def test_cli_without_card_refuses_cuda(project, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["inference", project["h5"], project["pth"], str(tmp_path / "o.fa"),
                  "--hidden-size", "16", "--num-layers", "2"])
    assert not (tmp_path / "o.fa").exists()


def test_cli_rejects_mismatched_model(project, tmp_path):
    with pytest.raises(RuntimeError, match="size mismatch"):
        cli.main(["inference", project["h5"], project["pth"], str(tmp_path / "o.fa"),
                  "--device", "cpu"])


def test_cli_lingru_fasta_byte_identical_to_reference(project, capsys):
    root = project["root"]
    params, pth = lingru_pth(root)
    want = str(root / "jax_lingru.fasta")
    jax_polish_to_fasta(project["h5"], params, want, RokoConfig(model=CFG_LIN),
                        batch_size=16, log=lambda *a: None)
    got = str(root / "port_lingru.fasta")
    assert cli.main(["inference", project["h5"], pth, got, "--b", "16",
                     "--model-kind", "lingru", *SMALL]) == 0
    assert "windows/s" in capsys.readouterr().out
    with open(got, "rb") as a, open(want, "rb") as b:
        got_bytes, want_bytes = a.read(), b.read()
    assert len(got_bytes) > 2000
    assert got_bytes == want_bytes


def test_cli_refuses_a_checkpoint_of_the_other_kind(project, tmp_path):
    """A gru .pth loaded as lingru, and a lingru one as gru, refuse loudly
    before anything is written."""
    _, lin = lingru_pth(tmp_path)
    for pth, kind in ((project["pth"], "lingru"), (lin, "gru")):
        with pytest.raises(RuntimeError, match="(?s)Missing key.*Unexpected key"):
            cli.main(["inference", project["h5"], pth, str(tmp_path / "o.fa"),
                      "--model-kind", kind, *SMALL])
    assert not (tmp_path / "o.fa").exists()
