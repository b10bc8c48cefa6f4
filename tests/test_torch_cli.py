"""End to end on the CPU: sim features made by ``roko_tpu``, one ``.pth``,
and the polished FASTA of ``python -m roko_tpu_torch inference --device
cpu`` byte-identical to ``roko_tpu.infer.polish_to_fasta``."""

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

# default front-end widths, so both CLIs reach it with
# --hidden-size 16 --num-layers 2
CFG = JaxModelConfig(hidden_size=16, num_layers=2)


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
