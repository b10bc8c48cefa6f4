"""The port's draft-to-FASTA path on the CPU: ``python -m roko_tpu_torch
sim``, ``features`` and ``polish --staged --device cpu`` (``--model-kind
gru`` and ``lingru``, hidden 16, 2 layers) against ``roko_tpu``'s sim,
``run_features`` and staged polish (``run_features`` +
``polish_to_fasta``) on the same inputs and the same ``.pth``: equal
files, equal HDF5 datasets, byte-identical FASTA. ``polish`` without
``--staged``, or with ``--truth``, exits with a usage error and writes
nothing."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from roko_tpu.config import ModelConfig as JaxModelConfig, RegionConfig, RokoConfig
from roko_tpu.features.pipeline import run_features as ref_run_features
from roko_tpu.infer import polish_to_fasta as ref_polish_to_fasta
from roko_tpu.models import RokoModel as JaxRokoModel
from roko_tpu.models.convert import load_torch_checkpoint
from roko_tpu.pipeline import run_streaming_polish as ref_streaming_polish
from roko_tpu.sim import build_synthetic_project as ref_project
from roko_tpu_torch import cli
from roko_tpu_torch.models.convert import state_dict_from_jax
from tests.test_torch_features import _assert_same_file
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
SMALL = ["--hidden-size", "16", "--num-layers", "2", "--device", "cpu"]
KINDS = {"gru": 4, "lingru": 6}  # kind -> init seed of the random JAX params


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """A 4 kb project written by the port's CLI, and random JAX params of
    each kind with their .pth."""
    root = tmp_path_factory.mktemp("torch_polish")
    proc = subprocess.run(
        [sys.executable, "-m", "roko_tpu_torch", "sim", str(root / "sim"), "--seed", "13",
         "--genome-len", "4000"],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    paths = {k: v for k, v in (line.split(": ", 1) for line in proc.stdout.splitlines())}
    pths, params = {}, {}
    for kind, seed in KINDS.items():
        cfg = JaxModelConfig(kind=kind, hidden_size=16, num_layers=2)
        params[kind] = jax.tree.map(np.asarray, JaxRokoModel(cfg).init(jax.random.PRNGKey(seed)))
        pths[kind] = str(root / f"{kind}.pth")
        torch.save(state_dict_from_jax(params[kind]), pths[kind])
    return dict(paths, root=root, pth=pths, params=params)


def test_cli_sim_byte_identical_to_reference(project):
    want = ref_project(str(project["root"] / "ref_sim"), seed=13, genome_len=4000)
    for key in ("truth_fasta", "draft_fasta", "reads_bam", "truth_bam"):
        got = Path(project[key]).read_bytes()
        assert got == Path(want[key]).read_bytes(), key
        if key.endswith("bam"):
            assert Path(project[key] + ".bai").read_bytes() == Path(want[key] + ".bai").read_bytes()
    assert project["contig"] == want["contig"] == "ctg"


@pytest.mark.parametrize("mode", ["infer", "train"])
def test_cli_features_match_reference(project, tmp_path, capsys, mode):
    got, want = str(tmp_path / "port.hdf5"), str(tmp_path / "ref.hdf5")
    y = ["--Y", project["truth_bam"]] if mode == "train" else []
    rc = cli.main(["features", project["draft_fasta"], project["reads_bam"], got, "--seed", "5",
                   "--t", "2", "--region-size", "1500", "--region-overlap", "200", *y])
    assert rc == 0
    out = capsys.readouterr().out
    assert "native extractor" in out and f"to {got}" in out
    n = ref_run_features(project["draft_fasta"], project["reads_bam"], want,
                         bam_y=y[1] if y else None, workers=2, seed=5,
                         config=RokoConfig(region=RegionConfig(1500, 200)),
                         log=lambda *a: None)
    assert n > 100
    _assert_same_file(got, want)


def _reference_staged_fasta(project, kind, out, seed=0):
    """The reference's staged polish: run_features, then polish_to_fasta
    with the same weights (read from the .pth where the reference reads
    one: gru)."""
    cfg = JaxModelConfig(kind=kind, hidden_size=16, num_layers=2)
    h5 = str(Path(out).with_suffix(".hdf5"))
    ref_run_features(project["draft_fasta"], project["reads_bam"], h5, seed=seed,
                     log=lambda *a: None)
    params = (load_torch_checkpoint(project["pth"][kind], cfg) if kind == "gru"
              else project["params"][kind])
    ref_polish_to_fasta(h5, params, out,
                        RokoConfig(model=cfg), batch_size=32, log=lambda *a: None)
    return Path(out).read_bytes()


@pytest.mark.parametrize("kind", list(KINDS))
def test_polish_staged_fasta_byte_identical_to_reference(project, tmp_path, kind):
    got = tmp_path / "port.fasta"
    keep = tmp_path / "kept.hdf5"
    argv = ["polish", project["draft_fasta"], project["reads_bam"], project["pth"][kind],
            str(got), "--staged", "--b", "32", "--t", "2", "--keep-hdf5", str(keep),
            "--model-kind", kind, *SMALL]
    if kind == "gru":  # once through the module entry point, as a user runs it
        proc = subprocess.run([sys.executable, "-m", "roko_tpu_torch", *argv],
                              capture_output=True, text=True, timeout=300, cwd=str(ROOT))
        assert proc.returncode == 0, proc.stderr
        assert "extracted" in proc.stdout and "wrote polished contigs" in proc.stdout
    else:
        assert cli.main(argv) == 0
    want = _reference_staged_fasta(project, kind, str(tmp_path / "ref.fasta"))
    assert len(want) > 3000
    assert got.read_bytes() == want
    _assert_same_file(str(keep), str(tmp_path / "ref.hdf5"))


@pytest.mark.parametrize("extra,message", [
    (["--distributed"], "--distributed is not ported yet (queue item A10"),
    (["--cascade"], "--cascade is not ported yet (queue item A10"),
    # --config and --trace-dir are ported: a config file that asks for
    # what the port does not run is refused, naming its queue item
    # a mesh the run's processes cannot fill, on any of its axes
    (["--config", "mesh.json"], "mesh dp=4: mesh [4, 1, 1] wants 4 devices, have 1"),
    (["--config", "mesh_tp.json"], "mesh dp=-1: 1 devices not divisible by fixed axes "
     "product 2"),
    (["--config", "cascade.json"], "config cascade.enabled = True: not ported yet (queue "
     "item A10"),
    (["--staged", "--resume"], "cannot combine with --staged"),
])
def test_polish_refuses_what_is_not_ported(project, tmp_path, capsys, extra, message):
    out = tmp_path / "o.fasta"
    unported = {"mesh.json": ("mesh", "dp", 4), "mesh_tp.json": ("mesh", "tp", 2),
                "cascade.json": ("cascade", "enabled", True)}
    if extra[-1] in unported:  # a reference-layout file, written beside the project
        section, key, value = unported[extra[-1]]
        raw = json.loads(RokoConfig().to_json())
        raw[section][key] = value
        path = project["root"] / extra[-1]
        path.write_text(json.dumps(raw))
        extra = [*extra[:-1], str(path)]
    with pytest.raises(SystemExit) as exc:
        cli.main(["polish", project["draft_fasta"], project["reads_bam"], project["pth"]["gru"],
                  str(out), *extra, *SMALL])
    assert exc.value.code == 2
    assert message in capsys.readouterr().err
    assert os.listdir(tmp_path) == []


def _reference_streaming_fasta(project, kind, out):
    """``roko-tpu polish``'s default engine on the same weights."""
    cfg = RokoConfig(model=JaxModelConfig(kind=kind, hidden_size=16, num_layers=2))
    ref_streaming_polish(project["draft_fasta"], project["reads_bam"], project["params"][kind],
                         cfg, out_path=out, seed=0, batch_size=32, workers=2,
                         log=lambda *a: None)
    return Path(out).read_bytes()


@pytest.mark.parametrize("kind", list(KINDS))
def test_polish_streams_by_default_byte_identical_to_reference(project, tmp_path, capsys, kind):
    got = tmp_path / "port.fasta"
    assert cli.main(["polish", project["draft_fasta"], project["reads_bam"], project["pth"][kind],
                     str(got), "--b", "32", "--t", "2", "--model-kind", kind, *SMALL]) == 0
    out = capsys.readouterr().out
    assert "streaming polish:" in out and "padding_efficiency" in out
    assert "wrote polished contigs" in out
    assert not Path(str(got) + ".resume").exists()  # the journal is removed on success
    want = _reference_streaming_fasta(project, kind, str(tmp_path / "ref.fasta"))
    assert len(want) > 3000
    assert got.read_bytes() == want


@pytest.mark.parametrize("staged", [False, True], ids=["streaming", "staged"])
def test_polish_truth_prints_the_reference_report(project, tmp_path, capsys, staged):
    from roko_tpu.cli import _print_assess as ref_print_assess

    out = tmp_path / "o.fasta"
    argv = ["polish", project["draft_fasta"], project["reads_bam"], project["pth"]["gru"],
            str(out), "--b", "32", "--truth", project["truth_fasta"], *SMALL]
    assert cli.main(argv + (["--staged"] if staged else [])) == 0
    got = capsys.readouterr().out
    ref_print_assess(str(out), project["truth_fasta"])
    want = capsys.readouterr().out
    assert "TOTAL" in want and "Q" in want
    assert got.endswith(want)


def test_polish_without_card_refuses_cuda_before_extraction(project, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["polish", project["draft_fasta"], project["reads_bam"], project["pth"]["gru"],
                  str(tmp_path / "o.fasta"), "--staged", "--keep-hdf5", str(tmp_path / "k.hdf5"),
                  "--hidden-size", "16", "--num-layers", "2"])
    assert os.listdir(tmp_path) == []
