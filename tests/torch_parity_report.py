"""Prints the CPU parity numbers of the PyTorch port against the JAX
package as JSON: max |delta| per tensor for the GRU layer and stack cases
of ``test_torch_gru.py``, for the logits of ``test_torch_model.py``, and
whether the polished FASTA of ``test_torch_cli.py``'s flow is
byte-identical. Run from the repo root:

    JAX_PLATFORMS=cpu python -m tests.torch_parity_report
"""

import json
import os
import tempfile
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("ROKO_COMPILE_CACHE", "off")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import roko_tpu.models.pallas_gru as pg  # noqa: E402
from roko_tpu.models import gru as jgru  # noqa: E402
from roko_tpu_torch.models import fused_gru as fg  # noqa: E402
from tests import test_torch_cli, test_torch_gru, test_torch_model  # noqa: E402


def _gru_rows():
    rows = {}
    for case, (B, in_size, H, patch) in test_torch_gru.CASES.items():
        with pytest.MonkeyPatch.context() as mp:
            test_torch_gru._patch(mp, patch)
            rng = np.random.default_rng(10)
            layer = test_torch_gru._layer(rng, in_size, H)
            x = rng.standard_normal((B, 90, in_size)).astype(np.float32)
            got = fg.fused_bidir_layer(test_torch_gru._torch(layer), torch.from_numpy(x)).numpy()
            jl, jx = test_torch_gru._jax(layer), jnp.asarray(x)
            pallas = np.asarray(pg.fused_bidir_layer(jl, jx, interpret=True))
            scan = np.asarray(jgru.bidir_layer(jl, jx))
        rows[case] = {
            "layer_vs_pallas": float(np.abs(got - pallas).max()),
            "layer_vs_scan": float(np.abs(got - scan).max()),
        }
    return rows


def _logit_rows():
    rows = {}
    for name, cfg in test_torch_model.CONFIGS.items():
        params = test_torch_model._jax_params(cfg)
        x = test_torch_model._windows(2)
        want = np.asarray(test_torch_model.JaxRokoModel(cfg).apply(params, x))
        model = test_torch_model.RokoModel(test_torch_model._port_config(cfg))
        model.load_state_dict(test_torch_model.state_dict_from_jax(params), strict=True)
        with torch.inference_mode():
            got = model(torch.from_numpy(x)).numpy()
        rows[name] = {"logits_max_abs": float(np.abs(got - want).max()),
                      "argmax_equal": bool((got.argmax(-1) == want.argmax(-1)).all())}
    return rows


def _fasta_row():
    with tempfile.TemporaryDirectory() as d:
        project = test_torch_cli.make_project(Path(d))
        want, got = os.path.join(d, "jax.fasta"), os.path.join(d, "port.fasta")
        cfg = test_torch_cli.RokoConfig(model=test_torch_cli.CFG)
        test_torch_cli.jax_polish_to_fasta(
            project["h5"], test_torch_cli.load_torch_checkpoint(project["pth"], test_torch_cli.CFG),
            want, cfg, batch_size=16, log=lambda *a: None)
        test_torch_cli.cli.main(["inference", project["h5"], project["pth"], got, "--b", "16",
                                 "--hidden-size", "16", "--num-layers", "2", "--device", "cpu"])
        a, b = open(got, "rb").read(), open(want, "rb").read()
        return {"windows": project["windows"], "fasta_bytes": len(a), "byte_identical": a == b}


def main():
    print(json.dumps({"gru": _gru_rows(), "model": _logit_rows(), "cli": _fasta_row(),
                      "torch": torch.__version__, "jax": jax.__version__}, indent=1))


if __name__ == "__main__":
    main()
