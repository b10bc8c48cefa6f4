"""Prints the CPU parity numbers of the PyTorch port against the JAX
package as JSON: max |delta| per tensor for the GRU layer and stack cases
of ``test_torch_gru.py``, for the logits of ``test_torch_model.py``,
whether the polished FASTA of ``test_torch_cli.py``'s flow is
byte-identical, the layer gradients of ``test_torch_gru_bwd.py``, the
full-model train step and Adam step of ``test_torch_train.py``, the
short run of ``test_torch_train_loop.py``, and for ``kind="lingru"`` the
layer, stack, gradient, scan-loop and logit cases of
``test_torch_lingru.py``, its train steps and its FASTA. Run from the
repo root:

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
import roko_tpu.models.pallas_lingru as pli  # noqa: E402
from roko_tpu.models import lingru as jlin  # noqa: E402
from roko_tpu_torch.models import fused_lingru as fl  # noqa: E402
from tests import (  # noqa: E402
    test_torch_cli,
    test_torch_gru,
    test_torch_gru_bwd,
    test_torch_lingru,
    test_torch_model,
    test_torch_train,
    test_torch_train_loop,
)


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


def _grad_rows():
    """Layer gradients against jax.grad through the Pallas backward."""
    rows = {}
    for case, (B, in_size, H, patch) in test_torch_gru_bwd.CASES.items():
        with pytest.MonkeyPatch.context() as mp:
            test_torch_gru_bwd._patch(mp, patch)
            rng = np.random.default_rng(20)
            layer = test_torch_gru_bwd._layer(rng, in_size, H)
            x = rng.standard_normal((B, 90, in_size)).astype(np.float32)
            g = rng.standard_normal((B, 90, 2 * H)).astype(np.float32)
            want_layer, want_x = jax.grad(
                lambda lyr, xx: (pg.fused_bidir_layer(lyr, xx, interpret=True) * g).sum(),
                argnums=(0, 1))(jax.tree.map(jnp.asarray, layer), jnp.asarray(x))
        got_layer, got_x = test_torch_gru_bwd._port_grads(layer, x, g)
        row = {f"{d}.{k}": float(np.abs(got_layer[d][k] - np.asarray(want_layer[d][k])).max())
               for d in got_layer for k in got_layer[d]}
        row["x"] = float(np.abs(got_x - np.asarray(want_x)).max())
        rows[case] = row
    return rows


def _step_rows():
    """Full-model train step (dropout 0) and one Adam step."""
    import dataclasses

    jcfg = test_torch_train.JaxModelConfig
    rows = {}
    for name, cfg, n, n_real in (
        ("tiny_gru", test_torch_train.TINY_GRU, 6, 4),
        ("default", dataclasses.replace(jcfg(), dropout=0.0), 3, 2),
        ("tiny_lin", test_torch_train.TINY_LIN, 6, 4),
        ("default_lingru", dataclasses.replace(jcfg(kind="lingru"), dropout=0.0), 3, 2),
    ):
        r = test_torch_train.step_against_reference(cfg, n, n_real)
        row = {"loss": abs(r["loss"][0] - r["loss"][1]),
               "counts_equal": r["counts"][0] == r["counts"][1],
               "grads": {p: float(np.abs(a - b).max()) for p, (a, b) in r["grads"].items()}}
        got, want = test_torch_train.adam_step_against_reference(r["params"], r["jgrads"],
                                                                 r["model"])
        row["adam_params_max_abs"] = max(float(np.abs(a - b).max())
                                         for (_, a), (_, b) in zip(got, want))
        rows[name] = row
    return rows


def _short_run_row():
    with tempfile.TemporaryDirectory() as d:
        history, want = test_torch_train_loop.short_run_against_reference(Path(d))
    return {"port_val_acc": [h["val_acc"] for h in history], "jax_val_acc": want,
            "port_train_loss": [h["train_loss"] for h in history]}


def _max(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _lingru_rows():
    """Layer and stack outputs against the Pallas kernel in interpret
    mode and the associative scan; layer gradients against the Pallas
    VJP; the plain scan loops against ``_run_fwd`` / ``_run_bwd``."""
    t = test_torch_lingru
    rows = {}
    for case, (B, T, budget) in {"b4_t90": (4, 90, None), "b11_t24": (11, 24, None),
                                 "b1_t24": (1, 24, None),
                                 "multi_time_block": (3, 40, 16 * 1024)}.items():
        with pytest.MonkeyPatch.context() as mp:
            if budget:
                mp.setattr(pli, "_VMEM_BUDGET", budget)
            in_size, H = (10, 12) if budget else (12, 16)
            layer = t._params(in_size, H, 1, 3)[0]
            x, w = t._x(1, (B, T, in_size)), t._x(2, (B, T, 2 * H))
            got, pallas, scan = t._layer_outputs(layer, x)
            (gp, gx) = t._port_grads(layer, x, w, fl.bidir_lingru_layer)
            wp, wx = t._jax_grads(layer, x, w, lambda p, xx: pli.bidir_lingru_layer_pallas(
                p, xx, interpret=True))
        rows[case] = {"layer_vs_pallas": _max(got, pallas), "layer_vs_scan": _max(got, scan),
                      "grads_vs_pallas_vjp": max(
                          [_max(a, b) for a, b in zip(jax.tree.leaves(gp), jax.tree.leaves(wp))]
                          + [_max(gx, wx)])}
    params = t._params(12, 16, 3, 5)
    x = t._x(2, (4, 60, 12))
    got = fl.bidir_lingru_stack(t._torch(params), torch.from_numpy(x)).numpy()
    rows["stack3_t60"] = {
        "stack_vs_pallas": _max(got, pli.bidir_lingru_stack_pallas(
            t._jax(params), jnp.asarray(x), interpret=True)),
        "stack_vs_scan": _max(got, jlin.bidir_lingru_stack(t._jax(params), jnp.asarray(x)))}
    B, T, H, Bp = 5, 40, 12, 8
    rng = np.random.default_rng(30)
    p = rng.standard_normal((B, T, 4 * H)).astype(np.float32)
    dy = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    h = fl.lingru_scan_plain(torch.from_numpy(p))
    dp = fl.lingru_scan_backward_plain(torch.from_numpy(p), h, torch.from_numpy(dy)).numpy()
    h = h.numpy()
    ps = jnp.asarray(t._tpu_stack(p.reshape(B, T, 2, 2 * H), Bp))
    hs = t._tpu_unstack(np.asarray(pli._run_fwd(ps, interpret=True)), B, Bp)
    dps = pli._run_bwd(ps, jnp.asarray(t._tpu_stack(h.reshape(B, T, 2, H), Bp)),
                       jnp.asarray(t._tpu_stack(dy.reshape(B, T, 2, H), Bp)), interpret=True)
    rows["scan_loops_vs_run_fwd_run_bwd"] = {
        "h": _max(h, hs.reshape(B, T, 2 * H)),
        "dp": _max(dp, t._tpu_unstack(np.asarray(dps), B, Bp).reshape(B, T, 4 * H))}
    return rows


def _lingru_logit_rows():
    import dataclasses

    t = test_torch_lingru
    rows = {}
    for name, cfg in t.MODELS.items():
        params = jax.tree.map(np.asarray, t.JaxRokoModel(cfg).init(jax.random.PRNGKey(0)))
        x = t._windows(2)
        model = t.RokoModel(t._port_config(cfg))
        model.load_state_dict(t.state_dict_from_jax(params), strict=True)
        with torch.inference_mode():
            got = model(torch.from_numpy(x)).numpy()
        scan = np.asarray(t.JaxRokoModel(cfg).apply(params, x))
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("ROKO_PALLAS_INTERPRET", "1")
            pallas = np.asarray(t.JaxRokoModel(dataclasses.replace(cfg, use_pallas=True))
                                .apply(params, x))
        rows[name] = {"logits_vs_scan": _max(got, scan), "logits_vs_pallas": _max(got, pallas),
                      "argmax_equal": bool((got.argmax(-1) == scan.argmax(-1)).all())}
    return rows


def _lingru_fasta_row():
    with tempfile.TemporaryDirectory() as d:
        root = Path(d)
        project = test_torch_cli.make_project(root)
        params, pth = test_torch_cli.lingru_pth(root)
        want, got = str(root / "jax.fasta"), str(root / "port.fasta")
        test_torch_cli.jax_polish_to_fasta(
            project["h5"], params, want, test_torch_cli.RokoConfig(model=test_torch_cli.CFG_LIN),
            batch_size=16, log=lambda *a: None)
        test_torch_cli.cli.main(["inference", project["h5"], pth, got, "--b", "16",
                                 "--model-kind", "lingru", *test_torch_cli.SMALL])
        a, b = open(got, "rb").read(), open(want, "rb").read()
        return {"windows": project["windows"], "fasta_bytes": len(a), "byte_identical": a == b}


def main():
    print(json.dumps({"gru": _gru_rows(), "model": _logit_rows(), "cli": _fasta_row(),
                      "gru_grads": _grad_rows(), "train_step": _step_rows(),
                      "short_run": _short_run_row(),
                      "lingru": _lingru_rows(), "lingru_model": _lingru_logit_rows(),
                      "lingru_cli": _lingru_fasta_row(),
                      "torch": torch.__version__, "jax": jax.__version__}, indent=1))


if __name__ == "__main__":
    main()
