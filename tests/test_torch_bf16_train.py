"""bfloat16 training of the port against ``roko_tpu`` on the CPU, at tiny
widths (embed 8, read MLP 8->4, hidden 16, 2 layers, dropout 0; inputs and
weights from numpy seeds):

- each bf16 plain backward twin (the kernels' CPU stand-ins) through its
  layer against ``jax.vjp`` of the reference's Pallas layer in interpret
  mode with bf16 params and input (``pallas_gru.fused_bidir_layer(...,
  compute_dtype=bfloat16)``, ``pallas_lingru.bidir_lingru_layer_pallas``),
  for dx and every layer gradient;
- the twins by hand: the gru one keeps ``dh``, ``dW_hh`` and ``db_hh`` in
  f32, rounds ``dhp`` to bf16 only as a product's operand, sums ``db_hh``
  from the unrounded ``dhp`` and stores ``dxp`` in bf16; the lingru one
  keeps ``e`` in f32 and stores ``dp`` in bf16;
- one whole-model bf16 train step of each kind against ``jax.grad`` of
  ``RokoModel(compute_dtype="bfloat16", use_pallas=True).apply(
  deterministic=False)``: the loss and every parameter gradient, which
  stay float32 and equal their own bf16 rounding wherever the reference's
  do (every parameter but the float32 head);
- ``train --compute-dtype bfloat16 --device cpu`` of both kinds: it runs,
  its checkpoints verify and they load into float32 ``inference``.

The reference runs its Pallas route as ``bf16_route_logits`` in
``test_torch_precision.py`` puts it there: for gru the tests patch
``roko_tpu.models.gru._pallas_backend`` and bind ``interpret=True`` into
``bidir_gru_stack_pallas``, for lingru they set ``ROKO_PALLAS_INTERPRET=1``;
no file of the JAX package changes. Each reference gradient is computed
once, in a module-scoped fixture.

The bar of each gradient tensor: its max |delta| from the reference's bf16
route is at most 2e-2 of its largest entry, and below the route's own
distance from the reference's float32 gradient. One kind of tensor is
held otherwise: a bias whose reference gradient comes from ``jax.grad``
of a bf16 ``x @ w + b`` (fc1's and fc2's, lingru's ``b_z`` and ``b_c``).
XLA on the CPU sums that transpose in bf16, one row at a time
(``test_reference_sums_a_bf16_bias_gradient_in_bf16``), and the error of
that sum is most of the route's distance from f32, where the port sums
in f32 and rounds once. So the layer test holds such a bias to the
reference's cotangent summed in f32: the layer's input carries a column
of ones with a zero weight row, whose weight gradient is that sum (a bf16
product, summed in f32 and rounded once), within one bf16 ulp. The model
test holds it within the route's distance plus one bf16 ulp.
"""

import dataclasses
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roko_tpu.models.gru as ref_gru
import roko_tpu.models.pallas_gru as ref_pallas_gru
from roko_tpu.config import ModelConfig as JaxModelConfig
from roko_tpu.models import RokoModel as JaxRokoModel
from roko_tpu.models.pallas_lingru import bidir_lingru_layer_pallas
from roko_tpu.training.loop import _loss_and_stats
from roko_tpu_torch import cli
from roko_tpu_torch import constants as C
from roko_tpu_torch.config import ModelConfig
from roko_tpu_torch.features.pipeline import run_features
from roko_tpu_torch.io.fasta import read_fasta
from roko_tpu_torch.models import fused_gru as fg
from roko_tpu_torch.models import fused_lingru as fl
from roko_tpu_torch.models.convert import jax_from_state_dict, state_dict_from_jax
from roko_tpu_torch.models.model import RokoModel
from roko_tpu_torch.sim import build_synthetic_project
from roko_tpu_torch.training import checkpoint as ck
from roko_tpu_torch.training.loop import loss_and_stats
from tests.test_torch_precision import TINY, _bf16_layer
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

KINDS = ("gru", "lingru")
#: a gradient against the reference's bf16 route: at most this share of
#: its largest entry (bf16 keeps 8 bits, 4e-3 relative, and each layer
#: rounds its dx, dW and db once more on the way down)
REL_BAR = 2e-2
#: one layer: batch 3 (the reference pads its rows to 16 and 8), T 9
LAYER_SHAPE = dict(B=3, T=9, IN=12, H=16)
#: kind -> the input matrices of a layer direction, and the bias each
#: one's last row (the ones column's) sums the cotangent of
INPUT_MATRICES = {"gru": {"w_ih": "b_ih"}, "lingru": {"w_zx": "b_z", "w_cx": "b_c"}}
SMALL = ["--hidden-size", "16", "--num-layers", "2", "--device", "cpu"]


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7) if x > 0 else 0.0


def summed_in_bf16(kind: str, path: str) -> bool:
    """Whether the reference's gradient at ``path`` is XLA's bf16 sum of a
    bias's cotangent (the module docstring)."""
    if "['fc1']['bias']" in path or "['fc2']['bias']" in path:
        return True
    return kind == "lingru" and ("['b_z']" in path or "['b_c']" in path)


def check_gradient(name, got, want, f32, slack=0.0):
    """The bar of the module docstring, the route's distance widened by
    ``slack``; returns (max |d|, route distance)."""
    d = float(np.abs(got - want).max())
    route = float(np.abs(want - f32).max())
    top = float(np.abs(want).max())
    assert d <= REL_BAR * top, (name, d, top)
    assert d < route + slack, (name, d, route, slack)
    return d, route


def _paths(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# -- one layer through the plain twins -------------------------------------------


def layer_gradients(kind):
    """(port, reference bf16, reference f32): {path: gradient} of one
    layer's params and its input, for one cotangent."""
    B, T, IN, H = (LAYER_SHAPE[k] for k in ("B", "T", "IN", "H"))
    rng = np.random.default_rng(11 if kind == "gru" else 12)
    layer = _bf16_layer(rng, kind, IN, H)
    x = rng.standard_normal((B, T, IN)).astype(np.float32)
    dy = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    # the last input column is ones and its weight rows zero: the gradient
    # of those rows is each bias's cotangent summed in f32
    x[..., -1] = 1.0
    for d in layer.values():
        for name in INPUT_MATRICES[kind]:
            d[name][-1] = 0.0

    def ref(dtype):
        jl = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), layer)
        if kind == "gru":
            fn = functools.partial(ref_pallas_gru.fused_bidir_layer, interpret=True,
                                   compute_dtype=dtype)
        else:
            fn = functools.partial(bidir_lingru_layer_pallas, interpret=True)
        y, vjp = jax.vjp(fn, jl, jnp.asarray(x).astype(dtype))
        gl, gx = vjp(jnp.asarray(dy).astype(y.dtype))
        return _paths({"layer": gl, "x": gx})

    tl = jax.tree.map(lambda a: torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True),
                      layer)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    if kind == "gru":
        y = fg.fused_bidir_layer(tl, tx)
    else:
        y = fl.bidir_lingru_layer(tl, tx)
    assert y.dtype == torch.bfloat16
    y.backward(torch.from_numpy(dy).to(torch.bfloat16))
    got = {"layer": jax.tree.map(lambda t: t.grad, tl), "x": tx.grad}
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(got))
    got = _paths(jax.tree.map(lambda t: t.float().numpy(), got))
    return got, ref(jnp.bfloat16), ref(jnp.float32)


@pytest.fixture(scope="module")
def layer_grads():
    return {kind: layer_gradients(kind) for kind in KINDS}


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_layer_gradients_follow_reference_pallas_route(layer_grads, kind):
    got, want, f32 = layer_grads[kind]
    assert set(got) == set(want) and len(got) == 9  # 2 directions x 4 params, and dx
    for path in want:
        if not summed_in_bf16(kind, path):
            check_gradient(path, got[path], want[path], f32[path])
    for direction in ("fwd", "bwd"):
        for w, b in INPUT_MATRICES[kind].items():
            key = f"['layer']['{direction}']"
            summed = want[f"{key}['{w}']"][-1]  # the reference's cotangent, summed in f32
            bias = got[f"{key}['{b}']"]
            assert np.abs(bias - summed).max() <= bf16_ulp(np.abs(summed).max()), (key, b)
            assert np.abs(bias - want[f"{key}['{b}']"]).max() <= REL_BAR * np.abs(summed).max()


# -- the twins by hand ----------------------------------------------------------


def _bf16_inputs(rng, B, T, H):
    xp = rng.standard_normal((B, T, 2 * 3 * H)).astype(np.float32)
    w = rng.uniform(-0.3, 0.3, (2, H, 3 * H)).astype(np.float32)
    b = rng.uniform(-0.3, 0.3, (2, 3 * H)).astype(np.float32)
    return [torch.from_numpy(a).to(torch.bfloat16) for a in (xp, w, b)]


def test_bf16_gru_backward_twin_rounds_as_the_kernel():
    """dh, dW_hh and db_hh in f32; dhp rounded to bf16 as the two
    products' operand only, db_hh summing it unrounded; dxp stored in
    bf16; the CPU wrapper routes bf16 to the twin and the autograd
    function hands dW_hh and db_hh back rounded to bf16 once."""
    B, T, H = 2, 6, 8
    rng = np.random.default_rng(3)
    xp, w, b = _bf16_inputs(rng, B, T, H)
    out = fg.gru_recurrence_plain(xp, w, b)
    dy = torch.from_numpy(rng.standard_normal((B, T, 2 * H)).astype(np.float32)).bfloat16()
    dxp, dw, db = fg.gru_recurrence_backward_plain(xp, w, b, out, dy)
    assert (dxp.dtype, dw.dtype, db.dtype) == (torch.bfloat16, torch.float32, torch.float32)
    routed = fg.gru_recurrence_backward(xp, w, b, out, dy)
    assert all(torch.equal(a, c) for a, c in zip(routed, (dxp, dw, db)))

    # the loop of the docstring, by hand, for direction 0 (t = T-1 .. 0)
    x, wf, bf, hs, g = (t.float() for t in (xp, w, b, out, dy))
    dh = torch.zeros(B, H)
    dw0, db0, db_rounded = torch.zeros(H, 3 * H), torch.zeros(3 * H), torch.zeros(3 * H)
    for t in range(T - 1, -1, -1):
        h_prev = hs[:, t - 1, :H] if t > 0 else torch.zeros(B, H)
        hp = h_prev @ wf[0] + bf[0]
        xt = x[:, t, : 3 * H]
        r = torch.sigmoid(xt[:, :H] + hp[:, :H])
        z = torch.sigmoid(xt[:, H : 2 * H] + hp[:, H : 2 * H])
        n = torch.tanh(xt[:, 2 * H :] + r * hp[:, 2 * H :])
        dh = dh + g[:, t, :H]
        dz = dh * (h_prev - n) * z * (1.0 - z)
        dn = dh * (1.0 - z) * (1.0 - n * n)
        dr = dn * hp[:, 2 * H :] * r * (1.0 - r)
        dhp = torch.cat([dr, dz, dn * r], dim=-1)
        want = torch.cat([dr, dz, dn], dim=-1).bfloat16()
        assert torch.equal(dxp[:, t, : 3 * H], want), t
        operand = dhp.bfloat16().float()
        dh = dh * z + operand @ wf[0].t()
        dw0 = dw0 + h_prev.t() @ operand
        db0 = db0 + dhp.sum(dim=0)
        db_rounded = db_rounded + operand.sum(dim=0)
    # f32 sums of f32 products: the hand loop's 2-D products and the twin's
    # batched ones may round their last bit apart
    torch.testing.assert_close(dw[0], dw0, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(db[0], db0, rtol=1e-6, atol=1e-6)
    # the unrounded dhp is what db_hh sums: its rounding moves db far more
    assert (db0 - db_rounded).abs().max() > 1e-4

    xs, ws, bs = (t.clone().requires_grad_(True) for t in (xp, w, b))
    fg.gru_recurrence(xs, ws, bs).backward(dy)
    assert torch.equal(xs.grad, dxp)
    assert ws.grad.dtype == bs.grad.dtype == torch.bfloat16
    assert torch.equal(ws.grad, dw.bfloat16()) and torch.equal(bs.grad, db.bfloat16())


def test_bf16_lingru_backward_twin_keeps_an_f32_e():
    """e, the gates and dp's arithmetic in f32 from widened inputs, dp
    stored rounded to bf16; the CPU wrapper routes bf16 to the twin."""
    B, T, H = 3, 7, 5
    rng = np.random.default_rng(4)
    p = torch.from_numpy(rng.standard_normal((B, T, 4 * H)).astype(np.float32)).bfloat16()
    h = fl.lingru_scan_plain(p)
    dy = torch.from_numpy(rng.standard_normal((B, T, 2 * H)).astype(np.float32)).bfloat16()
    dp = fl.lingru_scan_backward_plain(p, h, dy)
    assert dp.dtype == torch.bfloat16
    assert torch.equal(fl.lingru_scan_backward(p, h, dy), dp)
    # by hand for direction 0, whose walk runs t = T-1 .. 0
    pf, hf, gf = p.float(), h.float(), dy.float()
    z, c = torch.sigmoid(pf[..., :H]), torch.tanh(pf[..., H : 2 * H])
    e = torch.zeros(B, H)
    for t in range(T - 1, -1, -1):
        g = gf[:, t, :H] + e
        h_prev = hf[:, t - 1, :H] if t > 0 else torch.zeros(B, H)
        zt, ct = z[:, t], c[:, t]
        dz = g * ct - g * h_prev
        want = torch.cat([dz * (zt * (1.0 - zt)), g * zt * (1.0 - ct * ct)], dim=-1)
        assert torch.equal(dp[:, t, : 2 * H], want.bfloat16()), t
        e = (1.0 - zt) * g
    # the f32 twin on the widened inputs, rounded once at the end
    assert torch.equal(dp, fl.lingru_scan_backward_plain(p.float(), h.float(), dy.float())
                       .bfloat16())


# -- one whole-model train step ---------------------------------------------------


def _batch(n, n_real, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, C.FEATURE_VOCAB, (n, C.WINDOW_ROWS, C.WINDOW_COLS), dtype=np.uint8)
    y = rng.integers(0, C.NUM_CLASSES, (n, C.WINDOW_COLS)).astype(np.int32)
    w = (np.arange(n) < n_real).astype(np.float32)  # padding rows weigh 0
    return x, y, w


def step_gradients(kind):
    """(port, reference bf16, reference f32): (loss, {path: gradient}) of
    one train step on the same params and batch."""
    cfg = JaxModelConfig(kind=kind, dropout=0.0, **TINY)
    params = jax.tree.map(np.asarray, JaxRokoModel(cfg).init(jax.random.PRNGKey(1)))
    x, y, w = _batch(4, 3)

    def ref(dtype):
        model = JaxRokoModel(dataclasses.replace(cfg, compute_dtype=dtype, use_pallas=True))
        (loss, _), grads = jax.value_and_grad(
            lambda p: _loss_and_stats(model, p, x, y, w, jax.random.PRNGKey(9)), has_aux=True
        )(params)
        return float(loss), _paths(grads)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_gru, "_pallas_backend", lambda: True)
        mp.setattr(ref_pallas_gru, "bidir_gru_stack_pallas", functools.partial(
            ref_pallas_gru.bidir_gru_stack_pallas, interpret=True))
        mp.setenv("ROKO_PALLAS_INTERPRET", "1")
        want, f32 = ref("bfloat16"), ref("float32")

    model = RokoModel(ModelConfig(kind=kind, dropout=0.0, compute_dtype="bfloat16", **TINY))
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    model.train()
    loss, _, _ = loss_and_stats(model(torch.from_numpy(x)), torch.from_numpy(y),
                                torch.from_numpy(w))
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert all(g.dtype == torch.float32 for g in grads.values())
    return (loss.item(), _paths(jax_from_state_dict(grads))), want, f32


@pytest.fixture(scope="module")
def step_grads():
    return {kind: step_gradients(kind) for kind in KINDS}


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_train_step_follows_reference_pallas_route(step_grads, kind):
    (loss, got), (want_loss, want), (f32_loss, f32) = step_grads[kind]
    assert abs(loss - want_loss) < abs(want_loss - f32_loss), (loss, want_loss, f32_loss)
    assert set(got) == set(want)
    assert len(got) == 7 + 2 * 2 * 4  # embedding, fc1, fc2, head; 2 layers x 2 directions
    for path in want:
        slack = bf16_ulp(np.abs(want[path]).max()) if summed_in_bf16(kind, path) else 0.0
        check_gradient(path, got[path], want[path], f32[path], slack)


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_train_step_gradients_are_rounded_where_the_references_are(step_grads, kind):
    """float32 gradients that equal their own bf16 rounding: every
    parameter's but the head's, which runs in float32 in both."""
    (_, got), (_, want), _ = step_grads[kind]

    def is_bf16(a):
        return np.array_equal(a, torch.tensor(a).bfloat16().float().numpy())

    for path in want:
        assert is_bf16(got[path]) == is_bf16(want[path]) == ("head" not in path), path


def test_reference_sums_a_bf16_bias_gradient_in_bf16():
    """Why the bar has its ulp floor: the reference's gradient of ``b`` in
    ``x @ w + b`` (bf16) is XLA's bf16 sum of the cotangent, one row at a
    time, where the port's autograd sums in f32 and rounds once."""
    rng = np.random.default_rng(5)
    g = rng.standard_normal((3, 9, 64)).astype(np.float32)
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    bias = jax.grad(lambda b: jnp.sum((jnp.zeros((3, 9, 64), jnp.bfloat16) + b) * gb))(
        jnp.zeros(64, jnp.bfloat16))
    rowwise = jnp.zeros(64, jnp.bfloat16)
    for row in gb.reshape(-1, 64):
        rowwise = rowwise + row
    assert np.array_equal(np.asarray(bias, np.float32), np.asarray(rowwise, np.float32))
    b = torch.zeros(64, dtype=torch.bfloat16, requires_grad=True)
    (torch.zeros(3, 9, 64, dtype=torch.bfloat16) + b).backward(
        torch.from_numpy(g).bfloat16())
    once = torch.from_numpy(g).bfloat16().float().sum(dim=(0, 1)).bfloat16()
    assert torch.equal(b.grad, once)
    assert not np.array_equal(b.grad.float().numpy(), np.asarray(bias, np.float32))


# -- the command line -------------------------------------------------------------


@pytest.fixture(scope="module")
def sim_features(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_bf16_train_cli")
    paths = build_synthetic_project(str(root / "sim"), genome_len=3000, seed=11)
    train_h5, infer_h5 = str(root / "train.hdf5"), str(root / "infer.hdf5")
    run_features(paths["draft_fasta"], paths["reads_bam"], train_h5,
                 bam_y=paths["truth_bam"], seed=5, log=lambda *a: None)
    run_features(paths["draft_fasta"], paths["reads_bam"], infer_h5, seed=5,
                 log=lambda *a: None)
    return {"root": root, "train": train_h5, "infer": infer_h5}


@pytest.mark.parametrize("kind", KINDS)
def test_cli_trains_in_bf16_and_polishes_in_f32(sim_features, kind, capsys):
    root = sim_features["root"]
    ckpt, out = str(root / f"ckpt_{kind}"), str(root / f"out_{kind}.fa")
    flags = ["--model-kind", kind, *SMALL]
    assert cli.main(["train", sim_features["train"], ckpt, "--b", "8", "--epochs", "2",
                     "--compute-dtype", "bfloat16", *flags]) == 0
    losses = [float(v) for v in re.findall(r"train_loss ([0-9.]+)", capsys.readouterr().out)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    for name in os.listdir(ckpt):
        assert ck.verify_manifest(os.path.join(ckpt, name))[0] == "ok", name
    params = ck.load_params(ckpt)
    assert all(t.dtype == torch.float32 for t in params.values())
    assert any(k.startswith(f"{kind}.") for k in params)
    # a float32 inference of the bf16-trained checkpoint
    assert cli.main(["inference", sim_features["infer"], ckpt, out, "--b", "16",
                     "--compute-dtype", "float32", *flags]) == 0
    records = list(read_fasta(out))
    assert records and set(records[0][1]) <= set("ACGT")
