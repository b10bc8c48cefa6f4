"""The port's ``kind="lingru"`` on the CPU against the JAX package: the
layer and stack (plain scan loops) against ``bidir_lingru_layer_pallas``
in interpret mode, the associative-scan path and the per-step
``lingru_direction(naive=True)``; gradients against ``jax.grad`` through
the Pallas VJP (``_bwd_kernel``); the plain backward against ``_run_bwd``
on the same arrays; full-model logits against ``RokoModel.apply``; the
init; and the scan wrapper's CPU contract."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import roko_tpu.models.pallas_lingru as pli
from roko_tpu import constants as JC
from roko_tpu.config import ModelConfig as JaxModelConfig
from roko_tpu.models import RokoModel as JaxRokoModel
from roko_tpu.models import lingru as jlin
from roko_tpu_torch.config import ModelConfig
from roko_tpu_torch.models import fused_lingru as fl
from roko_tpu_torch.models.convert import state_dict_from_jax
from roko_tpu_torch.models.model import RokoModel
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = ATOL = 1e-5  # outputs: f32 on both sides, only the scan order differs
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6  # tests/test_pallas_lingru.py's gradient bar
LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-5  # the port's full-model bar

TINY_LIN = JaxModelConfig(kind="lingru", embed_dim=8, read_mlp=(8, 4), hidden_size=16,
                          num_layers=2)
MODELS = {"default": JaxModelConfig(kind="lingru"), "tiny_lin": TINY_LIN}
_FIELDS = ("kind", "embed_vocab", "window_rows", "window_cols", "embed_dim", "read_mlp",
           "hidden_size", "num_layers", "num_classes")


def _params(in_size, hidden, layers, seed):
    """JAX-initialised lingru layers as numpy arrays."""
    tree = jlin.RokoLinGRU(in_size, hidden, layers, 0.0).init(jax.random.PRNGKey(seed))
    return jax.tree.map(np.array, tree)


def _torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _layer_outputs(layer, x):
    """(port, Pallas interpret, associative scan) outputs of one layer."""
    got = fl.bidir_lingru_layer(_torch(layer), torch.from_numpy(x)).numpy()
    jl, jx = _jax(layer), jnp.asarray(x)
    pallas = np.asarray(pli.bidir_lingru_layer_pallas(jl, jx, interpret=True))
    scan = np.asarray(jlin.bidir_lingru_layer(jl, jx))
    return got, pallas, scan


# -- forward ---------------------------------------------------------------------


def test_layer_matches_pallas_scan_and_naive():
    """T = 90, B = 4, H = 16: the kernel's plain twin against the Pallas
    kernel, the associative scan, and the per-step oracle."""
    layer = _params(12, 16, 1, 3)[0]
    x = _x(1, (4, 90, 12))
    got, pallas, scan = _layer_outputs(layer, x)
    jl, jx = _jax(layer), jnp.asarray(x)
    naive = np.concatenate([
        np.asarray(jlin.lingru_direction(jl["fwd"], jx, naive=True)),
        np.asarray(jlin.lingru_direction(jl["bwd"], jx, reverse=True, naive=True)),
    ], axis=-1)
    assert got.shape == (4, 90, 32)
    for want in (pallas, scan, naive):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_stack_matches_pallas_and_scan():
    params = _params(12, 16, 3, 5)
    x = _x(2, (4, 60, 12))
    got = fl.bidir_lingru_stack(_torch(params), torch.from_numpy(x)).numpy()
    pallas = np.asarray(pli.bidir_lingru_stack_pallas(_jax(params), jnp.asarray(x),
                                                      interpret=True))
    scan = np.asarray(jlin.bidir_lingru_stack(_jax(params), jnp.asarray(x)))
    for want in (pallas, scan):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("batch", [11, 1])
def test_odd_batch_needs_no_padding(batch):
    """The reference pads the rows to a multiple of 8; the port does not."""
    layer = _params(12, 16, 1, 13)[0]
    got, pallas, scan = _layer_outputs(layer, _x(batch, (batch, 24, 12)))
    assert got.shape == (batch, 24, 32)
    for want in (pallas, scan):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# -- gradients -------------------------------------------------------------------


def _port_grads(layers, x, w, fn):
    """Gradients of mean(fn(layers, x) * w) in the port: (layers, x)."""
    tl = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), layers)
    tx = torch.tensor(x, requires_grad=True)
    (fn(tl, tx) * torch.from_numpy(w)).mean().backward()
    return jax.tree.map(lambda t: t.grad.numpy(), tl), tx.grad.numpy()


def _jax_grads(layers, x, w, fn):
    g = jax.grad(lambda p, xx: (fn(p, xx) * w).mean(), argnums=(0, 1))(
        _jax(layers), jnp.asarray(x))
    return jax.tree.map(np.asarray, g)


def _assert_grads_close(got, want):
    (gp, gx), (wp, wx) = got, want
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(gp)[0],
                            jax.tree.leaves(wp)):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=jax.tree_util.keystr(path))
    np.testing.assert_allclose(gx, wx, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg="x")


def test_layer_gradients_match_pallas_vjp():
    layer = _params(12, 16, 1, 7)[0]
    x, w = _x(3, (4, 90, 12)), _x(4, (4, 90, 32))
    got = _port_grads(layer, x, w, fl.bidir_lingru_layer)
    want = _jax_grads(layer, x, w,
                      lambda p, xx: pli.bidir_lingru_layer_pallas(p, xx, interpret=True))
    _assert_grads_close(got, want)


STACKS = {
    "pallas": lambda p, x: pli.bidir_lingru_stack_pallas(p, x, interpret=True),
    "scan": jlin.bidir_lingru_stack,
}


@pytest.mark.parametrize("reference", list(STACKS))
def test_stack_gradients_match_reference(reference):
    """Two layers, both directions: every parameter and the input, against
    the Pallas VJP and against autodiff through the associative scan."""
    params = _params(10, 12, 2, 7)
    x, w = _x(5, (2, 32, 10)), _x(6, (2, 32, 24))
    got = _port_grads(params, x, w, fl.bidir_lingru_stack)
    _assert_grads_close(got, _jax_grads(params, x, w, STACKS[reference]))


def test_multi_time_block_path(monkeypatch):
    """A small VMEM budget splits time into blocks on the reference side
    (the f32 carry, the e-carry and the boundary rows across its grid);
    the port's loops do not block time."""
    monkeypatch.setattr(pli, "_VMEM_BUDGET", 16 * 1024)
    assert pli._pick_tblk(40, 16, 12, 4, bwd=False) < 40  # time really splits
    assert pli._pick_tblk(40, 16, 12, 4, bwd=True) < 40
    layer = _params(10, 12, 1, 9)[0]
    x, w = _x(7, (3, 40, 10)), _x(8, (3, 40, 24))
    got, pallas, _ = _layer_outputs(layer, x)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    want = _jax_grads(layer, x, w,
                      lambda p, xx: pli.bidir_lingru_layer_pallas(p, xx, interpret=True))
    _assert_grads_close(_port_grads(layer, x, w, fl.bidir_lingru_layer), want)


def _tpu_stack(a, Bp):
    """[B, T, 2, W] -> the reference's time-major [T, 2Bp, W]: forward rows,
    then time-flipped backward rows, each zero-padded to Bp."""
    pad = ((0, Bp - a.shape[0]), (0, 0), (0, 0))
    rows = np.concatenate([np.pad(a[:, :, 0], pad), np.pad(a[:, ::-1, 1], pad)])
    return np.ascontiguousarray(rows.swapaxes(0, 1))


def _tpu_unstack(s, B, Bp):
    """The inverse of :func:`_tpu_stack`, padding rows dropped."""
    f = s[:, :B].swapaxes(0, 1)
    b = s[:, Bp : Bp + B].swapaxes(0, 1)[:, ::-1]
    return np.stack([f, b], axis=2)


@pytest.mark.parametrize("budget", [None, 16 * 1024])
def test_scan_loops_match_run_fwd_and_run_bwd(budget, monkeypatch):
    """The plain forward and backward loops against the Pallas kernels'
    own entry points ``_run_fwd`` and ``_run_bwd`` on the same arrays,
    restacked to the TPU layout here (one time block, then several)."""
    if budget:
        monkeypatch.setattr(pli, "_VMEM_BUDGET", budget)
    B, T, H, Bp = 5, 40, 12, 8
    rng = np.random.default_rng(30)
    p = rng.standard_normal((B, T, 4 * H)).astype(np.float32)
    dy = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    h = fl.lingru_scan_plain(torch.from_numpy(p))
    dp = fl.lingru_scan_backward_plain(torch.from_numpy(p), h, torch.from_numpy(dy)).numpy()
    h = h.numpy()

    ps = jnp.asarray(_tpu_stack(p.reshape(B, T, 2, 2 * H), Bp))
    hs = pli._run_fwd(ps, interpret=True)
    np.testing.assert_allclose(_tpu_unstack(np.asarray(hs), B, Bp).reshape(B, T, 2 * H), h,
                               rtol=RTOL, atol=ATOL)
    dps = pli._run_bwd(ps, jnp.asarray(_tpu_stack(h.reshape(B, T, 2, H), Bp)),
                       jnp.asarray(_tpu_stack(dy.reshape(B, T, 2, H), Bp)), interpret=True)
    want = _tpu_unstack(np.asarray(dps), B, Bp).reshape(B, T, 4 * H)
    np.testing.assert_allclose(dp, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_backward_plain_matches_autograd_of_forward_loop():
    rng = np.random.default_rng(31)
    p = torch.tensor(rng.standard_normal((3, 11, 4 * 5)), requires_grad=True)
    dy = torch.tensor(rng.standard_normal((3, 11, 2 * 5)))
    h = fl.lingru_scan_plain(p)
    (want,) = torch.autograd.grad(h, p, dy)
    got = fl.lingru_scan_backward_plain(p.detach(), h.detach(), dy)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)


def test_scan_gradcheck_f64():
    """torch.autograd.gradcheck of LinGRUScan (plain loops) in float64."""
    p = torch.tensor(np.random.default_rng(32).standard_normal((2, 5, 12)), requires_grad=True)
    assert torch.autograd.gradcheck(fl.LinGRUScan.apply, (p,), eps=1e-6, atol=1e-7)


def test_cpu_scan_takes_plain_path_and_counts_no_launch(monkeypatch):
    monkeypatch.setattr(fl.lingru_scan, "launches", 0)
    monkeypatch.setattr(fl.lingru_scan_backward, "launches", 0)
    p = torch.tensor(_x(33, (2, 6, 32)), requires_grad=True)
    h = fl.lingru_scan(p)
    assert h.grad_fn is not None  # the scan is on the tape
    assert torch.equal(h, fl.lingru_scan_plain(p))
    h.sum().backward()
    assert p.grad is not None
    assert fl.lingru_scan.launches == fl.lingru_scan_backward.launches == 0


@pytest.mark.parametrize("shape", [(2, 6), (2, 6, 30), (2, 6, 0)])
def test_scan_rejects_bad_shapes(shape):
    with pytest.raises(ValueError, match="4H"):
        fl.lingru_scan(torch.zeros(shape))


def test_scan_backward_rejects_mismatched_shapes():
    p = torch.zeros(2, 6, 32)
    with pytest.raises(ValueError, match="must be"):
        fl.lingru_scan_backward(p, torch.zeros(2, 6, 16), torch.zeros(2, 6, 8))


# -- the launch plan of the CUDA scans ------------------------------------------

H100_SMS = 132
SCAN_KERNELS = ("fwd", "bwd")
# shared memory one block may take on an H100: 227 KB
MAX_BLOCK_SMEM = 232448


@pytest.mark.parametrize("kernel", SCAN_KERNELS)
@pytest.mark.parametrize("B,blocks,waves", [(512, 1024, 4), (128, 256, 1)])
def test_scan_plan_stages_the_full_width_shapes(kernel, B, blocks, waves):
    """The main paths' shapes (T=90, H=128, at the inference and the train
    batch) run the staged kernel: one block per (row, direction), a
    chain thread and three gate threads a channel."""
    plan = fl.scan_plan(B, 90, 128, H100_SMS, kernel)
    steps, stages = fl.SCAN_DEFAULT[kernel]
    assert plan["variant"] == "staged"
    assert (plan["steps"], plan["stages"]) == (steps, stages)
    assert (plan["blocks"], plan["threads"], plan["waves"]) == (blocks, 512, waves)
    ring, gates = {"fwd": (2, 2), "bwd": (4, 4)}[kernel]
    assert plan["smem_bytes"] == 4 * steps * 128 * (stages * ring + 2 * gates)


@pytest.mark.parametrize("kernel", SCAN_KERNELS)
@pytest.mark.parametrize(
    "B,T,H,aligned",
    [(5, 90, 18, True), (5, 90, 6, True), (128, 90, 128, False), (1, 1, 4, True),
     (3, 7, 16, True)],
)
def test_scan_plan_streams_what_the_copies_cannot_take(kernel, B, T, H, aligned):
    """H not a multiple of 4 or a misaligned tensor breaks the bulk
    copies' 16-byte rule; fewer steps than one time tile leave nothing to
    stage."""
    plan = fl.scan_plan(B, T, H, H100_SMS, kernel, aligned=aligned)
    assert plan["variant"] == "streaming"
    assert (plan["steps"], plan["stages"], plan["smem_bytes"]) == (0, 0, 0)
    assert plan["blocks"] == -(-B * 2 * H // 128) and plan["threads"] == 128


@pytest.mark.parametrize("kernel", SCAN_KERNELS)
@pytest.mark.parametrize("H", [4, 12, 16, 128, 200, 512])
def test_scan_plan_fits_shared_memory_at_every_choice(kernel, H):
    """Every choice scan_choices offers fits one block's 227 KB; every other
    (steps, stages) is refused, and the default is among the choices."""
    choices = fl.scan_choices(kernel, H)
    assert fl.SCAN_DEFAULT[kernel] in choices
    for steps in fl.SCAN_STEPS:
        for stages in fl.SCAN_STAGES:
            if (steps, stages) not in choices:
                with pytest.raises(ValueError, match="more than"):
                    fl.scan_plan(7, 90, H, H100_SMS, kernel, steps=steps, stages=stages)
                continue
            plan = fl.scan_plan(7, 90, H, H100_SMS, kernel, steps=steps, stages=stages)
            assert plan["variant"] == "staged"
            assert 0 < plan["smem_bytes"] <= MAX_BLOCK_SMEM
            assert plan["blocks"] == 7 * 2 * -(-H // fl.SCAN_TILE)
            chain = -(-min(H, fl.SCAN_TILE) // 32) * 32
            assert plan["threads"] == 4 * chain


@pytest.mark.parametrize("kernel", SCAN_KERNELS)
def test_scan_plan_rejects_choices_it_cannot_run(kernel):
    with pytest.raises(ValueError, match="H % 4"):
        fl.scan_plan(4, 90, 18, H100_SMS, kernel, variant="staged")
    with pytest.raises(ValueError, match="aligned"):
        fl.scan_plan(4, 90, 16, H100_SMS, kernel, variant="staged", aligned=False)
    with pytest.raises(ValueError, match="steps in"):
        fl.scan_plan(4, 90, 16, H100_SMS, kernel, steps=5)
    with pytest.raises(ValueError, match="stages"):
        fl.scan_plan(4, 90, 16, H100_SMS, kernel, stages=9)
    with pytest.raises(ValueError, match="no steps"):
        fl.scan_plan(4, 90, 16, H100_SMS, kernel, variant="streaming", steps=8)
    with pytest.raises(ValueError, match="staged and streaming"):
        fl.scan_plan(4, 90, 16, H100_SMS, kernel, variant="resident")


def test_alignment_of_the_scans_inputs():
    t = torch.zeros(64)
    assert fl.aligned(t, t[4:]) and not fl.aligned(t, t[1:])


# -- the model -------------------------------------------------------------------


def _port_config(cfg, **kw):
    return ModelConfig(**{f: getattr(cfg, f) for f in _FIELDS}, **kw)


def _windows(n, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, JC.FEATURE_VOCAB, (n, JC.WINDOW_ROWS, JC.WINDOW_COLS),
                        dtype=np.uint8)


@pytest.mark.parametrize("path", ["scan", "pallas"])
@pytest.mark.parametrize("name", list(MODELS))
def test_logits_match_reference(name, path, monkeypatch):
    """Full-model logits against ``RokoModel.apply``: on its
    associative-scan path, and with ``use_pallas`` forced through the
    interpret-mode kernels."""
    cfg = MODELS[name]
    params = jax.tree.map(np.asarray, JaxRokoModel(cfg).init(jax.random.PRNGKey(0)))
    x = _windows(2)
    if path == "pallas":
        monkeypatch.setenv("ROKO_PALLAS_INTERPRET", "1")
        cfg = dataclasses.replace(cfg, use_pallas=True)
    want = np.asarray(JaxRokoModel(cfg).apply(params, x))

    model = RokoModel(_port_config(cfg))
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, JC.WINDOW_COLS, JC.NUM_CLASSES)
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def test_model_builds_only_its_kind():
    lin = RokoModel(ModelConfig(kind="lingru", hidden_size=8, num_layers=1))
    gru = RokoModel(ModelConfig(hidden_size=8, num_layers=1))
    assert hasattr(lin, "lingru") and not hasattr(lin, "gru")
    assert hasattr(gru, "gru") and not hasattr(gru, "lingru")
    assert all(k.startswith(("embedding", "fc", "lingru.")) for k in lin.state_dict())
    with pytest.raises(RuntimeError, match="Missing key"):
        lin.load_state_dict(gru.state_dict(), strict=True)


def test_init_follows_reference_distributions():
    """Orthogonal gate matrices (in the JAX layout [in, H] the Gram matrix
    of the shorter side is the identity) and N(0, 1) biases, as
    ``lingru_layer_params`` draws them."""
    cfg = ModelConfig(kind="lingru")
    sd = RokoModel(cfg, torch.Generator().manual_seed(0)).state_dict()
    biases = []
    for name, t in sd.items():
        if name.startswith("lingru.weight"):
            w = t.t().double()
            gram = w.t() @ w if w.shape[0] >= w.shape[1] else w @ w.t()
            torch.testing.assert_close(gram, torch.eye(len(gram), dtype=gram.dtype),
                                       atol=1e-5, rtol=0)
        elif name.startswith("lingru.bias"):
            biases.append(t)
    b = torch.cat(biases)
    assert b.numel() == cfg.num_layers * 2 * 2 * cfg.hidden_size
    assert abs(b.mean().item()) < 0.1 and abs(b.std().item() - 1) < 0.08
    assert len([k for k in sd if k.startswith("lingru.")]) == cfg.num_layers * 2 * 4


def test_init_is_a_function_of_the_generator():
    cfg = ModelConfig(kind="lingru", hidden_size=16, num_layers=2)
    a = RokoModel(cfg, torch.Generator().manual_seed(3))
    b = RokoModel(cfg, torch.Generator().manual_seed(3))
    c = RokoModel(cfg, torch.Generator().manual_seed(4))
    pairs = list(zip(a.state_dict().values(), b.state_dict().values(), c.state_dict().values()))
    assert all(torch.equal(p, q) for p, q, _ in pairs)
    assert not any(torch.equal(p, r) for p, _, r in pairs)


def test_stack_drops_between_layers_only():
    from roko_tpu_torch.models.layers import dropout

    layers = _torch(_params(6, 8, 2, 11))
    x = torch.from_numpy(_x(12, (3, 10, 6)))
    got = fl.bidir_lingru_stack(layers, x, dropout=0.5,
                                generator=torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    want = fl.bidir_lingru_layer(layers[1], dropout(fl.bidir_lingru_layer(layers[0], x), 0.5, g))
    assert torch.equal(got, want)
