"""``kind="transformer"`` of the port against ``roko_tpu`` on the CPU.

The same numpy-seeded inputs and the same weights, carried across by
``models/convert.py``, go through the reference and the port:

- ``attention``, ``layernorm``, ``gelu`` and one encoder layer in float32
  at rtol 1e-4 / atol 1e-5; in bfloat16 the elementwise pieces round where
  the reference's eager ops round (at least 99% of the outputs bit-equal;
  a fused torch op would round once). The GELU is the tanh form: the erf
  form misses the float32 bar;
- the whole model's logits at the tiny width (hidden 32, d_model 64, 4
  heads, 2 layers, embed 8, read MLP 8 -> 4, as ``tests/test_transformer.py``)
  and at full width (B=2) in float32 at the same bar with argmax exact,
  and in bfloat16 at the bar of the precision tests: nearer the
  reference's bf16 logits than those are to its float32 ones, argmax equal
  where the top-two gap exceeds that distance;
- one train step with dropout 0: the loss and every gradient against
  ``jax.value_and_grad`` of the reference's loss, in float32 at the same
  bar, and in bfloat16 (the bar below);
- dropout sites, the weights bridge, the refusals, the init, the CLI
  (train, inference, polish streamed and staged, in f32 and bf16), the
  Orbax tool with the reference's inference and polish FASTA, and config
  files and flags against the reference's.

The bf16 gradient bar. The port's forward rounds where the reference's
eager ops round, but the backward passes differ in their sums: the
reference's autodiff takes the transposes of its broadcasts (the layer
norms' and the softmax's row sums, every bias over the rows, ``pos_embed``
over the batch) as XLA bf16 reductions, which on the CPU carry several
bf16 ulps of error, where torch accumulates in float32 and rounds once.
The two backward passes' bf16 errors are then of one size and
independent, and a gradient tensor's distance from the reference's bf16
gradient can exceed the reference's own distance from its float32
gradient (the key biases, whose exact gradient is zero, are pure
rounding noise in both). So the loss holds the
precision tests' bar (nearer the reference's bf16 loss than that is to
its float32 one), and each gradient tensor is held within twice the
reference's bf16 distance from float32, both from the reference's bf16
gradient and from its float32 one: the port's bf16 step is as accurate
as the reference's.

The references are compiled once with XLA's excess precision off
(``xla_allow_excess_precision=False``), which gives the bits of their
eager ops (checked in ``test_compiled_reference_rounds_as_its_eager_ops``)
in a few seconds, where the eager backward compiles op by op for far longer.
"""

import contextlib
import dataclasses
import functools
import importlib.util
import io
import math
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from roko_tpu import cli as ref_cli
from roko_tpu import config as jconfig
from roko_tpu.config import ModelConfig as JaxModelConfig
from roko_tpu.features.pipeline import run_features as ref_run_features
from roko_tpu.infer import polish_to_fasta as ref_polish_to_fasta
from roko_tpu.models import RokoModel as JaxRokoModel
from roko_tpu.models import layers as ref_layers
from roko_tpu.models import model as ref_model
from roko_tpu.models import transformer as ref_transformer
from roko_tpu.training.checkpoint import CheckpointManager as RefCheckpointManager
from roko_tpu.training.loop import _loss_and_stats
from roko_tpu_torch import cli
from roko_tpu_torch import constants as C
from roko_tpu_torch.config import ModelConfig, RokoConfig
from roko_tpu_torch.features.pipeline import run_features
from roko_tpu_torch.io.fasta import read_fasta
from roko_tpu_torch.models import layers
from roko_tpu_torch.models import model as port_model
from roko_tpu_torch.models import transformer
from roko_tpu_torch.models.convert import jax_from_state_dict, state_dict_from_jax
from roko_tpu_torch.models.model import RokoModel
from roko_tpu_torch.sim import build_synthetic_project
from roko_tpu_torch.training import checkpoint as ck
from roko_tpu_torch.training.loop import loss_and_stats
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-4, 1e-5
#: the widths of tests/test_transformer.py
TRANS = JaxModelConfig(kind="transformer", hidden_size=32, d_model=64, num_heads=4,
                       num_layers=2, embed_dim=8, read_mlp=(8, 4))
FULL = JaxModelConfig(kind="transformer")
_FIELDS = ("kind", "embed_vocab", "window_rows", "window_cols", "embed_dim", "read_mlp",
           "hidden_size", "num_layers", "dropout", "num_classes", "d_model", "num_heads",
           "mlp_ratio")
#: the CLI's small model: the default front end, d_model 32 (2 x 16), 8 heads
SMALL = ["--model-kind", "transformer", "--hidden-size", "16", "--num-layers", "2",
         "--device", "cpu"]
SMALL_CFG = JaxModelConfig(kind="transformer", hidden_size=16, d_model=32, num_layers=2)
#: at least this share of bf16 outputs bit-equal to the reference's eager ops
BF16_EQUAL_SHARE = 0.99


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread_for_the_module():
    """One intra-op torch thread for the module-scoped fixtures too (the
    training ones), which run before the per-test ``one_torch_thread``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_config(cfg, **kw):
    return ModelConfig(**{f: getattr(cfg, f) for f in _FIELDS}, **kw)


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, jax.jit(JaxRokoModel(cfg).init)(jax.random.PRNGKey(seed)))


def _ref_logits(cfg, params, x, **kw):
    model = JaxRokoModel(dataclasses.replace(cfg, **kw))
    return np.asarray(exact_jit(lambda p, x: model.apply(p, x), params, x))


def _port_model(cfg, params, **kw):
    model = RokoModel(_port_config(cfg, **kw))
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


def _windows(n, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, C.FEATURE_VOCAB, (n, C.WINDOW_ROWS, C.WINDOW_COLS), dtype=np.uint8)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_pair(a):
    """``a`` rounded to bf16, as a JAX array and as a torch tensor."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(_f32(j)).bfloat16()


def _bf16_equal_share(want, got):
    return float(np.mean(_f32(want) == got.float().numpy()))


def exact_jit(fn, *args):
    """``fn(*args)``, compiled with XLA's excess precision off: each op
    rounds to its dtype as the eager op does, bit for bit."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


# -- the pieces ----------------------------------------------------------------------


def test_compiled_reference_rounds_as_its_eager_ops():
    """The references below are compiled with excess precision off: in
    bf16 they give the bits of the eager ops, where a plain ``jax.jit``
    keeps some values in float32 across a fusion and differs."""
    x = (3 * np.random.default_rng(5).standard_normal((2, 4, 90, 90))).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    eager = _f32(jax.nn.softmax(xj, axis=-1))
    assert np.array_equal(_f32(exact_jit(jax.nn.softmax, xj)), eager)
    assert not np.array_equal(_f32(jax.jit(jax.nn.softmax)(xj)), eager)


def test_attention_matches_reference():
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((3, 90, 64)).astype(np.float32) for _ in range(3))
    attention = functools.partial(ref_transformer.attention, num_heads=4)
    want = np.asarray(exact_jit(attention, q, k, v))
    got = transformer.attention(*map(torch.from_numpy, (q, k, v)), 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    pairs = [_bf16_pair(a) for a in (q, k, v)]
    got16 = transformer.attention(*(t for _, t in pairs), 4)
    want16 = exact_jit(attention, *(j for j, _ in pairs))
    assert got16.dtype == torch.bfloat16
    assert _bf16_equal_share(want16, got16) >= BF16_EQUAL_SHARE


def test_layernorm_matches_reference():
    rng = np.random.default_rng(1)
    x = (3 * rng.standard_normal((4, 90, 64)) + 1).astype(np.float32)
    scale, bias = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    want = np.asarray(exact_jit(ref_layers.layernorm, {"scale": scale, "bias": bias}, x))
    got = layers.layernorm(*map(torch.from_numpy, (x, scale, bias)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    (xj, xt), (sj, st), (bj, bt) = (_bf16_pair(a) for a in (x, scale, bias))
    want16 = exact_jit(ref_layers.layernorm, {"scale": sj, "bias": bj}, xj)
    got16 = layers.layernorm(xt, st, bt)
    assert _bf16_equal_share(want16, got16) >= BF16_EQUAL_SHARE
    # torch's fused layer norm rounds once, and misses the reference's bits
    fused = F.layer_norm(xt, (64,), st, bt, eps=1e-5)
    assert _bf16_equal_share(want16, fused) < BF16_EQUAL_SHARE


def test_gelu_is_the_reference_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation; torch's
    ``F.gelu`` to the erf form, which misses the float32 bar."""
    x = (2 * np.random.default_rng(2).standard_normal((4, 90, 256))).astype(np.float32)
    want = np.asarray(exact_jit(jax.nn.gelu, x))
    got = layers.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    erf = F.gelu(torch.from_numpy(x)).numpy()
    assert not np.allclose(erf, want, rtol=RTOL, atol=ATOL)
    xj, xt = _bf16_pair(x)
    assert _bf16_equal_share(exact_jit(jax.nn.gelu, xj), layers.gelu(xt)) >= BF16_EQUAL_SHARE


def test_encoder_layer_matches_reference():
    params = _jax_params(TRANS, seed=2)
    x = np.random.default_rng(3).standard_normal((3, 90, 64)).astype(np.float32)
    want = np.asarray(exact_jit(functools.partial(ref_transformer.encoder_layer, num_heads=4),
                                params["encoder"]["layers"][0], x))
    layer = _port_model(TRANS, params).encoder.layers[0]
    with torch.inference_mode():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# -- the model -----------------------------------------------------------------------


@pytest.mark.parametrize("name,cfg,n", [("tiny", TRANS, 4), ("full", FULL, 2)])
def test_logits_match_reference(name, cfg, n):
    params = _jax_params(cfg)
    x = _windows(n)
    want = _ref_logits(cfg, params, x)
    with torch.inference_mode():
        got = _port_model(cfg, params)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (n, C.WINDOW_COLS, C.NUM_CLASSES)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_bf16_logits_closer_to_reference_than_it_is_to_f32():
    params = _jax_params(TRANS)
    x = _windows(4)

    want, f32 = (_ref_logits(TRANS, params, x, compute_dtype=d) for d in ("bfloat16", "float32"))
    with torch.inference_mode():
        got = _port_model(TRANS, params, compute_dtype="bfloat16")(torch.from_numpy(x)).numpy()
    route = np.abs(want - f32).max()
    assert route > 1e-4, "bf16 did not move the reference's logits"
    assert np.abs(got - want).max() < route
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > route
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


def _batch(n, n_real, seed=7):
    rng = np.random.default_rng(seed)
    x = _windows(n, seed)
    y = rng.integers(0, C.NUM_CLASSES, (n, C.WINDOW_COLS)).astype(np.int32)
    w = (np.arange(n) < n_real).astype(np.float32)  # padding rows weigh 0
    return x, y, w


def _paths(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def step_gradients(dtype):
    """(port, reference) in ``dtype``: (loss, {path: gradient}) of one
    train step, dropout 0, on the same params and batch."""
    cfg = dataclasses.replace(TRANS, dropout=0.0)
    params = _jax_params(cfg, seed=1)
    x, y, w = _batch(4, 3)
    jmodel = JaxRokoModel(dataclasses.replace(cfg, compute_dtype=dtype))
    (jloss, _), jgrads = exact_jit(jax.value_and_grad(
        lambda p: _loss_and_stats(jmodel, p, x, y, w, jax.random.PRNGKey(9)), has_aux=True
    ), params)
    model = _port_model(cfg, params, compute_dtype=dtype).train()
    loss, _, _ = loss_and_stats(model(torch.from_numpy(x)), torch.from_numpy(y),
                                torch.from_numpy(w))
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert all(g.dtype == torch.float32 for g in grads.values())
    return (loss.item(), _paths(jax_from_state_dict(grads))), (float(jloss), _paths(jgrads))


@pytest.fixture(scope="module")
def f32_step():
    return step_gradients("float32")


@pytest.fixture(scope="module")
def bf16_step():
    return step_gradients("bfloat16")


def test_train_step_matches_reference(f32_step):
    (loss, got), (want_loss, want) = f32_step
    np.testing.assert_allclose(loss, want_loss, rtol=RTOL, atol=ATOL)
    assert set(got) == set(want)
    assert len(got) == 7 + 5 + 2 * 16  # front end, head; in_proj, pos_embed, ln_out; 2 layers
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=RTOL, atol=ATOL, err_msg=path)


def test_bf16_train_step_follows_reference(f32_step, bf16_step):
    (loss, got), (want_loss, want) = bf16_step
    _, (f32_loss, f32) = f32_step
    assert abs(loss - want_loss) < abs(want_loss - f32_loss), (loss, want_loss, f32_loss)
    assert set(got) == set(want)
    for path in want:
        route = float(np.abs(want[path] - f32[path]).max())
        d = float(np.abs(got[path] - want[path]).max())
        own = float(np.abs(got[path] - f32[path]).max())
        assert d <= 2 * route and own <= 2 * route, (path, d, own, route)


def test_bf16_train_step_gradients_are_rounded_where_the_references_are(bf16_step):
    """float32 gradients that equal their own bf16 rounding: every
    parameter's but the head's, which runs in float32 in both."""
    (_, got), (_, want) = bf16_step

    def is_bf16(a):
        return np.array_equal(a, torch.tensor(a).bfloat16().float().numpy())

    for path in want:
        assert is_bf16(got[path]) == is_bf16(want[path]) == ("head" not in path), path


def test_dropout_falls_on_the_reference_sites(monkeypatch):
    """With dropout on, both packages' dropout calls are replaced by one
    seeded mask per call in order: the port calls it at the same sites
    (the front end's three, then after ``proj`` and after ``mlp_out`` in
    each layer, never on the attention weights), with the same shapes, and
    its training logits equal the reference's."""
    cfg = dataclasses.replace(TRANS, dropout=0.2)
    params = _jax_params(cfg, seed=4)
    x = _windows(3)

    def masks(sites):
        def drop(shape, xs, rate, where):
            i = len(sites)
            sites.append(tuple(shape))
            keep = np.random.default_rng(100 + i).random(shape) >= rate
            return where(keep, xs / (1.0 - rate))
        return drop

    ref_sites, port_sites = [], []
    ref_drop, port_drop = masks(ref_sites), masks(port_sites)

    def jax_dropout(rng, xs, rate):
        return ref_drop(xs.shape, xs, rate, lambda m, v: jnp.where(m, v, 0.0))

    def torch_dropout(xs, rate, generator):
        return port_drop(xs.shape, xs, rate, lambda m, v: torch.where(
            torch.from_numpy(m), v, torch.zeros((), dtype=xs.dtype)))

    for module in (ref_model, ref_transformer):
        monkeypatch.setattr(module, "_dropout", jax_dropout)
    for module in (port_model, transformer):
        monkeypatch.setattr(module, "dropout", torch_dropout)
    jmodel = JaxRokoModel(cfg)
    want = np.asarray(exact_jit(lambda p, x: jmodel.apply(
        p, x, deterministic=False, rng=jax.random.PRNGKey(5)), params, x))
    got = _port_model(cfg, params).train()(torch.from_numpy(x)).detach().numpy()
    d, T = cfg.d_model, C.WINDOW_COLS
    assert port_sites == ref_sites
    assert port_sites[3:] == [(3, T, d)] * (2 * cfg.num_layers)
    assert len(port_sites) == 3 + 2 * cfg.num_layers
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # and the real dropout draws from the caller's generator
    monkeypatch.undo()
    model = _port_model(cfg, params).train()
    run = [model(torch.from_numpy(x), generator=torch.Generator().manual_seed(s))
           for s in (1, 1, 2)]
    assert torch.equal(run[0], run[1]) and not torch.equal(run[0], run[2])


# -- the bridge, the refusals, the init ----------------------------------------------


def test_bridge_round_trips_the_encoder_tree():
    params = _jax_params(TRANS, seed=3)
    sd = state_dict_from_jax(params)
    assert set(sd) == set(RokoModel(_port_config(TRANS)).state_dict())
    assert sd["encoder.layers.1.mlp_in.weight"].shape == (4 * 64, 64)
    back = jax_from_state_dict(sd)
    flat_a, tree_a = jax.tree.flatten(params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(flat_a, flat_b))
    again = state_dict_from_jax(back)
    assert list(again) == list(sd) and all(torch.equal(again[k], sd[k]) for k in sd)


@pytest.mark.parametrize("fields,match", [
    (dict(hidden_size=32, d_model=96), r"d_model \(96\) must equal 2\*hidden_size \(64\)"),
    (dict(hidden_size=32, d_model=64, num_heads=5), "d_model 64 not divisible by 5 heads"),
])
def test_construction_refuses_what_the_reference_refuses(fields, match):
    cfg = JaxModelConfig(kind="transformer", **fields)
    with pytest.raises(ValueError, match=match):
        JaxRokoModel(cfg).init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match=match):
        RokoModel(_port_config(cfg))


def test_int8_and_a_recurrence_are_refused():
    with pytest.raises(ValueError, match="transformer variant has no int8 weight path"):
        ModelConfig(kind="transformer", quantize="int8")
    model = RokoModel(_port_config(TRANS))
    from roko_tpu_torch.models.fused_gru import gru_recurrence_plain

    with pytest.raises(ValueError, match="no recurrence to replace"):
        model(torch.from_numpy(_windows(1)), gru_recurrence_plain)


def test_init_follows_reference_distributions():
    """Dense layers U(+-1/sqrt(in)), ``pos_embed`` 0.02 N(0, 1), layer norms
    scale 1 and bias 0, drawn from the generator."""
    cfg = ModelConfig(kind="transformer")
    sd = RokoModel(cfg, torch.Generator().manual_seed(0)).state_dict()
    pos = sd["encoder.pos_embed"]
    assert pos.shape == (cfg.window_cols, cfg.d_model)
    assert abs(pos.mean().item()) < 0.002 and abs(pos.std().item() - 0.02) < 0.001
    norms = [n for n in sd if ".ln" in n]
    assert len(norms) == 2 * (2 * cfg.num_layers + 1)
    for name in norms:
        want = 1.0 if name.endswith("weight") else 0.0
        assert torch.equal(sd[name], torch.full_like(sd[name], want)), name
    dense = [n[: -len(".weight")] for n in sd if n.endswith(".weight") and ".ln" not in n
             and n.startswith("encoder.")]
    assert len(dense) == 1 + 6 * cfg.num_layers
    for name in dense:
        w, b = sd[f"{name}.weight"], sd[f"{name}.bias"]
        bound = 1 / math.sqrt(w.shape[1])
        assert max(w.abs().max().item(), b.abs().max().item()) <= bound
        assert w.abs().max().item() > 0.9 * bound
        assert abs(w.std().item() - bound / math.sqrt(3)) < 0.1 * bound
    again = RokoModel(cfg, torch.Generator().manual_seed(0)).state_dict()
    other = RokoModel(cfg, torch.Generator().manual_seed(1)).state_dict()
    assert all(torch.equal(again[k], sd[k]) for k in sd)
    assert not torch.equal(other["encoder.pos_embed"], pos)


# -- config files and flags ----------------------------------------------------------


def test_reference_config_file_loads_its_widths(tmp_path):
    ref = jconfig.RokoConfig(model=jconfig.ModelConfig(
        kind="transformer", hidden_size=24, d_model=48, num_heads=6, mlp_ratio=2,
        num_layers=2))
    port = RokoConfig.from_json(ref.to_json())
    for f in ("kind", "hidden_size", "d_model", "num_heads", "mlp_ratio", "num_layers"):
        assert getattr(port.model, f) == getattr(ref.model, f), f
    assert jconfig.RokoConfig.from_json(port.to_json()).model == ref.model
    enc = RokoModel(port.model).encoder
    assert len(enc.layers) == 2 and enc.layers[0].mlp_in.weight.shape == (96, 48)
    # a file whose hidden size and d_model disagree builds no model, in
    # either package
    bad = jconfig.RokoConfig(model=jconfig.ModelConfig(kind="transformer", hidden_size=16))
    with pytest.raises(ValueError, match="d_model"):
        RokoModel(RokoConfig.from_json(bad.to_json()).model)


@pytest.mark.parametrize("argv", [
    ["train", "in.hdf5", "out", "--model-kind", "transformer", "--hidden-size", "24",
     "--num-heads", "6", "--mlp-ratio", "2"],
    ["inference", "d.hdf5", "ck", "o.fa", "--model-kind", "transformer", "--hidden-size", "24",
     "--d-model", "48", "--compute-dtype", "bfloat16"],
    ["polish", "r.fa", "x.bam", "ck", "o.fa", "--model-kind", "transformer", "--d-model", "512",
     "--num-heads", "16"],
])
def test_flags_build_the_references_model_config(argv):
    port = cli._build_config(cli.build_parser().parse_args(argv)).model
    ref = ref_cli._build_config(ref_cli.build_parser().parse_args(argv)).model
    mine = dataclasses.asdict(port)
    theirs = dataclasses.asdict(ref)
    assert mine == {k: theirs[k] for k in mine}


def test_cli_refuses_int8_with_the_references_message(tmp_path, capsys):
    argv = ["inference", "d.hdf5", "ck", str(tmp_path / "o.fa"), "--model-kind", "transformer",
            "--quantize", "int8"]
    with pytest.raises(ValueError) as ref_error:
        ref_cli._build_config(ref_cli.build_parser().parse_args(argv))
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2
    assert str(ref_error.value) in capsys.readouterr().err


# -- the command line ----------------------------------------------------------------


@pytest.fixture(scope="module")
def sim_features(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_transformer_cli")
    paths = build_synthetic_project(str(root / "sim"), genome_len=3000, seed=11)
    train_h5, infer_h5 = str(root / "train.hdf5"), str(root / "infer.hdf5")
    run_features(paths["draft_fasta"], paths["reads_bam"], train_h5,
                 bam_y=paths["truth_bam"], seed=5, log=lambda *a: None)
    run_features(paths["draft_fasta"], paths["reads_bam"], infer_h5, seed=5,
                 log=lambda *a: None)
    return {"root": root, "train": train_h5, "infer": infer_h5, **paths}


#: a config file's tiny front end (embed 8, read MLP 8 -> 4), so that two
#: training epochs on the CPU take seconds
TINY_FILE = RokoConfig(model=ModelConfig(kind="transformer", embed_dim=8, read_mlp=(8, 4),
                                         hidden_size=16, d_model=32, num_layers=2))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def trained(request, sim_features):
    """``train --model-kind transformer`` for two epochs in one compute
    dtype: (dtype, checkpoint directory, the flags, train's stdout)."""
    dtype, root = request.param, sim_features["root"]
    cfg = root / "tiny.json"
    cfg.write_text(TINY_FILE.to_json())
    flags = ["--model-kind", "transformer", "--config", str(cfg), "--device", "cpu",
             "--compute-dtype", dtype]
    ckpt, out = str(root / f"ckpt_{dtype}"), io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["train", sim_features["train"], ckpt, "--b", "8", "--epochs", "2",
                         *flags]) == 0
    return dtype, ckpt, flags, out.getvalue()


def test_cli_trains_and_infers(trained, sim_features, tmp_path):
    """``train``'s checkpoints verify and hold float32 encoder weights in
    either dtype; ``inference`` polishes with them."""
    dtype, ckpt, flags, log = trained
    losses = [float(v) for v in re.findall(r"train_loss ([0-9.]+)", log)]
    assert len(losses) == 2 and all(np.isfinite(losses)), log
    for name in os.listdir(ckpt):
        assert ck.verify_manifest(os.path.join(ckpt, name))[0] == "ok", name
    params = ck.load_params(ckpt)
    assert any(k.startswith("encoder.layers.1.") for k in params)
    assert all(t.dtype == torch.float32 for t in params.values())
    out = str(tmp_path / "inference.fa")
    assert cli.main(["inference", sim_features["infer"], ckpt, out, "--b", "16", *flags]) == 0
    records = list(read_fasta(out))
    assert records and set(records[0][1]) <= set("ACGT")


def test_cli_polish_streams_what_it_stages(trained, sim_features, tmp_path, capsys):
    """``polish`` streamed (with ``--truth``) and ``--staged`` with the
    trained checkpoint write the same bytes."""
    dtype, ckpt, flags, _ = trained
    base = ["polish", sim_features["draft_fasta"], sim_features["reads_bam"], ckpt]
    stream, staged = tmp_path / "stream.fa", tmp_path / "staged.fa"
    assert cli.main(base + [str(stream), "--b", "16", "--t", "2", "--truth",
                            sim_features["truth_fasta"], *flags]) == 0
    assert "Q" in capsys.readouterr().out
    assert cli.main(base + [str(staged), "--staged", "--b", "16", "--t", "2", *flags]) == 0
    assert stream.read_bytes() == staged.read_bytes()
    assert len(stream.read_bytes()) > 0


@pytest.fixture(scope="module")
def orbax_model(tmp_path_factory):
    """A ``roko_tpu`` transformer checkpoint directory (Orbax), its params,
    and the .pth ``tools/orbax_to_pth.py`` converts it to."""
    root = tmp_path_factory.mktemp("torch_transformer_orbax")
    params = JaxRokoModel(SMALL_CFG).init(jax.random.PRNGKey(8))
    mgr = RefCheckpointManager(str(root / "orbax"), log=lambda s: None)
    mgr.save(5, {"params": params, "step": jnp.asarray(5, jnp.int32)}, 0.5)
    mgr.close()
    pth = root / "model.pth"
    spec = importlib.util.spec_from_file_location("orbax_to_pth",
                                                  ROOT / "tools" / "orbax_to_pth.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with contextlib.redirect_stdout(io.StringIO()):
        assert tool.main([str(root / "orbax"), str(pth)]) == 0
    return {"dir": str(root / "orbax"), "pth": str(pth),
            "params": jax.tree.map(np.asarray, params)}


def test_orbax_checkpoint_infers_as_the_reference_does(orbax_model, sim_features, tmp_path):
    """The port's ``inference`` on the converted .pth writes ``roko-tpu
    inference``'s FASTA from the checkpoint, byte for byte."""
    want, got = tmp_path / "ref.fa", tmp_path / "port.fa"
    assert ref_cli.main(["inference", sim_features["infer"], orbax_model["dir"], str(want),
                         "--b", "16", "--model-kind", "transformer", "--hidden-size", "16",
                         "--num-layers", "2"]) == 0
    assert cli.main(["inference", sim_features["infer"], orbax_model["pth"], str(got),
                     "--b", "16", *SMALL]) == 0
    assert len(want.read_bytes()) > 2000 and got.read_bytes() == want.read_bytes()


def test_polish_writes_the_references_fasta(orbax_model, sim_features, tmp_path):
    """``polish`` (streamed and ``--staged``) with the converted .pth writes
    the reference's staged polish with the same weights, byte for byte."""
    ref_h5, ref_fa = str(tmp_path / "ref.hdf5"), tmp_path / "ref.fa"
    ref_run_features(sim_features["draft_fasta"], sim_features["reads_bam"], ref_h5, seed=0,
                     log=lambda *a: None)
    ref_polish_to_fasta(ref_h5, orbax_model["params"], str(ref_fa),
                        jconfig.RokoConfig(model=SMALL_CFG), batch_size=32, log=lambda *a: None)
    base = ["polish", sim_features["draft_fasta"], sim_features["reads_bam"], orbax_model["pth"]]
    for mode in ([], ["--staged"]):
        out = tmp_path / f"port{len(mode)}.fa"
        assert cli.main(base + [str(out), "--b", "32", "--t", "2", *mode, *SMALL]) == 0
        assert out.read_bytes() == ref_fa.read_bytes()
