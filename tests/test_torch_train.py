"""The port's training model against the JAX package on the CPU: the
init (F2), the config (F3), dropout, one full train step (loss, accuracy
and every gradient against ``jax.value_and_grad`` of
``roko_tpu.training.loop._loss_and_stats``) and one Adam step against
``optax.adam``."""

import dataclasses

import numpy as np
import optax

import jax
import torch

from roko_tpu.config import ModelConfig as JaxModelConfig
from roko_tpu.config import TrainConfig as JaxTrainConfig
from roko_tpu.config import GuardConfig as JaxGuardConfig
from roko_tpu.models import RokoModel as JaxRokoModel
from roko_tpu.training.loop import _loss_and_stats
from roko_tpu_torch import constants as C
from roko_tpu_torch.config import GuardConfig, ModelConfig, TrainConfig
from roko_tpu_torch.models import fused_gru as fg
from roko_tpu_torch.models.convert import jax_from_state_dict, state_dict_from_jax
from roko_tpu_torch.models.layers import dropout
from roko_tpu_torch.models.model import RokoModel
from roko_tpu_torch.training.loop import loss_and_stats, make_optimizer
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-4, 1e-5
TINY_GRU = JaxModelConfig(embed_dim=8, read_mlp=(8, 4), hidden_size=16, num_layers=2,
                          dropout=0.0)
_FIELDS = ("embed_vocab", "window_rows", "window_cols", "embed_dim", "read_mlp",
           "hidden_size", "num_layers", "dropout", "num_classes")


def _port_config(cfg):
    return ModelConfig(**{f: getattr(cfg, f) for f in _FIELDS})


def _batch(n, n_real, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, C.FEATURE_VOCAB, (n, C.WINDOW_ROWS, C.WINDOW_COLS), dtype=np.uint8)
    y = rng.integers(0, C.NUM_CLASSES, (n, C.WINDOW_COLS)).astype(np.int32)
    w = (np.arange(n) < n_real).astype(np.float32)  # padding rows weigh 0
    return x, y, w


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_config_defaults_match_reference():
    assert ModelConfig().dropout == JaxModelConfig().dropout == 0.2  # F3
    for port, ref in ((TrainConfig(), JaxTrainConfig()), (GuardConfig(), JaxGuardConfig())):
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name


def test_init_follows_reference_distributions():
    """F2: orthogonal GRU matrices (in the JAX layout [in, 3H] / [H, 3H],
    the Gram matrix of the shorter side is the identity), N(0, 1) GRU
    biases and embedding, U(+-1/sqrt(in)) dense layers."""
    cfg = ModelConfig()
    model = RokoModel(cfg, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    biases = []
    for name, t in sd.items():
        if name.startswith("gru.weight"):
            w = t.t().double()  # JAX layout
            gram = w.t() @ w if w.shape[0] >= w.shape[1] else w @ w.t()
            torch.testing.assert_close(gram, torch.eye(len(gram), dtype=gram.dtype),
                                       atol=1e-5, rtol=0)
        elif name.startswith("gru.bias"):
            biases.append(t)
    b = torch.cat(biases)
    assert b.numel() == cfg.num_layers * 2 * 2 * 3 * cfg.hidden_size
    assert abs(b.mean().item()) < 0.06 and abs(b.std().item() - 1) < 0.05
    e = sd["embedding.weight"]
    assert abs(e.mean().item()) < 0.15 and abs(e.std().item() - 1) < 0.1
    for name in ("fc1", "fc2", "fc4"):
        w, bias = sd[f"{name}.weight"], sd[f"{name}.bias"]
        bound = 1 / np.sqrt(w.shape[1])
        for t in (w, bias):
            assert t.abs().max().item() <= bound
        assert w.abs().max().item() > 0.9 * bound
        assert abs(w.std().item() - bound / np.sqrt(3)) < 0.1 * bound


def test_init_is_a_function_of_the_generator():
    a = RokoModel(ModelConfig(hidden_size=16, num_layers=2), torch.Generator().manual_seed(3))
    b = RokoModel(ModelConfig(hidden_size=16, num_layers=2), torch.Generator().manual_seed(3))
    c = RokoModel(ModelConfig(hidden_size=16, num_layers=2), torch.Generator().manual_seed(4))
    pairs = list(zip(a.state_dict().values(), b.state_dict().values(), c.state_dict().values()))
    assert all(torch.equal(p, q) for p, q, _ in pairs)
    assert not any(torch.equal(p, r) for p, _, r in pairs)


def test_dropout_keep_rate_scale_and_reproducibility():
    x = torch.ones(200_000)
    out = dropout(x, 0.2, torch.Generator().manual_seed(1))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.005
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / 0.8))
    assert torch.equal(out, dropout(x, 0.2, torch.Generator().manual_seed(1)))
    assert not torch.equal(out, dropout(x, 0.2, torch.Generator().manual_seed(2)))
    assert dropout(x, 0.0, None) is x


def test_stack_drops_between_layers_only():
    rng = np.random.default_rng(2)

    def layer(i):
        return {d: {"w_ih": torch.from_numpy(rng.uniform(-.3, .3, (i, 24)).astype(np.float32)),
                    "w_hh": torch.from_numpy(rng.uniform(-.3, .3, (8, 24)).astype(np.float32)),
                    "b_ih": torch.zeros(24), "b_hh": torch.zeros(24)} for d in ("fwd", "bwd")}

    layers = (layer(6), layer(16))
    x = torch.from_numpy(rng.standard_normal((3, 10, 6)).astype(np.float32))
    got = fg.bidir_gru_stack(layers, x, dropout=0.5, generator=torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    h = dropout(fg.fused_bidir_layer(layers[0], x), 0.5, g)
    want = fg.fused_bidir_layer(layers[1], h)
    assert torch.equal(got, want)


def step_against_reference(cfg, n, n_real):
    """One train step of the port and of the JAX package from the same
    params and batch (``n`` rows, the last ``n - n_real`` padding):
    ``{"loss": (port, jax), "counts": (port, jax), "grads": {path: (port,
    jax)}}`` and the params, JAX grads and port model for the Adam step."""
    params = jax.tree.map(np.asarray, JaxRokoModel(cfg).init(jax.random.PRNGKey(1)))
    x, y, w = _batch(n, n_real)
    jmodel = JaxRokoModel(cfg)
    (jloss, (jc, jt)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: _loss_and_stats(jmodel, p, x, y, w, jax.random.PRNGKey(9)), has_aux=True
    ))(params)

    model = RokoModel(_port_config(cfg))
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    model.train()
    loss, c, t = loss_and_stats(model(torch.from_numpy(x)), torch.from_numpy(y),
                                torch.from_numpy(w))
    loss.backward()
    got = dict(_leaves(jax_from_state_dict({k: p.grad for k, p in model.named_parameters()})))
    want = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    assert set(got) == set(want)
    return {
        "loss": (loss.item(), float(jloss)),
        "counts": ((c.item(), t.item()), (float(jc), float(jt))),
        "grads": {jax.tree_util.keystr(k): (got[k], want[k]) for k in want},
        "params": params, "jgrads": jgrads, "model": model,
    }


def _step_parity(cfg, n, n_real):
    r = step_against_reference(cfg, n, n_real)
    np.testing.assert_allclose(*r["loss"], rtol=RTOL, atol=ATOL)
    assert r["counts"][0] == r["counts"][1]
    for path, (g, want) in r["grads"].items():
        np.testing.assert_allclose(g, want, rtol=RTOL, atol=ATOL, err_msg=path)
    return r["params"], r["jgrads"], r["model"]


def adam_step_against_reference(params, jgrads, model):
    """One Adam step from the same gradients: (port params, optax params)
    as lists of (path, array)."""
    tx = optax.adam(1e-4)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    want = jax.tree.map(np.asarray, optax.apply_updates(params, updates))
    for name, g in state_dict_from_jax(jax.tree.map(np.asarray, jgrads)).items():
        dict(model.named_parameters())[name].grad = g.clone()
    make_optimizer(model, 1e-4).step()
    return _leaves(jax_from_state_dict(model.state_dict())), _leaves(want)


def test_train_step_matches_reference_tiny():
    # then one Adam step from the same gradients: torch.optim.Adam == optax.adam
    got, want = adam_step_against_reference(*_step_parity(TINY_GRU, 6, 4))
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=jax.tree_util.keystr(path))


def test_train_step_matches_reference_default_config():
    _step_parity(dataclasses.replace(JaxModelConfig(), dropout=0.0), 3, 2)


def test_every_parameter_gets_a_gradient():
    """F1 on the CPU: the front end and every GRU tensor are on the tape."""
    model = RokoModel(ModelConfig(hidden_size=8, num_layers=2)).train()
    x, y, w = _batch(2, 2)
    loss, _, _ = loss_and_stats(model(torch.from_numpy(x), generator=torch.Generator()),
                                torch.from_numpy(y), torch.from_numpy(w))
    loss.backward()
    missing = [n for n, p in model.named_parameters() if p.grad is None or not p.grad.any()]
    assert not missing
