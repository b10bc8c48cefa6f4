"""The port's model against ``roko_tpu.models.RokoModel.apply`` through
the weights bridge, and the bridge against the JAX package's converter."""

import numpy as np
import pytest

import jax
import torch

from roko_tpu import constants as JC
from roko_tpu.config import ModelConfig as JaxModelConfig
from roko_tpu.models import RokoModel as JaxRokoModel
from roko_tpu.models.convert import from_torch_state_dict
from roko_tpu_torch import constants as C
from roko_tpu_torch.config import ModelConfig
from roko_tpu_torch.models.convert import load_reference_pth, state_dict_from_jax
from roko_tpu_torch.models.model import RokoModel
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY_GRU = JaxModelConfig(embed_dim=8, read_mlp=(8, 4), hidden_size=16, num_layers=2)
CONFIGS = {"default": JaxModelConfig(), "tiny_gru": TINY_GRU}
_FIELDS = ("embed_vocab", "window_rows", "window_cols", "embed_dim", "read_mlp",
           "hidden_size", "num_layers", "num_classes")


def _port_config(cfg):
    return ModelConfig(**{f: getattr(cfg, f) for f in _FIELDS})


def _jax_params(cfg, seed=0):
    params = JaxRokoModel(cfg).init(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params)


def _windows(n, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, C.FEATURE_VOCAB, (n, C.WINDOW_ROWS, C.WINDOW_COLS), dtype=np.uint8)


def test_constants_match_reference():
    for name in ("GAP", "ALPHABET", "ENCODED_GAP", "NUM_CLASSES", "FEATURE_VOCAB",
                 "WINDOW_ROWS", "WINDOW_COLS", "WINDOW_STRIDE", "MAX_INS"):
        assert getattr(C, name) == getattr(JC, name), name


def test_config_defaults_match_reference():
    ref = JaxModelConfig()
    port = ModelConfig()
    for f in _FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
    assert port.gru_in_size == ref.gru_in_size


@pytest.mark.parametrize("kind", ["lingru", "transformer"])
def test_other_kinds_not_ported_yet(kind):
    with pytest.raises(ValueError, match="not ported yet"):
        ModelConfig(kind=kind)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_match_reference(name):
    cfg = CONFIGS[name]
    params = _jax_params(cfg)
    x = _windows(2)
    want = np.asarray(JaxRokoModel(cfg).apply(params, x))

    model = RokoModel(_port_config(cfg))
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, C.WINDOW_COLS, C.NUM_CLASSES)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bridge_round_trips_through_reference_converter(name):
    cfg = CONFIGS[name]
    params = _jax_params(cfg, seed=3)
    back = from_torch_state_dict(state_dict_from_jax(params), cfg)
    flat_a, tree_a = jax.tree.flatten(params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_reference_pth_loads_strict(tmp_path):
    params = _jax_params(TINY_GRU, seed=5)
    path = tmp_path / "model.pth"
    torch.save(state_dict_from_jax(params), str(path))
    model = RokoModel(_port_config(TINY_GRU))
    model.load_state_dict(load_reference_pth(str(path)), strict=True)
    assert torch.equal(model.gru.weight_hh_l1_reverse,
                       torch.from_numpy(params["gru"][1]["bwd"]["w_hh"].T.copy()))

    bad = tmp_path / "bad.pth"
    torch.save({"unrelated": torch.zeros(3)}, str(bad))
    with pytest.raises(ValueError, match="state_dict"):
        load_reference_pth(str(bad))
