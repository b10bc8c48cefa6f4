"""The port's bidirectional GRU layer and stack (plain recurrence on the
CPU) against the JAX package: the Pallas kernels in interpret mode on
their v3, v2 and multi-time-block paths, and the lax.scan path."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import roko_tpu.models.pallas_gru as pg
from roko_tpu.models import gru as jgru
from roko_tpu_torch.models import fused_gru as fg
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = ATOL = 1e-5  # f32 on both sides; only the summation order differs


def _layer(rng, in_size, hidden):
    b = 1.0 / np.sqrt(hidden)
    return {
        d: {
            "w_ih": rng.uniform(-b, b, (in_size, 3 * hidden)).astype(np.float32),
            "w_hh": rng.uniform(-b, b, (hidden, 3 * hidden)).astype(np.float32),
            "b_ih": rng.uniform(-b, b, (3 * hidden,)).astype(np.float32),
            "b_hh": rng.uniform(-b, b, (3 * hidden,)).astype(np.float32),
        }
        for d in ("fwd", "bwd")
    }


def _torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


# (batch, in, hidden, patch of the Pallas path)
CASES = {
    "v3": (4, 32, 8, None),
    "v2": (4, 32, 8, "v2"),
    "multi_time_block": (4, 32, 8, "budget"),
    "odd_batch": (5, 32, 8, None),
    "h16_in24": (4, 24, 16, None),
}


def _patch(monkeypatch, patch):
    if patch == "v2":
        monkeypatch.setattr(pg, "_pick_tblk_v3", lambda *a, **k: None)
    elif patch == "budget":
        monkeypatch.setattr(pg, "_VMEM_BUDGET", 64 * 1024)
        assert pg._pick_tblk_v3(90, 2 * 16, 8, 4) < 90  # time really splits


@pytest.mark.parametrize("case", list(CASES))
def test_fused_bidir_layer_matches_pallas_and_scan(case, monkeypatch):
    B, in_size, H, patch = CASES[case]
    _patch(monkeypatch, patch)
    rng = np.random.default_rng(10)
    layer = _layer(rng, in_size, H)
    x = rng.standard_normal((B, 90, in_size)).astype(np.float32)

    got = fg.fused_bidir_layer(_torch(layer), torch.from_numpy(x)).numpy()
    pallas = np.asarray(pg.fused_bidir_layer(_jax(layer), jnp.asarray(x), interpret=True))
    scan = np.asarray(jgru.bidir_layer(_jax(layer), jnp.asarray(x)))
    assert got.shape == (B, 90, 2 * H)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, scan, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_bidir_gru_stack_matches_pallas_and_scan(case, monkeypatch):
    B, in_size, H, patch = CASES[case]
    _patch(monkeypatch, patch)
    rng = np.random.default_rng(11)
    layers = (_layer(rng, in_size, H), _layer(rng, 2 * H, H))
    x = rng.standard_normal((B, 90, in_size)).astype(np.float32)

    got = fg.bidir_gru_stack(_torch(layers), torch.from_numpy(x)).numpy()
    pallas = np.asarray(
        pg.bidir_gru_stack_pallas(_jax(layers), jnp.asarray(x), interpret=True)
    )
    scan = np.asarray(jgru.bidir_gru_stack(_jax(layers), jnp.asarray(x)))
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, scan, rtol=RTOL, atol=ATOL)


def test_forward_only_recurrence_matches_scan_direction():
    """S=1 runs the forward direction alone."""
    rng = np.random.default_rng(12)
    p = _layer(rng, 24, 8)["fwd"]
    x = rng.standard_normal((3, 17, 24)).astype(np.float32)
    xp = torch.from_numpy(x @ p["w_ih"] + p["b_ih"])
    got = fg.gru_recurrence(
        xp, torch.from_numpy(p["w_hh"])[None], torch.from_numpy(p["b_hh"])[None]
    ).numpy()
    want = np.asarray(jgru.gru_direction(_jax(p), jnp.asarray(x), reverse=False))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_wrapper_on_cpu_takes_plain_path_and_counts_no_launch(monkeypatch):
    monkeypatch.setattr(fg.gru_recurrence, "launches", 0)
    rng = np.random.default_rng(13)
    xp = torch.from_numpy(rng.standard_normal((2, 9, 2 * 3 * 8)).astype(np.float32))
    w_hh = torch.from_numpy(rng.standard_normal((2, 8, 24)).astype(np.float32))
    b_hh = torch.from_numpy(rng.standard_normal((2, 24)).astype(np.float32))
    got = fg.gru_recurrence(xp, w_hh, b_hh)
    assert torch.equal(got, fg.gru_recurrence_plain(xp, w_hh, b_hh))
    assert fg.gru_recurrence.launches == 0


@pytest.mark.parametrize(
    "xp_shape,w_shape,b_shape",
    [
        ((2, 9, 48), (2, 8, 20), (2, 24)),  # w_hh not [S, H, 3H]
        ((2, 9, 48), (3, 8, 24), (3, 24)),  # more than two directions
        ((2, 9, 40), (2, 8, 24), (2, 24)),  # xp width is not S*3H
        ((2, 9, 48), (2, 8, 24), (2, 1, 24)),  # b_hh not [S, 3H]
    ],
)
def test_wrapper_rejects_bad_shapes(xp_shape, w_shape, b_shape):
    with pytest.raises(ValueError):
        fg.gru_recurrence(torch.zeros(xp_shape), torch.zeros(w_shape), torch.zeros(b_shape))
