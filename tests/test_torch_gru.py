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


H100_SMS = 132
SMEM_LIMIT = 232_448  # dynamic shared memory a block may ask for on an H100


@pytest.mark.parametrize("B,S,rows,blocks", [
    (512, 2, 8, 128),  # the inference batch: one wave
    (128, 2, 2, 128),  # the train batch: one wave, where 8 rows gave 32 blocks
    (5, 2, 1, 10), (66, 2, 1, 132), (67, 2, 2, 68), (265, 2, 8, 68),
    (4096, 2, 8, 1024),  # no rows give one wave: the most
])
def test_fwd_plan_fills_one_wave(B, S, rows, blocks):
    plan = fg.fwd_plan(B, 90, 128, S, H100_SMS)
    assert (plan["variant"], plan["rows"], plan["blocks"]) == ("resident", rows, blocks)
    assert plan["rows"] == fg.resident_rows(B, S, H100_SMS) == fg.bwd_rows(B, S, H100_SMS)


def test_fwd_plan_at_the_full_width_shapes():
    assert fg.fwd_plan(512, 90, 128, 2, H100_SMS) == dict(
        variant="resident", rows=8, blocks=128, threads=256, smem_bytes=206_848)
    assert fg.fwd_plan(128, 90, 128, 2, H100_SMS) == dict(
        variant="resident", rows=2, blocks=128, threads=128, smem_bytes=200_704)


@pytest.mark.parametrize("H", [4, 8, 16, 64, 124, 128, 132, 256, 512])
def test_fwd_variant_is_resident_up_to_128(H):
    want = "resident" if H <= 128 else "streaming"
    assert fg.fwd_variant(H) == want == fg.bwd_variant(H)
    assert fg.fwd_plan(9, 5, H, 2, H100_SMS)["variant"] == want


@pytest.mark.parametrize("rows", fg.RESIDENT_ROWS)
def test_fwd_resident_smem_fits_a_block_at_every_width(rows):
    for H in range(4, fg.RESIDENT_MAX_HIDDEN + 1, 4):
        plan = fg.fwd_plan(128, 90, H, 2, H100_SMS, rows=rows)
        assert plan["variant"] == "resident"
        assert plan["smem_bytes"] == 4 * (H * (3 * H + 4) + 2 * rows * H)
        assert plan["smem_bytes"] <= SMEM_LIMIT, (H, rows, plan["smem_bytes"])
    # the widest: W_hh[s] alone is 128 x 388 floats, the h buffers 1 KiB a row
    widest = fg.fwd_plan(128, 90, 128, 2, H100_SMS, rows=rows)["smem_bytes"]
    assert widest == 198_656 + rows * 1024


def test_fwd_plan_streaming_and_forced_rows():
    plan = fg.fwd_plan(9, 33, 512, 2, H100_SMS)
    assert (plan["variant"], plan["rows"], plan["blocks"]) == ("streaming", 8, 4)
    assert plan["smem_bytes"] == 4 * 2 * 8 * 512
    for rows, threads in zip(fg.RESIDENT_ROWS, (128, 128, 256, 256)):  # two groups from 4 up
        forced = fg.fwd_plan(512, 90, 128, 2, H100_SMS, rows=rows)
        assert (forced["rows"], forced["blocks"]) == (rows, 2 * -(-512 // rows))
        assert forced["threads"] == threads
        assert fg.fwd_plan(512, 90, 40, 2, H100_SMS, rows=rows)["threads"] == threads // 2
    with pytest.raises(ValueError, match="rows a block"):
        fg.fwd_plan(128, 90, 128, 2, H100_SMS, rows=3)
    with pytest.raises(ValueError, match="streaming gru_fwd"):
        fg.fwd_plan(9, 33, 512, 2, H100_SMS, rows=2)
