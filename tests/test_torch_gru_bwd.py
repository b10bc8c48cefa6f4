"""Gradients of the port's GRU recurrence on the CPU (the plain
reverse-time loop behind ``GRURecurrence``) against ``jax.grad`` through
``roko_tpu.models.pallas_gru.fused_bidir_layer`` in interpret mode, whose
backward runs the Pallas kernels ``_bwd_kernel_v3`` and ``_bwd_kernel``:
the v3 path, the v2 path (``_pick_tblk_v3`` patched to None), the
multi-time-block path (a small ``_VMEM_BUDGET``) and an odd batch."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import roko_tpu.models.pallas_gru as pg
from roko_tpu.models import gru as jgru
from roko_tpu_torch.models import fused_gru as fg
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-4, 1e-5  # f32 on both sides; only the summation order differs

# (batch, in, hidden, patch of the Pallas path)
CASES = {
    "v3": (4, 32, 8, None),
    "v2": (4, 32, 8, "v2"),
    "multi_time_block": (4, 32, 8, "budget"),
    "odd_batch": (5, 32, 8, None),
}


def _layer(rng, in_size, hidden):
    b = 1.0 / np.sqrt(hidden)
    return {
        d: {k: rng.uniform(-b, b, shape).astype(np.float32)
            for k, shape in (("w_ih", (in_size, 3 * hidden)), ("w_hh", (hidden, 3 * hidden)),
                             ("b_ih", (3 * hidden,)), ("b_hh", (3 * hidden,)))}
        for d in ("fwd", "bwd")
    }


def _patch(monkeypatch, patch):
    if patch == "v2":
        monkeypatch.setattr(pg, "_pick_tblk_v3", lambda *a, **k: None)
    elif patch == "budget":
        monkeypatch.setattr(pg, "_VMEM_BUDGET", 64 * 1024)
        assert pg._pick_tblk_v3(90, 2 * 16, 8, 4, bwd=True) < 90  # time really splits


def _port_grads(layer, x, g):
    """Gradients of sum(fused_bidir_layer(layer, x) * g) in the port."""
    tl = {d: {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
          for d, p in layer.items()}
    tx = torch.tensor(x, requires_grad=True)
    out = fg.fused_bidir_layer(tl, tx)
    (out * torch.from_numpy(g)).sum().backward()
    grads = {d: {k: t.grad.numpy() for k, t in p.items()} for d, p in tl.items()}
    return grads, tx.grad.numpy()


def _assert_tree_close(got, want):
    for d in want:
        for k in want[d]:
            np.testing.assert_allclose(got[d][k], want[d][k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{d}.{k}")


@pytest.mark.parametrize("case", list(CASES))
def test_layer_gradients_match_pallas_backward(case, monkeypatch):
    B, in_size, H, patch = CASES[case]
    _patch(monkeypatch, patch)
    rng = np.random.default_rng(20)
    layer = _layer(rng, in_size, H)
    x = rng.standard_normal((B, 90, in_size)).astype(np.float32)
    g = rng.standard_normal((B, 90, 2 * H)).astype(np.float32)

    def loss(lyr, xx):
        return (pg.fused_bidir_layer(lyr, xx, interpret=True) * g).sum()

    want_layer, want_x = jax.grad(loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, layer), jnp.asarray(x))
    got_layer, got_x = _port_grads(layer, x, g)
    _assert_tree_close(got_layer, jax.tree.map(np.asarray, want_layer))
    np.testing.assert_allclose(got_x, np.asarray(want_x), rtol=RTOL, atol=ATOL)


def test_layer_gradients_match_scan_autodiff():
    """The same gradients against autodiff through the lax.scan path."""
    rng = np.random.default_rng(21)
    layer = _layer(rng, 24, 16)
    x = rng.standard_normal((3, 90, 24)).astype(np.float32)
    g = rng.standard_normal((3, 90, 32)).astype(np.float32)
    want_layer, want_x = jax.grad(
        lambda lyr, xx: (jgru.bidir_layer(lyr, xx) * g).sum(), argnums=(0, 1)
    )(jax.tree.map(jnp.asarray, layer), jnp.asarray(x))
    got_layer, got_x = _port_grads(layer, x, g)
    _assert_tree_close(got_layer, jax.tree.map(np.asarray, want_layer))
    np.testing.assert_allclose(got_x, np.asarray(want_x), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("S", [1, 2])
def test_recurrence_gradcheck_f64(S):
    """torch.autograd.gradcheck of GRURecurrence (plain loops) in float64."""
    rng = np.random.default_rng(22 + S)
    B, T, H = 2, 5, 3
    xp = torch.tensor(rng.standard_normal((B, T, S * 3 * H)), requires_grad=True)
    w = torch.tensor(rng.uniform(-0.5, 0.5, (S, H, 3 * H)), requires_grad=True)
    b = torch.tensor(rng.uniform(-0.5, 0.5, (S, 3 * H)), requires_grad=True)
    assert torch.autograd.gradcheck(fg.GRURecurrence.apply, (xp, w, b), eps=1e-6, atol=1e-7)


def test_backward_plain_matches_autograd_of_forward_loop():
    """The reverse-time loop against autograd through the forward loop."""
    rng = np.random.default_rng(24)
    B, T, H, S = 3, 11, 8, 2
    xp = torch.tensor(rng.standard_normal((B, T, S * 3 * H)), requires_grad=True)
    w = torch.tensor(rng.uniform(-0.4, 0.4, (S, H, 3 * H)), requires_grad=True)
    b = torch.tensor(rng.uniform(-0.4, 0.4, (S, 3 * H)), requires_grad=True)
    dy = torch.tensor(rng.standard_normal((B, T, S * H)))
    out = fg.gru_recurrence_plain(xp, w, b)
    want = torch.autograd.grad(out, (xp, w, b), dy)
    got = fg.gru_recurrence_backward_plain(xp.detach(), w.detach(), b.detach(),
                                           out.detach(), dy)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-10, atol=1e-12)


def test_cpu_backward_takes_plain_path_and_counts_no_launch(monkeypatch):
    monkeypatch.setattr(fg.gru_recurrence_backward, "launches", 0)
    monkeypatch.setattr(fg.gru_recurrence, "launches", 0)
    rng = np.random.default_rng(25)
    xp = torch.tensor(rng.standard_normal((2, 6, 48)).astype(np.float32), requires_grad=True)
    w = torch.tensor(rng.uniform(-0.3, 0.3, (2, 8, 24)).astype(np.float32), requires_grad=True)
    b = torch.tensor(rng.uniform(-0.3, 0.3, (2, 24)).astype(np.float32), requires_grad=True)
    out = fg.gru_recurrence(xp, w, b)
    assert out.grad_fn is not None  # F1: the recurrence is on the tape
    out.sum().backward()
    assert all(t.grad is not None for t in (xp, w, b))
    assert fg.gru_recurrence_backward.launches == 0
    assert fg.gru_recurrence.launches == 0


def test_bwd_splits_depend_on_shapes_only():
    assert fg.bwd_splits(128, 90, 128, 2) == fg.bwd_splits(128, 90, 128, 2)
    assert fg.bwd_splits(9, 33, 512, 2) == 1  # 384 tiles fill the card already
    assert fg.bwd_splits(1, 1, 4, 1) == 1
    for B, T, H, S in [(128, 90, 128, 2), (5, 90, 16, 2), (13, 7, 128, 1)]:
        n = fg.bwd_splits(B, T, H, S)
        assert 1 <= n and (n - 1) * -(-(B * T) // n) < B * T  # no empty split


H100_SMS = 132
SMEM_LIMIT = 232_448  # dynamic shared memory a block may ask for on an H100


@pytest.mark.parametrize("B,S,rows", [
    (128, 2, 2),   # the train batch: 128 blocks, one wave
    (512, 2, 8),   # the inference batch: 128 blocks
    (5, 2, 1), (1, 1, 1), (66, 2, 1), (67, 2, 2), (132, 1, 1), (133, 1, 2),
    (264, 2, 4), (265, 2, 8),
    (4096, 2, 8),  # no rows give one wave: the most
])
def test_bwd_rows_fill_one_wave(B, S, rows):
    assert fg.bwd_rows(B, S, H100_SMS) == rows
    assert rows in fg.BWD_ROWS and rows <= 8
    smaller = [r for r in fg.BWD_ROWS if r < rows]
    assert all(S * -(-B // r) > H100_SMS for r in smaller)  # the fewest that fit
    if rows < fg.BWD_ROWS[-1]:
        assert S * -(-B // rows) <= H100_SMS


@pytest.mark.parametrize("H", [4, 8, 16, 64, 124, 128, 132, 256, 512])
def test_bwd_variant_is_resident_up_to_128(H):
    want = "resident" if H <= 128 else "streaming"
    assert fg.bwd_variant(H) == want
    assert fg.bwd_plan(9, 5, H, 2, H100_SMS)["variant"] == want


@pytest.mark.parametrize("rows", fg.BWD_ROWS)
def test_resident_smem_fits_a_block_at_every_width(rows):
    for H in range(4, fg.RESIDENT_MAX_HIDDEN + 1, 4):
        plan = fg.bwd_plan(128, 90, H, 2, H100_SMS, rows=rows)
        assert plan["variant"] == "resident"
        assert plan["smem_bytes"] == 4 * (H * (3 * H + 4) + 8 * rows * H)
        assert plan["smem_bytes"] <= SMEM_LIMIT, (H, rows, plan["smem_bytes"])
    # the widest: W_hh[s] alone is 128 x 388 floats, h_prev and dhp 2 KiB a row
    widest = fg.bwd_plan(128, 90, 128, 2, H100_SMS, rows=rows)["smem_bytes"]
    assert widest == 198_656 + 2 * rows * 2048


def test_bwd_plan_at_the_train_shape_is_one_wave():
    plan = fg.bwd_plan(128, 90, 128, 2, H100_SMS)
    assert plan == dict(variant="resident", rows=2, blocks=128, threads=128,
                        smem_bytes=206_848, splits=fg.bwd_splits(128, 90, 128, 2))
    assert fg.bwd_plan(512, 90, 128, 2, H100_SMS)["blocks"] == 128


def test_bwd_plan_streaming_and_forced_rows():
    plan = fg.bwd_plan(9, 33, 512, 2, H100_SMS)
    assert (plan["variant"], plan["rows"], plan["blocks"]) == ("streaming", 8, 4)
    assert plan["smem_bytes"] == 4 * 8 * 4 * 512
    for rows in fg.BWD_ROWS:
        forced = fg.bwd_plan(128, 90, 128, 2, H100_SMS, rows=rows)
        assert (forced["rows"], forced["blocks"]) == (rows, 2 * -(-128 // rows))
    with pytest.raises(ValueError, match="rows a block"):
        fg.bwd_plan(128, 90, 128, 2, H100_SMS, rows=3)
    with pytest.raises(ValueError, match="streaming"):
        fg.bwd_plan(9, 33, 512, 2, H100_SMS, rows=2)


# gru_bwd_bf16's resident block: W_hh[s] in bf16 [128][3 x 128 + 8], a
# ring of 8 / rows (1 at one row) + 4 steps (one hp pass's steps and 4 more) of a row's xp
# (3 x 128 + 8), dy and h_prev (128 + 8 each), the double-buffered dhp tile
# [2][rows][3 x 128 + 32] and a zero row [128 + 8], laid out for the widest
# H whatever H is
def _bf16_bwd_smem(rows):
    return 2 * (128 * 392 + ((8 // rows if rows >= 2 else 1) + 4) * rows * (392 + 2 * 136) + 2 * rows * 416
                + 136)


@pytest.mark.parametrize("rows", fg.BWD_ROWS)
@pytest.mark.parametrize("H", [16, 20, 48, 128])
def test_bf16_bwd_plan_at_every_rows(H, rows):
    """A warp for each 16 units (at most 8), shared memory within an H100
    block's 227 KB, and the f32 plan's rows, blocks and splits, forced and
    unforced."""
    plan = fg.bwd_plan(128, 90, H, 2, H100_SMS, rows=rows, dtype=torch.bfloat16)
    f32 = fg.bwd_plan(128, 90, H, 2, H100_SMS, rows=rows)
    assert plan["variant"] == "resident" and plan["rows"] == rows
    assert plan["threads"] == 32 * -(-H // 16) <= 256
    assert plan["smem_bytes"] == _bf16_bwd_smem(rows) <= SMEM_LIMIT
    for key in ("variant", "rows", "blocks", "splits"):
        assert plan[key] == f32[key], key
    for B in (1, 9, 128, 512):
        unforced = fg.bwd_plan(B, 90, H, 2, H100_SMS, dtype=torch.bfloat16)
        same = fg.bwd_plan(B, 90, H, 2, H100_SMS)
        assert (unforced["rows"], unforced["blocks"]) == (same["rows"], same["blocks"])
        assert unforced["smem_bytes"] == _bf16_bwd_smem(unforced["rows"])


def test_bf16_bwd_plan_leaves_the_f32_and_streaming_plans_as_they_were():
    """dtype=float32 is the default and gives gru_bwd's resident layout; above
    H=128 both dtypes stream with the same plan."""
    for B, T, H, S in [(128, 90, 128, 2), (5, 90, 16, 2), (13, 7, 128, 1), (9, 33, 512, 2)]:
        assert fg.bwd_plan(B, T, H, S, H100_SMS) == fg.bwd_plan(
            B, T, H, S, H100_SMS, dtype=torch.float32)
    assert fg.bwd_plan(128, 90, 128, 2, H100_SMS) == dict(
        variant="resident", rows=2, blocks=128, threads=128, smem_bytes=206_848,
        splits=fg.bwd_splits(128, 90, 128, 2))
    assert fg.bwd_plan(128, 90, 128, 2, H100_SMS, dtype=torch.bfloat16) == dict(
        variant="resident", rows=2, blocks=128, threads=256, smem_bytes=125_200,
        splits=fg.bwd_splits(128, 90, 128, 2))
    for H in (132, 256, 512):
        assert fg.bwd_plan(9, 33, H, 2, H100_SMS, dtype=torch.bfloat16) == fg.bwd_plan(
            9, 33, H, 2, H100_SMS)


def test_ptxas_usage_reads_registers_and_spills_by_function():
    from chip_smoke import ptxas_usage

    name = "_ZN12_GLOBAL__N_129gru_bwd_bf16_rec_resident_mmaILi8EEEvPK13__nv_bfloat16"
    report = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
        f"ptxas info    : Function properties for {name}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 232 registers, 400 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_Z3dwv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z3dwv",
        "    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 12288 bytes smem, 400 bytes cmem[0]",
    ])
    assert ptxas_usage(report) == {
        name: dict(registers=232, spill_stores=0, spill_loads=0),
        "_Z3dwv": dict(registers=128, spill_stores=4, spill_loads=8),
    }
