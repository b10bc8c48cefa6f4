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
    block's 227 KB, the f32 plan's rows and blocks, forced and unforced,
    and the splits of the bf16 weight-gradient pass."""
    plan = fg.bwd_plan(128, 90, H, 2, H100_SMS, rows=rows, dtype=torch.bfloat16)
    f32 = fg.bwd_plan(128, 90, H, 2, H100_SMS, rows=rows)
    assert plan["variant"] == "resident" and plan["rows"] == rows
    assert plan["threads"] == 32 * -(-H // 16) <= 256
    assert plan["smem_bytes"] == _bf16_bwd_smem(rows) <= SMEM_LIMIT
    for key in ("variant", "rows", "blocks"):
        assert plan[key] == f32[key], key
    assert plan["splits"] == plan["dw"]["splits"] == fg.dw_splits(128, 90, H, 2)
    for B in (1, 9, 128, 512):
        unforced = fg.bwd_plan(B, 90, H, 2, H100_SMS, dtype=torch.bfloat16)
        same = fg.bwd_plan(B, 90, H, 2, H100_SMS)
        assert (unforced["rows"], unforced["blocks"]) == (same["rows"], same["blocks"])
        assert unforced["smem_bytes"] == _bf16_bwd_smem(unforced["rows"])


def test_bf16_bwd_plan_leaves_the_f32_and_streaming_plans_as_they_were():
    """dtype=float32 is the default and gives gru_bwd's resident layout and
    its splits; above H=128 both dtypes stream with the same recurrence
    plan. The bf16 plan adds its weight-gradient pass's (``dw``), whose
    splits it launches with."""
    for B, T, H, S in [(128, 90, 128, 2), (5, 90, 16, 2), (13, 7, 128, 1), (9, 33, 512, 2)]:
        assert fg.bwd_plan(B, T, H, S, H100_SMS) == fg.bwd_plan(
            B, T, H, S, H100_SMS, dtype=torch.float32)
        assert "dw" not in fg.bwd_plan(B, T, H, S, H100_SMS)
    # gru_bwd's splits: two blocks an SM over its 64 x 64 tiles
    assert [fg.bwd_splits(*shape) for shape in [(128, 90, 128, 2), (512, 90, 128, 2),
                                                (13, 7, 128, 1), (5, 90, 16, 2),
                                                (9, 33, 512, 2)]] == [11, 11, 1, 2, 1]
    assert fg.bwd_plan(128, 90, 128, 2, H100_SMS) == dict(
        variant="resident", rows=2, blocks=128, threads=128, smem_bytes=206_848,
        splits=fg.bwd_splits(128, 90, 128, 2))
    assert fg.bwd_plan(128, 90, 128, 2, H100_SMS, dtype=torch.bfloat16) == dict(
        variant="resident", rows=2, blocks=128, threads=256, smem_bytes=125_200,
        splits=22, dw=fg.dw_plan(128, 90, 128, 2))
    for H in (132, 256, 512):
        bf16 = fg.bwd_plan(9, 33, H, 2, H100_SMS, dtype=torch.bfloat16)
        assert bf16.pop("dw") == fg.dw_plan(9, 33, H, 2)
        f32 = fg.bwd_plan(9, 33, H, 2, H100_SMS)
        assert bf16.pop("splits") == fg.dw_splits(9, 33, H, 2)
        f32.pop("splits")
        assert bf16 == f32


@pytest.mark.parametrize("B,T,H,S,tile,splits,blocks,per_sm", [
    (128, 90, 128, 2, (128, 64), 22, 264, 2),  # the train shape: two blocks an SM
    (512, 90, 128, 2, (128, 64), 22, 264, 2),
    (13, 7, 128, 1, (128, 64), 1, 6, 2),       # 91 rows: one split
    (5, 90, 16, 2, (16, 64), 2, 4, 2),         # at least 256 rows a split
    (9, 33, 256, 2, (256, 64), 2, 48, 2),      # two k-tiles a warp
    (128, 90, 512, 2, (512, 64), 3, 144, 1),   # four: one block an SM
    (9, 33, 512, 2, (512, 64), 2, 96, 1),
    (1, 1, 20, 1, (32, 64), 1, 1, 2),          # k and c padded to the tile
    (3, 2, 132, 2, (144, 64), 1, 14, 2),
])
def test_dw_plan_is_a_function_of_the_shapes(B, T, H, S, tile, splits, blocks, per_sm):
    """gru_bwd_bf16's weight-gradient pass: every k of H (up to whole
    k-tiles of 16) by 64 columns a block, (3H / 64 column tiles) x S x
    splits blocks of 256 threads, as many splits as fill 132 SMs with the
    blocks one holds (two up to 2 k-tiles a warp), the splits a function
    of the shapes alone (not of the card's SMs or the recurrence's rows)."""
    plan = fg.dw_plan(B, T, H, S)
    assert (plan["tile"], plan["splits"], plan["blocks"], plan["threads"],
            plan["blocks_per_sm"]) == (tile, splits, blocks, 256, per_sm)
    assert plan["splits"] == fg.dw_splits(B, T, H, S)
    assert plan["k_tiles_per_warp"] == -(-tile[0] // 16 // 8)
    for n_sm in (H100_SMS, 114, 1):
        for rows in ((None,) + fg.BWD_ROWS if H <= 128 else (None,)):
            got = fg.bwd_plan(B, T, H, S, n_sm, rows=rows, dtype=torch.bfloat16)
            assert got["dw"] == plan and got["splits"] == splits
    N, per = B * T, -(-(B * T) // splits)
    assert (splits - 1) * per < N  # no empty split


def test_dw_smem_fits_a_block_at_every_width():
    """The ring of 4 stages of 32 rows (a bf16 h_prev row of the tile's k
    and 16 bytes, 64 f32 of dhp) and the bf16 operand tile [32][72]: within
    an H100 block's 227 KB at every H the kernel takes, with at most 4
    k-tiles a warp (MT, the kernel's template), and two blocks within an
    SM's 228 KB (1 KB of it each block's) wherever the plan puts two."""
    for H in range(4, fg.MAX_HIDDEN + 1, 4):
        plan = fg.dw_plan(128, 90, H, 2)
        hpad = -(-H // 16) * 16
        assert plan["tile"] == (hpad, 64) and hpad - H < 16
        assert plan["smem_bytes"] == 4 * 32 * (2 * (hpad + 8) + 4 * 64) + 2 * 32 * 72
        assert plan["smem_bytes"] <= SMEM_LIMIT, (H, plan["smem_bytes"])
        assert 1 <= plan["k_tiles_per_warp"] <= 4
        assert plan["blocks_per_sm"] * (plan["smem_bytes"] + 1024) <= 228 * 1024, H
    # the widest: 166.5 KB, one block an SM
    assert fg.dw_plan(128, 90, fg.MAX_HIDDEN, 2)["smem_bytes"] == 170_496


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


# -- the bf16 weight-gradient pass's order of sums vs the reference ------------

BF16_DW_OF_MAX = 2e-3  # dW_hh and db_hh: the card's bar against the plain loop


def _bf16_exact(rng, shape, scale=1.0):
    """Normal values that bf16 holds exactly, as float32."""
    a = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
    return a.to(torch.bfloat16).float().numpy()


def dw_twin(out, dhp, S, splits):
    """gru_bwd_bf16's weight-gradient pass in plain torch, in its order of
    sums over rows: out [B, T, S*H] (the forward output; h_prev is out at
    t - 1 in direction 0 and t + 1 in direction 1, zero at the direction's
    start) and the unrounded dhp [B, T, S*3H] -> dW_hh [S, H, 3H] and db_hh
    [S, 3H] in float32. The rows n = b T + t fall in ``splits`` fixed
    contiguous ranges; in each, every 16 rows' ``h_prev^T bf16(dhp)``
    (bf16 operands, products summed in float32) is added to one running
    sum, and db sums dhp as it is, one row at a time; then the splits are
    added in order. Within 16 rows the sum is torch's, not the tensor
    core's."""
    B, T, SH = out.shape
    H = SH // S
    h = out.float().reshape(B, T, S, H)
    prev = torch.zeros_like(h)
    prev[:, 1:, 0] = h[:, :-1, 0]
    if S == 2:
        prev[:, :-1, 1] = h[:, 1:, 1]
    h_rows = prev.reshape(B * T, S, H).transpose(0, 1)  # [S, N, H], bf16 values
    d_rows = dhp.reshape(B * T, S, 3 * H).transpose(0, 1)
    d_ops = d_rows.to(torch.bfloat16).float()
    N = B * T
    per = -(-N // splits)
    dw, db = dhp.new_zeros(S, H, 3 * H), dhp.new_zeros(S, 3 * H)
    for p in range(splits):
        n0, n1 = min(N, p * per), min(N, (p + 1) * per)
        part_w, part_b = dhp.new_zeros(S, H, 3 * H), dhp.new_zeros(S, 3 * H)
        for k in range(n0, n1, 16):
            ke = min(k + 16, n1)
            part_w = part_w + torch.bmm(h_rows[:, k:ke].transpose(1, 2), d_ops[:, k:ke])
        for n in range(n0, n1):
            part_b = part_b + d_rows[:, n]
        dw, db = dw + part_w, db + part_b
    return dw, db


def _twin_draw(case):
    """(B, H, w_hh, b_hh, x, g) of a case of :func:`dw_twin_vs_pallas`,
    T = 90 and S = 2, as float32 values that bf16 holds: for ``v3`` and
    ``odd_batch`` normal draws at CASES' batch and hidden size; for
    ``card_c2`` the draws of the card test
    ``test_torch_gpu.py::test_bf16_gru_bwd_dw_pass_matches_plain`` at H =
    256, B = 1 (its seed H*7 + B*3 + T + S, xp normal, W_hh and b_hh
    uniform within 1/sqrt(H), dy normal), the one shape where the kernel
    misses its bar against the plain loop on the card (ROADMAP C2)."""
    T, S = 90, 2
    if case == "card_c2":
        B, H = 1, 256
        rng = np.random.default_rng(H * 7 + B * 3 + T + S)
        bound = 1.0 / np.sqrt(H)
        draws = (rng.standard_normal((B, T, S * 3 * H)), rng.uniform(-bound, bound, (S, H, 3 * H)),
                 rng.uniform(-bound, bound, (S, 3 * H)), rng.standard_normal((B, T, S * H)))
        x, w, b, g = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()
                      for a in draws)
        return B, H, w, b, x, g
    B, _, H, _ = CASES[case]
    rng = np.random.default_rng(26 if case == "v3" else 27)
    bound = 1.0 / np.sqrt(H)
    wb = [(_bf16_exact(rng, (H, 3 * H), bound), _bf16_exact(rng, (3 * H,), bound))
          for _ in range(S)]
    x = _bf16_exact(rng, (B, T, S * 3 * H))
    g = _bf16_exact(rng, (B, T, S * H))
    return B, H, np.stack([w for w, _ in wb]), np.stack([b for _, b in wb]), x, g


def dw_twin_vs_pallas(case):
    """:func:`dw_twin` beside dW_hh and db_hh of ``jax.vjp`` through the
    reference's Pallas layer (``_bwd_kernel_v3``) with
    ``compute_dtype=bfloat16`` in interpret mode, on the draws of
    :func:`_twin_draw`. Both sides see the same inputs: an identity input
    projection (``xp`` is ``x`` exactly on both sides), the reference's
    own forward output as h and the same bf16 cotangent; the dhp comes
    from the port's plain bf16 loop. Returns {"twin": {splits: (dW, db)},
    "ref": (dW, db), "plain": the plain loop's (dW, db), "args": the plain
    loop's (xp, w_hh, b_hh, out, dy)}."""
    B, H, w, b, x, g = _twin_draw(case)
    T, S = x.shape[1], 2
    eye = np.eye(S * 3 * H, dtype=np.float32)
    layer = {d: {"w_ih": eye[:, i * 3 * H:(i + 1) * 3 * H],
                 "b_ih": np.zeros(3 * H, np.float32), "w_hh": w[i], "b_hh": b[i]}
             for i, d in enumerate(("fwd", "bwd"))}

    y, vjp = jax.vjp(lambda lyr: pg.fused_bidir_layer(
        lyr, jnp.asarray(x), interpret=True, compute_dtype=jnp.bfloat16),
        jax.tree.map(jnp.asarray, layer))
    (want,) = vjp(jnp.asarray(g, dtype=y.dtype))
    ref = tuple(torch.from_numpy(np.stack([np.asarray(want[d][k], np.float32)
                                           for d in ("fwd", "bwd")]))
                for k in ("w_hh", "b_hh"))

    def bf16(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    args = (bf16(x), bf16(w), bf16(b), bf16(y), bf16(g))
    dhp = torch.empty(B, T, S * 3 * H)
    _, loop_w, loop_b = fg.gru_recurrence_backward_plain(*args, dhp_out=dhp)
    return {"twin": {splits: dw_twin(args[3], dhp, S, splits)
                     for splits in sorted({1, 3, fg.dw_splits(B, T, H, S)})},
            "ref": ref, "plain": (loop_w, loop_b), "args": args}


@pytest.mark.parametrize("case", ["v3", "odd_batch", "card_c2"])
def test_dw_twin_matches_pallas_bf16_backward(case):
    """:func:`dw_twin_vs_pallas`: the twin within 2e-3 of each tensor's
    largest entry of the reference's bf16 Pallas route, at every split
    count, and of the plain loop's own sums within 1e-5. At ``card_c2``
    this is the reference's witness for the plain loop that the card test
    holds the kernel to."""
    got = dw_twin_vs_pallas(case)
    for splits, twin in got["twin"].items():
        for name, g, want, plain in zip(("dw_hh", "db_hh"), twin, got["ref"], got["plain"]):
            torch.testing.assert_close(g, want, rtol=0,
                                       atol=BF16_DW_OF_MAX * want.abs().max().item(),
                                       msg=f"{name} at {splits} splits")
            # the plain loop's sums, in another order
            torch.testing.assert_close(g, plain, rtol=0,
                                       atol=1e-5 * plain.abs().max().item(), msg=name)


def test_backward_plain_hands_out_its_dhp():
    """``dhp_out`` takes each step's unrounded dhp = [dr, dz, dn r] at its
    own time index, and changes nothing the loop returns; db_hh is its sum
    over the rows."""
    rng = np.random.default_rng(28)
    B, T, H, S = 3, 6, 8, 2
    xp = torch.from_numpy(_bf16_exact(rng, (B, T, S * 3 * H))).to(torch.bfloat16)
    w = torch.from_numpy(_bf16_exact(rng, (S, H, 3 * H), 0.3)).to(torch.bfloat16)
    b = torch.from_numpy(_bf16_exact(rng, (S, 3 * H), 0.3)).to(torch.bfloat16)
    dy = torch.from_numpy(_bf16_exact(rng, (B, T, S * H))).to(torch.bfloat16)
    out = fg.gru_recurrence_plain(xp, w, b)
    dhp = torch.full((B, T, S * 3 * H), float("nan"))
    got = fg.gru_recurrence_backward_plain(xp, w, b, out, dy, dhp_out=dhp)
    want = fg.gru_recurrence_backward_plain(xp, w, b, out, dy)
    assert all(torch.equal(a, c) for a, c in zip(got, want))
    assert torch.isfinite(dhp).all()
    dxp = got[0].float().reshape(B, T, S, 3 * H)
    d = dhp.reshape(B, T, S, 3 * H)
    # dr and dz are dxp's before its rounding to bf16
    torch.testing.assert_close(d[..., :2 * H].to(torch.bfloat16).float(), dxp[..., :2 * H],
                               rtol=0, atol=0)
    torch.testing.assert_close(d.sum(dim=(0, 1)), got[2], rtol=1e-5, atol=1e-5)
