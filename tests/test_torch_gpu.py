"""Tests that need a CUDA card: the ``gru_fwd``, ``gru_bwd``,
``lingru_fwd`` and ``lingru_bwd`` kernels against their plain versions,
launch counting, input checks, determinism, and the model's forward and
gradients on the card for both kinds. They skip without a
card; run them on one with

    python -m pytest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest

import torch

from roko_tpu_torch.config import ModelConfig
from roko_tpu_torch.models import fused_gru as fg
from roko_tpu_torch.models import fused_lingru as fl
from roko_tpu_torch.models.model import RokoModel
from roko_tpu_torch.training.loop import loss_and_stats

pytestmark = pytest.mark.gpu

ATOL = RTOL = 1e-4  # f32 kernel vs f32 loop: summation order only


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(rng, B, T, H, S, device):
    bound = 1.0 / np.sqrt(H)
    xp = rng.standard_normal((B, T, S * 3 * H))
    w = rng.uniform(-bound, bound, (S, H, 3 * H))
    b = rng.uniform(-bound, bound, (S, 3 * H))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in (xp, w, b)]


def _n_sm(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


# on a 132-SM H100 the resident kernel takes rows 8, 2, 1, 1, 1 a block at
# the first five shapes; H=512 runs the streaming one
@pytest.mark.parametrize(
    "B,T,H,S",
    [(512, 90, 128, 2), (128, 90, 128, 2), (5, 90, 16, 2), (13, 7, 128, 1), (1, 1, 4, 2),
     (9, 33, 512, 2)],
)
def test_kernel_matches_plain(cuda, B, T, H, S):
    xp, w, b = _inputs(np.random.default_rng(B + H), B, T, H, S, cuda)
    got = fg.gru_recurrence(xp, w, b)
    want = fg.gru_recurrence_plain(xp, w, b)
    torch.cuda.synchronize()
    assert got.shape == (B, T, S * H)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("B,T,H,S", [(37, 25, 128, 2), (13, 11, 40, 1)])
def test_kernel_is_bitwise_equal_for_every_rows(cuda, B, T, H, S):
    """Rows of a block never interact and each sums in one order, so the
    resident kernel's output does not depend on its rows a block."""
    xp, w, b = _inputs(np.random.default_rng(B * 5 + T), B, T, H, S, cuda)
    assert fg.fwd_plan(B, T, H, S, _n_sm(cuda))["variant"] == "resident"
    want = fg._gru_fwd_kernel(xp, w, b, rows=1)
    for rows in fg.RESIDENT_ROWS[1:]:
        assert torch.equal(fg._gru_fwd_kernel(xp, w, b, rows=rows), want), rows
    torch.testing.assert_close(want, fg.gru_recurrence_plain(xp, w, b), atol=ATOL, rtol=RTOL)


def test_kernel_is_deterministic(cuda):
    xp, w, b = _inputs(np.random.default_rng(7), 128, 90, 128, 2, cuda)
    assert torch.equal(fg.gru_recurrence(xp, w, b), fg.gru_recurrence(xp, w, b))


def test_kernel_counts_launches(cuda, monkeypatch):
    monkeypatch.setattr(fg.gru_recurrence, "launches", 0)
    xp, w, b = _inputs(np.random.default_rng(0), 3, 5, 8, 2, cuda)
    fg.gru_recurrence(xp, w, b)
    fg.gru_recurrence(xp, w, b)
    assert fg.gru_recurrence.launches == 2


def test_kernel_rejects_what_it_does_not_take(cuda):
    xp, w, b = _inputs(np.random.default_rng(1), 3, 5, 8, 2, cuda)
    with pytest.raises(ValueError, match="float32"):
        fg.gru_recurrence(xp.double(), w.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        fg.gru_recurrence(xp.transpose(0, 1).contiguous().transpose(0, 1), w, b)
    with pytest.raises(ValueError, match="is on"):
        fg.gru_recurrence(xp, w.cpu(), b)
    xp6, w6, b6 = _inputs(np.random.default_rng(2), 3, 5, 6, 2, cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        fg.gru_recurrence(xp6, w6, b6)


def test_model_on_card_matches_plain_and_cpu(cuda):
    cfg = ModelConfig(hidden_size=32, num_layers=2)
    torch.manual_seed(0)
    model = RokoModel(cfg).eval()
    x = torch.from_numpy(
        np.random.default_rng(3).integers(0, 12, (4, 200, 90), dtype=np.uint8)
    )
    with torch.inference_mode():
        cpu = model(x)
        model.to(cuda)
        got = model(x.to(cuda))
        plain = model(x.to(cuda), fg.gru_recurrence_plain)
    torch.testing.assert_close(got, plain, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(got.cpu(), cpu, atol=ATOL, rtol=RTOL)


def _bwd_inputs(rng, B, T, H, S, device):
    xp, w, b = _inputs(rng, B, T, H, S, device)
    out = fg.gru_recurrence_plain(xp, w, b)
    dy = torch.from_numpy(rng.standard_normal((B, T, S * H)).astype(np.float32)).to(device)
    return xp, w, b, out, dy


# on a 132-SM H100 the resident recurrence takes rows 2, 8, 1, 1, 4, 2 a
# block at the first six shapes; the last two run the streaming one
@pytest.mark.parametrize(
    "B,T,H,S",
    [(128, 90, 128, 2), (512, 90, 128, 2), (5, 90, 16, 2), (13, 7, 128, 1), (200, 20, 64, 2),
     (140, 9, 36, 1), (9, 33, 512, 2), (11, 9, 256, 1)],
)
def test_bwd_kernel_matches_plain(cuda, B, T, H, S):
    args = _bwd_inputs(np.random.default_rng(B * 7 + H), B, T, H, S, cuda)
    got = fg.gru_recurrence_backward(*args)
    want = fg.gru_recurrence_backward_plain(*args)
    torch.cuda.synchronize()
    for name, g, w in zip(("dxp", "dw_hh", "db_hh"), got, want):
        assert g.shape == w.shape, name
        torch.testing.assert_close(g, w, atol=ATOL, rtol=RTOL, msg=name)


@pytest.mark.parametrize("B,T,H,S", [(37, 25, 128, 2), (13, 11, 40, 1)])
def test_bwd_kernel_is_bitwise_equal_for_every_rows(cuda, B, T, H, S):
    """Rows of a block never interact and each sums in one order, so the
    resident recurrence's outputs do not depend on its rows a block."""
    args = _bwd_inputs(np.random.default_rng(B + T), B, T, H, S, cuda)
    assert fg.bwd_plan(B, T, H, S, _n_sm(cuda))["variant"] == "resident"
    want = fg._gru_bwd_kernel(*args, rows=1)
    for rows in fg.BWD_ROWS[1:]:
        got = fg._gru_bwd_kernel(*args, rows=rows)
        for name, g, w in zip(("dxp", "dw_hh", "db_hh"), got, want):
            assert torch.equal(g, w), (rows, name)
    plain = fg.gru_recurrence_backward_plain(*args)
    for name, g, w in zip(("dxp", "dw_hh", "db_hh"), want, plain):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=RTOL, msg=name)


def test_bwd_kernel_is_deterministic(cuda):
    args = _bwd_inputs(np.random.default_rng(4), 128, 90, 128, 2, cuda)
    a = fg.gru_recurrence_backward(*args)
    b = fg.gru_recurrence_backward(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_bwd_kernel_counts_launches_and_takes_strided_dy(cuda, monkeypatch):
    monkeypatch.setattr(fg.gru_recurrence_backward, "launches", 0)
    xp, w, b, out, dy = _bwd_inputs(np.random.default_rng(5), 6, 9, 8, 2, cuda)
    strided = torch.cat([dy, dy], dim=-1)[..., : dy.shape[-1]]
    assert not strided.is_contiguous()
    got = fg.gru_recurrence_backward(xp, w, b, out, strided)
    want = fg.gru_recurrence_backward(xp, w, b, out, dy)
    assert fg.gru_recurrence_backward.launches == 2
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_bwd_kernel_rejects_what_it_does_not_take(cuda):
    xp, w, b, out, dy = _bwd_inputs(np.random.default_rng(6), 3, 5, 8, 2, cuda)
    with pytest.raises(ValueError, match="float32"):
        fg.gru_recurrence_backward(xp.double(), w.double(), b.double(), out.double(), dy.double())
    with pytest.raises(ValueError, match="must be"):
        fg.gru_recurrence_backward(xp, w, b, out[:, :4].contiguous(), dy)
    with pytest.raises(ValueError, match="is on"):
        fg.gru_recurrence_backward(xp, w, b, out.cpu(), dy)


def test_model_gradients_on_card_match_plain(cuda, monkeypatch):
    """F1: on the card every parameter gets a gradient through the
    kernels, equal to the gradient through the plain recurrence."""
    monkeypatch.setattr(fg.gru_recurrence_backward, "launches", 0)
    cfg = ModelConfig(hidden_size=32, num_layers=2, dropout=0.0)
    model = RokoModel(cfg).to(cuda).train()
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.integers(0, 12, (6, 200, 90), dtype=np.uint8)).to(cuda)
    y = torch.from_numpy(rng.integers(0, 5, (6, 90)).astype(np.int32)).to(cuda)
    w = torch.tensor([1, 1, 1, 1, 0, 0], dtype=torch.float32, device=cuda)

    def grads(recurrence):
        model.zero_grad(set_to_none=True)
        loss, _, _ = loss_and_stats(model(x, recurrence), y, w)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in model.named_parameters()}

    loss_k, got = grads(fg.gru_recurrence)
    loss_p, want = grads(fg.gru_recurrence_plain)
    assert fg.gru_recurrence_backward.launches == cfg.num_layers
    torch.testing.assert_close(loss_k, loss_p, atol=ATOL, rtol=RTOL)
    for name, g in got.items():
        assert g is not None and bool(g.abs().sum() > 0), name
        torch.testing.assert_close(g, want[name], atol=ATOL, rtol=RTOL, msg=name)


# -- lingru -------------------------------------------------------------------


def _lin_inputs(rng, B, T, H, device):
    """p [B, T, 4H], the plain forward's h and a gradient dy [B, T, 2H]."""
    p = torch.from_numpy(rng.standard_normal((B, T, 4 * H)).astype(np.float32)).to(device)
    dy = torch.from_numpy(rng.standard_normal((B, T, 2 * H)).astype(np.float32)).to(device)
    return p, fl.lingru_scan_plain(p), dy


@pytest.mark.parametrize(
    "B,T,H", [(512, 90, 128), (128, 90, 128), (5, 90, 16), (11, 40, 12), (1, 1, 4), (9, 33, 512)]
)
def test_lingru_kernels_match_plain(cuda, B, T, H):
    p, h_plain, dy = _lin_inputs(np.random.default_rng(B * 3 + H), B, T, H, cuda)
    h = fl.lingru_scan(p)
    dp = fl.lingru_scan_backward(p, h_plain, dy)
    dp_plain = fl.lingru_scan_backward_plain(p, h_plain, dy)
    torch.cuda.synchronize()
    assert h.shape == (B, T, 2 * H) and dp.shape == p.shape
    torch.testing.assert_close(h, h_plain, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(dp, dp_plain, atol=ATOL, rtol=RTOL)


def test_lingru_bwd_is_bitwise_repeatable(cuda):
    p, h, dy = _lin_inputs(np.random.default_rng(40), 128, 90, 128, cuda)
    assert torch.equal(fl.lingru_scan_backward(p, h, dy), fl.lingru_scan_backward(p, h, dy))


def test_lingru_fwd_is_bitwise_repeatable(cuda):
    p, _, _ = _lin_inputs(np.random.default_rng(45), 128, 90, 128, cuda)
    assert torch.equal(fl.lingru_scan(p), fl.lingru_scan(p))


# the full-width shapes, a ragged time tile (T=33, T=40), channel tiles
# (H=512) and a narrow ring row (H=12)
@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
@pytest.mark.parametrize("B,T,H", [(512, 90, 128), (128, 90, 128), (9, 33, 512), (11, 40, 12)])
def test_lingru_kernels_are_bitwise_equal_across_plans_and_to_streaming(cuda, kernel, B, T, H):
    """Each channel's walk is one fixed sequence of f32 operations whatever
    the ring's steps and stages, so a staged kernel gives the same bits at
    every choice and as its streaming kernel."""
    p, h, dy = _lin_inputs(np.random.default_rng(B + T + H), B, T, H, cuda)
    args = (p,) if kernel == "fwd" else (p, h, dy)
    launch = fl._lingru_fwd_kernel if kernel == "fwd" else fl._lingru_bwd_kernel
    assert fl.scan_plan(B, T, H, _n_sm(cuda), kernel)["variant"] == "staged"
    want = launch(*args, variant="streaming")
    for steps, stages in fl.scan_choices(kernel, H):
        assert torch.equal(launch(*args, steps=steps, stages=stages), want), (steps, stages)
    plain = fl.lingru_scan_plain(p) if kernel == "fwd" else fl.lingru_scan_backward_plain(*args)
    torch.testing.assert_close(want, plain, atol=ATOL, rtol=RTOL)


def test_lingru_kernels_stream_a_misaligned_input(cuda):
    p, h, dy = _lin_inputs(np.random.default_rng(46), 4, 20, 16, cuda)

    def shifted(t):
        return torch.empty(t.numel() + 1, device=cuda)[1:].view_as(t).copy_(t)

    assert not fl.aligned(shifted(dy))
    assert torch.equal(fl.lingru_scan(shifted(p)), fl.lingru_scan(p))
    assert torch.equal(fl.lingru_scan_backward(p, h, shifted(dy)),
                       fl.lingru_scan_backward(p, h, dy))
    with pytest.raises(ValueError, match="aligned"):
        fl._lingru_fwd_kernel(shifted(p), variant="staged")
    with pytest.raises(ValueError, match="aligned"):
        fl._lingru_bwd_kernel(p, h, shifted(dy), variant="staged")


def test_lingru_kernels_count_launches_and_take_strided_dy(cuda, monkeypatch):
    monkeypatch.setattr(fl.lingru_scan, "launches", 0)
    monkeypatch.setattr(fl.lingru_scan_backward, "launches", 0)
    p, h, dy = _lin_inputs(np.random.default_rng(41), 6, 9, 8, cuda)
    fl.lingru_scan(p)
    strided = torch.cat([dy, dy], dim=-1)[..., : dy.shape[-1]]
    assert not strided.is_contiguous()
    got = fl.lingru_scan_backward(p, h, strided)
    want = fl.lingru_scan_backward(p, h, dy)
    assert fl.lingru_scan.launches == 1
    assert fl.lingru_scan_backward.launches == 2
    assert torch.equal(got, want)


def test_lingru_kernels_reject_what_they_do_not_take(cuda):
    p, h, dy = _lin_inputs(np.random.default_rng(42), 3, 5, 8, cuda)
    with pytest.raises(ValueError, match="float32"):
        fl.lingru_scan(p.double())
    with pytest.raises(ValueError, match="float32"):
        fl.lingru_scan_backward(p.double(), h.double(), dy.double())
    with pytest.raises(ValueError, match="contiguous"):
        fl.lingru_scan(p.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="contiguous"):
        fl.lingru_scan_backward(p, h.transpose(0, 1).contiguous().transpose(0, 1), dy)
    with pytest.raises(ValueError, match="is on"):
        fl.lingru_scan_backward(p, h.cpu(), dy)
    with pytest.raises(ValueError, match="is on"):
        fl.lingru_scan_backward(p, h, dy.cpu())


def test_lingru_model_on_card_matches_plain_and_cpu(cuda):
    model = RokoModel(ModelConfig(kind="lingru", hidden_size=32, num_layers=2)).eval()
    x = torch.from_numpy(
        np.random.default_rng(43).integers(0, 12, (4, 200, 90), dtype=np.uint8)
    )
    with torch.inference_mode():
        cpu = model(x)
        model.to(cuda)
        got = model(x.to(cuda))
        plain = model(x.to(cuda), fl.lingru_scan_plain)
    torch.testing.assert_close(got, plain, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(got.cpu(), cpu, atol=ATOL, rtol=RTOL)


def test_lingru_model_gradients_on_card_match_plain(cuda, monkeypatch):
    """F1's check for LinGRUScan: on the card every parameter gets a
    gradient through the kernels, equal to the one through the plain
    scan."""
    monkeypatch.setattr(fl.lingru_scan_backward, "launches", 0)
    cfg = ModelConfig(kind="lingru", hidden_size=32, num_layers=2, dropout=0.0)
    model = RokoModel(cfg).to(cuda).train()
    rng = np.random.default_rng(44)
    x = torch.from_numpy(rng.integers(0, 12, (6, 200, 90), dtype=np.uint8)).to(cuda)
    y = torch.from_numpy(rng.integers(0, 5, (6, 90)).astype(np.int32)).to(cuda)
    w = torch.tensor([1, 1, 1, 1, 0, 0], dtype=torch.float32, device=cuda)

    def grads(scan):
        model.zero_grad(set_to_none=True)
        loss, _, _ = loss_and_stats(model(x, scan), y, w)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in model.named_parameters()}

    loss_k, got = grads(fl.lingru_scan)
    loss_p, want = grads(fl.lingru_scan_plain)
    assert fl.lingru_scan_backward.launches == cfg.num_layers
    torch.testing.assert_close(loss_k, loss_p, atol=ATOL, rtol=RTOL)
    for name, g in got.items():
        assert g is not None and bool(g.abs().sum() > 0), name
        torch.testing.assert_close(g, want[name], atol=ATOL, rtol=RTOL, msg=name)
