"""Tests that need a CUDA card: the ``gru_fwd``, ``gru_bwd``,
``lingru_fwd`` and ``lingru_bwd`` kernels and the bfloat16
``gru_fwd_bf16``, ``lingru_fwd_bf16``, ``gru_bwd_bf16`` and
``lingru_bwd_bf16`` against their plain versions, launch counting, input
checks, determinism, and the model's forward and gradients on the card
for both recurrent kinds, in float32 and bfloat16, and the transformer's
forward on the card against the CPU. They skip without a card; run
them on one with

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


# the full-width shapes, a ragged time tile (T=33, T=40, T=37), channel
# tiles (H=512) and narrow ring rows (H=12 in f32; H % 8 == 0 in bf16)
@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
@pytest.mark.parametrize(
    "dtype,B,T,H",
    [(torch.float32, 512, 90, 128), (torch.float32, 128, 90, 128), (torch.float32, 9, 33, 512),
     (torch.float32, 11, 40, 12), (torch.bfloat16, 512, 90, 128), (torch.bfloat16, 128, 90, 128),
     (torch.bfloat16, 9, 33, 512), (torch.bfloat16, 11, 40, 16), (torch.bfloat16, 3, 37, 24)],
)
def test_lingru_kernels_are_bitwise_equal_across_plans_and_to_streaming(cuda, kernel, dtype,
                                                                       B, T, H):
    """Each channel's walk is one fixed sequence of f32 operations on the
    same inputs (bf16 ones widened) whatever the ring's steps and stages,
    so a staged kernel gives the same bits at every choice of its dtype
    and as its streaming kernel."""
    p, h, dy = (t.to(dtype) for t in _lin_inputs(np.random.default_rng(B + T + H), B, T, H,
                                                  cuda))
    if dtype == torch.bfloat16:
        h = fl.lingru_scan_plain(p)  # the bf16 forward's output
    args = (p,) if kernel == "fwd" else (p, h, dy)
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    launch = getattr(fl, f"_lingru_{kernel}{suffix}_kernel")
    assert fl.scan_plan(B, T, H, _n_sm(cuda), kernel, dtype=dtype)["variant"] == "staged"
    want = launch(*args, variant="streaming")
    for steps, stages in fl.scan_choices(kernel, H, dtype):
        assert torch.equal(launch(*args, steps=steps, stages=stages), want), (steps, stages)
    assert torch.equal(launch(*args), want)
    plain = fl.lingru_scan_plain(p) if kernel == "fwd" else fl.lingru_scan_backward_plain(*args)
    assert want.dtype == plain.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(want, plain, atol=ATOL, rtol=RTOL)
    elif kernel == "fwd":
        torch.testing.assert_close(want.float(), plain.float(), atol=BF16_ATOL, rtol=0)
    else:
        assert beyond_one_bf16_ulp(want, plain) <= BF16_BWD_OF_MAX


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


def test_bf16_lingru_kernels_stream_a_misaligned_input(cuda):
    """A bf16 tensor whose storage starts 2 bytes off a 16-byte boundary
    streams, with the same bits as the staged launch on aligned inputs;
    forced to the staged variant it raises."""
    p, _, dy = _bf16(*_lin_inputs(np.random.default_rng(47), 4, 20, 16, cuda))
    h = fl.lingru_scan_plain(p)

    def shifted(t):
        return torch.empty(t.numel() + 1, device=cuda, dtype=t.dtype)[1:].view_as(t).copy_(t)

    assert not fl.aligned(shifted(dy))
    assert fl.scan_plan(4, 20, 16, _n_sm(cuda), "fwd", dtype=torch.bfloat16)["variant"] == "staged"
    assert torch.equal(fl.lingru_scan(shifted(p)), fl.lingru_scan(p))
    assert torch.equal(fl.lingru_scan_backward(p, h, shifted(dy)),
                       fl.lingru_scan_backward(p, h, dy))
    with pytest.raises(ValueError, match="aligned"):
        fl._lingru_fwd_bf16_kernel(shifted(p), variant="staged")
    with pytest.raises(ValueError, match="aligned"):
        fl._lingru_bwd_bf16_kernel(p, h, shifted(dy), variant="staged")


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


def test_transformer_model_on_card_matches_cpu(cuda, monkeypatch):
    """The tiny transformer's logits on the card against the CPU's: plain
    matrix products, and none of the port's kernels launched."""
    cfg = ModelConfig(kind="transformer", hidden_size=32, d_model=64, num_heads=4,
                      num_layers=2)
    model = RokoModel(cfg).eval()
    x = torch.from_numpy(
        np.random.default_rng(47).integers(0, 12, (4, 200, 90), dtype=np.uint8)
    )
    wrappers = (fg.gru_recurrence, fg.gru_recurrence_backward, fl.lingru_scan,
                fl.lingru_scan_backward)
    for w in wrappers:
        monkeypatch.setattr(w, "launches", 0)
        monkeypatch.setattr(w, "launches_bf16", 0)
    with torch.inference_mode():
        cpu = model(x)
        model.to(cuda)
        got = model(x.to(cuda))
    torch.testing.assert_close(got.cpu(), cpu, atol=1e-5, rtol=1e-4)
    assert all(w.launches == w.launches_bf16 == 0 for w in wrappers)


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


# -- the streaming polish's session and engine on the card ---------------------


def test_session_on_card_predicts_the_unpadded_forward_at_every_rung(cuda):
    """A batch padded to rung 32, 128 or 512 gives each window the class
    ids of the unpadded forward of the same windows."""
    from roko_tpu_torch.serve.session import PolishSession

    model = RokoModel(ModelConfig())
    session = PolishSession(model, device=cuda)
    assert session.ladder == (32, 128, 512)
    x = np.random.default_rng(45).integers(0, 12, (600, 200, 90), dtype=np.uint8)
    for n in (20, 32, 100, 128, 300, 512, 600):
        with torch.inference_mode():
            want = model(torch.from_numpy(x[:n]).to(cuda)).argmax(-1).to(torch.int32).cpu()
        np.testing.assert_array_equal(session.predict(x[:n]), want.numpy())
    assert session.dispatched_shapes == {32, 128, 512}


@pytest.mark.parametrize("kind", ["gru", "lingru"])
def test_streaming_on_card_equals_staged_on_card(cuda, tmp_path, kind):
    """The default polish engine on the card writes the stitch of the
    staged in-memory inference of the same windows, byte for byte, for
    both model kinds (``gru_fwd`` or ``lingru_fwd`` at the ladder's
    rungs)."""
    from roko_tpu_torch.features.pipeline import open_region_stream
    from roko_tpu_torch.infer import run_inference
    from roko_tpu_torch.io.fasta import write_fasta
    from roko_tpu_torch.pipeline import run_streaming_polish
    from roko_tpu_torch.sim import build_synthetic_project

    paths = build_synthetic_project(str(tmp_path / "sim"), genome_len=20_000, seed=3)
    torch.manual_seed(3)
    model = RokoModel(ModelConfig(kind=kind, hidden_size=32, num_layers=2))
    with open_region_stream(paths["draft_fasta"], paths["reads_bam"], workers=2, seed=0,
                            log=lambda s: None) as stream:
        refs = dict(stream.refs)
        batches = [([c] * len(p[i:i + 128]), p[i:i + 128], x[i:i + 128])
                   for c, p, x, _ in stream.results for i in range(0, len(p), 128)]
    staged = run_inference(iter(batches), refs, model, device=cuda, log=lambda s: None)
    write_fasta(str(tmp_path / "staged.fasta"), list(staged.items()))
    out = tmp_path / "stream.fasta"
    run_streaming_polish(paths["draft_fasta"], paths["reads_bam"], model, out_path=str(out),
                         workers=2, batch_size=128, device=cuda, log=lambda s: None)
    assert out.read_bytes() == (tmp_path / "staged.fasta").read_bytes()


def test_session_asked_for_cuda_without_a_card_raises(monkeypatch):
    """No silent move to the CPU (runs with or without a card)."""
    from roko_tpu_torch.serve.session import PolishSession

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        PolishSession(RokoModel(ModelConfig(hidden_size=16, num_layers=1)), device="cuda")


# -- bfloat16: gru_fwd_bf16 and lingru_fwd_bf16 ---------------------------------

#: a bf16 kernel against its bf16 plain loop: both round every h to bf16
#: (4e-3 relative) after summing the step product in f32 in another order,
#: so a rounding may land one bf16 ulp apart and carry into later steps
BF16_ATOL = 1e-2


def _bf16(*tensors):
    return [t.to(torch.bfloat16) for t in tensors]


# the inference rungs (rows 1, 2, 8 a block), ragged shapes, S=1, and H=512
# (the streaming variant); H=20 masks units inside a 16-unit tile, H=48 is
# three whole tiles, B=1 and 9 mask columns of the 8-row tile
@pytest.mark.parametrize(
    "B,T,H,S",
    [(32, 90, 128, 2), (128, 90, 128, 2), (512, 90, 128, 2), (5, 90, 16, 2), (13, 7, 128, 1),
     (1, 1, 4, 2), (9, 33, 512, 2), (1, 90, 20, 2), (9, 33, 20, 1), (1, 40, 48, 1),
     (9, 90, 48, 2)],
)
def test_bf16_gru_kernel_matches_plain(cuda, B, T, H, S):
    xp, w, b = _bf16(*_inputs(np.random.default_rng(B + 2 * H), B, T, H, S, cuda))
    got = fg.gru_recurrence(xp, w, b)
    want = fg.gru_recurrence_plain(xp, w, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, S * H)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_ATOL, rtol=0)
    assert torch.equal(fg.gru_recurrence(xp, w, b), got)


@pytest.mark.parametrize("B,T,H,S", [(37, 25, 128, 2), (13, 11, 40, 1), (9, 33, 20, 2),
                                     (9, 25, 48, 1), (1, 40, 48, 2)])
def test_bf16_gru_kernel_is_bitwise_equal_for_every_rows(cuda, B, T, H, S):
    xp, w, b = _bf16(*_inputs(np.random.default_rng(B * 7 + T), B, T, H, S, cuda))
    assert fg.fwd_plan(B, T, H, S, _n_sm(cuda), dtype=torch.bfloat16)["variant"] == "resident"
    want = fg._gru_fwd_kernel(xp, w, b, rows=1)
    for rows in fg.RESIDENT_ROWS[1:]:
        assert torch.equal(fg._gru_fwd_kernel(xp, w, b, rows=rows), want), rows


def test_bf16_gru_kernel_rejects_a_misaligned_xp(cuda):
    """gru_fwd_bf16 stages xp by 8-byte asynchronous copies: an xp whose
    storage starts 2 bytes off raises, and is not copied to an aligned one."""
    xp, w, b = _bf16(*_inputs(np.random.default_rng(6), 3, 5, 8, 2, cuda))
    shifted = torch.empty(xp.numel() + 1, device=cuda, dtype=torch.bfloat16)[1:].view(xp.shape)
    shifted.copy_(xp)
    with pytest.raises(ValueError, match="8-byte aligned"):
        fg.gru_recurrence(shifted, w, b)


@pytest.mark.parametrize("B,T,H", [(128, 90, 128), (512, 90, 128), (5, 90, 16), (11, 40, 12),
                                   (1, 1, 4), (9, 33, 512)])
def test_bf16_lingru_kernel_matches_plain(cuda, B, T, H):
    p, _, _ = _lin_inputs(np.random.default_rng(B * 5 + H), B, T, H, cuda)
    p = p.to(torch.bfloat16)
    got = fl.lingru_scan(p)
    want = fl.lingru_scan_plain(p)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, 2 * H)
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_ATOL, rtol=0)
    assert torch.equal(fl.lingru_scan(p), got)


def test_bf16_kernels_count_launches_apart_from_f32(cuda, monkeypatch):
    for wrapper in (fg.gru_recurrence, fl.lingru_scan):
        monkeypatch.setattr(wrapper, "launches", 0)
        monkeypatch.setattr(wrapper, "launches_bf16", 0)
    xp, w, b = _bf16(*_inputs(np.random.default_rng(0), 3, 5, 8, 2, cuda))
    fg.gru_recurrence(xp, w, b)
    fl.lingru_scan(_bf16(_lin_inputs(np.random.default_rng(1), 3, 5, 8, cuda)[0])[0])
    assert (fg.gru_recurrence.launches, fg.gru_recurrence.launches_bf16) == (0, 1)
    assert (fl.lingru_scan.launches, fl.lingru_scan.launches_bf16) == (0, 1)


def test_bf16_kernels_reject_what_they_do_not_take(cuda):
    """A bf16 tensor goes to a bf16 kernel or raises: never upcast to an
    f32 kernel, and a mixed-dtype call raises."""
    xp, w, b = _inputs(np.random.default_rng(4), 3, 5, 8, 2, cuda)
    with pytest.raises(ValueError, match="gru_fwd_bf16 takes bfloat16; w_hh is torch.float32"):
        fg.gru_recurrence(xp.to(torch.bfloat16), w, b.to(torch.bfloat16))
    p = _lin_inputs(np.random.default_rng(5), 3, 5, 8, cuda)[0].to(torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        fl.lingru_scan(p.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="lingru_bwd_bf16 takes bfloat16; dy is torch.float32"):
        fl.lingru_scan_backward(p, fl.lingru_scan(p), p[..., :16].float())
    xb, wb, bb = _bf16(xp, w, b)
    out = fg.gru_recurrence(xb, wb, bb)
    with pytest.raises(ValueError, match="gru_bwd_bf16 takes bfloat16; dy is torch.float32"):
        fg.gru_recurrence_backward(xb, wb, bb, out, out.float())
    with pytest.raises(ValueError, match="gru_bwd takes float32; out is torch.bfloat16"):
        fg.gru_recurrence_backward(xp, w, b, out, out.float())


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("kind", ["gru", "lingru"])
def test_bf16_model_on_card_matches_plain_and_cpu(cuda, kind, quantize):
    """The bf16 model (and bf16 + int8) on the card through the kernels
    against the plain recurrence on the card and the whole model on the
    CPU: cuBLAS and the CPU round the bf16 products' sums apart, so the
    logits meet the bf16 bar, not the f32 one."""
    from roko_tpu_torch.models.quant import maybe_quantize

    torch.manual_seed(5)
    cfg = ModelConfig(kind=kind, hidden_size=32, num_layers=2, compute_dtype="bfloat16",
                      quantize=quantize)
    model = maybe_quantize(RokoModel(cfg).eval())
    plain = fg.gru_recurrence_plain if kind == "gru" else fl.lingru_scan_plain
    x = torch.from_numpy(np.random.default_rng(6).integers(0, 12, (4, 200, 90), dtype=np.uint8))
    with torch.inference_mode():
        cpu = model(x)
        model.to(cuda)
        got = model(x.to(cuda))
        ref = model(x.to(cuda), plain)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref, atol=BF16_ATOL, rtol=0)
    torch.testing.assert_close(got.cpu(), cpu, atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["gru", "lingru"])
def test_bf16_streaming_on_card_equals_staged_on_card(cuda, tmp_path, kind):
    """``test_streaming_on_card_equals_staged_on_card`` in bf16: the
    ladder's padded rungs leave every window's class ids as they are."""
    from roko_tpu_torch.features.pipeline import open_region_stream
    from roko_tpu_torch.infer import run_inference
    from roko_tpu_torch.io.fasta import write_fasta
    from roko_tpu_torch.pipeline import run_streaming_polish
    from roko_tpu_torch.sim import build_synthetic_project

    paths = build_synthetic_project(str(tmp_path / "sim"), genome_len=20_000, seed=3)
    torch.manual_seed(3)
    model = RokoModel(ModelConfig(kind=kind, hidden_size=32, num_layers=2,
                                  compute_dtype="bfloat16"))
    with open_region_stream(paths["draft_fasta"], paths["reads_bam"], workers=2, seed=0,
                            log=lambda s: None) as stream:
        refs = dict(stream.refs)
        batches = [([c] * len(p[i:i + 128]), p[i:i + 128], x[i:i + 128])
                   for c, p, x, _ in stream.results for i in range(0, len(p), 128)]
    launches = (fg.gru_recurrence if kind == "gru" else fl.lingru_scan).launches_bf16
    staged = run_inference(iter(batches), refs, model, device=cuda, log=lambda s: None)
    write_fasta(str(tmp_path / "staged.fasta"), list(staged.items()))
    out = tmp_path / "stream.fasta"
    run_streaming_polish(paths["draft_fasta"], paths["reads_bam"], model, out_path=str(out),
                         workers=2, batch_size=128, device=cuda, log=lambda s: None)
    assert out.read_bytes() == (tmp_path / "staged.fasta").read_bytes()
    assert (fg.gru_recurrence if kind == "gru" else fl.lingru_scan).launches_bf16 > launches


# -- bfloat16: gru_bwd_bf16 and lingru_bwd_bf16 ---------------------------------


def beyond_one_bf16_ulp(got, want):
    """The largest excess of |got - want| over one bf16 ulp of the larger
    of the two values, as a share of want's largest entry."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return (((g - w).abs() - ulp).clamp_min(0) / w.abs().max().clamp_min(1e-30)).max().item()


#: a bf16 backward kernel against its plain loop: dxp and dp within one
#: bf16 ulp plus 1e-4 of their largest entry (gru_bwd_bf16 rounds dhp as
#: the carry's operand: where kernel and loop straddle that rounding, dh
#: and every later dxp move a little, and an entry that is a small
#: difference moves by many of its own ulps); dW_hh and db_hh, f32 sums of
#: those operands, within half a bf16 ulp (2e-3) of their largest entry
BF16_BWD_OF_MAX = 1e-4
BF16_DW_OF_MAX = 2e-3


def _bf16_bwd_inputs(rng, B, T, H, S, device):
    xp, w, b = _bf16(*_inputs(rng, B, T, H, S, device))
    out = fg.gru_recurrence_plain(xp, w, b)
    dy = torch.from_numpy(rng.standard_normal((B, T, S * H)).astype(np.float32)).to(device)
    return xp, w, b, out, dy.to(torch.bfloat16)


def _check_gru_bwd_bf16(got, want):
    dxp, dw, db = got
    assert dxp.dtype == torch.bfloat16 and dw.dtype == db.dtype == torch.float32
    assert beyond_one_bf16_ulp(dxp, want[0]) <= BF16_BWD_OF_MAX
    for name, g, w in (("dw_hh", dw, want[1]), ("db_hh", db, want[2])):
        torch.testing.assert_close(g, w, rtol=0, atol=BF16_DW_OF_MAX * w.abs().max().item(),
                                   msg=name)


# the train shape (resident, 2 rows a block on a 132-SM H100), ragged
# shapes, S=1, and the streaming variant at H=512 and 256; for the
# resident mma layout H=20 masks units inside a 16-unit tile and leaves
# two warps, H=48 is three whole tiles, B=1 and 9 mask columns of the
# 8-row tile, T=1 has no previous state at all
@pytest.mark.parametrize(
    "B,T,H,S",
    [(128, 90, 128, 2), (5, 90, 16, 2), (13, 7, 128, 1), (140, 9, 36, 1), (9, 33, 512, 2),
     (11, 9, 256, 1), (1, 90, 20, 2), (9, 33, 20, 1), (9, 40, 48, 1), (1, 25, 48, 2),
     (128, 1, 128, 2), (1, 1, 20, 1)],
)
def test_bf16_gru_bwd_kernel_matches_plain(cuda, B, T, H, S):
    args = _bf16_bwd_inputs(np.random.default_rng(B * 3 + H), B, T, H, S, cuda)
    got = fg.gru_recurrence_backward(*args)
    want = fg.gru_recurrence_backward_plain(*args)
    torch.cuda.synchronize()
    _check_gru_bwd_bf16(got, want)
    again = fg.gru_recurrence_backward(*args)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("B,T,H,S", [(37, 25, 128, 2), (13, 11, 40, 1), (9, 33, 20, 2),
                                     (9, 25, 48, 1), (1, 40, 48, 2), (37, 1, 128, 2),
                                     (1, 1, 20, 1)])
def test_bf16_gru_bwd_kernel_is_bitwise_equal_for_every_rows(cuda, B, T, H, S):
    args = _bf16_bwd_inputs(np.random.default_rng(B + 5 * T), B, T, H, S, cuda)
    assert fg.bwd_plan(B, T, H, S, _n_sm(cuda), dtype=torch.bfloat16)["variant"] == "resident"
    want = fg._gru_bwd_kernel(*args, rows=1)
    for rows in fg.BWD_ROWS[1:]:
        got = fg._gru_bwd_kernel(*args, rows=rows)
        for name, g, w in zip(("dxp", "dw_hh", "db_hh"), got, want):
            assert torch.equal(g, w), (rows, name)
    _check_gru_bwd_bf16(want, fg.gru_recurrence_backward_plain(*args))


@pytest.mark.parametrize("arg", ["xp", "out", "dy"])
def test_bf16_gru_bwd_kernel_rejects_a_misaligned_input(cuda, arg):
    """gru_bwd_bf16 stages xp, out and dy by 8-byte asynchronous copies: a
    tensor whose storage starts 2 bytes off raises, and is not copied to an
    aligned one."""
    args = dict(zip(("xp", "w_hh", "b_hh", "out", "dy"),
                    _bf16_bwd_inputs(np.random.default_rng(7), 3, 5, 8, 2, cuda)))
    t = args[arg]
    shifted = torch.empty(t.numel() + 1, device=cuda, dtype=torch.bfloat16)[1:].view(t.shape)
    shifted.copy_(t)
    args[arg] = shifted
    with pytest.raises(ValueError, match=f"copies {arg} in 8-byte granules"):
        fg.gru_recurrence_backward(*args.values())


def test_bf16_gru_bwd_resident_recurrence_does_not_spill(cuda, tmp_path, monkeypatch):
    """ptxas holds the resident bf16 recurrence (W_hh's 96 fragment
    registers a thread beside the step's working set) without spilling, at
    every rows a block."""
    from chip_smoke import ptxas_usage
    from roko_tpu_torch import kernels

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)  # a fresh build returns its report
    report = kernels.build(["gru_bwd_bf16"])["gru_bwd_bf16"]["ptxas"]
    usage = {n: u for n, u in ptxas_usage(report).items()
             if "gru_bwd_bf16_rec_resident_mma" in n}
    assert len(usage) == len(fg.BWD_ROWS), report
    for name, u in usage.items():
        assert u["spill_stores"] == u["spill_loads"] == 0, (name, u)
        assert u["registers"] <= 255, (name, u)


def test_bf16_gru_bwd_dw_pass_does_not_spill(cuda, tmp_path, monkeypatch):
    """ptxas holds the tensor-core weight-gradient pass (up to 128
    accumulators a thread at H = 512) without spilling, at every k-tiles
    a warp and both h_prev granules."""
    from chip_smoke import ptxas_usage
    from roko_tpu_torch import kernels

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)  # a fresh build returns its report
    report = kernels.build(["gru_bwd_bf16"])["gru_bwd_bf16"]["ptxas"]
    usage = {n: u for n, u in ptxas_usage(report).items() if "gru_bwd_bf16_dw_mma" in n}
    assert len(usage) == 4 * 2, report
    for name, u in usage.items():
        assert u["spill_stores"] == u["spill_loads"] == 0, (name, u)


#: the weight-gradient pass against the float64 sums of its own operands
#: (h_prev and bf16(dhp), products exact in f32): each mma's 16 products
#: summed by the tensor core, then rounded f32 running sums over a split's
#: row groups and the splits
DW_F64_OF_MAX = 1e-5


# every tile edge of the weight-gradient pass: H = 8 and 20 leave k-tiles
# (of 16) partly empty and most warps idle, 36 and 132 are not multiples of
# 8 (h_prev in 8-byte granules) and 132 and 256 take two k-tiles a warp
# (the streaming recurrence); 3H is 24, 60, 108, 384, 396, 768 columns of
# 64-column tiles; B T = 1 .. 11 520 rows in splits of 32-row stages
@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("T", [1, 2, 90])
@pytest.mark.parametrize("B", [1, 3, 128])
@pytest.mark.parametrize("H", [8, 20, 36, 128, 132, 256])
def test_bf16_gru_bwd_dw_pass_matches_plain(cuda, H, B, T, S):
    """gru_bwd_bf16's dW_hh and db_hh within 2e-3 of their largest entry
    of the plain loop's, and within DW_F64_OF_MAX of the float64 sums of
    the kernel's own dhp; every output and the dhp scratch bitwise equal
    across two launches and, on the resident recurrence, to launches
    forced onto each of its rows a block (the recurrence, which writes
    dxp and dhp, is the parent's)."""
    from chip_smoke import h_prev_rows

    args = _bf16_bwd_inputs(np.random.default_rng(H * 7 + B * 3 + T + S), B, T, H, S, cuda)
    dhp = torch.empty(B, T, S * 3 * H, device=cuda)
    got = fg._gru_bwd_kernel(*args, dhp=dhp)
    want = fg.gru_recurrence_backward_plain(*args)
    for name, g, w in (("dw_hh", got[1], want[1]), ("db_hh", got[2], want[2])):
        torch.testing.assert_close(g, w, rtol=0, atol=BF16_DW_OF_MAX * w.abs().max().item(),
                                   msg=lambda m, name=name: f"{name}: {m}")
    h_t = h_prev_rows(torch, args[3], S).transpose(1, 2).double()
    d_rows = dhp.reshape(B * T, S, 3 * H).transpose(0, 1).double()
    f64 = (torch.bmm(h_t, d_rows.to(torch.bfloat16).double()), d_rows.sum(dim=1))
    for name, g, w in (("dw_hh", got[1], f64[0]), ("db_hh", got[2], f64[1])):
        assert (g.double() - w).abs().max().item() <= DW_F64_OF_MAX * w.abs().max().item(), name
    resident = fg.bwd_plan(B, T, H, S, _n_sm(cuda), dtype=torch.bfloat16)["variant"] == "resident"
    for rows in (None, *(fg.BWD_ROWS if resident else ())):
        again = torch.empty_like(dhp)
        other = fg._gru_bwd_kernel(*args, rows=rows, dhp=again)
        assert torch.equal(again, dhp), rows
        for name, g, o in zip(("dxp", "dw_hh", "db_hh"), got, other):
            assert torch.equal(g, o), (rows, name)


def test_bf16_gru_bwd_matches_the_reference_golden_at_c2(cuda):
    """ROADMAP C2: on the card test's draws at H = 256, B = 1 (the streaming
    recurrence) with the reference's own forward output, the kernel's
    dW_hh and db_hh within BF16_DW_OF_MAX of the largest entry of the
    reference's bf16 Pallas route (tests/torch_golden/c2.py), and the plain
    loop's beside them."""
    from tests.torch_golden import c2

    golden = c2.load()
    x, w, b, dy = c2.draw()
    assert c2.digest(x, w, b, dy) == str(golden["draws_sha256"])
    args = tuple(torch.from_numpy(a).to(cuda).to(torch.bfloat16)
                 for a in (x, w, b, golden["y"], dy))
    for who, got in (("kernel", fg.gru_recurrence_backward(*args)),
                     ("plain", fg.gru_recurrence_backward_plain(*args))):
        for name, g, key in (("dw_hh", got[1], "w_hh"), ("db_hh", got[2], "b_hh")):
            want = torch.from_numpy(golden[key]).to(cuda)
            torch.testing.assert_close(g, want, rtol=0,
                                       atol=BF16_DW_OF_MAX * want.abs().max().item(),
                                       msg=lambda m, n=f"{who} {name}": f"{n}: {m}")


@pytest.mark.parametrize("B,T,H", [(128, 90, 128), (512, 90, 128), (5, 90, 16), (11, 40, 12),
                                   (1, 1, 4), (9, 33, 512)])
def test_bf16_lingru_bwd_kernel_matches_plain(cuda, B, T, H):
    p, _, dy = _lin_inputs(np.random.default_rng(B * 9 + H), B, T, H, cuda)
    p, dy = _bf16(p, dy)
    h = fl.lingru_scan_plain(p)
    got = fl.lingru_scan_backward(p, h, dy)
    want = fl.lingru_scan_backward_plain(p, h, dy)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, 4 * H)
    assert beyond_one_bf16_ulp(got, want) <= BF16_BWD_OF_MAX
    assert torch.equal(fl.lingru_scan_backward(p, h, dy), got)


def test_bf16_bwd_kernels_count_launches_apart_from_f32(cuda, monkeypatch):
    for wrapper in (fg.gru_recurrence_backward, fl.lingru_scan_backward):
        monkeypatch.setattr(wrapper, "launches", 0)
        monkeypatch.setattr(wrapper, "launches_bf16", 0)
    fg.gru_recurrence_backward(*_bf16_bwd_inputs(np.random.default_rng(0), 3, 5, 8, 2, cuda))
    p, _, dy = _bf16(*_lin_inputs(np.random.default_rng(1), 3, 5, 8, cuda))
    strided = torch.cat([dy, dy], dim=-1)[..., : dy.shape[-1]]
    fl.lingru_scan_backward(p, fl.lingru_scan_plain(p), strided)
    assert (fg.gru_recurrence_backward.launches, fg.gru_recurrence_backward.launches_bf16) == (0, 1)
    assert (fl.lingru_scan_backward.launches, fl.lingru_scan_backward.launches_bf16) == (0, 1)


#: a bf16 train step through the kernels against the same step through the
#: plain recurrences (on the card) or on the CPU: every gradient is rounded
#: to bf16 once (2^-8 relative), and a rounding of dxp that lands an ulp
#: apart in one layer carries to the layers below, so each gradient is held
#: to a share of its largest entry; the CPU also rounds the front end's
#: bf16 GEMMs apart from cuBLAS
BF16_STEP_OF_MAX = 1e-2
BF16_STEP_CPU_OF_MAX = 2e-2


@pytest.mark.parametrize("kind", ["gru", "lingru"])
def test_bf16_train_step_on_card_matches_plain_and_cpu(cuda, kind, monkeypatch):
    counted = fg.gru_recurrence_backward if kind == "gru" else fl.lingru_scan_backward
    monkeypatch.setattr(counted, "launches_bf16", 0)
    cfg = ModelConfig(kind=kind, hidden_size=32, num_layers=2, dropout=0.0,
                      compute_dtype="bfloat16")
    model = RokoModel(cfg).train()
    plain = fg.gru_recurrence_plain if kind == "gru" else fl.lingru_scan_plain
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.integers(0, 12, (6, 200, 90), dtype=np.uint8))
    y = torch.from_numpy(rng.integers(0, 5, (6, 90)).astype(np.int32))
    w = torch.tensor([1, 1, 1, 1, 0, 0], dtype=torch.float32)

    def grads(recurrence, device):
        model.to(device).zero_grad(set_to_none=True)
        loss, _, _ = loss_and_stats(model(x.to(device), recurrence), y.to(device), w.to(device))
        loss.backward()
        # clones: moving the model moves the gradients it holds
        return loss.item(), {n: p.grad.cpu().clone() for n, p in model.named_parameters()}

    loss_c, cpu = grads(None, "cpu")
    loss_k, got = grads(None, cuda)
    loss_p, want = grads(plain, cuda)
    assert counted.launches_bf16 == cfg.num_layers
    assert abs(loss_k - loss_p) <= 1e-4 * abs(loss_p) and abs(loss_k - loss_c) <= 1e-3
    for name, g in got.items():
        assert g.dtype == torch.float32 and bool(g.abs().sum() > 0), name
        top = want[name].abs().max().item()
        torch.testing.assert_close(g, want[name], rtol=0, atol=BF16_STEP_OF_MAX * top, msg=name)
        torch.testing.assert_close(g, cpu[name], rtol=0, atol=BF16_STEP_CPU_OF_MAX * top,
                                   msg=name)
