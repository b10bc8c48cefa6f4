"""Tests that need a CUDA card: the ``gru_fwd`` kernel against its plain
version, launch counting, input checks and the model on the card. They
skip without a card; run them on one with

    python -m pytest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest

import torch

from roko_tpu_torch.config import ModelConfig
from roko_tpu_torch.models import fused_gru as fg
from roko_tpu_torch.models.model import RokoModel

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


@pytest.mark.parametrize(
    "B,T,H,S",
    [(512, 90, 128, 2), (5, 90, 16, 2), (13, 7, 128, 1), (1, 1, 4, 2), (9, 33, 512, 2)],
)
def test_kernel_matches_plain(cuda, B, T, H, S):
    xp, w, b = _inputs(np.random.default_rng(B + H), B, T, H, S, cuda)
    got = fg.gru_recurrence(xp, w, b)
    want = fg.gru_recurrence_plain(xp, w, b)
    torch.cuda.synchronize()
    assert got.shape == (B, T, S * H)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


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
