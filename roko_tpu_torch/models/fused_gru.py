"""Bidirectional GRU layers on the hand-written CUDA recurrence kernel.

Counterpart of the forward half of ``roko_tpu/models/pallas_gru.py``:
``fused_bidir_layer`` and ``bidir_gru_stack`` here match its
``fused_bidir_layer`` (:697) and ``bidir_gru_stack_pallas`` (:711), and
``gru_recurrence`` stands where its forward Pallas kernels
``_fwd_kernel_v3`` / ``_fwd_kernel`` stood (``csrc/gru_fwd.cu``).

The input projection ``x @ W_ih + b_ih`` for every step and both
directions stays one plain matrix product outside the kernel, as
``_xproj_stacked`` left it to XLA. The TPU's time-major stacked layout,
batch padding and VMEM block choice are not carried over: the kernel
takes the projection in its natural [B, T, S*3H] layout, walks the
backward direction by index and writes [B, T, S*H], which is already the
layer output ``fwd ++ bwd``.

Parameters come in the JAX package's layout, so the tests hand both
sides the same arrays: per direction ``w_ih`` [in, 3H], ``w_hh`` [H, 3H],
``b_ih`` and ``b_hh`` [3H], gate order (r, z, n).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from roko_tpu_torch import kernels

Layer = Dict[str, Dict[str, torch.Tensor]]
Recurrence = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

#: the kernel's widest hidden size (MAX_THREADS in csrc/gru_fwd.cu)
MAX_HIDDEN = 512


def _shapes(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor):
    if w_hh.dim() != 3 or w_hh.shape[2] != 3 * w_hh.shape[1]:
        raise ValueError(f"w_hh must be [S, H, 3H], got {tuple(w_hh.shape)}")
    S, H, H3 = w_hh.shape
    if S not in (1, 2):
        raise ValueError(f"S must be 1 (forward) or 2 (forward, backward), got {S}")
    if tuple(b_hh.shape) != (S, H3):
        raise ValueError(f"b_hh must be [{S}, {H3}], got {tuple(b_hh.shape)}")
    if xp.dim() != 3 or xp.shape[2] != S * H3:
        raise ValueError(f"xp must be [B, T, {S * H3}], got {tuple(xp.shape)}")
    B, T, _ = xp.shape
    return B, T, S, H


def gru_recurrence_plain(
    xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> torch.Tensor:
    """The recurrence as a Python loop over T: xp [B, T, S*3H] (the input
    projection, biases included), w_hh [S, H, 3H], b_hh [S, 3H] ->
    h [B, T, S*H] from h_0 = 0. Direction 1, when present, runs from
    t = T-1 down to 0."""
    B, T, S, H = _shapes(xp, w_hh, b_hh)
    x = xp.reshape(B, T, S, 3 * H)
    out = xp.new_empty(B, T, S, H)
    h = xp.new_zeros(S, B, H)
    for step in range(T):
        ts = [step, T - 1 - step][:S]
        xt = torch.stack([x[:, t, s] for s, t in enumerate(ts)])  # [S, B, 3H]
        hp = torch.bmm(h, w_hh) + b_hh[:, None]
        r = torch.sigmoid(xt[..., :H] + hp[..., :H])
        z = torch.sigmoid(xt[..., H : 2 * H] + hp[..., H : 2 * H])
        n = torch.tanh(xt[..., 2 * H :] + r * hp[..., 2 * H :])
        h = (1.0 - z) * n + z * h
        for s, t in enumerate(ts):
            out[:, t, s] = h[s]
    return out.reshape(B, T, S * H)


def gru_recurrence(
    xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> torch.Tensor:
    """The recurrence of :func:`gru_recurrence_plain` in the CUDA kernel
    ``gru_fwd`` for a CUDA tensor (launch or raise), the plain loop for a
    CPU tensor. ``gru_recurrence.launches`` counts kernel launches."""
    B, T, S, H = _shapes(xp, w_hh, b_hh)
    if xp.device.type == "cpu":
        return gru_recurrence_plain(xp, w_hh, b_hh)
    if xp.device.type != "cuda":
        raise ValueError(f"gru_recurrence runs on cuda or cpu, not {xp.device}")
    for name, t in (("xp", xp), ("w_hh", w_hh), ("b_hh", b_hh)):
        if t.device != xp.device:
            raise ValueError(f"{name} is on {t.device}, xp on {xp.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"gru_fwd takes float32; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"gru_fwd takes contiguous tensors; {name} is not")
    if H % 4 or H > MAX_HIDDEN:
        raise ValueError(
            f"gru_fwd takes a hidden size that is a multiple of 4 and at "
            f"most {MAX_HIDDEN}; got {H}"
        )
    out = torch.empty(B, T, S * H, device=xp.device, dtype=torch.float32)
    if B == 0 or T == 0:
        return out
    lib = kernels.library("gru_fwd")
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        code = lib.roko_gru_fwd(
            xp.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), out.data_ptr(),
            B, T, H, S, stream,
        )
    kernels.check(lib, "gru_fwd", code)
    gru_recurrence.launches += 1
    return out


gru_recurrence.launches = 0


def fused_bidir_layer(
    layer: Layer, x: torch.Tensor, *, recurrence: Recurrence = gru_recurrence
) -> torch.Tensor:
    """One bidirectional layer, [B, T, in] -> [B, T, 2H] (fwd ++ bwd), with
    one input product for both directions and one recurrence launch.
    ``recurrence`` swaps in :func:`gru_recurrence_plain` to hold the
    kernel against it on the card."""
    fwd, bwd = layer["fwd"], layer["bwd"]
    w_ih = torch.cat([fwd["w_ih"], bwd["w_ih"]], dim=1)  # [in, 6H]
    b_ih = torch.cat([fwd["b_ih"], bwd["b_ih"]])
    xp = torch.matmul(x, w_ih) + b_ih  # [B, T, 6H]
    w_hh = torch.stack([fwd["w_hh"], bwd["w_hh"]])  # [2, H, 3H]
    b_hh = torch.stack([fwd["b_hh"], bwd["b_hh"]])  # [2, 3H]
    return recurrence(xp.contiguous(), w_hh.contiguous(), b_hh.contiguous())


def bidir_gru_stack(
    layers: Sequence[Layer], x: torch.Tensor, *,
    recurrence: Recurrence = gru_recurrence,
) -> torch.Tensor:
    """Stacked bidirectional GRU in inference mode, [B, T, in] ->
    [B, T, 2H]."""
    for layer in layers:
        x = fused_bidir_layer(layer, x, recurrence=recurrence)
    return x
