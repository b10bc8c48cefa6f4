"""Bidirectional GRU layers on the hand-written CUDA recurrence kernels.

Counterpart of ``roko_tpu/models/pallas_gru.py``: ``fused_bidir_layer``
and ``bidir_gru_stack`` here match its ``fused_bidir_layer`` (:697) and
``bidir_gru_stack_pallas`` (:711), and :class:`GRURecurrence` stands where
its ``custom_vjp`` ``_gru_multi`` (:417) stood. Its forward launches
``csrc/gru_fwd.cu`` (for the Pallas ``_fwd_kernel_v3`` / ``_fwd_kernel``)
and its backward ``csrc/gru_bwd.cu`` (for ``_bwd_kernel_v3`` /
``_bwd_kernel``).

The input projection ``x @ W_ih + b_ih`` for every step and both
directions stays one plain matrix product outside the kernels, as
``_xproj_stacked`` left it to XLA, so autograd derives ``dx``, ``dW_ih``
and ``db_ih`` from the recurrence's ``dxp`` as ``_finish_bwd`` did. The
TPU's time-major stacked layout, batch padding, VMEM block choice and
boundary rows are not carried over: the kernels take the projection in
its natural [B, T, S*3H] layout, walk the backward direction by index and
read and write [B, T, S*H], which is already the layer output
``fwd ++ bwd``.

Parameters come in the JAX package's layout, so the tests hand both
sides the same arrays: per direction ``w_ih`` [in, 3H], ``w_hh`` [H, 3H],
``b_ih`` and ``b_hh`` [3H], gate order (r, z, n).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from roko_tpu_torch import kernels
from roko_tpu_torch.models.layers import dropout as _dropout

Layer = Dict[str, Dict[str, torch.Tensor]]
Recurrence = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

#: the kernels' widest hidden size (MAX_THREADS in csrc/gru_fwd.cu, gru_bwd.cu)
MAX_HIDDEN = 512
#: blocks the weight-gradient pass of gru_bwd aims for: two per SM of an H100
_BWD_TARGET_BLOCKS = 2 * 132
#: the weight-gradient pass's output tile (TK x TC in csrc/gru_bwd.cu)
_BWD_TILE = 64


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


def _check_cuda(name: str, H: int, **tensors: torch.Tensor) -> None:
    """What the kernels take: :func:`kernels.check_inputs`, and H a
    multiple of 4 and at most MAX_HIDDEN."""
    kernels.check_inputs(name, **tensors)
    if H % 4 or H > MAX_HIDDEN:
        raise ValueError(
            f"{name} takes a hidden size that is a multiple of 4 and at "
            f"most {MAX_HIDDEN}; got {H}"
        )


def _prev_steps(T: int, S: int, step: int):
    """Time index of each direction at reverse sweep ``step`` and the
    index of its previous state (None at the sequence start)."""
    ts = [T - 1 - step, step][:S]
    prev = [t - 1 if t > 0 else None for t in ts[:1]]
    prev += [t + 1 if t < T - 1 else None for t in ts[1:]]
    return ts, prev


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


def gru_recurrence_backward_plain(
    xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
    out: torch.Tensor, dy: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of :func:`gru_recurrence_plain` as a reverse-time Python
    loop with the formulas of ``pallas_gru.py::_bwd_kernel_v3`` (:252-285).
    ``out`` is the forward's output and ``dy`` the gradient arriving at
    it, both [B, T, S*H]. Each step recomputes the gates from the stored
    previous state, then::

        dh += dy;  dz = dh (h_prev - n) z (1 - z);  dn = dh (1 - z)(1 - n^2)
        dr = dn hp_n r (1 - r)           (hp_n with its bias b_hn)
        dxp = [dr, dz, dn];  dhp = [dr, dz, dn r]
        dh <- dh z + dhp W_hh^T;  dW_hh += h_prev^T dhp;  db_hh += sum dhp

    Returns dxp [B, T, S*3H], dW_hh [S, H, 3H] and db_hh [S, 3H]."""
    B, T, S, H = _shapes(xp, w_hh, b_hh)
    x = xp.reshape(B, T, S, 3 * H)
    hs = out.reshape(B, T, S, H)
    g = dy.reshape(B, T, S, H)
    dxp = xp.new_empty(B, T, S, 3 * H)
    dw = w_hh.new_zeros(S, H, 3 * H)
    db = b_hh.new_zeros(S, 3 * H)
    dh = xp.new_zeros(S, B, H)
    zero = xp.new_zeros(B, H)
    for step in range(T):
        ts, prev = _prev_steps(T, S, step)
        xt = torch.stack([x[:, t, s] for s, t in enumerate(ts)])  # [S, B, 3H]
        h_prev = torch.stack(
            [zero if p is None else hs[:, p, s] for s, p in enumerate(prev)]
        )
        hp = torch.bmm(h_prev, w_hh) + b_hh[:, None]
        r = torch.sigmoid(xt[..., :H] + hp[..., :H])
        z = torch.sigmoid(xt[..., H : 2 * H] + hp[..., H : 2 * H])
        hpn = hp[..., 2 * H :]
        n = torch.tanh(xt[..., 2 * H :] + r * hpn)
        dh = dh + torch.stack([g[:, t, s] for s, t in enumerate(ts)])
        dz = dh * (h_prev - n) * z * (1.0 - z)
        dn = dh * (1.0 - z) * (1.0 - n * n)
        dr = dn * hpn * r * (1.0 - r)
        dhp = torch.cat([dr, dz, dn * r], dim=-1)  # [S, B, 3H]
        da = torch.cat([dr, dz, dn], dim=-1)
        for s, t in enumerate(ts):
            dxp[:, t, s] = da[s]
        dh = dh * z + torch.bmm(dhp, w_hh.transpose(1, 2))
        dw = dw + torch.bmm(h_prev.transpose(1, 2), dhp)
        db = db + dhp.sum(dim=1)
    return dxp.reshape(B, T, S * 3 * H), dw, db


def _gru_fwd_kernel(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """Launch ``gru_fwd`` (or raise); counts on ``gru_recurrence.launches``."""
    B, T, S, H = _shapes(xp, w_hh, b_hh)
    _check_cuda("gru_fwd", H, xp=xp, w_hh=w_hh, b_hh=b_hh)
    out = torch.empty(B, T, S * H, device=xp.device, dtype=torch.float32)
    if B == 0 or T == 0:
        return out
    lib = kernels.library("gru_fwd")
    with torch.cuda.device(xp.device):
        code = lib.roko_gru_fwd(
            xp.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), out.data_ptr(),
            B, T, H, S, kernels.stream(xp),
        )
    kernels.check(lib, "gru_fwd", code)
    gru_recurrence.launches += 1
    return out


def bwd_splits(B: int, T: int, H: int, S: int) -> int:
    """Row splits of gru_bwd's weight-gradient pass: enough blocks to fill
    the card, each split summing a fixed contiguous range of the B*T rows.
    A function of the shapes only, so two runs sum in the same order."""
    tiles = S * -(-H // _BWD_TILE) * -(-3 * H // _BWD_TILE)
    rows = max(B * T, 1)
    return max(1, min(-(-_BWD_TARGET_BLOCKS // tiles), -(-rows // 256)))


def gru_recurrence_backward(
    xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
    out: torch.Tensor, dy: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients of :func:`gru_recurrence_backward_plain` in the CUDA
    kernel ``gru_bwd`` for CUDA tensors (launch or raise), the plain loop
    for CPU tensors. ``gru_recurrence_backward.launches`` counts kernel
    launches."""
    B, T, S, H = _shapes(xp, w_hh, b_hh)
    if kernels.device_kind(xp, "gru_recurrence_backward") == "cpu":
        return gru_recurrence_backward_plain(xp, w_hh, b_hh, out, dy)
    dy = dy.contiguous()  # slices and cats upstream hand it strided
    _check_cuda("gru_bwd", H, xp=xp, w_hh=w_hh, b_hh=b_hh, out=out, dy=dy)
    for name, t in (("out", out), ("dy", dy)):
        if tuple(t.shape) != (B, T, S * H):
            raise ValueError(f"{name} must be [{B}, {T}, {S * H}], got {tuple(t.shape)}")
    f32 = dict(device=xp.device, dtype=torch.float32)
    dxp = torch.empty_like(xp)
    dw = torch.zeros(S, H, 3 * H, **f32)
    db = torch.zeros(S, 3 * H, **f32)
    if B == 0 or T == 0:
        return dxp, dw, db
    nsplit = bwd_splits(B, T, H, S)
    w_t = w_hh.transpose(1, 2).contiguous()  # [S, 3H, H]: coalesced W^T rows
    dhp = torch.empty_like(xp)
    part_w = torch.empty(nsplit, S, H, 3 * H, **f32)
    part_b = torch.empty(nsplit, S, 3 * H, **f32)
    lib = kernels.library("gru_bwd")
    with torch.cuda.device(xp.device):
        code = lib.roko_gru_bwd(
            xp.data_ptr(), out.data_ptr(), dy.data_ptr(), w_hh.data_ptr(),
            w_t.data_ptr(), b_hh.data_ptr(), dxp.data_ptr(), dhp.data_ptr(),
            part_w.data_ptr(), part_b.data_ptr(), dw.data_ptr(), db.data_ptr(),
            B, T, H, S, nsplit, kernels.stream(xp),
        )
    kernels.check(lib, "gru_bwd", code)
    gru_recurrence_backward.launches += 1
    return dxp, dw, db


gru_recurrence_backward.launches = 0


class GRURecurrence(torch.autograd.Function):
    """The recurrence with its gradient: forward ``gru_fwd`` and backward
    ``gru_bwd`` on CUDA tensors, the plain loops on CPU tensors.
    ``apply(xp, w_hh, b_hh) -> out``; the backward returns
    ``(dxp, dW_hh, db_hh)``."""

    @staticmethod
    def forward(ctx, xp, w_hh, b_hh):
        if kernels.device_kind(xp, "gru_recurrence") == "cpu":
            out = gru_recurrence_plain(xp, w_hh, b_hh)
        else:
            out = _gru_fwd_kernel(xp, w_hh, b_hh)
        ctx.save_for_backward(xp, w_hh, b_hh, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        xp, w_hh, b_hh, out = ctx.saved_tensors
        return gru_recurrence_backward(xp, w_hh, b_hh, out, dy)


def gru_recurrence(
    xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> torch.Tensor:
    """The recurrence of :func:`gru_recurrence_plain`, differentiable
    through :class:`GRURecurrence`: the CUDA kernels for CUDA tensors
    (launch or raise), the plain loops for CPU tensors.
    ``gru_recurrence.launches`` counts forward kernel launches."""
    _shapes(xp, w_hh, b_hh)
    return GRURecurrence.apply(xp, w_hh, b_hh)


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
    dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Stacked bidirectional GRU, [B, T, in] -> [B, T, 2H]. ``dropout``
    (training only) applies to every layer's output but the last, the
    ``torch.nn.GRU`` placement (``roko_tpu/models/gru.py:164-170``)."""
    for i, layer in enumerate(layers):
        x = fused_bidir_layer(layer, x, recurrence=recurrence)
        if i < len(layers) - 1:
            x = _dropout(x, dropout, generator)
    return x
