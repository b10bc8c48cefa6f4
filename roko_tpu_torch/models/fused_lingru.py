"""Bidirectional lingru layers on the hand-written CUDA scan kernels.

Counterpart of ``roko_tpu/models/pallas_lingru.py``: ``bidir_lingru_layer``
and ``bidir_lingru_stack`` here match its ``bidir_lingru_layer_pallas``
(:256) and ``bidir_lingru_stack_pallas`` (:297), and :class:`LinGRUScan`
stands where its ``custom_vjp`` ``lingru_scan_pallas`` (:230) stood. Its
forward launches ``csrc/lingru_fwd.cu`` (for the Pallas ``_fwd_kernel``)
and its backward ``csrc/lingru_bwd.cu`` (for ``_bwd_kernel``).

Per direction the recurrence is gated by the input alone::

    z_t = sigmoid(p_z)    c_t = tanh(p_c)    h_t = (1 - z_t) h_{t-1} + z_t c_t

from h_0 = 0, where ``p = x @ w4 + b4`` holds the raw gate projections of
both directions, ``w4 = [w_zx_f | w_cx_f | w_zx_b | w_cx_b]``. The
projection stays one plain matrix product outside the kernels, as the
JAX package left it to XLA (:280), so autograd derives ``dx``, ``dw4`` and
``db4`` from the scan's ``dp``. The TPU's time-major direction-stacked
layout, its row padding to 8, its VMEM time blocks, the in-block
Hillis-Steele scan and the boundary rows are not carried over: the
kernels take ``p`` in its natural [B, T, 4H] layout, walk the backward
direction from t = T-1 down to 0 by index, and write [B, T, 2H], which is
already the layer output ``fwd ++ bwd``.

Parameters come in the JAX package's layout, so the tests hand both
sides the same arrays: per direction ``w_zx`` and ``w_cx`` [in, H],
``b_z`` and ``b_c`` [H].
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
from torch.autograd.function import once_differentiable

from roko_tpu_torch import kernels
from roko_tpu_torch.models.layers import dropout as _dropout

Layer = Dict[str, Dict[str, torch.Tensor]]
Scan = Callable[[torch.Tensor], torch.Tensor]


def _hidden(p: torch.Tensor) -> int:
    if p.dim() != 3 or p.shape[2] % 4 or p.shape[2] == 0:
        raise ValueError(f"p must be [B, T, 4H] with H > 0, got {tuple(p.shape)}")
    return p.shape[2] // 4


def _kernel_time(t: torch.Tensor) -> torch.Tensor:
    """[B, T, 2, W] with direction 1 flipped in time, so both directions
    step forward together; its own inverse."""
    return torch.stack([t[:, :, 0], t[:, :, 1].flip(1)], dim=2)


def _gates(p: torch.Tensor, H: int):
    """(z, c) of both directions in kernel time, [B, T, 2, H] each."""
    q = _kernel_time(p.reshape(p.shape[0], p.shape[1], 2, 2 * H))
    return torch.sigmoid(q[..., :H]), torch.tanh(q[..., H:])


def lingru_scan_plain(p: torch.Tensor) -> torch.Tensor:
    """The scan as a Python loop over T: p [B, T, 4H] (the gate
    projections of both directions, biases included) -> h [B, T, 2H] from
    h_0 = 0. Direction 1 runs from t = T-1 down to 0."""
    H = _hidden(p)
    B, T = p.shape[:2]
    z, c = _gates(p, H)
    a, b = 1.0 - z, z * c
    h = p.new_zeros(B, 2, H)
    steps = []
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        steps.append(h)
    out = torch.stack(steps, dim=1) if steps else p.new_zeros(B, 0, 2, H)
    return _kernel_time(out).reshape(B, T, 2 * H)


def lingru_scan_backward_plain(
    p: torch.Tensor, h: torch.Tensor, dy: torch.Tensor
) -> torch.Tensor:
    """Gradient of :func:`lingru_scan_plain` as a reverse-time Python loop
    with the formulas of ``pallas_lingru.py::_bwd_kernel`` (:136-168).
    ``h`` is the forward's output and ``dy`` the gradient arriving at it,
    both [B, T, 2H]. With ``a = 1 - z`` and ``e`` the gradient carried
    into step t from step t+1 (zero past the last step), each step::

        g = dy_t + e;  da = g h_{t-1};  dz = g c - da;  dc = g z
        dp_t = [dz z (1 - z), dc (1 - c^2)];  e <- a_t g

    Returns dp [B, T, 4H]."""
    H = _hidden(p)
    B, T = p.shape[:2]
    z, c = _gates(p, H)
    hk = _kernel_time(h.reshape(B, T, 2, H))
    gk = _kernel_time(dy.reshape(B, T, 2, H))
    e = p.new_zeros(B, 2, H)
    steps = []
    for t in range(T - 1, -1, -1):
        g = gk[:, t] + e
        h_prev = hk[:, t - 1] if t > 0 else torch.zeros_like(e)
        zt, ct = z[:, t], c[:, t]
        da = g * h_prev  # h_t = a_t h_{t-1} + b_t, a = 1 - z, b = z c
        dz = g * ct - da
        dc = g * zt
        steps.append(torch.cat([dz * (zt * (1.0 - zt)), dc * (1.0 - ct * ct)], dim=-1))
        e = (1.0 - zt) * g
    dp = torch.stack(steps[::-1], dim=1) if steps else p.new_zeros(B, 0, 2, 2 * H)
    return _kernel_time(dp).reshape(B, T, 4 * H)


def _lingru_fwd_kernel(p: torch.Tensor) -> torch.Tensor:
    """Launch ``lingru_fwd`` (or raise); counts on ``lingru_scan.launches``."""
    H = _hidden(p)
    kernels.check_inputs("lingru_fwd", p=p)
    B, T = p.shape[:2]
    out = torch.empty(B, T, 2 * H, device=p.device, dtype=torch.float32)
    if B == 0 or T == 0:
        return out
    lib = kernels.library("lingru_fwd")
    with torch.cuda.device(p.device):
        code = lib.roko_lingru_fwd(p.data_ptr(), out.data_ptr(), B, T, H, kernels.stream(p))
    kernels.check(lib, "lingru_fwd", code)
    lingru_scan.launches += 1
    return out


def lingru_scan_backward(
    p: torch.Tensor, h: torch.Tensor, dy: torch.Tensor
) -> torch.Tensor:
    """The gradient of :func:`lingru_scan_backward_plain` in the CUDA
    kernel ``lingru_bwd`` for CUDA tensors (launch or raise), the plain
    loop for CPU tensors. ``lingru_scan_backward.launches`` counts kernel
    launches."""
    H = _hidden(p)
    B, T = p.shape[:2]
    for name, t in (("h", h), ("dy", dy)):
        if tuple(t.shape) != (B, T, 2 * H):
            raise ValueError(f"{name} must be [{B}, {T}, {2 * H}], got {tuple(t.shape)}")
    if kernels.device_kind(p, "lingru_scan_backward") == "cpu":
        return lingru_scan_backward_plain(p, h, dy)
    dy = dy.contiguous()  # slices and cats upstream hand it strided
    kernels.check_inputs("lingru_bwd", p=p, h=h, dy=dy)
    dp = torch.empty_like(p)
    if B == 0 or T == 0:
        return dp
    lib = kernels.library("lingru_bwd")
    with torch.cuda.device(p.device):
        code = lib.roko_lingru_bwd(
            p.data_ptr(), h.data_ptr(), dy.data_ptr(), dp.data_ptr(), B, T, H, kernels.stream(p)
        )
    kernels.check(lib, "lingru_bwd", code)
    lingru_scan_backward.launches += 1
    return dp


lingru_scan_backward.launches = 0


class LinGRUScan(torch.autograd.Function):
    """The scan with its gradient: forward ``lingru_fwd`` and backward
    ``lingru_bwd`` on CUDA tensors, the plain loops on CPU tensors.
    ``apply(p) -> h``; the backward returns ``dp``."""

    @staticmethod
    def forward(ctx, p):
        if kernels.device_kind(p, "lingru_scan") == "cpu":
            h = lingru_scan_plain(p)
        else:
            h = _lingru_fwd_kernel(p)
        ctx.save_for_backward(p, h)
        return h

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        p, h = ctx.saved_tensors
        return lingru_scan_backward(p, h, dy)


def lingru_scan(p: torch.Tensor) -> torch.Tensor:
    """The scan of :func:`lingru_scan_plain`, differentiable through
    :class:`LinGRUScan`: the CUDA kernels for CUDA tensors (launch or
    raise), the plain loops for CPU tensors. ``lingru_scan.launches``
    counts forward kernel launches."""
    _hidden(p)
    return LinGRUScan.apply(p)


lingru_scan.launches = 0


def bidir_lingru_layer(
    layer: Layer, x: torch.Tensor, *, scan: Scan = lingru_scan
) -> torch.Tensor:
    """One bidirectional layer, [B, T, in] -> [B, T, 2H] (fwd ++ bwd), with
    one input product for both directions and one scan launch. ``scan``
    swaps in :func:`lingru_scan_plain` to hold the kernel against it on
    the card."""
    fwd, bwd = layer["fwd"], layer["bwd"]
    w4 = torch.cat([fwd["w_zx"], fwd["w_cx"], bwd["w_zx"], bwd["w_cx"]], dim=1)
    b4 = torch.cat([fwd["b_z"], fwd["b_c"], bwd["b_z"], bwd["b_c"]])
    return scan((torch.matmul(x, w4) + b4).contiguous())  # p [B, T, 4H]


def bidir_lingru_stack(
    layers: Sequence[Layer], x: torch.Tensor, *,
    scan: Scan = lingru_scan,
    dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Stacked bidirectional lingru, [B, T, in] -> [B, T, 2H]. ``dropout``
    (training only) applies between layers only, as
    ``bidir_lingru_stack_pallas`` places it."""
    for i, layer in enumerate(layers):
        x = bidir_lingru_layer(layer, x, scan=scan)
        if i < len(layers) - 1:
            x = _dropout(x, dropout, generator)
    return x
