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
``b_z`` and ``b_c`` [H]; a matrix may be an int8 weight
(``models/quant.py``), dequantized here to the input's dtype.

The input's dtype is the compute dtype. In bfloat16 the projection runs
in bf16 and the scan reads bf16, computes in f32 and writes bf16, as the
Pallas kernel does with a bf16 input (:44-45, :99); on a card it launches
``csrc/lingru_fwd_bf16.cu``. Its gradient reads p, h and dy in bf16, runs
the gates and the e-scan in f32 and stores dp in bf16 (``_bwd_kernel``
:121-168, ``dp_ref.dtype``); on a card it launches
``csrc/lingru_bwd_bf16.cu``. Both have the f32 kernels' two variants,
staged or streaming by :func:`scan_plan` with ``dtype=torch.bfloat16``.
A bf16 tensor on a card goes to a bf16 kernel or raises: never to a
float32 one, nor to the plain loop.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence

import torch
from torch.autograd.function import once_differentiable

from roko_tpu_torch import kernels
from roko_tpu_torch.models.layers import dropout as _dropout
from roko_tpu_torch.models.layers import weight as _weight

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
    h_0 = 0. Direction 1 runs from t = T-1 down to 0. A bfloat16 p is
    widened to f32, scanned in f32 and each h rounded to bf16, as
    ``lingru_fwd_bf16`` computes it."""
    H = _hidden(p)
    B, T = p.shape[:2]
    q = p.to(torch.promote_types(p.dtype, torch.float32))
    z, c = _gates(q, H)
    a, b = 1.0 - z, z * c
    h = q.new_zeros(B, 2, H)
    steps = []
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        steps.append(h)
    out = torch.stack(steps, dim=1) if steps else q.new_zeros(B, 0, 2, H)
    return _kernel_time(out).reshape(B, T, 2 * H).to(p.dtype)


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

    Returns dp [B, T, 4H] in p's dtype. bfloat16 inputs widen to f32, the
    gates and e are f32 and dp is rounded to bf16 at the end, as
    ``lingru_bwd_bf16`` computes it."""
    H = _hidden(p)
    B, T = p.shape[:2]
    acc = torch.promote_types(p.dtype, torch.float32)
    z, c = _gates(p.to(acc), H)
    hk = _kernel_time(h.to(acc).reshape(B, T, 2, H))
    gk = _kernel_time(dy.to(acc).reshape(B, T, 2, H))
    e = z.new_zeros(B, 2, H)
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
    dp = torch.stack(steps[::-1], dim=1) if steps else z.new_zeros(B, 0, 2, 2 * H)
    return _kernel_time(dp).reshape(B, T, 4 * H).to(p.dtype)


#: channels a block of the staged scan kernels (TILE in csrc/lingru_*.cu)
SCAN_TILE = 128
#: steps a time tile and slots of the ring the staged kernels take
SCAN_STEPS = (4, 8, 16)
SCAN_STAGES = (2, 3, 4, 6)
#: (steps, stages) of each staged kernel unless told otherwise: the f32
#: kernels' and the bf16 kernels'. The bf16 ones are the fastest of their
#: sweep on an H100 at T=90, H=128, B=128 and 512 (chip_smoke.py
#: --lingru-bf16-only): time falls with steps a tile (a tile's barrier and
#: copies are a fixed cost) and barely moves with stages, so the shallower
#: ring of the two best
SCAN_DEFAULT = {"fwd": (16, 3), "bwd": (8, 3)}
SCAN_DEFAULT_BF16 = {"fwd": (16, 2), "bwd": (16, 2)}
#: rows of the tile's width a step takes in the ring and in each of the
#: two gate buffers: forward p_z, p_c and (1 - z, z c); backward p_z, p_c,
#: h_{t-1}, dy and (z, c, h_{t-1}, dy)
_SCAN_ROWS = {"fwd": (2, 2), "bwd": (4, 4)}
#: by dtype, what the staged kernels' layout takes (csrc/lingru_*.cu): bytes
#: of a ring element (gate buffers hold f32), the multiple of H whose bf16
#: or f32 runs are 16-byte copies, gate threads per chain thread, and the
#: registers a thread their launch bounds allow
_STAGED = {
    torch.float32: dict(ring_bytes=4, h_multiple=4, gate_groups=3, max_regs=64),
    torch.bfloat16: dict(ring_bytes=2, h_multiple=8, gate_groups=2, max_regs=56),
}
_STREAM_THREADS = 128  # threads a block of the streaming kernels
_BLOCK_SMEM = 232448  # shared memory one block may take on an H100, bytes
_SM_SMEM = 233472  # shared memory of an H100 SM, bytes
_BLOCK_RESERVED = 1024  # shared memory the card keeps for each block


def _staged_layout(dtype: torch.dtype) -> dict:
    if dtype not in _STAGED:
        raise ValueError(f"the lingru scan kernels take float32 or bfloat16, not {dtype}")
    return _STAGED[dtype]


def _smem_bytes(kernel: str, steps: int, stages: int, tile: int, dtype: torch.dtype) -> int:
    ring_rows, gate_rows = _SCAN_ROWS[kernel]
    ring_bytes = _staged_layout(dtype)["ring_bytes"]
    return steps * tile * (ring_bytes * stages * ring_rows + 4 * 2 * gate_rows)


def scan_plan(
    B: int, T: int, H: int, n_sm: int, kernel: str, *,
    aligned: bool = True, variant: Optional[str] = None,
    steps: Optional[int] = None, stages: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
) -> dict:
    """How ``lingru_{kernel}`` (``lingru_{kernel}_bf16`` for ``dtype``
    bfloat16) launches at these shapes on a card with ``n_sm`` SMs: the
    variant, steps a time tile and slots of the ring (0 and 0 when
    streaming), blocks, threads a block, dynamic shared-memory bytes a
    block, and the waves of blocks the card runs them in (blocks resident
    on an SM by threads, registers and shared memory).

    ``"staged"`` (time tiles copied into a ring in shared memory, a chain
    thread and gate threads a channel) takes 16-byte bulk copies of a
    step's runs: H a multiple of 4 in float32, of 8 in bfloat16, and
    16-byte-aligned tensors (``aligned``), and at least one tile's steps;
    ``"streaming"`` takes the rest. The ring holds the input's dtype, the
    gate buffers f32. ``variant``, ``steps`` and ``stages`` force a
    choice, as the bitwise checks across choices do; :func:`scan_choices`
    lists them."""
    if kernel not in _SCAN_ROWS:
        raise ValueError(f"no staged lingru_{kernel} kernel")
    layout = _staged_layout(dtype)
    default = (SCAN_DEFAULT_BF16 if dtype == torch.bfloat16 else SCAN_DEFAULT)[kernel]
    stageable = H % layout["h_multiple"] == 0 and aligned
    if variant is None:
        variant = "staged" if stageable and T >= (steps or default[0]) else "streaming"
    if variant == "streaming":
        if steps or stages:
            raise ValueError("the streaming lingru kernels take no steps or stages")
        blocks = -(-B * 2 * H // _STREAM_THREADS)
        return dict(variant=variant, steps=0, stages=0, blocks=blocks,
                    threads=_STREAM_THREADS, smem_bytes=0,
                    waves=-(-blocks // (n_sm * (2048 // _STREAM_THREADS))))
    if variant != "staged":
        raise ValueError(f"lingru variants are staged and streaming, not {variant!r}")
    if not stageable:
        raise ValueError(f"the staged {str(dtype)[6:]} lingru kernels take "
                         f"H % {layout['h_multiple']} == 0 and 16-byte-aligned tensors "
                         f"(H = {H}, aligned = {aligned})")
    steps = steps or default[0]
    stages = stages or default[1]
    if steps not in SCAN_STEPS or stages not in SCAN_STAGES:
        raise ValueError(f"the staged lingru kernels take steps in {SCAN_STEPS} and stages "
                         f"in {SCAN_STAGES}, not {steps} and {stages}")
    tile = min(H, SCAN_TILE)
    threads = (1 + layout["gate_groups"]) * -(-tile // 32) * 32
    smem = _smem_bytes(kernel, steps, stages, tile, dtype)
    if smem > _BLOCK_SMEM:
        raise ValueError(f"{steps} steps x {stages} stages of lingru_{kernel} take {smem} bytes "
                         f"of shared memory a block, more than {_BLOCK_SMEM}")
    blocks = B * 2 * -(-H // SCAN_TILE)
    per_sm = min(2048 // threads, 32, 65536 // (threads * layout["max_regs"]),
                 _SM_SMEM // (smem + _BLOCK_RESERVED))
    return dict(variant=variant, steps=steps, stages=stages, blocks=blocks, threads=threads,
                smem_bytes=smem, waves=-(-blocks // (n_sm * per_sm)))


def scan_choices(kernel: str, H: int, dtype: torch.dtype = torch.float32) -> list:
    """Every (steps, stages) the staged ``lingru_{kernel}`` (in ``dtype``)
    takes at hidden size ``H`` (those whose block fits in shared memory)."""
    return [(n, m) for n in SCAN_STEPS for m in SCAN_STAGES
            if _smem_bytes(kernel, n, m, min(H, SCAN_TILE), dtype) <= _BLOCK_SMEM]


def aligned(*tensors: torch.Tensor) -> bool:
    """Whether every tensor's storage starts on a 16-byte boundary, as the
    staged kernels' bulk copies need."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_scan(kernel: str, args, out: torch.Tensor, **forced) -> None:
    """Launch ``lingru_{kernel}`` on ``args`` into ``out``, the bf16 kernel
    for a bf16 ``out``, as :func:`scan_plan` lays it out (``forced``:
    ``variant``, ``steps``, ``stages``), or raise."""
    name = f"lingru_{kernel}" + ("_bf16" if out.dtype == torch.bfloat16 else "")
    p = args[0]
    (B, T), H = p.shape[:2], p.shape[2] // 4
    plan = scan_plan(B, T, H, _sm_count(p.device), kernel, aligned=aligned(*args, out),
                     dtype=out.dtype, **forced)
    lib = kernels.library(name)
    entry = getattr(lib, kernels.KERNELS[name][1])
    with torch.cuda.device(p.device):
        code = entry(*(t.data_ptr() for t in (*args, out)), B, T, H, plan["steps"],
                     plan["stages"], kernels.stream(p))
    kernels.check(lib, "{} ({variant}, {steps} steps x {stages} stages)".format(name, **plan),
                  code)


def _lingru_fwd_kernel(
    p: torch.Tensor, *,
    variant: Optional[str] = None, steps: Optional[int] = None, stages: Optional[int] = None,
) -> torch.Tensor:
    """Launch ``lingru_fwd`` (or raise) as :func:`scan_plan` lays it out;
    ``variant``, ``steps`` and ``stages`` force its choice. Counts on
    ``lingru_scan.launches``."""
    H = _hidden(p)
    kernels.check_inputs("lingru_fwd", p=p)
    B, T = p.shape[:2]
    out = torch.empty(B, T, 2 * H, device=p.device, dtype=torch.float32)
    if B == 0 or T == 0:
        return out
    _launch_scan("fwd", (p,), out, variant=variant, steps=steps, stages=stages)
    lingru_scan.launches += 1
    return out


def _lingru_fwd_bf16_kernel(
    p: torch.Tensor, *,
    variant: Optional[str] = None, steps: Optional[int] = None, stages: Optional[int] = None,
) -> torch.Tensor:
    """Launch ``lingru_fwd_bf16`` (or raise) as :func:`scan_plan` lays it
    out for bfloat16; ``variant``, ``steps`` and ``stages`` force its
    choice. Counts on ``lingru_scan.launches_bf16``."""
    H = _hidden(p)
    kernels.check_inputs("lingru_fwd_bf16", p=p)
    B, T = p.shape[:2]
    out = torch.empty(B, T, 2 * H, device=p.device, dtype=torch.bfloat16)
    if B == 0 or T == 0:
        return out
    _launch_scan("fwd", (p,), out, variant=variant, steps=steps, stages=stages)
    lingru_scan.launches_bf16 += 1
    return out


def _lingru_bwd_kernel(
    p: torch.Tensor, h: torch.Tensor, dy: torch.Tensor, *,
    variant: Optional[str] = None, steps: Optional[int] = None, stages: Optional[int] = None,
) -> torch.Tensor:
    """Launch ``lingru_bwd`` (or raise) as :func:`scan_plan` lays it out;
    ``variant``, ``steps`` and ``stages`` force its choice. Counts on
    ``lingru_scan_backward.launches``."""
    _hidden(p)
    kernels.check_inputs("lingru_bwd", p=p, h=h, dy=dy)
    dp = torch.empty_like(p)
    if p.shape[0] == 0 or p.shape[1] == 0:
        return dp
    _launch_scan("bwd", (p, h, dy), dp, variant=variant, steps=steps, stages=stages)
    lingru_scan_backward.launches += 1
    return dp


def _lingru_bwd_bf16_kernel(
    p: torch.Tensor, h: torch.Tensor, dy: torch.Tensor, *,
    variant: Optional[str] = None, steps: Optional[int] = None, stages: Optional[int] = None,
) -> torch.Tensor:
    """Launch ``lingru_bwd_bf16`` (or raise) as :func:`scan_plan` lays it
    out for bfloat16; ``variant``, ``steps`` and ``stages`` force its
    choice. Counts on ``lingru_scan_backward.launches_bf16``."""
    _hidden(p)
    kernels.check_inputs("lingru_bwd_bf16", p=p, h=h, dy=dy)
    dp = torch.empty_like(p)
    if p.shape[0] == 0 or p.shape[1] == 0:
        return dp
    _launch_scan("bwd", (p, h, dy), dp, variant=variant, steps=steps, stages=stages)
    lingru_scan_backward.launches_bf16 += 1
    return dp


def lingru_scan_backward(
    p: torch.Tensor, h: torch.Tensor, dy: torch.Tensor
) -> torch.Tensor:
    """The gradient of :func:`lingru_scan_backward_plain` in a CUDA kernel
    for CUDA tensors (launch or raise; ``lingru_bwd`` or
    ``lingru_bwd_bf16`` by p's dtype), the plain loop for CPU tensors.
    ``lingru_scan_backward.launches`` counts launches of the float32
    kernel, ``lingru_scan_backward.launches_bf16`` of the bfloat16 one."""
    H = _hidden(p)
    B, T = p.shape[:2]
    for name, t in (("h", h), ("dy", dy)):
        if tuple(t.shape) != (B, T, 2 * H):
            raise ValueError(f"{name} must be [{B}, {T}, {2 * H}], got {tuple(t.shape)}")
    if kernels.device_kind(p, "lingru_scan_backward") == "cpu":
        return lingru_scan_backward_plain(p, h, dy)
    dy = dy.contiguous()  # slices and cats hand dy strided
    if p.dtype == torch.bfloat16:
        return _lingru_bwd_bf16_kernel(p, h, dy)
    return _lingru_bwd_kernel(p, h, dy)


lingru_scan_backward.launches = 0
lingru_scan_backward.launches_bf16 = 0


class LinGRUScan(torch.autograd.Function):
    """The scan with its gradient: forward ``lingru_fwd`` and backward
    ``lingru_bwd`` on CUDA tensors (``lingru_fwd_bf16`` and
    ``lingru_bwd_bf16`` on bfloat16 ones), the plain loops on CPU tensors.
    ``apply(p) -> h``; the backward returns ``dp`` in p's dtype."""

    @staticmethod
    def forward(ctx, p):
        if kernels.device_kind(p, "lingru_scan") == "cpu":
            h = lingru_scan_plain(p)
        elif p.dtype == torch.bfloat16:
            h = _lingru_fwd_bf16_kernel(p)
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
    raise; the kernel by p's dtype), the plain loops for CPU tensors.
    ``lingru_scan.launches`` counts launches of the float32 forward
    kernel, ``lingru_scan.launches_bf16`` of the bfloat16 one."""
    _hidden(p)
    return LinGRUScan.apply(p)


lingru_scan.launches = 0
lingru_scan.launches_bf16 = 0


def bidir_lingru_layer(
    layer: Layer, x: torch.Tensor, *, scan: Scan = lingru_scan
) -> torch.Tensor:
    """One bidirectional layer, [B, T, in] -> [B, T, 2H] (fwd ++ bwd), with
    one input product for both directions and one scan launch, in x's
    dtype (the layer's biases must have it too: ``layers.cast_tree``). ``scan``
    swaps in :func:`lingru_scan_plain` to hold the kernel against it on
    the card."""
    fwd, bwd = layer["fwd"], layer["bwd"]
    w4 = torch.cat([_weight(d[k], x.dtype) for d in (fwd, bwd) for k in ("w_zx", "w_cx")], dim=1)
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
