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
``b_ih`` and ``b_hh`` [3H], gate order (r, z, n); a matrix may be an int8
weight (``models/quant.py``), dequantized here to the input's dtype.

The input's dtype is the compute dtype. In bfloat16 (the JAX package's
``compute_dtype="bfloat16"``: ``_xproj_stacked`` :428 stores ``xp`` in
bf16, and the kernels take ``h.astype(cdt)`` as the step product's
operand, keep an f32 carry and store bf16) the projection runs in bf16,
and the recurrence launches ``csrc/gru_fwd_bf16.cu`` on a card; its
gradient launches ``csrc/gru_bwd_bf16.cu`` (``_bwd_kernel_v3`` :200-300 with
``cdt = dxp_dtype = bfloat16``: the gates recomputed from the stored bf16
output, ``dh``, ``dW_hh`` and ``db_hh`` in f32, ``dhp`` rounded to bf16 only
as the operand of its two products, ``dxp`` stored in bf16), and
:class:`GRURecurrence` hands ``dW_hh`` and ``db_hh`` back rounded to bf16
once, as ``_finish_bwd`` (:606-611) does. A bf16 tensor on a card goes to
a bf16 kernel or raises: never to a float32 one.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from roko_tpu_torch import kernels
from roko_tpu_torch.models.layers import dropout as _dropout
from roko_tpu_torch.models.layers import weight as _weight

Layer = Dict[str, Dict[str, torch.Tensor]]
Recurrence = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

#: the kernels' widest hidden size (MAX_THREADS in csrc/gru_fwd.cu, gru_bwd.cu)
MAX_HIDDEN = 512
#: blocks the weight-gradient pass of gru_bwd aims for: two per SM of an H100
_BWD_TARGET_BLOCKS = 2 * 132
#: the weight-gradient pass's output tile (TK x TC in csrc/gru_bwd.cu)
_BWD_TILE = 64
#: the resident recurrences of gru_fwd and gru_bwd: widest H (RES_MAX_H),
#: the padding of each W_hh row in shared memory (W_PAD: 16 bytes), the
#: batch rows a block may take
RESIDENT_MAX_HIDDEN = 128
_W_PAD_BYTES = 16
_W_PAD = _W_PAD_BYTES // 4
RESIDENT_ROWS = (1, 2, 4, 8)
BWD_ROWS = RESIDENT_ROWS
#: batch rows a block of the streaming recurrences takes (STREAM_ROWS)
_STREAM_ROWS = 8
#: gru_fwd_bf16's resident variant (csrc/gru_fwd_bf16.cu): the batch rows
#: of its mma tile (TILE_N, the most rows a block), the steps of xp in its
#: shared-memory ring (XP_STAGES), and the bf16 a row of the ring and of
#: the h buffer (XS, HS), laid out for the widest H
_MMA_ROWS = 8
_XP_STAGES = 8
_BF16_XS = 3 * RESIDENT_MAX_HIDDEN + 8
_BF16_HS = RESIDENT_MAX_HIDDEN + 8
#: gru_bwd_bf16's resident variant (csrc/gru_bwd_bf16.cu): a row of its
#: dhp tile (DS: three gates laid out for the widest H and 64 bytes); a row
#: of W_hh[s] or of a slot's xp is _BF16_XS bf16 (WS there), of dy, h_prev
#: or the zero row _BF16_HS
_BF16_DS = 3 * RESIDENT_MAX_HIDDEN + 32
#: gru_bwd_bf16's weight-gradient pass (part (b) of csrc/gru_bwd_bf16.cu):
#: the columns of dW a block owns (DW_TC), the rows of B*T a stage of its
#: ring holds (DW_KR), the stages (DW_STAGES), threads a block, the padding
#: of an operand row (DW_BS - DW_TC), the SMs of an H100 its splits fill
#: and the fewest rows a split takes
_DW_COLS = 64
_DW_ROWS = 32
_DW_STAGES = 4
_DW_THREADS = 256
_DW_PAD = 8
_H100_SMS = 132
_DW_MIN_ROWS = 256


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
    t = T-1 down to 0. In xp's dtype: for bfloat16 the inputs widen to
    f32, the step product takes h rounded to bf16 (products exact in f32,
    summed in f32), the carry stays f32 and each step's h is stored
    rounded to bf16, as ``gru_fwd_bf16`` computes it."""
    B, T, S, H = _shapes(xp, w_hh, b_hh)
    cdt, acc = xp.dtype, torch.promote_types(xp.dtype, torch.float32)
    x = xp.to(acc).reshape(B, T, S, 3 * H)
    w, b = w_hh.to(acc), b_hh.to(acc)
    out = xp.new_empty(B, T, S, H)
    h = x.new_zeros(S, B, H)
    for step in range(T):
        ts = [step, T - 1 - step][:S]
        xt = torch.stack([x[:, t, s] for s, t in enumerate(ts)])  # [S, B, 3H]
        hp = torch.bmm(h.to(cdt).to(acc), w) + b[:, None]
        r = torch.sigmoid(xt[..., :H] + hp[..., :H])
        z = torch.sigmoid(xt[..., H : 2 * H] + hp[..., H : 2 * H])
        n = torch.tanh(xt[..., 2 * H :] + r * hp[..., 2 * H :])
        h = (1.0 - z) * n + z * h
        for s, t in enumerate(ts):
            out[:, t, s] = h[s]
    return out.reshape(B, T, S * H)


def k_order_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [S, M, K] @ b [S, K, N]`` in a's dtype with each entry one
    running sum over k = 0 .. K-1 from zero, one product added at a time:
    the order of sums of the plain bf16 backward's two step products, the
    same at every shape and on every device. On bf16 values held in float32
    each product is exact, so this is what a fused multiply-add chain in k
    order gives: gru_bwd_bf16's streaming recurrence, and cuBLAS's f32 GEMM
    where it sums in k order. ``torch.bmm`` picks its order by shape and
    device."""
    out = a.new_zeros(a.shape[0], a.shape[1], b.shape[2])
    for a_k, b_k in zip(a.unsqueeze(3).unbind(2), b.unsqueeze(1).unbind(2)):
        out.addcmul_(a_k, b_k)
    return out


def gru_recurrence_backward_plain(
    xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
    out: torch.Tensor, dy: torch.Tensor, *, dhp_out: Optional[torch.Tensor] = None,
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

    Returns dxp [B, T, S*3H] in xp's dtype, dW_hh [S, H, 3H] and db_hh
    [S, 3H] in float32 (the kernels' sums). For bfloat16 the inputs widen
    to f32 and every sum is f32; ``dhp`` is rounded to bf16 only as the
    operand of ``dhp W_hh^T`` and ``h_prev^T dhp`` (``db_hh`` sums it
    unrounded), and dxp is stored rounded to bf16, as ``gru_bwd_bf16``
    computes it; both step products, ``h_prev W_hh`` and ``dhp W_hh^T``,
    sum in k order one product at a time (:func:`k_order_bmm`), so the
    rounding of dhp to bf16, which the carry takes on, does not hang on
    the order a library picks. ``dhp_out`` ([B, T, S*3H], the
    accumulation dtype), when given, takes each step's unrounded dhp, as
    the kernels' scratch does: a seam for tests, which no program path
    sets."""
    B, T, S, H = _shapes(xp, w_hh, b_hh)
    cdt, acc = xp.dtype, torch.promote_types(xp.dtype, torch.float32)
    x = xp.to(acc).reshape(B, T, S, 3 * H)
    hs = out.to(acc).reshape(B, T, S, H)
    g = dy.to(acc).reshape(B, T, S, H)
    w, b = w_hh.to(acc), b_hh.to(acc)
    dxp = xp.new_empty(B, T, S, 3 * H)
    dw = x.new_zeros(S, H, 3 * H)
    db = x.new_zeros(S, 3 * H)
    dh = x.new_zeros(S, B, H)
    zero = x.new_zeros(B, H)
    mm = torch.bmm if cdt == acc else k_order_bmm
    h_prevs = torch.stack([  # [T, S, B, H]: each step's previous states
        torch.stack([zero if p is None else hs[:, p, s] for s, p in enumerate(prev)])
        for _, prev in (_prev_steps(T, S, step) for step in range(T))
    ]) if T else x.new_zeros(0, S, B, H)
    # no hp depends on dh: every step's in one product over the T*B rows
    hps = mm(h_prevs.transpose(0, 1).reshape(S, T * B, H), w)
    hps = hps.reshape(S, T, B, 3 * H).transpose(0, 1) + b[None, :, None]
    for step in range(T):
        ts, _ = _prev_steps(T, S, step)
        xt = torch.stack([x[:, t, s] for s, t in enumerate(ts)])  # [S, B, 3H]
        h_prev, hp = h_prevs[step], hps[step]
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
            if dhp_out is not None:
                dhp_out[:, t, s * 3 * H : (s + 1) * 3 * H] = dhp[s]
        operand = dhp.to(cdt).to(acc)  # the products' bf16 operand
        dh = dh * z + mm(operand, w.transpose(1, 2))
        dw = dw + torch.bmm(h_prev.transpose(1, 2), operand)
        db = db + dhp.sum(dim=1)
    return dxp.reshape(B, T, S * 3 * H), dw, db


def fwd_plan(B: int, T: int, H: int, S: int, n_sm: int, rows: Optional[int] = None,
             dtype: torch.dtype = torch.float32) -> dict:
    """How gru_fwd (``dtype`` float32) or gru_fwd_bf16 (bfloat16) launches
    at these shapes on a card with ``n_sm`` SMs: the variant, batch rows a
    block (``rows`` forces one of :data:`RESIDENT_ROWS` on the resident
    variant), blocks, threads a block and dynamic shared-memory bytes a
    block. gru_fwd's resident block holds W_hh[s] with rows of 3H floats
    and 16 bytes of padding and the double-buffered h (resident_smem_bytes
    in csrc/gru_fwd.cu), and from 4 rows up runs two thread groups of half
    the rows each (resident_groups). gru_fwd_bf16's resident block holds
    W_hh[s] in registers, a warp for each 16 units, and in shared memory
    the xp ring [XP_STAGES][rows][3 * 128 + 8] and the double-buffered h of
    the 8-row mma tile [2][8][128 + 8], laid out for the widest H whatever
    H is (resident_smem_bytes in csrc/gru_fwd_bf16.cu). A streaming block
    holds the double-buffered h alone."""
    variant, rows = _variant_rows("gru_fwd", B, H, S, n_sm, rows)
    size = torch.finfo(dtype).bits // 8
    smem = size * 2 * rows * H
    threads = -(-H // 32) * 32
    if variant == "resident" and dtype == torch.bfloat16:
        threads = 32 * -(-H // 16)
        smem = 2 * (_XP_STAGES * rows * _BF16_XS + 2 * _MMA_ROWS * _BF16_HS)
    elif variant == "resident":
        smem += size * H * 3 * H + H * _W_PAD_BYTES
        threads *= 2 if rows >= 4 else 1
    return dict(variant=variant, rows=rows, blocks=S * -(-B // rows),
                threads=threads, smem_bytes=smem)


def _gru_fwd_kernel(
    xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor, rows: Optional[int] = None
) -> torch.Tensor:
    """Launch ``gru_fwd`` for a float32 ``xp`` or ``gru_fwd_bf16`` for a
    bfloat16 one (or raise) as :func:`fwd_plan` lays it out; ``rows``
    forces the resident variant's rows a block. Counts on
    ``gru_recurrence.launches`` and ``gru_recurrence.launches_bf16``."""
    B, T, S, H = _shapes(xp, w_hh, b_hh)
    bf16 = xp.dtype == torch.bfloat16
    name = "gru_fwd_bf16" if bf16 else "gru_fwd"
    _check_cuda(name, H, xp=xp, w_hh=w_hh, b_hh=b_hh)
    if w_hh.data_ptr() % 16:
        raise ValueError(f"{name} reads w_hh in vectors; its storage is not 16-byte aligned")
    if bf16 and xp.data_ptr() % 8:
        raise ValueError(f"{name} copies xp in 8-byte granules; its storage is not 8-byte aligned")
    out = torch.empty(B, T, S * H, device=xp.device, dtype=xp.dtype)
    if B == 0 or T == 0:
        return out
    plan = fwd_plan(B, T, H, S, torch.cuda.get_device_properties(xp.device).multi_processor_count,
                    rows, xp.dtype)
    lib = kernels.library(name)
    with torch.cuda.device(xp.device):
        code = getattr(lib, kernels.KERNELS[name][1])(
            xp.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), out.data_ptr(),
            B, T, H, S, plan["rows"], int(plan["variant"] == "resident"),
            kernels.stream(xp),
        )
    kernels.check(lib, name, code)
    if bf16:
        gru_recurrence.launches_bf16 += 1
    else:
        gru_recurrence.launches += 1
    return out


def bwd_splits(B: int, T: int, H: int, S: int) -> int:
    """Row splits of gru_bwd's weight-gradient pass: enough blocks to fill
    the card, each split summing a fixed contiguous range of the B*T rows.
    A function of the shapes only, so two runs sum in the same order."""
    tiles = S * -(-H // _BWD_TILE) * -(-3 * H // _BWD_TILE)
    rows = max(B * T, 1)
    return max(1, min(-(-_BWD_TARGET_BLOCKS // tiles), -(-rows // 256)))


def _dw_k_tiles_per_warp(H: int) -> int:
    """The weight-gradient pass's k-tiles of 16 a warp (its template MT)."""
    k_tiles = -(-H // 16)
    return -(-k_tiles // (_DW_THREADS // 32))


def _dw_blocks_per_sm(H: int) -> int:
    """Blocks of the weight-gradient pass an SM holds (dw_min_blocks in
    csrc/gru_bwd_bf16.cu): two up to 2 k-tiles a warp, else one."""
    return 2 if _dw_k_tiles_per_warp(H) <= 2 else 1


def dw_splits(B: int, T: int, H: int, S: int) -> int:
    """Row splits of gru_bwd_bf16's weight-gradient pass: S * ceil(3H / 64)
    column tiles a split, enough splits to fill the SMs of an H100 with as
    many blocks as one holds, and at least _DW_MIN_ROWS rows a split. A
    function of the shapes only, so two runs sum in the same order."""
    tiles = S * -(-3 * H // _DW_COLS)
    target = _H100_SMS * _dw_blocks_per_sm(H)
    return max(1, min(-(-target // tiles), -(-max(B * T, 1) // _DW_MIN_ROWS)))


def dw_plan(B: int, T: int, H: int, S: int) -> dict:
    """How gru_bwd_bf16's weight-gradient pass launches: a block owns one
    direction, one split of the B*T rows and a ``tile`` of dW, every k of
    H up to whole k-tiles of 16 by 64 columns; ``splits``, ``blocks``
    (column tiles x S x splits), ``threads`` a block, dynamic
    shared-memory bytes a block (dw_smem_bytes in csrc/gru_bwd_bf16.cu: a
    ring of 4 stages of 32 rows, each a bf16 row of h_prev of the tile's k
    and 16 bytes and 64 f32 of dhp, and the bf16 operand tile [32][64 +
    8]), ``k_tiles_per_warp`` (its template MT) and ``blocks_per_sm``, the
    blocks an SM holds, which the splits aim to fill. Shapes only."""
    hpad = -(-H // 16) * 16
    splits = dw_splits(B, T, H, S)
    smem = (_DW_STAGES * _DW_ROWS * (2 * (hpad + _DW_PAD) + 4 * _DW_COLS)
            + 2 * _DW_ROWS * (_DW_COLS + _DW_PAD))
    return dict(tile=(hpad, _DW_COLS), splits=splits,
                blocks=-(-3 * H // _DW_COLS) * S * splits, threads=_DW_THREADS,
                smem_bytes=smem, k_tiles_per_warp=_dw_k_tiles_per_warp(H),
                blocks_per_sm=_dw_blocks_per_sm(H))


def resident_rows(B: int, S: int, n_sm: int) -> int:
    """Batch rows a block of a resident recurrence (gru_fwd's or gru_bwd's)
    takes: the fewest of :data:`RESIDENT_ROWS` that keep the
    S * ceil(B / rows) blocks within one wave of the card's ``n_sm`` SMs
    (one block fits an SM), and the most when none does."""
    return next((r for r in RESIDENT_ROWS if S * -(-B // r) <= n_sm), RESIDENT_ROWS[-1])


bwd_rows = resident_rows


def recurrence_variant(H: int) -> str:
    """The recurrence kernels' variant for hidden size ``H``, gru_fwd's and
    gru_bwd's alike: ``"resident"`` (W_hh held on chip: in shared memory;
    in registers in gru_fwd_bf16; both in gru_bwd_bf16) up to
    :data:`RESIDENT_MAX_HIDDEN`, ``"streaming"`` (W_hh from L2 every step)
    above. A function of the shape, not a fallback."""
    return "resident" if H <= RESIDENT_MAX_HIDDEN else "streaming"


fwd_variant = bwd_variant = recurrence_variant


def _variant_rows(name: str, B: int, H: int, S: int, n_sm: int, rows: Optional[int]):
    """The variant of kernel ``name`` at hidden size ``H`` and its batch
    rows a block: ``rows`` when given and allowed, else one wave's."""
    variant = recurrence_variant(H)
    if variant == "streaming":
        if rows not in (None, _STREAM_ROWS):
            raise ValueError(f"the streaming {name} takes {_STREAM_ROWS} rows a block, not {rows}")
        return variant, _STREAM_ROWS
    if rows is None:
        return variant, resident_rows(B, S, n_sm)
    if rows not in RESIDENT_ROWS:
        raise ValueError(f"{name} takes {RESIDENT_ROWS} rows a block, not {rows}")
    return variant, rows


def bwd_plan(B: int, T: int, H: int, S: int, n_sm: int, rows: Optional[int] = None,
             dtype: torch.dtype = torch.float32) -> dict:
    """How gru_bwd (``dtype`` float32) or gru_bwd_bf16 (bfloat16) launches
    at these shapes on a card with ``n_sm`` SMs: the recurrence's variant,
    batch rows a block (``rows`` forces one of :data:`RESIDENT_ROWS` on the
    resident variant), blocks, threads a block, dynamic shared-memory bytes
    a block, and the weight-gradient pass's splits. gru_bwd's resident block
    holds W_hh[s] with rows of 3H + 4 floats and double-buffered h_prev and
    dhp (resident_smem_bytes in csrc/gru_bwd.cu). gru_bwd_bf16's resident
    block has a warp for each 16 units and holds, laid out for the widest H
    whatever H is, W_hh[s] in bf16 [128][3 * 128 + 8], a ring of
    (8 / rows, or 1 at one row) + 4 steps of rows slots, each a row's xp, dy and h_prev
    (3 * 128 + 8 and twice 128 + 8), the double-buffered bf16 dhp tile
    [2][rows][3 * 128 + 32] and a zero row [128 + 8] (resident_smem_bytes
    in csrc/gru_bwd_bf16.cu). A streaming block of either holds h_prev and
    dhp once, in f32. ``splits`` are the row splits of the weight-gradient
    pass: :func:`bwd_splits` for gru_bwd, and for gru_bwd_bf16 those of its
    tensor-core pass, whose whole plan is ``dw`` (:func:`dw_plan`)."""
    variant, rows = _variant_rows("gru_bwd", B, H, S, n_sm, rows)
    threads = -(-H // 32) * 32
    if variant == "streaming":
        smem = 4 * rows * 4 * H
    elif dtype == torch.bfloat16:
        threads = 32 * -(-H // 16)
        stages = (_MMA_ROWS // rows if rows >= 2 else 1) + 4
        smem = 2 * (RESIDENT_MAX_HIDDEN * _BF16_XS + stages * rows * (_BF16_XS + 2 * _BF16_HS)
                    + 2 * rows * _BF16_DS + _BF16_HS)
    else:
        smem = 4 * (H * (3 * H + _W_PAD) + 2 * rows * 4 * H)
    plan = dict(variant=variant, rows=rows, blocks=S * -(-B // rows),
                threads=threads, smem_bytes=smem, splits=bwd_splits(B, T, H, S))
    if dtype == torch.bfloat16:
        plan["dw"] = dw_plan(B, T, H, S)
        plan["splits"] = plan["dw"]["splits"]
    return plan


def _gru_bwd_kernel(
    xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
    out: torch.Tensor, dy: torch.Tensor, rows: Optional[int] = None,
    dhp: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``gru_bwd`` for a float32 ``xp`` or ``gru_bwd_bf16`` for a
    bfloat16 one (or raise) as :func:`bwd_plan` lays it out; ``rows``
    forces the resident recurrence's rows a block; ``dhp``, a contiguous
    float32 [B, T, S*3H] on xp's device, takes the recurrence's unrounded
    dhp, which the weight-gradient pass reads (by default a buffer of the
    call's own; a seam for tests and chip_smoke.py, which no program path
    sets). dxp comes back in xp's dtype, dW_hh and db_hh in float32.
    Counts on ``gru_recurrence_backward.launches`` and
    ``gru_recurrence_backward.launches_bf16``."""
    B, T, S, H = _shapes(xp, w_hh, b_hh)
    bf16 = xp.dtype == torch.bfloat16
    name = "gru_bwd_bf16" if bf16 else "gru_bwd"
    _check_cuda(name, H, xp=xp, w_hh=w_hh, b_hh=b_hh, out=out, dy=dy)
    for arg, t in (("out", out), ("dy", dy)):
        if tuple(t.shape) != (B, T, S * H):
            raise ValueError(f"{arg} must be [{B}, {T}, {S * H}], got {tuple(t.shape)}")
    if w_hh.data_ptr() % 16:
        raise ValueError(f"{name} reads w_hh in vectors; its storage is not 16-byte aligned")
    for arg, t in (("xp", xp), ("out", out), ("dy", dy)):
        if bf16 and t.data_ptr() % 8:
            raise ValueError(
                f"{name} copies {arg} in 8-byte granules; its storage is not 8-byte aligned")
    f32 = dict(device=xp.device, dtype=torch.float32)
    dxp = torch.empty_like(xp)
    dw = torch.zeros(S, H, 3 * H, **f32)
    db = torch.zeros(S, 3 * H, **f32)
    if B == 0 or T == 0:
        return dxp, dw, db
    plan = bwd_plan(B, T, H, S, torch.cuda.get_device_properties(xp.device).multi_processor_count,
                    rows, xp.dtype)
    nsplit = plan["splits"]
    # dhp for the weight-gradient pass, unrounded: db_hh sums it as it is
    if dhp is None:
        dhp = torch.empty(B, T, S * 3 * H, **f32)
    elif (dhp.dtype, tuple(dhp.shape), dhp.device) != (torch.float32, (B, T, S * 3 * H),
                                                         xp.device) or not dhp.is_contiguous():
        raise ValueError(f"dhp must be a contiguous float32 [{B}, {T}, {S * 3 * H}] on "
                         f"{xp.device}")
    elif dhp.data_ptr() % 16:
        raise ValueError(f"{name} copies dhp in 16-byte granules; its storage is not "
                         "16-byte aligned")
    part_w = torch.empty(nsplit, S, H, 3 * H, **f32)
    part_b = torch.empty(nsplit, S, 3 * H, **f32)
    lib = kernels.library(name)
    with torch.cuda.device(xp.device):
        code = getattr(lib, kernels.KERNELS[name][1])(
            xp.data_ptr(), out.data_ptr(), dy.data_ptr(), w_hh.data_ptr(),
            b_hh.data_ptr(), dxp.data_ptr(), dhp.data_ptr(),
            part_w.data_ptr(), part_b.data_ptr(), dw.data_ptr(), db.data_ptr(),
            B, T, H, S, nsplit, plan["rows"], int(plan["variant"] == "resident"),
            kernels.stream(xp),
        )
    kernels.check(lib, name, code)
    if bf16:
        gru_recurrence_backward.launches_bf16 += 1
    else:
        gru_recurrence_backward.launches += 1
    return dxp, dw, db


def gru_recurrence_backward(
    xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
    out: torch.Tensor, dy: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients of :func:`gru_recurrence_backward_plain` in a CUDA
    kernel for CUDA tensors (launch or raise; ``gru_bwd`` or
    ``gru_bwd_bf16`` by xp's dtype), the plain loop for CPU tensors.
    ``gru_recurrence_backward.launches`` counts launches of the float32
    kernel, ``gru_recurrence_backward.launches_bf16`` of the bfloat16 one."""
    _shapes(xp, w_hh, b_hh)
    if kernels.device_kind(xp, "gru_recurrence_backward") == "cpu":
        return gru_recurrence_backward_plain(xp, w_hh, b_hh, out, dy)
    # slices and cats upstream hand dy strided
    return _gru_bwd_kernel(xp, w_hh, b_hh, out, dy.contiguous())


gru_recurrence_backward.launches = 0
gru_recurrence_backward.launches_bf16 = 0


class GRURecurrence(torch.autograd.Function):
    """The recurrence with its gradient: forward ``gru_fwd`` and backward
    ``gru_bwd`` on CUDA tensors (``gru_fwd_bf16`` and ``gru_bwd_bf16`` on
    bfloat16 ones), the plain loops on CPU tensors.
    ``apply(xp, w_hh, b_hh) -> out``; the backward returns
    ``(dxp, dW_hh, db_hh)``, each in its input's dtype: the f32 sums of
    dW_hh and db_hh are rounded once to the dtype of w_hh and b_hh."""

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
        dxp, dw, db = gru_recurrence_backward(xp, w_hh, b_hh, out, dy)
        return dxp, dw.to(w_hh.dtype), db.to(b_hh.dtype)


def gru_recurrence(
    xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> torch.Tensor:
    """The recurrence of :func:`gru_recurrence_plain`, differentiable
    through :class:`GRURecurrence`: the CUDA kernels for CUDA tensors
    (launch or raise; the kernel by xp's dtype), the plain loops for CPU
    tensors. ``gru_recurrence.launches`` counts launches of the float32
    forward kernel, ``gru_recurrence.launches_bf16`` of the bfloat16 one."""
    _shapes(xp, w_hh, b_hh)
    return GRURecurrence.apply(xp, w_hh, b_hh)


gru_recurrence.launches = 0
gru_recurrence.launches_bf16 = 0


def fused_bidir_layer(
    layer: Layer, x: torch.Tensor, *, recurrence: Recurrence = gru_recurrence
) -> torch.Tensor:
    """One bidirectional layer, [B, T, in] -> [B, T, 2H] (fwd ++ bwd), with
    one input product for both directions and one recurrence launch, in
    x's dtype (the layer's biases must have it too: ``layers.cast_tree``).
    ``recurrence`` swaps in :func:`gru_recurrence_plain` to hold the
    kernel against it on the card."""
    fwd, bwd = layer["fwd"], layer["bwd"]
    w_ih = torch.cat([_weight(fwd["w_ih"], x.dtype), _weight(bwd["w_ih"], x.dtype)], dim=1)
    b_ih = torch.cat([fwd["b_ih"], bwd["b_ih"]])
    xp = torch.matmul(x, w_ih) + b_ih  # [B, T, 6H]
    w_hh = torch.stack([_weight(fwd["w_hh"], x.dtype), _weight(bwd["w_hh"], x.dtype)])
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
