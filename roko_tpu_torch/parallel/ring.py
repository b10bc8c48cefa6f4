"""Ring attention: sequence-parallel attention over the ``sp`` axis.

Counterpart of ``roko_tpu/parallel/ring.py`` (:35-125). Each rank of an
sp group holds one column block ``[B, T/sp, D]`` of q, k and v. It
attends its queries to the k/v block it holds, then passes that block on
to the next rank of the ring (``s -> s + 1``) and receives the previous
rank's, accumulating an online softmax; after ``sp`` blocks every query
has seen every key. The result equals dense attention over the whole
sequence up to float reassociation.

The construction is the reference's, op for op (its ``jnp.einsum``
blocks run outside any Pallas kernel, so no TPU kernel stands behind this
module and it launches no CUDA kernel of the port): q scaled before the
product, f32 accumulators ``o``, ``m`` and ``l``, v cast to f32, the last
step without a rotation, the output ``o / l`` in q's dtype.

The rotation is an autograd ``Function``, the counterpart of
``lax.ppermute``: forward sends to ``s + 1`` and receives from ``s - 1``,
backward sends the incoming gradient the other way, and autograd
differentiates the rest, as JAX differentiates through ``ppermute``.
Every send and receive of a step is posted at once
(``dist.batch_isend_irecv``): a blocking send before a receive would
deadlock the ring. The transport depends on the backend (:func:`transport`):
NCCL sends device tensors; gloo sends CPU tensors only, so on a card
under gloo each block is copied to the host, sent, and copied back.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

from roko_tpu_torch.parallel import distributed
from roko_tpu_torch.parallel.mesh import Mesh


def transport(device: torch.device) -> str:
    """How a rotation moves a block of ``device`` on this run's backend:
    ``"direct"``, the tensor as it is (a CUDA tensor under NCCL, a CPU
    tensor under gloo), or ``"host"`` (a CUDA tensor under gloo: copied to
    the host, sent, and copied back)."""
    if torch.device(device).type == "cuda" and distributed.backend() == "gloo":
        return "host"
    return "direct"


def rotate(blocks: Sequence[torch.Tensor], mesh: Mesh, shift: int) -> List[torch.Tensor]:
    """Every tensor of ``blocks`` sent ``shift`` places along this rank's sp
    ring and the one ``shift`` places before received in its place, all
    sends and receives posted at once. No autograd."""
    import torch.distributed as dist

    d, t, s, n = mesh.d, mesh.t, mesh.s, mesh.sp
    dst, src = mesh.rank_of(d, t, (s + shift) % n), mesh.rank_of(d, t, (s - shift) % n)
    host = transport(blocks[0].device) == "host"
    ops, bufs = [], []
    for tag, b in enumerate(blocks):
        out = b.detach().contiguous()
        if host:
            out = out.cpu()
        buf = torch.empty_like(out)
        ops += [dist.P2POp(dist.isend, out, dst, mesh.sp_group, tag),
                dist.P2POp(dist.irecv, buf, src, mesh.sp_group, tag)]
        bufs.append(buf)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [buf.to(b.device) if host else buf for buf, b in zip(bufs, blocks)]


class _PPermute(torch.autograd.Function):
    """``lax.ppermute`` over the sp ring: forward passes the blocks on to
    ``s + 1``, backward passes their gradients back to ``s - 1``."""

    @staticmethod
    def forward(ctx, mesh: Mesh, *blocks: torch.Tensor):
        ctx.mesh = mesh
        return tuple(rotate(blocks, mesh, 1))

    @staticmethod
    def backward(ctx, *grads: torch.Tensor):
        return (None, *rotate(grads, ctx.mesh, -1))


def ppermute(mesh: Mesh, *blocks: torch.Tensor) -> tuple:
    """The blocks of rank ``s - 1`` of this rank's sp ring, differentiable."""
    return _PPermute.apply(mesh, *blocks)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                   mesh: Mesh) -> torch.Tensor:
    """Multi-head attention of this rank's queries over the whole
    sequence; q, k, v ``[B, T/sp, D]``, this rank's column block ->
    ``[B, T/sp, D]`` in q's dtype (``_ring_attention_local``, :35-89)."""
    B, Tq, D = q.shape
    H = num_heads
    hd = D // H
    scale = 1.0 / math.sqrt(hd)

    def heads(x: torch.Tensor) -> torch.Tensor:  # [B, T, D] -> [B, H, T, hd]
        return x.reshape(B, -1, H, hd).transpose(1, 2)

    qh = (heads(q) * scale).float()
    o = torch.zeros((B, H, Tq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Tq), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for i in range(mesh.sp):
        # the products of the block's (exact, bf16 or f32) values summed in f32,
        # as preferred_element_type=float32 sums them
        s = torch.einsum("bhqd,bhkd->bhqk", qh, heads(k_blk).float())
        new_m = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - new_m)
        p = torch.exp(s - new_m[..., None])
        o = o * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, heads(v_blk).float())
        l = l * alpha + p.sum(dim=-1)
        m = new_m
        if i + 1 < mesh.sp:  # the last block is not passed on
            k_blk, v_blk = ppermute(mesh, k_blk, v_blk)
    out = o / l[..., None]
    return out.transpose(1, 2).reshape(B, Tq, D).to(q.dtype)


def column_block(mesh: Mesh, cols: int) -> slice:
    """This rank's columns ``[s * cols / sp, (s + 1) * cols / sp)``."""
    if cols % mesh.sp:
        raise ValueError(f"{cols} columns not divisible by sp={mesh.sp}")
    per = cols // mesh.sp
    return slice(mesh.s * per, (mesh.s + 1) * per)


def gather_columns(x: torch.Tensor, mesh: Mesh, dim: int = 1) -> torch.Tensor:
    """The column blocks of every rank of this rank's sp group joined along
    ``dim``, in ring order, on ``x``'s device. Through CPU tensors: gloo
    gathers only those; no autograd."""
    if mesh.sp == 1:
        return x
    parts = distributed.all_gather_cpu(x.detach(), mesh.sp_group)
    return torch.cat(list(parts.unbind(0)), dim=dim).to(x.device)
