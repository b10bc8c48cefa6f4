"""Ring attention of the port (``roko_tpu_torch/parallel/ring.py``) against
``roko_tpu`` on the CPU.

Six gloo ranks (``tests/torch_tp_worker.py``, mode ``ring``, launched
once for the module) lay two grids over the run, dp=3 x sp=2 and dp=2 x
sp=3. On each, every rank runs ``ring_attention`` on its column block of
numpy-seeded q, k and v ([4, 48, 32], 4 heads) and backpropagates a
seeded cotangent; and the tiny transformer's encoder (d_model 32, 4
heads, 2 layers) on its block of a [4, 90, 40] input, with ``pos_embed``
at its offset and the ring in place of the attention. This process joins
the blocks of the first dp group in ring order and holds them against
the reference's dense ``attention`` and ``jax.grad`` of it, against
``roko_tpu.parallel.ring.make_ring_attention`` on JAX's virtual CPU mesh
(``tests/conftest.py``), and against ``transformer_apply``, at
``tests/test_ring.py``'s bars: rtol = atol = 2e-5 forward, 3e-5 for
dq, dk and dv. Every dp group's blocks are bitwise those of the first.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roko_tpu.config import MeshConfig as JaxMeshConfig
from roko_tpu.config import ModelConfig as JaxModelConfig
from roko_tpu.models.transformer import attention, transformer_apply
from roko_tpu.parallel.mesh import make_mesh as ref_make_mesh
from roko_tpu.parallel.ring import make_ring_attention
from roko_tpu_torch.models.convert import jax_from_state_dict
from tests import torch_dp_worker as W
from tests import torch_tp_worker as T
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

FWD, GRAD = 2e-5, 3e-5
SPS = sorted(T.RING_GRIDS)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ring")
    W.launch("ring", str(out), ranks=6, module="tests.torch_tp_worker")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(6)]


def joined(ranks, sp, key, d=0):
    """The column blocks of dp group ``d`` of the sp grid, joined in ring order."""
    blocks = sorted((r["grids"][sp] for r in ranks if r["grids"][sp]["coords"][0] == d),
                    key=lambda b: b["coords"][2])
    assert [b["coords"][2] for b in blocks] == list(range(sp))
    return torch.cat([b[key] for b in blocks], dim=1).numpy()


def _loss(attn_fn, q, k, v, ct):
    return jnp.sum(attn_fn(q, k, v, T.RING_H) * ct)


@pytest.fixture(scope="module")
def dense():
    """The reference's dense attention and its q/k/v gradients."""
    q, k, v, ct = (jnp.asarray(a) for a in T.ring_inputs())
    out = attention(q, k, v, T.RING_H)
    grads = jax.grad(lambda *a: _loss(attention, *a, ct), argnums=(0, 1, 2))(q, k, v)
    return {"out": np.asarray(out), **{n: np.asarray(g) for n, g in zip(("dq", "dk", "dv"), grads)}}


def _ref_ring_mesh(sp):
    """dp=2 x sp on the virtual devices: dp must divide the 4 rows there."""
    return ref_make_mesh(JaxMeshConfig(dp=2, tp=1, sp=sp), jax.devices()[: 2 * sp])


@pytest.fixture(scope="module")
def ref_ring():
    """``make_ring_attention`` at each sp and ``jax.grad`` through it."""
    q, k, v, ct = (jnp.asarray(a) for a in T.ring_inputs())
    out = {}
    for sp in SPS:
        ring = make_ring_attention(_ref_ring_mesh(sp), T.RING_H)
        grads = jax.jit(jax.grad(lambda *a: _loss(ring, *a, ct), argnums=(0, 1, 2)))(q, k, v)
        out[sp] = {"out": np.asarray(ring(q, k, v, T.RING_H)),
                   **{n: np.asarray(g) for n, g in zip(("dq", "dk", "dv"), grads)}}
    return out


@pytest.mark.parametrize("sp", SPS)
def test_ring_forward_matches_dense_attention(ranks, dense, sp):
    got = joined(ranks, sp, "out")
    print(f"sp={sp}: max |delta| {np.abs(got - dense['out']).max():.3e}")
    np.testing.assert_allclose(got, dense["out"], rtol=FWD, atol=FWD)


@pytest.mark.parametrize("sp", SPS)
def test_ring_forward_matches_reference_ring(ranks, ref_ring, sp):
    np.testing.assert_allclose(joined(ranks, sp, "out"), ref_ring[sp]["out"], rtol=FWD, atol=FWD)


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("grad", ["dq", "dk", "dv"])
def test_ring_gradients_match_dense_attention(ranks, dense, sp, grad):
    """The rotation's backward carries each k/v block's gradient back to
    the rank that holds it."""
    np.testing.assert_allclose(joined(ranks, sp, grad), dense[grad], rtol=GRAD, atol=GRAD)


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("grad", ["dq", "dk", "dv"])
def test_ring_gradients_match_reference_ring(ranks, ref_ring, sp, grad):
    np.testing.assert_allclose(joined(ranks, sp, grad), ref_ring[sp][grad], rtol=GRAD, atol=GRAD)


@pytest.mark.parametrize("sp", SPS)
def test_encoder_with_the_ring_matches_transformer_apply(ranks, sp):
    """The whole encoder on each rank's columns (``pos_embed`` at the
    block's offset, the ring as attention) against the reference's dense
    encoder on all 90 columns."""
    model = W.fresh_model(T.TRANSFORMER)
    tree = jax_from_state_dict(model.state_dict())
    cfg = JaxModelConfig(kind="transformer", hidden_size=16, d_model=32, num_heads=4,
                         num_layers=2, embed_dim=8, read_mlp=(8, 4))
    want = np.asarray(transformer_apply(tree["encoder"], cfg, jnp.asarray(T.encoder_input())))
    np.testing.assert_allclose(joined(ranks, sp, "encoder"), want, rtol=FWD, atol=FWD)


@pytest.mark.parametrize("sp", SPS)
def test_every_dp_group_computes_the_same_blocks(ranks, sp):
    for d in range(T.RING_GRIDS[sp].dp):
        for key in ("out", "dq", "dk", "dv", "encoder"):
            assert np.array_equal(joined(ranks, sp, key, d), joined(ranks, sp, key))


def test_cpu_tensors_rotate_as_they_are(ranks):
    """On the CPU the blocks travel as CPU tensors over gloo; the host copy
    is for CUDA tensors under gloo."""
    assert {r["grids"][sp]["transport"] for r in ranks for sp in SPS} == {"direct"}
