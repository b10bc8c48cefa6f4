"""The reference's own numbers for ROADMAP fault C2: the bf16 GRU backward
at H = 256, B = 1, T = 90, S = 2, the shape where the card test
``tests/test_torch_gpu.py::test_bf16_gru_bwd_dw_pass_matches_plain
[256-1-90-2]`` runs the streaming bf16 recurrence.

The inputs are that test's draws (seed ``H*7 + B*3 + T + S`` = 1887: xp
normal, W_hh and b_hh uniform within 1/sqrt(H), dy normal, each rounded to
bf16), with the identity input projection of
``tests/test_torch_gru_bwd.py::dw_twin_vs_pallas`` so that xp is x on both
sides. ``c2_bf16_bwd.npz`` holds what ``jax.vjp`` through
``roko_tpu/models/pallas_gru.py::fused_bidir_layer(..., interpret=True,
compute_dtype=bfloat16)`` gives on them: the forward output ``y``, and
``dw_hh`` and ``db_hh`` of the Pallas backward (``_bwd_kernel_v3``), with
``draws_sha256``, a digest of the four draws, so that a card that draws
them again can check it drew the same bits. Nothing else is stored: the
draws come back from the seed.

    JAX_PLATFORMS=cpu python -m tests.torch_golden.c2   # rewrites the file
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

PATH = Path(__file__).with_name("c2_bf16_bwd.npz")
B, T, H, S = 1, 90, 256, 2
SEED = H * 7 + B * 3 + T + S


def draw():
    """(xp [B, T, S*3H], w_hh [S, H, 3H], b_hh [S, 3H], dy [B, T, S*H]) as
    float32 arrays holding bf16 values, in the card test's draw order."""
    import torch

    rng = np.random.default_rng(SEED)
    bound = 1.0 / np.sqrt(H)
    raw = (rng.standard_normal((B, T, S * 3 * H)), rng.uniform(-bound, bound, (S, H, 3 * H)),
           rng.uniform(-bound, bound, (S, 3 * H)), rng.standard_normal((B, T, S * H)))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()
                 for a in raw)


def digest(*arrays) -> str:
    """sha256 of the arrays' float32 bytes, one after another."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a, np.float32).tobytes())
    return h.hexdigest()


def compute() -> dict:
    """The golden's entries, from the reference on this machine."""
    import jax
    import jax.numpy as jnp

    import roko_tpu.models.pallas_gru as pg

    x, w, b, g = draw()
    eye = np.eye(S * 3 * H, dtype=np.float32)
    layer = {d: {"w_ih": eye[:, i * 3 * H:(i + 1) * 3 * H],
                 "b_ih": np.zeros(3 * H, np.float32), "w_hh": w[i], "b_hh": b[i]}
             for i, d in enumerate(("fwd", "bwd"))}
    y, vjp = jax.vjp(lambda lyr: pg.fused_bidir_layer(
        lyr, jnp.asarray(x), interpret=True, compute_dtype=jnp.bfloat16),
        jax.tree.map(jnp.asarray, layer))
    (want,) = vjp(jnp.asarray(g, dtype=y.dtype))
    return {"y": np.asarray(y, np.float32),
            **{f"{k}": np.stack([np.asarray(want[d][k], np.float32) for d in ("fwd", "bwd")])
               for k in ("w_hh", "b_hh")},
            "draws_sha256": np.array(digest(x, w, b, g))}


def load(path: Path = PATH) -> dict:
    """The committed golden: ``y``, ``w_hh`` (dW_hh), ``b_hh`` (db_hh) and
    ``draws_sha256``."""
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


if __name__ == "__main__":
    np.savez_compressed(PATH, **compute())
    print(f"wrote {PATH} ({PATH.stat().st_size} bytes)")
