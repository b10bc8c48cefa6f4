"""Convert a ``roko_tpu`` checkpoint directory (Orbax) into a
reference-layout ``.pth`` state_dict that ``python -m roko_tpu_torch
inference`` and ``polish`` load.

    JAX_PLATFORMS=cpu python tools/orbax_to_pth.py CKPT_DIR OUT.pth

Reads the parameters with ``roko_tpu.training.checkpoint.load_params``
(the best numbered checkpoint, else ``latest``; each verified against its
sha256 manifest), converts them with the port's
``roko_tpu_torch.models.convert.state_dict_from_jax``, and writes the
state_dict with ``torch.save``. Needs JAX and ``orbax.checkpoint``, as
``roko_tpu`` does; the port itself imports neither, which is why this
one-shot tool lives outside it.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def convert(ckpt_dir: str, out_path: str) -> int:
    """Write ``out_path``; returns the number of tensors written."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import jax
    import numpy as np
    import torch

    from roko_tpu.training.checkpoint import load_params
    from roko_tpu_torch.models.convert import state_dict_from_jax

    params = jax.tree.map(np.asarray, load_params(ckpt_dir))
    sd = state_dict_from_jax(params)
    tmp = out_path + ".tmp"
    torch.save(sd, tmp)
    os.replace(tmp, out_path)
    return len(sd)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("ckpt_dir", help="roko_tpu checkpoint directory (train's output)")
    p.add_argument("out", help="the .pth to write")
    args = p.parse_args(argv)
    n = convert(args.ckpt_dir, args.out)
    print(f"wrote {n} tensors from {args.ckpt_dir} to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
