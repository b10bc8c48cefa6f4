"""Command line of the port: ``python -m roko_tpu_torch inference``.

Mirrors ``roko-tpu inference`` (``roko_tpu/cli.py:554-574``) with the
flags of the same names, plus ``--device``. The model is a
reference-layout ``.pth`` state_dict; reading the HDF5 needs ``h5py``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from roko_tpu_torch.config import ModelConfig


def cmd_inference(args: argparse.Namespace) -> int:
    from roko_tpu_torch.infer import polish_to_fasta, resolve_device
    from roko_tpu_torch.models.convert import load_reference_pth
    from roko_tpu_torch.models.model import RokoModel

    device = resolve_device(args.device)
    overrides = {
        k: v
        for k, v in (("hidden_size", args.hidden_size), ("num_layers", args.num_layers))
        if v is not None
    }
    model = RokoModel(ModelConfig(**overrides))
    model.load_state_dict(load_reference_pth(args.model), strict=True)
    polish_to_fasta(args.data, model, args.out, device=device, batch_size=args.b)
    print(f"wrote polished contigs to {args.out}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m roko_tpu_torch",
        description="roko consensus polishing on PyTorch and CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("inference", help="features HDF5 + .pth -> polished FASTA")
    p.add_argument("data", help="inference HDF5 (from `roko-tpu features`)")
    p.add_argument("model", help="reference-layout torch .pth state_dict")
    p.add_argument("out", help="output FASTA path")
    p.add_argument("--b", type=int, default=128, help="batch size (default 128)")
    p.add_argument("--hidden-size", type=int, default=None)
    p.add_argument("--num-layers", type=int, default=None)
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the model runs (default cuda; no card is an error, "
        "never a silent move to the CPU)",
    )
    p.set_defaults(fn=cmd_inference)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
