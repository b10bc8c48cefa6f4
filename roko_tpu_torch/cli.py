"""Command line of the port: ``python -m roko_tpu_torch train`` and
``inference``.

Mirrors ``roko-tpu train`` and ``roko-tpu inference``
(``roko_tpu/cli.py:507-574``, flags :1332-1370) with the flags of the
same names, plus ``--device``. ``inference`` takes a reference-layout
``.pth`` state_dict or a checkpoint directory that ``train`` wrote.
Reading the HDF5 needs ``h5py``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from roko_tpu_torch.config import ModelConfig


def _model_config(args: argparse.Namespace) -> ModelConfig:
    return ModelConfig(**{
        k: v
        for k, v in (("hidden_size", args.hidden_size), ("num_layers", args.num_layers))
        if v is not None
    })


def cmd_train(args: argparse.Namespace) -> int:
    from roko_tpu_torch.config import TrainConfig
    from roko_tpu_torch.infer import resolve_device
    from roko_tpu_torch.training.loop import train

    device = resolve_device(args.device)
    tcfg = TrainConfig(**{
        k: v
        for k, v in (("batch_size", args.b), ("epochs", args.epochs), ("lr", args.lr),
                     ("patience", args.patience), ("seed", args.seed),
                     ("val_fraction", args.val_fraction))
        if v is not None
    })
    train(args.train, args.out, args.val, model_cfg=_model_config(args),
          train_cfg=tcfg, device=device, resume=args.resume)
    return 0


def _load_model_params(model_arg: str):
    """A checkpoint directory of ``train``, or a reference ``.pth``."""
    import os

    if os.path.isdir(model_arg):
        from roko_tpu_torch.training.checkpoint import load_params

        return load_params(model_arg)
    from roko_tpu_torch.models.convert import load_reference_pth

    return load_reference_pth(model_arg)


def cmd_inference(args: argparse.Namespace) -> int:
    from roko_tpu_torch.infer import polish_to_fasta, resolve_device
    from roko_tpu_torch.models.model import RokoModel

    device = resolve_device(args.device)
    model = RokoModel(_model_config(args))
    model.load_state_dict(_load_model_params(args.model), strict=True)
    polish_to_fasta(args.data, model, args.out, device=device, batch_size=args.b)
    print(f"wrote polished contigs to {args.out}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m roko_tpu_torch",
        description="roko consensus polishing on PyTorch and CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p: argparse.ArgumentParser) -> None:
        p.add_argument("--hidden-size", type=int, default=None)
        p.add_argument("--num-layers", type=int, default=None)
        p.add_argument(
            "--device", choices=("cuda", "cpu"), default="cuda",
            help="where the model runs (default cuda; no card is an error, "
            "never a silent move to the CPU)",
        )

    p = sub.add_parser("train", help="training HDF5 -> checkpoints")
    p.add_argument("train", help="training HDF5 file or directory")
    p.add_argument("out", help="checkpoint output directory")
    p.add_argument("--val", default=None, help="validation HDF5 file or directory")
    p.add_argument(
        "--val-fraction", type=float, default=None,
        help="without --val: hold out this fraction of training windows "
        "for validation so early stopping works (seeded split)",
    )
    p.add_argument("--b", type=int, default=None, help="batch size (default 128)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--patience", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument(
        "--no-resume", dest="resume", action="store_false", default=True,
        help="start fresh even if the checkpoint dir has a latest state",
    )
    common(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("inference", help="features HDF5 + model -> polished FASTA")
    p.add_argument("data", help="inference HDF5 (from `roko-tpu features`)")
    p.add_argument("model", help="checkpoint directory of `train`, or a "
                   "reference-layout torch .pth state_dict")
    p.add_argument("out", help="output FASTA path")
    p.add_argument("--b", type=int, default=128, help="batch size (default 128)")
    common(p)
    p.set_defaults(fn=cmd_inference)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
