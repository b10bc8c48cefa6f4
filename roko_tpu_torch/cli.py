"""Command line of the port: ``python -m roko_tpu_torch sim``,
``features``, ``train``, ``inference`` and ``polish --staged``.

Mirrors ``roko-tpu sim``, ``features``, ``train``, ``inference`` and the
staged branch of ``polish`` (``roko_tpu/cli.py:461-574``, :626-737,
:1230; flags :1310-1370, :1545-1600, :1864-1873) with the flags of the
same names (``--model-kind`` takes the kinds the port runs), plus
``--device``. ``inference`` and ``polish`` take a reference-layout
``.pth`` state_dict or a checkpoint directory that ``train`` wrote.
Writing and reading the HDF5 needs ``h5py``. Not ported yet: the
streaming ``polish`` (the default there), ``--truth`` and ``assess``,
``--config``, ``--distributed``, ``--resume`` and remote paths.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

from roko_tpu_torch.config import PORTED_KINDS, FeaturesConfig, ModelConfig


def _model_config(args: argparse.Namespace, **window) -> ModelConfig:
    return ModelConfig(kind=args.model_kind, **window, **{
        k: v
        for k, v in (("hidden_size", args.hidden_size), ("num_layers", args.num_layers))
        if v is not None
    })


def _features_config(args: argparse.Namespace) -> FeaturesConfig:
    """Defaults, overridden by the flags given (a flag left at None
    defers to the default)."""
    base = FeaturesConfig()

    def over(dc, **names):
        got = {f: getattr(args, attr) for f, attr in names.items()}
        return dataclasses.replace(dc, **{k: v for k, v in got.items() if v is not None})

    read_filter = over(base.read_filter, min_mapq="min_mapq", filter_flag="filter_flag")
    if args.no_proper_pair:
        read_filter = dataclasses.replace(read_filter, require_proper_pair=False)
    return FeaturesConfig(
        window=over(base.window, rows="window_rows", cols="window_cols",
                    stride="window_stride"),
        read_filter=read_filter,
        region=over(base.region, size="region_size", overlap="region_overlap"),
    )


def cmd_sim(args: argparse.Namespace) -> int:
    """A synthetic polishing project: truth and draft FASTA, reads and
    truth BAMs with exact alignments."""
    from roko_tpu_torch.sim import build_synthetic_project

    kwargs = {
        k: v
        for k, v in (("seed", args.seed), ("genome_len", args.genome_len),
                     ("coverage", args.coverage), ("read_len", args.read_len))
        if v is not None
    }
    for k, v in build_synthetic_project(args.out_dir, **kwargs).items():
        print(f"{k}: {v}")
    return 0


def _run_features(args: argparse.Namespace, out: str, cfg: FeaturesConfig,
                  bam_y: Optional[str] = None) -> int:
    from roko_tpu_torch.features.backend import selected
    from roko_tpu_torch.features.pipeline import run_features

    print(f"features: {selected()} extractor, {args.t} worker(s)")
    return run_features(args.ref, args.X, out, bam_y=bam_y, workers=args.t,
                        seed=args.seed, config=cfg, job_retries=args.job_retries,
                        job_timeout=args.job_timeout)


def cmd_features(args: argparse.Namespace) -> int:
    n = _run_features(args, args.o, _features_config(args), bam_y=args.Y)
    print(f"wrote {n} windows to {args.o}")
    return 0


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


def cmd_polish(args: argparse.Namespace) -> int:
    """``polish --staged``: features into an HDF5 file (a temporary one
    unless ``--keep-hdf5``), then ``inference`` on it. The model is loaded
    on the host first, so a bad checkpoint fails before the extraction;
    nothing reaches the card until the features are written."""
    import os
    import tempfile

    from roko_tpu_torch.infer import polish_to_fasta, resolve_device
    from roko_tpu_torch.models.model import RokoModel

    device = resolve_device(args.device)
    cfg = _features_config(args)
    model = RokoModel(_model_config(args, window_rows=cfg.window.rows,
                                    window_cols=cfg.window.cols))
    model.load_state_dict(_load_model_params(args.model), strict=True)
    with tempfile.TemporaryDirectory() as td:
        hdf5 = args.keep_hdf5 or os.path.join(td, "features.hdf5")
        n = _run_features(args, hdf5, cfg)
        print(f"extracted {n} windows")
        polish_to_fasta(hdf5, model, args.out, device=device, batch_size=args.b)
    print(f"wrote polished contigs to {args.out}")
    return 0


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
        p.add_argument(
            "--model-kind", choices=PORTED_KINDS, default="gru",
            help="recurrence family: gru (torch-exact reference, default) or "
            "lingru (gated linear recurrence)",
        )
        p.add_argument("--hidden-size", type=int, default=None)
        p.add_argument("--num-layers", type=int, default=None)
        p.add_argument(
            "--device", choices=("cuda", "cpu"), default="cuda",
            help="where the model runs (default cuda; no card is an error, "
            "never a silent move to the CPU)",
        )

    def extraction(p: argparse.ArgumentParser) -> None:
        p.add_argument("--t", type=int, default=1, help="feature workers")
        p.add_argument("--seed", type=int, default=0, help="row-sampling RNG seed")
        p.add_argument("--job-retries", type=int, default=1,
                       help="in-parent retries for a region job that raised")
        p.add_argument(
            "--job-timeout", type=float, default=None,
            help="seconds to wait per region result before assuming the worker "
            "died and finishing the rest in the parent (process pools only)")
        p.add_argument("--window-rows", type=int, default=None, help="pileup rows per window")
        p.add_argument("--window-cols", type=int, default=None,
                       help="pileup columns per window")
        p.add_argument("--window-stride", type=int, default=None)
        p.add_argument("--region-size", type=int, default=None)
        p.add_argument("--region-overlap", type=int, default=None)
        p.add_argument("--min-mapq", type=int, default=None,
                       help="read filter: minimum mapping quality")
        p.add_argument("--filter-flag", type=int, default=None,
                       help="read filter: SAM flag mask to drop")
        p.add_argument("--no-proper-pair", action="store_true",
                       help="read filter: drop the proper-pair requirement for paired reads")

    p = sub.add_parser(
        "sim", help="write a synthetic truth/draft/reads project (no aligner needed)")
    p.add_argument("out_dir")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--genome-len", type=int, default=None)
    p.add_argument("--coverage", type=int, default=None)
    p.add_argument("--read-len", type=int, default=None)
    p.set_defaults(fn=cmd_sim)

    p = sub.add_parser("features", help="FASTA + BAM (or SAM) -> features HDF5")
    p.add_argument("ref", help="draft assembly FASTA")
    p.add_argument("X", help="reads-to-draft BAM or SAM")
    p.add_argument("o", help="output HDF5 path")
    p.add_argument("--Y", default=None, help="truth-to-draft BAM or SAM (training mode)")
    extraction(p)
    p.set_defaults(fn=cmd_features)

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

    p = sub.add_parser(
        "polish", help="draft FASTA + reads BAM + model -> polished FASTA (--staged)")
    p.add_argument("ref", help="draft assembly FASTA")
    p.add_argument("X", help="reads-to-draft BAM or SAM")
    p.add_argument("model", help="checkpoint directory of `train`, or a "
                   "reference-layout torch .pth state_dict")
    p.add_argument("out", help="output FASTA path")
    p.add_argument("--staged", action="store_true",
                   help="features -> HDF5 -> inference, the only polish the port runs")
    p.add_argument("--keep-hdf5", default=None, help="write the features HDF5 here")
    p.add_argument("--truth", default=None,
                   help="truth FASTA for an assess report (not ported yet)")
    p.add_argument("--b", type=int, default=128, help="inference batch size (default 128)")
    extraction(p)
    common(p)
    p.set_defaults(fn=cmd_polish)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "polish":
        if not args.staged:
            parser.error("polish: the streaming engine is not ported yet; run "
                         "`polish --staged` (features, then inference)")
        if args.truth is not None:
            parser.error("polish --truth: the assess scorer is not ported yet")
    return args.fn(args)
