"""Command line of the port: ``python -m roko_tpu_torch sim``,
``features``, ``train``, ``inference``, ``polish``, ``assess`` and
``bench``.

Mirrors ``roko-tpu sim``, ``features``, ``train``, ``inference``,
``polish``, ``assess`` and ``bench`` (``roko_tpu/cli.py:461-574``,
:590, :626-737, :1230, :1288; flags :1310-1370, :1469-1537, :1545-1632,
:1864-1887) with the flags of the same names (``--model-kind`` takes the
kinds the port runs), plus ``--device``. ``bench`` runs the suites of
``benchmark.py`` that the port has (inference, per kind, recurrence,
precision, ``--train``); the flags of the others are usage errors that
name their queue item. ``polish`` streams by default (extraction,
batching and inference overlapped, ``--resume`` from its journal);
``--staged`` runs ``features`` then ``inference``; ``--truth`` prints
the assess report after either. ``inference`` and ``polish`` take a reference-layout
``.pth`` state_dict or a checkpoint directory that ``train`` wrote.
``train``, ``inference`` and ``polish`` take ``--compute-dtype
{auto,float32,bfloat16}`` and ``--quantize {int8,none}``
(``roko_tpu/cli.py:44-59``); ``train`` refuses int8, as the reference
does, and trains in bfloat16 with float32 weights.
Writing and reading the HDF5 needs ``h5py``. Not ported yet, each a
usage error that names its queue item: ``--distributed`` and
``--cascade`` (A10), ``--config`` and ``--trace-dir`` (A11), and remote
paths.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

from roko_tpu_torch.config import (
    COMPUTE_DTYPES,
    PORTED_KINDS,
    QUANTIZE_MODES,
    FeaturesConfig,
    ModelConfig,
)


def _model_config(args: argparse.Namespace, **window) -> ModelConfig:
    """The model flags over the defaults; ``--quantize none`` is off."""
    return ModelConfig(kind=args.model_kind, **window, **{
        k: v
        for k, v in (("hidden_size", args.hidden_size), ("num_layers", args.num_layers),
                     ("compute_dtype", args.compute_dtype))
        if v is not None
    }, quantize=None if args.quantize in (None, "none") else args.quantize)


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


def _print_assess(polished_path: str, truth_path: str, k: int = 16,
                  json_path: Optional[str] = None, bed_path: Optional[str] = None) -> None:
    from roko_tpu_torch.eval.assess import assess_fastas, format_report, write_bed, write_json
    from roko_tpu_torch.io.fasta import read_fasta

    truth = {n: s.encode() for n, s in read_fasta(truth_path)}
    polished = {n: s.encode() for n, s in read_fasta(polished_path)}
    res = assess_fastas(truth, polished, k=k, collect_errors=bed_path is not None)
    print(format_report(res))
    if json_path:
        write_json(res, json_path)
        print(f"wrote {json_path}")
    if bed_path:
        write_bed(res, bed_path)
        print(f"wrote {bed_path}")


def cmd_assess(args: argparse.Namespace) -> int:
    """Polished-vs-truth error rates and Q score."""
    _print_assess(args.polished, args.truth, k=args.k, json_path=args.json, bed_path=args.bed)
    return 0


def cmd_polish(args: argparse.Namespace) -> int:
    """Draft -> polished FASTA. Default: the streaming engine
    (``pipeline.stream``), which writes each contig as soon as its last
    window is voted, behind a resume journal; ``--keep-hdf5`` tees the
    features to an HDF5 file. ``--staged``: features into an HDF5 file (a
    temporary one unless ``--keep-hdf5``), then ``inference`` on it. The
    model is loaded on the host first, so a bad checkpoint fails before
    the extraction."""
    import os
    import sys
    import tempfile

    from roko_tpu_torch.config import PipelineConfig, RokoConfig
    from roko_tpu_torch.infer import polish_to_fasta, resolve_device
    from roko_tpu_torch.models.model import RokoModel

    device = resolve_device(args.device)
    cfg = _features_config(args)
    model = RokoModel(_model_config(args, window_rows=cfg.window.rows,
                                    window_cols=cfg.window.cols))
    model.load_state_dict(_load_model_params(args.model), strict=True)
    if args.staged:
        with tempfile.TemporaryDirectory() as td:
            hdf5 = args.keep_hdf5 or os.path.join(td, "features.hdf5")
            n = _run_features(args, hdf5, cfg)
            print(f"extracted {n} windows")
            polish_to_fasta(hdf5, model, args.out, device=device, batch_size=args.b)
    else:
        from roko_tpu_torch.pipeline import run_streaming_polish
        from roko_tpu_torch.resilience import JournalMismatch

        pipeline = PipelineConfig(**{
            k: v for k, v in (("queue_regions", args.queue_regions),
                              ("max_batch_delay_ms", args.batch_delay_ms),
                              ("prefetch", args.prefetch))
            if v is not None
        })
        try:
            run_streaming_polish(
                args.ref, args.X, model,
                RokoConfig(window=cfg.window, read_filter=cfg.read_filter,
                           region=cfg.region, model=model.cfg, pipeline=pipeline),
                out_path=args.out, workers=args.t, seed=args.seed, batch_size=args.b,
                device=device, tee_hdf5=args.keep_hdf5, job_retries=args.job_retries,
                job_timeout=args.job_timeout, resume=args.resume,
            )
        except JournalMismatch as e:
            print(f"polish: {e}", file=sys.stderr)
            return 1
    print(f"wrote polished contigs to {args.out}")
    if args.truth:
        _print_assess(args.out, args.truth)
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


def cmd_bench(args: argparse.Namespace) -> int:
    """The benchmark JSON line (``benchmark.main``); 1 when a row of a
    ported suite failed."""
    from roko_tpu_torch.benchmark import main as bench_main

    argv: List[str] = ["--device", args.device]
    if args.train:
        argv.append("--train")
    for flag, value in (("--batch", args.b), ("--out", args.out),
                        ("--bench-iterations", args.bench_iterations),
                        ("--compare", args.compare)):
        if value is not None:
            argv += [flag, str(value)]
    return bench_main(argv)


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
            "--compute-dtype", default=None, choices=COMPUTE_DTYPES,
            help="matmul and recurrence compute dtype (params stay f32). Default "
            "auto: float32 on cuda and cpu (bfloat16 only on a TPU, as in roko-tpu)",
        )
        p.add_argument(
            "--quantize", default=None, choices=QUANTIZE_MODES + ("none",),
            help="weight-only quantization of the dense and recurrent matrices, "
            "applied when the checkpoint is loaded (training always runs full "
            "precision): int8 with per-output-channel f32 scales; 'none' is off",
        )
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
        "polish", help="draft FASTA + reads BAM + model -> polished FASTA")
    p.add_argument("ref", help="draft assembly FASTA")
    p.add_argument("X", help="reads-to-draft BAM or SAM")
    p.add_argument("model", help="checkpoint directory of `train`, or a "
                   "reference-layout torch .pth state_dict")
    p.add_argument("out", help="output FASTA path")
    p.add_argument("--staged", action="store_true",
                   help="force the two-stage features -> HDF5 -> inference path "
                   "instead of the default streaming engine")
    p.add_argument("--keep-hdf5", default=None,
                   help="also write the features HDF5 here (streaming: a tee)")
    p.add_argument("--truth", default=None,
                   help="truth FASTA: print an assess report after polishing")
    p.add_argument("--b", type=int, default=128, help="inference batch size (default 128)")
    p.add_argument("--prefetch", type=int, default=None,
                   help="streaming: submitted region blocks whose predictions may be "
                   "outstanding (default 2)")
    p.add_argument("--queue-regions", type=int, default=None,
                   help="streaming: bounded region-queue depth in region blocks "
                   "(default 8; a full queue blocks the extraction workers)")
    p.add_argument("--batch-delay-ms", type=float, default=None,
                   help="streaming: flush a partial device batch at most this long "
                   "after its oldest window was queued (default 250)")
    p.add_argument("--resume", action="store_true",
                   help="streaming: resume a crashed run from the journal beside the "
                   "output (<out>.resume/); committed contigs are not re-extracted")
    for flag, item in (("--distributed", "A10"), ("--cascade", "A10")):
        p.add_argument(flag, action="store_true", help=f"not ported yet (queue item {item})")
    for flag, item in (("--config", "A11"), ("--trace-dir", "A11")):
        p.add_argument(flag, default=None, help=f"not ported yet (queue item {item})")
    extraction(p)
    common(p)
    p.set_defaults(fn=cmd_polish)

    p = sub.add_parser("assess", help="polished FASTA vs truth FASTA -> error rates + Qscore")
    p.add_argument("polished", help="polished assembly FASTA")
    p.add_argument("truth", help="truth/reference FASTA")
    p.add_argument("--k", type=int, default=16, help="anchor k-mer size")
    p.add_argument("--json", default=None, help="also write a JSON report here")
    p.add_argument("--bed", default=None,
                   help="also write truth-space error loci (contig start end kind count)")
    p.set_defaults(fn=cmd_assess)

    from roko_tpu_torch.benchmark import add_unported_flags

    p = sub.add_parser("bench", help="print the benchmark JSON line")
    p.add_argument("--train", action="store_true", help="also time training steps")
    p.add_argument("--b", type=int, default=None,
                   help="exact benchmark batch size (default: sweep 512, 2048 on a card)")
    p.add_argument("--out", default=None, help="write full results JSON here")
    p.add_argument("--bench-iterations", type=int, default=None,
                   help="fixed-work mode: pin the timed iteration count of the suites")
    p.add_argument("--compare", default=None, metavar="BENCH_JSON",
                   help="previous result to diff against: adds detail.vs_previous, and "
                   "defaults to fixed-work --bench-iterations")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the model runs (default cuda; no card is an error, never a "
                   "silent move to the CPU)")
    add_unported_flags(p)
    p.set_defaults(fn=cmd_bench)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "train":
        from roko_tpu_torch.training.loop import check_trainable

        try:
            check_trainable(_model_config(args))
        except ValueError as e:
            parser.error(str(e))
    if args.command == "bench":
        from roko_tpu_torch.benchmark import unported_flag

        msg = unported_flag(args)
        if msg:
            parser.error(msg)
    if args.command == "polish":
        for flag, item in (("distributed", "A10"), ("cascade", "A10"),
                           ("config", "A11"), ("trace_dir", "A11")):
            if getattr(args, flag):
                parser.error(f"polish --{flag.replace('_', '-')} is not ported yet "
                             f"(queue item {item} of ROADMAP.md)")
        if args.resume and args.staged:
            parser.error("polish --resume is a streaming-engine feature (the journal "
                         "rides the incremental writer); it cannot combine with --staged")
    return args.fn(args)
