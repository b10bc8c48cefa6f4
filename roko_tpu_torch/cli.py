"""Command line of the port: ``python -m roko_tpu_torch sim``,
``features``, ``train``, ``inference``, ``polish``, ``assess``, ``inspect``
and ``bench``.

Mirrors ``roko-tpu sim``, ``features``, ``train``, ``inference``,
``polish``, ``assess``, ``inspect`` and ``bench`` (``roko_tpu/cli.py:461-574``,
:590, :626-737, :1230, :1254, :1288; flags :35-64, :1310-1370, :1469-1537,
:1545-1632, :1858-1887) with the flags of the same names (``--model-kind``
takes gru, lingru and transformer; ``--d-model``, ``--num-heads`` and
``--mlp-ratio`` size the transformer, and ``--hidden-size`` without
``--d-model`` sets ``d_model`` to twice it), plus ``--device``. ``--config`` reads a
``RokoConfig`` JSON file of the reference's layout: built-in defaults <
the file < the flags given (``roko_tpu/cli.py:20-30``, :309-350), and
``--quantize none`` clears the file's setting; a file that asks for what
the port does not run is a usage error naming its queue item. ``train``
streams the corpus with ``--no-memory``, reads one of ``--data-shards``
shards, saves ``latest`` every ``--save-every-steps`` steps inside an
epoch, and ``--trace-dir`` (also on ``inference`` and ``polish``) writes
a ``torch.profiler`` trace. ``bench`` runs the suites of
``benchmark.py`` that the port has (inference, per kind, recurrence,
precision, ``--train``, ``--mesh-devices``); the flags of the others are usage errors that
name their queue item. ``polish`` streams by default (extraction,
batching and inference overlapped, ``--resume`` from its journal);
``--staged`` runs ``features`` then ``inference``; ``--truth`` prints
the assess report after either. ``inference`` and ``polish`` take a reference-layout
``.pth`` state_dict or a checkpoint directory that ``train`` wrote.
``train``, ``inference`` and ``polish`` take ``--compute-dtype
{auto,float32,bfloat16}`` and ``--quantize {int8,none}``
(``roko_tpu/cli.py:44-59``); ``train`` refuses int8, as the reference
does, and trains in bfloat16 with float32 weights. ``train``,
``inference`` and ``polish`` take ``--dp`` (``roko_tpu/cli.py:29-32``):
started as N processes with ``ROKO_COORDINATOR``, ``ROKO_NUM_PROCESSES``
and ``ROKO_PROCESS_ID`` (one per card), ``train`` splits each step's
batch over them and ``inference`` and ``polish`` split the contigs;
``polish`` then runs staged and refuses ``--resume`` and ``--keep-hdf5``
(:645-760), and ``--truth`` prints on rank 0. ``--tp`` and ``--sp``
split the transformer over a dp x tp x sp grid of the processes (its
heads and MLP units, its pileup columns; ``parallel/``): the dp groups
split the batch or the contigs, and the ranks of a group run them
together. A grid that does not cover the processes, and a transformer
whose heads (tp) or 90 columns (sp) the grid does not divide, are usage
errors.
Writing and reading the HDF5 needs ``h5py``. Not ported yet, each a
usage error that names its queue item: ``--distributed`` and
``--cascade`` (A10), and remote paths (A10).
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
    RokoConfig,
)


def _build_config(args: argparse.Namespace) -> RokoConfig:
    """Built-in defaults < the ``--config`` file < the flags given (a flag
    left at None defers to the layer below)."""
    base = RokoConfig()
    if getattr(args, "config", None):
        with open(args.config) as f:
            base = RokoConfig.from_json(f.read())

    def over(dc, **names):
        got = {f: getattr(args, attr, None) for f, attr in names.items()}
        return dataclasses.replace(dc, **{k: v for k, v in got.items() if v is not None})

    window = over(base.window, rows="window_rows", cols="window_cols", stride="window_stride")
    read_filter = over(base.read_filter, min_mapq="min_mapq", filter_flag="filter_flag")
    if getattr(args, "no_proper_pair", None):
        read_filter = dataclasses.replace(read_filter, require_proper_pair=False)
    model = over(base.model, kind="model_kind", hidden_size="hidden_size",
                 num_layers="num_layers", compute_dtype="compute_dtype", d_model="d_model",
                 num_heads="num_heads", mlp_ratio="mlp_ratio")
    quantize = getattr(args, "quantize", None)
    if quantize is not None:  # "none" clears the file's setting
        model = dataclasses.replace(model, quantize=None if quantize == "none" else quantize)
    # the transformer's head is the recurrent kinds' head: d_model tracks
    # 2 x hidden unless it is given
    if getattr(args, "hidden_size", None) is not None and getattr(args, "d_model", None) is None:
        model = dataclasses.replace(model, d_model=2 * model.hidden_size)
    # the model consumes the window geometry
    model = dataclasses.replace(model, window_rows=window.rows, window_cols=window.cols)
    mesh = over(base.mesh, dp="dp", tp="tp", sp="sp")
    guard = over(base.guard, spike_sigma="spike_sigma", max_bad_steps="max_bad_steps",
                 max_rollbacks="max_rollbacks", ema_beta="guard_ema_beta",
                 warmup_steps="guard_warmup_steps", save_every_steps="save_every_steps")
    if getattr(args, "no_guard", None):
        guard = dataclasses.replace(guard, enabled=False)
    return RokoConfig(
        window=window, read_filter=read_filter,
        region=over(base.region, size="region_size", overlap="region_overlap"),
        model=model,
        train=over(base.train, batch_size="b", epochs="epochs", lr="lr", patience="patience",
                   seed="seed", in_memory="memory", val_fraction="val_fraction"),
        data=over(base.data, shards="data_shards", shard_id="data_shard_id",
                  seed="data_seed", input_prefetch="input_prefetch",
                  block_size="data_block_size", mix_blocks="data_mix_blocks",
                  manifest="data_manifest"),
        mesh=mesh, guard=guard, serve=base.serve,
        pipeline=over(base.pipeline, prefetch="prefetch", queue_regions="queue_regions",
                      max_batch_delay_ms="batch_delay_ms"),
        resilience=base.resilience,
    )


def _model_config(args: argparse.Namespace) -> ModelConfig:
    return _build_config(args).model


def _features_config(cfg: RokoConfig) -> FeaturesConfig:
    return FeaturesConfig(window=cfg.window, read_filter=cfg.read_filter, region=cfg.region)


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
    n = _run_features(args, args.o, _features_config(args.cfg), bam_y=args.Y)
    print(f"wrote {n} windows to {args.o}")
    return 0


def cmd_train(args: argparse.Namespace) -> int:
    from roko_tpu_torch.infer import resolve_device
    from roko_tpu_torch.training.loop import train

    device = resolve_device(args.device)
    cfg = args.cfg
    train(args.train, args.out, args.val, model_cfg=cfg.model, train_cfg=cfg.train,
          guard_cfg=cfg.guard, data_cfg=cfg.data, mesh_cfg=cfg.mesh, device=device,
          resume=args.resume, trace_dir=args.trace_dir)
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
    temporary one unless ``--keep-hdf5``), then ``inference`` on it; a run
    of several processes is always staged, each rank extracting into a
    file of its own and polishing its contigs (``roko_tpu/cli.py:645-760``).
    The model is loaded on the host first, so a bad checkpoint fails
    before the extraction."""
    import os
    import sys
    import tempfile

    from roko_tpu_torch.infer import polish_to_fasta, resolve_device
    from roko_tpu_torch.parallel import distributed

    device = resolve_device(args.device)
    cfg = args.cfg
    several = distributed.world_size() > 1
    if several and args.keep_hdf5:
        raise SystemExit(
            "polish --keep-hdf5 is single-host only: every pod process would write the same "
            "path on a shared filesystem. Run the staged `features` + `inference` commands "
            "instead.")
    if several and args.resume:
        raise SystemExit(
            "polish --resume is a streaming-engine feature (the journal rides the incremental "
            "writer); it cannot combine with --staged or a multi-host pod.")
    model = _model_on_mesh(cfg, args.model)
    if args.staged or several:
        with tempfile.TemporaryDirectory() as td:
            hdf5 = args.keep_hdf5 or os.path.join(td, "features.hdf5")
            n = _run_features(args, hdf5, _features_config(cfg))
            print(f"extracted {n} windows")
            polish_to_fasta(hdf5, model, args.out, device=device,
                            batch_size=cfg.train.batch_size, trace_dir=args.trace_dir)
    else:
        from roko_tpu_torch.pipeline import run_streaming_polish
        from roko_tpu_torch.resilience import JournalMismatch

        try:
            run_streaming_polish(
                args.ref, args.X, model, dataclasses.replace(cfg, model=model.cfg),
                out_path=args.out, workers=args.t, seed=args.seed,
                batch_size=cfg.train.batch_size, device=device, tee_hdf5=args.keep_hdf5,
                job_retries=args.job_retries, job_timeout=args.job_timeout,
                resume=args.resume, trace_dir=args.trace_dir,
            )
        except JournalMismatch as e:
            print(f"polish: {e}", file=sys.stderr)
            return 1
    # the FASTA is rank 0's: only there is it certain to exist
    if distributed.is_primary():
        print(f"wrote polished contigs to {args.out}")
        if args.truth:
            _print_assess(args.out, args.truth)
    return 0


def cmd_inference(args: argparse.Namespace) -> int:
    from roko_tpu_torch.infer import polish_to_fasta, resolve_device

    device = resolve_device(args.device)
    model = _model_on_mesh(args.cfg, args.model)
    polish_to_fasta(args.data, model, args.out, device=device,
                    batch_size=args.cfg.train.batch_size, trace_dir=args.trace_dir)
    from roko_tpu_torch.parallel import distributed

    if distributed.is_primary():
        print(f"wrote polished contigs to {args.out}")
    return 0


def cmd_inspect(args: argparse.Namespace) -> int:
    """Per file of a features HDF5 (or a directory of them): its windows,
    geometry, region groups, contigs and kind (``roko_tpu/cli.py:1254-1285``,
    the same lines)."""
    import h5py

    from roko_tpu_torch.data.hdf5 import data_group_names, hdf5_files

    total_windows = 0
    for path in hdf5_files(args.data):
        with h5py.File(path, "r") as fd:
            groups = data_group_names(fd)
            windows = sum(fd[g]["examples"].shape[0] for g in groups)
            labeled = sum("labels" in fd[g] for g in groups)
            contigs = sorted(fd["contigs"].keys()) if "contigs" in fd else []
            first = fd[groups[0]]["examples"] if groups else None
            geom = f"{first.shape[1]}x{first.shape[2]}" if first is not None else "-"
            total_windows += windows
            kind = ("EMPTY (no region groups)" if not groups
                    else "training" if labeled == len(groups)
                    else "inference" if labeled == 0
                    else f"mixed ({labeled}/{len(groups)} labeled)")
            print(f"{path}: {windows} windows ({geom}) in {len(groups)} region groups, "
                  f"{len(contigs)} contig(s) "
                  f"[{', '.join(contigs[:5])}{'...' if len(contigs) > 5 else ''}], {kind}")
    print(f"total: {total_windows} windows")
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
                        ("--compare", args.compare), ("--mesh-devices", args.mesh_devices)):
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
            "--model-kind", choices=PORTED_KINDS, default=None,
            help="sequence block: gru (torch-exact reference, default), lingru "
            "(gated linear recurrence) or transformer (pre-LN encoder)",
        )
        p.add_argument("--hidden-size", type=int, default=None)
        p.add_argument("--num-layers", type=int, default=None)
        p.add_argument("--d-model", type=int, default=None,
                       help="transformer width (default 2 x --hidden-size)")
        p.add_argument("--num-heads", type=int, default=None,
                       help="transformer attention heads (default 8)")
        p.add_argument("--mlp-ratio", type=int, default=None,
                       help="transformer MLP width over d_model (default 4)")
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

    def mesh(p: argparse.ArgumentParser) -> None:
        p.add_argument("--dp", type=int, default=None,
                       help="data-parallel mesh axis: the processes of the run, one per card "
                       "(-1 = all of them, the default)")
        p.add_argument("--tp", type=int, default=None,
                       help="tensor-parallel mesh axis: ranks that split the transformer's "
                       "heads and MLP units (default 1)")
        p.add_argument("--sp", type=int, default=None,
                       help="sequence-parallel mesh axis: ranks that split the transformer's "
                       "pileup columns, with ring attention (default 1)")

    def config(p: argparse.ArgumentParser, trace: Optional[str] = None) -> None:
        p.add_argument(
            "--config", default=None,
            help="RokoConfig JSON file (RokoConfig.to_json layout, either package's); "
            "the flags given override its values")
        if trace:
            p.add_argument("--trace-dir", default=None,
                           help=f"write a torch.profiler trace of {trace} here "
                           "(Chrome trace JSON; on a card with its kernels)")

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
    config(p)
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
    p.add_argument("--b", type=int, default=None,
                   help="global batch size (default 128; a step's batch is b / --data-shards)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--patience", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument(
        "--no-resume", dest="resume", action="store_false", default=True,
        help="start fresh even if the checkpoint dir has a latest state",
    )
    p.add_argument("--memory", action="store_true", default=None,
                   help="hold the corpus in host memory (the default)")
    p.add_argument("--no-memory", dest="memory", action="store_false", default=None,
                   help="stream batches from the HDF5 files span by span instead")
    for flag, kind, text in (
        ("--data-shards", int, "split the corpus into this many deterministic shards and "
         "train on one (default 0: one shard)"),
        ("--data-shard-id", int, "the shard this run reads (default -1: 0)"),
        ("--data-seed", int, "seed of the epoch shuffles (default -1: --seed)"),
        ("--data-block-size", int, "rows of a span block: the unit the shuffle permutes "
         "and a resume skips (default 256)"),
        ("--data-mix-blocks", int, "blocks whose rows a mix group permutes together "
         "(default 8)"),
        ("--input-prefetch", int, "mix groups a reader thread keeps ahead of batching "
         "with --no-memory (default 2)"),
        ("--data-manifest", str, "pin the corpus manifest to this path: one that no longer "
         "matches the files is refused with the per-file diff (default: the sidecar "
         "beside the corpus, rebuilt when stale)"),
    ):
        p.add_argument(flag, type=kind, default=None, help=text)
    p.add_argument("--no-guard", action="store_true", default=None,
                   help="turn the NaN/loss-spike sentinel off")
    for flag, kind, text in (
        ("--spike-sigma", float, "skip an update whose loss lies this many EMA standard "
         "deviations above the loss EMA (default 6)"),
        ("--max-bad-steps", int, "skipped steps in a row that roll back to the last "
         "checkpoint (default 3)"),
        ("--max-rollbacks", int, "rollbacks after which the run gives up (default 3)"),
        ("--guard-ema-beta", float, "decay of the loss EMA and its variance (default 0.98)"),
        ("--guard-warmup-steps", int, "good steps before spike detection arms "
         "(default 20)"),
        ("--save-every-steps", int, "also save latest every N steps inside an epoch, with "
         "the data position, so a resume continues at the next batch (default 0)"),
    ):
        p.add_argument(flag, type=kind, default=None, help=text)
    common(p)
    mesh(p)
    config(p, "the first trained epoch")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("inference", help="features HDF5 + model -> polished FASTA")
    p.add_argument("data", help="inference HDF5 (from `roko-tpu features`)")
    p.add_argument("model", help="checkpoint directory of `train`, or a "
                   "reference-layout torch .pth state_dict")
    p.add_argument("out", help="output FASTA path")
    p.add_argument("--b", type=int, default=None, help="batch size (default 128)")
    common(p)
    mesh(p)
    config(p, "the inference loop")
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
    p.add_argument("--b", type=int, default=None, help="inference batch size (default 128)")
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
    extraction(p)
    common(p)
    mesh(p)
    config(p, "the inference (streaming: the whole run)")
    p.set_defaults(fn=cmd_polish)

    p = sub.add_parser("assess", help="polished FASTA vs truth FASTA -> error rates + Qscore")
    p.add_argument("polished", help="polished assembly FASTA")
    p.add_argument("truth", help="truth/reference FASTA")
    p.add_argument("--k", type=int, default=16, help="anchor k-mer size")
    p.add_argument("--json", default=None, help="also write a JSON report here")
    p.add_argument("--bed", default=None,
                   help="also write truth-space error loci (contig start end kind count)")
    p.set_defaults(fn=cmd_assess)

    p = sub.add_parser("inspect", help="summarise a features HDF5 file or directory")
    p.add_argument("data", help="features HDF5 file or directory")
    p.set_defaults(fn=cmd_inspect)

    from roko_tpu_torch.benchmark import add_mesh_flag, add_unported_flags

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
    add_mesh_flag(p)
    add_unported_flags(p)
    p.set_defaults(fn=cmd_bench)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "bench":
        from roko_tpu_torch.benchmark import unported_flag

        msg = unported_flag(args)
        if msg:
            parser.error(msg)
    if args.command == "polish":
        for flag in ("distributed", "cascade"):
            if getattr(args, flag):
                parser.error(f"polish --{flag} is not ported yet (queue item A10 of "
                             "ROADMAP.md)")
        if args.resume and args.staged:
            parser.error("polish --resume is a streaming-engine feature (the journal "
                         "rides the incremental writer); it cannot combine with --staged")
    if hasattr(args, "config"):  # the subcommands that read a RokoConfig
        try:
            args.cfg = _build_config(args)
            if args.command == "train":
                from roko_tpu_torch.training.loop import check_trainable

                check_trainable(args.cfg.model)
        except ValueError as e:
            parser.error(str(e))
    if hasattr(args, "dp"):  # the subcommands that run on the mesh
        _check_mesh(parser, args)
    return args.fn(args)


def _check_mesh(parser: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    """Join the run's processes (``ROKO_*``; nothing in one process) and
    refuse a grid the processes do not fill (``mesh_shape``'s message), or
    one that does not divide the transformer."""
    from roko_tpu_torch.parallel import distributed
    from roko_tpu_torch.parallel.mesh import mesh_shape
    from roko_tpu_torch.parallel.tp import check_divisible

    mesh = args.cfg.mesh
    distributed.initialize(device=args.device)
    try:
        _, tp, sp = mesh_shape(mesh)
    except ValueError as e:
        parser.error(f"mesh dp={mesh.dp}: {e}; the port runs one process per card: "
                     "start N processes with ROKO_COORDINATOR, ROKO_NUM_PROCESSES=N and "
                     "ROKO_PROCESS_ID for a dp x tp x sp grid of N")
    try:
        check_divisible(args.cfg.model, tp, sp)
    except ValueError as e:
        parser.error(f"mesh tp={tp} sp={sp}: {e}")


def _model_on_mesh(cfg: RokoConfig, model_arg: str):
    """The model of ``cfg`` on the run's grid, its parameters (a full
    state_dict: a checkpoint directory or a reference ``.pth``) cut to
    this rank's part."""
    from roko_tpu_torch.models.model import RokoModel
    from roko_tpu_torch.parallel.mesh import make_mesh
    from roko_tpu_torch.parallel.tp import shard_state_dict

    mesh = make_mesh(cfg.mesh)
    model = RokoModel(cfg.model, mesh=mesh)
    model.load_state_dict(shard_state_dict(cfg.model, _load_model_params(model_arg), mesh),
                          strict=True)
    return model
