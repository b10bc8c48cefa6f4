"""Command line of the port: ``python -m roko_tpu_torch sim``,
``features``, ``train``, ``inference``, ``polish``, ``assess``, ``inspect``,
``bench``, ``serve``, ``compile`` and ``rollout``.

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
precision, ``--train``, ``--mesh-devices``, ``--serve-mix``,
``--coldstart-ladder``, ``--fleet-workers``, ``--cascade-draft``); the
flags of the others are usage errors that name their queue item. ``polish`` streams by default (extraction,
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
``serve MODEL`` is the single-process polishing service
(``roko_tpu/cli.py:966-1108``, flags :1644-1819): it loads the model
once, binds the socket, warms the batch ladder on a thread while
``/healthz`` says ``warming``, prints its ready line and answers ``POST
/polish`` through the ``--batching`` policy (``serve/server.py``);
``--announce FILE`` writes the bound port. ``train`` and ``serve`` take
``--event-log``. ``serve --workers N`` (``auto``: one per visible card)
runs the fleet's supervisor instead (``serve/supervisor.py``,
``roko_tpu/cli.py:1006-1035``): N workers on their
``--devices-per-worker`` card slices (0: sharing the cards), each one
session over k ``serve`` ranks that the supervisor starts under
``ROKO_*``, one rank a card of its slice (shared cards: the config's
``dp x tp x sp`` grid when it names every axis, else the visible cards;
k = 1 is a plain process), restarted all k together; failover
routing, restarts, ``--registry``, the rollout gate's ``--bake-s``,
``--rollback-error-pct`` and ``--rollback-p99-x``, the autoscaler's
``--min-workers``/``--max-workers`` and the ``--ab-lane``; ``rollout
NAME`` drives a running supervisor onto a registered version
(:1112-1227). ``compile OUT`` writes a kernel bundle
(``compile/bundle.py``, :842-964): the libraries the model's kind and
dtype launch, checked in a fresh process unless ``--no-verify``, and
registered with ``--register NAME [--params CKPT]``; ``serve``,
``polish`` and ``inference`` load one with ``--bundle`` and take
``--compile-cache DIR`` and ``--no-compile-cache`` (the kernel build
cache, ``compile/cache.py``). ``inference``, ``polish`` and ``serve``
take ``--cascade [T]`` with ``--cascade-tier``, ``--cascade-version``,
``--cascade-method``, ``--cascade-calibration``, ``--cascade-cache-bytes``
and ``--cascade-cache-dir`` (``cascade/``, ``roko_tpu/cli.py:252-290``):
a cheap tier first, only uncertain windows reach the model. ``polish
--distributed`` (``pipeline/distpolish.py``, :662-695) shards the job over
a forked fleet of ``--workers`` serve processes in units of whole contigs
or ``--unit-bases`` spans, ``--unit-attempts`` each, resumable with
``--resume``; ``polish`` takes ``--event-log``. Writing and reading the
HDF5 needs ``h5py``. ``features``, ``train``, ``inference``, ``polish`` and
``serve`` read and write ``gs://``, ``s3://`` and ``http(s)://`` paths
through the object-store client (``datapipe/store.py``), configured by
``--store-cache``, ``--store-endpoint``, the config's ``store`` section and
``ROKO_STORE_*``. ``serve --federation`` runs the multi-host federation's
front (no model), and ``serve MODEL --host-agent --join HOST:PORT
[--host-id ID] [--lease-ttl S]`` a host agent of it
(``serve/federation.py``). ``serve`` and ``compile`` started as N
processes under ``ROKO_COORDINATOR``/``ROKO_NUM_PROCESSES``/
``ROKO_PROCESS_ID`` take ``--dp``/``--tp``/``--sp`` (``roko_tpu/cli.py:
29-32``, :861-874, :1047-1080): ``serve`` runs ONE session over the
ranks (``serve/session.py``), rank 0 binds, answers and dispatches every
global rung, the other ranks follow, and ``compile`` resolves its ladder
against dp and rank 0 writes the bundle; ``--workers``, ``--federation``,
``--host-agent`` and ``--join`` then are usage errors.
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

#: the fleet's front end and workers: ``python -m roko_tpu_torch``
_MODULE = "roko_tpu_torch"


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
                 warmup_steps="guard_warmup_steps", save_every_steps="save_every_steps",
                 event_log="event_log", event_log_max_mb="event_log_max_mb")
    if getattr(args, "no_guard", None):
        guard = dataclasses.replace(guard, enabled=False)
    fleet = over(base.fleet, workers="workers", devices_per_worker="devices_per_worker",
                 heartbeat_interval_s="heartbeat_interval", registry_dir="registry",
                 bake_s="bake_s", rollback_error_pct="rollback_error_pct",
                 rollback_p99_x="rollback_p99_x", min_workers="min_workers",
                 max_workers="max_workers", join="join", host_id="host_id",
                 lease_ttl_s="lease_ttl")
    ab = getattr(args, "ab_lane", None)
    if ab is not None:
        fleet = dataclasses.replace(fleet, ab_version=ab[0], ab_fraction=ab[1])
    compile_cfg = over(base.compile, cache_dir="compile_cache", bundle_dir="bundle")
    if getattr(args, "no_compile_cache", None):
        compile_cfg = dataclasses.replace(compile_cfg, enabled=False)
    cascade = over(base.cascade, tier="cascade_tier", tier_version="cascade_version",
                   method="cascade_method", calibration_path="cascade_calibration",
                   cache_bytes="cascade_cache_bytes", cache_dir="cascade_cache_dir")
    # --cascade enables; its optional value (-1.0 for the bare flag) sets
    # the threshold over the config layer
    casc_flag = getattr(args, "cascade", None)
    if casc_flag is not None:
        cascade = dataclasses.replace(
            cascade, enabled=True, **({} if casc_flag == -1.0 else {"threshold": casc_flag}))
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
        mesh=mesh, guard=guard,
        serve=over(base.serve, host="host", port="port", max_queue="max_queue",
                   max_delay_ms="max_delay_ms", data_root="data_root", ladder="ladder",
                   batching="batching", max_queue_age_ms="max_queue_age_ms",
                   rung_upgrade_fill="rung_upgrade_fill", event_log="event_log",
                   event_log_max_mb="event_log_max_mb", trace_ring="trace_ring",
                   tenants="tenants"),
        pipeline=over(base.pipeline, prefetch="prefetch", queue_regions="queue_regions",
                      max_batch_delay_ms="batch_delay_ms"),
        resilience=over(base.resilience, predict_deadline_s="predict_deadline",
                        compile_deadline_s="compile_deadline",
                        breaker_failures="breaker_failures",
                        breaker_reset_s="breaker_reset_s", drain_deadline_s="drain_deadline"),
        compile=compile_cfg, fleet=fleet,
        distpolish=over(base.distpolish, unit_bases="unit_bases",
                        unit_attempts="unit_attempts"),
        cascade=cascade,
        store=over(base.store, cache_dir="store_cache", endpoint="store_endpoint"),
    )


def _configure_store(cfg: RokoConfig) -> None:
    """Install the object-store client with this run's config, so that
    ``gs://``, ``s3://`` and ``http(s)://`` arguments resolve through it
    (``ROKO_STORE_FAULTS`` still applies on top)."""
    from roko_tpu_torch.datapipe.store import configure_store

    configure_store(cfg.store)


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
    _configure_store(args.cfg)
    n = _run_features(args, args.o, _features_config(args.cfg), bam_y=args.Y)
    print(f"wrote {n} windows to {args.o}")
    return 0


def _configure_event_log(path: Optional[str], max_mb: float,
                         worker_id: Optional[int] = None, rank: int = 0) -> None:
    """Install the process-wide JSONL event sink (``obs/events.py``); a
    fleet worker writes ``PATH.w<id>`` (its follower rank r
    ``PATH.w<id>.r<r>``), so N processes never share one file's
    rotation."""
    if not path:
        return
    from roko_tpu_torch.obs.events import configure_event_log

    if worker_id is not None:
        path = f"{path}.w{worker_id}" + (f".r{rank}" if rank else "")
    configure_event_log(path, max_mb)
    print(f"obs: event log -> {path}")


def cmd_train(args: argparse.Namespace) -> int:
    from roko_tpu_torch.infer import resolve_device
    from roko_tpu_torch.training.loop import train

    device = resolve_device(args.device)
    cfg = args.cfg
    _configure_store(cfg)
    _configure_event_log(cfg.guard.event_log, cfg.guard.event_log_max_mb)
    train(args.train, args.out, args.val, model_cfg=cfg.model, train_cfg=cfg.train,
          guard_cfg=cfg.guard, data_cfg=cfg.data, mesh_cfg=cfg.mesh, device=device,
          resume=args.resume, trace_dir=args.trace_dir)
    return 0


def _load_model_params(model_arg: str):
    """A checkpoint directory of ``train``, or a reference ``.pth``."""
    from roko_tpu_torch.models.convert import load_model_params

    return load_model_params(model_arg)


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

    cfg = args.cfg
    _configure_store(cfg)
    several = distributed.world_size() > 1
    _configure_event_log(cfg.serve.event_log, cfg.serve.event_log_max_mb,
                         worker_id=distributed.rank() if several else None)
    if args.distributed:
        # the map-reduce polish over a forked worker fleet
        # (pipeline/distpolish.py, roko_tpu/cli.py:662-695): this process
        # coordinates and never loads the model; its workers do, on
        # --device
        if several:
            raise SystemExit(
                "polish --distributed forks its own worker fleet; run it from one process, "
                "not under a multi-process launcher")
        from roko_tpu_torch.pipeline.distpolish import PoisonedUnit, run_distributed_polish
        from roko_tpu_torch.resilience import JournalMismatch

        try:
            run_distributed_polish(args.ref, args.X, args.model, args.out, cfg,
                                   seed=args.seed, resume=args.resume, device=args.device)
        except (PoisonedUnit, JournalMismatch) as e:
            print(f"polish: {e}", file=sys.stderr)
            return 1
        print(f"wrote polished contigs to {args.out}")
        if args.truth:
            _print_assess(args.out, args.truth)
        return 0
    device = resolve_device(args.device)
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
                            batch_size=cfg.train.batch_size, trace_dir=args.trace_dir, cfg=cfg)
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
    _configure_store(args.cfg)
    model = _model_on_mesh(args.cfg, args.model)
    polish_to_fasta(args.data, model, args.out, device=device,
                    batch_size=args.cfg.train.batch_size, trace_dir=args.trace_dir, cfg=args.cfg)
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
                        ("--compare", args.compare), ("--mesh-devices", args.mesh_devices),
                        ("--coldstart-ladder", args.coldstart_ladder),
                        ("--fleet-workers", args.fleet_workers),
                        ("--cascade-draft", args.cascade_draft),
                        ("--serve-mix", args.serve_mix)):
        if value is not None:
            argv += [flag, str(value)]
    return bench_main(argv)


def _workers_type(text: str):
    """``--workers``: a count, or ``auto`` (-1, one per visible card)."""
    if text.strip().lower() == "auto":
        return -1
    try:
        n = int(text)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an integer worker count or 'auto', got {text!r}") from None
    if n < 0:
        raise argparse.ArgumentTypeError("worker count must be >= 0 (use 'auto' for "
                                         "one per visible card)")
    return n


def _ab_lane_type(text: str):
    """``--ab-lane VERSION:FRACTION`` with the fraction in (0, 1]."""
    name, sep, frac = text.rpartition(":")
    if not sep or not name:
        raise argparse.ArgumentTypeError(f"expected VERSION:FRACTION, got {text!r}")
    try:
        fraction = float(frac)
    except ValueError:
        raise argparse.ArgumentTypeError(f"A/B fraction {frac!r} is not a number") from None
    if not 0.0 < fraction <= 1.0:
        raise argparse.ArgumentTypeError("A/B fraction must be in (0, 1]")
    return name, fraction


def _ladder_type(text: str):
    """``--ladder 32,128,512``: a clean usage error on a malformed list."""
    try:
        rungs = tuple(int(t) for t in text.split(","))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected comma-separated integers, got {text!r}") from None
    return rungs


def _tenants_type(text: str):
    """``--tenants name[:weight[:max_queue[:max_inflight]]],...`` into
    :class:`TenantConfig` rows (``roko_tpu/cli.py:773``)."""
    from roko_tpu_torch.config import TenantConfig

    out = []
    for spec in text.split(","):
        spec = spec.strip()
        if not spec:
            continue
        parts = spec.split(":")
        if len(parts) > 4:
            raise argparse.ArgumentTypeError(
                f"tenant spec {spec!r}: expected name[:weight[:max_queue[:max_inflight]]]")
        try:
            out.append(TenantConfig(
                name=parts[0],
                weight=float(parts[1]) if len(parts) > 1 else 1.0,
                max_queue=int(parts[2]) if len(parts) > 2 else 0,
                max_inflight=int(parts[3]) if len(parts) > 3 else 0,
            ))
        except ValueError as e:
            raise argparse.ArgumentTypeError(f"tenant spec {spec!r}: {e}") from None
    if not out:
        raise argparse.ArgumentTypeError("no tenant specs given")
    return tuple(out)


#: env var: a path prefix under which a serve process writes its kernel
#: launch counts (``<prefix>.<pid>.json``), so a harness can read what its
#: fleet workers launched
ENV_LAUNCHES = "ROKO_KERNEL_LAUNCHES"


class _LaunchReport:
    """The file ``<prefix>.<pid>.json`` of a serve process under
    :data:`ENV_LAUNCHES`: the kernel wrappers' launch counts, those at the
    end of the warmup, the process's rank and fleet worker id, the
    dispatches its session ran its rows of (the warmup's too), and (rank
    0) the requests, windows and batches served. Rank 0 rewrites it
    (atomically) at the warmup's end, after each answered ``/polish`` request before its reply
    goes out, and at exit, so a SIGKILLed worker's file still holds every
    request it answered; a follower rank at its warmup's end and at exit.
    In a file written at exit a rank's ``gru_fwd`` launches are its
    layers times its ``dispatches``."""

    def __init__(self, prefix: str, metrics=None, session=None):
        import os
        import threading

        self.path = f"{prefix}.{os.getpid()}.json"
        self.metrics = metrics
        self.session = session
        self.warmup: dict = {}
        self._lock = threading.Lock()

    def warm(self) -> None:
        from roko_tpu_torch.kernels import forward_launches

        self.warmup = forward_launches()
        self.write()

    def write(self) -> None:
        import json
        import os

        from roko_tpu_torch.kernels import forward_launches
        from roko_tpu_torch.parallel import distributed

        with self._lock:
            worker = os.environ.get("ROKO_WORKER_ID")
            report = {"pid": os.getpid(),
                      "model_version": os.environ.get("ROKO_MODEL_VERSION"),
                      "worker": None if worker is None else int(worker),
                      "rank": self.session.mesh.rank if self.session else 0,
                      "dispatches": self.session.dispatches if self.session else None,
                      "backend": distributed.backend(),
                      "launches": forward_launches(), "warmup_launches": self.warmup,
                      "served": {k: self.metrics.counters[k] if self.metrics else 0
                                 for k in ("requests", "windows", "batches")}}
            with open(self.path + ".tmp", "w") as f:
                json.dump(report, f)
            os.replace(self.path + ".tmp", self.path)


def cmd_serve(args: argparse.Namespace) -> int:
    """The polishing service (``roko_tpu/cli.py:966-1108``): load the
    model once, bind the socket, warm the batch ladder on a thread
    (``/healthz`` says ``warming`` and ``/polish`` sheds with 503
    meanwhile), print the ready line, and serve until SIGTERM drains it. A
    failed warmup (a kernel bundle that does not match included) stops the
    server and exits non-zero. Started as N processes under ``ROKO_*``,
    the session spans the ranks: rank 0 serves and sends the stop op after
    the last reply, the others follow (:func:`_serve_follower`); a broken
    session exits rank 0 non-zero. With ``--workers N`` (and no
    ``--worker-id``) this process is the fleet's supervisor instead
    (``serve/supervisor.py``, ``roko_tpu/cli.py:1006-1035``); with
    ``--federation`` the federation's front, which loads no model, and with
    ``--join`` (or ``--host-agent``) a supervisor that is a host agent of
    that front (``serve/federation.py``, ``roko_tpu/cli.py:992-1026``)."""
    import os
    import sys
    import threading
    import time

    from roko_tpu_torch.parallel import distributed

    cfg = args.cfg
    _configure_store(cfg)
    several = distributed.world_size() > 1
    if args.worker_id is not None:
        _configure_event_log(cfg.serve.event_log, cfg.serve.event_log_max_mb,
                             worker_id=args.worker_id, rank=distributed.rank())
        # a fleet worker's ranks end with the supervisor that started them
        _exit_with_parent()
    else:
        _configure_event_log(cfg.serve.event_log, cfg.serve.event_log_max_mb,
                             worker_id=distributed.rank() if several else None)
    if args.federation and args.worker_id is None:
        # the lease/epoch registry and cross-host router: no model, no card
        from roko_tpu_torch.serve.federation import run_federation_front

        return run_federation_front(cfg, announce=args.announce)
    if (args.host_agent or cfg.fleet.join) and args.worker_id is None:
        # a full supervisor that joins the federation front as a host
        from roko_tpu_torch.serve.federation import run_host_agent

        try:
            return run_host_agent(args.model, cfg, announce=args.announce, device=args.device)
        except ValueError as e:
            print(f"serve: {e}", file=sys.stderr)
            return 1
    if cfg.fleet.workers != 0 and args.worker_id is None:
        # the fleet's supervisor: it only routes, so it loads no model and
        # never initialises CUDA; --workers auto and an oversubscribing
        # slice are settled before anything spawns
        from roko_tpu_torch.parallel.mesh import resolve_fleet_topology
        from roko_tpu_torch.serve.supervisor import run_supervisor, worker_ranks

        try:
            cfg = dataclasses.replace(
                cfg, fleet=resolve_fleet_topology(cfg.fleet, backend=args.device))
            # each worker's k ranks must fit the grid, the model and the
            # ladder before anything spawns
            worker_ranks(cfg, args.device)
        except ValueError as e:
            print(f"serve: {e}", file=sys.stderr)
            return 1
        return run_supervisor(args.model, cfg, announce=args.announce, device=args.device)
    from roko_tpu_torch.infer import resolve_device
    from roko_tpu_torch.parallel.mesh import make_mesh
    from roko_tpu_torch.serve.metrics import ServeMetrics
    from roko_tpu_torch.serve.server import (
        BROKEN_EXIT_AFTER_S,
        drain,
        make_server,
        serve_forever,
        write_announce,
    )
    from roko_tpu_torch.serve.session import PolishSession

    # one session over the run's ranks (one rank without ROKO_*): rank 0
    # serves, the others follow its dispatches
    mesh = make_mesh(cfg.mesh)
    device = distributed.device_of_rank(resolve_device(args.device))
    model = _model_on_mesh(cfg, args.model, mesh)
    try:
        session = PolishSession(model, cfg, device=device, mesh=mesh)
    except ValueError as e:
        print(f"serve: {e}", file=sys.stderr)
        return 1
    report = (_LaunchReport(os.environ[ENV_LAUNCHES], session=session)
              if os.environ.get(ENV_LAUNCHES) else None)
    if not session.leader:
        return _serve_follower(session, report)
    metrics = ServeMetrics(latency_samples=cfg.serve.latency_samples)
    if report is not None:
        report.metrics = metrics
    server = make_server(session, cfg.serve, metrics=metrics, warming=True,
                         worker_id=args.worker_id,
                         on_polished=report.write if report is not None else None)

    def _broken(reason: str) -> None:
        # the group is out of step: answer /healthz "broken" a moment,
        # then drain and exit non-zero, never dispatch on it again
        print(f"serve: session broken ({reason}); exiting after {BROKEN_EXIT_AFTER_S:.0f}s",
              file=sys.stderr, flush=True)
        timer = threading.Timer(BROKEN_EXIT_AFTER_S, lambda: drain(server))
        timer.daemon = True
        timer.start()

    session.on_broken(_broken)
    if args.announce:
        # written after the bind and before the warmup, so whoever started
        # a --port 0 server can watch it warm
        write_announce(args.announce, server.server_address[1])
    per = tuple(r // session.dp for r in session.ladder)
    print(f"serve: mesh dp={session.dp} over {session.n_devices} device(s); warming predict "
          f"ladder {session.ladder} = {session.dp} x per-device {per} on {session.device} "
          f"({cfg.serve.batching} batching; healthz=warming, /polish sheds until ready) ...",
          flush=True)
    warm_error: list = []

    def _warm() -> None:
        try:
            t0 = time.perf_counter()
            # the kernel bundle (cfg.compile.bundle_dir) loads here, or
            # the kernels build: a mismatch fails the start loudly
            ready = session.warmup(log=print)
            dt = time.perf_counter() - t0
            server.metrics.warmup_seconds = dt  # type: ignore[attr-defined]
            if report is not None:
                report.warm()
            server._warming.clear()  # type: ignore[attr-defined]
            print(f"serve: {ready} executables ready in {dt:.1f}s "
                  f"({session.warmup_report.mode}); accepting requests", flush=True)
        except BaseException as e:
            # a half-warm service must die loudly, not sit at 503 forever
            import traceback

            traceback.print_exc(file=sys.stderr)
            warm_error.append(e)
            server.shutdown()

    threading.Thread(target=_warm, name="roko-serve-warmup", daemon=True).start()
    serve_forever(server)
    if report is not None:
        report.write()
    if session.broken is not None:
        _exit_out_of_step(f"serve: session broken: {session.broken}")
    # the followers' loop ends after the last reply
    session.stop()
    distributed.shutdown()
    if warm_error:
        raise SystemExit(f"serve: warmup failed: {warm_error[0]}")
    return 0


def _serve_follower(session, report=None) -> int:
    """A follower rank of ``serve``: build or load its kernels, then run
    its rows of every dispatch rank 0 sends until rank 0's stop (exit 0).
    A failure exits non-zero at once, so rank 0's next dispatch fails.
    ``report`` (a :class:`_LaunchReport`) is written after the warmup and
    at the stop."""
    from roko_tpu_torch.parallel import distributed

    m = session.mesh
    print(f"serve: rank {m.rank} of {session.n_devices} (dp={m.dp} tp={m.tp} sp={m.sp}) on "
          f"{session.device} follows rank 0's dispatches", flush=True)
    try:
        session.warmup(log=print)
        if report is not None:
            report.warm()
        served = session.follow()
    except BaseException:
        import traceback

        traceback.print_exc()
        _exit_out_of_step(f"serve: rank {m.rank} failed; its group is out of step")
    if report is not None:
        report.write()
    print(f"serve: rank {m.rank} followed {served} dispatch(es); stopped by rank 0", flush=True)
    distributed.shutdown()
    return 0


#: seconds between a fleet worker rank's looks at its parent
PARENT_POLL_S = 0.5


def _exit_with_parent() -> None:
    """End this process (exit 1) once the process that started it is
    gone: a fleet worker rank whose supervisor was killed outright leaves
    nothing behind. A thread looks at the parent's pid every
    :data:`PARENT_POLL_S`; an orphan is adopted by another process."""
    import os
    import threading
    import time

    parent = os.getppid()

    def watch() -> None:
        while os.getppid() == parent:
            time.sleep(PARENT_POLL_S)
        _exit_out_of_step(f"serve: the fleet's supervisor (pid {parent}) is gone; "
                          "this worker rank exits")

    threading.Thread(target=watch, name="roko-serve-parent", daemon=True).start()


def _exit_out_of_step(message: str) -> None:
    """Exit 1 now: a collective of this process may still be in flight,
    and leaving its process group could wait on it."""
    import os
    import sys

    print(message, file=sys.stderr, flush=True)
    sys.stdout.flush()
    os._exit(1)


def cmd_compile(args: argparse.Namespace) -> int:
    """Write a kernel bundle (``compile/bundle.py``,
    ``roko_tpu/cli.py:842-964``): the libraries the model's kind and dtype
    launch, built and copied in, every ladder rung (and ``--b``) run once,
    and the manifest with the identity digest. Unless ``--no-verify``, a
    fresh process then loads the bundle with the build cache off and runs
    every rung; a failure removes the manifest, so the bundle never looks
    loadable. ``--register NAME`` then pins it (and ``--params``) in the
    model registry. No checkpoint is needed: the kernels depend on the
    config only."""
    import os
    import subprocess
    import sys
    import tempfile

    from roko_tpu_torch.compile import BUNDLE_MANIFEST, export_bundle
    from roko_tpu_torch.config import resolve_ladder
    from roko_tpu_torch.parallel import distributed
    from roko_tpu_torch.parallel.mesh import make_mesh

    cfg = args.cfg
    # the ladder denominates against the run's grid (the auto default is
    # the per-rank base rungs x dp), so --b joins the global rungs a
    # session on this grid asks for
    mesh = make_mesh(cfg.mesh)
    try:
        rungs = set(args.ladder or resolve_ladder(cfg.serve, mesh.dp))
        if args.b:
            rungs.add(args.b)  # inference/polish dispatch at --b too
        manifest = export_bundle(args.out, cfg, mesh=mesh, ladder=sorted(rungs),
                                 device=args.device)
    except ValueError as e:
        print(f"compile: {e}", file=sys.stderr)
        return 1
    if manifest is None:  # a follower rank: rank 0 wrote the bundle
        distributed.shutdown()
        return 0
    ident = manifest["identity"]
    model = ident["model"]
    print(f"compile: wrote bundle {args.out} (kind {model['kind']}, compute_dtype="
          f"{model['compute_dtype']}, quantize={model['quantize'] or 'none'}, "
          f"mesh=dp{ident['mesh']['dp']}xtp{ident['mesh']['tp']}xsp{ident['mesh']['sp']}, "
          f"{ident['backend']} {ident['device_kind']}, libraries "
          f"{sorted(manifest['libraries'])}, rungs {manifest['rungs']}, "
          f"digest {manifest['digest'][:12]})")
    if not args.no_verify:
        with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
            f.write(cfg.to_json())
            cfg_path = f.name
        budget = cfg.resilience.compile_deadline_s or None
        try:
            env = dict(os.environ, ROKO_COMPILE_CACHE="off")
            r = subprocess.run(
                [sys.executable, "-c", "import sys; from roko_tpu_torch.compile.bundle import "
                 "verify_main; verify_main(*sys.argv[1:])", args.out, cfg_path, args.device],
                capture_output=True, text=True, env=env, timeout=budget)
            failure = (r.stderr or r.stdout) if r.returncode != 0 else None
        except subprocess.TimeoutExpired:
            failure = f"verification timed out after {budget:.0f}s"
        finally:
            os.unlink(cfg_path)
        if failure is not None:
            print("compile: bundle FAILED fresh-process verification — refusing to leave it "
                  "loadable:\n" + failure, file=sys.stderr)
            os.unlink(os.path.join(args.out, BUNDLE_MANIFEST))
            return 1
        print(f"compile: {r.stdout.strip().splitlines()[-1]} (fresh process)")
    if args.register:
        # after the check: the registry never names a bundle that has not
        # loaded in a fresh process
        from roko_tpu_torch.serve.registry import (
            RegistryError,
            register_model,
            resolve_registry_dir,
        )

        try:
            register_model(resolve_registry_dir(args.registry or cfg.fleet.registry_dir),
                           args.register, args.out, params_path=args.params, force=args.force)
        except RegistryError as e:
            print(f"compile: registration refused — {e}", file=sys.stderr)
            return 1
    return 0


def cmd_rollout(args: argparse.Namespace) -> int:
    """Drive a running fleet supervisor onto a registered model version
    (``roko_tpu/cli.py:1112-1227``): ``POST /rollout``, then poll ``GET
    /rollout`` printing each state change until the rollout lands (0) or
    rolls back or fails (1). The supervisor does the work, one worker at a
    time, so this command is safe to interrupt and re-run."""
    import json
    import sys
    import time
    import urllib.error
    import urllib.request

    url = args.url.rstrip("/")
    payload = {"name": args.name}
    for key, val in (("bake_s", args.bake_s), ("rollback_error_pct", args.rollback_error_pct),
                     ("rollback_p99_x", args.rollback_p99_x)):
        if val is not None:
            payload[key] = val
    req = urllib.request.Request(url + "/rollout", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        # generous: the supervisor re-hashes the registered version first
        with urllib.request.urlopen(req, timeout=300) as r:
            status = json.loads(r.read())
    except urllib.error.HTTPError as e:
        body = e.read()
        try:
            msg = json.loads(body).get("error", "")
        except ValueError:
            msg = body[:200].decode(errors="replace")
        print(f"rollout: refused (HTTP {e.code}): {msg}", file=sys.stderr)
        return 1
    except TimeoutError:
        print(f"rollout: the supervisor at {url} did not answer the submission within 300s; "
              f"observe with `python -m {_MODULE} rollout {args.name} --url {url}`",
              file=sys.stderr)
        return 1
    except OSError as e:
        print(f"rollout: no supervisor at {url} ({e}); start one with "
              f"`python -m {_MODULE} serve CKPT --workers N`", file=sys.stderr)
        return 1
    print(f"rollout: {status['from_version']} -> {status['to_version']} accepted "
          f"(bake {status['bake_s']:g}s, workers {status['workers']})", flush=True)
    if args.no_wait:
        return 0
    deadline = time.monotonic() + args.timeout
    last = None
    while time.monotonic() < deadline:
        time.sleep(args.poll_s)
        try:
            with urllib.request.urlopen(url + "/rollout", timeout=30) as r:
                status = json.loads(r.read())
        except (OSError, ValueError):
            continue  # a transient scrape failure; the supervisor journals
        snap = (status.get("state"), tuple(status.get("workers_done", [])))
        if snap != last:
            last = snap
            reason = status.get("reason")
            print(f"rollout: state={status.get('state')} done={status.get('workers_done')} "
                  f"versions={status.get('worker_versions')}"
                  + (f" reason={reason!r}" if reason else ""), flush=True)
        if status.get("state") == "done":
            print(f"rollout: complete — fleet on {status['to_version']}")
            return 0
        if status.get("state") == "idle":
            # a supervisor restarted mid-watch reports idle even when its
            # recovery finalized the rollout: ask what the fleet runs
            try:
                with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
                    live = json.loads(r.read()).get("version")
            except (OSError, ValueError):
                live = None
            if live == args.name:
                print(f"rollout: complete — fleet on {args.name} (finalized across a "
                      "supervisor restart)")
                return 0
        if status.get("state") in ("rolled_back", "failed", "idle"):
            print(f"rollout: NOT applied (state={status.get('state')}"
                  + (f", reason={status.get('reason')!r})" if status.get("reason") else ")"),
                  file=sys.stderr)
            return 1
    print(f"rollout: still {status.get('state')!r} after {args.timeout:g}s of watching; the "
          f"supervisor keeps going — re-observe with `python -m {_MODULE} rollout "
          f"{args.name} --url {url}`", file=sys.stderr)
    return 1


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

    def event_log(p: argparse.ArgumentParser) -> None:
        p.add_argument("--event-log", default=None, metavar="PATH",
                       help="append every ROKO_* event as one JSON record to this JSONL file "
                       "(rotated to PATH.1 past --event-log-max-mb); the stderr lines stay")
        p.add_argument("--event-log-max-mb", type=float, default=None,
                       help="event-log rotation cap in MiB (default 64)")

    def compile_flags(p: argparse.ArgumentParser) -> None:
        p.add_argument("--compile-cache", default=None, metavar="DIR",
                       help="kernel build cache directory (default build/roko_tpu_torch/ "
                       "beside the package; env ROKO_COMPILE_CACHE overrides, and "
                       "ROKO_COMPILE_CACHE=off turns it off)")
        p.add_argument("--no-compile-cache", action="store_true", default=None,
                       help="build every kernel into a fresh directory of this process "
                       "(each start runs nvcc)")
        p.add_argument("--bundle", default=None, metavar="DIR",
                       help="kernel bundle (written by `compile`) whose libraries load "
                       "instead of being built; one that does not match the model or the "
                       "card is refused, never rebuilt")

    def cascade(p: argparse.ArgumentParser) -> None:
        """The cascade's knobs (``cascade/``, ``roko_tpu/cli.py:252-290``)."""
        p.add_argument(
            "--cascade", nargs="?", const=-1.0, type=float, default=None, metavar="THRESHOLD",
            help="enable the confidence cascade: a cheap tier first, only uncertain windows "
            "escalate to the model. The optional value sets the threshold in [0, 1] (0 "
            "escalates every window: the plain path's output; 1 none); bare --cascade keeps "
            "the config's (default 0.05)")
        p.add_argument("--cascade-tier", choices=("majority", "model"), default=None,
                       help="tier 1: 'majority' (the pileup majority vote, on the host) or "
                       "'model' (a registered version, on --device; needs --cascade-version)")
        p.add_argument("--cascade-version", default=None, metavar="NAME",
                       help="registry version of --cascade-tier model (digest-verified)")
        p.add_argument("--cascade-method", choices=("max_softmax", "margin"), default=None,
                       help="calibrated confidence function (default max_softmax)")
        p.add_argument("--cascade-calibration", default=None, metavar="PATH",
                       help="temperature-scaling artifact JSON (refuses another model's "
                       "params digest)")
        p.add_argument("--cascade-cache-bytes", type=int, default=None, metavar="N",
                       help="in-memory window-cache byte cap (0 turns it off; default 64 MiB)")
        p.add_argument("--cascade-cache-dir", default=None, metavar="DIR",
                       help="shared on-disk window cache (identity pinned by its meta.json; "
                       "a distributed polish's workers share one)")

    def store(p: argparse.ArgumentParser) -> None:
        """The object-store client's flags (``datapipe/store.py``,
        ``roko_tpu/cli.py:233-250``); retries, the hedge and the breaker
        are the config's ``store`` section and ``ROKO_STORE_*``."""
        p.add_argument("--store-cache", default=None, metavar="DIR",
                       help="on-disk checksummed block cache of gs:// / s3:// / http(s):// "
                       "reads (sha256-verified entries, identity-pinned, bounded; default: "
                       "none); processes of one host may share it")
        p.add_argument("--store-endpoint", default=None, metavar="URL",
                       help="HTTP(S) gateway prefix that gs://bucket/key and s3://bucket/key "
                       "resolve against (e.g. http://127.0.0.1:9000); without it those "
                       "schemes refuse loudly")

    def extraction(p: argparse.ArgumentParser) -> None:
        p.add_argument("--t", type=int, default=1, help="feature workers")
        p.add_argument("--seed", type=int, default=0, help="row-sampling RNG seed")
        p.add_argument("--job-retries", type=int, default=1,
                       help="in-parent retries for a region job that raised")
        p.add_argument(
            "--job-timeout", type=float, default=None,
            help="seconds to wait per region result before assuming the worker "
            "died and finishing the rest in the parent (process pools only)")
        geometry(p)

    def geometry(p: argparse.ArgumentParser) -> None:
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
    store(p)
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
    event_log(p)
    store(p)
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
    compile_flags(p)
    cascade(p)
    store(p)
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
    p.add_argument("--distributed", action="store_true",
                   help="shard the job over a forked worker fleet (--workers, default 2): a "
                   "commit or retry per unit through the resume journal; a SIGKILLed worker "
                   "costs one unit's re-run and the FASTA is the single process's byte for "
                   "byte; GET /jobz on the printed front-end port shows each unit's state")
    p.add_argument("--workers", type=_workers_type, default=None,
                   help="with --distributed: fleet worker processes ('auto' = visible cards / "
                   "--devices-per-worker; default 2)")
    p.add_argument("--devices-per-worker", type=int, default=None,
                   help="with --distributed: cards each worker sees, one rank of the "
                   "worker's session a card (default 0: the workers share the cards, each "
                   "a session over the --dp/--tp/--sp grid, or over every visible card)")
    p.add_argument("--unit-bases", type=int, default=None,
                   help="with --distributed: split contigs longer than this into "
                   "region-aligned span units, stitched by the coordinator (default 1000000; "
                   "0 = whole contigs only)")
    p.add_argument("--unit-attempts", type=int, default=None,
                   help="with --distributed: attempts of a unit on distinct workers before "
                   "its contig is quarantined and the job fails naming it (default 3)")
    extraction(p)
    common(p)
    mesh(p)
    config(p, "the inference (streaming: the whole run)")
    compile_flags(p)
    cascade(p)
    event_log(p)
    store(p)
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

    from roko_tpu_torch.benchmark import (
        add_cascade_flag,
        add_fleet_flags,
        add_mesh_flag,
        add_serve_mix_flag,
        add_unported_flags,
    )

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
    add_fleet_flags(p)
    add_cascade_flag(p)
    add_unported_flags(p)
    add_serve_mix_flag(p)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser(
        "serve", help="persistent polishing service: warm model + batched HTTP /polish "
        "(+ /healthz, /metrics, /tracez, /profilez)")
    p.add_argument("model", nargs="?", default=None,
                   help="checkpoint directory of `train`, or a reference-layout torch .pth "
                   "state_dict (required except under --federation, which loads no model)")
    p.add_argument("--host", default=None, help="bind address (default 127.0.0.1)")
    p.add_argument("--port", type=int, default=None,
                   help="bind port (default 8000; 0 = ephemeral, see --announce)")
    p.add_argument("--ladder", type=_ladder_type, default=None,
                   help="comma-separated global padded batch sizes the session warms, "
                   "multiples of dp (default 32,128,512 x dp)")
    p.add_argument("--max-queue", type=int, default=None,
                   help="bounded request pool (full -> 503 + Retry-After; default 64)")
    p.add_argument("--max-delay-ms", type=float, default=None,
                   help="deadline batching: a partial batch waits at most this long after "
                   "its first request (default 25)")
    p.add_argument("--batching", choices=("continuous", "deadline", "ragged"), default=None,
                   help="batching policy (default continuous): 'continuous' packs windows "
                   "of many requests densely into ladder-rung steps; 'deadline' coalesces "
                   "whole requests; 'ragged' packs as continuous but runs every step at the "
                   "top rung with its valid-row count")
    p.add_argument("--max-queue-age-ms", type=float, default=None,
                   help="continuous and ragged: the oldest queued window waits at most this "
                   "long before a partial batch dispatches (default 25)")
    p.add_argument("--rung-upgrade-fill", type=float, default=None,
                   help="continuous: pad up to the next-larger rung only when the pending "
                   "windows fill at least this share of it (default 0.75)")
    p.add_argument("--data-root", default=None,
                   help="confine the ref+bam form of /polish to files under this directory")
    p.add_argument("--trace-ring", type=int, default=None,
                   help="GET /tracez retention: request traces kept (default 256)")
    p.add_argument("--tenants", type=_tenants_type, default=None,
                   metavar="NAME[:W[:Q[:I]]],...",
                   help="tenant fair share: name[:weight[:max_queue[:max_inflight]]] specs; "
                   "requests carry X-Roko-Tenant, slots grant by deficit-weighted round-robin, "
                   "and a tenant past its quota gets 429 + Retry-After")
    p.add_argument("--announce", default=None, metavar="FILE",
                   help="write {\"pid\", \"port\"} of the bound socket here (atomic rename)")
    for flag, kind, text in (
        ("--predict-deadline", float, "watchdog: seconds one device predict may take "
         "(default 600; 0 disables)"),
        ("--compile-deadline", float, "watchdog: seconds the first dispatch of each batch "
         "shape may take, kernel build included (default 1800; 0 disables)"),
        ("--breaker-failures", int, "circuit breaker: consecutive device failures that trip "
         "it (default 5; 0 disables)"),
        ("--breaker-reset-s", float, "circuit breaker: seconds open before half-open "
         "probing (default 30)"),
        ("--drain-deadline", float, "SIGTERM drain: seconds in-flight requests get to "
         "finish (default 20)"),
    ):
        p.add_argument(flag, type=kind, default=None, help=text)
    p.add_argument("--workers", type=_workers_type, default=None,
                   help="fleet mode: start this many worker serve processes behind a "
                   "supervising front end that restarts crashed or hung workers and fails "
                   "requests over (default 0: one process; 'auto': one per visible card "
                   "over --devices-per-worker)")
    p.add_argument("--devices-per-worker", type=int, default=None,
                   help="fleet mode: cards each worker sees through CUDA_VISIBLE_DEVICES; a "
                   "worker of k cards is one session over k serve ranks the supervisor starts "
                   "and restarts together (default 0: the workers share the cards, each a "
                   "session over the --dp/--tp/--sp grid, or over every visible card)")
    p.add_argument("--heartbeat-interval", type=float, default=None,
                   help="fleet mode: seconds between the supervisor's /healthz probes of "
                   "each worker (default 2)")
    p.add_argument("--registry", default=None, metavar="DIR",
                   help="fleet mode: the model registry rollouts resolve names in (default "
                   "build/roko_tpu_torch_registry; env ROKO_REGISTRY overrides)")
    p.add_argument("--bake-s", type=float, default=None,
                   help="fleet mode: seconds each rolled worker must stay healthy before the "
                   "next is touched; the canary gate is judged over it (default 15)")
    p.add_argument("--rollback-error-pct", type=float, default=None,
                   help="fleet mode: canary error %% past this (and past the incumbent's) "
                   "rolls the fleet back (default 2)")
    p.add_argument("--rollback-p99-x", type=float, default=None,
                   help="fleet mode: canary p99 past this multiple of the incumbent's rolls "
                   "back (default 3)")
    p.add_argument("--min-workers", type=int, default=None,
                   help="fleet mode: autoscaler floor (default 0 = --workers)")
    p.add_argument("--max-workers", type=int, default=None,
                   help="fleet mode: autoscaler ceiling (default 0 = --workers)")
    p.add_argument("--ab-lane", type=_ab_lane_type, default=None, metavar="VERSION:FRACTION",
                   help="fleet mode: route this share of unpinned traffic to workers "
                   "running the named registered version")
    p.add_argument("--worker-id", type=int, default=None, help=argparse.SUPPRESS)
    compile_flags(p)
    cascade(p)
    p.add_argument("--federation", action="store_true",
                   help="run the multi-host federation's FRONT END instead of a fleet: a "
                   "lease/epoch registry of the host agents that --join it and a "
                   "partition-tolerant router over them (loads no model)")
    p.add_argument("--host-agent", action="store_true",
                   help="run this fleet as a federation HOST AGENT: a full supervisor that "
                   "also registers with the front named by --join and keeps its lease alive "
                   "(implied by --join)")
    p.add_argument("--join", default=None, metavar="HOST:PORT",
                   help="the federation front a host agent registers with; the registration "
                   "is a TTL lease, and registering again bumps this host's fencing epoch")
    p.add_argument("--host-id", default=None,
                   help="stable host identity at the federation registry (default "
                   "host-<pid>; set it so that a restarted agent bumps the SAME host's epoch)")
    p.add_argument("--lease-ttl", type=float, default=None,
                   help="federation lease TTL seconds (default 10; the agent renews every "
                   "ttl/3, and expiry takes the host out of rotation)")
    common(p)
    mesh(p)
    geometry(p)
    config(p)
    event_log(p)
    store(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "compile", help="write a kernel bundle: the libraries the model launches, with the "
        "identity they were built for (load with serve/polish/inference --bundle)")
    p.add_argument("out", help="bundle output directory")
    p.add_argument("--ladder", type=_ladder_type, default=None,
                   help="comma-separated batch sizes to run once (default the serve ladder "
                   "32,128,512)")
    p.add_argument("--b", type=int, default=None,
                   help="also run this batch size (inference/polish's steady-state batch)")
    p.add_argument("--no-verify", action="store_true",
                   help="skip the fresh-process load and run of the written bundle")
    p.add_argument("--register", default=None, metavar="NAME",
                   help="after the check, register the bundle in the model registry under "
                   "this version name (the target of `rollout NAME`)")
    p.add_argument("--params", default=None, metavar="CKPT",
                   help="with --register: pin this checkpoint's bytes (sha256 a file) into "
                   "the version; omitted: the version rolls out on the fleet's checkpoint")
    p.add_argument("--registry", default=None, metavar="DIR",
                   help="model registry directory (default build/roko_tpu_torch_registry; "
                   "env ROKO_REGISTRY overrides)")
    p.add_argument("--force", action="store_true",
                   help="with --register: overwrite a name registered with another identity")
    common(p)
    mesh(p)
    geometry(p)
    config(p)
    p.set_defaults(fn=cmd_compile)

    p = sub.add_parser(
        "rollout", help="roll a running fleet supervisor onto a registered model version, "
        "one worker at a time, with a canary gate and automatic rollback")
    p.add_argument("name", help="registered model version name")
    p.add_argument("--url", default="http://127.0.0.1:8000",
                   help="fleet supervisor base URL (default http://127.0.0.1:8000)")
    p.add_argument("--bake-s", type=float, default=None,
                   help="this rollout's healthy stretch a worker")
    p.add_argument("--rollback-error-pct", type=float, default=None,
                   help="this rollout's canary error-rate threshold (%%)")
    p.add_argument("--rollback-p99-x", type=float, default=None,
                   help="this rollout's canary p99 multiple threshold")
    p.add_argument("--no-wait", action="store_true",
                   help="submit and exit 0 at once instead of watching the rollout")
    p.add_argument("--timeout", type=float, default=3600.0,
                   help="seconds to watch before giving up (default 3600)")
    p.add_argument("--poll-s", type=float, default=1.0, help=argparse.SUPPRESS)
    p.set_defaults(fn=cmd_rollout)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "bench":
        from roko_tpu_torch.benchmark import unported_flag

        msg = unported_flag(args)
        if msg:
            parser.error(msg)
    if args.command == "serve" and args.worker_id is None:
        from roko_tpu_torch.parallel import distributed

        if distributed.planned_processes() > 1:
            for flag, on in (("--workers", args.workers not in (None, 0)),
                             ("--federation", args.federation),
                             ("--host-agent", args.host_agent), ("--join", args.join)):
                if on:
                    parser.error(f"serve {flag} runs a process tree of its own; run it from "
                                 "one process, not under a multi-process launcher")
    if args.command == "polish":
        if args.distributed and (args.staged or args.keep_hdf5):
            parser.error("polish --distributed drives the fleet workers' own streaming stacks; "
                         "it cannot combine with --staged or --keep-hdf5")
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
    if args.command == "serve" and args.worker_id is None:
        # the reference's usage errors of serve (roko_tpu/cli.py:999-1025)
        if args.model is None and not args.federation:
            parser.error("serve: MODEL is required (only --federation runs model-less)")
        if not args.federation and (args.host_agent or args.cfg.fleet.join):
            if not args.cfg.fleet.join:
                parser.error("serve: --host-agent needs the front end as --join HOST:PORT")
            if args.cfg.fleet.workers == 0:
                parser.error("serve: a host agent supervises workers — pass --workers N "
                             "(N >= 1 or -1 for auto)")
    if hasattr(args, "dp") and not _launches_workers(args):  # the subcommands on the mesh
        _check_mesh(parser, args)
    return args.fn(args)


def _launches_workers(args: argparse.Namespace) -> bool:
    """True for a process that starts workers and joins no grid itself:
    the fleet's supervisor, a host agent, the federation's front and the
    distributed polish's coordinator. Its ``--dp/--tp/--sp`` are its
    workers' grid (``serve/supervisor.py`` checks it before they spawn)."""
    if args.command == "polish":
        return bool(args.distributed)
    if args.command != "serve" or args.worker_id is not None:
        return False
    fc = args.cfg.fleet
    return bool(fc.workers != 0 or fc.join or args.federation or args.host_agent)


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
                     "ROKO_PROCESS_ID for a dp x tp x sp grid of N (serve --workers starts "
                     "a worker's ranks so itself)")
    try:
        check_divisible(args.cfg.model, tp, sp)
    except ValueError as e:
        parser.error(f"mesh tp={tp} sp={sp}: {e}")


def _model_on_mesh(cfg: RokoConfig, model_arg: str, mesh=None):
    """The model of ``cfg`` on the run's grid (``mesh``, default
    ``cfg.mesh`` over the run's processes), its parameters (a full
    state_dict: a checkpoint directory or a reference ``.pth``) cut to
    this rank's part."""
    from roko_tpu_torch.models.model import RokoModel
    from roko_tpu_torch.parallel.mesh import make_mesh
    from roko_tpu_torch.parallel.tp import shard_state_dict

    mesh = mesh or make_mesh(cfg.mesh)
    model = RokoModel(cfg.model, mesh=mesh)
    model.load_state_dict(shard_state_dict(cfg.model, _load_model_params(model_arg), mesh),
                          strict=True)
    return model
