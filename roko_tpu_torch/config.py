"""Configuration of the port: the fields of ``roko_tpu.config`` that the
feature extractor, the inference and training paths, the data plane, the
streaming polish and the polishing service read, with the same names and
defaults (``WindowConfig``, ``ReadFilterConfig``, ``RegionConfig``,
``ModelConfig``, ``TrainConfig``, ``DataConfig``, ``MeshConfig``,
``GuardConfig``, ``ServeConfig``, ``TenantConfig``, ``DEFAULT_TENANT``,
``BATCHING_MODES``, ``PipelineConfig``, ``ResilienceConfig``,
``CompileConfig``, ``FleetConfig``,
``resolve_ladder``, ``validate_ladder``, ``COMPUTE_DTYPES``,
``QUANTIZE_MODES`` and ``default_compute_dtype``). ``FeaturesConfig`` holds
the three sections of ``roko_tpu.config.RokoConfig`` that feature
extraction reads; ``RokoConfig`` adds the sections the port runs, with
the reference's JSON layout (``to_json`` / ``from_json``): a file that
``roko_tpu``'s ``RokoConfig.to_json`` wrote loads here, and one written
here loads there."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

from roko_tpu_torch import constants as C


@dataclass(frozen=True)
class WindowConfig:
    """Pileup window geometry (``roko_tpu/config.py:24-36``)."""

    rows: int = C.WINDOW_ROWS
    cols: int = C.WINDOW_COLS
    stride: int = C.WINDOW_STRIDE
    max_ins: int = C.MAX_INS
    #: the first ref_rows rows carry the draft base per column (GAP at
    #: insertion slots, forward strand)
    ref_rows: int = C.REF_ROWS


@dataclass(frozen=True)
class ReadFilterConfig:
    """Which reads enter the pileup (``roko_tpu/config.py:39-46``)."""

    min_mapq: int = C.MIN_MAPQ
    filter_flag: int = C.FILTER_FLAG
    #: paired reads must also be proper pairs
    require_proper_pair: bool = True


@dataclass(frozen=True)
class RegionConfig:
    """Contig -> region fan-out (``roko_tpu/config.py:49-53``)."""

    size: int = C.REGION_SIZE
    overlap: int = C.REGION_OVERLAP


@dataclass(frozen=True)
class FeaturesConfig:
    """What feature extraction reads of ``roko_tpu.config.RokoConfig``."""

    window: WindowConfig = field(default_factory=WindowConfig)
    read_filter: ReadFilterConfig = field(default_factory=ReadFilterConfig)
    region: RegionConfig = field(default_factory=RegionConfig)


#: the values of ``ModelConfig.kind`` the port runs
PORTED_KINDS = ("gru", "lingru", "transformer")

#: valid ``ModelConfig.compute_dtype`` values (``roko_tpu/config.py:60-66``):
#: the width of the matrix products and of the recurrences' loads and
#: stores; parameters are stored float32. "auto" resolves through
#: :func:`default_compute_dtype`.
COMPUTE_DTYPES = ("auto", "float32", "bfloat16")

#: valid ``ModelConfig.quantize`` values besides None (off): "int8" is
#: weight-only quantization of the dense and recurrent matrices with
#: per-output-channel float32 scales, applied when a model is loaded for
#: inference (``models/quant.py``)
QUANTIZE_MODES = ("int8",)


def default_compute_dtype(backend: Optional[str] = None) -> str:
    """The dtype ``compute_dtype="auto"`` resolves to on ``backend``: the
    JAX package's policy (``roko_tpu/config.py:78-88``), bfloat16 on a TPU
    and float32 everywhere else. The port runs on ``"cuda"`` or ``"cpu"``
    (None stands for either), so it resolves to float32."""
    return "bfloat16" if backend == "tpu" else "float32"


@dataclass(frozen=True)
class ModelConfig:
    kind: str = "gru"
    embed_vocab: int = C.FEATURE_VOCAB
    window_rows: int = C.WINDOW_ROWS
    window_cols: int = C.WINDOW_COLS
    embed_dim: int = 50
    read_mlp: Tuple[int, ...] = (100, 10)
    hidden_size: int = 128
    num_layers: int = 3
    #: inverted dropout after the embedding, fc1 and fc2 and between
    #: recurrent layers, in training only
    dropout: float = 0.2
    num_classes: int = C.NUM_CLASSES
    #: ``kind="transformer"`` only: the encoder's width (2 x hidden_size,
    #: so the head is shared), its attention heads and its MLP's widening
    d_model: int = 256
    num_heads: int = 8
    mlp_ratio: int = 4
    #: one of COMPUTE_DTYPES; "auto" resolves per backend (:meth:`resolve`)
    compute_dtype: str = "auto"
    #: one of QUANTIZE_MODES or None; conversion-time only: training
    #: refuses it, inference quantizes the float32 weights at load
    quantize: Optional[str] = None

    def __post_init__(self) -> None:
        if self.quantize is not None and self.kind == "transformer":
            raise ValueError(
                "quantize covers the gru/lingru consensus models (their "
                "dense/recurrence matmul kernels); the transformer "
                "variant has no int8 weight path"
            )
        if self.kind not in PORTED_KINDS:
            raise ValueError(
                f"unknown model kind {self.kind!r}; expected one of "
                + "|".join(PORTED_KINDS)
            )
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {self.dropout}")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"unknown compute_dtype {self.compute_dtype!r}; expected "
                "one of " + "|".join(COMPUTE_DTYPES)
            )
        if self.quantize is not None and self.quantize not in QUANTIZE_MODES:
            raise ValueError(
                f"unknown quantize mode {self.quantize!r}; expected one "
                "of " + "|".join(QUANTIZE_MODES) + " (or null/absent)"
            )

    def resolve(self, backend: Optional[str] = None) -> "ModelConfig":
        """This config with ``compute_dtype="auto"`` replaced by
        :func:`default_compute_dtype` of ``backend`` (itself when the
        dtype is already concrete). The model resolves its config here."""
        if self.compute_dtype != "auto":
            return self
        return dataclasses.replace(self, compute_dtype=default_compute_dtype(backend))

    @property
    def gru_in_size(self) -> int:
        return self.embed_dim * self.read_mlp[-1]


@dataclass(frozen=True)
class TrainConfig:
    """Optimisation hyperparameters (``roko_tpu/config.py:191-219``)."""

    batch_size: int = 128
    epochs: int = 100
    lr: float = 1e-4
    #: epochs without a better val accuracy before the run stops
    patience: int = 7
    #: seeds the init, the epoch shuffles, the holdout and dropout
    seed: int = 0
    #: hold the corpus in host memory (``--memory``, the default); False
    #: streams it from the HDF5 files span by span (``--no-memory``)
    in_memory: bool = True
    #: with no val set, hold out this fraction of the training windows
    #: (seeded split); 0 = no split, and then no early stopping
    val_fraction: float = 0.0
    #: best checkpoints kept by val accuracy, beside ``latest``
    keep_checkpoints: int = 3
    #: batches a producer thread stages on the device ahead of the step
    prefetch: int = 2
    #: in-epoch heartbeat every N steps (0 disables)
    log_every_steps: int = 200


@dataclass(frozen=True)
class DataConfig:
    """The sharded data plane (``roko_tpu/config.py:223-257``): shards that
    partition the global shuffled stream, block and mix sizes, readahead,
    and the manifest."""

    #: data shards the corpus splits into; 0 = auto (one: one process)
    shards: int = 0
    #: this process's shard; -1 = auto (0 in one process)
    shard_id: int = -1
    #: seed of the epoch shuffles; -1 = ``TrainConfig.seed``
    seed: int = -1
    #: rows of a span block: the unit the shuffle permutes and fast-forward skips
    block_size: int = 256
    #: blocks whose rows one mix group permutes together
    mix_blocks: int = 8
    #: mix groups a reader thread keeps decoded ahead of batching (a
    #: streamed corpus; device staging is ``TrainConfig.prefetch``)
    input_prefetch: int = 2
    #: pinned manifest; None = the sidecar beside the corpus (a stale one is
    #: rebuilt, a pinned one that mismatches the files is refused)
    manifest: Optional[str] = None


@dataclass(frozen=True)
class MeshConfig:
    """The process mesh (``roko_tpu/config.py:259-265``), a dp x tp x sp
    grid of the run's processes, one per card: dp shards the batch, tp the
    transformer's heads and MLP units, sp its pileup columns
    (``parallel/``)."""

    dp: int = -1  # -1 = all remaining processes
    tp: int = 1
    sp: int = 1


@dataclass(frozen=True)
class GuardConfig:
    """NaN/loss-spike sentinel (``roko_tpu/config.py:780-815``), on by
    default: a bad step's update is skipped, and ``max_bad_steps`` bad
    steps in a row roll the run back to its last good checkpoint."""

    enabled: bool = True
    #: a loss this many EMA standard deviations above the loss EMA is a spike
    spike_sigma: float = 6.0
    #: decay of the loss EMA and of its variance EMA
    ema_beta: float = 0.98
    #: good steps before spike detection arms (non-finite is armed at once)
    warmup_steps: int = 20
    #: consecutive skipped steps that trigger a rollback
    max_bad_steps: int = 3
    #: rollbacks after which the run gives up
    max_rollbacks: int = 3
    #: also save ``latest`` every N steps inside an epoch, with the data
    #: position, so a resume continues at the next batch; 0 = epoch
    #: boundaries only
    save_every_steps: int = 0
    #: JSONL event sink of the guard's events (``obs/events.py``); None =
    #: stderr lines only
    event_log: Optional[str] = None
    event_log_max_mb: float = 64.0


#: tenant id every request without an ``X-Roko-Tenant`` header (or a
#: client ``tenant=``) is accounted under; with one tenant the deficit
#: round-robin reduces to arrival order
DEFAULT_TENANT = "default"


@dataclass(frozen=True)
class TenantConfig:
    """One row of the tenant fair-share table (``roko_tpu/config.py:275-
    323``): an admission weight plus optional per-tenant caps. Unlisted
    tenants get ``weight=1`` and no caps."""

    name: str
    #: deficit-round-robin weight: each scheduler round grants a tenant
    #: ``weight`` x the base share of device-slot windows
    weight: float = 1.0
    #: queued windows this tenant may hold in the batcher pool; beyond it
    #: submissions get 429 + Retry-After (0 = no cap)
    max_queue: int = 0
    #: concurrent in-flight REQUESTS for this tenant; beyond it 429 (0 =
    #: no cap)
    max_inflight: int = 0

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if self.weight <= 0:
            # a zero weight never accumulates deficit: the grant loop
            # needs weight > 0 to end
            raise ValueError(
                f"tenant {self.name!r} weight must be > 0; got {self.weight}"
            )
        if self.max_queue < 0 or self.max_inflight < 0:
            raise ValueError(
                f"tenant {self.name!r} caps must be >= 0; got "
                f"max_queue={self.max_queue} max_inflight={self.max_inflight}"
            )


#: valid ``ServeConfig.batching`` policies: "continuous" packs windows of
#: many requests densely into ladder-rung device steps
#: (``serve/scheduler.py::ContinuousBatcher``); "deadline" is the
#: whole-request coalescer (``serve/batcher.py::MicroBatcher``); "ragged"
#: packs as continuous but runs every step at the top rung with a
#: valid-row count (``RaggedBatcher``)
BATCHING_MODES = ("continuous", "deadline", "ragged")


@dataclass(frozen=True)
class ServeConfig:
    """The polishing service and its batching plane
    (``roko_tpu/config.py:325-429``): the bind address, the padded batch
    ladder, the request pool bound, the batching policy and its flush
    bounds, the Retry-After hint, the latency reservoir, the ``data_root``
    confinement, the event log, the trace ring and the tenant table."""

    host: str = "127.0.0.1"
    port: int = 8000
    #: padded batch-size ladder; () = auto: ``ladder_base`` scaled by dp
    ladder: Tuple[int, ...] = ()
    #: per-device rung sizes the auto ladder scales by the dp extent
    ladder_base: Tuple[int, ...] = (32, 128, 512)
    #: bounded request pool: submissions beyond it get 503 + Retry-After
    max_queue: int = 64
    #: deadline batching: a partial batch dispatches at most this long
    #: after its first request arrived
    max_delay_ms: float = 25.0
    #: one of BATCHING_MODES
    batching: str = "continuous"
    #: continuous and ragged batching: the oldest queued window waits at
    #: most this long before a partial batch dispatches
    max_queue_age_ms: float = 25.0
    #: pending windows pad up to the next-larger rung only when they
    #: fill at least this fraction of it
    rung_upgrade_fill: float = 0.75
    #: seconds a rejected client is told to wait before retrying (the
    #: continuous batcher's floor until it has measured its throughput)
    retry_after_s: float = 1.0
    #: per-stage latency reservoir behind the /metrics p50/p99 rows
    latency_samples: int = 1024
    #: confine the ref+bam form of POST /polish to files under this
    #: directory; None = any readable path
    data_root: Optional[str] = None
    #: JSONL event sink (``obs/events.py``); None = stderr lines only
    event_log: Optional[str] = None
    event_log_max_mb: float = 64.0
    #: GET /tracez retention: the last N request traces and the slowest N
    trace_ring: int = 256
    trace_slowest: int = 32
    #: tenant fair-share table; () = the single default tenant
    tenants: Tuple[TenantConfig, ...] = ()

    def __post_init__(self) -> None:
        if self.batching not in BATCHING_MODES:
            raise ValueError(
                f"unknown batching policy {self.batching!r}; expected one "
                "of " + "|".join(BATCHING_MODES)
            )
        if not 0.0 < self.rung_upgrade_fill <= 1.0:
            raise ValueError(
                "rung_upgrade_fill must lie in (0, 1]; got "
                f"{self.rung_upgrade_fill}"
            )
        if self.max_queue_age_ms < 0:
            raise ValueError(
                f"max_queue_age_ms must be >= 0; got {self.max_queue_age_ms}"
            )
        if not self.ladder_base or any(r <= 0 for r in self.ladder_base):
            raise ValueError(
                "ladder_base must name at least one positive per-device "
                f"rung size; got {self.ladder_base}"
            )
        if self.trace_ring < 1 or self.trace_slowest < 1:
            raise ValueError(
                "trace_ring/trace_slowest must be >= 1; got "
                f"{self.trace_ring}/{self.trace_slowest}"
            )
        names = [t.name for t in self.tenants]
        if len(names) != len(set(names)):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate tenant names: {dupes}")


def resolve_ladder(serve: ServeConfig, dp: int) -> Tuple[int, ...]:
    """The global rung ladder a session on a ``dp``-wide grid uses:
    explicit ``serve.ladder`` rungs pass through (sorted, deduped; their
    validity against dp is :func:`validate_ladder`'s, where the grid is
    known), and the auto default scales each per-rank
    ``serve.ladder_base`` rung by dp. ``dp`` is the dp extent of the
    session's grid of processes (``serve/session.py``): each global rung
    sends rung/dp rows to every dp group. The session, the bundle exporter
    and the stream's tail rungs all resolve through here."""
    if dp < 1:
        raise ValueError(f"mesh dp axis must be >= 1; got {dp}")
    if serve.ladder:
        return tuple(sorted(set(serve.ladder)))
    return tuple(sorted({r * dp for r in serve.ladder_base}))


def validate_ladder(rungs: Sequence[int], dp: int, *, flag: str = "--ladder") -> None:
    """Refuse global rungs that cannot shard over the dp axis, naming the
    nearest valid rungs."""
    bad = [r for r in rungs if r <= 0 or r % dp]
    if not bad:
        return

    def nearest(r: int) -> str:
        lo = (r // dp) * dp
        hi = lo + dp
        opts = [v for v in (lo, hi) if v > 0] or [dp]
        return f"{r} -> " + " or ".join(str(v) for v in dict.fromkeys(opts))

    raise ValueError(
        f"ladder rungs {bad} are not positive multiples of the mesh dp "
        f"axis (dp={dp}): a global rung shards rung/dp windows onto "
        f"each of the dp devices. Nearest valid: "
        + "; ".join(nearest(r) for r in sorted(bad))
        + f". Pick multiples of dp, or leave {flag} unset to auto-scale "
        "the per-device base ladder by dp."
    )


@dataclass(frozen=True)
class PipelineConfig:
    """The streaming polish engine (``roko_tpu/config.py:645-663``)."""

    #: bounded region-result queue depth, in region blocks; a full queue
    #: blocks the extraction workers
    queue_regions: int = 8
    #: a partial device batch dispatches at most this long after its
    #: oldest window was queued (the scheduler's ``max_queue_age_ms``)
    max_batch_delay_ms: float = 250.0
    #: submitted blocks whose predictions may be outstanding
    prefetch: int = 2


@dataclass(frozen=True)
class ResilienceConfig:
    """Failure-handling knobs (``roko_tpu/config.py:748-778``). A blown
    deadline raises :class:`HangError`; the JAX package's
    ``hang_fallback="cpu"`` (finish on the host CPU) is not ported, since
    carrying on on the CPU after the card failed would hide the card."""

    #: hard deadline on one device predict call; on expiry the watchdog
    #: dumps every thread stack and raises. 0 disables the watchdog.
    predict_deadline_s: float = 600.0
    #: deadline of the FIRST dispatch of each padded batch shape, which
    #: on the card also builds the kernels. 0 disables it.
    compile_deadline_s: float = 1800.0
    #: serve: consecutive device failures that trip the circuit breaker
    #: (0 disables it)
    breaker_failures: int = 5
    #: serve: seconds an open breaker waits before half-open probing
    breaker_reset_s: float = 30.0
    #: serve: seconds in-flight requests get to finish after SIGTERM
    drain_deadline_s: float = 20.0


@dataclass(frozen=True)
class CompileConfig:
    """Cold start (``roko_tpu/config.py:719-746``): the kernel build cache,
    kernel bundles and the ladder warmup (``roko_tpu_torch/compile``). The
    port's compiled artifacts are the nvcc-built kernel libraries, so its
    "persistent compile cache" is the kernel build directory and its
    bundle carries those libraries. ``cache_max_mb`` and
    ``min_compile_time_s`` steer JAX's persistent cache and have no nvcc
    counterpart: they stay at their defaults (:data:`_NOT_PORTED`)."""

    #: kernel build cache on/off (``--no-compile-cache``, or
    #: ``ROKO_COMPILE_CACHE=off``, which overrides everything here): off
    #: builds every kernel into a fresh directory of this process
    enabled: bool = True
    #: build directory; None = ``build/roko_tpu_torch/`` beside the package
    cache_dir: Optional[str] = None
    #: kernel bundle (written by ``python -m roko_tpu_torch compile``) whose
    #: libraries load instead of being built; a mismatch refuses loudly
    bundle_dir: Optional[str] = None
    #: warm the ladder's rungs on threads at once; False = one by one
    parallel_warmup: bool = True
    #: warmup thread cap; 0 = min(len(ladder), host cores)
    warmup_workers: int = 0


@dataclass(frozen=True)
class FleetConfig:
    """The single-host serving fleet (``roko_tpu/config.py:473-640``): a
    supervising front end starts ``workers`` workers, each pinned to a
    slice of the cards by ``CUDA_VISIBLE_DEVICES`` (or sharing them with
    ``devices_per_worker=0``) and each one session over one serve process
    a card of its slice (``parallel.mesh.fleet_worker_ranks``), and routes
    around crashed, hung and
    breaker-tripped workers; rollouts, the A/B lane and the autoscaler ride
    on it. ``join``, ``host_id``, ``lease_ttl_s`` and ``fed_breaker_*`` are
    the multi-host federation's (``serve/federation.py``): a supervisor
    with ``join`` set is a host agent of the front end at ``HOST:PORT``."""

    #: worker processes; 0 = the single-process service; -1 = auto (one
    #: per ``devices_per_worker`` visible cards)
    workers: int = 0
    #: cards each worker sees, one rank of its session a card; 0 = every
    #: worker shares every card (its ranks: the mesh's grid, or one a card)
    devices_per_worker: int = 0
    heartbeat_interval_s: float = 2.0
    heartbeat_timeout_s: float = 5.0
    heartbeat_misses: int = 3
    spawn_deadline_s: float = 120.0
    term_grace_s: float = 10.0
    restart_base_delay_s: float = 0.5
    restart_max_delay_s: float = 30.0
    stable_after_s: float = 30.0
    storm_threshold: int = 5
    storm_reset_s: float = 60.0
    max_inflight: int = 0
    failover_attempts: int = 3
    #: worker logs, announce files and the rollout journal; None = a
    #: ``roko-fleet-<pid>`` directory under the temporary directory
    runtime_dir: Optional[str] = None
    #: model registry; None = ``build/roko_tpu_torch_registry`` beside the
    #: package (env ``ROKO_REGISTRY`` overrides both)
    registry_dir: Optional[str] = None
    bake_s: float = 15.0
    rollback_error_pct: float = 2.0
    rollback_p99_x: float = 3.0
    rollout_ready_timeout_s: float = 900.0
    min_workers: int = 0
    max_workers: int = 0
    autoscale_interval_s: float = 1.0
    autoscale_up_backlog: float = 32.0
    autoscale_down_backlog: float = 4.0
    autoscale_idle_s: float = 10.0
    autoscale_cooldown_s: float = 3.0
    autoscale_ema_beta: float = 0.5
    ab_version: Optional[str] = None
    ab_fraction: float = 0.0
    #: this host's stable identity at the federation front's registry;
    #: None = ``host-<agent pid>`` (set it, so that an agent restarted
    #: after a crash bumps the SAME host's epoch)
    host_id: Optional[str] = None
    #: the federation front to join as ``HOST:PORT`` (``--join``); set, it
    #: turns ``serve`` into a host agent
    join: Optional[str] = None
    #: registration lease TTL in seconds: the agent renews every ttl/3; an
    #: expired lease leaves rotation until the agent registers again, which
    #: bumps the epoch and fences the old one
    lease_ttl_s: float = 10.0
    #: the front's breaker per host: consecutive connection failures that
    #: open it, and seconds until a half-open probe
    fed_breaker_failures: int = 3
    fed_breaker_reset_s: float = 10.0

    def __post_init__(self) -> None:
        if self.min_workers < 0 or self.max_workers < 0:
            raise ValueError(
                "min_workers/max_workers must be >= 0; got "
                f"{self.min_workers}/{self.max_workers}"
            )
        if self.max_workers and self.min_workers > self.max_workers:
            raise ValueError(
                f"min_workers ({self.min_workers}) exceeds max_workers "
                f"({self.max_workers})"
            )
        if not 0.0 <= self.ab_fraction <= 1.0:
            raise ValueError(f"ab_fraction must lie in [0, 1]; got {self.ab_fraction}")
        if self.ab_fraction > 0 and not self.ab_version:
            raise ValueError("ab_fraction > 0 needs ab_version (a registry name)")
        if self.autoscale_down_backlog > self.autoscale_up_backlog:
            raise ValueError(
                "autoscale_down_backlog must not exceed "
                "autoscale_up_backlog (the hysteresis band); got "
                f"{self.autoscale_down_backlog} > {self.autoscale_up_backlog}"
            )
        if not 0.0 <= self.autoscale_ema_beta < 1.0:
            raise ValueError(
                f"autoscale_ema_beta must lie in [0, 1); got {self.autoscale_ema_beta}"
            )
        if self.lease_ttl_s <= 0:
            raise ValueError(f"lease_ttl_s must be > 0; got {self.lease_ttl_s}")
        if self.fed_breaker_failures < 1:
            raise ValueError(
                f"fed_breaker_failures must be >= 1; got {self.fed_breaker_failures}")


@dataclass(frozen=True)
class DistPolishConfig:
    """The distributed polish over the worker fleet (``polish
    --distributed``, ``pipeline/distpolish.py``; ``roko_tpu/config.py:
    665-718``): a whole-genome job splits into per-contig work units
    (contigs past ``unit_bases`` into region-aligned span units),
    dispatched across the fleet's workers with a commit or retry per unit
    through the resume journal."""

    #: contigs longer than this split into span units on the extraction
    #: region table; 0 = whole-contig units only
    unit_bases: int = 1_000_000
    #: distinct dispatch attempts of one unit before it is quarantined
    #: and the job fails naming its contig
    unit_attempts: int = 3
    #: hard cap on units in flight across the fleet; 0 = auto
    #: (``inflight_per_worker`` x worker count)
    max_inflight_units: int = 0
    #: units in flight per READY worker (the live limit follows the fleet)
    inflight_per_worker: int = 2
    #: deadline of one unit's round trip; on expiry the attempt fails
    unit_timeout_s: float = 600.0
    #: scheduler poll while parked (draining, no ready worker, backoff)
    park_poll_s: float = 0.25
    #: seconds to wait for the first ready worker, and for a fully
    #: unready fleet mid-job, before the job gives up
    ready_timeout_s: float = 600.0

    def __post_init__(self) -> None:
        if self.unit_attempts < 1:
            raise ValueError(f"unit_attempts must be >= 1; got {self.unit_attempts}")
        if self.inflight_per_worker < 1:
            raise ValueError(
                f"inflight_per_worker must be >= 1; got {self.inflight_per_worker}")


@dataclass(frozen=True)
class CascadeConfig:
    """Adaptive compute (``cascade/``; ``roko_tpu/config.py:819-880``):
    every window goes through a cheap tier first, only the uncertain rest
    escalates to the model, and repeated windows come from a
    content-addressed cache."""

    #: False keeps the plain single-tier path everywhere
    enabled: bool = False
    #: tier-1 kind: "majority" (the pileup majority vote, on the host) or
    #: "model" (a named registry version, on the session's device)
    tier: str = "majority"
    #: registry version name of ``tier="model"``
    tier_version: Optional[str] = None
    #: windows whose calibrated confidence is <= 1 - threshold escalate:
    #: 0 escalates every window (the plain path's bytes), 1 none
    threshold: float = 0.05
    #: confidence function: "max_softmax" or "margin" (top-2 logit gap)
    method: str = "max_softmax"
    #: temperature-scaling artifact (JSON beside the checkpoint); None =
    #: the tier's default temperature
    calibration_path: Optional[str] = None
    #: byte cap of the in-memory window cache; 0 turns it off
    cache_bytes: int = 64 * 2**20
    #: on-disk cache directory a distributed polish's workers share
    #: (identity pinned by its meta.json); None = in memory only
    cache_dir: Optional[str] = None

    def __post_init__(self) -> None:
        if self.tier not in ("majority", "model"):
            raise ValueError(f"cascade.tier must be 'majority' or 'model', got {self.tier!r}")
        if self.method not in ("max_softmax", "margin"):
            raise ValueError(
                f"cascade.method must be 'max_softmax' or 'margin', got {self.method!r}")
        if not 0.0 <= self.threshold <= 1.0:
            raise ValueError(f"cascade.threshold must lie in [0, 1], got {self.threshold}")
        if self.cache_bytes < 0:
            raise ValueError(f"cascade.cache_bytes must be >= 0, got {self.cache_bytes}")
        if self.tier == "model" and not self.tier_version:
            raise ValueError(
                "cascade.tier='model' needs cascade.tier_version (a model-registry name)")


@dataclass(frozen=True)
class StoreConfig:
    """The object-store data plane (``datapipe/store.py``;
    ``roko_tpu/config.py:881-932``): ranged reads through a checksummed
    block cache, retries, a hedged read and a breaker around every
    request, read-verify-commit uploads. ``gs://`` and ``s3://`` URLs
    resolve through ``endpoint`` (or ``ROKO_STORE_ENDPOINT``); faults are
    injected from the environment only (``ROKO_STORE_FAULTS``)."""

    #: on-disk block and object cache (``--store-cache``); None = none
    cache_dir: Optional[str] = None
    #: the block cache's eviction cap in bytes (least recently used past it)
    cache_bytes: int = 256 * 2**20
    #: ranged-read granularity: the unit cached and checksummed
    block_bytes: int = 4 * 2**20
    #: socket timeout of one request
    timeout_s: float = 30.0
    #: attempts a request (1 = no retries)
    max_attempts: int = 4
    #: seconds before a straggling read gets a hedged second request; 0 = off
    hedge_s: float = 0.0
    #: consecutive failures of an endpoint that trip its breaker
    breaker_failures: int = 5
    #: seconds an open breaker waits before a half-open probe
    breaker_reset_s: float = 30.0
    #: HTTP(S) gateway prefix of ``gs://`` and ``s3://`` URLs
    endpoint: Optional[str] = None

    def __post_init__(self) -> None:
        if self.cache_bytes < 0:
            raise ValueError(f"store.cache_bytes must be >= 0, got {self.cache_bytes}")
        if self.block_bytes < 1:
            raise ValueError(f"store.block_bytes must be >= 1, got {self.block_bytes}")
        if self.max_attempts < 1:
            raise ValueError(f"store.max_attempts must be >= 1, got {self.max_attempts}")
        if self.hedge_s < 0:
            raise ValueError(f"store.hedge_s must be >= 0, got {self.hedge_s}")
        if self.breaker_failures < 1:
            raise ValueError(
                f"store.breaker_failures must be >= 1, got {self.breaker_failures}")


#: the fields of ``roko_tpu.config.RokoConfig`` the port does not run,
#: by section: field -> (the reference's default, the ROADMAP queue item
#: that ports it, or why it is not ported). A file that sets one to another
#: value is refused, naming the item; none is dropped silently.
_NOT_PORTED: Dict[str, Dict[str, Tuple[Any, str]]] = {
    "model": {"remat_frontend": (False, "A12"), "remat_scan": (False, "A12")},
    "train": {"dropout_rng_impl": ("threefry", "A12")},
    "resilience": {"hang_fallback": ("none", "deliberately not ported: finishing on the CPU "
                                     "after the card failed would hide the card")},
    "compile": {
        "cache_max_mb": (1024, "no nvcc counterpart: it bounds JAX's persistent XLA cache by "
                         "LRU eviction, and the port's kernel build directory evicts nothing"),
        "min_compile_time_s": (0.0, "no nvcc counterpart: it skips caching fast XLA compiles, "
                               "and every nvcc build is cached"),
    },
}

#: fields that load whatever they hold: ``use_pallas`` asks the reference
#: for its Pallas kernels on a TPU (the port runs its own kernels on every
#: card)
_IGNORED = {"model": ("use_pallas",)}


@dataclass(frozen=True)
class RokoConfig(FeaturesConfig):
    """The sections of ``roko_tpu.config.RokoConfig`` the streaming polish
    reads: the feature sections (it is a ``FeaturesConfig``), the model,
    the batching plane, the pipeline, the failure handling, the kernel
    build cache and bundles, the serving fleet and its federation, the
    distributed polish, the cascade and the object store. The model's ``window_rows``/``window_cols`` must match ``window``."""

    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    guard: GuardConfig = field(default_factory=GuardConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    compile: CompileConfig = field(default_factory=CompileConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    distpolish: DistPolishConfig = field(default_factory=DistPolishConfig)
    cascade: CascadeConfig = field(default_factory=CascadeConfig)
    store: StoreConfig = field(default_factory=StoreConfig)

    def to_json(self) -> str:
        """The reference's layout (``roko_tpu/config.py:935-983``): one
        object per section, keys sorted."""
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "RokoConfig":
        """Load a file of the reference's layout; a section or field
        missing keeps its default. A field the port does not run must hold
        the reference's default (:data:`_NOT_PORTED`), else the file is
        refused with the field and its queue item."""
        raw = json.loads(text)
        classes = {f.name: f.default_factory for f in dataclasses.fields(RokoConfig)}
        unknown = sorted(set(raw) - set(classes) - set(_NOT_PORTED))
        if unknown:
            raise ValueError(f"config sections {unknown} are not RokoConfig sections")
        built = {}
        for name in sorted(set(raw) | set(_NOT_PORTED)):
            values = dict(raw.get(name, {}))
            for key, (default, item) in _NOT_PORTED.get(name, {}).items():
                if key in values and values.pop(key) != default:
                    where = (f"not ported yet (queue item {item} of ROADMAP.md)"
                             if item.startswith("A") else item)
                    raise ValueError(
                        f"config {name}.{key} = {raw[name][key]!r}: {where}; the port "
                        f"runs only its default {default!r}")
            for key in _IGNORED.get(name, ()):
                values.pop(key, None)
            if name not in classes:
                continue
            cls = classes[name]
            known = {f.name for f in dataclasses.fields(cls)}
            extra = sorted(set(values) - known)
            if extra:
                raise ValueError(f"config section {name!r} has unknown fields {extra}")
            built[name] = cls(**{k: tuple(TenantConfig(**t) for t in v) if k == "tenants"
                                 else tuple(v) if isinstance(v, list) else v
                                 for k, v in values.items()})
        return RokoConfig(**built)
