"""Configuration of the port: the fields of ``roko_tpu.config`` that the
feature extractor, the inference and training paths of ``kind="gru"``
and ``kind="lingru"``, the data plane and the streaming polish read, with
the same names and defaults (``WindowConfig``, ``ReadFilterConfig``,
``RegionConfig``, ``ModelConfig``, ``TrainConfig``, ``DataConfig``,
``MeshConfig``, ``GuardConfig``, ``ServeConfig``, ``PipelineConfig``, ``ResilienceConfig``,
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


@dataclass(frozen=True)
class ServeConfig:
    """The batching plane's fields of ``roko_tpu/config.py::ServeConfig``
    (:325-429): the padded batch ladder and the continuous scheduler's
    rung-upgrade hysteresis (the stream sets the age flush bound from
    ``PipelineConfig.max_batch_delay_ms``). The HTTP server with its
    request pool bound, age flush default, Retry-After and tenant table,
    the deadline and ragged batchers and the trace ring are not ported
    yet (queue items A9.2, A9.4)."""

    #: padded batch-size ladder; () = auto: ``ladder_base`` scaled by dp
    ladder: Tuple[int, ...] = ()
    #: per-device rung sizes the auto ladder scales by the dp extent
    ladder_base: Tuple[int, ...] = (32, 128, 512)
    #: pending windows pad up to the next-larger rung only when they
    #: fill at least this fraction of it
    rung_upgrade_fill: float = 0.75

    def __post_init__(self) -> None:
        if not 0.0 < self.rung_upgrade_fill <= 1.0:
            raise ValueError(
                "rung_upgrade_fill must lie in (0, 1]; got "
                f"{self.rung_upgrade_fill}"
            )
        if not self.ladder_base or any(r <= 0 for r in self.ladder_base):
            raise ValueError(
                "ladder_base must name at least one positive per-device "
                f"rung size; got {self.ladder_base}"
            )


def resolve_ladder(serve: ServeConfig, dp: int) -> Tuple[int, ...]:
    """The global rung ladder a session on a ``dp``-wide device set uses:
    explicit ``serve.ladder`` rungs pass through (sorted, deduped), and
    the auto default scales each ``serve.ladder_base`` rung by dp. ``dp``
    is the extent of the mesh the session runs on: a process of the port
    drives one card, so a session's dp is 1 in every process of a run
    (``MeshConfig`` splits training steps and the contigs of an inference
    across processes, never a session's batch; a session over several
    cards is queue item A9.1)."""
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


#: the fields of ``roko_tpu.config.RokoConfig`` the port does not run,
#: by section: field -> (the reference's default, the ROADMAP queue item
#: that ports it, or why it is not ported). A file that sets one to another
#: value is refused, naming the item; none is dropped silently.
_NOT_PORTED: Dict[str, Dict[str, Tuple[Any, str]]] = {
    "model": {"remat_frontend": (False, "A12"), "remat_scan": (False, "A12")},
    "train": {"dropout_rng_impl": ("threefry", "A12")},
    "guard": {"event_log": (None, "A9"), "event_log_max_mb": (64.0, "A9")},
    "resilience": {"hang_fallback": ("none", "deliberately not ported: finishing on the CPU "
                                     "after the card failed would hide the card"),
                   "breaker_failures": (5, "A9"), "breaker_reset_s": (30.0, "A9"),
                   "drain_deadline_s": (20.0, "A9")},
    "serve": {k: (v, "A9") for k, v in (
        ("host", "127.0.0.1"), ("port", 8000), ("max_queue", 64), ("max_delay_ms", 25.0),
        ("data_root", None), ("batching", "continuous"), ("max_queue_age_ms", 25.0),
        ("retry_after_s", 1.0), ("latency_samples", 1024), ("event_log", None),
        ("event_log_max_mb", 64.0), ("trace_ring", 256), ("trace_slowest", 32),
        ("tenants", []))},
    "compile": {k: (v, "A9.3") for k, v in (
        ("enabled", True), ("cache_dir", None), ("cache_max_mb", 1024),
        ("min_compile_time_s", 0.0), ("bundle_dir", None), ("parallel_warmup", True),
        ("warmup_workers", 0))},
    "cascade": {k: (v, "A10") for k, v in (
        ("enabled", False), ("tier", "majority"), ("tier_version", None),
        ("threshold", 0.05), ("method", "max_softmax"), ("calibration_path", None),
        ("cache_bytes", 64 * 2**20), ("cache_dir", None))},
    "distpolish": {k: (v, "A10") for k, v in (
        ("unit_bases", 1_000_000), ("unit_attempts", 3), ("inflight_per_worker", 2),
        ("max_inflight_units", 0), ("park_poll_s", 0.25), ("ready_timeout_s", 600.0),
        ("unit_timeout_s", 600.0))},
    "store": {k: (v, "A10") for k, v in (
        ("cache_dir", None), ("cache_bytes", 256 * 2**20), ("block_bytes", 4 * 2**20),
        ("timeout_s", 30.0), ("max_attempts", 4), ("hedge_s", 0.0), ("breaker_failures", 5),
        ("breaker_reset_s", 30.0), ("endpoint", None))},
    "fleet": {k: (v, "A9") for k, v in (
        ("workers", 0), ("devices_per_worker", 0), ("heartbeat_interval_s", 2.0),
        ("heartbeat_timeout_s", 5.0), ("heartbeat_misses", 3), ("spawn_deadline_s", 120.0),
        ("term_grace_s", 10.0), ("restart_base_delay_s", 0.5), ("restart_max_delay_s", 30.0),
        ("stable_after_s", 30.0), ("storm_threshold", 5), ("storm_reset_s", 60.0),
        ("max_inflight", 0), ("failover_attempts", 3), ("runtime_dir", None),
        ("registry_dir", None), ("bake_s", 15.0), ("rollback_error_pct", 2.0),
        ("rollback_p99_x", 3.0), ("rollout_ready_timeout_s", 900.0), ("ab_version", None),
        ("ab_fraction", 0.0), ("min_workers", 0), ("max_workers", 0),
        ("autoscale_interval_s", 1.0), ("autoscale_up_backlog", 32.0),
        ("autoscale_down_backlog", 4.0), ("autoscale_idle_s", 10.0),
        ("autoscale_ema_beta", 0.5), ("autoscale_cooldown_s", 3.0), ("join", None),
        ("host_id", None), ("lease_ttl_s", 10.0), ("fed_breaker_failures", 3),
        ("fed_breaker_reset_s", 10.0))},
}

#: fields that load whatever they hold: ``use_pallas`` asks the reference
#: for its Pallas kernels on a TPU (the port runs its own kernels on every
#: card)
_IGNORED = {"model": ("use_pallas",)}


@dataclass(frozen=True)
class RokoConfig(FeaturesConfig):
    """The sections of ``roko_tpu.config.RokoConfig`` the streaming polish
    reads: the feature sections (it is a ``FeaturesConfig``), the model,
    the batching plane, the pipeline and the failure handling. The
    model's ``window_rows``/``window_cols`` must match ``window``."""

    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    guard: GuardConfig = field(default_factory=GuardConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)

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
            built[name] = cls(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in values.items()})
        return RokoConfig(**built)
