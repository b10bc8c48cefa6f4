"""Prometheus text metrics of the polishing service (the port's copy of
``roko_tpu/serve/metrics.py``), built on
:class:`roko_tpu_torch.utils.profiling.StageTimer` and the mergeable
histograms of ``obs/hist.py``.

Series (prefixed ``roko_serve_`` unless named otherwise):

- ``requests_total``, ``windows_total``, ``batches_total``,
  ``rejected_total``, ``errors_total`` — counters;
- ``queue_depth`` — gauge, sampled at scrape time;
- ``cpu_fallback`` — gauge, always 0: the port has no CPU fail-over;
- ``batch_fill_ratio`` and ``padding_efficiency`` — gauges, real windows
  over the padded rows (or ragged slots) dispatched, with the raw
  ``fill_windows_total`` and ``fill_padded_total`` beside them;
- ``queue_windows`` and ``scheduler_occupancy`` — gauges of the
  continuous and ragged batchers (absent under the deadline batcher);
- ``tenant_requests_total``, ``tenant_rejected_total``,
  ``tenant_backlog`` and ``model_requests_total`` — tenant- and
  model-labelled rows, once traffic carries a tenant or the process a
  ``ROKO_MODEL_VERSION``;
- ``breaker_state`` (0 closed, 1 half-open, 2 open) and
  ``breaker_trips_total`` with a circuit breaker attached;
- ``warmup_seconds`` — gauge, NaN while the ladder warms;
- ``roko_compile_cache_hits`` and ``roko_compile_cache_misses`` — the
  kernel build cache of this process (``compile/cache.py``): libraries
  found already built, and nvcc runs (0 in a worker started from a
  kernel bundle);
- ``request_latency_seconds`` — summary (p50, p99, count, sum) over the
  retained samples, and per size class (``size_class="le{rung}"``,
  ``gt{top}`` past the top rung);
- ``cascade_windows_total``, ``cascade_escalated_total``,
  ``cascade_cache_hits_total`` (counters), ``cascade_escalation_fraction``
  and ``cascade_cache_hit_rate`` (gauges), once a cascade router reported;
- the mergeable histograms ``roko_request_latency_seconds`` (by size
  class, tenant and model), ``roko_queue_wait_seconds``,
  ``roko_device_time_seconds`` and ``roko_cascade_tier_seconds`` (by
  tier);
- ``roko_store_*_total`` — the object-store client's process-wide
  counters (``datapipe/store.py``: requests, retries, hedges, breaker
  trips, cache hits and misses, injected faults).

Every series of the reference's ``/metrics`` has its counterpart here.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

from roko_tpu_torch.compile.cache import cache_counters
from roko_tpu_torch.obs.hist import HistogramFamily
from roko_tpu_torch.utils.profiling import StageTimer

_PREFIX = "roko_serve_"
_COUNTERS = ("requests", "windows", "batches", "rejected", "errors")

#: the mergeable histogram families a worker renders, which the fleet's
#: supervisor sums bucket by bucket into fleet rows (``serve/fleet.py``)
HISTOGRAM_SERIES = (
    "roko_request_latency_seconds",
    "roko_queue_wait_seconds",
    "roko_device_time_seconds",
    "roko_cascade_tier_seconds",
)

#: labelled series the supervisor passes through row by row, each with a
#: ``worker="i"`` label appended
LABELED_SERIES = (
    "roko_serve_tenant_requests_total",
    "roko_serve_tenant_rejected_total",
    "roko_serve_tenant_backlog",
    "roko_serve_model_requests_total",
)

def parse_labeled_rows(text: str, names) -> Dict[str, list]:
    """``{name: [(label_body, value), ...]}`` for the LABELLED series of a
    Prometheus text body (``label_body`` is the raw text inside the
    braces)."""
    wanted = set(names)
    out: Dict[str, list] = {}
    for line in text.splitlines():
        if not line or line.startswith("#") or "{" not in line:
            continue
        name, rest = line.split("{", 1)
        if name not in wanted or "}" not in rest:
            continue
        body, _, value = rest.partition("}")
        value = value.strip()
        if value:
            out.setdefault(name, []).append((body, value))
    return out


def parse_metric_values(text: str, names) -> Dict[str, str]:
    """``{name: value}`` for the unlabelled series of a Prometheus text
    body; values stay strings."""
    wanted = set(names)
    out: Dict[str, str] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) == 2 and parts[0] in wanted:
            out[parts[0]] = parts[1]
    return out


class ServeMetrics:
    def __init__(self, latency_samples: int = 1024):
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {name: 0 for name in _COUNTERS}
        self.timer = StageTimer(max_samples=latency_samples)
        #: windows actually dispatched / padded rows dispatched
        self._fill_windows = 0
        self._fill_padded = 0
        #: scrape-time gauge; the batcher points this at its queue
        self.queue_depth: Callable[[], int] = lambda: 0
        #: scrape-time gauge; make_server points this at
        #: ``PolishSession.failed_over`` (always False in the port)
        self.cpu_fallback: Callable[[], bool] = lambda: False
        #: circuit breaker to render state and trips for (make_server)
        self.breaker = None
        #: ladder warmup wall seconds (None renders NaN: still warming)
        self.warmup_seconds: Optional[float] = None
        #: request-size latency classes (the session's ladder rungs, set
        #: by make_server); empty = per-class rows off
        self.size_classes: Tuple[int, ...] = ()
        #: continuous-scheduler gauges (None under the deadline batcher)
        self.queue_windows: Optional[Callable[[], int]] = None
        self.occupancy: Optional[Callable[[], float]] = None
        #: per-tenant queued-window gauge source (continuous batchers)
        self.tenant_backlogs: Optional[Callable[[], Dict[str, int]]] = None
        self._tenant_requests: Dict[str, int] = {}
        self._tenant_rejected: Dict[str, int] = {}
        #: per-model request counter; ``model_version`` is this process's
        #: version identity (env ROKO_MODEL_VERSION) and labels the
        #: latency histogram
        self._model_requests: Dict[str, int] = {}
        self.model_version: Optional[str] = None
        #: mergeable cumulative histograms: request latency by size class,
        #: and the queue-wait / device-time decomposition
        self.hist_latency = HistogramFamily("roko_request_latency_seconds", label="size_class")
        self.hist_queue_wait = HistogramFamily("roko_queue_wait_seconds")
        self.hist_device = HistogramFamily("roko_device_time_seconds")
        #: the cascade's per-tier time, labelled tier1/tier2 (mergeable)
        self.hist_cascade = HistogramFamily("roko_cascade_tier_seconds", label="tier")
        #: the cascade's counters; rendered only once a router reported
        self._cascade_windows = 0
        self._cascade_escalated = 0
        self._cascade_cache_hits = 0
        self.cascade_enabled = False

    def size_class(self, windows: int) -> str:
        """``le{r}`` for the smallest rung r >= n, ``gt{top}`` past the top."""
        for rung in self.size_classes:
            if windows <= rung:
                return f"le{rung}"
        return f"gt{self.size_classes[-1]}"

    def observe_request(
        self,
        windows: int,
        seconds: float,
        tenant: Optional[str] = None,
        model: Optional[str] = None,
    ) -> None:
        """One completed request: the aggregate latency span, its size
        class's span, and the histogram rows (with tenant and model rows
        beside the size-class one)."""
        self.timer.record("request", seconds)
        label = self.size_class(windows) if self.size_classes else None
        if label is not None:
            self.timer.record(f"request:{label}", seconds)
        model = model or self.model_version
        extra = []
        if tenant:
            extra.append(("tenant", tenant))
            with self._lock:
                self._tenant_requests[tenant] = self._tenant_requests.get(tenant, 0) + 1
        if model:
            extra.append(("model", model))
            with self._lock:
                self._model_requests[model] = self._model_requests.get(model, 0) + 1
        self.hist_latency.observe(seconds, label, extra_labels=extra)

    def inc_tenant_rejected(self, tenant: str) -> None:
        with self._lock:
            self._tenant_rejected[tenant] = self._tenant_rejected.get(tenant, 0) + 1

    def observe_cascade(
        self,
        *,
        windows: int = 0,
        escalated: int = 0,
        cache_hits: int = 0,
        tier1_seconds: Optional[float] = None,
        tier2_seconds: Optional[float] = None,
    ) -> None:
        """One routed batch (``CascadeRouter`` calls this): the window
        counters and the per-tier time."""
        with self._lock:
            self.cascade_enabled = True
            self._cascade_windows += windows
            self._cascade_escalated += escalated
            self._cascade_cache_hits += cache_hits
        if tier1_seconds is not None:
            self.hist_cascade.observe(tier1_seconds, "tier1")
        if tier2_seconds is not None:
            self.hist_cascade.observe(tier2_seconds, "tier2")

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self.counters[name] += by

    def observe_fill(self, windows: int, padded: int) -> None:
        with self._lock:
            self._fill_windows += windows
            self._fill_padded += padded

    def fill_ratio(self) -> Optional[float]:
        """Real windows over padded rows dispatched (None before the
        first step): the ``padding_efficiency``."""
        with self._lock:
            if not self._fill_padded:
                return None
            return self._fill_windows / self._fill_padded

    def fill_totals(self) -> Tuple[int, int]:
        """(real windows, padded rows) dispatched so far."""
        with self._lock:
            return self._fill_windows, self._fill_padded

    def render(self) -> str:
        """The ``GET /metrics`` body, in the reference's order and format."""
        lines = []
        for name in _COUNTERS:
            full = f"{_PREFIX}{name}_total"
            lines.append(f"# TYPE {full} counter")
            lines.append(f"{full} {self.counters[name]}")
        lines.append(f"# TYPE {_PREFIX}queue_depth gauge")
        lines.append(f"{_PREFIX}queue_depth {int(self.queue_depth())}")
        fill = self.fill_ratio()
        for gauge in ("batch_fill_ratio", "padding_efficiency"):
            lines.append(f"# TYPE {_PREFIX}{gauge} gauge")
            lines.append(f"{_PREFIX}{gauge} " + ("NaN" if fill is None else f"{fill:.4f}"))
        fw, fp = self.fill_totals()
        lines.append(f"# TYPE {_PREFIX}fill_windows_total counter")
        lines.append(f"{_PREFIX}fill_windows_total {fw}")
        lines.append(f"# TYPE {_PREFIX}fill_padded_total counter")
        lines.append(f"{_PREFIX}fill_padded_total {fp}")
        if self.queue_windows is not None:
            lines.append(f"# TYPE {_PREFIX}queue_windows gauge")
            lines.append(f"{_PREFIX}queue_windows {int(self.queue_windows())}")
        if self.occupancy is not None:
            lines.append(f"# TYPE {_PREFIX}scheduler_occupancy gauge")
            lines.append(f"{_PREFIX}scheduler_occupancy {self.occupancy():.4f}")
        with self._lock:
            t_req = dict(self._tenant_requests)
            t_rej = dict(self._tenant_rejected)
            m_req = dict(self._model_requests)
        t_backlog = self.tenant_backlogs() if self.tenant_backlogs else {}
        for series, kind, label, rows in (
            ("tenant_requests_total", "counter", "tenant", t_req),
            ("tenant_rejected_total", "counter", "tenant", t_rej),
            ("tenant_backlog", "gauge", "tenant", t_backlog),
            ("model_requests_total", "counter", "model", m_req),
        ):
            if rows:
                lines.append(f"# TYPE {_PREFIX}{series} {kind}")
                for key in sorted(rows):
                    lines.append(f'{_PREFIX}{series}{{{label}="{key}"}} {int(rows[key])}')
        lines.append(f"# TYPE {_PREFIX}cpu_fallback gauge")
        lines.append(f"{_PREFIX}cpu_fallback {int(bool(self.cpu_fallback()))}")
        if self.breaker is not None:
            lines.append(f"# TYPE {_PREFIX}breaker_state gauge")
            lines.append(f"{_PREFIX}breaker_state {self.breaker.state_code()}")
            lines.append(f"# TYPE {_PREFIX}breaker_trips_total counter")
            lines.append(f"{_PREFIX}breaker_trips_total {self.breaker.trip_count}")
        lines.append(f"# TYPE {_PREFIX}warmup_seconds gauge")
        lines.append(
            f"{_PREFIX}warmup_seconds "
            + ("NaN" if self.warmup_seconds is None else f"{self.warmup_seconds:.3f}")
        )
        hits, misses = cache_counters()
        lines.append("# TYPE roko_compile_cache_hits counter")
        lines.append(f"roko_compile_cache_hits {hits}")
        lines.append("# TYPE roko_compile_cache_misses counter")
        lines.append(f"roko_compile_cache_misses {misses}")
        lat = f"{_PREFIX}request_latency_seconds"
        lines.append(f"# TYPE {lat} summary")
        for q in (50, 99):
            v = self.timer.percentile("request", q)
            if v is not None:
                lines.append(f'{lat}{{quantile="0.{q}"}} {v:.6f}')
        lines.append(f"{lat}_count {self.timer.counts.get('request', 0)}")
        lines.append(f"{lat}_sum {self.timer.totals.get('request', 0.0):.6f}")
        # per-size-class rows, for the classes that have seen traffic
        for rung in self.size_classes:
            for label in (f"le{rung}",) + ((f"gt{rung}",) if rung == self.size_classes[-1]
                                            else ()):
                stage = f"request:{label}"
                if not self.timer.counts.get(stage):
                    continue
                for q in (50, 99):
                    v = self.timer.percentile(stage, q)
                    if v is not None:
                        lines.append(f'{lat}{{quantile="0.{q}",size_class="{label}"}} {v:.6f}')
                lines.append(f'{lat}_count{{size_class="{label}"}} {self.timer.counts[stage]}')
                lines.append(
                    f'{lat}_sum{{size_class="{label}"}} '
                    f"{self.timer.totals.get(stage, 0.0):.6f}"
                )
        if self.cascade_enabled:
            with self._lock:
                cw, ce, ch = (self._cascade_windows, self._cascade_escalated,
                              self._cascade_cache_hits)
            for name, value in (("windows_total", cw), ("escalated_total", ce),
                                ("cache_hits_total", ch)):
                lines.append(f"# TYPE {_PREFIX}cascade_{name} counter")
                lines.append(f"{_PREFIX}cascade_{name} {value}")
            for name, num in (("escalation_fraction", ce), ("cache_hit_rate", ch)):
                lines.append(f"# TYPE {_PREFIX}cascade_{name} gauge")
                lines.append(f"{_PREFIX}cascade_{name} " + (f"{num / cw:.4f}" if cw else "NaN"))
        # the object-store client's counters (process-wide, not per
        # worker): retries, hedges and breaker trips show on /metrics
        from roko_tpu_torch.datapipe.store import store_metrics_lines

        lines.extend(store_metrics_lines())
        # mergeable histograms last (no serve prefix)
        for hist in (self.hist_latency, self.hist_queue_wait, self.hist_device,
                     self.hist_cascade):
            lines.extend(hist.render())
        return "\n".join(lines) + "\n"
