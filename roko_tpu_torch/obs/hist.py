"""Mergeable latency metrics: cumulative Prometheus histograms (the
port's copy of ``roko_tpu/obs/hist.py``; the rendered text is byte-equal
to the reference's for the same observations).

The reservoir summaries of ``serve/metrics.py`` answer p50/p99 for ONE
process, but percentiles do not compose. Histograms with FIXED bucket
bounds do: bucket counts are plain monotone counters, so the latency of
several processes is the bucket-wise SUM of their rows, and any scraper
derives quantiles from the summed CDF (:func:`quantile_from_buckets`).

Every instance shares :data:`DEFAULT_LATENCY_BUCKETS`; merging across
processes is only sound because the bounds never vary per process.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: fixed bucket upper bounds in SECONDS, log-spaced from sub-ms host
#: overhead to the 600 s request ceiling. Chosen once, shared by every
#: histogram in the codebase — merging only works on identical bounds.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 600.0,
)

_INF = float("inf")


def _fmt_le(le: float) -> str:
    if le == _INF:
        return "+Inf"
    return f"{le:g}"


class HistogramFamily:
    """One named histogram with an optional single label dimension
    (e.g. ``size_class``), rendered in the Prometheus text format:

    ``<name>_bucket{le="..."} N`` (cumulative), ``<name>_sum``,
    ``<name>_count`` — plus the label when set. Thread-safe; observe is
    two dict updates under a lock (a few hundred ns on the serve hot path)."""

    def __init__(
        self,
        name: str,
        *,
        label: Optional[str] = None,
        buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
    ):
        self.name = name
        self.label = label
        self.buckets: Tuple[float, ...] = tuple(buckets) + (_INF,)
        self._lock = threading.Lock()
        #: label value -> per-bucket NON-cumulative counts ("" = the
        #: unlabeled aggregate row, always kept)
        self._counts: Dict[str, List[int]] = {}
        self._sums: Dict[str, float] = {}
        self._totals: Dict[str, int] = {}

    def _row(self, key: str) -> List[int]:
        row = self._counts.get(key)
        if row is None:
            row = self._counts[key] = [0] * len(self.buckets)
            self._sums[key] = 0.0
            self._totals[key] = 0
        return row

    def observe(
        self,
        seconds: float,
        label_value: Optional[str] = None,
        extra_labels: Iterable[Tuple[str, str]] = (),
    ) -> None:
        # linear scan beats bisect at ~18 buckets and costs nothing to
        # reason about; the first bound >= value takes the count
        idx = 0
        for idx, le in enumerate(self.buckets):  # noqa: B007
            if seconds <= le:
                break
        # extra_labels adds independent single-label rows (e.g.
        # tenant="bulk", model="v2") beside the primary-label row; each
        # key is stored PRE-RENDERED as 'name="value"' so render() can
        # emit it verbatim and a parse/merge stays label-blind.
        # The unlabeled aggregate still counts each observation ONCE.
        keys = [""] + ([label_value] if label_value else []) + [
            f'{ln}="{lv}"' for ln, lv in extra_labels if lv
        ]
        with self._lock:
            for key in keys:
                self._row(key)[idx] += 1
                self._sums[key] += seconds
                self._totals[key] += 1

    def cumulative(
        self, label_value: str = ""
    ) -> List[Tuple[float, int]]:
        """``[(le, cumulative_count), ...]`` for one row — the shape
        :func:`quantile_from_buckets` consumes."""
        with self._lock:
            row = self._counts.get(label_value)
            if row is None:
                return []
            out, acc = [], 0
            for le, c in zip(self.buckets, row):
                acc += c
                out.append((le, acc))
            return out

    def count(self, label_value: str = "") -> int:
        with self._lock:
            return self._totals.get(label_value, 0)

    def render(self) -> List[str]:
        """Prometheus text lines (``# TYPE`` + every row). The unlabeled
        aggregate renders first; labeled rows carry ``self.label``."""
        with self._lock:
            keys = sorted(self._counts)
            rows = {
                k: (list(self._counts[k]), self._sums[k], self._totals[k])
                for k in keys
            }
        if not rows:
            return []
        lines = [f"# TYPE {self.name} histogram"]
        for key in ([""] if "" in rows else []) + [k for k in keys if k]:
            counts, total_sum, total = rows[key]
            if not key:
                pair = ""
            elif '="' in key:
                # pre-rendered extra-label row (observe(extra_labels=))
                pair = key
            else:
                pair = f'{self.label}="{key}"' if self.label else ""
            extra = f",{pair}" if pair else ""
            acc = 0
            for le, c in zip(self.buckets, counts):
                acc += c
                lines.append(
                    f'{self.name}_bucket{{le="{_fmt_le(le)}"{extra}}} {acc}'
                )
            label = f"{{{pair}}}" if pair else ""
            lines.append(f"{self.name}_sum{label} {total_sum:.6f}")
            lines.append(f"{self.name}_count{label} {total}")
        return lines


def quantile_from_buckets(
    cumulative: Sequence[Tuple[float, int]], q: float
) -> Optional[float]:
    """The q-th quantile (0..1) from cumulative ``(le, count)`` rows —
    linear interpolation inside the landing bucket, the same estimate
    Prometheus' ``histogram_quantile`` computes. None on an empty
    histogram. Works identically on one worker's rows and on
    bucket-summed rows of several processes."""
    if not cumulative:
        return None
    total = cumulative[-1][1]
    if total <= 0:
        return None
    rank = q * total
    prev_le, prev_count = 0.0, 0
    for le, count in cumulative:
        if count >= rank:
            if le == _INF:
                # open-ended bucket: report its lower bound (no upper
                # bound to interpolate toward)
                return prev_le
            span = count - prev_count
            frac = (rank - prev_count) / span if span else 1.0
            return prev_le + (le - prev_le) * frac
        prev_le, prev_count = le, count
    return prev_le


def parse_histogram_rows(
    text: str, name: str
) -> Dict[Tuple[Tuple[str, str], ...], float]:
    """Extract every ``<name>_bucket/_sum/_count`` row from a Prometheus
    text body as ``{((label, value), ...): number}`` — labels sorted, the
    series suffix riding as a ``("__series__", "bucket"|"sum"|"count")``
    pair. Bodies of several processes merge with this (bucket rows sum
    because the bounds are fixed)."""
    out: Dict[Tuple[Tuple[str, str], ...], float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        for series in ("bucket", "sum", "count"):
            prefix = f"{name}_{series}"
            if not line.startswith(prefix):
                continue
            rest = line[len(prefix):]
            labels: List[Tuple[str, str]] = [("__series__", series)]
            if rest.startswith("{"):
                end = rest.find("}")
                if end < 0:
                    break
                body, rest = rest[1:end], rest[end + 1:]
                for pair in body.split(","):
                    if "=" not in pair:
                        continue
                    k, v = pair.split("=", 1)
                    labels.append((k.strip(), v.strip().strip('"')))
            parts = rest.split()
            if len(parts) != 1:
                break
            try:
                value = float(parts[0])
            except ValueError:
                break
            out[tuple(sorted(labels))] = value
            break
    return out


def render_histogram_rows(
    name: str,
    rows: Dict[Tuple[Tuple[str, str], ...], float],
    extra: str = "",
) -> List[str]:
    """Render parsed/merged rows back to Prometheus text: ``_bucket``
    lines grouped by their non-``le`` labels (``le`` in numeric order),
    then ``_sum``/``_count``. ``extra`` appends verbatim label text
    (e.g. ``worker="0"``) to every row, for a per-process re-export
    beside bucket-summed rows."""

    def _le_key(le: str) -> float:
        return _INF if le == "+Inf" else float(le)

    groups: Dict[Tuple[Tuple[str, str], ...], Dict[str, float]] = {}
    scalars: Dict[Tuple[Tuple[str, str], ...], Dict[str, float]] = {}
    for key, value in rows.items():
        labels = dict(key)
        series = labels.pop("__series__", "")
        le = labels.pop("le", None)
        group = tuple(sorted(labels.items()))
        if series == "bucket" and le is not None:
            groups.setdefault(group, {})[le] = value
        elif series in ("sum", "count"):
            scalars.setdefault(group, {})[series] = value

    def _labels_text(group, le: Optional[str] = None) -> str:
        parts = ([f'le="{le}"'] if le is not None else []) + [
            f'{k}="{v}"' for k, v in group
        ]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def _num(v: float) -> str:
        return str(int(v)) if float(v).is_integer() else f"{v:.6f}"

    lines: List[str] = []
    for group in sorted(set(groups) | set(scalars)):
        for le in sorted(groups.get(group, {}), key=_le_key):
            lines.append(
                f"{name}_bucket{_labels_text(group, le)} "
                f"{_num(groups[group][le])}"
            )
        sc = scalars.get(group, {})
        if "sum" in sc:
            lines.append(f"{name}_sum{_labels_text(group)} {sc['sum']:.6f}")
        if "count" in sc:
            lines.append(
                f"{name}_count{_labels_text(group)} {_num(sc['count'])}"
            )
    return lines


def merge_histogram_rows(
    bodies: Iterable[Dict[Tuple[Tuple[str, str], ...], float]]
) -> Dict[Tuple[Tuple[str, str], ...], float]:
    """Bucket-wise sum of parsed rows from many processes — valid because
    every process uses :data:`DEFAULT_LATENCY_BUCKETS` (counters over
    identical bounds add)."""
    out: Dict[Tuple[Tuple[str, str], ...], float] = {}
    for rows in bodies:
        for key, value in rows.items():
            out[key] = out.get(key, 0.0) + value
    return out
