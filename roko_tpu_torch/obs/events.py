"""The one-line event format behind every ``ROKO_*`` line (the port's
copy of ``roko_tpu/obs/events.py``): ``ROKO_<SUBSYSTEM> event=<event>
k=v ...``, floats compacted to ``%.6g``, keys in call-site order.
:func:`emit` writes that line through the caller's ``log`` (stderr by
default) AND appends one JSON record to the optional process-wide sink
(:class:`EventLog`, installed by :func:`configure_event_log`: ``--event-log
PATH`` of ``serve`` and ``train``, ``ServeConfig.event_log`` and
``GuardConfig.event_log``), so the same event is greppable in a terminal
and queryable as data. The sink is JSONL with size-capped rotation
(``<path>`` -> ``<path>.1``), appended without fsync: events are
diagnostics, not a journal."""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional

Log = Callable[[str], None]

def legacy_prefix(subsystem: str) -> str:
    """The grep prefix of ``subsystem``'s legacy one-liners
    (``guard`` -> ``ROKO_GUARD``)."""
    return "ROKO_" + subsystem.upper()


def _fmt_value(v: Any) -> str:
    # the guard_line float compaction, applied plane-wide: floats render
    # %.6g so thresholds and losses stay short and grep-stable
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def format_line(
    subsystem: str,
    event: str,
    fields: Optional[Dict[str, Any]] = None,
    *,
    suffix: str = "",
    bare_event: bool = False,
    text: Optional[str] = None,
) -> str:
    """The legacy one-liner: ``ROKO_<SUB> event=<event> k=v ... <suffix>``.

    ``bare_event`` drops the ``event=`` key (the watchdog's historical
    ``ROKO_WATCHDOG hang stage=...`` shape); ``text`` replaces
    everything after the prefix verbatim (the failover prose line).
    Key order follows the fields dict (call-site order)."""
    prefix = legacy_prefix(subsystem)
    if text is not None:
        return f"{prefix} {text}"
    parts = [prefix, event if bare_event else f"event={event}"]
    for k, v in (fields or {}).items():
        parts.append(f"{k}={_fmt_value(v)}")
    if suffix:
        parts.append(suffix)
    return " ".join(parts)


class EventLog:
    """Append-only JSONL sink with size-capped rotation: when the file
    passes ``max_bytes`` it is renamed to ``<path>.1`` (replacing any
    previous rotation) and a fresh file started — bounded disk for a
    long-lived service, and at least one full cap of history retained."""

    def __init__(self, path: str, max_bytes: int = 64 * 2**20):
        self.path = path
        self.max_bytes = max(1, int(max_bytes))
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # append: a restarted service continues the same log
        self._f = open(path, "a", encoding="utf-8")

    def write(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record, default=str, separators=(",", ":"))
        with self._lock:
            if self._f is None:
                return  # sink died (disk full / dir vanished): stay dead
            try:
                if self._f.tell() + len(line) + 1 > self.max_bytes:
                    self._rotate()
                self._f.write(line + "\n")
                self._f.flush()
            except (OSError, ValueError):
                # diagnostics must never take the service down with them;
                # ValueError = a write raced a failed rotation's closed
                # handle. The sink goes dead rather than raising out of
                # emit() on every later event.
                if self._f is not None:
                    try:
                        self._f.close()
                    except (OSError, ValueError):
                        pass
                self._f = None

    def _rotate(self) -> None:
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            # the rename failed (``.1`` is a directory, EPERM): KEEP the
            # history — the file grows past the cap (retried on the next
            # write) rather than truncating the only copy
            return
        self._f.close()
        try:
            self._f = open(self.path, "w", encoding="utf-8")
        except OSError:
            self._f = None  # a dead sink, not a crash
            raise

    def close(self) -> None:
        with self._lock:
            try:
                if self._f is not None:
                    self._f.close()
            except (OSError, ValueError):
                pass
            self._f = None


#: the process-wide sink (None = events go to the line only)
_sink: Optional[EventLog] = None


def configure_event_log(path: Optional[str], max_mb: float = 64.0) -> Optional[str]:
    """Install (or, with ``path=None``, remove) the process-wide JSONL
    sink; returns the path. Safe to call again: the previous sink is
    closed."""
    global _sink
    if _sink is not None:
        _sink.close()
        _sink = None
    if path:
        _sink = EventLog(path, max_bytes=int(max_mb * 2**20))
    return path


def event_log_path() -> Optional[str]:
    """The live sink's path (None when no event log is set)."""
    return _sink.path if _sink is not None else None


def _stderr(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def emit(
    subsystem: str,
    event: str,
    *,
    request_id: Optional[str] = None,
    log: Optional[Log] = None,
    suffix: str = "",
    bare_event: bool = False,
    text: Optional[str] = None,
    quiet: bool = False,
    **fields: Any,
) -> str:
    """Emit one event: the one-liner through ``log`` (stderr by default)
    plus a JSON record to the configured sink. Returns the rendered line.
    ``quiet=True`` skips the line (sink only), for per-request events
    that would flood stderr; without a sink a quiet emit is free."""
    sink = _sink
    if quiet and sink is None:
        return ""
    line = format_line(
        subsystem, event, fields,
        suffix=suffix, bare_event=bare_event, text=text,
    )
    if not quiet:
        (log or _stderr)(line)
    if sink is not None:
        record: Dict[str, Any] = {
            "ts": round(time.time(), 6),
            "subsystem": subsystem,
            "event": event,
        }
        if request_id is not None:
            record["request_id"] = request_id
        record.update(fields)
        if suffix:
            record["note"] = suffix
        if text is not None:
            record["text"] = text
        sink.write(record)
    return line
