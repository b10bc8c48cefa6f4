"""The one-line event format behind every ``ROKO_*`` line (the port's
copy of ``roko_tpu/obs/events.py``): ``ROKO_<SUBSYSTEM> event=<event>
k=v ...``, floats compacted to ``%.6g``, keys in call-site order. The
JAX package also appends each event to an optional JSONL sink
(``--event-log``); the port has no such flag yet, so it writes the line
only."""

from __future__ import annotations

import sys
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


def _stderr(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def emit(
    subsystem: str,
    event: str,
    *,
    log: Optional[Log] = None,
    suffix: str = "",
    bare_event: bool = False,
    text: Optional[str] = None,
    **fields: Any,
) -> str:
    """Emit one event: the one-liner through ``log`` (stderr by
    default). Returns the rendered line."""
    line = format_line(
        subsystem, event, fields,
        suffix=suffix, bare_event=bare_event, text=text,
    )
    (log or _stderr)(line)
    return line
