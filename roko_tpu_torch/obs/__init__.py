"""Observability of the port's host side: the one-line event format and
its JSONL sink (``events``), request-scoped tracing (``trace``) and
mergeable latency histograms (``hist``)."""
