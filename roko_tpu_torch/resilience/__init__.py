"""Failure handling of the port's host side (copies of
``roko_tpu/resilience``): bounded retries of region jobs (``retry``),
hard deadlines around device calls (``watchdog``) and the streaming
polish's resume journal (``journal``). The batching plane's circuit
breaker waits for the HTTP service (queue item A9.4). Pure Python: none
of it imports torch."""

from roko_tpu_torch.resilience.journal import JournalMismatch, PolishJournal
from roko_tpu_torch.resilience.retry import RetryPolicy
from roko_tpu_torch.resilience.watchdog import (
    DeadlinePolicy,
    HangError,
    call_with_deadline,
    dump_thread_stacks,
)

__all__ = [
    "DeadlinePolicy",
    "HangError",
    "JournalMismatch",
    "PolishJournal",
    "RetryPolicy",
    "call_with_deadline",
    "dump_thread_stacks",
]
