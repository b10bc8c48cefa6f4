"""Device watchdog: hard deadlines around calls that can hang forever
(the port's copy of ``roko_tpu/resilience/watchdog.py``).

A device can answer its first query and then never return from a
kernel build or a launch. In-process there is no way to
interrupt that call — Python cannot kill a thread stuck in native code —
so the only survivable shape is to make the *caller* expendable: run the
hazardous call on a sacrificial daemon thread, wait with a deadline, and
when it expires dump every thread's stack, emit one machine-parseable
diagnostic line, and raise :class:`HangError` from the (still healthy)
watching thread. The stuck thread is abandoned; being a daemon it cannot
block interpreter exit. The error then propagates to a loud nonzero
exit — never a silent infinite hang. (The JAX package can instead fail
over to a host-CPU predict; the port refuses that: it would hide the
card.)

The diagnostic line is grep-stable::

    ROKO_WATCHDOG hang stage=<name> deadline_s=<d> threads=<n>

followed by the full ``sys._current_frames`` stack dump, so a wedged
production run leaves enough post-mortem in its log to see exactly which
frame never returned.
"""

from __future__ import annotations

import sys
import threading
import traceback
from typing import Any, Callable, Optional

from roko_tpu_torch.obs import events as obs_events

Log = Callable[[str], None]


class HangError(RuntimeError):
    """A watched call blew its deadline. The offending call is still
    running on an abandoned daemon thread; the device behind it must be
    presumed wedged."""

    def __init__(self, stage: str, deadline_s: float):
        super().__init__(
            f"{stage!r} still running after its {deadline_s:g}s deadline; "
            "device presumed hung (thread stacks dumped to the log)"
        )
        self.stage = stage
        self.deadline_s = deadline_s


def dump_thread_stacks(skip_current: bool = False) -> str:
    """Every live thread's stack, rendered for the log — the post-mortem
    payload behind the one-line diagnostic (``sys._current_frames`` is
    the same source ``faulthandler`` reads, but this string can go
    through a ``log`` callable instead of straight to a real fd)."""
    names = {t.ident: t for t in threading.enumerate()}
    current = threading.get_ident()
    chunks = []
    for ident, frame in sorted(sys._current_frames().items()):
        if skip_current and ident == current:
            continue
        t = names.get(ident)
        label = t.name if t is not None else "?"
        daemon = " daemon" if t is not None and t.daemon else ""
        chunks.append(
            f"--- thread {label} (ident={ident}{daemon}) ---\n"
            + "".join(traceback.format_stack(frame))
        )
    return "".join(chunks).rstrip()


def thread_stack(thread: threading.Thread) -> str:
    """One live thread's current stack (empty string when the thread is
    gone) — for "I am abandoning this stuck thread" log warnings."""
    frame = sys._current_frames().get(thread.ident)
    if frame is None:
        return ""
    return "".join(traceback.format_stack(frame)).rstrip()


class DeadlinePolicy:
    """Split watchdog budgets: compile-grade vs predict-grade.

    The first watched call for a given key (in practice the padded batch
    size) may legitimately include a cold build — on the card, the
    first launch of each kernel builds it with nvcc — which can take
    minutes where steady-state predicts take milliseconds; under a
    single budget a cold build either
    trips the watchdog (compile masquerading as a device hang) or forces
    the predict deadline so high it stops protecting anything. This
    policy hands the FIRST call per key ``compile_deadline_s`` and every
    later call ``predict_deadline_s`` (``ResilienceConfig`` carries
    both). Thread-safe — parallel warmup probes rungs concurrently."""

    def __init__(
        self, predict_deadline_s: float, compile_deadline_s: Optional[float] = None
    ):
        self.predict_deadline_s = predict_deadline_s
        self.compile_deadline_s = (
            predict_deadline_s if compile_deadline_s is None else compile_deadline_s
        )
        self._seen: set = set()
        self._lock = threading.Lock()

    def deadline_for(self, key: Any) -> "tuple[float, bool]":
        """(budget seconds, is_first_call). Marks the key seen, so the
        compile budget is spent exactly once per key."""
        with self._lock:
            first = key not in self._seen
            self._seen.add(key)
        return (self.compile_deadline_s if first else self.predict_deadline_s), first

    def forget(self, key: Any) -> None:
        """Re-arm the compile budget for ``key``. Called when a FIRST
        dispatch fails — the failure means the first call's one-time work
        (on the card, building the kernels) did not finish, so the retry
        must redo it and would otherwise be judged by the tight predict
        deadline, recreating the build-masquerading-as-hang problem this
        class exists to fix."""
        with self._lock:
            self._seen.discard(key)

    def is_warm(self, key: Any) -> bool:
        with self._lock:
            return key in self._seen


def call_with_deadline(
    fn: Callable[[], Any],
    deadline_s: float,
    *,
    stage: str = "call",
    log: Optional[Log] = None,
) -> Any:
    """Run ``fn()`` under a hard deadline.

    ``deadline_s <= 0`` disables the watchdog (``fn`` runs inline on the
    calling thread — zero overhead, zero protection). Otherwise ``fn``
    runs on a sacrificial daemon thread; on expiry the diagnostic line
    plus all thread stacks go to ``log`` and :class:`HangError` raises
    in the caller. An exception raised by ``fn`` itself re-raises here
    unchanged (with its original traceback attached).
    """
    if deadline_s <= 0:
        return fn()
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    box: dict = {}
    done = threading.Event()

    def run() -> None:
        try:
            box["value"] = fn()
        except BaseException as e:
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(
        target=run, name=f"roko-watchdog-{stage}", daemon=True
    )
    t.start()
    if not done.wait(deadline_s):
        # the one-liner goes through the event plane so a configured
        # --event-log sink records the hang as data too; the full stack
        # dump stays log-only (it is a post-mortem blob, not an event)
        obs_events.emit(
            "watchdog", "hang", log=log, bare_event=True,
            stage=stage, deadline_s=deadline_s,
            threads=threading.active_count(),
        )
        log(dump_thread_stacks(skip_current=True))
        raise HangError(stage, deadline_s)
    if "error" in box:
        raise box["error"]
    return box["value"]
