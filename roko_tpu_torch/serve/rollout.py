"""Zero-downtime model rollout with a canary health gate and automatic
rollback (the port's copy of ``roko_tpu/serve/rollout.py``).

``python -m roko_tpu_torch rollout NAME`` (or ``POST /rollout`` on the
supervisor)
drives the fleet onto a registered model version ONE worker at a time,
riding the fleet's rolling-drain machinery: worker *i* leaves rotation
and drains its in-flight requests, restarts from the new version's
launch spec, must flip its own ``/healthz`` to 200 (its re-warm from the
version's kernel bundle), and must
then hold a contiguous ``bake_s`` healthy stretch before worker *i+1*
is touched — the fleet always has N-1 ready workers and clients never
see the swap (failover routing covers the one in motion).

The **canary gate** compares the new version's error rate and p99
against the incumbent's pre-rollout baseline (scraped from the same
per-worker ``/metrics`` the supervisor already aggregates). Regression
past ``rollback_error_pct`` / ``rollback_p99_x`` — or a restart storm
on the new bundle (the fleet's storm breaker, applied to versions: the
per-worker storm counter resets on a version change so only NEW-bundle
deaths count) — halts the rollout and rolls every completed worker back
to the incumbent, loudly (``ROKO_ROLLOUT event=rollback ...``).

Every state transition is journaled FIRST to an atomic, fsync'd
``rollout.json`` in the fleet runtime dir (the resume journal's tmp +
fsync + rename), so
a supervisor SIGKILLed mid-rollout can never leave a silently mixed
fleet: on restart, :func:`recover_rollout` reads the journal and either
**finalizes** (every worker had already rolled — only the journal
delete was lost) or **reverts** to the incumbent recorded in the
journal, with a loud ``ROKO_ROLLOUT event=recovered`` line either way.
Since a restarted supervisor spawns ALL workers from one chosen spec,
recovery is mixed-fleet-proof by construction — the journal's job is to
pick WHICH version, and to make the interruption loud.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.request
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from roko_tpu_torch.obs import events as obs_events
from roko_tpu_torch.resilience.journal import _fsync_write
from roko_tpu_torch.serve.fleet import (
    BOOT_VERSION,
    FAILED,
    READY,
    Fleet,
    WorkerHandle,
)

Log = Callable[[str], None]

_FORMAT = 1

#: terminal + live states rendered by the ``roko_rollout_state`` gauge
ROLLOUT_STATE_CODES = {
    "idle": 0,
    "done": 0,
    "rolled_back": 0,
    "rolling": 1,
    "rolling_back": 2,
    "failed": 3,  # rollback itself failed: fleet needs an operator
}


def _now_unix() -> int:
    return int(time.time())


# -- journal ------------------------------------------------------------------


class _StateFile:
    """One atomic JSON state record (tmp + fsync + rename): rewritten whole, read back tolerant of absence, loud on
    corruption. Shared by the rollout journal and the landed-version
    pointer so their crash-consistency discipline cannot drift."""

    #: ROKO_ROLLOUT event name emitted when the file is unreadable
    UNREADABLE_EVENT = "state_unreadable"
    #: what the caller will do about an unreadable file (log detail)
    UNREADABLE_ACTION = "ignore"

    def __init__(self, path: str):
        self.path = path

    def write(self, record: Dict[str, Any]) -> None:
        _fsync_write(
            self.path,
            json.dumps(dict(record, format=_FORMAT), sort_keys=True).encode(),
        )

    def load(self, log: Optional[Log] = None) -> Optional[Dict[str, Any]]:
        """The record, or None when there is none. An unreadable file
        is reported loudly and treated as absent — the caller's safe
        default (boot everything on its own incumbent spec) yields a
        uniform fleet either way."""
        try:
            with open(self.path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            if log is not None:
                obs_events.emit(
                    "rollout", self.UNREADABLE_EVENT, log=log,
                    path=self.path, error=repr(e),
                    action=self.UNREADABLE_ACTION,
                )
            return None

    def delete(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass


class RolloutJournal(_StateFile):
    """Atomic rollout state file (``<runtime_dir>/rollout.json``):
    rewritten BEFORE each state transition takes effect, deleted only
    once the fleet is uniformly on one version again. Presence = a
    rollout did not finish; contents = enough identity (model path,
    bundle dir, digest per side) to revert without the registry."""

    FILENAME = "rollout.json"
    UNREADABLE_EVENT = "journal_unreadable"
    UNREADABLE_ACTION = "revert_to_boot"


class CurrentVersionFile(_StateFile):
    """Durable pointer to the version a fleet LANDED on (atomic JSON in
    the runtime dir, same write discipline as the journal). Without it
    a plain supervisor restart — OOM kill, host reboot, systemd with
    the original argv — would silently re-boot the CLI-named incumbent
    after a completed rollout; with it the restart re-pins the landed
    version, loudly. Written by the controller on completion (and on a
    rollback to a previously landed version), removed when the fleet
    is back on the CLI incumbent."""

    FILENAME = "current-version.json"
    UNREADABLE_EVENT = "version_pin_unreadable"
    UNREADABLE_ACTION = "boot_incumbent"


def recover_rollout(
    journal: RolloutJournal, log: Log = print
) -> Optional[Dict[str, Any]]:
    """Startup half of crash consistency: decide what a restarted
    supervisor should do about a journaled, unfinished rollout.

    Returns ``None`` (no journal — boot normally) or
    ``{"action": "finalize"|"revert", "record": rec}``:

    - **finalize** — the interrupted rollout had already moved every
      worker (state ``rolling`` with all workers journaled done; only
      the completion mark was lost): boot the fleet on the TO version.
    - **revert** — anything else (mid-roll, mid-rollback, unknown):
      boot the fleet on the FROM version, restoring the incumbent
      digest on every worker.

    Either way the caller spawns ALL workers from the one chosen spec,
    so the fleet can never come back mixed; the loud ``ROKO_ROLLOUT``
    line is emitted here."""
    rec = journal.load(log)
    if rec is None:
        return None
    n = int(rec.get("workers", 0))
    done = sorted(set(rec.get("done", [])))
    if rec.get("state") == "rolling" and n and len(done) >= n:
        action = "finalize"
    else:
        action = "revert"
    frm = rec.get("from", {}) or {}
    to = rec.get("to", {}) or {}
    obs_events.emit(
        "rollout", "recovered", log=log,
        suffix="— an interrupted rollout was found; the fleet will boot "
        f"uniformly on {(to if action == 'finalize' else frm).get('version')!r}",
        state=rec.get("state"),
        **{"from": frm.get("version"), "to": to.get("version")},
        done=f"{done}/{n}", action=action,
    )
    return {"action": action, "record": rec}


# -- worker metrics scrape ----------------------------------------------------


@dataclass
class WorkerStats:
    """One worker's health numbers at a point in time, scraped from its
    own ``/metrics`` (lifetime-of-incarnation counters: a freshly
    rolled worker's numbers cover only the new version's traffic)."""

    requests: int
    errors: int
    p99_s: Optional[float]


def parse_worker_stats(text: str) -> WorkerStats:
    requests = errors = 0
    p99: Optional[float] = None
    for line in text.splitlines():
        if line.startswith("roko_serve_requests_total "):
            requests = int(float(line.split()[1]))
        elif line.startswith("roko_serve_errors_total "):
            errors = int(float(line.split()[1]))
        elif line.startswith('roko_serve_request_latency_seconds{quantile="0.99"} '):
            # the UNlabeled-by-size aggregate row only (size_class rows
            # carry a second label and don't match this prefix exactly)
            p99 = float(line.split()[1])
    return WorkerStats(requests=requests, errors=errors, p99_s=p99)


def scrape_worker(
    port: Optional[int], timeout_s: float
) -> Optional[WorkerStats]:
    if port is None:
        return None
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=timeout_s
        ) as r:
            return parse_worker_stats(r.read().decode())
    except OSError:
        return None


@dataclass
class Baseline:
    """The incumbent's pre-rollout health: aggregate error rate and the
    worst per-worker p99 across ready workers. ``error_pct`` is over
    lifetime counters (a regression gate, not a billing meter); a
    traffic-free fleet baselines at 0%/None and the gate then judges
    the canary on absolute thresholds alone."""

    error_pct: float
    p99_s: Optional[float]
    requests: int


def capture_baseline(fleet: Fleet, timeout_s: float) -> Baseline:
    req = err = 0
    p99s: List[float] = []
    for w in fleet.workers:
        if w.state != READY:
            continue
        stats = scrape_worker(w.port, timeout_s)
        if stats is None:
            continue
        req += stats.requests
        err += stats.errors
        if stats.p99_s is not None:
            p99s.append(stats.p99_s)
    return Baseline(
        error_pct=(100.0 * err / req) if req else 0.0,
        p99_s=max(p99s) if p99s else None,
        requests=req,
    )


# -- controller ---------------------------------------------------------------


class RolloutController:
    """One rollout (or its rollback), driven on its own thread.

    The controller owns the journal and the state machine; the fleet
    supplies the mechanics (``roll_worker``, supervision-maintained
    worker states, launch specs installed by the supervisor). Exactly
    one controller may be live per fleet (``fleet.rollout``)."""

    def __init__(
        self,
        fleet: Fleet,
        to_version: str,
        *,
        journal: RolloutJournal,
        bake_s: Optional[float] = None,
        rollback_error_pct: Optional[float] = None,
        rollback_p99_x: Optional[float] = None,
        ready_timeout_s: Optional[float] = None,
        log: Log = print,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        fc = fleet.fleet_cfg
        if not fleet.has_spec(to_version):
            raise ValueError(
                f"no launch spec installed for version {to_version!r}"
            )
        self.fleet = fleet
        self.journal = journal
        self.from_version = fleet.active_version
        self.to_version = to_version
        self.bake_s = fc.bake_s if bake_s is None else float(bake_s)
        self.rollback_error_pct = (
            fc.rollback_error_pct
            if rollback_error_pct is None
            else float(rollback_error_pct)
        )
        self.rollback_p99_x = (
            fc.rollback_p99_x
            if rollback_p99_x is None
            else float(rollback_p99_x)
        )
        self.ready_timeout_s = (
            fc.rollout_ready_timeout_s
            if ready_timeout_s is None
            else float(ready_timeout_s)
        )
        self._log = log
        self._clock = clock
        self._sleep = sleep
        self._poll_s = max(0.02, min(0.25, self.bake_s / 10 or 0.02))
        self.state = "idle"
        self.reason = ""
        self.done: List[int] = []
        self.started_unix: Optional[int] = None
        self.finished_unix: Optional[int] = None
        self.baseline: Optional[Baseline] = None
        #: durable pointer to the version the fleet LANDED on, kept in
        #: the same directory as the journal so a plain supervisor
        #: restart re-pins a completed rollout instead of silently
        #: re-booting the CLI incumbent
        self.current = CurrentVersionFile(
            os.path.join(
                os.path.dirname(journal.path), CurrentVersionFile.FILENAME
            )
        )
        self._thread: Optional[threading.Thread] = None

    # -- observation --------------------------------------------------------

    def state_code(self) -> int:
        return ROLLOUT_STATE_CODES.get(self.state, 3)

    def active(self) -> bool:
        return self.state in ("rolling", "rolling_back")

    def status(self) -> Dict[str, Any]:
        """The ``GET /rollout`` body."""
        return {
            "state": self.state,
            "from_version": self.from_version,
            "to_version": self.to_version,
            "workers": len(self.fleet.workers),
            "workers_done": sorted(self.done),
            "worker_versions": {
                str(w.id): w.version for w in self.fleet.workers
            },
            "reason": self.reason,
            "bake_s": self.bake_s,
            "rollback_error_pct": self.rollback_error_pct,
            "rollback_p99_x": self.rollback_p99_x,
            "baseline": (
                {
                    "error_pct": self.baseline.error_pct,
                    "p99_s": self.baseline.p99_s,
                    "requests": self.baseline.requests,
                }
                if self.baseline
                else None
            ),
            "started_unix": self.started_unix,
            "finished_unix": self.finished_unix,
        }

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        # state flips BEFORE the thread exists: the single-rollout 409
        # guard (and a fast-polling client) must never observe "idle"
        # on a controller that has been started
        self.state = "rolling"
        self._thread = threading.Thread(
            target=self.run, name="roko-rollout", daemon=True
        )
        self._thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def _side(self, version: str) -> Dict[str, Any]:
        meta = dict(self.fleet.launch_spec(version).meta)
        meta["version"] = version
        return meta

    def _record(self, state: str) -> Dict[str, Any]:
        return {
            "state": state,
            "from": self._side(self.from_version),
            "to": self._side(self.to_version),
            "done": sorted(self.done),
            "workers": len(self.fleet.workers),
            "reason": self.reason,
            "started_unix": self.started_unix,
        }

    def run(self) -> None:
        """The whole rollout, journal-first at every transition."""
        self.started_unix = _now_unix()
        self.state = "rolling"
        hb = self.fleet.fleet_cfg.heartbeat_timeout_s
        self.baseline = capture_baseline(self.fleet, hb)
        obs_events.emit(
            "rollout", "start", log=self._log,
            **{"from": self.from_version, "to": self.to_version},
            workers=len(self.fleet.workers),
            bake_s=f"{self.bake_s:g}",
            baseline_error_pct=f"{self.baseline.error_pct:.3f}",
            # pre-stringified: str(float) keeps the historical full
            # repr; emit's %.6g compaction would alter the bytes
            baseline_p99_s=(
                str(self.baseline.p99_s)
                if self.baseline.p99_s is not None else "n/a"
            ),
        )
        self.journal.write(self._record("rolling"))
        try:
            for w in self.fleet.workers:
                why = self._roll_one(w, self.to_version, gate=True)
                if why is not None:
                    self._rollback(why)
                    return
                self.done.append(w.id)
                self.journal.write(self._record("rolling"))
                obs_events.emit(
                    "rollout", "worker_done", log=self._log,
                    worker=w.id, version=self.to_version,
                    done=f"{len(self.done)}/{len(self.fleet.workers)}",
                )
            with self.fleet._lock:
                self.fleet.active_version = self.to_version
            self.state = "done"
            self.finished_unix = _now_unix()
            # pointer BEFORE the journal delete: every moment after the
            # rollout finished, a restarted supervisor finds either the
            # all-done journal (finalize) or the pointer — never a
            # silent revert to the CLI incumbent
            self.current.write(self._side(self.to_version))
            self.journal.delete()
            obs_events.emit(
                "rollout", "done", log=self._log,
                version=self.to_version, workers=len(self.done),
            )
        except Exception as e:  # defensive: never leave state unjournaled
            self._rollback(f"internal rollout error: {e!r}")

    # -- one worker ---------------------------------------------------------

    def _storm_reason(self, w: WorkerHandle, version: str) -> Optional[str]:
        threshold = max(1, self.fleet.fleet_cfg.storm_threshold)
        if w.version == version and (
            w.state == FAILED or w.attempt >= threshold
        ):
            return (
                f"restart storm on version {version!r} (worker {w.id}: "
                f"{max(w.attempt, threshold)} death(s) without a stable "
                "stretch)"
            )
        return None

    def _roll_one(
        self, w: WorkerHandle, version: str, *, gate: bool
    ) -> Optional[str]:
        """Drain-restart one worker onto ``version`` and wait it back
        to READY; with ``gate`` also hold the bake window and judge the
        canary. Returns None on success, else the rollback reason."""
        obs_events.emit(
            "rollout", "roll", log=self._log,
            worker=w.id, **{"from": w.version, "to": version},
        )
        try:
            self.fleet.roll_worker(w, version)
        except (RuntimeError, ValueError, OSError) as e:
            # OSError: Popen itself failed (fork EAGAIN, bad argv) —
            # must surface as a rollback reason, never kill the
            # controller thread mid-rollback
            return f"could not restart worker {w.id}: {e}"
        deadline = self._clock() + self.ready_timeout_s
        while True:
            if self.fleet._draining:
                return "fleet draining"
            storm = self._storm_reason(w, version)
            if storm is not None:
                return storm
            if w.state == READY and w.version == version:
                break
            if self._clock() > deadline:
                return (
                    f"worker {w.id} not ready on {version!r} within "
                    f"{self.ready_timeout_s:.0f}s (state {w.state})"
                )
            self._sleep(self._poll_s)
        if not gate:
            return None
        return self._bake(w, version)

    def _bake(self, w: WorkerHandle, version: str) -> Optional[str]:
        """Hold worker ``w`` under observation until it has served a
        CONTIGUOUS ``bake_s`` healthy stretch on ``version``; judge the
        canary gate over that stretch. Leaving rotation resets the
        stretch (the storm breaker bounds how often that may happen)."""
        hb = self.fleet.fleet_cfg.heartbeat_timeout_s
        budget = self._clock() + self.ready_timeout_s + self.bake_s
        stretch_start: Optional[float] = self._clock()
        start = scrape_worker(w.port, hb)
        while True:
            if self.fleet._draining:
                return "fleet draining"
            storm = self._storm_reason(w, version)
            if storm is not None:
                return storm
            if self._clock() > budget:
                return (
                    f"worker {w.id} never held a {self.bake_s:g}s healthy "
                    f"stretch on {version!r}"
                )
            if w.state != READY:
                stretch_start = None
            elif stretch_start is None:
                stretch_start = self._clock()
                start = scrape_worker(w.port, hb)
            elif self._clock() - stretch_start >= self.bake_s:
                break
            self._sleep(self._poll_s)
        end = scrape_worker(w.port, hb)
        return self._gate_verdict(w, start, end)

    def _gate_verdict(
        self,
        w: WorkerHandle,
        start: Optional[WorkerStats],
        end: Optional[WorkerStats],
    ) -> Optional[str]:
        """Canary judgement over the bake window. No traffic during the
        bake (or unscrapeable metrics on a worker the health probe says
        is READY) passes on health alone — the gate detects regressions
        it can observe, it does not manufacture them."""
        base = self.baseline or Baseline(0.0, None, 0)
        if start is None or end is None:
            obs_events.emit(
                "rollout", "gate", log=self._log,
                suffix="(health gate only)",
                worker=w.id, verdict="pass", detail="metrics_unscrapeable",
            )
            return None
        d_req = max(0, end.requests - start.requests)
        d_err = max(0, end.errors - start.errors)
        if d_req > 0:
            err_pct = 100.0 * d_err / d_req
            if (
                err_pct > self.rollback_error_pct
                and err_pct > base.error_pct
            ):
                return (
                    f"canary error rate {err_pct:.2f}% over {d_req} "
                    f"request(s) exceeds rollback_error_pct="
                    f"{self.rollback_error_pct:g}% (baseline "
                    f"{base.error_pct:.2f}%)"
                )
        if (
            end.p99_s is not None
            and base.p99_s
            and end.p99_s > self.rollback_p99_x * base.p99_s
        ):
            return (
                f"canary p99 {end.p99_s * 1e3:.1f}ms exceeds "
                f"rollback_p99_x={self.rollback_p99_x:g} x baseline "
                f"{base.p99_s * 1e3:.1f}ms"
            )
        obs_events.emit(
            "rollout", "gate", log=self._log,
            worker=w.id, verdict="pass", requests=d_req, errors=d_err,
            p99_s=str(end.p99_s) if end.p99_s is not None else "n/a",
        )
        return None

    # -- rollback -----------------------------------------------------------

    def _rollback(self, reason: str) -> None:
        self.state = "rolling_back"
        self.reason = reason
        obs_events.emit(
            "rollout", "rollback", log=self._log,
            **{"from": self.to_version, "to": self.from_version},
            reason=repr(reason),
        )
        self.journal.write(self._record("rolling_back"))
        for w in self.fleet.workers:
            if w.version != self.to_version and (
                w.target_version != self.to_version
            ):
                continue
            if self.fleet._draining:
                # the fleet is going down anyway; the journal survives
                # and the next start reverts the rest
                self.state = "failed"
                obs_events.emit(
                    "rollout", "rollback_interrupted", log=self._log,
                    suffix="(journal kept)", reason="fleet_draining",
                )
                return
            why = self._roll_one(w, self.from_version, gate=False)
            if why is not None:
                # the INCUMBENT will not come back either: degraded
                # fleet, operator problem — keep the journal as the
                # record of the mixed state and scream
                self.state = "failed"
                self.finished_unix = _now_unix()
                self.journal.write(self._record("rolling_back"))
                obs_events.emit(
                    "rollout", "rollback_failed", log=self._log,
                    suffix="— fleet left degraded, journal kept at "
                    f"{self.journal.path}",
                    worker=w.id, reason=repr(why),
                )
                return
        self.state = "rolled_back"
        self.finished_unix = _now_unix()
        # the fleet is back on from_version: re-pin it (or drop the
        # pointer when that IS the CLI incumbent)
        if self.from_version == BOOT_VERSION:
            self.current.delete()
        else:
            self.current.write(self._side(self.from_version))
        self.journal.delete()
        obs_events.emit(
            "rollout", "rolled_back", log=self._log,
            suffix="— incumbent restored on every worker",
            version=self.from_version,
        )
