"""Worker fleet: process supervision and failover routing for the
multi-worker serving tier (the port's copy of ``roko_tpu/serve/fleet.py``).

One :class:`Fleet` owns N workers, each a full ``python -m
roko_tpu_torch serve`` stack (warm PolishSession, batcher, HTTP) pinned
to a slice of the cards by ``CUDA_VISIBLE_DEVICES``
(``parallel.mesh.fleet_worker_env``), or sharing them, and loading one
kernel bundle. A worker whose slice holds k cards is k processes, the
ranks of one session under ``ROKO_*`` (``parallel.mesh.
fleet_worker_rank_envs``, a fresh coordinator port each start): rank 0
binds the worker's port and announces it once every rank has joined, the
others follow its dispatches. The worker lives and dies as one: any
rank's exit is the worker's death, the rest of its ranks are killed
(followers of a dead leader would block in a receive for ever, a leader
without a follower fails its next dispatch), and the restart starts all
k. The fleet's job is to make worker failure a latency event, never a
correctness or availability event:

- **liveness** — every worker is heartbeat-probed on ``/healthz``
  (``FleetConfig.heartbeat_interval_s``); any answer — 200 ready, 503
  warming/draining/breaker-open — proves the process alive, but only a
  200 keeps it in rotation. ``heartbeat_misses`` consecutive
  *unanswered* probes declare it hung.
- **supervision** — a crashed worker (``waitpid`` via ``Popen.poll`` of
  every rank, each tick, so a follower that dies while the worker is
  idle is seen at once, not at the next dispatch) or a hung one
  (SIGTERM, then SIGKILL after ``term_grace_s``) is restarted under the
  shared :class:`~roko_tpu_torch.resilience.RetryPolicy`
  exponential-backoff shape, guarded by a per-worker restart-storm
  :class:`~roko_tpu_torch.resilience.CircuitBreaker`: ``storm_threshold``
  restarts without a ``stable_after_s`` healthy stretch mark the worker
  FAILED and the fleet degrades (serves on the survivors) instead of
  flapping; after ``storm_reset_s`` one half-open probe restart is
  admitted.
- **failover** — :meth:`Fleet.post_polish` routes a request to a ready
  worker; a connection-level failure (the worker died or was killed
  mid-request) transparently re-dispatches to another ready worker —
  polish is deterministic and idempotent, so clients observe latency,
  not errors. Worker 503s (busy/warming) try the next worker once each
  before surfacing as a fleet 503 with the largest ``Retry-After``
  seen.
- **restart re-warm** — a restarted worker re-enters rotation only
  after its own warmup flips ``/healthz`` to 200 (the bundle's
  libraries when one is configured; binds-first/warming-503 semantics
  from ``serve/server.py``).

The supervisor front end (``serve/supervisor.py``) puts the HTTP
surface over this class; tests drive it directly with stub worker
processes, so the supervision machinery is covered by real
kill/restart/waitpid paths without paying a torch import per worker.
Pure Python: nothing here imports torch, so the supervisor never touches
the card its workers use.
"""

from __future__ import annotations

import collections
import http.client
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from roko_tpu_torch.config import FleetConfig, RokoConfig
from roko_tpu_torch.obs import events as obs_events
from roko_tpu_torch.obs.hist import (
    merge_histogram_rows,
    parse_histogram_rows,
    render_histogram_rows,
)
from roko_tpu_torch.resilience import CircuitBreaker, RetryPolicy
from roko_tpu_torch.serve.httpbase import REQUEST_TIMEOUT_S, write_announce  # noqa: F401
from roko_tpu_torch.serve.metrics import (
    HISTOGRAM_SERIES,
    LABELED_SERIES,
    parse_labeled_rows,
    parse_metric_values,
)

# worker lifecycle states (rendered in /healthz and the
# roko_fleet_worker_state gauge)
STARTING = "starting"    # spawned, port not yet announced
WARMING = "warming"      # bound, ladder still compiling (healthz 503)
READY = "ready"          # in rotation
UNHEALTHY = "unhealthy"  # alive but out of rotation (breaker tripped)
DRAINING = "draining"    # worker reports draining (rolling restart)
DEAD = "dead"            # process gone; restart scheduled
FAILED = "failed"        # restart-storm breaker open; not restarting
STOPPED = "stopped"      # deliberately terminated (fleet drain)

#: gauge encoding for roko_fleet_worker_state
STATE_CODES = {
    READY: 0, WARMING: 1, STARTING: 1, UNHEALTHY: 2, DRAINING: 3,
    DEAD: 4, FAILED: 5, STOPPED: 6,
}

#: worker series re-exported at the front end labeled by worker id
#: (breaker + compile-cache gauges, plus the continuous scheduler's
#: occupancy/padding series so fleet dashboards see per-worker packing
#: density — docs/SERVING.md "Continuous batching")
PASSTHROUGH_SERIES = (
    ("roko_serve_breaker_state", "gauge"),
    ("roko_serve_breaker_trips_total", "counter"),
    ("roko_serve_padding_efficiency", "gauge"),
    ("roko_serve_fill_windows_total", "counter"),
    ("roko_serve_fill_padded_total", "counter"),
    ("roko_serve_queue_windows", "gauge"),
    ("roko_serve_scheduler_occupancy", "gauge"),
    ("roko_compile_cache_hits", "counter"),
    ("roko_compile_cache_misses", "counter"),
    ("roko_serve_cascade_windows_total", "counter"),
    ("roko_serve_cascade_escalated_total", "counter"),
    ("roko_serve_cascade_cache_hits_total", "counter"),
)

#: connection-level failures that mean "this worker did not answer" —
#: the failover trigger (a dead/killed worker mid-request lands here)
_CONN_ERRORS = (OSError, http.client.HTTPException)

#: version label of the launch spec a fleet boots with, before any
#: rollout has installed a registry-named one (docs/SERVING.md
#: "Model lifecycle")
BOOT_VERSION = "boot"

#: the program of a fleet's process-group leader (``Fleet(own_process_group
#: =True)``): it holds the group open for the workers to join, and when its
#: standard input reaches its end (the fleet's process exited or was
#: killed) it drains the group with SIGTERM, waits ``argv[1]`` seconds and
#: kills it, itself included
_GROUP_LEADER = (
    "import os, signal, sys, time\n"
    "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
    "signal.signal(signal.SIGINT, signal.SIG_IGN)\n"
    "sys.stdin.buffer.read()\n"
    "os.killpg(0, signal.SIGTERM)\n"
    "time.sleep(float(sys.argv[1]))\n"
    "os.killpg(0, signal.SIGKILL)\n"
)


_ports_lock = threading.Lock()
#: coordinator ports this process handed out lately: none is handed twice
#: while it may still be bound
_recent_ports: "collections.deque[int]" = collections.deque(maxlen=256)


def free_coordinator(host: str = "127.0.0.1") -> str:
    """``host:port`` of a free loopback port for a worker's session
    coordinator (rank 0's store binds it), never one handed out lately by
    this process: two workers starting at once, or a restart while the
    last incarnation's port lingers, never race for one port. A port taken
    by another program in between hangs that start only until the spawn
    deadline kills it, and the restart draws a fresh one."""
    with _ports_lock:
        for _ in range(64):
            with socket.socket() as sock:
                sock.bind((host, 0))
                port = sock.getsockname()[1]
            if port not in _recent_ports:
                _recent_ports.append(port)
                return f"{host}:{port}"
    raise OSError("no free loopback port for a worker's session coordinator")


class WorkerLaunchSpec:
    """Everything that determines WHICH program a spawned worker runs:
    the argv builder (model path + per-version worker config, so the
    kernel bundle rides inside; ``command(worker_id, announce_path)``, the
    path None for a follower rank, which binds nothing), the env overlay
    (device pinning), ``ranks(worker_id)`` (one overlay a rank of the
    worker's session, rank 0 first; default one rank with ``env``), and
    the version label it serves under. Initial spawn, crash restart, and
    rollout all resolve a worker's launch through ONE spec
    (``Fleet._spawn``), so the three paths cannot drift on which
    bundle/params a worker gets.

    ``meta`` carries operator-facing identity (bundle digest, model
    path) for the rollout journal and logs — the spec itself is the
    source of truth for what actually launches."""

    def __init__(
        self,
        command: Callable[[int, str], List[str]],
        *,
        env: Optional[Callable[[int], Dict[str, str]]] = None,
        ranks: Optional[Callable[[int], List[Dict[str, str]]]] = None,
        version: str = BOOT_VERSION,
        meta: Optional[Dict[str, object]] = None,
    ):
        self.command = command
        self.env = env or (lambda wid: {})
        self.ranks = ranks or (lambda wid: [self.env(wid)])
        self.version = version
        self.meta: Dict[str, object] = dict(meta or {})


def _wait_all(procs: Sequence[subprocess.Popen], seconds: float) -> None:
    """Wait until every process in ``procs`` has exited or ``seconds``
    have passed."""
    deadline = time.monotonic() + seconds
    for p in procs:
        try:
            p.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            return


def _tail(path: str, n: int = 2000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - n))
            return f.read().decode(errors="replace")
    except OSError:
        return "(no worker log)"


class WorkerHandle:
    """One supervised worker: the Popen of each of its ranks (rank 0
    first), rank 0's announced port, lifecycle state, heartbeat
    bookkeeping, and restart-storm breaker."""

    def __init__(self, wid: int, runtime_dir: str, cfg: FleetConfig):
        self.id = wid
        self._cfg = cfg
        self.announce_path = os.path.join(
            runtime_dir, f"worker-{wid}.announce.json"
        )
        self.log_path = os.path.join(runtime_dir, f"worker-{wid}.log")
        #: this incarnation's processes, rank 0 (the one that binds) first
        self.procs: List[subprocess.Popen] = []
        self.port: Optional[int] = None
        self.state = DEAD
        self.spawned_at = 0.0
        self.restart_at = 0.0   # monotonic time the next restart is due
        self.restarts = 0       # lifetime respawn count (metrics)
        self.attempt = 0        # consecutive deaths w/o a stable stretch
        self.misses = 0         # consecutive unanswered heartbeats
        self.ready_since = 0.0
        self.stable = False     # this incarnation survived stable_after_s
        #: model version this incarnation runs / the next spawn targets
        #: (rollout moves target_version, _spawn follows it)
        self.version = BOOT_VERSION
        self.target_version = BOOT_VERSION
        #: True while a rollout is deliberately restarting this worker —
        #: the supervision loop leaves held workers alone so the planned
        #: restart is not double-handled as a crash
        self.hold = False
        #: last Retry-After hint this worker reported in /healthz (the
        #: live backlog/throughput estimate); None until it
        #: answers a probe
        self.retry_hint: Optional[float] = None
        #: live queue depth (windows) from the last answered /healthz —
        #: the autoscaler's backlog signal
        self.queue_windows: Optional[int] = None
        #: per-tenant {"backlog_windows", "retry_after_s"} hints from
        #: the last answered /healthz (multi-tenant 429/503 sizing)
        self.tenant_hints: Dict[str, Dict[str, float]] = {}
        #: restart-storm breaker: record_failure per death, record_success
        #: once stable; OPEN = stop restarting (fleet degrades), half-open
        #: after storm_reset_s admits exactly one probe restart
        self.storm = CircuitBreaker(
            failure_threshold=max(1, cfg.storm_threshold),
            reset_s=cfg.storm_reset_s,
        )

    def reset_regime(self) -> None:
        """Fresh restart-storm history: a version change is a new
        regime — deaths under the old bundle must not pre-charge the
        new bundle's breaker (nor vice versa: the rollback trigger
        counts NEW-bundle deaths only)."""
        self.attempt = 0
        self.stable = False
        self.storm = CircuitBreaker(
            failure_threshold=max(1, self._cfg.storm_threshold),
            reset_s=self._cfg.storm_reset_s,
        )

    @property
    def proc(self) -> Optional[subprocess.Popen]:
        """Rank 0's process: the one that binds, drains and announces."""
        return self.procs[0] if self.procs else None

    def alive(self) -> bool:
        """Every rank runs: a worker missing one is dead."""
        return bool(self.procs) and all(p.poll() is None for p in self.procs)

    def exited(self) -> Optional[Tuple[int, int]]:
        """``(rank, exit code)`` of the first rank that has exited, or None."""
        for r, p in enumerate(self.procs):
            rc = p.poll()
            if rc is not None:
                return r, rc
        return None


class Fleet:
    """Spawn, supervise, and route across N worker processes.

    ``worker_command(worker_id, announce_path) -> argv`` builds each
    worker's command line (the supervisor builds a ``python -m roko_tpu_torch serve``
    invocation; tests substitute a stdlib stub worker), and
    ``worker_env(worker_id) -> dict`` the per-worker environment overlay
    (device-slice pinning by default).

    With ``own_process_group`` the workers run in a process group of
    their own, led by a small process (:data:`_GROUP_LEADER`) that
    outlives nothing of the fleet: :meth:`stop` drains the workers and
    then kills the group, and should this process die without a stop
    (SIGKILL, the OOM killer) the leader drains and kills the group
    itself, so no worker is left holding the card."""

    def __init__(
        self,
        cfg: RokoConfig,
        worker_command: Callable[[int, str], List[str]],
        *,
        worker_env: Optional[Callable[[int], Dict[str, str]]] = None,
        runtime_dir: Optional[str] = None,
        log: Callable[[str], None] = print,
        clock: Callable[[], float] = time.monotonic,
        own_process_group: bool = False,
    ):
        self.cfg = cfg
        fc = cfg.fleet
        if fc.workers < 1:
            raise ValueError("FleetConfig.workers must be >= 1 for a fleet")
        self.fleet_cfg = fc
        #: launch specs by version label; every spawn resolves through
        #: one of these (docs/SERVING.md "Model lifecycle"). The
        #: constructor's command/env pair becomes the BOOT spec;
        #: rollouts install more via add_launch_spec.
        self._specs: Dict[str, WorkerLaunchSpec] = {
            BOOT_VERSION: WorkerLaunchSpec(
                worker_command, env=worker_env, version=BOOT_VERSION
            )
        }
        self.active_version = BOOT_VERSION
        #: the live RolloutController when a rollout is running or has
        #: run (supervisor wires it; metrics render its state)
        self.rollout = None
        self._log = log
        self._clock = clock
        self.runtime_dir = (
            runtime_dir
            or fc.runtime_dir
            or os.path.join(
                tempfile.gettempdir(), f"roko-fleet-{os.getpid()}"
            )
        )
        #: removed on a CLEAN stop only — a wedged run leaves the worker
        #: logs behind for the CI failure dump to collect
        self._own_runtime_dir = runtime_dir is None and fc.runtime_dir is None
        self.workers = [
            WorkerHandle(i, self.runtime_dir, fc) for i in range(fc.workers)
        ]
        self.restart_policy = RetryPolicy(
            base_delay_s=fc.restart_base_delay_s,
            max_delay_s=fc.restart_max_delay_s,
            jitter=0.1,
        )
        self.max_inflight = fc.max_inflight or (
            fc.workers * cfg.serve.max_queue
        )
        self._lock = threading.RLock()
        self._rr = 0
        #: ids of workers still drain-terminating off the routing path —
        #: scale-up must not re-mint such an id while its announce file
        #: and device slice may still be live
        self._retiring: set = set()
        #: the autoscaler's park flag for background jobs while interactive
        #: backlog spikes: a distributed polish job dispatches no new unit
        #: while it is set (pipeline/distpolish.py); rendered as
        #: roko_fleet_jobs_parked
        self.jobs_parked = False
        #: the distributed polish job running, or last run, over this fleet
        #: (pipeline/distpolish.py; GET /jobz reads its snapshot)
        self.job = None
        self._counters = {"restarts": 0, "failovers": 0,
                          "requests": 0, "rejected": 0,
                          "scale_ups": 0, "scale_downs": 0}
        self._stop = threading.Event()
        self._draining = False
        self._drain_done = threading.Event()
        self._own_process_group = own_process_group
        #: the group leader's Popen while the fleet runs in a group of its
        #: own; its pid is the group's id
        self._leader: Optional[subprocess.Popen] = None
        self._thread: Optional[threading.Thread] = None

    # -- launch specs -------------------------------------------------------

    def _spec_live(self, version: str) -> bool:
        # caller holds self._lock
        return version in self._specs and any(
            w.version == version or w.target_version == version
            for w in self.workers
        )

    def spec_installable(self, version: str) -> bool:
        """True when :meth:`add_launch_spec` would accept ``version`` —
        the rollout starter checks this BEFORE building a spec, because
        building one writes the per-version worker config to disk and a
        refused swap must not have already changed what a live worker's
        next crash-restart would run."""
        with self._lock:
            return not self._spec_live(version)

    def add_launch_spec(self, spec: WorkerLaunchSpec) -> None:
        """Register a version's launch spec so rollout / restart can
        spawn workers onto it. Replacing the spec of a version workers
        currently run is refused — that is exactly the silent-drift this
        indirection exists to prevent (register a new version instead)."""
        with self._lock:
            if self._spec_live(spec.version):
                raise ValueError(
                    f"launch spec {spec.version!r} is live on the fleet; "
                    "refusing to swap it underneath running workers"
                )
            self._specs[spec.version] = spec

    def install_boot_spec(self, spec: WorkerLaunchSpec) -> None:
        """Replace the constructor's placeholder boot spec BEFORE
        ``start()`` — the supervisor can only build the real one (whose
        per-version worker config lives in the runtime dir) after the
        runtime dir exists, and rollout recovery may boot a different
        version than the CLI named."""
        with self._lock:
            if any(w.alive() for w in self.workers):
                raise RuntimeError(
                    "install_boot_spec must run before the fleet starts"
                )
            self._specs = {spec.version: spec}
            self.active_version = spec.version
            for w in self.workers:
                w.version = w.target_version = spec.version

    def launch_spec(self, version: Optional[str] = None) -> WorkerLaunchSpec:
        with self._lock:
            return self._specs[version or self.active_version]

    def has_spec(self, version: str) -> bool:
        with self._lock:
            return version in self._specs

    # -- counters -----------------------------------------------------------

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name] += by

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters[name]

    @property
    def process_group(self) -> Optional[int]:
        """The id of the workers' own process group, while there is one."""
        return None if self._leader is None else self._leader.pid

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        """Spawn every worker and start the supervision thread."""
        os.makedirs(self.runtime_dir, exist_ok=True)
        if self._own_process_group and self._leader is None:
            grace = self.cfg.resilience.drain_deadline_s + self.fleet_cfg.term_grace_s
            self._leader = subprocess.Popen(
                [sys.executable, "-c", _GROUP_LEADER, str(grace)],
                stdin=subprocess.PIPE, process_group=0)
        now = self._clock()
        for w in self.workers:
            self._spawn(w, now)
        self._thread = threading.Thread(
            target=self._supervise, name="roko-fleet-supervise", daemon=True
        )
        self._thread.start()

    def _spawn(self, w: WorkerHandle, now: float) -> None:
        # no rank of an earlier incarnation may outlive it
        self._kill_ranks(w)
        try:
            os.unlink(w.announce_path)
        except OSError:
            pass
        # THE one resolution point for what a worker runs: initial
        # spawn, crash restart, and rollout all land here, and all read
        # the worker's target version's launch spec — argv (model path +
        # per-version config carrying the bundle) and env overlay both
        spec = self.launch_spec(w.target_version)
        if spec.version != w.version:
            w.reset_regime()  # storm history belongs to the old bundle
        w.version = spec.version
        overlays = spec.ranks(w.id)
        # append: across restarts one log per worker slot keeps the
        # whole crash history (every rank's) in a single CI-dumpable file
        logf = open(w.log_path, "ab", buffering=0)
        procs: List[subprocess.Popen] = []
        try:
            logf.write(
                f"\n--- spawn worker {w.id} (restart {w.restarts}, "
                f"version {spec.version}, {len(overlays)} rank(s)) ---\n".encode()
            )
            for rank, overlay in enumerate(overlays):
                env = dict(os.environ)
                env.update(overlay)
                env["ROKO_WORKER_ID"] = str(w.id)
                # the worker's model-lane identity: labels its latency
                # histograms and arms the X-Roko-Model pin guard server-side
                env["ROKO_MODEL_VERSION"] = spec.version
                procs.append(subprocess.Popen(
                    spec.command(w.id, w.announce_path if rank == 0 else None),
                    stdout=logf,
                    stderr=subprocess.STDOUT,
                    env=env,
                    **({} if self._leader is None else {"process_group": self._leader.pid}),
                ))
        except BaseException:
            # a worker runs with all k ranks or not at all
            for p in procs:
                p.kill()
                p.wait()
            raise
        finally:
            logf.close()  # the children keep their own copy of the fd
        w.procs = procs
        w.state = STARTING
        w.spawned_at = now
        w.port = None
        w.misses = 0
        w.stable = False
        # a dead incarnation's backlog estimate must not inflate
        # front-end 503s (live_retry_after_s takes the fleet MAX)
        w.retry_hint = None
        w.queue_windows = None
        w.tenant_hints = {}

    def roll_worker(self, w: WorkerHandle, version: str) -> None:
        """Deliberate restart of ONE worker onto ``version`` (the
        rollout path, docs/SERVING.md "Model lifecycle"): the worker
        leaves rotation (DRAINING), gets SIGTERM — it finishes its own
        in-flight requests under the drain deadline — then respawns
        immediately from the new version's launch spec. ``hold`` keeps
        the supervision loop from double-handling the planned death as
        a crash; it resumes tracking the fresh incarnation (warming →
        ready) the moment the spawn lands."""
        if not self.has_spec(version):
            raise ValueError(f"no launch spec for version {version!r}")
        with self._lock:
            if self._draining:
                # a stopping fleet must not grow fresh workers that
                # would outlive the drain as orphans
                raise RuntimeError("fleet is draining; not rolling workers")
            w.hold = True
            if w.state == READY:
                w.state = DRAINING  # routing excludes it from here on
        try:
            grace = (
                self.cfg.resilience.drain_deadline_s
                + self.fleet_cfg.term_grace_s
            )
            self._terminate(w, grace)
            with self._lock:
                w.target_version = version
            w.restarts += 1
            self.inc("restarts")
            self._spawn(w, self._clock())
        finally:
            with self._lock:
                w.hold = False

    # -- elastic sizing -----------------------------------------------------

    def scale_to(self, n: int, *, reason: str = "") -> int:
        """Resize the fleet to ``n`` workers (the autoscaler's actuator;
        docs/SERVING.md "Multi-tenant & elastic fleet").

        Scale-UP appends fresh :class:`WorkerHandle`\\ s on the LOWEST
        free ids (ids double as device-slice indices, so they stay
        dense; a retiring worker's id is not free until its drain
        completes) targeting the active version, spawned through the
        same launch-spec resolution as boot/restart/rollout. Scale-DOWN
        retires the highest-id non-held workers: each leaves
        ``self.workers`` immediately (routing and supervision stop
        seeing it) and drains in a background thread — SIGTERM lets it
        finish in-flight requests under the drain deadline, so clients
        never observe the shrink. Refused (no-op) while the fleet is
        draining. Returns the new worker count."""
        added: List[WorkerHandle] = []
        victims: List[WorkerHandle] = []
        with self._lock:
            if self._draining:
                return len(self.workers)
            n = max(1, int(n))
            cur = len(self.workers)
            if n == cur:
                return cur
            if n > cur:
                # lowest free id: ids double as device-slice indices
                # (fleet_worker_env), so they must stay dense within
                # [0, max_workers) — a retiring worker's id is NOT free
                # until its drain completes (announce file + slice)
                used = {w.id for w in self.workers} | self._retiring
                for _ in range(n - cur):
                    wid = 0
                    while wid in used:
                        wid += 1
                    used.add(wid)
                    w = WorkerHandle(wid, self.runtime_dir, self.fleet_cfg)
                    w.version = w.target_version = self.active_version
                    self.workers.append(w)
                    added.append(w)
                self.inc("scale_ups")
            else:
                pool = sorted(
                    (w for w in self.workers if not w.hold),
                    key=lambda w: w.id,
                )
                while len(self.workers) - len(victims) > n and pool:
                    v = pool.pop()  # highest id first: LIFO shrink
                    victims.append(v)
                for v in victims:
                    self.workers.remove(v)
                    self._retiring.add(v.id)
                    if v.state == READY:
                        v.state = DRAINING
                self.inc("scale_downs")
            if self.fleet_cfg.max_inflight == 0:
                # derived admission cap tracks the live worker count
                self.max_inflight = (
                    len(self.workers) * self.cfg.serve.max_queue
                )
        now = self._clock()
        for w in added:
            try:
                self._spawn(w, now)
            except OSError as e:
                self._note_death(w, now, f"spawn failed: {e}")
        for v in victims:
            threading.Thread(
                target=self._retire, args=(v,),
                name=f"roko-fleet-retire-{v.id}", daemon=True,
            ).start()
        self._log(
            f"roko fleet: scaled {cur} -> {len(self.workers)} workers"
            + (f" ({reason})" if reason else "")
        )
        return len(self.workers)

    def _retire(self, w: WorkerHandle) -> None:
        """Drain-terminate one retired worker off the routing path."""
        grace = (
            self.cfg.resilience.drain_deadline_s
            + self.fleet_cfg.term_grace_s
        )
        self._terminate(w, grace)
        w.state = STOPPED
        w.port = None
        try:
            os.unlink(w.announce_path)
        except OSError:
            pass
        with self._lock:
            self._retiring.discard(w.id)

    def stop(
        self, *, rolling: bool = True, cleanup: bool = True
    ) -> None:
        """Stop supervision, then terminate workers — sequentially
        (rolling: each worker gets its own SIGTERM drain + exit before
        the next is touched) or in one sweep (``rolling=False``, the
        Ctrl-C path). Idempotent; a second caller BLOCKS until the
        first stop finishes (the supervisor's exit path must not
        return while the SIGTERM drain thread is still terminating
        workers — orphans would outlive the supervisor)."""
        with self._lock:
            first = not self._draining
            self._draining = True
        grace = (
            self.cfg.resilience.drain_deadline_s
            + self.fleet_cfg.term_grace_s
        )
        if not first:
            self._drain_done.wait((grace + 5.0) * (len(self.workers) + 1))
            return
        try:
            self._stop.set()
            if self._thread is not None:
                self._thread.join(
                    self.fleet_cfg.heartbeat_timeout_s
                    + self.fleet_cfg.heartbeat_interval_s + 5.0
                )
            if not rolling:
                for w in self.workers:
                    if w.proc is not None and w.proc.poll() is None:
                        w.proc.terminate()  # rank 0 drains and stops its followers
            for w in self.workers:
                self._terminate(w, grace)
                w.state = STOPPED
            if cleanup and self._own_runtime_dir:
                shutil.rmtree(self.runtime_dir, ignore_errors=True)
        finally:
            if self._leader is not None:  # drained: kill what is left of the group
                try:
                    os.killpg(self._leader.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                self._leader.wait()
                self._leader.stdin.close()
            self._drain_done.set()

    def _terminate(self, w: WorkerHandle, grace_s: float) -> None:
        """SIGTERM rank 0 (it drains its in-flight requests, then sends
        its followers the stop op), escalate to SIGKILL after ``grace_s``;
        followers still running ``term_grace_s`` after rank 0's clean exit,
        or at once when rank 0 did not exit cleanly, are killed."""
        leader = w.proc
        if leader is None or all(p.poll() is not None for p in w.procs):
            return
        if leader.poll() is None:
            leader.terminate()
            try:
                leader.wait(grace_s)
            except subprocess.TimeoutExpired:
                self._log(
                    f"roko fleet: worker {w.id} ignored SIGTERM for "
                    f"{grace_s:.0f}s; escalating to SIGKILL"
                )
        if leader.poll() == 0:  # drained: its followers got the stop op
            _wait_all(w.procs[1:], self.fleet_cfg.term_grace_s)
        self._kill_ranks(w)

    def _kill_ranks(self, w: WorkerHandle) -> None:
        """SIGKILL every rank of ``w`` still running, and reap them all."""
        for p in w.procs:
            if p.poll() is None:
                p.kill()
        for p in w.procs:
            try:
                p.wait(self.fleet_cfg.term_grace_s)
            except subprocess.TimeoutExpired:  # pragma: no cover
                pass

    # -- supervision --------------------------------------------------------

    def _supervise(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception as e:  # pragma: no cover - defensive
                self._log(f"roko fleet: supervision tick failed: {e!r}")
            self._stop.wait(self.fleet_cfg.heartbeat_interval_s)

    def tick(self) -> None:
        """One supervision pass over every worker (public so tests can
        drive supervision synchronously with a fake clock)."""
        # snapshot: scale_to() mutates self.workers concurrently
        for w in list(self.workers):
            if self._draining:
                return
            self._check(w, self._clock())

    def _check(self, w: WorkerHandle, now: float) -> None:
        cfg = self.fleet_cfg
        if w.hold:
            # a rollout is deliberately restarting this worker; its
            # death is planned, not a crash to supervise
            return
        if w.state in (FAILED, DEAD):
            if w.state == DEAD and now < w.restart_at:
                return
            # storm breaker gates the respawn: CLOSED passes, OPEN
            # refuses (FAILED = degraded fleet), half-open admits one
            # probe restart after storm_reset_s
            if w.storm.allow():
                if w.state == FAILED:
                    self._log(
                        f"roko fleet: worker {w.id} storm breaker half-open;"
                        " admitting one probe restart"
                    )
                self._restart(w, now)
            elif w.state != FAILED:
                w.state = FAILED
                self._log(
                    f"roko fleet: worker {w.id} restart storm "
                    f"({cfg.storm_threshold} restarts without a stable "
                    f"stretch) — marking FAILED, fleet degraded; next "
                    f"probe in {cfg.storm_reset_s:.0f}s"
                )
            return
        dead = w.exited()
        if dead is not None:
            rank, rc = dead
            if len(w.procs) > 1:
                # the worker's session is out of step: one death, all k
                # ranks restart together
                self._kill_ranks(w)
                self._note_death(w, now, f"rank {rank} of {len(w.procs)} exited rc={rc} "
                                 "(its other ranks killed)")
            else:
                self._note_death(w, now, f"exited rc={rc}")
            return
        if w.state == STARTING:
            port = self._read_announce(w)
            if port is not None:
                w.port = port
                w.state = WARMING
                self._log(
                    f"roko fleet: worker {w.id} bound 127.0.0.1:{port} "
                    "(warming)"
                )
            elif now - w.spawned_at > cfg.spawn_deadline_s:
                self._kill_hung(
                    w, now,
                    f"never announced within {cfg.spawn_deadline_s:.0f}s",
                )
            return
        # bound: heartbeat via /healthz
        try:
            code, body = self._probe(w, "/healthz")
        except _CONN_ERRORS:
            w.misses += 1
            if w.misses >= cfg.heartbeat_misses:
                self._kill_hung(
                    w, now, f"{w.misses} consecutive missed heartbeats"
                )
            return
        w.misses = 0
        hint = body.get("retry_after_s")
        if isinstance(hint, (int, float)) and hint > 0:
            # the worker's live backlog/throughput Retry-After estimate
            # rides in healthz; cache it so front-end 503s can
            # promise a real wait instead of the static config guess
            w.retry_hint = float(hint)
        qw = body.get("queue_windows")
        if isinstance(qw, (int, float)):
            w.queue_windows = int(qw)
        th = body.get("tenants")
        if isinstance(th, dict):
            # per-tenant backlog/Retry-After hints for 429/503 sizing
            w.tenant_hints = {
                str(t): h for t, h in th.items() if isinstance(h, dict)
            }
        status = body.get("status", "")
        if code == 200:
            if w.state != READY:
                self._log(f"roko fleet: worker {w.id} in rotation")
                w.state = READY
                w.ready_since = now
            elif not w.stable and now - w.ready_since >= cfg.stable_after_s:
                # survived the probation window: the storm breaker
                # records recovery and the backoff schedule resets
                w.stable = True
                w.attempt = 0
                w.storm.record_success()
        elif status == "warming":
            w.state = WARMING
        elif status == "draining":
            w.state = DRAINING
        else:
            # breaker-tripped (or otherwise unhealthy) but answering:
            # out of rotation, left alive — the worker's own half-open
            # probing may recover it without losing the warm session
            if w.state != UNHEALTHY:
                self._log(
                    f"roko fleet: worker {w.id} out of rotation "
                    f"(healthz {code} status={status or '?'})"
                )
            w.state = UNHEALTHY

    def _read_announce(self, w: WorkerHandle) -> Optional[int]:
        try:
            with open(w.announce_path) as f:
                return int(json.load(f)["port"])
        except (OSError, ValueError, KeyError):
            return None

    def _note_death(self, w: WorkerHandle, now: float, why: str) -> None:
        w.storm.record_failure()
        delay = self.restart_policy.delay_for(w.attempt + 1)
        w.attempt += 1
        w.restart_at = now + delay
        w.state = DEAD
        w.port = None
        self._log(
            f"roko fleet: worker {w.id} {why}; restart "
            f"{w.attempt} in {delay:.1f}s; log tail:\n{_tail(w.log_path)}"
        )

    def _kill_hung(self, w: WorkerHandle, now: float, why: str) -> None:
        self._log(
            f"roko fleet: worker {w.id} presumed hung ({why}); "
            "SIGTERM -> SIGKILL"
        )
        self._terminate(w, self.fleet_cfg.term_grace_s)
        self._note_death(w, now, f"killed ({why})")

    def _restart(self, w: WorkerHandle, now: float) -> None:
        w.restarts += 1
        self.inc("restarts")
        try:
            self._spawn(w, now)
        except OSError as e:  # spawn itself failed: another death
            self._note_death(w, now, f"respawn failed: {e}")

    # -- routing ------------------------------------------------------------

    def ready_count(self) -> int:
        return sum(1 for w in list(self.workers) if w.state == READY)

    def live_retry_after_s(self, tenant: Optional[str] = None) -> float:
        """Retry-After for front-end 503/429s (draining, at capacity, no
        worker available): the LARGEST hint any live worker reported in
        its last answered /healthz — each worker computes its own from
        live backlog over observed throughput (docs/SERVING.md
        "Continuous batching") — falling back to the static
        ``serve.retry_after_s`` only when no worker has answered (none
        bound yet, or all dead).

        With ``tenant`` given, the hint is sized from THAT tenant's
        backlog and observed drain rate (the workers' per-tenant
        healthz hints), not the global queue — a quota-limited bulk
        tenant must not inflate the wait promised to an interactive
        one."""
        with self._lock:
            workers = list(self.workers)
        if tenant is not None:
            t_hints = []
            for w in workers:
                if not w.alive():
                    continue
                h = w.tenant_hints.get(tenant)
                ra = h.get("retry_after_s") if h else None
                if isinstance(ra, (int, float)) and ra > 0:
                    t_hints.append(float(ra))
            if t_hints:
                return max(t_hints)
        hints = [
            w.retry_hint
            for w in workers
            if w.retry_hint is not None and w.alive()
        ]
        return max(hints) if hints else self.cfg.serve.retry_after_s

    def backlog_windows(self) -> int:
        """Total queued windows across live workers (last answered
        /healthz) — the autoscaler's raw backlog signal."""
        with self._lock:
            workers = list(self.workers)
        return sum(
            w.queue_windows
            for w in workers
            if w.queue_windows is not None and w.alive()
        )

    def suspect(self, w: WorkerHandle) -> None:
        """A worker that dropped a connection leaves rotation NOW; the
        supervision loop confirms via waitpid/heartbeat and either
        restarts it or probes it straight back to READY. Shared by the
        front end's failover path and the distributed-polish
        coordinator."""
        with self._lock:
            if w.state == READY:
                w.state = UNHEALTHY

    def pick(
        self, exclude: Sequence[int] = (), version: Optional[str] = None
    ) -> Optional[Tuple[WorkerHandle, int]]:
        """Round-robin over in-rotation workers, skipping ``exclude``
        (ids already tried for this request); ``version`` restricts to
        workers running that model version (per-request model lanes).
        Returns the handle AND a port snapshot taken under the lock:
        the supervision thread nulls ``w.port`` when a worker dies, and
        reading it later would race — ``HTTPConnection(host, None)``
        silently falls back to port 80."""
        with self._lock:
            ready = [
                w for w in self.workers
                if w.state == READY and w.id not in exclude
                and w.port is not None
                and (version is None or w.version == version)
            ]
            if not ready:
                return None
            self._rr += 1
            w = ready[self._rr % len(ready)]
            return w, w.port

    def post_polish(
        self,
        body: bytes,
        timeout: Optional[float] = None,
        request_id: Optional[str] = None,
        tenant: Optional[str] = None,
        model_version: Optional[str] = None,
        pinned: bool = False,
    ) -> Tuple[int, bytes, Dict[str, str]]:
        """Route one ``POST /polish`` body to a ready worker with
        transparent failover: a connection-level failure (worker died
        mid-request) retries on another ready worker — polish is
        idempotent, so the client sees added latency, never the crash.
        Worker 503s try the next worker, then surface as a fleet 503
        with the largest ``Retry-After`` observed. Returns
        ``(status, reply_body, extra_headers)``.

        ``tenant`` rides every dispatch as ``X-Roko-Tenant`` so worker
        fair-share/quota accounting sees the tenant without the front
        end re-serializing the body. ``model_version`` restricts
        routing to workers running that version: ``pinned=True`` (the
        client named it) also forwards ``X-Roko-Model`` for the
        worker-side identity guard and surfaces a loud 503 when no
        ready worker runs it; ``pinned=False`` (A/B lane assignment)
        falls back softly to any ready worker when the candidate lane
        is empty — lane routing is an optimization, never an outage.

        ``request_id`` (assigned by the front end) rides every dispatch
        as ``X-Roko-Request-Id`` — including the failover RE-dispatch,
        so the worker trace and event log see ONE request however many
        workers it visited; each dispatch appends a quiet ``fleet
        dispatch`` event to the configured event log."""
        cfg = self.fleet_cfg
        tried: List[int] = []
        # resolved lazily: the live hint sweeps every worker's waitpid
        # under the lock, which the hot 200 path must never pay
        retry_after: Optional[float] = None
        for _ in range(max(1, cfg.failover_attempts)):
            picked = self.pick(exclude=tried, version=model_version)
            if picked is None and model_version is not None and not pinned:
                # lane soft-fallback: candidate lane empty or busy —
                # the incumbent serves the request
                picked = self.pick(exclude=tried)
            if picked is None:
                break
            w, port = picked
            tried.append(w.id)
            if request_id is not None:
                # sink-only (quiet): one record per dispatch attempt —
                # after a mid-request SIGKILL the log shows the SAME
                # request_id with two dispatch spans on two workers
                obs_events.emit(
                    "fleet", "dispatch", quiet=True,
                    request_id=request_id, worker=w.id,
                    attempt=len(tried),
                )
            try:
                code, reply, hdrs = self._forward(
                    port, body, timeout, request_id=request_id,
                    tenant=tenant,
                    model_version=model_version if pinned else None,
                )
            except _CONN_ERRORS as e:
                # the worker vanished mid-request: suspect it (the
                # supervision loop confirms via waitpid/heartbeat and
                # restarts it) and fail over
                self.inc("failovers")
                self._log(
                    f"roko fleet: worker {w.id} dropped a request "
                    f"({type(e).__name__}); failing over"
                )
                if request_id is not None:
                    obs_events.emit(
                        "fleet", "failover", quiet=True,
                        request_id=request_id, worker=w.id,
                        error=type(e).__name__,
                    )
                self.suspect(w)
                continue
            if code == 503:
                if retry_after is None:
                    retry_after = self.live_retry_after_s(tenant)
                try:
                    retry_after = max(
                        retry_after, float(hdrs.get("Retry-After", 0))
                    )
                except ValueError:
                    pass
                continue
            if code == 429:
                # tenant quota breach: the worker's Retry-After promise
                # must reach the client intact
                keep = {
                    k: v for k, v in hdrs.items()
                    if k.lower() == "retry-after"
                }
                return code, reply, keep
            return code, reply, {}
        if retry_after is None:
            retry_after = self.live_retry_after_s(tenant)
        if pinned and model_version is not None and not tried:
            msg = (
                f"no ready worker runs model {model_version!r} "
                "(fleet busy, rolling, or lane not deployed)"
            )
        else:
            msg = "no worker available (fleet busy or degraded)"
        body_out = json.dumps({
            "error": msg,
            "retry_after_s": retry_after,
        }).encode()
        return 503, body_out, {"Retry-After": f"{max(1, round(retry_after))}"}

    def _forward(
        self,
        port: int,
        body: bytes,
        timeout: Optional[float] = None,
        request_id: Optional[str] = None,
        tenant: Optional[str] = None,
        model_version: Optional[str] = None,
    ) -> Tuple[int, bytes, Dict[str, str]]:
        """One POST /polish to one worker's snapshotted port, no
        retries here. The default read timeout is generous (a polish
        can legitimately take minutes); a worker that HANGS mid-request
        is killed by the supervision loop, which closes this socket and
        converts the hang into a connection error -> failover."""
        conn = http.client.HTTPConnection(
            "127.0.0.1", port,
            timeout=REQUEST_TIMEOUT_S if timeout is None else timeout,
        )
        headers = {"Content-Type": "application/json"}
        if request_id is not None:
            headers["X-Roko-Request-Id"] = request_id
        if tenant is not None:
            headers["X-Roko-Tenant"] = tenant
        if model_version is not None:
            headers["X-Roko-Model"] = model_version
        try:
            conn.request("POST", "/polish", body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, data, dict(resp.getheaders())
        finally:
            conn.close()

    def _probe(
        self, w: WorkerHandle, path: str
    ) -> Tuple[int, Dict[str, object]]:
        """GET a worker's JSON endpoint with the heartbeat timeout;
        HTTP error codes (503 warming/unhealthy) parse as answers, only
        transport failures raise."""
        url = f"http://127.0.0.1:{w.port}{path}"
        try:
            with urllib.request.urlopen(
                url, timeout=self.fleet_cfg.heartbeat_timeout_s
            ) as r:
                return r.status, json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.read() or b"{}")
            except ValueError:
                return e.code, {}

    # -- observation --------------------------------------------------------

    def summary(self) -> Dict[str, object]:
        """The supervisor ``/healthz`` body: aggregate status + the
        per-worker state map."""
        workers = list(self.workers)
        up = self.ready_count()
        states = {
            str(w.id): {
                "state": w.state,
                "port": w.port,
                "restarts": w.restarts,
                "version": w.version,
                "ranks": len(w.procs),
            }
            for w in workers
        }
        if self._draining:
            status, code = "draining", 503
        elif up == len(workers):
            status, code = "ok", 200
        elif up >= 1:
            # serving on the survivors: a load balancer may still route
            # here, but the degradation is visible
            status, code = "degraded", 200
        elif any(w.state in (WARMING, STARTING) for w in workers):
            status, code = "warming", 503
        else:
            status, code = "unhealthy", 503
        return {
            "status": status,
            "code": code,
            "workers": states,
            "workers_up": up,
            "version": self.active_version,
            # host-level load signal: the federation front's
            # HostAutoscaler sizes each host from this
            # (serve/federation.py)
            "backlog_windows": self.backlog_windows(),
        }

    def render_metrics(self) -> str:
        """The supervisor ``/metrics`` body: fleet gauges/counters plus
        selected per-worker series re-labeled by worker id (scraped
        live from each bound worker with the heartbeat timeout;
        unanswering workers are simply absent from the passthrough)."""
        workers = list(self.workers)
        p = "roko_fleet_"
        lines = [
            f"# TYPE {p}workers gauge",
            f"{p}workers {len(workers)}",
            f"# TYPE {p}workers_up gauge",
            f"{p}workers_up {self.ready_count()}",
        ]
        for name in ("restarts", "failovers", "requests", "rejected",
                     "scale_ups", "scale_downs"):
            lines.append(f"# TYPE {p}{name}_total counter")
            lines.append(f"{p}{name}_total {self.counter(name)}")
        lines.append(f"# TYPE {p}jobs_parked gauge")
        lines.append(f"{p}jobs_parked {1 if self.jobs_parked else 0}")
        lines.append(f"# TYPE {p}worker_state gauge")
        for w in workers:
            lines.append(
                f'{p}worker_state{{worker="{w.id}"}} '
                f"{STATE_CODES.get(w.state, 9)}"
            )
        lines.append(f"# TYPE {p}worker_restarts_total counter")
        for w in workers:
            lines.append(
                f'{p}worker_restarts_total{{worker="{w.id}"}} {w.restarts}'
            )
        # info-style: which model version each worker runs (the mixed-
        # fleet window during a rollout or an A/B lane is visible from
        # one scrape)
        lines.append(f"# TYPE {p}model_version gauge")
        for w in workers:
            lines.append(
                f'{p}model_version{{worker="{w.id}",'
                f'version="{w.version}"}} 1'
            )
        lines.append("# TYPE roko_rollout_state gauge")
        lines.append(
            "roko_rollout_state "
            f"{getattr(self.rollout, 'state_code', lambda: 0)() if self.rollout is not None else 0}"
        )
        names = tuple(n for n, _ in PASSTHROUGH_SERIES)
        scraped: Dict[int, Dict[str, str]] = {}
        bodies: Dict[int, str] = {}
        for w in workers:
            if w.port is None or not w.alive():
                continue
            try:
                url = f"http://127.0.0.1:{w.port}/metrics"
                with urllib.request.urlopen(
                    url, timeout=self.fleet_cfg.heartbeat_timeout_s
                ) as r:
                    bodies[w.id] = body = r.read().decode()
                    scraped[w.id] = parse_metric_values(body, names)
            except _CONN_ERRORS:  # URLError subclasses OSError
                continue
        for name, kind in PASSTHROUGH_SERIES:
            rows = [
                (wid, vals[name])
                for wid, vals in sorted(scraped.items())
                if name in vals
            ]
            if not rows:
                continue
            lines.append(f"# TYPE {name} {kind}")
            for wid, val in rows:
                lines.append(f'{name}{{worker="{wid}"}} {val}')
        # tenant-/model-labeled worker series, re-exported with the
        # worker id appended inside the braces — fleet dashboards see
        # per-tenant admission and per-model traffic per worker
        labeled = {
            wid: parse_labeled_rows(body, LABELED_SERIES)
            for wid, body in sorted(bodies.items())
        }
        for name in LABELED_SERIES:
            rows2 = [
                (wid, lbody, val)
                for wid, per in labeled.items()
                for lbody, val in per.get(name, [])
            ]
            if not rows2:
                continue
            kind = "counter" if name.endswith("_total") else "gauge"
            lines.append(f"# TYPE {name} {kind}")
            for wid, lbody, val in rows2:
                lines.append(f'{name}{{{lbody},worker="{wid}"}} {val}')
        # MERGEABLE histograms (docs/OBSERVABILITY.md): fleet-level rows
        # are the bucket-wise SUM of the worker rows — sound because
        # every process shares DEFAULT_LATENCY_BUCKETS — so a fleet p99
        # derives from the summed CDF instead of a percentile
        # passthrough that cannot aggregate; the per-worker rows stay
        # beside them labeled worker="i"
        for name in HISTOGRAM_SERIES:
            per_worker = {
                wid: parse_histogram_rows(body, name)
                for wid, body in sorted(bodies.items())
            }
            merged = merge_histogram_rows(per_worker.values())
            if not merged:
                continue
            lines.append(f"# TYPE {name} histogram")
            lines.extend(render_histogram_rows(name, merged))
            for wid, rows in per_worker.items():
                lines.extend(
                    render_histogram_rows(name, rows, extra=f'worker="{wid}"')
                )
        return "\n".join(lines) + "\n"

    def tracez(self, query: str = "") -> Dict[str, object]:
        """The supervisor ``GET /tracez`` body: every live worker's
        trace ring + scheduler snapshot, keyed by worker id (a worker
        not answering is simply absent)."""
        out: Dict[str, object] = {}
        path = "/tracez" + (f"?{query}" if query else "")
        for w in list(self.workers):
            if w.port is None or not w.alive():
                continue
            try:
                _, body = self._probe(w, path)
                out[str(w.id)] = body
            except _CONN_ERRORS:
                continue
        return {"workers": out}
