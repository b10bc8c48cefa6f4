"""Supervising front end for the multi-worker serving tier (the port's
copy of ``roko_tpu/serve/supervisor.py``).

``python -m roko_tpu_torch serve CKPT --workers N`` runs THIS process
instead of a PolishSession: it starts N ``python -m roko_tpu_torch
serve`` workers (each a full warm stack, pinned to its cards by
``CUDA_VISIBLE_DEVICES`` or sharing them, loading one kernel bundle) via
:class:`~roko_tpu_torch.serve.fleet.Fleet`, and puts a thin HTTP surface
over the fleet. It is the workers' launcher too: a worker whose slice
holds k cards (``--devices-per-worker k``; with shared cards, the
config's ``dp x tp x sp`` grid) is k processes under ``ROKO_*``, one
session over them (``parallel.mesh.fleet_worker_rank_envs``). The HTTP
surface:

- ``POST /polish`` — admission control (bounded in-flight, 503 +
  ``Retry-After`` past it) then failover routing: the body is relayed
  verbatim to a ready worker; a worker dying mid-request is retried on
  another worker transparently (polish is idempotent), so clients see
  latency, never the crash.
- ``GET /healthz`` — fleet aggregate (``ok`` / ``degraded`` with 200,
  ``warming`` / ``unhealthy`` / ``draining`` with 503) plus the
  per-worker state map.
- ``GET /metrics`` — ``roko_fleet_*`` series plus selected per-worker
  gauges re-labeled by worker id.
- ``POST /rollout`` / ``GET /rollout`` — start / observe a
  health-gated zero-downtime rollout onto a registered model version
  (``serve/rollout.py``).
- ``POST /job`` / ``GET /jobz`` — submit a whole-genome distributed
  polish (server-side ref/bam/out paths) over this fleet, and read its
  per-unit state (``pipeline/distpolish.py``); a rollout is refused while
  a job runs, a job while a rollout runs, and a job dispatches no new
  unit while the autoscaler has parked background work.

Every front-end 503 (draining, at capacity, no worker available)
carries the LARGEST live worker ``Retry-After`` hint (each worker
estimates its own from live backlog over observed throughput and
reports it in ``/healthz``); the static ``serve.retry_after_s`` is only
the fallback when no worker has answered.

The supervisor process never initialises CUDA: it only routes, so it
loads no params, builds no model, and computes the workers' card slices
with the pure ``parallel.mesh.fleet_worker_env`` helper. This module
imports no torch; ``parallel.mesh`` (which imports torch without touching
the card) is imported where the slices are computed, and a distributed
polish job's stitch where the job runs.

SIGTERM is a rolling drain: the front end stops admitting and finishes
in-flight relays first, then workers are SIGTERMed one at a time (each
drains its own in-flight under ``--drain-deadline``, escalating to
SIGKILL after ``term_grace_s``) — no mid-request connection resets on
the way down.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import threading
import time
from http.server import ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from roko_tpu_torch.config import ModelConfig, RokoConfig
from roko_tpu_torch.obs import events as obs_events
from roko_tpu_torch.obs.trace import new_request_id
from roko_tpu_torch.serve.fleet import (
    BOOT_VERSION,
    Fleet,
    WorkerLaunchSpec,
    free_coordinator,
    write_announce,
)
from roko_tpu_torch.serve.httpbase import (
    _NAME_RE,
    JsonRequestHandler,
    drain,
    init_lifecycle,
    request_tenant,
    serve_forever,
)
from roko_tpu_torch.serve.registry import (
    RegistryError,
    resolve_model,
    resolve_registry_dir,
)
from roko_tpu_torch.serve.rollout import (
    CurrentVersionFile,
    RolloutController,
    RolloutJournal,
    recover_rollout,
)


class _FrontHandler(JsonRequestHandler):
    # set by make_front_server on the class copy
    fleet: Fleet

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        if self.path.split("?", 1)[0] == "/tracez":
            # aggregate view: every worker's trace ring + scheduler
            # snapshot keyed by worker id — the
            # request_id assigned here at the front end is what each
            # worker's records carry, so one id greps across the fleet
            parts = self.path.split("?", 1)
            self._reply_json(
                200, self.fleet.tracez(parts[1] if len(parts) > 1 else "")
            )
        elif self.path == "/healthz":
            body = self.fleet.summary()
            if self.server._draining.is_set():  # type: ignore[attr-defined]
                body["status"], body["code"] = "draining", 503
            code = body.pop("code")
            self._reply_json(code, body)
        elif self.path == "/metrics":
            self._reply(
                200,
                self.fleet.render_metrics().encode(),
                content_type="text/plain; version=0.0.4",
            )
        elif self.path == "/rollout":
            ctl = self.fleet.rollout
            self._reply_json(
                200, ctl.status() if ctl is not None else {"state": "idle"}
            )
        elif self.path == "/jobz":
            # the distributed polish job's per-unit state table
            job = getattr(self.fleet, "job", None)
            self._reply_json(200, job.snapshot() if job is not None else {"state": "idle"})
        else:
            self._reply_json(404, {"error": f"no route {self.path}"})

    def _handle_starter(self, attr: str, what: str) -> None:
        """POST plumbing for the operator surfaces whose implementation
        run_supervisor wires onto the server object (``/rollout`` and
        ``/job``): 501 when unconfigured, bounded
        body read, JSON-object validation, then ``(code, body)`` from
        the starter."""
        starter = getattr(self.server, attr, None)
        if starter is None:
            self._reply_json(
                501,
                {"error": f"{what} is not configured on this front end "
                          "(run via `python -m roko_tpu_torch serve --workers N`)"},
            )
            return
        raw = self._read_body()
        if raw is None:
            return  # error reply already sent
        try:
            payload = json.loads(raw.decode() or "{}")
            if not isinstance(payload, dict):
                raise ValueError("payload must be a JSON object")
        except (ValueError, UnicodeDecodeError) as e:
            self._reply_json(400, {"error": str(e)})
            return
        code, body = starter(payload)
        self._reply_json(code, body)

    def do_POST(self) -> None:  # noqa: N802 - http.server API
        if self.path == "/rollout":
            self._handle_starter("_start_rollout", "rollout")
            return
        if self.path == "/job":
            # a whole-genome distributed polish over THIS fleet; observe
            # it with GET /jobz
            self._handle_starter("_start_job", "distributed polish jobs")
            return
        if self.path != "/polish":
            self._reply_json(404, {"error": f"no route {self.path}"})
            return
        fleet = self.fleet
        # tenant / model-lane identity ride in headers — the front end
        # never parses the (possibly 256 MiB) body to route
        try:
            tenant = request_tenant(self.headers, {})
        except ValueError as e:
            self._reply_json(400, {"error": str(e)})
            return
        model = self.headers.get("X-Roko-Model")
        pinned = model is not None
        if pinned and not _NAME_RE.match(model):
            self._reply_json(
                400,
                {"error": "model name must match "
                          "[A-Za-z0-9][A-Za-z0-9._-]{0,63}"},
            )
            return
        with self._track_inflight():
            # draining checked AFTER the increment (same TOCTOU rule as
            # the worker server: drain() watches the counter)
            if self.server._draining.is_set():  # type: ignore[attr-defined]
                self.close_connection = True
                # live hint: the max Retry-After any up worker last
                # reported (static config value when none have
                # answered) — sized from the REQUESTING tenant's backlog
                # and drain rate when the workers report per-tenant
                # hints; computed only on the 503 paths, never the hot
                # success path (it sweeps every worker's waitpid)
                retry = fleet.live_retry_after_s(tenant)
                self._reply_json(
                    503,
                    {"error": "fleet draining", "retry_after_s": retry},
                    extra={"Retry-After": f"{max(1, round(retry))}"},
                )
                return
            with self.server._inflight_lock:  # type: ignore[attr-defined]
                inflight = self.server._inflight  # type: ignore[attr-defined]
            if inflight > fleet.max_inflight:
                # admission control: past the fleet's aggregate queue
                # capacity, shed here instead of stacking relays behind
                # workers that will 503 anyway
                fleet.inc("rejected")
                retry = fleet.live_retry_after_s(tenant)
                self._reply_json(
                    503,
                    {"error": "fleet at capacity",
                     "retry_after_s": retry},
                    extra={"Retry-After": f"{max(1, round(retry))}"},
                )
                return
            if pinned:
                # the pin resolves through the registry HERE — an
                # unregistered or digest-drifted version refuses loudly
                # before any worker sees the request
                err = self.server._verify_model(model)  # type: ignore[attr-defined]
                if err is not None:
                    self._reply_json(400, {"error": err})
                    return
            try:
                body = self._read_body()
            except TimeoutError:
                # peer stalled mid-body past the socket timeout
                self.close_connection = True
                self._reply_json(
                    503, {"error": "timed out reading the request"}
                )
                return
            if body is None:
                return  # error reply already sent
            fleet.inc("requests")
            # the request id is minted HERE (or honored from the
            # client's header) and preserved across failover
            # re-dispatch: the reply, the worker's /tracez record, and
            # the event log all carry the front end's id
            rid = (
                self.headers.get("X-Roko-Request-Id") or new_request_id()
            )
            version = model if pinned else None
            if version is None:
                lane = self.server._ab_lane  # type: ignore[attr-defined]
                if lane is not None:
                    # deterministic split: the request id (stable across
                    # failover) hashes into [0,1) against the configured
                    # fraction — no RNG, replayable from the event log
                    lane_version, fraction = lane
                    h = int(
                        hashlib.sha256(rid.encode()).hexdigest()[:8], 16
                    )
                    if h / float(1 << 32) < fraction:
                        version = lane_version
            code, reply, extra = fleet.post_polish(
                body, request_id=rid, tenant=tenant,
                model_version=version, pinned=pinned,
            )
            if code == 503:
                self.close_connection = True
            self._reply(code, reply, extra=extra)


def make_front_server(
    fleet: Fleet,
    host: Optional[str] = None,
    port: Optional[int] = None,
    *,
    handler_base: Optional[type] = None,
) -> ThreadingHTTPServer:
    """Bind the supervisor front end (port 0 = ephemeral) and return
    the server; the caller runs ``serve_forever``. The fleet rides on
    the server object (``.fleet``) and the lifecycle state matches the
    worker server's, so :func:`roko_tpu.serve.server.drain` works on
    it unchanged. ``handler_base`` swaps in a ``_FrontHandler``
    subclass."""
    serve_cfg = fleet.cfg.serve
    handler = type(
        "RokoFleetHandler",
        (handler_base or _FrontHandler,),
        {"fleet": fleet},
    )
    server = ThreadingHTTPServer(
        (serve_cfg.host if host is None else host,
         serve_cfg.port if port is None else port),
        handler,
    )
    server.fleet = fleet  # type: ignore[attr-defined]
    #: POST /rollout and POST /job implementations; run_supervisor wires
    #: the real ones, bare front ends answer 501
    server._start_rollout = None  # type: ignore[attr-defined]
    server._start_job = None  # type: ignore[attr-defined]
    #: (version, fraction) when an A/B lane routes a slice of unpinned
    #: traffic to a candidate version; run_supervisor wires it
    server._ab_lane = None  # type: ignore[attr-defined]
    #: X-Roko-Model pin verifier: name -> error string or None (pass);
    #: re-verifies the registry entry (bundle digest + params manifest)
    #: with a short-lived cache so pinned traffic does not re-hash the
    #: checkpoint per request
    server._verify_model = make_model_verifier(fleet)  # type: ignore[attr-defined]
    init_lifecycle(server, fleet.cfg.resilience.drain_deadline_s)
    return server


def make_model_verifier(
    fleet: Fleet, ttl_s: float = 10.0
) -> Callable[[str], Optional[str]]:
    """Front-end ``model=`` pin gate: resolve the named version through
    the registry with full verification (bundle digest + params
    manifest re-hash) and cache the verdict for ``ttl_s`` — drift is
    caught within one TTL, and pinned hot paths do not re-hash a
    checkpoint per request. Returns an error string in the
    RegistryMismatch shape, or None when the pin is valid."""
    cache: Dict[str, Tuple[float, Optional[str]]] = {}
    lock = threading.Lock()

    def verify(name: str) -> Optional[str]:
        now = time.monotonic()
        with lock:
            hit = cache.get(name)
            if hit is not None and hit[0] > now:
                return hit[1]
        try:
            resolve_model(
                resolve_registry_dir(fleet.fleet_cfg.registry_dir), name
            )
            err: Optional[str] = None
        except RegistryError as e:
            # unregistered AND drifted both refuse in the same loud
            # shape — the one thing that never happens is silently
            # serving the incumbent under a pinned name
            err = f"RegistryMismatch: model={name!r} refused: {e}"
        with lock:
            cache[name] = (now + ttl_s, err)
        return err

    return verify


def worker_command(
    model_path: str, config_path: str, device: str = "cuda"
) -> Callable[[int, Optional[str]], List[str]]:
    """argv builder for real ``python -m roko_tpu_torch serve`` workers:
    ephemeral loopback port, port announced through ``announce_path``,
    config via the shared JSON, the supervisor's ``--device`` (a worker
    that cannot see the card fails its start; it never moves to the CPU).
    ``--worker-id`` keeps the child out of supervisor mode. A follower
    rank (``announce_path`` None) gets the same command without
    ``--announce``: it binds nothing and follows rank 0's dispatches."""

    def build(worker_id: int, announce_path: Optional[str]) -> List[str]:
        return [
            sys.executable, "-m", "roko_tpu_torch", "serve", model_path,
            "--config", config_path,
            "--host", "127.0.0.1", "--port", "0",
            "--worker-id", str(worker_id),
            *(["--announce", announce_path] if announce_path is not None else []),
            "--device", device,
        ]

    return build


def worker_ranks(cfg: RokoConfig, device: str = "cuda") -> int:
    """k, the ranks of each worker's session
    (``parallel.mesh.fleet_worker_ranks``), checked before anything
    spawns: the config's grid must fill k (``mesh_shape``'s message), the
    transformer must split over its tp and sp (``check_divisible``'s) and
    an explicit ladder must shard over its dp (``validate_ladder``'s); a
    ``ValueError`` names what does not fit."""
    from roko_tpu_torch.config import validate_ladder
    from roko_tpu_torch.parallel.mesh import fleet_worker_ranks, mesh_shape
    from roko_tpu_torch.parallel.tp import check_divisible

    k = fleet_worker_ranks(cfg.fleet.devices_per_worker, cfg.mesh, device)
    dp, tp, sp = mesh_shape(cfg.mesh, k)
    check_divisible(cfg.model, tp, sp)
    if cfg.serve.ladder:
        validate_ladder(cfg.serve.ladder, dp)
    return k


def worker_launch_spec(
    version: str,
    model_path: str,
    cfg: RokoConfig,
    runtime_dir: str,
    *,
    meta: Optional[Dict[str, Any]] = None,
    device: str = "cuda",
) -> WorkerLaunchSpec:
    """THE builder for what a worker of ``version`` runs: writes the
    per-version worker config JSON (``fleet.workers`` zeroed so a child
    can never recurse into supervisor mode; the version's kernel bundle
    riding in ``compile.bundle_dir``) and returns the spec initial
    spawn, crash restart, and rollout all resolve through —
    ``Fleet._spawn`` reads nothing else, so the three paths cannot
    drift on which bundle/params a worker gets."""
    fc = cfg.fleet
    worker_cfg = dataclasses.replace(
        cfg, fleet=dataclasses.replace(fc, workers=0)
    )
    os.makedirs(runtime_dir, exist_ok=True)
    config_path = os.path.join(
        runtime_dir, f"worker-config-{version}.json"
    )
    with open(config_path, "w") as f:
        f.write(worker_cfg.to_json())
    spec_meta: Dict[str, Any] = {
        "model_path": model_path,
        "bundle_dir": cfg.compile.bundle_dir,
        "model": dataclasses.asdict(cfg.model),
    }
    spec_meta.update(meta or {})
    # card slices are carved for the fleet's MAX size: an autoscaled
    # worker's fresh id must map to a valid slice, and a fixed-size
    # fleet (max_workers unset) keeps the old denominator (shared cards,
    # devices_per_worker=0, and the CPU give an empty overlay either way)
    from roko_tpu_torch.parallel.mesh import fleet_worker_rank_envs

    n_slices = max(fc.workers, fc.max_workers or 0)
    k = worker_ranks(cfg, device)
    spec_meta["ranks"] = k

    def ranks(wid: int) -> List[Dict[str, str]]:
        # a fresh coordinator port for every start of the worker's session
        return fleet_worker_rank_envs(
            wid, n_slices, fc.devices_per_worker, cfg.mesh,
            free_coordinator() if k > 1 else "", backend=device)

    return WorkerLaunchSpec(
        worker_command(model_path, config_path, device),
        ranks=ranks,
        version=version,
        meta=spec_meta,
    )


def _version_config(cfg: RokoConfig, side: Dict[str, Any]) -> RokoConfig:
    """The supervisor config specialised to one version's identity: the
    side dict (a registry entry, or a journal record's from/to block)
    names the bundle dir and — when it carries one — the full
    ModelConfig the bundle was compiled for, so a rollout across model
    kinds or precision variants launches workers whose config matches
    the bundle digest instead of refusing at warmup."""
    out = dataclasses.replace(
        cfg,
        compile=dataclasses.replace(
            cfg.compile, bundle_dir=side.get("bundle_dir")
        ),
    )
    model = side.get("model") or {}
    if model:
        out = dataclasses.replace(
            out,
            model=ModelConfig(
                **{
                    k: tuple(v) if k == "read_mlp" else v
                    for k, v in model.items()
                }
            ),
        )
    return out


def make_rollout_starter(
    fleet: Fleet,
    journal: RolloutJournal,
    model_path: str,
    cfg: RokoConfig,
    log=print,
    device: str = "cuda",
) -> Callable[[Dict[str, Any]], Tuple[int, Dict[str, Any]]]:
    """The ``POST /rollout`` implementation: resolve+verify the named
    registry version, install its launch spec, and start a
    :class:`RolloutController` — one at a time (409 while one is
    active). Returns ``(http_code, json_body)``."""
    lock = threading.Lock()

    def start(payload: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        name = payload.get("name")
        if not isinstance(name, str) or not name:
            return 400, {"error": "body must carry the model version "
                                  '{"name": "<registered name>"}'}
        overrides = {}
        for key in ("bake_s", "rollback_error_pct", "rollback_p99_x",
                    "ready_timeout_s"):
            val = payload.get(key)
            if val is None:
                continue
            if not isinstance(val, (int, float)) or val < 0:
                return 400, {"error": f"{key} must be a non-negative "
                                      "number"}
            overrides[key] = float(val)
        with lock:
            ctl = fleet.rollout
            if ctl is not None and ctl.active():
                return 409, {
                    "error": "a rollout is already in progress",
                    "status": ctl.status(),
                }
            job = getattr(fleet, "job", None)
            if job is not None and job.active():
                # a rollout mid-job would splice two versions' contigs
                # into one FASTA, the mix the job's journal identity
                # refuses; the job starter refuses the mirror race
                return 409, {
                    "error": "a distributed polish job is running; "
                             "refusing to roll worker versions "
                             "underneath it",
                    "job": job.snapshot(),
                }
            if fleet.active_version == name:
                return 409, {
                    "error": f"fleet is already on version {name!r}",
                }
            try:
                entry = resolve_model(
                    resolve_registry_dir(fleet.fleet_cfg.registry_dir),
                    name,
                )
            except RegistryError as e:
                return 400, {"error": str(e)}
            # ALWAYS rebuild the spec from the freshly verified entry —
            # a version re-registered (--force) since a failed attempt
            # must roll out its NEW bytes, not a stale cached spec. The
            # admission check runs FIRST: building a spec writes the
            # per-version worker config, and a refused swap must not
            # have already changed what a live worker's next
            # crash-restart would run.
            if not fleet.spec_installable(name):
                return 409, {
                    "error": f"launch spec {name!r} is live on the "
                             "fleet; refusing to swap it underneath "
                             "running workers",
                }
            # a bundle-only version (no params pinned) rolls out
            # against the fleet's CURRENT incumbent checkpoint — the
            # active spec's params, which after an earlier rollout is
            # NOT the checkpoint the CLI was started with
            incumbent_params = (
                fleet.launch_spec().meta.get("model_path") or model_path
            )
            try:
                fleet.add_launch_spec(
                    worker_launch_spec(
                        name,
                        entry.get("params_path") or incumbent_params,
                        _version_config(cfg, entry),
                        fleet.runtime_dir,
                        meta={"bundle_digest": entry["bundle_digest"]},
                        device=device,
                    )
                )
            except ValueError as e:  # raced; the backstop still holds
                return 409, {"error": str(e)}
            ctl = RolloutController(
                fleet, name, journal=journal, log=log, **overrides
            )
            fleet.rollout = ctl
            ctl.start()
            return 202, ctl.status()

    return start


class Autoscaler:
    """Backlog-driven worker-count control loop (the reference's docs/SERVING.md
    "Multi-tenant & elastic fleet").

    Pure decision logic over an injected fleet + clock so tests drive
    it synchronously: each :meth:`tick` smooths backlog-per-worker with
    an EMA, then

    - **scales UP fast** — +1 worker whenever the smoothed backlog
      exceeds ``autoscale_up_backlog`` windows/worker, the cooldown has
      passed, and the fleet is below ``max_workers``;
    - **scales DOWN slowly** — −1 worker only after the smoothed
      backlog has stayed at or below ``autoscale_down_backlog`` for a
      CONTINUOUS ``autoscale_idle_s`` stretch (any excursion above
      resets the stretch), re-arming the stretch per step down;
    - **parks background jobs** — ``fleet.jobs_parked`` flips on when
      interactive backlog spikes past the up threshold and off once it
      falls back under the down threshold (a distributed polish job
      dispatches no new unit while it is set; ``pipeline/distpolish.py``).

    The up threshold strictly above the down threshold (enforced by
    FleetConfig) plus the idle-stretch requirement is the hysteresis
    band: oscillating load rides inside it without flapping the worker
    count. Enabled only when the configured bounds leave room
    (``max_workers > min_workers``)."""

    def __init__(
        self,
        fleet: Fleet,
        *,
        log: Callable[[str], None] = print,
        clock: Callable[[], float] = time.monotonic,
    ):
        fc = fleet.fleet_cfg
        self.fleet = fleet
        self.fc = fc
        self.min_workers = max(1, fc.min_workers or fc.workers)
        self.max_workers = max(
            self.min_workers, fc.max_workers or fc.workers
        )
        self.enabled = self.max_workers > self.min_workers
        self._log = log
        self._clock = clock
        self.ema: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last_change: Optional[float] = None

    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One control decision; returns ``"up"``/``"down"`` when the
        fleet was resized, None otherwise (parking alone returns
        None)."""
        fc = self.fc
        fleet = self.fleet
        now = self._clock() if now is None else now
        n = len(fleet.workers)
        per_worker = fleet.backlog_windows() / max(1, n)
        if self.ema is None:
            self.ema = float(per_worker)
        else:
            self.ema = (
                fc.autoscale_ema_beta * self.ema
                + (1.0 - fc.autoscale_ema_beta) * per_worker
            )
        ema = self.ema
        # park/resume is independent of sizing headroom: even a fleet
        # pinned at max_workers sheds its background job while
        # interactive backlog spikes
        if ema > fc.autoscale_up_backlog:
            if not fleet.jobs_parked:
                fleet.jobs_parked = True
                self._log(
                    f"roko autoscale: backlog {ema:.1f} windows/worker — "
                    "parking background jobs"
                )
        elif ema <= fc.autoscale_down_backlog and fleet.jobs_parked:
            fleet.jobs_parked = False
            self._log(
                "roko autoscale: backlog drained — resuming background "
                "jobs"
            )
        if not self.enabled:
            return None
        cooled = (
            self._last_change is None
            or now - self._last_change >= fc.autoscale_cooldown_s
        )
        if ema > fc.autoscale_up_backlog:
            self._idle_since = None
            if n < self.max_workers and cooled:
                fleet.scale_to(
                    n + 1,
                    reason=f"backlog {ema:.1f} windows/worker > "
                           f"{fc.autoscale_up_backlog:g}",
                )
                self._last_change = now
                return "up"
            return None
        if ema > fc.autoscale_down_backlog:
            # inside the hysteresis band: hold, and any prior idle
            # stretch is void
            self._idle_since = None
            return None
        if self._idle_since is None:
            self._idle_since = now
            return None
        if (
            n > self.min_workers
            and cooled
            and now - self._idle_since >= fc.autoscale_idle_s
        ):
            fleet.scale_to(
                n - 1,
                reason=f"backlog {ema:.1f} windows/worker idle for "
                       f"{now - self._idle_since:.0f}s",
            )
            self._last_change = now
            self._idle_since = now  # next step down needs a fresh stretch
            return "down"
        return None


def start_autoscaler(
    fleet: Fleet,
    stop: threading.Event,
    *,
    log: Callable[[str], None] = print,
) -> Optional[Autoscaler]:
    """Spin the autoscale control thread when the config leaves room
    (``max_workers > min_workers`` effective); returns the Autoscaler
    (or None when fixed-size)."""
    scaler = Autoscaler(fleet, log=log)
    if not scaler.enabled:
        return None

    def loop() -> None:
        while not stop.is_set():
            try:
                scaler.tick()
            except Exception as e:  # pragma: no cover - defensive
                log(f"roko autoscale: tick failed: {e!r}")
            stop.wait(fleet.fleet_cfg.autoscale_interval_s)

    threading.Thread(
        target=loop, name="roko-fleet-autoscale", daemon=True
    ).start()
    log(
        f"roko autoscale: elastic fleet {scaler.min_workers}.."
        f"{scaler.max_workers} workers (up>"
        f"{fleet.fleet_cfg.autoscale_up_backlog:g}, down<="
        f"{fleet.fleet_cfg.autoscale_down_backlog:g} windows/worker)"
    )
    return scaler


def rolling_drain(
    server: ThreadingHTTPServer, fleet: Fleet, log=print
) -> None:
    """SIGTERM path: drain the front end (reject new, finish in-flight
    relays, stop the accept loop), THEN terminate workers one at a
    time — each worker drains its own in-flight before the next is
    touched."""
    drain(server, log=log)
    log("roko fleet: rolling worker drain")
    fleet.stop(rolling=True)


def boot_fleet(
    model_path: str,
    cfg: RokoConfig,
    *,
    log=print,
    device: str = "cuda",
) -> Tuple[Fleet, RolloutJournal, Optional[Dict[str, Any]], str, str,
           RokoConfig]:
    """Everything between "a config" and "a Fleet ready to start()":
    journal-driven rollout recovery, landed-version re-pinning, the
    boot launch spec, and the A/B lane (shared with the federation's host
    agent, ``serve/federation.run_host_agent``). Returns ``(fleet, journal, recovery,
    boot_version, boot_model, boot_cfg)``."""
    fleet = Fleet(
        cfg,
        worker_command=(lambda *_: []),  # placeholder; boot spec below
        log=log,
    )
    fc = cfg.fleet
    os.makedirs(fleet.runtime_dir, exist_ok=True)
    journal = RolloutJournal(
        os.path.join(fleet.runtime_dir, RolloutJournal.FILENAME)
    )
    current = CurrentVersionFile(
        os.path.join(fleet.runtime_dir, CurrentVersionFile.FILENAME)
    )
    boot_version, boot_model, boot_cfg = BOOT_VERSION, model_path, cfg
    recovery = recover_rollout(journal, log)
    if recovery is not None:
        rec = recovery["record"]
        side = rec["to"] if recovery["action"] == "finalize" else rec["from"]
        boot_version = side.get("version") or BOOT_VERSION
        boot_model = side.get("model_path") or model_path
        boot_cfg = _version_config(cfg, side)
        # keep the landed-version pointer consistent with the decision
        if boot_version == BOOT_VERSION:
            current.delete()
        else:
            current.write(side)
    else:
        # no interrupted rollout — but a COMPLETED one must survive a
        # plain supervisor restart: re-pin the landed version instead
        # of silently re-booting the CLI-named incumbent
        pinned = current.load(log)
        if pinned and (pinned.get("version") or BOOT_VERSION) != BOOT_VERSION:
            boot_version = pinned["version"]
            boot_model = pinned.get("model_path") or model_path
            boot_cfg = _version_config(cfg, pinned)
            obs_events.emit(
                "rollout", "version_pinned", log=log,
                suffix="— restart re-pins the landed rollout version",
                version=boot_version,
                bundle_digest=str(pinned.get("bundle_digest", "?"))[:12],
            )
    fleet.install_boot_spec(
        worker_launch_spec(
            boot_version, boot_model, boot_cfg, fleet.runtime_dir,
            device=device,
        )
    )
    if fc.ab_version:
        # A/B model lane: register the candidate version's launch spec
        # and re-target the highest-id worker slice BEFORE start(), so
        # the lane boots in one spawn sweep. A bad lane config refuses
        # the whole boot — a supervisor silently serving 100% incumbent
        # under a configured experiment is the failure mode to refuse.
        try:
            entry = resolve_model(
                resolve_registry_dir(fc.registry_dir), fc.ab_version
            )
        except RegistryError as e:
            raise RegistryError(
                f"--ab-lane version {fc.ab_version!r} refused: {e}"
            ) from e
        fleet.add_launch_spec(
            worker_launch_spec(
                fc.ab_version,
                entry.get("params_path") or boot_model,
                _version_config(boot_cfg, entry),
                fleet.runtime_dir,
                meta={"bundle_digest": entry["bundle_digest"]},
                device=device,
            )
        )
        n_ab = min(
            max(1, round(fc.ab_fraction * len(fleet.workers))),
            max(0, len(fleet.workers) - 1),
        )
        for w in fleet.workers[len(fleet.workers) - n_ab:]:
            w.version = w.target_version = fc.ab_version
        log(
            f"roko fleet: A/B lane {fc.ab_version!r} on {n_ab} "
            f"worker(s), {fc.ab_fraction:.0%} of unpinned traffic"
        )
    return fleet, journal, recovery, boot_version, boot_model, boot_cfg


def run_supervisor(
    model_path: str,
    cfg: RokoConfig,
    *,
    announce: Optional[str] = None,
    log=print,
    device: str = "cuda",
) -> int:
    """The ``python -m roko_tpu_torch serve --workers N`` entry point: spawn the fleet,
    bind the front end, serve until SIGTERM/Ctrl-C. ``announce`` (used
    by tests/automation) writes ``{"pid", "port"}`` once the front-end
    socket is bound — the same contract workers honour.

    Before anything spawns, the rollout journal in the runtime dir is
    consulted: a supervisor killed mid-rollout restarts onto ONE
    version — finalized forward when every worker had already rolled,
    reverted to the journaled incumbent otherwise — loudly, never a
    silently mixed fleet (``serve/rollout.py``)."""
    # idempotent for CLI callers (cmd_serve already resolved); the real
    # guard for programmatic users: --workers auto resolves against the
    # visible cards and an oversubscribing worker x slice combination
    # refuses before anything spawns — all without initialising CUDA
    from roko_tpu_torch.parallel.mesh import resolve_fleet_topology

    fc = resolve_fleet_topology(cfg.fleet, backend=device)
    if fc is not cfg.fleet:
        cfg = dataclasses.replace(cfg, fleet=fc)
    fleet, journal, recovery, boot_version, boot_model, boot_cfg = (
        boot_fleet(model_path, cfg, log=log, device=device)
    )

    server = make_front_server(fleet)
    if fc.ab_version and fc.ab_fraction > 0:
        server._ab_lane = (fc.ab_version, fc.ab_fraction)  # type: ignore[attr-defined]
    # the starter's fallback identity is what the fleet actually BOOTED
    # (a recovered/pinned version, not necessarily the CLI args)
    server._start_rollout = make_rollout_starter(  # type: ignore[attr-defined]
        fleet, journal, boot_model, boot_cfg, log=log, device=device
    )
    # distributed polish jobs over this fleet (POST /job, GET /jobz)
    from roko_tpu_torch.pipeline.distpolish import make_job_starter

    server._start_job = make_job_starter(  # type: ignore[attr-defined]
        fleet, boot_cfg, log=log
    )
    if announce:
        write_announce(announce, server.server_address[1])
    log(
        f"roko fleet: supervising {fc.workers} worker(s) "
        f"(runtime dir {fleet.runtime_dir}, version {boot_version}); "
        "front end binding"
    )
    fleet.start()
    if recovery is not None:
        # every worker just spawned from the one recovered spec — the
        # fleet is uniform again and the journal has done its job
        journal.delete()
    autoscale_stop = threading.Event()
    fleet.autoscaler = start_autoscaler(  # type: ignore[attr-defined]
        fleet, autoscale_stop, log=log
    )
    try:
        serve_forever(
            server,
            log=log,
            drain_fn=lambda: rolling_drain(server, fleet, log=log),
        )
    finally:
        autoscale_stop.set()
        # Ctrl-C / accept-loop exit: make sure no worker outlives the
        # supervisor (stop() is idempotent — a completed rolling drain
        # already did this)
        fleet.stop(rolling=False)
    return 0
