"""Multi-host fleet federation (the port's copy of
``roko_tpu/serve/federation.py``).

Everything below one host (worker failover, rollout, autoscaling)
discovers workers through an announce FILE in a shared runtime dir,
which stops at the host boundary. This module is the
supervisor-of-supervisors seam: it federates many per-host fleets behind
one front end over TCP, built to survive what fails first at that scale,
the network.

Topology::

    client ──HTTP──▶ federation front (this module)
                       │  lease/epoch registry + per-host breakers
          ┌────────────┼────────────┐
          ▼            ▼            ▼
      host agent   host agent   host agent   (serve MODEL --host-agent)
       Fleet(N)     Fleet(N)     Fleet(N)    (serve/fleet.py, unchanged)
        workers      workers      workers

- **Host agent** (:func:`run_host_agent`): a full supervisor (the same
  Fleet, rollout journal recovery, autoscaler and ``POST /job``) that
  also *joins* a federation front (``--join HOST:PORT``) and keeps its
  registration alive.
- **Lease/epoch registry** (:class:`HostRegistry`): registration is a
  lease (a TTL renewed by the agent's heartbeat; expiry takes the host
  out of rotation). Registering again bumps an **epoch**. Relays carry
  the epoch (``X-Roko-Fed-Epoch``) and every agent reply echoes its own:
  a zombie of a stale lease is *fenced*: it refuses mismatched relays
  with 409, and even a zombie that ignores the header has its reply
  refused at the front when the echoed epoch is stale. A fenced reply
  is NEVER served.
- **Partition-tolerant routing** (:meth:`FederationFront.post_polish`):
  a :class:`~roko_tpu_torch.resilience.CircuitBreaker` per host, failover
  across hosts mid-request that keeps ``request_id``, a degraded mode on
  the survivors with loud ``federation`` events, per-host state on
  ``/healthz``.
- **Chaos**: the agent's heartbeat socket and the front's relay socket
  both go through :mod:`roko_tpu_torch.serve.transport`, so
  ``ROKO_FED_FAULTS`` drives real multi-process fleets through scripted
  drops, delays, duplicates and partitions on loopback.
- **Host-dimension rollout and autoscale**: ``POST /rollout`` at the
  front rolls one host at a time through each agent's own drain, bake
  and canary gates; :class:`HostAutoscaler` resizes each host's worker
  count through the agent's ``POST /scale``.

The front never touches the card: it loads no model. This module imports
no torch; a host agent's workers are ``serve`` processes that do.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import time
from http.server import ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from roko_tpu_torch.config import RokoConfig
from roko_tpu_torch.obs import events as obs_events
from roko_tpu_torch.obs.hist import (
    merge_histogram_rows,
    parse_histogram_rows,
    render_histogram_rows,
)
from roko_tpu_torch.obs.trace import new_request_id
from roko_tpu_torch.resilience import CircuitBreaker
from roko_tpu_torch.serve.httpbase import (
    _NAME_RE,
    JsonRequestHandler,
    drain,
    init_lifecycle,
    request_tenant,
    serve_forever,
    write_announce,
)
from roko_tpu_torch.serve.metrics import (
    HISTOGRAM_SERIES,
    parse_metric_values,
)
from roko_tpu_torch.serve.transport import transport_from_env

#: the fencing token: relays carry the registry's epoch for the target
#: host; agents refuse mismatches and echo their own epoch on every
#: reply so the front end can refuse a stale reply it did not fence at
#: the source.
FED_EPOCH_HEADER = "X-Roko-Fed-Epoch"

#: which host served a reply (set by the front end on the way out) —
#: lets clients and gates observe cross-host failover without parsing
#: logs.
FED_HOST_HEADER = "X-Roko-Host"

_CONN_ERRORS = (OSError, http.client.HTTPException)

#: /metrics gauge encoding for per-host state
HOST_STATE_CODES = {"live": 0, "breaker-open": 1, "expired": 2}

FEDERATION_COUNTERS = (
    "registrations", "lease_expiries", "fence_refusals", "relays",
    "failovers",
)


class HostLease:
    """One registered host: address, lease token, epoch, breaker."""

    def __init__(
        self,
        host_id: str,
        host: str,
        port: int,
        *,
        epoch: int,
        lease_id: str,
        expires_at: float,
        breaker: CircuitBreaker,
        workers: int = 0,
        pid: Optional[int] = None,
    ):
        self.host_id = host_id
        self.host = host
        self.port = port
        self.epoch = epoch
        self.lease_id = lease_id
        self.expires_at = expires_at
        self.breaker = breaker
        self.workers = workers
        self.pid = pid
        self.expired = False

    def state(self) -> str:
        if self.expired:
            return "expired"
        if self.breaker.state == "open":
            return "breaker-open"
        return "live"

    def addr(self) -> str:
        return f"{self.host}:{self.port}"


class HostRegistry:
    """The front end's worker registry, one level up from the announce
    file: hosts register over TCP and stay in rotation only while
    their lease is renewed.

    Lease semantics (the edge matrix tests pin every row):

    - expiry takes a host out of rotation for NEW picks; an in-flight
      relay's reply is still served (the epoch did not change —
      expiry alone proves nothing about staleness);
    - renewal with a stale/unknown ``lease_id`` — or against an
      expired lease — is refused, forcing the agent to re-register;
    - re-registration (restarted agent, healed partition) bumps the
      host's **epoch** and replaces the lease in place: one entry per
      ``host_id``, never duplicates;
    - only an epoch mismatch *fences* — the zombie-from-a-stale-lease
      case, refused at the agent AND on reply at the front end.
    """

    def __init__(
        self,
        ttl_s: float = 10.0,
        *,
        breaker_failures: int = 3,
        breaker_reset_s: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
        log: Callable[[str], None] = print,
    ):
        if ttl_s <= 0:
            raise ValueError("lease ttl_s must be > 0")
        self.ttl_s = ttl_s
        self._breaker_failures = breaker_failures
        self._breaker_reset_s = breaker_reset_s
        self._clock = clock
        self._log = log
        self._lock = threading.Lock()
        self._hosts: Dict[str, HostLease] = {}
        #: epochs survive lease replacement AND removal: a host that
        #: flaps through many partitions keeps bumping monotonically,
        #: so no stale process can ever collide back into validity
        self._epochs: Dict[str, int] = {}
        self._rr = 0
        self._counters = {k: 0 for k in FEDERATION_COUNTERS}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] += n

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters[name]

    def register(
        self,
        host_id: str,
        host: str,
        port: int,
        *,
        workers: int = 0,
        pid: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Grant (or re-grant) a lease. Returns the body the agent
        stores: ``{lease_id, epoch, ttl_s}``."""
        with self._lock:
            epoch = self._epochs.get(host_id, 0) + 1
            self._epochs[host_id] = epoch
            rejoin = host_id in self._hosts
            lease = HostLease(
                host_id, host, port,
                epoch=epoch,
                lease_id=os.urandom(8).hex(),
                expires_at=self._clock() + self.ttl_s,
                # a fresh breaker per registration: the host just
                # proved it can reach us, so it re-enters rotation
                # clean instead of inheriting an open breaker from its
                # previous life
                breaker=CircuitBreaker(
                    self._breaker_failures,
                    self._breaker_reset_s,
                    clock=self._clock,
                ),
                workers=workers,
                pid=pid,
            )
            self._hosts[host_id] = lease
            self._counters["registrations"] += 1
        obs_events.emit(
            "federation",
            "host_rejoined" if rejoin else "host_joined",
            log=self._log,
            host=host_id, addr=lease.addr(), epoch=epoch,
            workers=workers,
        )
        return {
            "lease_id": lease.lease_id,
            "epoch": epoch,
            "ttl_s": self.ttl_s,
        }

    def renew(
        self, host_id: str, lease_id: str
    ) -> Optional[Dict[str, Any]]:
        """Extend a live lease. None = refused (unknown host, stale
        lease_id, or expired lease) — the agent must re-register and
        adopt the bumped epoch."""
        with self._lock:
            lease = self._hosts.get(host_id)
            if (
                lease is None
                or lease.lease_id != lease_id
                or lease.expired
            ):
                return None
            lease.expires_at = self._clock() + self.ttl_s
            return {"ttl_s": self.ttl_s, "epoch": lease.epoch}

    def sweep(self, now: Optional[float] = None) -> List[str]:
        """Expire overdue leases (out of rotation for new picks; the
        epoch is NOT bumped — see class docstring). Returns the newly
        expired host ids."""
        now = self._clock() if now is None else now
        expired: List[str] = []
        with self._lock:
            for lease in self._hosts.values():
                if not lease.expired and lease.expires_at < now:
                    lease.expired = True
                    self._counters["lease_expiries"] += 1
                    expired.append(lease.host_id)
        for host_id in expired:
            obs_events.emit(
                "federation", "lease_expired", log=self._log,
                suffix="— host out of rotation until it re-registers",
                host=host_id,
            )
        return expired

    def current_epoch(self, host_id: str) -> int:
        with self._lock:
            return self._epochs.get(host_id, 0)

    def hosts(self) -> List[HostLease]:
        with self._lock:
            return list(self._hosts.values())

    def live(self) -> List[HostLease]:
        with self._lock:
            return [l for l in self._hosts.values() if not l.expired]

    def get(self, host_id: str) -> Optional[HostLease]:
        with self._lock:
            return self._hosts.get(host_id)

    def pick(self, exclude: Tuple[str, ...] = ()) -> Optional[HostLease]:
        """Round-robin over unexpired hosts whose breaker admits a
        request (half-open claims the probe slot, same contract as the
        worker-level breaker)."""
        with self._lock:
            candidates = [
                l for l in self._hosts.values()
                if not l.expired and l.host_id not in exclude
            ]
            self._rr += 1
            offset = self._rr
        n = len(candidates)
        for i in range(n):
            lease = candidates[(offset + i) % n]
            if lease.breaker.allow():
                return lease
        return None


class FederationRollout:
    """Host-dimension rollout: relay ``POST /rollout`` to one agent at
    a time and wait for its own drain/bake/canary gates to land before
    touching the next host — a canary failure on host 0 never reaches
    host 1."""

    def __init__(
        self,
        front: "FederationFront",
        payload: Dict[str, Any],
        *,
        log: Callable[[str], None] = print,
    ):
        self.front = front
        self.payload = dict(payload)
        self.name = str(payload.get("name", ""))
        self._log = log
        self.state = "idle"
        self.hosts: Dict[str, Dict[str, Any]] = {}
        self._thread: Optional[threading.Thread] = None

    def active(self) -> bool:
        return self.state == "rolling"

    def status(self) -> Dict[str, Any]:
        return {
            "state": self.state,
            "name": self.name,
            "hosts": dict(self.hosts),
        }

    def start(self) -> None:
        self.state = "rolling"
        self._thread = threading.Thread(
            target=self._run, name="roko-federation-rollout", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        front = self.front
        timeout = front.fleet_cfg.rollout_ready_timeout_s
        for lease in front.registry.live():
            hid = lease.host_id
            obs_events.emit(
                "federation", "host_rollout", log=self._log,
                host=hid, version=self.name,
            )
            try:
                code, _, data = front.transport(
                    "POST", lease.host, lease.port, "/rollout",
                    headers={"Content-Type": "application/json"},
                    body=json.dumps(self.payload).encode(),
                    timeout=10.0, peer=hid,
                )
            except _CONN_ERRORS as e:
                self.hosts[hid] = {"state": "unreachable",
                                   "error": type(e).__name__}
                self.state = "failed"
                return
            if code != 202:
                self.hosts[hid] = {
                    "state": "refused", "code": code,
                    "error": data.decode(errors="replace")[:300],
                }
                self.state = "failed"
                return
            final = self._await_host(lease, timeout)
            self.hosts[hid] = final
            if final.get("state") != "done":
                # the host's own gates rolled it back (or it vanished):
                # stop the wave — the remaining hosts keep the incumbent
                self.state = "failed"
                obs_events.emit(
                    "federation", "host_rollout_failed", log=self._log,
                    host=hid, version=self.name,
                    state=str(final.get("state")),
                )
                return
        self.state = "done"

    def _await_host(
        self, lease: HostLease, timeout_s: float
    ) -> Dict[str, Any]:
        front = self.front
        deadline = time.monotonic() + timeout_s
        last: Dict[str, Any] = {"state": "unknown"}
        while time.monotonic() < deadline:
            try:
                _, _, data = front.transport(
                    "GET", lease.host, lease.port, "/rollout",
                    timeout=5.0, peer=lease.host_id,
                )
                last = json.loads(data.decode() or "{}")
            except (_CONN_ERRORS, ValueError):
                time.sleep(0.5)
                continue
            if last.get("state") in (
                "done", "failed", "rolled_back", "idle"
            ):
                return last
            time.sleep(0.5)
        last.setdefault("state", "timeout")
        if last.get("state") == "rolling":
            last["state"] = "timeout"
        return last


class FederationFront:
    """The federated router: lease registry + per-host breakers +
    cross-host failover, surfaced over the same front-end HTTP shape
    the single-host supervisor serves."""

    def __init__(
        self,
        cfg: RokoConfig,
        *,
        transport=None,
        clock: Callable[[], float] = time.monotonic,
        log: Callable[[str], None] = print,
    ):
        fc = cfg.fleet
        self.cfg = cfg
        self.fleet_cfg = fc
        self._log = log
        self._clock = clock
        self.registry = HostRegistry(
            fc.lease_ttl_s,
            breaker_failures=fc.fed_breaker_failures,
            breaker_reset_s=fc.fed_breaker_reset_s,
            clock=clock,
            log=log,
        )
        self.transport = transport or transport_from_env("front")
        self.rollout: Optional[FederationRollout] = None
        self.autoscaler: Optional[HostAutoscaler] = None
        self._rollout_lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Spin the lease sweeper (and the host autoscaler when the
        config leaves room)."""

        def sweep_loop() -> None:
            while not self._stop.is_set():
                try:
                    self.registry.sweep()
                except Exception as e:  # pragma: no cover - defensive
                    self._log(f"roko federation: sweep failed: {e!r}")
                self._stop.wait(max(0.05, self.registry.ttl_s / 4.0))

        t = threading.Thread(
            target=sweep_loop, name="roko-federation-sweep", daemon=True
        )
        t.start()
        self._threads.append(t)
        scaler = HostAutoscaler(self, log=self._log, clock=self._clock)
        if scaler.enabled:
            self.autoscaler = scaler

            def scale_loop() -> None:
                while not self._stop.is_set():
                    try:
                        scaler.tick()
                    except Exception as e:  # pragma: no cover
                        self._log(
                            f"roko federation: autoscale tick failed: {e!r}"
                        )
                    self._stop.wait(self.fleet_cfg.autoscale_interval_s)

            ts = threading.Thread(
                target=scale_loop, name="roko-federation-autoscale",
                daemon=True,
            )
            ts.start()
            self._threads.append(ts)

    def stop(self) -> None:
        self._stop.set()

    # -- routing -------------------------------------------------------------

    def _breaker_failure(self, lease: HostLease, why: str) -> None:
        prev = lease.breaker.state
        lease.breaker.record_failure()
        if lease.breaker.state == "open" and prev != "open":
            obs_events.emit(
                "federation", "host_down", log=self._log,
                suffix="— breaker open; serving on the survivors",
                host=lease.host_id, error=why,
            )

    def _breaker_success(self, lease: HostLease) -> None:
        prev = lease.breaker.state
        lease.breaker.record_success()
        if prev != "closed":
            obs_events.emit(
                "federation", "host_up", log=self._log,
                host=lease.host_id,
            )

    def post_polish(
        self,
        body: bytes,
        timeout: Optional[float] = None,
        request_id: Optional[str] = None,
        tenant: Optional[str] = None,
        model_version: Optional[str] = None,
        pinned: bool = False,
    ) -> Tuple[int, bytes, Dict[str, str]]:
        """Route one polish body to a host agent with cross-host
        failover. The contract is :meth:`Fleet.post_polish`'s one level
        up: ``request_id`` rides every dispatch (the failover's dispatch
        to ANOTHER HOST too), connection failures try the next host, 503s
        collect the largest Retry-After, and a reply whose echoed epoch
        does not match the relay's is a **fence refusal**: counted,
        logged loudly, and never served."""
        registry = self.registry
        tried: List[str] = []
        retry_after: Optional[float] = None
        attempts = max(1, self.fleet_cfg.failover_attempts)
        for _ in range(attempts):
            lease = registry.pick(exclude=tuple(tried))
            if lease is None:
                break
            tried.append(lease.host_id)
            epoch = lease.epoch
            if request_id is not None:
                obs_events.emit(
                    "federation", "dispatch", quiet=True,
                    request_id=request_id, host=lease.host_id,
                    epoch=epoch, attempt=len(tried),
                )
            headers = {
                "Content-Type": "application/json",
                FED_EPOCH_HEADER: str(epoch),
            }
            if request_id is not None:
                headers["X-Roko-Request-Id"] = request_id
            if tenant is not None:
                headers["X-Roko-Tenant"] = tenant
            if pinned and model_version is not None:
                headers["X-Roko-Model"] = model_version
            try:
                code, hdrs, reply = self.transport(
                    "POST", lease.host, lease.port, "/polish",
                    headers=headers, body=body,
                    timeout=120.0 if timeout is None else timeout,
                    peer=lease.host_id,
                )
            except _CONN_ERRORS as e:
                registry.inc("failovers")
                self._breaker_failure(lease, type(e).__name__)
                self._log(
                    f"roko federation: host {lease.host_id} dropped a "
                    f"request ({type(e).__name__}); failing over"
                )
                if request_id is not None:
                    obs_events.emit(
                        "federation", "failover", quiet=True,
                        request_id=request_id, host=lease.host_id,
                        error=type(e).__name__,
                    )
                continue
            hdrs = {k.title(): v for k, v in hdrs.items()}
            echo = hdrs.get(FED_EPOCH_HEADER.title())
            if code == 409 and b"fenced" in reply:
                # the agent fenced the relay at the source: its epoch
                # does not match the registry's — a zombie (or a racing
                # re-registration). Never serve; the request fails over.
                registry.inc("fence_refusals")
                lease.breaker.cancel_probe()
                obs_events.emit(
                    "federation", "fence_refusal", log=self._log,
                    request_id=request_id, host=lease.host_id,
                    expected_epoch=epoch, where="agent",
                )
                continue
            if echo is not None and echo != str(epoch):
                # the reply came back under the WRONG epoch: a stale
                # process answered on a recycled address. Refusing here
                # is the last line of the fence — the reply is dropped,
                # never served.
                registry.inc("fence_refusals")
                lease.breaker.cancel_probe()
                obs_events.emit(
                    "federation", "fence_refusal", log=self._log,
                    suffix="— stale-epoch reply refused, never served",
                    request_id=request_id, host=lease.host_id,
                    expected_epoch=epoch, reply_epoch=echo,
                    where="reply",
                )
                continue
            if code == 503:
                # the host answered — alive, just saturated/draining
                self._breaker_success(lease)
                hint = 0.0
                try:
                    hint = float(hdrs.get("Retry-After", 0))
                except ValueError:
                    pass
                try:
                    hint = max(
                        hint,
                        float(json.loads(reply.decode() or "{}").get(
                            "retry_after_s", 0)),
                    )
                except (ValueError, AttributeError):
                    pass
                retry_after = max(retry_after or 0.0, hint)
                continue
            self._breaker_success(lease)
            if code == 429:
                keep = {
                    k: v for k, v in hdrs.items()
                    if k.lower() == "retry-after"
                }
                keep[FED_HOST_HEADER] = lease.host_id
                return code, reply, keep
            registry.inc("relays")
            return code, reply, {FED_HOST_HEADER: lease.host_id}
        if retry_after is None:
            retry_after = float(self.cfg.serve.retry_after_s)
        body_out = json.dumps({
            "error": "no federated host available "
                     "(all hosts down, fenced, or saturated)",
            "retry_after_s": retry_after,
        }).encode()
        return 503, body_out, {
            "Retry-After": f"{max(1, round(retry_after))}"
        }

    # -- registration plumbing (the /fed/* handlers) -------------------------

    def handle_register(
        self, payload: Dict[str, Any]
    ) -> Tuple[int, Dict[str, Any]]:
        host_id = payload.get("host_id")
        port = payload.get("port")
        if not isinstance(host_id, str) or not host_id:
            return 400, {"error": "host_id must be a non-empty string"}
        if not isinstance(port, int) or not (0 < port < 65536):
            return 400, {"error": "port must be an int in (0, 65536)"}
        host = payload.get("host") or "127.0.0.1"
        workers = payload.get("workers") or 0
        pid = payload.get("pid")
        return 200, self.registry.register(
            host_id, str(host), port,
            workers=int(workers),
            pid=int(pid) if isinstance(pid, int) else None,
        )

    def handle_renew(
        self, payload: Dict[str, Any]
    ) -> Tuple[int, Dict[str, Any]]:
        host_id = payload.get("host_id")
        lease_id = payload.get("lease_id")
        if not isinstance(host_id, str) or not isinstance(lease_id, str):
            return 400, {"error": "body must carry host_id and lease_id"}
        out = self.registry.renew(host_id, lease_id)
        if out is None:
            return 404, {
                "error": f"no live lease for host {host_id!r} — "
                         "re-register",
            }
        return 200, out

    # -- operator surfaces ---------------------------------------------------

    def start_rollout(
        self, payload: Dict[str, Any]
    ) -> Tuple[int, Dict[str, Any]]:
        name = payload.get("name")
        if not isinstance(name, str) or not name:
            return 400, {"error": "body must carry the model version "
                                  '{"name": "<registered name>"}'}
        with self._rollout_lock:
            if self.rollout is not None and self.rollout.active():
                return 409, {
                    "error": "a federation rollout is already in progress",
                    "status": self.rollout.status(),
                }
            if not self.registry.live():
                return 503, {"error": "no live host to roll"}
            ctl = FederationRollout(self, payload, log=self._log)
            self.rollout = ctl
            ctl.start()
            return 202, ctl.status()

    def rollout_status(self) -> Dict[str, Any]:
        ctl = self.rollout
        return ctl.status() if ctl is not None else {"state": "idle"}

    def scale_host(
        self, host_id: str, workers: int
    ) -> Tuple[int, Dict[str, Any]]:
        """Relay a worker-count change to one host's agent."""
        lease = self.registry.get(host_id)
        if lease is None or lease.expired:
            return 404, {"error": f"no live host {host_id!r}"}
        try:
            code, _, data = self.transport(
                "POST", lease.host, lease.port, "/scale",
                headers={"Content-Type": "application/json"},
                body=json.dumps({"workers": workers}).encode(),
                timeout=10.0, peer=host_id,
            )
        except _CONN_ERRORS as e:
            return 503, {"error": f"host {host_id!r} unreachable: "
                                  f"{type(e).__name__}"}
        try:
            body = json.loads(data.decode() or "{}")
        except ValueError:
            body = {}
        return code, body

    # -- observation ---------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """The federation ``/healthz`` body: per-host state map +
        degraded-mode aggregate (same shape one level up from
        ``Fleet.summary``)."""
        hosts = self.registry.hosts()
        states = {
            l.host_id: {
                "state": l.state(),
                "addr": l.addr(),
                "epoch": l.epoch,
                "breaker": l.breaker.state,
                "workers": l.workers,
            }
            for l in hosts
        }
        up = sum(1 for l in hosts if l.state() == "live")
        if not hosts:
            status, code = "warming", 503
        elif up == len(hosts):
            status, code = "ok", 200
        elif up >= 1:
            status, code = "degraded", 200
        else:
            status, code = "unhealthy", 503
        return {
            "status": status,
            "code": code,
            "hosts": states,
            "hosts_up": up,
            "federation": {
                k: self.registry.counter(k) for k in FEDERATION_COUNTERS
            },
        }

    def _scrape(self, path: str) -> Dict[str, str]:
        """GET ``path`` from every unexpired host agent; unanswering
        hosts are simply absent (same contract as the fleet's worker
        scrape)."""
        out: Dict[str, str] = {}
        for lease in self.registry.live():
            try:
                _, _, data = self.transport(
                    "GET", lease.host, lease.port, path,
                    timeout=self.fleet_cfg.heartbeat_timeout_s,
                    peer=lease.host_id,
                )
                out[lease.host_id] = data.decode(errors="replace")
            except _CONN_ERRORS:
                continue
        return out

    def render_metrics(self) -> str:
        """The federation ``/metrics`` body: ``roko_federation_*``
        gauges/counters, per-host fleet gauges re-labeled
        ``host="h"``, and the third level of the mergeable-histogram
        ladder — federation rows are the bucket-wise sum of the
        host-merged rows, which are themselves worker sums
        (fleet ← host ← worker)."""
        hosts = self.registry.hosts()
        p = "roko_federation_"
        up = sum(1 for l in hosts if l.state() == "live")
        lines = [
            f"# TYPE {p}hosts gauge",
            f"{p}hosts {len(hosts)}",
            f"# TYPE {p}hosts_up gauge",
            f"{p}hosts_up {up}",
        ]
        for name in FEDERATION_COUNTERS:
            lines.append(f"# TYPE {p}{name}_total counter")
            lines.append(
                f"{p}{name}_total {self.registry.counter(name)}"
            )
        lines.append(f"# TYPE {p}host_state gauge")
        for l in hosts:
            lines.append(
                f'{p}host_state{{host="{l.host_id}"}} '
                f"{HOST_STATE_CODES.get(l.state(), 9)}"
            )
        lines.append(f"# TYPE {p}host_epoch gauge")
        for l in hosts:
            lines.append(
                f'{p}host_epoch{{host="{l.host_id}"}} {l.epoch}'
            )
        bodies = self._scrape("/metrics")
        # per-host fleet sizing, re-labeled by host
        for name in ("roko_fleet_workers", "roko_fleet_workers_up"):
            rows = [
                (hid, vals[name])
                for hid, body in sorted(bodies.items())
                for vals in [parse_metric_values(body, (name,))]
                if name in vals
            ]
            if not rows:
                continue
            lines.append(f"# TYPE {name} gauge")
            for hid, val in rows:
                lines.append(f'{name}{{host="{hid}"}} {val}')
        # the histogram ladder's top rung: each agent body's UNLABELED
        # rows are already its worker-merged fleet rows, so the
        # federation row is their bucket-wise sum; every host's full
        # row set (including worker="i" rows) re-exports beside it
        # with host="h" appended
        for name in HISTOGRAM_SERIES:
            per_host = {
                hid: parse_histogram_rows(body, name)
                for hid, body in sorted(bodies.items())
            }
            merged = merge_histogram_rows(
                {
                    k: v for k, v in rows.items()
                    if "worker" not in dict(k)
                    and all(lk in ("__series__", "le")
                            for lk, _ in k)
                }
                for rows in per_host.values()
            )
            if not merged:
                continue
            lines.append(f"# TYPE {name} histogram")
            lines.extend(render_histogram_rows(name, merged))
            for hid, rows in per_host.items():
                lines.extend(
                    render_histogram_rows(
                        name, rows, extra=f'host="{hid}"'
                    )
                )
        return "\n".join(lines) + "\n"

    def tracez(self, query: str = "") -> Dict[str, Any]:
        """Aggregate trace view keyed by host id — one request_id greps
        across the whole federation, hosts included."""
        out: Dict[str, Any] = {}
        path = f"/tracez?{query}" if query else "/tracez"
        for hid, body in self._scrape(path).items():
            try:
                out[hid] = json.loads(body)
            except ValueError:
                out[hid] = {"error": "unparseable tracez body"}
        return out


class HostAutoscaler:
    """The fleet's autoscaler lifted to the host dimension: per-host
    backlog EMA with the same hysteresis band (up fast past
    ``autoscale_up_backlog``, down only after a continuous
    ``autoscale_idle_s`` stretch at or under ``autoscale_down_backlog``),
    actuated through each agent's ``POST /scale``. Per-host state —
    one saturated host scales up without touching its idle peers."""

    def __init__(
        self,
        front: FederationFront,
        *,
        log: Callable[[str], None] = print,
        clock: Callable[[], float] = time.monotonic,
    ):
        fc = front.fleet_cfg
        self.front = front
        self.fc = fc
        self.min_workers = max(1, fc.min_workers or fc.workers or 1)
        self.max_workers = max(
            self.min_workers, fc.max_workers or fc.workers or 1
        )
        self.enabled = self.max_workers > self.min_workers
        self._log = log
        self._clock = clock
        self.ema: Dict[str, float] = {}
        self._idle_since: Dict[str, float] = {}
        self._last_change: Dict[str, float] = {}

    def _host_load(
        self, lease: HostLease
    ) -> Optional[Tuple[int, float]]:
        """(worker_count, backlog_windows) from the agent's /healthz —
        None when the host does not answer (the breaker/routing path
        owns that failure; sizing just skips a beat)."""
        try:
            _, _, data = self.front.transport(
                "GET", lease.host, lease.port, "/healthz",
                timeout=self.fc.heartbeat_timeout_s,
                peer=lease.host_id,
            )
            body = json.loads(data.decode() or "{}")
        except (_CONN_ERRORS, ValueError):
            return None
        workers = body.get("workers")
        n = len(workers) if isinstance(workers, dict) else 0
        try:
            backlog = float(body.get("backlog_windows", 0.0))
        except (TypeError, ValueError):
            backlog = 0.0
        return max(1, n), backlog

    def tick(self, now: Optional[float] = None) -> Dict[str, str]:
        """One sizing pass over every live host; returns
        ``{host_id: "up"|"down"}`` for the hosts resized."""
        fc = self.fc
        now = self._clock() if now is None else now
        actions: Dict[str, str] = {}
        for lease in self.front.registry.live():
            hid = lease.host_id
            load = self._host_load(lease)
            if load is None:
                continue
            n, backlog = load
            per = backlog / n
            prev = self.ema.get(hid)
            ema = (
                float(per) if prev is None
                else fc.autoscale_ema_beta * prev
                + (1.0 - fc.autoscale_ema_beta) * per
            )
            self.ema[hid] = ema
            last = self._last_change.get(hid)
            cooled = last is None or now - last >= fc.autoscale_cooldown_s
            if ema > fc.autoscale_up_backlog:
                self._idle_since.pop(hid, None)
                if n < self.max_workers and cooled:
                    code, _ = self.front.scale_host(hid, n + 1)
                    if code == 200:
                        self._last_change[hid] = now
                        actions[hid] = "up"
                        obs_events.emit(
                            "federation", "host_scale", log=self._log,
                            host=hid, workers=n + 1, direction="up",
                            backlog=round(ema, 1),
                        )
                continue
            if ema > fc.autoscale_down_backlog:
                self._idle_since.pop(hid, None)
                continue
            since = self._idle_since.setdefault(hid, now)
            if (
                n > self.min_workers
                and cooled
                and now - since >= fc.autoscale_idle_s
            ):
                code, _ = self.front.scale_host(hid, n - 1)
                if code == 200:
                    self._last_change[hid] = now
                    self._idle_since[hid] = now
                    actions[hid] = "down"
                    obs_events.emit(
                        "federation", "host_scale", log=self._log,
                        host=hid, workers=n - 1, direction="down",
                        backlog=round(ema, 1),
                    )
        return actions


class _FederationHandler(JsonRequestHandler):
    """The federation front end's HTTP surface — the supervisor front
    shape one level up, plus the ``/fed/*`` registration plane."""

    front: FederationFront  # set by make_federation_server

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            body = self.front.summary()
            if self.server._draining.is_set():  # type: ignore[attr-defined]
                body["status"], body["code"] = "draining", 503
            code = body.pop("code")
            self._reply_json(code, body)
        elif path == "/metrics":
            self._reply(
                200,
                self.front.render_metrics().encode(),
                content_type="text/plain; version=0.0.4",
            )
        elif path == "/rollout":
            self._reply_json(200, self.front.rollout_status())
        elif path == "/tracez":
            parts = self.path.split("?", 1)
            self._reply_json(
                200,
                self.front.tracez(parts[1] if len(parts) > 1 else ""),
            )
        else:
            self._reply_json(404, {"error": f"no route {self.path}"})

    def _json_post(
        self, fn: Callable[[Dict[str, Any]], Tuple[int, Dict[str, Any]]]
    ) -> None:
        raw = self._read_body()
        if raw is None:
            return
        try:
            payload = json.loads(raw.decode() or "{}")
            if not isinstance(payload, dict):
                raise ValueError("payload must be a JSON object")
        except (ValueError, UnicodeDecodeError) as e:
            self._reply_json(400, {"error": str(e)})
            return
        code, body = fn(payload)
        self._reply_json(code, body)

    def do_POST(self) -> None:  # noqa: N802 - http.server API
        front = self.front
        if self.path == "/fed/register":
            self._json_post(front.handle_register)
            return
        if self.path == "/fed/renew":
            self._json_post(front.handle_renew)
            return
        if self.path == "/rollout":
            self._json_post(front.start_rollout)
            return
        if self.path == "/scale":
            def scale(payload: Dict[str, Any]):
                host = payload.get("host")
                workers = payload.get("workers")
                if not isinstance(host, str) or not host:
                    return 400, {"error": "body must name the host"}
                if not isinstance(workers, int) or workers < 1:
                    return 400, {"error": "workers must be an int >= 1"}
                return front.scale_host(host, workers)

            self._json_post(scale)
            return
        if self.path != "/polish":
            self._reply_json(404, {"error": f"no route {self.path}"})
            return
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
            if self.server._draining.is_set():  # type: ignore[attr-defined]
                self.close_connection = True
                retry = float(self.front.cfg.serve.retry_after_s)
                self._reply_json(
                    503,
                    {"error": "federation draining",
                     "retry_after_s": retry},
                    extra={"Retry-After": f"{max(1, round(retry))}"},
                )
                return
            try:
                body = self._read_body()
            except TimeoutError:
                self.close_connection = True
                self._reply_json(
                    503, {"error": "timed out reading the request"}
                )
                return
            if body is None:
                return
            rid = (
                self.headers.get("X-Roko-Request-Id") or new_request_id()
            )
            code, reply, extra = front.post_polish(
                body, request_id=rid, tenant=tenant,
                model_version=model, pinned=pinned,
            )
            if code == 503:
                self.close_connection = True
            self._reply(code, reply, extra=extra)


def make_federation_server(
    front: FederationFront,
    host: Optional[str] = None,
    port: Optional[int] = None,
) -> ThreadingHTTPServer:
    """Bind the federation front end (port 0 = ephemeral); the caller
    runs ``serve_forever``. Its lifecycle state is the worker and
    supervisor servers', so :func:`roko_tpu_torch.serve.httpbase.drain`
    works on it unchanged."""
    serve_cfg = front.cfg.serve
    handler = type(
        "RokoFederationHandler", (_FederationHandler,), {"front": front}
    )
    server = ThreadingHTTPServer(
        (serve_cfg.host if host is None else host,
         serve_cfg.port if port is None else port),
        handler,
    )
    server.front = front  # type: ignore[attr-defined]
    init_lifecycle(server, front.cfg.resilience.drain_deadline_s)
    return server


def run_federation_front(
    cfg: RokoConfig,
    *,
    announce: Optional[str] = None,
    log=print,
) -> int:
    """The ``python -m roko_tpu_torch serve --federation`` entry point:
    bind the registry and router front end and serve until SIGTERM or
    Ctrl-C. Loads no model and claims no card: hosts bring their own
    fleets."""
    front = FederationFront(cfg, log=log)
    server = make_federation_server(front)
    if announce:
        write_announce(announce, server.server_address[1])
    log(
        "roko federation: front end binding "
        f"(lease ttl {front.registry.ttl_s:g}s; hosts join with "
        "`python -m roko_tpu_torch serve MODEL --host-agent --join HOST:PORT`)"
    )
    front.start()
    try:
        serve_forever(
            server,
            log=log,
            drain_fn=lambda: drain(server, log=log),
        )
    finally:
        front.stop()
    return 0


# ---------------------------------------------------------------------------
# host agent
# ---------------------------------------------------------------------------


class HostAgent:
    """The per-host side of the federation: keeps this host's lease
    alive at the front end and owns the host's fencing epoch.

    The join loop registers, then renews every ``ttl/3``. A refused
    renewal (lease expired during a partition, or the front end
    restarted) re-registers and **adopts the bumped epoch** — from
    that moment the previous epoch is fenced, including any zombie
    process still claiming it."""

    def __init__(
        self,
        fleet,
        cfg: RokoConfig,
        *,
        host_id: Optional[str] = None,
        join: Optional[str] = None,
        advertise_host: str = "127.0.0.1",
        transport=None,
        log: Callable[[str], None] = print,
    ):
        fc = cfg.fleet
        self.fleet = fleet
        self.cfg = cfg
        self.host_id = host_id or fc.host_id or f"host-{os.getpid()}"
        join = join or fc.join
        if not join or ":" not in join:
            raise ValueError(
                "host agent needs the federation front as --join "
                "HOST:PORT (or fleet.join in the config)"
            )
        fh, _, fp = join.rpartition(":")
        self.front_addr = (fh, int(fp))
        self.advertise_host = advertise_host
        self.transport = transport or transport_from_env(self.host_id)
        self._log = log
        self.epoch = 0
        self.lease_id: Optional[str] = None
        self.ttl_s = float(fc.lease_ttl_s)
        self.port: Optional[int] = None
        self._stop = threading.Event()

    # -- front-end RPC -------------------------------------------------------

    def _call_front(
        self, path: str, payload: Dict[str, Any]
    ) -> Tuple[int, Dict[str, Any]]:
        fh, fp = self.front_addr
        code, _, data = self.transport(
            "POST", fh, fp, path,
            headers={"Content-Type": "application/json"},
            body=json.dumps(payload).encode(),
            timeout=max(2.0, self.ttl_s / 2.0),
            peer="front",
        )
        try:
            body = json.loads(data.decode() or "{}")
        except ValueError:
            body = {}
        return code, body

    def register(self) -> bool:
        code, body = self._call_front("/fed/register", {
            "host_id": self.host_id,
            "host": self.advertise_host,
            "port": self.port,
            "workers": len(self.fleet.workers),
            "pid": os.getpid(),
        })
        if code != 200 or "lease_id" not in body:
            return False
        self.lease_id = str(body["lease_id"])
        self.epoch = int(body.get("epoch", 0))
        self.ttl_s = float(body.get("ttl_s", self.ttl_s))
        obs_events.emit(
            "federation", "joined", log=self._log,
            host=self.host_id, epoch=self.epoch,
            front=f"{self.front_addr[0]}:{self.front_addr[1]}",
        )
        return True

    def renew(self) -> bool:
        """One renewal; False = refused (must re-register)."""
        code, body = self._call_front("/fed/renew", {
            "host_id": self.host_id,
            "lease_id": self.lease_id or "",
        })
        if code != 200:
            return False
        self.ttl_s = float(body.get("ttl_s", self.ttl_s))
        return True

    # -- lifecycle -----------------------------------------------------------

    def start(self, port: int) -> None:
        self.port = port
        threading.Thread(
            target=self._join_loop,
            name=f"roko-federation-join-{self.host_id}",
            daemon=True,
        ).start()

    def stop(self) -> None:
        self._stop.set()

    def _join_loop(self) -> None:
        stop = self._stop
        registered = False
        while not stop.is_set():
            try:
                if not registered:
                    registered = self.register()
                    if not registered:
                        stop.wait(min(1.0, self.ttl_s / 3.0))
                        continue
                elif not self.renew():
                    # refused: the lease died (partition outlived the
                    # TTL, or the front end restarted). Re-register NOW
                    # — the bump fences whatever still claims the old
                    # epoch.
                    obs_events.emit(
                        "federation", "lease_refused", log=self._log,
                        suffix="— re-registering",
                        host=self.host_id, epoch=self.epoch,
                    )
                    registered = False
                    continue
            except _CONN_ERRORS:
                # partition: the lease may still be live at the front —
                # keep the lease_id and retry; an expired lease turns
                # into a refused renewal above once the net heals
                stop.wait(min(1.0, self.ttl_s / 3.0))
                continue
            stop.wait(self.ttl_s / 3.0)


def make_agent_handler(agent: HostAgent):
    """The host agent's HTTP surface: the full supervisor front
    (``_FrontHandler`` — relays, rollout, jobs, metrics) with the
    federation plane layered on: every reply echoes the agent's epoch,
    ``/polish`` fences mismatched relays with 409, ``/scale`` resizes
    the local fleet, and ``/healthz`` carries the host identity +
    backlog the front-end autoscaler reads."""
    from roko_tpu_torch.serve.supervisor import _FrontHandler

    class _AgentHandler(_FrontHandler):
        def _reply(self, code, body, content_type="application/json",
                   extra=None):
            extra = dict(extra or {})
            # the echo is unconditional — fencing at the front end
            # must work on every path, including errors
            extra[FED_EPOCH_HEADER] = str(self.agent.epoch)
            super()._reply(
                code, body, content_type=content_type, extra=extra
            )

        def do_GET(self):  # noqa: N802 - http.server API
            if self.path == "/healthz":
                body = self.fleet.summary()
                body["host_id"] = self.agent.host_id
                body["epoch"] = self.agent.epoch
                if self.server._draining.is_set():  # type: ignore[attr-defined]
                    body["status"], body["code"] = "draining", 503
                code = body.pop("code")
                self._reply_json(code, body)
                return
            super().do_GET()

        def do_POST(self):  # noqa: N802 - http.server API
            if self.path == "/scale":
                raw = self._read_body()
                if raw is None:
                    return
                try:
                    payload = json.loads(raw.decode() or "{}")
                    workers = payload.get("workers")
                    if not isinstance(workers, int) or workers < 1:
                        raise ValueError("workers must be an int >= 1")
                except (ValueError, UnicodeDecodeError) as e:
                    self._reply_json(400, {"error": str(e)})
                    return
                self.fleet.scale_to(workers, reason="federation")
                self._reply_json(
                    200,
                    {"host_id": self.agent.host_id, "workers": workers},
                )
                return
            if self.path == "/polish":
                want = self.headers.get(FED_EPOCH_HEADER)
                mine = self.agent.epoch
                if want is not None and mine and want != str(mine):
                    # the registry knows a newer epoch than this
                    # process: we ARE the zombie (stale lease) — refuse
                    # at the source, never touch a worker
                    obs_events.emit(
                        "federation", "fenced", log=self.agent._log,
                        request_id=self.headers.get("X-Roko-Request-Id"),
                        host=self.agent.host_id,
                        relay_epoch=want, agent_epoch=mine,
                    )
                    self._reply_json(
                        409,
                        {"error": f"fenced: relay epoch {want} != "
                                  f"agent epoch {mine}",
                         "fenced": True},
                    )
                    return
            super().do_POST()

    _AgentHandler.agent = agent
    return _AgentHandler


def run_host_agent(
    model_path: str,
    cfg: RokoConfig,
    *,
    announce: Optional[str] = None,
    log=print,
    device: str = "cuda",
) -> int:
    """The ``python -m roko_tpu_torch serve MODEL --host-agent --join
    HOST:PORT`` entry point: a full supervisor (fleet, rollout recovery,
    autoscaler, ``POST /job``, rolling SIGTERM drain: the
    :func:`~roko_tpu_torch.serve.supervisor.boot_fleet` machinery,
    unchanged) that also joins a federation front and speaks the
    lease/epoch protocol. Its workers run in this process's group, so a
    SIGKILL of the group takes every worker of the host with it."""
    import dataclasses as _dc

    from roko_tpu_torch.parallel.mesh import resolve_fleet_topology
    from roko_tpu_torch.pipeline.distpolish import make_job_starter
    from roko_tpu_torch.serve.supervisor import (
        boot_fleet,
        make_front_server,
        make_rollout_starter,
        rolling_drain,
        start_autoscaler,
    )

    fc = resolve_fleet_topology(cfg.fleet, backend=device)
    if fc is not cfg.fleet:
        cfg = _dc.replace(cfg, fleet=fc)
    fleet, journal, recovery, boot_version, boot_model, boot_cfg = (
        boot_fleet(model_path, cfg, log=log, device=device)
    )
    agent = HostAgent(fleet, cfg, log=log)
    server = make_front_server(
        fleet, handler_base=make_agent_handler(agent)
    )
    if cfg.fleet.ab_version and cfg.fleet.ab_fraction > 0:
        server._ab_lane = (  # type: ignore[attr-defined]
            cfg.fleet.ab_version, cfg.fleet.ab_fraction
        )
    server._start_rollout = make_rollout_starter(  # type: ignore[attr-defined]
        fleet, journal, boot_model, boot_cfg, log=log, device=device
    )
    server._start_job = make_job_starter(  # type: ignore[attr-defined]
        fleet, boot_cfg, log=log
    )
    if announce:
        write_announce(announce, server.server_address[1])
    log(
        f"roko federation: host agent {agent.host_id!r} supervising "
        f"{cfg.fleet.workers} worker(s), joining "
        f"{agent.front_addr[0]}:{agent.front_addr[1]} "
        f"(version {boot_version})"
    )
    fleet.start()
    if recovery is not None:
        journal.delete()
    autoscale_stop = threading.Event()
    fleet.autoscaler = start_autoscaler(  # type: ignore[attr-defined]
        fleet, autoscale_stop, log=log
    )
    agent.start(server.server_address[1])
    try:
        serve_forever(
            server,
            log=log,
            drain_fn=lambda: rolling_drain(server, fleet, log=log),
        )
    finally:
        agent.stop()
        autoscale_stop.set()
        fleet.stop(rolling=False)
    return 0
