"""The port's multi-host federation (``roko_tpu_torch/serve/federation.py``
and ``serve/transport.py``) case for case with ``tests/test_federation.py``,
and held against the JAX package's (``roko_tpu/serve/federation.py``) in
the same process on the same inputs: the fault-spec parses and refusals,
the ``FaultyTransport`` decisions under one seed, the lease, epoch and
breaker transitions on one scripted clock, the ``summary`` states and the
503's ``Retry-After``, the host autoscaler's actions and the front's
merged ``/metrics`` text.

Then real processes on loopback: a front and two host agents over TCP
supervising the port's stub worker (``tests/torch_fleet_stub_worker.py``):
fencing, failover with ``request_id``, survival when degraded, rejoin with
the epoch bumped; ``serve --federation`` through the CLI; and one real CPU
host agent (``serve MODEL --host-agent --join ...``) whose ``POST /job``
reads its draft and BAM from a ``StubObjectStore`` and writes its FASTA
there, byte-identical to ``roko-tpu polish`` on the same inputs and
weights."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import roko_tpu.config as jconfig
import roko_tpu.serve.federation as jfed
import roko_tpu.serve.transport as jtransport
from roko_tpu_torch.config import FleetConfig, RokoConfig, ServeConfig
from roko_tpu_torch.serve import federation as fed
from roko_tpu_torch.serve import transport
from roko_tpu_torch.serve.client import PolishClient, ServerBusy, ServiceUnavailable
from roko_tpu_torch.serve.federation import (
    FED_EPOCH_HEADER,
    FED_HOST_HEADER,
    FederationFront,
    FederationRollout,
    HostAgent,
    HostAutoscaler,
    HostRegistry,
    make_agent_handler,
    make_federation_server,
)
from roko_tpu_torch.serve.fleet import Fleet
from roko_tpu_torch.serve.supervisor import make_front_server
from roko_tpu_torch.serve.transport import (
    FaultyTransport,
    HttpTransport,
    parse_fed_faults,
    transport_from_env,
)
from tests.test_torch_fleet import (
    fast_fleet_cfg,
    get_json,
    make_fleet,
    post,
    stop_front,
    stub_command,
    wait_until,
)

ROOT = Path(__file__).resolve().parent.parent


def noop(_msg):
    pass


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class ScriptedTransport:
    """peer -> fn(method, path, headers, body) -> (code, hdrs, bytes); the
    fn may raise. Every wire call is recorded for ordering and header
    assertions (the cross-host request_id contract)."""

    def __init__(self, handlers):
        self.handlers = handlers
        self.calls = []

    def __call__(self, method, host, port, path, headers=None, body=None, timeout=10.0,
                 peer=""):
        self.calls.append((peer, method, path, dict(headers or {})))
        return self.handlers[peer](method, path, dict(headers or {}), body)


def fed_config(cfgmod=None, **fleet_kw):
    """A federation config of ``cfgmod`` (the port's config module, or
    ``roko_tpu.config`` for the reference's)."""
    m = cfgmod or sys.modules[RokoConfig.__module__]
    base = dict(workers=1, lease_ttl_s=10.0, failover_attempts=3)
    base.update(fleet_kw)
    return m.RokoConfig(serve=m.ServeConfig(max_queue=8, retry_after_s=0.2),
                        fleet=m.FleetConfig(**base))


def make_scripted_front(handlers, clock=None, *, mod=fed, cfgmod=None, **fleet_kw):
    t = ScriptedTransport(handlers)
    front = mod.FederationFront(fed_config(cfgmod, **fleet_kw), transport=t,
                                clock=clock or time.monotonic, log=noop)
    return front, t


def both_fronts(handlers_for, clock_for=lambda: None, **fleet_kw):
    """The port's and the reference's fronts on the same scripted agents:
    ``handlers_for(front)`` builds the agents of one front."""
    out = []
    for mod, cfgmod in ((fed, None), (jfed, jconfig)):
        handlers = {}
        front, t = make_scripted_front(handlers, clock_for(), mod=mod, cfgmod=cfgmod,
                                       **fleet_kw)
        handlers.update(handlers_for(front))
        out.append((front, t))
    return out


def echo_ok(front, host_id, payload=b'{"polished": "ok"}'):
    """A well-behaved agent: 200 and the CURRENT registry epoch echoed."""

    def h(method, path, headers, body):
        return 200, {FED_EPOCH_HEADER: str(front.registry.get(host_id).epoch)}, payload

    return h


# -- transport: fault spec and injection --------------------------------------


def test_parse_fed_faults_valid_spec():
    spec = "drop:0.05, delay:0.1,duplicate:0.02,partition:front-h1,partition:h1-h2"
    rates, partitions = parse_fed_faults(spec)
    assert rates == {"drop": 0.05, "delay": 0.1, "duplicate": 0.02}
    assert partitions == {frozenset(("front", "h1")), frozenset(("h1", "h2"))}
    assert parse_fed_faults("") == ({}, set())
    assert (rates, partitions) == jtransport.parse_fed_faults(spec)


@pytest.mark.parametrize("spec,match", [
    ("chaos:0.5", "valid: drop, delay"), ("drop:lots", "not a number"),
    ("drop:1.5", "out of range"), ("partition:front", "two distinct endpoints"),
    ("partition:a-a", "two distinct endpoints"), ("delay:-0.1", "out of range"),
])
def test_parse_fed_faults_refuses_loudly(spec, match):
    with pytest.raises(ValueError, match=match) as got:
        parse_fed_faults(spec)
    with pytest.raises(ValueError) as want:
        jtransport.parse_fed_faults(spec)
    assert str(got.value) == str(want.value)


def recording_inner(replies=None):
    calls = []
    n = [0]

    def inner(method, host, port, path, headers=None, body=None, timeout=10.0, peer=""):
        calls.append((method, path, peer))
        n[0] += 1
        return 200, {}, (b"reply-%d" % n[0] if replies is None else replies)

    return inner, calls


def test_faulty_transport_rate_zero_is_identity():
    """Rate 0 on every kind injects NOTHING."""
    inner, calls = recording_inner(b"ok")
    t = FaultyTransport(inner, {"drop": 0.0, "delay": 0.0, "duplicate": 0.0}, name="a")
    for _ in range(20):
        assert t("POST", "h", 1, "/polish", peer="b") == (200, {}, b"ok")
    assert len(calls) == 20
    assert all(v == 0 for v in t.injected.values())


def test_faulty_transport_drop_rate_one_is_total_partition():
    """drop:1 is the other endpoint: nothing ever reaches the wire."""
    inner, calls = recording_inner(b"ok")
    t = FaultyTransport(inner, {"drop": 1.0}, name="a")
    for _ in range(10):
        with pytest.raises(ConnectionError, match="injected drop"):
            t("POST", "h", 1, "/polish", peer="b")
    assert calls == []
    assert t.injected["drop"] == 10


def test_faulty_transport_duplicate_sends_twice():
    inner, calls = recording_inner()
    t = FaultyTransport(inner, {"duplicate": 1.0}, name="a")
    code, _, body = t("POST", "h", 1, "/polish", peer="b")
    # both sends hit the wire; the SECOND reply is returned
    assert len(calls) == 2
    assert body == b"reply-2"
    assert t.injected["duplicate"] == 1


def test_faulty_transport_duplicate_falls_back_to_first_reply():
    n = [0]

    def inner(method, host, port, path, headers=None, body=None, timeout=10.0, peer=""):
        n[0] += 1
        if n[0] == 2:
            raise ConnectionError("second send lost")
        return 200, {}, b"first"

    t = FaultyTransport(inner, {"duplicate": 1.0}, name="a")
    assert t("POST", "h", 1, "/p", peer="b") == (200, {}, b"first")


def test_faulty_transport_named_partition_and_heal():
    inner, calls = recording_inner(b"ok")
    t = FaultyTransport(inner, name="front")
    t.partition("front", "h1")
    with pytest.raises(ConnectionError, match="injected partition"):
        t("GET", "h", 1, "/healthz", peer="h1")
    # the partition is a named PAIR: other peers are unaffected
    assert t("GET", "h", 1, "/healthz", peer="h2")[0] == 200
    t.heal("front", "h1")
    assert t("GET", "h", 1, "/healthz", peer="h1")[0] == 200
    assert t.injected["partition"] == 1


def test_faulty_transport_refuses_bad_rates():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultyTransport(lambda *a, **k: None, {"chaos": 0.5})
    with pytest.raises(ValueError, match="out of range"):
        FaultyTransport(lambda *a, **k: None, {"drop": 2.0})


def test_transport_from_env():
    assert isinstance(transport_from_env("x", env={}), HttpTransport)
    t = transport_from_env("front", env={
        "ROKO_FED_FAULTS": "drop:0.25,partition:front-h1",
        "ROKO_FED_DELAY_S": "0.01",
        "ROKO_FED_FAULTS_SEED": "7",
    })
    assert isinstance(t, FaultyTransport)
    assert t.rates == {"drop": 0.25}
    assert t.name == "front"
    assert t.delay_s == 0.01
    with pytest.raises(ValueError, match="valid: drop"):
        transport_from_env("x", env={"ROKO_FED_FAULTS": "nope:1"})


def _fault_trace(mod, seed):
    """300 calls through ``mod``'s transport_from_env at the chaos gate's
    rates plus a partition, as per-call outcomes."""
    inner, calls = recording_inner()
    t = mod.transport_from_env("front", inner=inner, env={
        "ROKO_FED_FAULTS": "drop:0.1,delay:0.2,duplicate:0.1,partition:front-h2",
        "ROKO_FED_DELAY_S": "0", "ROKO_FED_FAULTS_SEED": str(seed)})
    trace = []
    for i in range(300):
        before = len(calls)
        try:
            _, _, body = t("POST", "h", 1, "/polish", peer=f"h{i % 3}")
            trace.append((len(calls) - before, body.decode()))
        except ConnectionError as e:
            trace.append(str(e).split()[1])
    return trace, dict(t.injected)


@pytest.mark.parametrize("seed", [0, 42, 1234])
def test_faulty_transport_decisions_equal_reference(seed):
    """Under one spec and seed the port draws its fault decisions in the
    reference's order: drop, duplicate and partition outcomes equal the
    reference's call for call."""
    got, got_injected = _fault_trace(transport, seed)
    want, want_injected = _fault_trace(jtransport, seed)
    assert got == want and got_injected == want_injected
    assert got_injected["drop"] and got_injected["duplicate"] and got_injected["partition"]


# -- lease/epoch registry ------------------------------------------------------


def test_lease_register_renew_expire_reregister():
    clock = FakeClock()
    reg = HostRegistry(ttl_s=10.0, clock=clock, log=noop)
    grant = reg.register("h1", "127.0.0.1", 7001, workers=2)
    assert set(grant) == {"lease_id", "epoch", "ttl_s"}
    assert grant["epoch"] == 1
    # renewal extends; a stale lease_id is refused
    clock.advance(6.0)
    assert reg.renew("h1", grant["lease_id"])["epoch"] == 1
    assert reg.renew("h1", "not-the-lease") is None
    assert reg.renew("ghost", grant["lease_id"]) is None
    # expiry: out of rotation, renewal refused, epoch NOT bumped
    clock.advance(11.0)
    assert reg.sweep() == ["h1"]
    assert reg.sweep() == []  # already expired: no double count
    assert reg.counter("lease_expiries") == 1
    assert reg.renew("h1", grant["lease_id"]) is None
    assert reg.pick() is None
    assert reg.current_epoch("h1") == 1
    # registering again (the healed partition) bumps the epoch and
    # replaces the lease in place: one entry, never duplicates
    grant2 = reg.register("h1", "127.0.0.1", 7001, workers=2)
    assert grant2["epoch"] == 2
    assert grant2["lease_id"] != grant["lease_id"]
    assert len(reg.hosts()) == 1
    assert reg.get("h1").state() == "live"
    assert reg.counter("registrations") == 2


def test_duplicate_registration_from_restarted_agent():
    """A restarted agent registers while the old lease is still LIVE: the
    epoch bumps, one entry survives, and the old lease_id is dead."""
    clock = FakeClock()
    reg = HostRegistry(ttl_s=10.0, clock=clock, log=noop)
    g1 = reg.register("h1", "127.0.0.1", 7001)
    g2 = reg.register("h1", "127.0.0.1", 7009)
    assert (g1["epoch"], g2["epoch"]) == (1, 2)
    assert len(reg.hosts()) == 1
    assert reg.get("h1").port == 7009
    assert reg.renew("h1", g1["lease_id"]) is None  # the zombie's lease
    assert reg.renew("h1", g2["lease_id"]) is not None
    # the epoch is monotonic across every restart
    assert reg.register("h1", "127.0.0.1", 7001)["epoch"] == 3


def test_pick_round_robin_skips_expired_and_open_breakers():
    clock = FakeClock()
    reg = HostRegistry(ttl_s=10.0, breaker_failures=1, clock=clock, log=noop)
    reg.register("h1", "127.0.0.1", 7001)
    reg.register("h2", "127.0.0.1", 7002)
    assert {reg.pick().host_id for _ in range(4)} == {"h1", "h2"}
    reg.get("h1").breaker.record_failure()  # opens at 1 failure
    assert {reg.pick().host_id for _ in range(4)} == {"h2"}
    clock.advance(11.0)
    reg.sweep()
    assert reg.pick() is None


def _lease_script(mod):
    """One scripted history of leases, epochs and breakers on a fake
    clock; the lease ids (random) become the order they were granted in."""
    clock = FakeClock()
    reg = mod.HostRegistry(ttl_s=4.0, breaker_failures=2, breaker_reset_s=3.0, clock=clock,
                           log=noop)
    ids, out = {}, []

    def grant(g):
        ids.setdefault(g["lease_id"], len(ids))
        return {**g, "lease_id": ids[g["lease_id"]]}

    def state():
        return [(l.host_id, l.epoch, l.state(), l.breaker.state, l.port, l.workers)
                for l in reg.hosts()]

    gs = {h: reg.register(h, "127.0.0.1", 7000 + i, workers=i + 1)
          for i, h in enumerate(("h0", "h1", "h2"))}
    out.append([grant(g) for g in gs.values()])
    for step in range(12):
        clock.advance(1.5)
        if step % 3 == 0:
            out.append(reg.renew("h0", gs["h0"]["lease_id"]))
        if step == 4:
            reg.get("h1").breaker.record_failure()
            reg.get("h1").breaker.record_failure()
        if step == 6:
            gs["h2"] = reg.register("h2", "127.0.0.1", 7102, workers=5)
            out.append(grant(gs["h2"]))
            out.append(reg.renew("h2", "stale"))
        out.append(reg.sweep())
        pick = reg.pick(exclude=("h0",) if step == 9 else ())
        out.append(None if pick is None else pick.host_id)
        out.append(state())
    out.append({k: reg.counter(k) for k in fed.FEDERATION_COUNTERS})
    out.append({h: reg.current_epoch(h) for h in ("h0", "h1", "h2", "hx")})
    return out


def test_lease_epoch_breaker_transitions_equal_reference():
    """The lease, epoch and breaker transitions of one scripted clock:
    every grant, renewal, sweep, pick and state equals the reference's."""
    got = _lease_script(fed)
    assert got == _lease_script(jfed)
    assert got[-1] == {"h0": 1, "h1": 1, "h2": 2, "hx": 0}


# -- partition-tolerant routing (scripted transports) -------------------------


def test_expiry_mid_relay_still_serves_the_reply():
    """The lease expires while the relay is in flight: expiry alone proves
    nothing about staleness (the epoch did not change), so the reply IS
    served, but the host is out of rotation for new picks."""
    clock = FakeClock()
    handlers = {}
    front, t = make_scripted_front(handlers, clock=clock)
    front.registry.register("h1", "127.0.0.1", 7001)

    def h1(method, path, headers, body):
        clock.advance(11.0)
        front.registry.sweep()  # expiry lands mid-relay
        return 200, {FED_EPOCH_HEADER: headers[FED_EPOCH_HEADER]}, \
            b'{"polished": "late-but-valid"}'

    handlers["h1"] = h1
    code, reply, extra = front.post_polish(b"{}", request_id="rid-1")
    assert code == 200
    assert reply == b'{"polished": "late-but-valid"}'
    assert extra[FED_HOST_HEADER] == "h1"
    assert front.registry.counter("fence_refusals") == 0
    assert front.registry.counter("lease_expiries") == 1
    assert front.registry.pick() is None


def test_agent_fence_409_never_served():
    """The agent fenced the relay at the source (its epoch is stale): with
    no other host the client sees 503, never the fenced reply."""
    handlers = {}
    front, t = make_scripted_front(handlers)
    front.registry.register("h1", "127.0.0.1", 7001)
    handlers["h1"] = lambda m, p, h, b: (
        409, {}, b'{"error": "fenced: relay epoch 2 != agent epoch 1", "fenced": true}')
    code, reply, extra = front.post_polish(b"{}", request_id="rid-2")
    assert code == 503
    assert b"no federated host available" in reply
    assert front.registry.counter("fence_refusals") == 1
    # fencing is no host FAILURE: the process answered under the wrong
    # epoch, so the breaker stays closed
    assert front.registry.get("h1").state() == "live"


def test_stale_epoch_reply_refused_never_served():
    """A zombie that IGNORES the fencing header and answers 200 under its
    old epoch is refused on reply at the front: the last line of the
    fence."""
    handlers = {}
    front, t = make_scripted_front(handlers)
    front.registry.register("h1", "127.0.0.1", 7001)
    front.registry.register("h1", "127.0.0.1", 7001)  # epoch now 2
    handlers["h1"] = lambda m, p, h, b: (200, {FED_EPOCH_HEADER: "1"}, b'{"polished": "ZOMBIE"}')
    code, reply, extra = front.post_polish(b"{}", request_id="rid-3")
    assert code == 503
    assert b"ZOMBIE" not in reply
    assert front.registry.counter("fence_refusals") == 1


def test_fence_refusal_fails_over_to_good_host():
    handlers = {}
    front, t = make_scripted_front(handlers)
    # registration order pins round robin: the FIRST pick is the
    # second-registered host (the offset starts at 1)
    front.registry.register("good", "127.0.0.1", 7002)
    front.registry.register("bad", "127.0.0.1", 7001)
    handlers["bad"] = lambda m, p, h, b: (409, {}, b'{"error": "fenced", "fenced": true}')
    handlers["good"] = echo_ok(front, "good", b'{"polished": "good"}')
    code, reply, extra = front.post_polish(b"{}", request_id="rid-4")
    assert (code, reply) == (200, b'{"polished": "good"}')
    assert extra[FED_HOST_HEADER] == "good"
    assert front.registry.counter("fence_refusals") == 1
    # the request_id rode BOTH relays, the fenced one and the failover
    rids = [c[3]["X-Roko-Request-Id"] for c in t.calls if c[2] == "/polish"]
    assert rids == ["rid-4", "rid-4"]
    assert [c[0] for c in t.calls if c[2] == "/polish"] == ["bad", "good"]


def test_conn_error_failover_preserves_request_id_and_opens_breaker():
    handlers = {}
    front, t = make_scripted_front(handlers, fed_breaker_failures=1)
    front.registry.register("good", "127.0.0.1", 7002)
    front.registry.register("dead", "127.0.0.1", 7001)

    def dead(method, path, headers, body):
        raise ConnectionError("wire cut")

    handlers["dead"] = dead
    handlers["good"] = echo_ok(front, "good", b'{"polished": "good"}')
    code, reply, extra = front.post_polish(b"{}", request_id="rid-5")
    assert (code, extra[FED_HOST_HEADER]) == (200, "good")
    assert front.registry.counter("failovers") == 1
    assert front.registry.get("dead").state() == "breaker-open"
    rids = [c[3]["X-Roko-Request-Id"] for c in t.calls if c[2] == "/polish"]
    assert rids == ["rid-5", "rid-5"]
    # degraded mode: serving on the survivors, loudly visible
    s = front.summary()
    assert s["status"] == "degraded"
    assert s["hosts"]["dead"]["state"] == "breaker-open"
    assert s["hosts"]["good"]["state"] == "live"


def test_all_hosts_down_returns_503_with_retry_after():
    handlers = {}
    front, t = make_scripted_front(handlers, fed_breaker_failures=1)
    front.registry.register("h1", "127.0.0.1", 7001)

    def dead(method, path, headers, body):
        raise ConnectionError("wire cut")

    handlers["h1"] = dead
    code, reply, extra = front.post_polish(b"{}", request_id="rid-6")
    assert code == 503
    body = json.loads(reply)
    assert "no federated host available" in body["error"]
    assert body["retry_after_s"] == pytest.approx(0.2)
    assert extra["Retry-After"] == "1"


def test_503_collects_the_largest_retry_after():
    handlers = {}
    front, t = make_scripted_front(handlers)
    front.registry.register("h1", "127.0.0.1", 7001)
    front.registry.register("h2", "127.0.0.1", 7002)
    handlers["h1"] = lambda m, p, h, b: (503, {}, b'{"error": "busy", "retry_after_s": 3.0}')
    handlers["h2"] = lambda m, p, h, b: (503, {"Retry-After": "7"}, b'{"error": "busy"}')
    code, reply, extra = front.post_polish(b"{}", request_id="rid-7")
    assert code == 503
    assert json.loads(reply)["retry_after_s"] == 7.0
    assert extra["Retry-After"] == "7"
    # a 503 is an ALIVENESS signal: both hosts stay live
    assert all(l.state() == "live" for l in front.registry.hosts())


def test_summary_warming_ok_degraded_unhealthy():
    clock = FakeClock()
    front, _ = make_scripted_front({}, clock=clock)
    assert (front.summary()["status"], front.summary()["code"]) == ("warming", 503)
    g1 = front.registry.register("h1", "127.0.0.1", 7001)
    front.registry.register("h2", "127.0.0.1", 7002)
    assert front.summary()["status"] == "ok"
    clock.advance(6.0)
    front.registry.renew("h1", g1["lease_id"])
    clock.advance(5.0)
    front.registry.sweep()  # h2 expires; h1 renewed
    s = front.summary()
    assert (s["status"], s["code"]) == ("degraded", 200)
    assert s["hosts"]["h2"]["state"] == "expired"
    assert s["federation"]["lease_expiries"] == 1
    clock.advance(6.0)
    front.registry.sweep()
    assert (front.summary()["status"], front.summary()["code"]) == ("unhealthy", 503)


def test_register_and_renew_validation():
    front, _ = make_scripted_front({})
    assert front.handle_register({"host_id": "", "port": 7001})[0] == 400
    assert front.handle_register({"host_id": "h1", "port": 0})[0] == 400
    assert front.handle_renew({"host_id": "h1"})[0] == 400
    code, body = front.handle_renew({"host_id": "h1", "lease_id": "nope"})
    assert code == 404 and "re-register" in body["error"]
    assert front.scale_host("ghost", 2)[0] == 404


def _agents(front):
    """Scripted agents a..e: fenced, a stale-epoch zombie, saturated with
    two Retry-After hints, dead, and well-behaved."""

    def dead(method, path, headers, body):
        raise ConnectionError("wire cut")

    return {
        "a": lambda m, p, h, b: (409, {}, b'{"error": "fenced", "fenced": true}'),
        "b": lambda m, p, h, b: (200, {FED_EPOCH_HEADER: "0"}, b'{"polished": "ZOMBIE"}'),
        "c": lambda m, p, h, b: (503, {"retry-after": "2"}, b'{"retry_after_s": 4.5}'),
        "d": dead,
        "e": echo_ok(front, "e", b'{"polished": "e"}'),
        "f": lambda m, p, h, b: (429, {"Retry-After": "3", FED_EPOCH_HEADER: "1"},
                                 b'{"error": "quota"}'),
    }


def _routing_script(front, t, clock):
    out = []
    reg = front.registry
    for order in (("a", "b", "c"), ("d", "e"), ("c", "d"), ("f",), ("a", "b", "c", "d", "e")):
        for h in reg.hosts():
            reg._hosts.pop(h.host_id)
        for i, h in enumerate(order):
            reg.register(h, "127.0.0.1", 7000 + i)
        for k in range(3):
            code, reply, extra = front.post_polish(b"{}", request_id=f"r{k}", tenant="t1")
            out.append((code, reply, extra))
            summary = front.summary()
            out.append({**summary, "hosts": {h: {k2: v for k2, v in s.items()}
                                             for h, s in summary["hosts"].items()}})
            clock.advance(0.4)
    out.append([(c[0], c[2], sorted(c[3].items())) for c in t.calls])
    return out


def test_post_polish_and_summary_equal_reference():
    """Fencing at the agent and at the reply, dead hosts, 503 hints, a
    429 and a good host, in several rotations: every reply, extra header,
    ``summary`` and wire call of the port's front equals the reference's."""
    clocks = [FakeClock(), FakeClock()]
    it = iter(clocks)
    (pf, pt), (jf, jt) = both_fronts(_agents, lambda: next(it), fed_breaker_failures=1,
                                     fed_breaker_reset_s=1.0, failover_attempts=4)
    got = _routing_script(pf, pt, clocks[0])
    want = _routing_script(jf, jt, clocks[1])
    assert got == want
    codes = {r[0] for r in got[:-1:2]}
    assert {200, 429, 503} <= codes


# -- host-dimension rollout and autoscale ----------------------------------------


def agent_rollout_handler(state_body):
    def h(method, path, headers, body):
        if method == "POST" and path == "/rollout":
            return 202, {}, b"{}"
        if method == "GET" and path == "/rollout":
            return 200, {}, json.dumps(state_body).encode()
        raise AssertionError(f"unexpected {method} {path}")

    return h


def test_federation_rollout_rolls_hosts_sequentially():
    handlers = {}
    front, t = make_scripted_front(handlers, rollout_ready_timeout_s=10.0)
    front.registry.register("h1", "127.0.0.1", 7001)
    front.registry.register("h2", "127.0.0.1", 7002)
    handlers["h1"] = agent_rollout_handler({"state": "done"})
    handlers["h2"] = agent_rollout_handler({"state": "done"})
    code, body = front.start_rollout({"name": "v2"})
    assert code == 202
    wait_until(lambda: front.rollout.state == "done", timeout=15,
               msg="federation rollout done")
    posts = [c[0] for c in t.calls if c[1] == "POST" and c[2] == "/rollout"]
    assert posts == ["h1", "h2"]
    # host 1's gates landed BEFORE host 2 was touched
    h1_done = max(i for i, c in enumerate(t.calls) if c[0] == "h1" and c[1] == "GET")
    h2_post = next(i for i, c in enumerate(t.calls) if c[0] == "h2" and c[1] == "POST")
    assert h1_done < h2_post
    assert front.rollout.hosts["h1"]["state"] == "done"


def test_federation_rollout_aborts_wave_on_host_failure():
    """Host 1's own canary gates rolled it back: the wave stops and host 2
    keeps the incumbent."""
    handlers = {}
    front, t = make_scripted_front(handlers, rollout_ready_timeout_s=10.0)
    front.registry.register("h1", "127.0.0.1", 7001)
    front.registry.register("h2", "127.0.0.1", 7002)
    handlers["h1"] = agent_rollout_handler({"state": "rolled_back"})
    handlers["h2"] = agent_rollout_handler({"state": "done"})
    code, _ = front.start_rollout({"name": "v2"})
    assert code == 202
    wait_until(lambda: front.rollout.state == "failed", timeout=15,
               msg="federation rollout failed")
    assert [c[0] for c in t.calls if c[1] == "POST" and c[2] == "/rollout"] == ["h1"]
    assert "h2" not in front.rollout.hosts


def test_federation_rollout_refusals():
    front, _ = make_scripted_front({})
    assert front.start_rollout({})[0] == 400
    assert front.start_rollout({"name": "v2"})[0] == 503  # no live host
    front.registry.register("h1", "127.0.0.1", 7001)
    front.rollout = FederationRollout(front, {"name": "vX"}, log=noop)
    front.rollout.state = "rolling"
    code, body = front.start_rollout({"name": "v2"})
    assert code == 409 and "already in progress" in body["error"]


def _scaling_agents(backlogs, scaled):
    def agent(hid):
        def h(method, path, headers, body):
            if path == "/healthz":
                return 200, {}, json.dumps({"workers": {"0": {}, "1": {}},
                                            "backlog_windows": backlogs[hid][0]}).encode()
            if path == "/scale":
                scaled.append((hid, json.loads(body)["workers"]))
                return 200, {}, b'{"ok": 1}'
            raise AssertionError(path)

        return h

    return {hid: agent(hid) for hid in backlogs}


def test_host_autoscaler_scales_each_host_independently():
    clock = FakeClock()
    handlers = {}
    front, t = make_scripted_front(
        handlers, clock=clock, min_workers=1, max_workers=3, autoscale_up_backlog=10.0,
        autoscale_down_backlog=2.0, autoscale_idle_s=1.0, autoscale_cooldown_s=0.0,
        autoscale_ema_beta=0.0)
    front.registry.register("hot", "127.0.0.1", 7001)
    front.registry.register("cold", "127.0.0.1", 7002)
    backlogs = {"hot": [100.0], "cold": [0.0]}
    scaled = []
    handlers.update(_scaling_agents(backlogs, scaled))
    scaler = HostAutoscaler(front, log=noop, clock=clock)
    assert scaler.enabled
    # the saturated host scales up; its idle peer is untouched (the idle
    # clock has only just started)
    assert scaler.tick() == {"hot": "up"}
    assert dict(scaled) == {"hot": 3}
    # a continuous idle stretch scales the cold host down to the floor
    clock.advance(2.0)
    backlogs["hot"][0] = 0.0
    scaler.tick()  # idle_since starts for both
    clock.advance(2.0)
    actions = scaler.tick()
    assert actions["cold"] == "down"
    assert dict(scaled)["cold"] == 1


def test_host_autoscaler_disabled_without_headroom():
    front, _ = make_scripted_front({}, min_workers=0, max_workers=0)
    assert not HostAutoscaler(front, log=noop).enabled


def test_host_autoscaler_actions_equal_reference():
    """One backlog trace (a spike, a plateau inside the band, an idle
    stretch) over three hosts on one fake clock: every tick's actions and
    every ``/scale`` the port's host autoscaler sends equal the reference's."""
    rng = np.random.default_rng(5)
    trace = np.concatenate([rng.uniform(40, 120, (6, 3)), rng.uniform(3, 9, (6, 3)),
                            rng.uniform(0, 1, (12, 3))])
    kw = dict(min_workers=1, max_workers=4, autoscale_up_backlog=20.0,
              autoscale_down_backlog=4.0, autoscale_idle_s=2.0, autoscale_cooldown_s=1.0,
              autoscale_ema_beta=0.5)
    runs = []
    for mod, cfgmod in ((fed, None), (jfed, jconfig)):
        clock = FakeClock()
        handlers = {}
        front, _ = make_scripted_front(handlers, clock=clock, mod=mod, cfgmod=cfgmod, **kw)
        backlogs = {h: [0.0] for h in ("h0", "h1", "h2")}
        for i, h in enumerate(backlogs):
            front.registry.register(h, "127.0.0.1", 7000 + i)
        scaled = []
        handlers.update(_scaling_agents(backlogs, scaled))
        scaler = mod.HostAutoscaler(front, log=noop, clock=clock)
        actions = []
        for row in trace:
            for h, v in zip(backlogs, row):
                backlogs[h][0] = float(v)
            actions.append(scaler.tick())
            clock.advance(0.5)
        runs.append((actions, scaled, scaler.ema))
    assert runs[0] == runs[1]
    assert any("up" in a.values() for a in runs[0][0])
    assert any("down" in a.values() for a in runs[0][0])


# -- the front's /metrics: the third rung of the histogram ladder -------------


def _host_metrics(i):
    """A host agent's /metrics body: fleet gauges, its fleet-merged
    latency rows, the per-worker rows, and a size-class row."""
    lines = [f"roko_fleet_workers {2 + i}", f"roko_fleet_workers_up {1 + i}",
             "# TYPE roko_request_latency_seconds histogram"]
    for labels, scale in (("", 3), (',worker="0"', 1), (',worker="1"', 2)):
        for le, n in (("0.05", 1), ("0.1", 2), ("+Inf", 3)):
            lines.append(f'roko_request_latency_seconds_bucket{{le="{le}"{labels}}} '
                         f"{n * scale + i}")
        lines.append(f"roko_request_latency_seconds_sum{{{labels[1:]}}} {0.1 * scale + i}"
                     if labels else f"roko_request_latency_seconds_sum {0.1 * scale + i}")
        lines.append(f"roko_request_latency_seconds_count{{{labels[1:]}}} {3 * scale + i}"
                     if labels else f"roko_request_latency_seconds_count {3 * scale + i}")
    lines.append('roko_queue_wait_seconds_bucket{le="+Inf",size_class="le8"} 4')
    lines.append(f'roko_queue_wait_seconds_bucket{{le="0.01"}} {i}')
    lines.append(f'roko_queue_wait_seconds_bucket{{le="+Inf"}} {i + 2}')
    lines.append(f"roko_queue_wait_seconds_sum {i}")
    lines.append(f"roko_queue_wait_seconds_count {i + 2}")
    return ("\n".join(lines) + "\n").encode()


def test_front_metrics_text_equals_reference():
    """The front's merged ``/metrics`` over two scripted agents (plus an
    expired one that is not scraped): the port's text equals the
    reference's, byte for byte."""

    def agents(front):
        return {f"h{i}": (lambda m, p, h, b, i=i: (200, {}, _host_metrics(i))) for i in range(3)}

    clocks = [FakeClock(), FakeClock()]
    it = iter(clocks)
    texts = []
    for (front, _), clock in zip(both_fronts(agents, lambda: next(it)), clocks):
        front.registry.register("h2", "127.0.0.1", 7002)
        clock.advance(5.0)
        front.registry.register("h0", "127.0.0.1", 7000)
        front.registry.register("h1", "127.0.0.1", 7001)
        front.registry.register("h1", "127.0.0.1", 7001)
        clock.advance(6.0)
        front.registry.sweep()
        texts.append(front.render_metrics())
    assert texts[0] == texts[1]
    assert 'roko_fleet_workers{host="h0"} 2' in texts[0]
    assert 'roko_federation_host_epoch{host="h1"} 2' in texts[0]
    assert 'roko_request_latency_seconds_bucket{le="+Inf"} 19' in texts[0]
    assert 'host="h2"' not in texts[0].split("roko_federation_host_epoch")[-1]


def test_trace_probe_renders_host_rows_and_federation_counters(capsys):
    """``tools/trace_probe.py`` reads the port's front: the host-labelled
    histogram rows and the federation counters."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("trace_probe",
                                                  str(ROOT / "tools" / "trace_probe.py"))
    tp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tp)
    clock = FakeClock()
    handlers = {f"h{i}": (lambda m, p, h, b, i=i: (200, {}, _host_metrics(i)))
                for i in range(2)}
    front, _ = make_scripted_front(handlers, clock=clock, lease_ttl_s=2.0)
    front.registry.register("h0", "127.0.0.1", 7000)
    clock.advance(3.0)
    front.registry.register("h1", "127.0.0.1", 7001)
    front.registry.sweep()
    front.registry.inc("fence_refusals")
    tp.print_metrics(front.render_metrics())
    out = capsys.readouterr().out
    assert 'roko_request_latency_seconds{host="h1"}' in out
    assert "federation: hosts=2 up=1 lease_expiries=1 fence_refusals=1" in out


# -- the client's total-deadline budget ---------------------------------------------


def test_client_deadline_budget_names_the_budget():
    c = PolishClient("http://127.0.0.1:1", deadline_s=5.0)
    slept = []
    c._sleep = slept.append

    def busy(*a, **kw):
        raise ServerBusy(30.0)

    c._request = busy
    with pytest.raises(ServiceUnavailable) as ei:
        c._post_with_retries({}, retries=3)
    # the FIRST 30 s wait would already overshoot the 5 s budget: no sleep
    # happens, and the error names the budget
    assert slept == []
    assert ei.value.deadline_s == 5.0
    assert "deadline_s=5.0" in str(ei.value)
    assert "1 attempt(s)" in str(ei.value)


def test_client_deadline_per_call_overrides_constructor():
    c = PolishClient("http://127.0.0.1:1")
    c._sleep = lambda s: None

    def busy(*a, **kw):
        raise ServerBusy(30.0)

    c._request = busy
    with pytest.raises(ServiceUnavailable, match="deadline_s=2.0"):
        c._post_with_retries({}, retries=3, deadline_s=2.0)


def test_client_without_deadline_keeps_historical_message():
    c = PolishClient("http://127.0.0.1:1")
    slept = []
    c._sleep = slept.append

    def busy(*a, **kw):
        raise ServerBusy(0.01)

    c._request = busy
    with pytest.raises(ServiceUnavailable) as ei:
        c._post_with_retries({}, retries=2)
    assert len(slept) == 2
    assert "all 3 attempt(s)" in str(ei.value)
    assert "deadline" not in str(ei.value)
    assert ei.value.deadline_s is None


# -- end to end on loopback: real agents, stub-worker fleets ------------------------


def _start_serving(server):
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    return th


def _stub_host(tmp_path, i, fed_port, tag=""):
    cfg = RokoConfig(
        serve=ServeConfig(max_queue=8, retry_after_s=0.2),
        fleet=fast_fleet_cfg(workers=1, host_id=f"h{i}", join=f"127.0.0.1:{fed_port}",
                             lease_ttl_s=2.0),
    )
    fleet = Fleet(cfg, stub_command, runtime_dir=str(tmp_path / f"host{i}{tag}"), log=noop)
    agent = HostAgent(fleet, cfg, log=noop)
    server = make_front_server(fleet, port=0, handler_base=make_agent_handler(agent))
    thread = _start_serving(server)
    fleet.start()
    agent.start(server.server_address[1])
    return fleet, agent, server, thread


def _worker_pid(fleet):
    return fleet.workers[0].proc.pid


def test_federation_end_to_end_two_hosts(tmp_path):
    """A real front and two host agents, each supervising a real
    (stub-worker) Fleet over TCP on loopback: registration, round-robin
    relays, zombie fencing after an epoch bump, degraded-mode survival
    after one host's front dies, and the dead host's rejoin under a bumped
    epoch, routed to again, with no client-visible error throughout."""
    fed_front = FederationFront(
        fed_config(lease_ttl_s=2.0, fed_breaker_failures=1, fed_breaker_reset_s=0.5),
        log=noop)
    fed_server = make_federation_server(fed_front, host="127.0.0.1", port=0)
    fed_thread = _start_serving(fed_server)
    fed_port = fed_server.server_address[1]
    fed_front.start()
    hosts = []
    try:
        for i in range(2):
            hosts.append(_stub_host(tmp_path, i, fed_port))
        servers = [h[2] for h in hosts]
        wait_until(lambda: len(fed_front.registry.live()) == 2
                   and all(get_json(s.server_address[1], "/healthz")[0] == 200
                           for s in servers),
                   timeout=30, msg="both hosts registered and ready")
        client = PolishClient(f"http://127.0.0.1:{fed_port}", timeout=30)
        replies = [post(client) for _ in range(4)]
        assert all(r["polished"].startswith("STUB-") for r in replies)
        # round robin spread the load over BOTH hosts' workers
        assert {r["polished"] for r in replies} == {
            f"STUB-{_worker_pid(h[0])}" for h in hosts}
        assert fed_front.registry.counter("relays") >= 4
        code, body = get_json(fed_port, "/healthz")
        assert code == 200 and body["status"] == "ok"
        assert set(body["hosts"]) == {"h0", "h1"}
        assert body["federation"]["fence_refusals"] == 0
        text = fed_front.render_metrics()
        assert "roko_federation_hosts 2" in text
        assert "roko_federation_hosts_up 2" in text
        assert 'roko_fleet_workers{host="h0"}' in text and 'host="h1"' in text
        # -- zombie fencing: h0's agent keeps epoch 1 while the registry
        # moves to epoch 2 ---
        hosts[0][1].stop()  # no heal: the zombie never registers again
        time.sleep(0.05)
        fed_front.registry.register("h0", "127.0.0.1", servers[0].server_address[1], workers=1)
        for _ in range(2):  # both round-robin slots: one hits h0
            assert post(client)["polished"] == f"STUB-{_worker_pid(hosts[1][0])}"
        assert fed_front.registry.counter("fence_refusals") >= 1
        # -- host death (its front's socket gone): the survivor serves with
        # no client error ---
        stop_front(servers[0], hosts[0][3])
        hosts[0][0].stop(rolling=False)
        for _ in range(3):
            assert post(client)["polished"].startswith("STUB-")
        wait_until(lambda: get_json(fed_port, "/healthz")[1]["status"] == "degraded",
                   timeout=15, msg="degraded mode after host death")
        code, body = get_json(fed_port, "/healthz")
        assert body["hosts"]["h0"]["state"] in ("expired", "breaker-open")
        assert body["hosts"]["h1"]["state"] == "live"
        # -- rejoin: h0 comes back under the same host id, one epoch up ---
        old_epoch = fed_front.registry.current_epoch("h0")
        hosts[0] = _stub_host(tmp_path, 0, fed_port, tag="b")
        wait_until(lambda: (lambda l: l is not None and l.state() == "live"
                            and l.epoch == old_epoch + 1)(fed_front.registry.get("h0"))
                   and get_json(hosts[0][2].server_address[1], "/healthz")[0] == 200,
                   timeout=30, msg="h0 rejoined")
        assert hosts[0][1].epoch == old_epoch + 1
        served = {post(client)["polished"] for _ in range(4)}
        assert f"STUB-{_worker_pid(hosts[0][0])}" in served
        wait_until(lambda: get_json(fed_port, "/healthz")[1]["status"] == "ok", timeout=15,
                   msg="ok again after the rejoin")
    finally:
        fed_front.stop()
        for fleet, agent, server, thread in hosts:
            agent.stop()
            try:
                stop_front(server, thread)
            except OSError:
                pass
            fleet.stop(rolling=False)
        stop_front(fed_server, fed_thread)


def test_agent_handler_echoes_epoch_and_scales(tmp_path):
    """Every agent reply carries X-Roko-Fed-Epoch, /healthz carries the
    host identity, and /scale resizes the local fleet."""
    fleet = make_fleet(tmp_path, workers=1)
    cfg = RokoConfig(serve=ServeConfig(max_queue=8, retry_after_s=0.2),
                     fleet=fast_fleet_cfg(workers=1, host_id="solo", join="127.0.0.1:1"))
    agent = HostAgent(fleet, cfg, log=noop)
    agent.epoch = 5
    server = make_front_server(fleet, port=0, handler_base=make_agent_handler(agent))
    th = _start_serving(server)
    port = server.server_address[1]
    try:
        fleet.start()
        wait_until(lambda: get_json(port, "/healthz")[0] == 200, timeout=30,
                   msg="solo fleet ready")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            assert r.headers[FED_EPOCH_HEADER] == "5"
            body = json.loads(r.read())
        assert body["host_id"] == "solo"
        assert body["epoch"] == 5
        assert "backlog_windows" in body  # the host autoscaler's load signal
        # fenced relay: a NEWER epoch in the relay header means this
        # process is the zombie: 409, no worker touched
        req = urllib.request.Request(f"http://127.0.0.1:{port}/polish", data=b"{}",
                                     headers={FED_EPOCH_HEADER: "6"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=10)
        assert exc.value.code == 409
        assert exc.value.headers[FED_EPOCH_HEADER] == "5"
        assert json.loads(exc.value.read())["fenced"] is True
        req = urllib.request.Request(f"http://127.0.0.1:{port}/scale",
                                     data=json.dumps({"workers": 2}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            assert json.loads(r.read())["workers"] == 2
        wait_until(lambda: len(fleet.workers) == 2, timeout=15,
                   msg="scale-up through the agent")
    finally:
        stop_front(server, th)
        fleet.stop(rolling=False)


def test_host_agent_requires_join_target(tmp_path):
    fleet = make_fleet(tmp_path, workers=1)
    with pytest.raises(ValueError, match="--join") as got:
        HostAgent(fleet, fed_config(), log=noop)
    with pytest.raises(ValueError) as want:
        jfed.HostAgent(fleet, fed_config(jconfig), log=noop)
    assert str(got.value) == str(want.value)


# -- the command line ----------------------------------------------------------------


def _env():
    return {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "ROKO_FED_FAULTS")}


def _announced_port(path, proc, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            pytest.fail(f"exited {proc.returncode}: {proc.stdout.read()[-3000:]}")
        try:
            with open(path) as fh:
                return json.load(fh)["port"]
        except (OSError, ValueError, KeyError):
            time.sleep(0.05)
    pytest.fail(f"no announce file {path}")


def test_cli_federation_front_runs_model_less(tmp_path):
    """``python -m roko_tpu_torch serve --federation`` needs no MODEL and
    loads none: /healthz says warming (no host yet) in the reference's
    shape, a host registers through /fed/register, and SIGTERM drains it
    to exit 0."""
    announce = str(tmp_path / "front.json")
    proc = subprocess.Popen(
        [sys.executable, "-m", "roko_tpu_torch", "serve", "--federation", "--port", "0",
         "--announce", announce, "--lease-ttl", "3"],
        cwd=str(ROOT), env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        port = _announced_port(announce, proc)
        wait_until(lambda: get_json(port, "/healthz")[0] == 503, timeout=30,
                   msg="front answering")
        code, body = get_json(port, "/healthz")
        assert body["status"] == "warming" and body["hosts"] == {}
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/fed/register",
            data=json.dumps({"host_id": "h9", "port": 7009}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            grant = json.loads(r.read())
        assert grant["epoch"] == 1 and grant["ttl_s"] == 3.0
        assert get_json(port, "/healthz")[1]["status"] == "ok"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out[-3000:]
        assert "front end binding" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# -- a real CPU host agent: POST /job over the object store --------------------------


from tests.test_torch_distpolish import project  # noqa: E402,F401  (module fixture)


def test_host_agent_job_over_store_byte_identical(project, tmp_path):
    """A real host agent through the CLI (``serve MODEL --host-agent
    --join ... --host-id h0 --lease-ttl 2 --workers 1 --store-endpoint
    URL --device cpu``) behind an in-process front: it registers, a
    ``/polish`` relayed by the front carries ``X-Roko-Host``, and its
    ``POST /job`` reads the draft and BAM from a ``StubObjectStore`` and
    writes the FASTA there (``s3://`` URLs), byte-identical to ``roko-tpu
    polish`` on the same inputs and weights. SIGTERM drains the agent to
    exit 0 with no worker left."""
    from roko_tpu_torch.datapipe.store import StubObjectStore
    from roko_tpu_torch.serve.client import _b64

    bucket = tmp_path / "bucket" / "bkt"
    bucket.mkdir(parents=True)
    for name, src in (("draft.fasta", project["fasta"]), ("reads.bam", project["bam"]),
                      ("reads.bam.bai", project["bam"] + ".bai")):
        (bucket / name).write_bytes(open(src, "rb").read())
    stub = StubObjectStore(str(tmp_path / "bucket")).start()
    front = FederationFront(fed_config(lease_ttl_s=2.0), log=noop)
    fed_server = make_federation_server(front, host="127.0.0.1", port=0)
    fed_thread = _start_serving(fed_server)
    front.start()
    runtime = str(tmp_path / "runtime")
    cfg = project["cfg"]
    cfg_json = tmp_path / "agent.json"
    cfg_json.write_text(RokoConfig(
        model=cfg.model, region=cfg.region, serve=cfg.serve, distpolish=cfg.distpolish,
        fleet=FleetConfig(heartbeat_interval_s=0.25, runtime_dir=runtime)).to_json())
    announce = str(tmp_path / "agent.announce.json")
    proc = subprocess.Popen(
        [sys.executable, "-m", "roko_tpu_torch", "serve", project["pth"], "--host-agent",
         "--join", f"127.0.0.1:{fed_server.server_address[1]}", "--host-id", "h0",
         "--lease-ttl", "2", "--workers", "1", "--config", str(cfg_json),
         "--store-endpoint", stub.url, "--store-cache", str(tmp_path / "cache"),
         "--port", "0", "--announce", announce, "--device", "cpu"],
        cwd=str(ROOT), env=dict(_env(), ROKO_COMPILE_CACHE="off"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    worker = None
    try:
        port = _announced_port(announce, proc)
        wait_until(lambda: front.registry.get("h0") is not None
                   and get_json(port, "/healthz")[1].get("status") == "ok",
                   timeout=240, msg="the host agent registered and its worker warm")
        assert front.registry.get("h0").epoch == 1
        with open(os.path.join(runtime, "worker-0.announce.json")) as fh:
            worker = json.load(fh)["pid"]
        # one relayed /polish: served, and X-Roko-Host names the agent
        rng = np.random.default_rng(0)
        positions = np.stack([np.arange(90), np.zeros(90, np.int64)], 1)[None]
        examples = rng.integers(0, 12, (1, 200, 90), dtype=np.uint8)
        payload = {"contig": "c", "draft": "ACGT" * 30, "n": 1,
                   "positions": _b64(positions, np.int64), "examples": _b64(examples, np.uint8)}
        req = urllib.request.Request(
            f"http://127.0.0.1:{fed_server.server_address[1]}/polish",
            data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"},
            method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.headers[FED_HOST_HEADER] == "h0"
            assert json.loads(r.read())["windows"] == 1
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/job",
            data=json.dumps({"ref": "s3://bkt/draft.fasta", "bam": "s3://bkt/reads.bam",
                             "out": "s3://bkt/job.fasta", "seed": 0}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 202
        wait_until(lambda: get_json(port, "/jobz")[1].get("state") in ("done", "failed"),
                   timeout=240, msg="the job's end")
        assert get_json(port, "/jobz")[1]["state"] == "done"
        got = (bucket / "job.fasta").read_bytes()
        assert got == project["reference"] == project["single"]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0, out[-4000:]
        assert "host agent 'h0'" in out
    finally:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
        front.stop()
        stop_front(fed_server, fed_thread)
        stub.shutdown()
        stub.server_close()
    if worker is not None:
        with pytest.raises(ProcessLookupError):
            os.kill(worker, 0)
