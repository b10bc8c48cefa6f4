"""The port's batching plane on the CPU: the continuous batcher
(``roko_tpu_torch.serve.scheduler``) on a fake session, mirroring
``tests/test_scheduler.py``'s policy cases and replaying seeded submit
sequences through both packages' batchers to the same plans and spans;
``PolishSession`` against the unpadded model and ``roko_tpu``'s session
on the same weights; and the host pieces it rides on (watchdog, journal,
metrics, config) against their references.

Scheduler cases drive one cycle at a time, synchronously, with the clock
passed in: no thread, no timing race."""

import dataclasses
import json
import os
import random
import threading
import time

import jax
import numpy as np
import pytest
import torch

from roko_tpu.config import MeshConfig as JaxMeshConfig
from roko_tpu.config import ModelConfig as JaxModelConfig
from roko_tpu.config import RokoConfig as JaxRokoConfig
from roko_tpu.config import ServeConfig as JaxServeConfig
from roko_tpu.config import resolve_ladder as ref_resolve_ladder
from roko_tpu.models import RokoModel as JaxRokoModel
from roko_tpu.obs import events as ref_events
from roko_tpu.parallel.mesh import make_mesh
from roko_tpu.serve.scheduler import ContinuousBatcher as RefBatcher
from roko_tpu.serve.session import PolishSession as RefSession
from roko_tpu_torch import constants as C
from roko_tpu_torch.config import (
    ModelConfig,
    ResilienceConfig,
    RokoConfig,
    ServeConfig,
    resolve_ladder,
    validate_ladder,
)
from roko_tpu_torch.infer import pad_windows, rung_for, tail_rungs
from roko_tpu_torch.models.convert import state_dict_from_jax
from roko_tpu_torch.models.model import RokoModel
from roko_tpu_torch.obs import events
from roko_tpu_torch.resilience import HangError, call_with_deadline
from roko_tpu_torch.resilience.journal import JournalMismatch, PolishJournal
from roko_tpu_torch.serve.batcher import Backpressure
from roko_tpu_torch.serve.metrics import ServeMetrics
from roko_tpu_torch.serve.scheduler import ContinuousBatcher
from roko_tpu_torch.serve.session import PolishSession
from tests.test_scheduler import FakeRaggedSession as RefFakeRaggedSession
from tests.test_scheduler import FakeSession as RefFakeSession
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROWS, COLS = 200, 90


class FakeSession:
    """Ladder arithmetic + a deterministic 'predict' without a model:
    predict(x)[i] is a function of window i's bytes only."""

    def __init__(self, ladder=(8, 16)):
        self.ladder = tuple(ladder)
        self.cfg = RokoConfig(serve=ServeConfig(ladder=self.ladder))
        self._window_shape = (ROWS, COLS)
        self.dispatched = []

    def rung_for(self, n):
        return rung_for(self.ladder, n)

    def padded_size(self, n):
        top = self.ladder[-1]
        full, rest = divmod(n, top)
        return full * top + (self.rung_for(rest) if rest else 0)

    def predict(self, x):
        self.dispatched.append(x.shape[0])
        return x.sum(axis=1, dtype=np.int64).astype(np.int32)


class FakeRaggedSession(FakeSession):
    """The ragged step's contract without a model: the full top-rung slab
    and a valid-row count, rows at or past it zeroed."""

    dp = 1

    def ragged_slots(self, n):
        return n

    def predict_ragged(self, x, n):
        assert x.shape[0] == self.ladder[-1]
        self.dispatched.append((x.shape[0], n))
        masked = x.copy()
        masked[n:] = 0
        return masked.sum(axis=1, dtype=np.int64).astype(np.int32)[:n]


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _win(rng, n):
    return rng.integers(0, C.FEATURE_VOCAB, (n, ROWS, COLS)).astype(np.uint8)


def make_cb(session=None, **kw):
    kw.setdefault("max_queue", 8)
    kw.setdefault("max_queue_age_ms", 50.0)
    kw.setdefault("start", False)
    return ContinuousBatcher(session or FakeSession(), **kw)


def step(cb, ahead=0.0):
    """One scheduler cycle (plan -> take -> dispatch) with the clock
    ``ahead`` seconds in the future; the spans it packed, or None."""
    with cb._cv:
        k, _ = cb._plan(time.perf_counter() + ahead)
        spans = cb._take(k) if k is not None else None
    if spans:
        cb._dispatch(spans)
    return spans


# -- policy cases, as tests/test_scheduler.py:136-560 checks them -----------


def test_plan_full_top_rung_and_hysteresis(rng):
    for n, want in ((40, 16), (9, 8), (13, 13)):
        cb = make_cb()
        cb.submit(_win(rng, n))
        with cb._cv:
            assert cb._plan(time.perf_counter())[0] == want, n


def test_plan_waits_then_age_flushes_small_backlog(rng):
    cb = make_cb(max_queue_age_ms=30.0)
    cb.submit(_win(rng, 3))
    with cb._cv:
        k, wait = cb._plan(time.perf_counter())
    assert k is None and 0 < wait <= 0.030
    with cb._cv:
        assert cb._plan(time.perf_counter() + 0.040)[0] == 3


def test_fair_share_packs_small_with_large_and_scatters(rng):
    cb = make_cb()
    large, small = cb.submit(_win(rng, 20)), cb.submit(_win(rng, 2))
    spans = step(cb)
    assert {s.n for s, _, _, _ in spans} == {2, 20}
    assert small.done() and not large.done()
    step(cb, ahead=1.0)
    assert large.done()
    xs = [_win(rng, n) for n in (5, 11, 2, 16, 1)]
    futs = [cb.submit(x) for x in xs]
    for _ in range(10):
        step(cb, ahead=1.0)
    for x, f in zip(xs, futs):
        np.testing.assert_array_equal(f.result(0), x.sum(axis=1, dtype=np.int64))


def test_small_never_waits_behind_large_and_neither_starves(rng):
    cb = make_cb(max_queue=64)
    large = cb.submit(_win(rng, 48))
    step(cb)
    small = cb.submit(_win(rng, 2))
    step(cb)
    assert small.done() and not large.done()
    while not large.done():
        assert step(cb, ahead=1.0) is not None
    big = cb.submit(_win(rng, 32))
    for _ in range(12):
        cb.submit(_win(rng, 2))
        step(cb)
        if big.done():
            break
    assert big.done()


def test_stop_fails_incomplete_requests_loudly(rng):
    cb = make_cb()
    done = cb.submit(_win(rng, 8))
    step(cb)
    partial = cb.submit(_win(rng, 48))
    step(cb)
    cb.stop()
    with pytest.raises(RuntimeError, match="batcher stopped"):
        partial.result(0)
    assert done.result(0).shape == (8, COLS)
    with pytest.raises(RuntimeError, match="batcher stopped"):
        cb.submit(_win(rng, 1))


def test_geometry_and_device_errors(rng):
    class Sick(FakeSession):
        boom = True

        def predict(self, x):
            if self.boom:
                self.boom = False
                raise RuntimeError("the card ate it")
            return super().predict(x)

    cb = make_cb(Sick())
    with pytest.raises(ValueError, match="windows shaped"):
        cb.submit(np.zeros((2, 10, 10), np.uint8))
    a, b = cb.submit(_win(rng, 6)), cb.submit(_win(rng, 2))
    step(cb)
    for f in (a, b):
        with pytest.raises(RuntimeError, match="the card ate it"):
            f.result(0)
    assert cb._pool == []
    c = cb.submit(_win(rng, 8))
    step(cb)
    assert c.result(0).shape == (8, COLS)


def test_zero_window_request_completes_at_once(rng):
    metrics = ServeMetrics()
    cb = make_cb(metrics=metrics)
    assert cb.submit(_win(rng, 0)).result(0).shape == (0, COLS)
    assert cb._pool == [] and metrics.counters == {
        "requests": 1, "windows": 0, "batches": 0, "rejected": 0, "errors": 0}
    real = cb.submit(_win(rng, 4))
    step(cb, ahead=1.0)
    assert real.result(0).shape == (4, COLS)


def test_backpressure_when_the_pool_is_full(rng):
    metrics = ServeMetrics()
    cb = make_cb(max_queue=2, metrics=metrics)
    cb.submit(_win(rng, 16))
    cb.submit(_win(rng, 12))
    with pytest.raises(Backpressure, match="request queue full"):
        cb.submit(_win(rng, 1))
    step(cb)  # fair share: 8 windows of each, so both stay in the pool
    with pytest.raises(Backpressure):
        cb.submit(_win(rng, 1))
    step(cb)  # the last 12 fill 0.75 of the 16 rung: both packed whole
    cb.submit(_win(rng, 1))
    assert metrics.counters == {"requests": 3, "windows": 29, "batches": 2, "rejected": 2,
                                "errors": 0}


def test_metrics_padding_efficiency(rng):
    metrics = ServeMetrics()
    assert metrics.fill_ratio() is None
    cb = make_cb(metrics=metrics)
    small, large = cb.submit(_win(rng, 2)), cb.submit(_win(rng, 14))
    while not (small.done() and large.done()):
        step(cb, ahead=1.0)
    assert metrics.fill_totals() == (16, 16) and metrics.fill_ratio() == 1.0
    cb.submit(_win(rng, 3))
    step(cb, ahead=1.0)  # age flush: 3 windows padded to the 8 rung
    assert metrics.fill_totals() == (19, 24) and metrics.fill_ratio() == 19 / 24
    assert metrics.counters["batches"] == 2


def test_scheduler_thread_serves_and_stops(rng):
    """The started batcher: futures complete on its own thread, and stop
    joins it."""
    cb = make_cb(start=True, max_queue_age_ms=5.0)
    futs = [cb.submit(_win(rng, n)) for n in (3, 20, 1)]
    for f in futs:
        assert f.result(5.0).shape[1] == COLS
    assert cb.scheduler_alive()
    cb.stop()
    assert not cb.scheduler_alive()


# -- the same submit sequences through both packages' batchers --------------


def _replay(seed):
    """Seeded ops: submits of 0-40 windows, and cycles at the present
    clock or past the age bound."""
    rng = random.Random(seed)
    ops = []
    for _ in range(60):
        r = rng.random()
        if r < 0.45:
            ops.append(("submit", rng.randrange(0, 41)))
        else:
            ops.append(("step", rng.choice([0.0, 100.0])))
    return ops


def _run_ops(batcher, ops, rng):
    """Plans and spans, slots named by submission order; rejections by
    their exception type and reason."""
    ids, trace, futs = {}, [], []
    for op in ops:
        if op[0] == "submit":
            x = _win(rng, op[1])
            try:
                fut = batcher.submit(x, tenant=op[2] if len(op) > 2 else None)
            except Exception as e:  # each package raises its own class
                if type(e).__name__ not in ("Backpressure", "QuotaExceeded"):
                    raise
                # the Retry-After hint follows each run's measured
                # throughput: compared apart from the reason
                trace.append(("rejected", type(e).__name__, str(e).split(";")[0]))
                continue
            ids[id(fut._req)] = len(ids)
            futs.append((fut, x))
        else:
            with batcher._cv:
                k, _ = batcher._plan(time.perf_counter() + op[1])
                spans = batcher._take(k) if k is not None else []
            trace.append(("plan", k, [(ids[id(s)], a, n, o) for s, a, n, o in spans]))
            if spans:
                batcher._dispatch(spans)
    done = [(i, f.done()) for i, (f, _) in enumerate(futs)]
    for f, x in futs:
        if f.done():
            np.testing.assert_array_equal(f.result(0), x.sum(axis=1, dtype=np.int64))
    return trace, done


@pytest.mark.parametrize("seed", range(6))
def test_same_plans_and_spans_as_reference(seed):
    ops = _replay(seed)
    kw = dict(max_queue=6, max_queue_age_ms=10_000.0, start=False)
    ladder = (8, 16, 32) if seed % 3 else (8, 16)
    port = ContinuousBatcher(FakeSession(ladder), **kw)
    ref = RefBatcher(RefFakeSession(ladder), **kw)
    got = _run_ops(port, ops, np.random.default_rng(seed))
    want = _run_ops(ref, ops, np.random.default_rng(seed))
    assert got == want
    assert any(t[0] == "plan" and t[2] for t in got[0])


def _tenant_replay(seed):
    """Seeded ops over three tenants: submits of 0-24 windows, cycles."""
    rng = random.Random(100 + seed)
    ops = []
    for _ in range(80):
        if rng.random() < 0.5:
            ops.append(("submit", rng.randrange(0, 25), rng.choice(["gold", "bulk", "capped"])))
        else:
            ops.append(("step", rng.choice([0.0, 100.0])))
    return ops


@pytest.mark.parametrize("seed", range(4))
def test_tenant_grants_equal_reference(seed):
    """Deficit-weighted round-robin over tenants (weights 3 and 1, a
    queue-capped and an in-flight-capped tenant): the same plans, spans,
    429 rejections and deficits as the reference's batcher with the same
    TenantConfigs."""
    from roko_tpu.config import TenantConfig as RefTenant
    from roko_tpu_torch.config import TenantConfig

    rows = (("gold", 3.0, 0, 0), ("bulk", 1.0, 0, 0), ("capped", 1.0, 20, 2 + seed % 2))
    ops = _tenant_replay(seed)
    kw = dict(max_queue=8, max_queue_age_ms=10_000.0, start=False)
    port = ContinuousBatcher(FakeSession((8, 16, 32)), tenants=tuple(TenantConfig(*r) for r in rows),
                             **kw)
    ref = RefBatcher(RefFakeSession((8, 16, 32)), tenants=tuple(RefTenant(*r) for r in rows), **kw)
    got = _run_ops(port, ops, np.random.default_rng(seed))
    want = _run_ops(ref, ops, np.random.default_rng(seed))
    assert got == want
    assert port._deficit == ref._deficit
    assert any(t[0] == "rejected" and t[1] == "QuotaExceeded" for t in got[0])
    assert len({o for s in got[0] if s[0] == "plan" for o, *_ in s[2]}) > 3


@pytest.mark.parametrize("seed", range(4))
def test_ragged_plans_equal_reference(seed):
    from roko_tpu.serve.scheduler import RaggedBatcher as RefRagged
    from roko_tpu_torch.serve.scheduler import RaggedBatcher

    ops = _replay(seed)
    kw = dict(max_queue=6, max_queue_age_ms=10_000.0, start=False)
    port_session, ref_session = FakeRaggedSession((8, 16)), RefFakeRaggedSession((8, 16))
    got = _run_ops(RaggedBatcher(port_session, **kw), ops, np.random.default_rng(seed))
    want = _run_ops(RefRagged(ref_session, **kw), ops, np.random.default_rng(seed))
    assert got == want
    assert port_session.dispatched == ref_session.dispatched
    assert all(rows == 16 for rows, _ in port_session.dispatched)


# -- the deadline batcher, as tests/test_serve.py:125-233 ------------------


def make_mb(session=None, **kw):
    from roko_tpu_torch.serve.batcher import MicroBatcher

    kw.setdefault("start", False)
    return MicroBatcher(session or FakeSession(), **kw)


def test_micro_batcher_deadline_flushes_a_lone_request(rng):
    metrics = ServeMetrics()
    mb = make_mb(start=True, max_delay_ms=5.0, metrics=metrics)
    try:
        x = _win(rng, 3)
        np.testing.assert_array_equal(mb.predict(x, timeout=10.0),
                                      x.sum(axis=1, dtype=np.int64))
        assert metrics.counters["batches"] == 1 and metrics.counters["windows"] == 3
        assert metrics.fill_ratio() == pytest.approx(3 / 8)
        assert metrics.timer.counts["request"] == 1
    finally:
        mb.stop()


def test_micro_batcher_gather_coalesces_and_stops_at_the_top_rung(rng):
    session = FakeSession()
    mb = make_mb(session, metrics=ServeMetrics())
    xa, xb = _win(rng, 3), _win(rng, 4)
    fa, fb = mb.submit(xa), mb.submit(xb)
    batch = mb._gather(mb._q.get_nowait())
    assert [len(r.x) for r in batch] == [3, 4]
    mb._dispatch(batch)
    np.testing.assert_array_equal(fa.result(0), xa.sum(axis=1, dtype=np.int64))
    np.testing.assert_array_equal(fb.result(0), xb.sum(axis=1, dtype=np.int64))
    assert mb.metrics.counters["batches"] == 1 and mb.metrics.fill_ratio() == 7 / 8
    # a backlog older than the deadline still coalesces
    mb = make_mb(session, max_delay_ms=0.0, metrics=ServeMetrics())
    futs = [mb.submit(_win(rng, 2)) for _ in range(3)]
    assert len(mb._gather(mb._q.get_nowait())) == 3
    # gathering stops once the top rung is full
    mb = make_mb(session)
    for _ in range(3):
        mb.submit(_win(rng, 6))
    batch = mb._gather(mb._q.get_nowait())
    assert sum(len(r.x) for r in batch) >= 16 and mb._q.qsize() == 0
    mb._dispatch(batch)
    assert session.dispatched[-1] == 18  # one predict; the session pads it to its ladder
    del futs


def test_micro_batcher_backpressure_stop_and_errors(rng):
    metrics = ServeMetrics()
    mb = make_mb(max_queue=2, retry_after_s=2.5, metrics=metrics)
    x = _win(rng, 1)
    mb.submit(x)
    mb.submit(x)
    with pytest.raises(Backpressure) as exc:
        mb.submit(x)
    assert exc.value.retry_after_s == 2.5 and str(exc.value) == \
        "request queue full; retry after 2.5s"
    assert metrics.counters["rejected"] == 1 and metrics.counters["requests"] == 2
    assert metrics.queue_depth() == 2
    queued = mb._q.queue[0]
    mb.stop()
    with pytest.raises(RuntimeError, match="batcher stopped"):
        PredictFutureOf(queued).result(0)
    with pytest.raises(RuntimeError, match="batcher stopped"):
        mb.submit(x)
    # a bad request fails its own future, and never moves the breaker
    from roko_tpu_torch.resilience import CircuitBreaker

    class Strict(FakeSession):
        def predict(self, x):
            if x.shape[1:] != self._window_shape:
                raise ValueError(f"windows shaped {x.shape}")
            return super().predict(x)

    breaker = CircuitBreaker(failure_threshold=1)
    mb = make_mb(Strict(), breaker=breaker)
    fut = mb.submit(np.zeros((2, 10, 10), np.uint8))
    mb._dispatch(mb._gather(mb._q.get_nowait()))
    with pytest.raises(ValueError):
        fut.result(0)
    assert breaker.state == "closed"


def print_nothing(line):
    raise AssertionError(f"a quiet event printed {line!r}")


def PredictFutureOf(req):
    from roko_tpu_torch.serve.batcher import PredictFuture

    return PredictFuture(req, None)


def test_micro_batcher_breaker_trips_and_sheds(rng):
    from roko_tpu_torch.resilience import CircuitBreaker

    class Sick(FakeSession):
        def predict(self, x):
            raise RuntimeError("the card ate it")

    breaker = CircuitBreaker(failure_threshold=2, reset_s=60.0)
    mb = make_mb(Sick(), breaker=breaker, metrics=ServeMetrics())
    for _ in range(2):
        fut = mb.submit(_win(rng, 2))
        mb._dispatch(mb._gather(mb._q.get_nowait()))
        with pytest.raises(RuntimeError, match="ate it"):
            fut.result(0)
    assert breaker.state == "open" and breaker.trip_count == 1
    with pytest.raises(Backpressure, match="circuit breaker open"):
        mb.submit(_win(rng, 1))
    assert mb.snapshot()["mode"] == "deadline"


# -- host pieces of the service against their references -------------------


def test_circuit_breaker_transitions_equal_reference():
    from roko_tpu.resilience import CircuitBreaker as RefBreaker
    from roko_tpu_torch.resilience import CircuitBreaker

    def run(cls):
        now = [0.0]
        b = cls(failure_threshold=3, reset_s=10.0, clock=lambda: now[0])
        seq = []
        script = ["f", "f", "s", "f", "f", "f", "a", "t5", "a", "t6", "a", "a", "c", "a",
                  "f", "t10", "a", "s", "a", "f", "f", "f", "t3"]
        for op in script:
            if op == "f":
                b.record_failure()
            elif op == "s":
                b.record_success()
            elif op == "a":
                seq.append(b.allow())
            elif op == "c":
                b.cancel_probe()
            else:
                now[0] += float(op[1:])
            seq.append((b.state, b.state_code(), round(b.retry_after_s(), 6), b.trip_count))
        return seq

    assert run(CircuitBreaker) == run(RefBreaker)
    with pytest.raises(ValueError):
        CircuitBreaker(failure_threshold=0)


def test_histogram_text_equals_reference():
    from roko_tpu.obs import hist as ref_hist
    from roko_tpu_torch.obs import hist

    r = random.Random(3)
    obs = [(r.expovariate(20.0), r.choice([None, "le8", "gt16"]),
            r.choice([(), (("tenant", "a"),), (("tenant", "b"), ("model", "v1"))]))
           for _ in range(300)]
    got, want = hist.HistogramFamily("h", label="size_class"), \
        ref_hist.HistogramFamily("h", label="size_class")
    for fam in (got, want):
        for seconds, label, extra in obs:
            fam.observe(seconds, label, extra_labels=extra)
    text = "\n".join(got.render())
    assert text == "\n".join(want.render())
    rows = hist.parse_histogram_rows(text, "h")
    assert rows == ref_hist.parse_histogram_rows(text, "h")
    merged = hist.merge_histogram_rows([rows, rows])
    assert merged == ref_hist.merge_histogram_rows([rows, rows])
    assert hist.render_histogram_rows("h", merged, 'worker="0"') == \
        ref_hist.render_histogram_rows("h", merged, 'worker="0"')
    for q in (0.5, 0.9, 0.99):
        assert hist.quantile_from_buckets(got.cumulative(), q) == \
            ref_hist.quantile_from_buckets(want.cumulative(), q)
    assert hist.DEFAULT_LATENCY_BUCKETS == ref_hist.DEFAULT_LATENCY_BUCKETS


def test_trace_ring_stays_bounded():
    from roko_tpu_torch.obs.trace import RequestTrace, TraceRing, new_request_id

    ring = TraceRing(last_n=4, slowest_n=2)
    for i in range(50):
        t = RequestTrace(f"r{i}", windows=i, tenant="a" if i % 2 else None)
        t.add("queue_wait", 0.001)
        t.add_step(0.002, rung=8, step=i, occupancy=0.5, dp=1, windows=i)
        t.finish()
        t.total_s = float(i % 7)  # a known order for the slowest board
        ring.record(t)
    snap = ring.snapshot()
    assert len(ring) == 4 and snap["seen"] == 50
    assert [r["request_id"] for r in snap["last"]] == ["r46", "r47", "r48", "r49"]
    assert [r["total_s"] for r in snap["slowest"]] == [6.0, 6.0]
    assert snap["last"][1]["tenant"] == "a" and "tenant" not in snap["last"][0]
    assert set(snap["last"][0]) == {"request_id", "total_s", "spans", "device_steps",
                                    "windows", "ts"}
    assert len(new_request_id()) == 16


def test_event_log_sink_rotates_as_reference(tmp_path):
    from roko_tpu.obs import events as ref_ev

    lines = {}
    for mod, tag in ((events, "port"), (ref_ev, "ref")):
        path = str(tmp_path / tag / "ev.jsonl")
        mod.configure_event_log(path, max_mb=300 / 2**20)
        try:
            for i in range(6):
                line = mod.emit("serve", "x", log=lambda s: None, request_id=f"r{i}", n=i,
                                f=0.5)
                assert line == f"ROKO_SERVE event=x n={i} f=0.5"
            assert mod.emit("serve", "q", quiet=True, log=print_nothing, n=1)
            assert mod.event_log_path() == path
        finally:
            mod.configure_event_log(None)
        lines[tag] = [[{k: v for k, v in json.loads(ln).items() if k != "ts"}
                       for ln in open(p)] for p in (path + ".1", path)]
    assert lines["port"] == lines["ref"] and lines["port"][1]
    assert events.event_log_path() is None and events.emit("serve", "q", quiet=True) == ""


# -- PolishSession ---------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxModelConfig(hidden_size=16, num_layers=2)
    params = jax.tree.map(np.asarray, JaxRokoModel(jcfg).init(jax.random.PRNGKey(2)))
    model = RokoModel(ModelConfig(hidden_size=16, num_layers=2))
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    x = np.random.default_rng(5).integers(0, C.FEATURE_VOCAB, (21, ROWS, COLS), dtype=np.uint8)
    return params, model, x


def test_session_predict_equals_unpadded_model_at_every_rung(tiny):
    _, model, x = tiny
    session = PolishSession(model, device="cpu", ladder=(4, 8, 16))
    with torch.inference_mode():
        want = model(torch.from_numpy(x)).argmax(-1).to(torch.int32).numpy()
    for n in (1, 3, 4, 5, 8, 9, 16, 21):
        np.testing.assert_array_equal(session.predict(x[:n]), want[:n])
    assert session.dispatched_shapes == {4, 8, 16}
    assert session.predict(x[:0]).shape == (0, COLS)
    assert session.padded_size(21) == 24 and session.rung_for(5) == 8
    with pytest.raises(ValueError, match="windows shaped"):
        session.predict(np.zeros((2, 10, 10), np.uint8))


def test_session_equals_reference_session(tiny):
    params, model, x = tiny
    jcfg = JaxRokoConfig(model=JaxModelConfig(hidden_size=16, num_layers=2),
                         mesh=JaxMeshConfig(dp=1))
    ref = RefSession(params, jcfg, mesh=make_mesh(jcfg.mesh, jax.devices()[:1]), ladder=(8, 16))
    session = PolishSession(model, device="cpu", ladder=(8, 16))
    assert session.warmup() == 2
    for n in (3, 16, 21):
        np.testing.assert_array_equal(session.predict(x[:n]), ref.predict(x[:n]))
    assert session.ladder == ref.ladder


def test_predict_ragged_is_bit_equal_to_predict(tiny):
    """The ragged step (a masked top-rung slab) gives the class ids of
    ``predict`` on the same rows, whatever stale rows the slab holds, and
    checks its slab and count as the reference's does."""
    _, model, x = tiny
    cfg = RokoConfig(model=model.cfg, serve=ServeConfig(batching="ragged"))
    session = PolishSession(model, cfg, device="cpu", ladder=(4, 8, 16))
    assert session.warmup() == 1 and session.dispatched_shapes == {16}
    assert session.warmup_report.mode == "serial" and set(session.warmup_report.per_rung_s) == {16}
    stale = x[5:21].copy()  # a slab whose tail holds other windows
    for n in (0, 1, 3, 8, 16):
        slab = stale.copy()
        slab[:n] = x[:n]
        got = session.predict_ragged(slab, n)
        assert got.shape == (n, COLS)
        np.testing.assert_array_equal(got, session.predict(x[:n]))
    assert session.ragged_slots(5) == 5 and session.failed_over is False
    assert session.cache_size() == session.ready_executables() == 4  # 3 rungs + the ragged step
    with pytest.raises(ValueError, match="ragged slab shaped"):
        session.predict_ragged(x[:8], 8)
    with pytest.raises(ValueError, match="outside"):
        session.predict_ragged(stale, 17)
    assert session._deadlines.is_warm(("ragged", 16))


def test_session_ladder_defaults_and_checks(tiny):
    _, model, _ = tiny
    assert PolishSession(model, device="cpu").ladder == (32, 128, 512)
    assert tail_rungs(resolve_ladder(ServeConfig(), 1), 128, 1) == (32, 128)
    with pytest.raises(ValueError, match="not positive multiples"):
        validate_ladder((8, 12), 8)
    with pytest.raises(ValueError, match="at least one"):
        PolishSession(model, device="cpu", ladder=())
    np.testing.assert_array_equal(pad_windows(np.ones((2, 3), np.uint8), 4)[2:], 0)


def test_session_refuses_cuda_without_a_card(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PolishSession(tiny[1], device="cuda")


def test_hang_fallback_is_not_an_option():
    """A hang raises HangError; the port has no CPU fail-over to ask for."""
    with pytest.raises(TypeError, match="hang_fallback"):
        ResilienceConfig(hang_fallback="cpu")
    assert "hang_fallback" not in dataclasses.asdict(ResilienceConfig())


def test_session_hang_raises_and_rearms_the_first_call_budget(tiny, monkeypatch, capsys):
    _, model, x = tiny
    cfg = RokoConfig(model=model.cfg,
                     resilience=ResilienceConfig(predict_deadline_s=0.1, compile_deadline_s=0.1))
    session = PolishSession(model, cfg, device="cpu", ladder=(4,))
    release = threading.Event()
    monkeypatch.setattr(session, "_forward", lambda xs: release.wait(5.0))
    try:
        with pytest.raises(HangError, match="serve-compile"):
            session.predict(x[:2])
    finally:
        release.set()
    err = capsys.readouterr().err
    assert err.startswith("ROKO_WATCHDOG hang stage=serve-compile deadline_s=0.1 threads=")
    assert "roko-watchdog-serve-compile" in err  # the stack dump
    assert not session._deadlines.is_warm(4)


# -- host pieces against their references ------------------------------------


def test_watchdog_and_events_match_reference():
    assert call_with_deadline(lambda: 7, 1.0) == 7
    assert call_with_deadline(lambda: 8, 0) == 8
    with pytest.raises(KeyError):
        call_with_deadline(lambda: {}["x"], 1.0)
    for args, kw in ((("watchdog", "hang", {"stage": "s", "deadline_s": 1.5}), {"bare_event": True}),
                     (("guard", "skip", {"loss": 0.1234567891}), {"suffix": "note"}),
                     (("failover", "x", None), {"text": "prose"})):
        assert events.format_line(*args, **kw) == ref_events.format_line(*args, **kw)


def test_journal_commits_resumes_and_refuses(tmp_path, monkeypatch):
    out = str(tmp_path / "o.fasta")
    meta = {"ref": "r", "seed": 1, "config": {"window": (1, 2)}}
    j = PolishJournal(out)
    assert j.open(meta, resume=False) == {}
    j.commit("b", "ACGT", 3)
    j.close()
    with open(j.manifest_path, "a") as fh:
        fh.write('{"contig": "torn"')  # a crash mid-append
    j = PolishJournal(out)
    assert j.open(meta, resume=True) == {"b": ("ACGT", 3)}
    j.close()
    with pytest.raises(JournalMismatch, match="different run"):
        PolishJournal(out).open(dict(meta, seed=2), resume=True)
    assert json.load(open(j.meta_path))["format"] == 1
    j = PolishJournal(out)
    assert j.open(meta, resume=False) == {}  # a fresh run drops stale state
    j.finalize()
    assert not (tmp_path / "o.fasta.resume").exists()
    # a store output's journal lives in the port's own local scratch root,
    # keyed by the URL
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    remote = PolishJournal("gs://bucket/o.fasta")
    assert remote.remote_dir == "gs://bucket/o.fasta.resume"
    assert os.path.dirname(remote.dir) == os.path.expanduser(
        os.path.join("~", ".cache", "roko_tpu_torch", "journal"))


def test_config_defaults_match_reference():
    from roko_tpu.config import PipelineConfig as RefPipeline
    from roko_tpu.config import ResilienceConfig as RefResilience
    from roko_tpu_torch.config import PipelineConfig

    assert dataclasses.asdict(PipelineConfig()) == dataclasses.asdict(RefPipeline())
    ref = dataclasses.asdict(RefResilience())
    assert {k: ref[k] for k in dataclasses.asdict(ResilienceConfig())} == dataclasses.asdict(
        ResilienceConfig())
    ref_serve, serve = dataclasses.asdict(JaxServeConfig()), dataclasses.asdict(ServeConfig())
    assert {k: ref_serve[k] for k in serve} == serve
    for dp in (1, 2, 8):
        assert resolve_ladder(ServeConfig(), dp) == ref_resolve_ladder(JaxServeConfig(), dp)
