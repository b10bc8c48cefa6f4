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
        "requests": 1, "windows": 0, "batches": 0, "rejected": 0}
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
    assert metrics.counters == {"requests": 3, "windows": 29, "batches": 2, "rejected": 2}


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
                fut = batcher.submit(x)
            except Exception as e:  # each package raises its own class
                if type(e).__name__ != "Backpressure":
                    raise
                # the reference's Retry-After hint is not ported
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


def test_journal_commits_resumes_and_refuses(tmp_path):
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
    with pytest.raises(ValueError, match="remote stores"):
        PolishJournal("gs://bucket/o.fasta")


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
