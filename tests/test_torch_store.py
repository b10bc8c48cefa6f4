"""The port's object-store data plane (``roko_tpu_torch/datapipe/store.py``
behind ``datapipe/io.py``) case for case with ``tests/test_store.py``, and
held against the JAX package's client (``roko_tpu/datapipe/store.py``) in
the same process on the same inputs: the fault-spec parses and refusals,
the ``FaultyStore`` decisions under one seed, the ``StoreMismatch`` field
diff, the retry schedule and counters on the same scripted stub faults,
and the stub server's replies.

The contract is RECOVER OR REFUSE LOUDLY: every fault class the wire can
produce (timeout, 5xx, truncated body, checksum mismatch, torn write,
breaker open) either converges on the right bytes within the retry and
hedge budget or surfaces a typed ``StoreError``. Last, a real CPU ``python
-m roko_tpu_torch polish`` whose draft, BAM and output live in a
``StubObjectStore`` (``s3://`` URLs through ``--store-endpoint``), under
``FaultyStore`` at the storage gate's rates, writes FASTA byte-identical
to ``roko-tpu polish`` on the same inputs and weights."""

import hashlib
import http.client
import json
import os
import random
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

import roko_tpu.datapipe.store as jst
import roko_tpu_torch.datapipe.store as st
from roko_tpu_torch.datapipe import io as dio

ROOT = Path(__file__).resolve().parent.parent
GATE_RATES = "timeout:0.1,http500:0.05,truncate:0.02,torn_write:0.02"


def _fast_retry(attempts=4, mod=st):
    return mod.RetryPolicy(max_attempts=attempts, base_delay_s=0.01, max_delay_s=0.05,
                           retryable=(mod.StoreError, OSError))


@pytest.fixture(autouse=True)
def store_state():
    """Every test gets a clean process-wide store plane: counters zeroed,
    the default client and scheme registrations restored after."""
    st.reset_store_counters()
    jst.reset_store_counters()
    saved_default = st._default_store
    saved_openers = dict(dio._OPENERS)
    saved_writers = dict(dio._WRITERS)
    yield
    with st._default_lock:
        st._default_store = saved_default
    dio._OPENERS.clear()
    dio._OPENERS.update(saved_openers)
    dio._WRITERS.clear()
    dio._WRITERS.update(saved_writers)
    st.reset_store_counters()
    jst.reset_store_counters()


@pytest.fixture
def stub(tmp_path):
    root = tmp_path / "bucket"
    root.mkdir()
    srv = st.StubObjectStore(str(root)).start()
    yield srv, root
    srv.shutdown()
    srv.server_close()


def _put_local(root, name, data):
    p = root / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_bytes(data)
    return data


# -- fault-spec parsing ------------------------------------------------------------


def test_parse_fault_spec():
    rates = st.parse_fault_spec(GATE_RATES)
    assert rates == {"timeout": 0.1, "http500": 0.05, "truncate": 0.02, "torn_write": 0.02}
    assert rates == jst.parse_fault_spec(GATE_RATES)
    with pytest.raises(ValueError, match="kind one of"):
        st.parse_fault_spec("meteor:0.5")
    with pytest.raises(ValueError, match="rate"):
        st.parse_fault_spec("timeout:1.5")
    with pytest.raises(ValueError, match="fault spec"):
        st.parse_fault_spec("timeout")


@pytest.mark.parametrize("spec", ["meteor:0.5", "timeout:1.5", "timeout", "http500:x",
                                  "truncate:-0.1"])
def test_parse_fault_spec_refusals_equal_reference(spec):
    with pytest.raises(ValueError) as got:
        st.parse_fault_spec(spec)
    with pytest.raises(ValueError) as want:
        jst.parse_fault_spec(spec)
    assert str(got.value) == str(want.value)


def _faulty_trace(mod, seed):
    """200 requests (GET, PUT and HEAD) through ``mod``'s FaultyStore at
    the gate's rates over a recording inner transport, as per-call
    outcomes."""
    sent = []

    def inner(method, url, headers, body, timeout):
        sent.append((method, len(body or b""), headers.get("Content-Length")))
        return 200, {"content-length": "64"}, b"x" * 64

    fs = mod.FaultyStore(inner, mod.parse_fault_spec(GATE_RATES), seed=seed)
    out = []
    for i in range(200):
        method = ("GET", "PUT", "HEAD")[i % 3]
        try:
            status, _, data = fs(method, "http://h/k", {}, b"p" * 100 if method == "PUT"
                                 else None, 1.0)
            out.append((status, len(data)))
        except OSError as e:
            out.append(type(e).__name__)
    return out, sent, dict(fs.injected)


@pytest.mark.parametrize("seed", [0, 42, 1234])
def test_faulty_store_decisions_equal_reference(seed):
    """Under one seed the port's FaultyStore draws the reference's
    decisions: the same timeouts, 500s, truncated GETs and torn PUTs, call
    for call, and the same bytes reach the inner transport."""
    got = _faulty_trace(st, seed)
    assert got == _faulty_trace(jst, seed)
    assert got[2]["timeout"] and got[2]["http500"]


# -- block cache ----------------------------------------------------------------------


def test_block_cache_roundtrip_and_corrupt_entry(tmp_path):
    cache = st.BlockCache(str(tmp_path / "bc"))
    key = st.BlockCache.key("http://x/a", "id1", 0, 4)
    assert key == jst.BlockCache.key("http://x/a", "id1", 0, 4)
    assert cache.get(key) is None
    cache.put(key, b"data")
    assert cache.get(key) == b"data"
    # flip payload bytes on disk: the sha256 line no longer matches, so a
    # miss, and the poisoned entry is deleted (not returned, not kept)
    path = cache._path(key)
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:-2] + b"!!")
    assert cache.get(key) is None
    assert not os.path.exists(path)
    assert st.store_counters()["cache_corrupt"] == 1


def test_block_cache_identity_pin_refuses_foreign_dir(tmp_path):
    d = tmp_path / "bc"
    st.BlockCache(str(d))
    with open(d / "meta.json", "w") as fh:
        json.dump({"kind": "something-else", "version": 9}, fh)
    with pytest.raises(st.StoreMismatch) as ei:
        st.BlockCache(str(d))
    # the CascadeMismatch field-diff shape: "key: artifact=X run=Y" lines
    assert "kind" in str(ei.value) and "something-else" in str(ei.value)


def test_block_cache_shared_with_reference_layout(tmp_path):
    """The port's cache directory is the reference's layout: each reads
    the other's entries and its identity pin."""
    d = str(tmp_path / "bc")
    key = st.BlockCache.key("http://x/a", "id", 0, 5)
    other = jst.BlockCache.key("http://x/a", "id", 5, 5)
    st.BlockCache(d).put(key, b"hello")
    assert jst.BlockCache(d).get(key) == b"hello"
    jst.BlockCache(d).put(other, b"world")
    assert st.BlockCache(d).get(other) == b"world"


def test_store_mismatch_field_diff_equals_reference():
    diff = {"version": (9, 1), "kind": ("something-else", "roko-store-block-cache")}
    got = st.StoreMismatch("block cache", "/c", diff)
    want = jst.StoreMismatch("block cache", "/c", diff)
    assert str(got) == str(want) and got.diff == want.diff
    assert str(st.StoreMismatch("x", "/y", {})) == str(jst.StoreMismatch("x", "/y", {}))


def test_block_cache_lru_eviction(tmp_path):
    cache = st.BlockCache(str(tmp_path / "bc"), max_bytes=3000)
    keys = [st.BlockCache.key("http://x/a", "id", i * 1000, 1000) for i in range(4)]
    for i, k in enumerate(keys):
        cache.put(k, bytes([i]) * 1000)
        time.sleep(0.01)  # mtime-ordered LRU needs distinct stamps
    entries, total = cache.stats()
    assert total <= 3000
    assert cache.get(keys[0]) is None  # oldest evicted
    assert cache.get(keys[-1]) == bytes([3]) * 1000


# -- scripted fault matrix --------------------------------------------------------------


def test_transient_5xx_retried_to_success(stub):
    srv, root = stub
    data = _put_local(root, "a.bin", os.urandom(20000))
    store = st.ObjectStore(timeout_s=5.0, retry=_fast_retry())
    srv.fail_next(2, status=500)
    assert store.get_object(srv.url + "/a.bin") == data
    c = st.store_counters()
    assert c["retries"] == 2 and c["request_failures"] == 2


def test_retry_after_is_a_delay_floor(stub):
    srv, root = stub
    _put_local(root, "a.bin", b"x" * 100)
    store = st.ObjectStore(timeout_s=5.0, retry=_fast_retry())
    srv.fail_next(1, status=503, retry_after=0.5)
    t0 = time.monotonic()
    store.get_object(srv.url + "/a.bin")
    assert time.monotonic() - t0 >= 0.45


def test_truncated_ranged_body_retried(stub):
    srv, root = stub
    data = _put_local(root, "a.bin", os.urandom(30000))
    store = st.ObjectStore(timeout_s=5.0, retry=_fast_retry())
    srv.truncate_next(1)
    assert store._ranged_get(srv.url + "/a.bin", 0, 30000) == data
    assert st.store_counters()["retries"] >= 1


def test_checksum_mismatch_on_whole_get_retried(stub):
    srv, root = stub
    data = _put_local(root, "a.bin", os.urandom(30000))
    store = st.ObjectStore(timeout_s=5.0, retry=_fast_retry())
    srv.truncate_next(1)  # headers (the advertised sha too) stay intact
    assert store.get_object(srv.url + "/a.bin") == data
    assert st.store_counters()["retries"] >= 1


def test_persistent_failure_refuses_loudly(stub):
    srv, root = stub
    _put_local(root, "a.bin", b"x")
    store = st.ObjectStore(timeout_s=5.0, retry=_fast_retry(attempts=3))
    srv.fail_next(10, status=500)
    with pytest.raises(st.StoreHTTPError):
        store.get_object(srv.url + "/a.bin")
    assert st.store_counters()["retries"] == 2  # 3 attempts in all


def test_missing_object_is_not_retried(stub):
    srv, root = stub
    store = st.ObjectStore(timeout_s=5.0, retry=_fast_retry())
    with pytest.raises(st.StoreHTTPError) as ei:
        store.get_object(srv.url + "/nope.bin")
    assert ei.value.status == 404
    assert st.store_counters()["retries"] == 0  # 4xx gives up


def test_breaker_opens_and_recovers(stub):
    srv, root = stub
    data = _put_local(root, "a.bin", b"y" * 50)
    store = st.ObjectStore(timeout_s=2.0, retry=_fast_retry(attempts=1), breaker_failures=2,
                           breaker_reset_s=0.3)
    url = srv.url + "/a.bin"
    srv.fail_next(2, status=500)
    for _ in range(2):
        with pytest.raises(st.StoreHTTPError):
            store.get_object(url)
    with pytest.raises(st.BreakerOpen) as ei:
        store.get_object(url)
    assert ei.value.retry_after > 0
    assert st.store_counters()["breaker_open"] >= 1
    time.sleep(0.35)  # the cool-down: the half-open probe succeeds, it closes
    assert store.get_object(url) == data
    assert store.get_object(url) == data


def test_breaker_open_recovery_within_retry_budget(stub):
    """BreakerOpen is retryable with the cool-down as the Retry-After
    floor: one get_object arriving while the breaker is open recovers by
    itself once the endpoint heals."""
    srv, root = stub
    data = _put_local(root, "a.bin", b"z" * 50)
    store = st.ObjectStore(
        timeout_s=2.0,
        retry=st.RetryPolicy(max_attempts=4, base_delay_s=0.01, max_delay_s=0.2,
                             retryable=(st.StoreError, OSError)),
        breaker_failures=1, breaker_reset_s=0.2)
    srv.fail_next(1, status=500)
    assert store.get_object(srv.url + "/a.bin") == data
    assert st.store_counters()["breaker_open"] >= 1


def test_hedged_read_beats_straggler(stub):
    srv, root = stub
    data = _put_local(root, "a.bin", os.urandom(10000))
    store = st.ObjectStore(timeout_s=10.0, hedge_s=0.15)
    srv.delay_next(3.0, 1)
    t0 = time.monotonic()
    assert store.get_object(srv.url + "/a.bin") == data
    assert time.monotonic() - t0 < 1.5
    c = st.store_counters()
    assert c["hedges"] == 1 and c["hedge_wins"] == 1


def test_hedged_read_fast_failing_primary_raises_promptly(stub):
    """A primary that fails BEFORE hedge_s elapses raises at once: there
    is no second leg to wait for."""
    srv, root = stub
    store = st.ObjectStore(timeout_s=5.0, hedge_s=5.0)
    t0 = time.monotonic()
    with pytest.raises(st.StoreHTTPError):
        store.get_object(srv.url + "/missing.bin")  # 404: no retries
    assert time.monotonic() - t0 < 2.0


def test_hedged_failed_leg_waits_for_winning_leg():
    """When BOTH legs exist, a failed leg defers to the other's success
    (``_hedged`` driven directly for a fixed order)."""
    store = st.ObjectStore(hedge_s=0.05)
    lock, calls = threading.Lock(), [0]

    def fn():
        with lock:
            calls[0] += 1
            me = calls[0]
        if me == 1:
            time.sleep(0.15)  # past hedge_s, so the hedge leg started
            raise st.StoreError("primary fails after the hedge started")
        time.sleep(0.2)  # the hedge succeeds AFTER the primary's error
        return b"ok"

    assert store._hedged("http://x/a", fn) == b"ok"
    assert st.store_counters()["hedge_wins"] == 1


def test_stub_truncate_applies_to_ranged_body(stub):
    """The scripted truncate fault reaches a ranged GET whose span lies in
    the first half of the object."""
    srv, root = stub
    data = _put_local(root, "a.bin", os.urandom(30000))
    store = st.ObjectStore(timeout_s=5.0, retry=_fast_retry())
    srv.truncate_next(1)
    assert store._ranged_get(srv.url + "/a.bin", 0, 10000) == data[:10000]
    assert st.store_counters()["retries"] >= 1


def test_localize_refuses_unknown_size(stub, tmp_path):
    """A HEAD without Content-Length refuses; no empty file is committed
    as verified."""
    srv, root = stub
    _put_local(root, "a.bin", b"payload")
    store = st.ObjectStore(timeout_s=5.0, cache_dir=str(tmp_path / "c"))
    store.stat = lambda url: (-1, "size=-1")
    with pytest.raises(st.StoreError, match="did not report"):
        store.localize(srv.url + "/a.bin")


def test_torn_write_never_becomes_the_object(stub):
    """FaultyStore's torn_write halves the PUT body while the checksum
    header stays: the stub refuses it, the client PUTs again, and a
    reader only ever sees the whole object or none."""
    srv, root = stub
    payload = os.urandom(40000)
    store = st.ObjectStore(timeout_s=5.0, retry=_fast_retry())
    store.transport = st.FaultyStore(store.transport, {"torn_write": 1.0}, seed=1)
    with pytest.raises(st.StoreError):
        store.put_object(srv.url + "/t.bin", payload)
    assert not (root / "t.bin").exists()
    flaky = st.ObjectStore(timeout_s=5.0, retry=_fast_retry())
    calls = {"n": 0}
    real = flaky.transport

    def tear_first(method, url, headers, body, timeout):
        if method == "PUT" and calls["n"] == 0:
            calls["n"] += 1
            body = body[: len(body) // 2]
        return real(method, url, headers, body, timeout)

    flaky.transport = tear_first
    flaky.put_object(srv.url + "/t.bin", payload)
    assert (root / "t.bin").read_bytes() == payload
    assert st.store_counters()["put_retries"] >= 1


def _schedule(mod, url, scripts, srv, root):
    """One client of ``mod`` through a list of scripted stub faults:
    per operation its result or error type, and the retry events (op,
    attempt, delay, error type) with the jitter seeded alike."""
    logs = []
    store = mod.ObjectStore(timeout_s=5.0, retry=_fast_retry(mod=mod), breaker_failures=3,
                            breaker_reset_s=0.05, log=logs.append)
    out = []
    for k, (script, op) in enumerate(scripts):
        with srv.faults_lock:
            srv.faults.clear()  # what an op's failures left unconsumed
        script(srv)
        random.seed(k)
        try:
            got = op(store, url)
            out.append(hashlib.sha256(got).hexdigest() if isinstance(got, bytes) else got)
        except mod.StoreError as e:
            out.append(type(e).__name__)
        time.sleep(0.06)
    events = [tuple(w for w in line.split() if w.split("=")[0] in
                    ("event", "op", "attempt", "delay_s")) for line in logs]
    return out, events, mod.store_counters()


def test_retry_schedule_equals_reference(stub):
    """The same scripted stub faults (5xx runs, a Retry-After floor, a
    truncated body, a torn upload, a persistent failure, a 404) against
    the port's and the reference's clients: the same results, retry
    events with the same delays, and the same counters."""
    srv, root = stub
    _put_local(root, "a.bin", os.urandom(9000))
    scripts = [
        (lambda s: s.fail_next(2, status=500), lambda c, u: c.get_object(u)),
        (lambda s: s.fail_next(1, status=503, retry_after=0.1), lambda c, u: c.stat(u)),
        (lambda s: s.truncate_next(1), lambda c, u: c._ranged_get(u, 100, 5000)),
        (lambda s: s.fail_next(1, status=500), lambda c, u: c.put_object(u + ".w", b"q" * 999)),
        (lambda s: s.fail_next(6, status=500), lambda c, u: c.get_object(u)),
        (lambda s: None, lambda c, u: c.get_object(u + ".missing")),
        (lambda s: s.fail_next(1, status=429), lambda c, u: c.get_object(u)),
    ]
    got = _schedule(st, srv.url + "/a.bin", scripts, srv, root)
    want = _schedule(jst, srv.url + "/a.bin", scripts, srv, root)
    assert got == want
    assert got[2]["retries"] >= 6 and "StoreHTTPError" in got[0]


def test_stub_server_replies_equal_reference(tmp_path):
    """The port's StubObjectStore answers HEAD, ranged GET and checksummed
    PUT as the reference's: the same statuses, headers and bodies."""
    replies = []
    for mod in (st, jst):
        root = tmp_path / mod.__name__
        _put_local(root, "a.bin", bytes(range(256)) * 10)
        srv = mod.StubObjectStore(str(root)).start()
        host, port = srv.server_address[:2]
        got = []
        try:
            for method, path, headers, body in (
                    ("HEAD", "/a.bin", {}, None), ("GET", "/a.bin", {"Range": "bytes=5-99"}, None),
                    ("GET", "/nope", {}, None), ("PUT", "/b.bin",
                                                 {st.CHECKSUM_HEADER: "0" * 64}, b"xyz"),
                    ("PUT", "/c.bin", {st.CHECKSUM_HEADER: hashlib.sha256(b"xyz").hexdigest()},
                     b"xyz"), ("GET", "/c.bin", {}, None), ("GET", "/../etc", {}, None)):
                conn = http.client.HTTPConnection(host, port, timeout=10)
                conn.request(method, path, body=body, headers=headers)
                r = conn.getresponse()
                got.append((r.status, sorted((k, v) for k, v in r.getheaders()
                                             if k not in ("Server", "Date")), r.read()))
                conn.close()
        finally:
            srv.shutdown()
            srv.server_close()
        replies.append(got)
    assert replies[0] == replies[1]
    assert [r[0] for r in replies[0]] == [200, 206, 404, 422, 200, 200, 404]


# -- reader and writer seams --------------------------------------------------------------


def test_open_input_unknown_scheme_lists_registered(stub):
    st.install(st.ObjectStore(timeout_s=5.0))
    with pytest.raises(ValueError) as ei:
        dio.open_input("warp://bucket/key")
    msg = str(ei.value)
    assert "warp" in msg and "currently registered schemes" in msg
    assert "http" in msg  # the installed store schemes are named
    with pytest.raises(ValueError, match="currently registered schemes"):
        dio.open_output("warp://bucket/key")


def test_store_schemes_install_the_client_on_first_use(stub, monkeypatch):
    """With no handler registered, a store URL installs the default client
    (built from ``ROKO_STORE_*``) on first use."""
    srv, root = stub
    _put_local(root, "bkt/k.txt", b"first use")
    for scheme in st.STORE_SCHEMES:
        dio.register_opener(scheme, None)
        dio.register_writer(scheme, None)
    with st._default_lock:
        st._default_store = None
    monkeypatch.setenv("ROKO_STORE_ENDPOINT", srv.url)
    with dio.open_input("s3://bkt/k.txt") as fh:
        assert fh.read() == b"first use"
    assert set(st.STORE_SCHEMES) <= set(dio.registered_schemes()["output"])


def test_gs_scheme_requires_endpoint(monkeypatch):
    monkeypatch.delenv("ROKO_STORE_ENDPOINT", raising=False)
    store = st.ObjectStore(timeout_s=5.0)
    with pytest.raises(st.StoreError, match="ROKO_STORE_ENDPOINT"):
        store.stat("gs://bucket/key")


def test_gs_resolves_through_endpoint(stub):
    srv, root = stub
    data = _put_local(root, "bkt/key.bin", os.urandom(500))
    store = st.ObjectStore(timeout_s=5.0, endpoint=srv.url)
    assert store.get_object("gs://bkt/key.bin") == data
    assert store.get_object("s3://bkt/key.bin") == data


def test_store_file_seek_read_and_h5(stub, tmp_path):
    h5py = pytest.importorskip("h5py")
    import numpy as np

    srv, root = stub
    data = _put_local(root, "a.bin", os.urandom(100000))
    store = st.ObjectStore(timeout_s=5.0, cache_dir=str(tmp_path / "bc"), block_bytes=16384)
    st.install(store)
    fh = dio.open_input(srv.url + "/a.bin")
    assert fh.seek(0, os.SEEK_END) == len(data)
    fh.seek(12345)
    assert fh.read(100) == data[12345:12445]
    fh.seek(-10, os.SEEK_END)
    assert fh.read() == data[-10:]
    fh.close()
    # h5py over ranged HTTP reads through the same handle
    local = tmp_path / "c.h5"
    with h5py.File(local, "w") as f:
        f.create_dataset("x", data=np.arange(1000))
    _put_local(root, "c.h5", local.read_bytes())
    with dio.open_h5(srv.url + "/c.h5") as f:
        np.testing.assert_array_equal(f["x"][:], np.arange(1000))
    assert st.store_counters()["cache_hits"] > 0


def test_fasta_roundtrip_and_abort_through_store(stub):
    from roko_tpu_torch.io.fasta import iter_fasta, write_fasta

    srv, root = stub
    st.install(st.ObjectStore(timeout_s=5.0, retry=_fast_retry()))
    url = srv.url + "/polished.fasta"
    write_fasta(url, [("ctg1", "ACGT" * 200), ("ctg2", "TTGG" * 50)])
    assert list(iter_fasta(url)) == [("ctg1", "ACGT" * 200), ("ctg2", "TTGG" * 50)]

    def boom():
        yield ("ctg1", "ACGT")
        raise RuntimeError("producer died")

    with pytest.raises(RuntimeError, match="producer died"):
        write_fasta(srv.url + "/torn.fasta", boom())
    assert not (root / "torn.fasta").exists()  # aborted, never uploaded


def test_localize_bam_fetches_bai_sidecar(stub, tmp_path):
    from roko_tpu_torch.io.bam import write_sorted_bam
    from roko_tpu_torch.sim import cigar_from_string, make_record

    srv, root = stub
    recs = [make_record("r%d" % i, 0, i * 10, "A" * 50, cigar_from_string("50M"))
            for i in range(5)]
    bam = str(root / "reads.bam")
    write_sorted_bam(bam, [("ctg1", 2000)], recs)
    assert os.path.exists(bam + ".bai")
    store = st.ObjectStore(timeout_s=5.0, cache_dir=str(tmp_path / "scratch"))
    st.install(store)
    local = dio.ensure_local(srv.url + "/reads.bam")
    assert open(local, "rb").read() == open(bam, "rb").read()
    assert os.path.exists(local + ".bai")  # the sidecar rode along
    # a second localize of an unchanged object: revalidated, same path
    assert dio.ensure_local(srv.url + "/reads.bam") == local


def test_localize_revalidates_identity(stub, tmp_path):
    srv, root = stub
    _put_local(root, "a.bin", b"version-one")
    store = st.ObjectStore(timeout_s=5.0, cache_dir=str(tmp_path / "s"))
    p1 = store.localize(srv.url + "/a.bin")
    assert open(p1, "rb").read() == b"version-one"
    _put_local(root, "a.bin", b"version-TWO!")
    p2 = store.localize(srv.url + "/a.bin")
    assert open(p2, "rb").read() == b"version-TWO!"


# -- probabilistic fault convergence (the storage gate's rates) ---------------------------


def test_faulty_store_default_rates_converge(stub, tmp_path):
    """Every reader path under the gate's rates: 30 operations in a row
    all return the right bytes (the budget absorbs the faults), seed
    fixed."""
    srv, root = stub
    data = _put_local(root, "a.bin", os.urandom(60000))
    store = st.ObjectStore(timeout_s=3.0, cache_dir=str(tmp_path / "bc"), block_bytes=8192,
                           retry=_fast_retry(attempts=6))
    store.transport = st.FaultyStore(store.transport, st.parse_fault_spec(GATE_RATES),
                                     seed=1234)
    st.install(store)
    url = srv.url + "/a.bin"
    for _ in range(10):
        assert store.get_object(url) == data
    with dio.open_input(url) as fh:
        fh.seek(30000)
        assert fh.read(8192) == data[30000:38192]
    for i in range(5):
        payload = os.urandom(5000)
        store.put_object(srv.url + f"/w{i}.bin", payload)
        assert (root / f"w{i}.bin").read_bytes() == payload
    assert store.transport.injected  # the wrapper really fired
    assert st.store_counters()["faults_injected"] > 0


# -- the manifest, the journal and /metrics over the store --------------------------------


def test_manifest_builds_and_reloads_over_store(stub, tmp_path):
    h5py = pytest.importorskip("h5py")
    import numpy as np

    from roko_tpu_torch.datapipe.manifest import load_or_build_manifest

    srv, root = stub
    local = tmp_path / "corpus.h5"
    with h5py.File(local, "w") as f:
        g = f.create_group("contig_1_0")
        g.create_dataset("examples", data=np.zeros((40, 3, 4), np.uint8))
        g.create_dataset("labels", data=np.zeros((40, 4), np.int64))
    _put_local(root, "corpus.h5", local.read_bytes())
    st.install(st.ObjectStore(timeout_s=5.0, retry=_fast_retry()))
    url = srv.url + "/corpus.h5"
    man, paths = load_or_build_manifest(url)
    assert man.total_rows == 40 and paths == [url]
    assert (root / "corpus.h5.manifest.json").exists()  # the sidecar uploaded
    man2, _ = load_or_build_manifest(url)  # a reload verifies, no rebuild
    assert man2.fingerprint == man.fingerprint


def test_journal_of_a_store_output_keys_local_scratch_and_mirrors(stub, tmp_path, monkeypatch):
    """A store-scheme output's journal lives in the port's own scratch
    root keyed by the URL (never the JAX package's), and each committed
    span payload mirrors next to the output in the store; a mirror that
    fails never fails the commit."""
    import numpy as np

    from roko_tpu.resilience.journal import _journal_dir as ref_dir
    from roko_tpu_torch.resilience.journal import PolishJournal, _journal_dir

    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    srv, root = stub
    st.install(st.ObjectStore(timeout_s=5.0, retry=_fast_retry(attempts=1)))
    out = srv.url + "/polished.fasta"
    j = PolishJournal(out)
    assert j.dir == _journal_dir(out) == os.path.join(
        str(tmp_path / "home"), ".cache", "roko_tpu_torch", "journal",
        hashlib.sha256(out.encode()).hexdigest()[:16] + ".resume")
    assert os.path.basename(j.dir) == os.path.basename(ref_dir(out)) and j.dir != ref_dir(out)
    assert _journal_dir("/x/o.fa") == "/x/o.fa.resume" == _journal_dir("file:///x/o.fa")
    j.open({"k": 1}, resume=False)
    j.commit_unit("c:0", 3, positions=np.arange(4), preds=np.ones(4))
    mirrored = list((root / "polished.fasta.resume").iterdir())
    assert len(mirrored) == 1 and mirrored[0].read_bytes() == open(
        os.path.join(j.dir, mirrored[0].name), "rb").read()
    srv.fail_next(5, status=500)
    j.commit_unit("c:1", 2, positions=np.arange(3), preds=np.ones(3))
    assert j.load_units()["c:1"]["state"] == "committed"
    j.close()


def test_store_metrics_lines_in_serve_render(stub):
    srv, root = stub
    _put_local(root, "a.bin", b"q" * 10)
    store = st.ObjectStore(timeout_s=5.0, retry=_fast_retry())
    srv.fail_next(1, status=500)
    store.get_object(srv.url + "/a.bin")
    text = "\n".join(st.store_metrics_lines())
    assert "roko_store_requests_total" in text
    assert "roko_store_retries_total 1" in text

    from roko_tpu_torch.serve.metrics import ServeMetrics

    rendered = ServeMetrics().render()
    assert "roko_store_requests_total" in rendered
    assert "roko_store_retries_total 1" in rendered
    jst._counters.update(st.store_counters())
    assert st.store_metrics_lines() == jst.store_metrics_lines()


def test_store_events_reach_event_log(stub, tmp_path):
    from roko_tpu_torch.obs.events import configure_event_log

    srv, root = stub
    _put_local(root, "a.bin", b"e" * 10)
    evlog = str(tmp_path / "events.jsonl")
    configure_event_log(evlog, 4.0)
    try:
        store = st.ObjectStore(timeout_s=5.0, retry=_fast_retry())
        srv.fail_next(1, status=500)
        store.get_object(srv.url + "/a.bin")
    finally:
        configure_event_log(None, 0)
    recs = [json.loads(line) for line in open(evlog)]
    retries = [r for r in recs if r.get("event") == "store_retry"]
    assert retries and retries[0]["subsystem"] == "store"
    assert retries[0]["url"].endswith("/a.bin")


def test_stub_server_main_serves_a_directory(tmp_path):
    """``python -m roko_tpu_torch.datapipe.store --root DIR --port-file F``
    serves the directory until it is stopped."""
    _put_local(tmp_path / "root", "x.bin", b"standalone")
    port_file = tmp_path / "port"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, "-m", "roko_tpu_torch.datapipe.store", "--root",
                             str(tmp_path / "root"), "--port-file", str(port_file)],
                            cwd=str(ROOT), env=env, stdout=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while not port_file.exists() or not port_file.read_text():
            assert time.monotonic() < deadline and proc.poll() is None
            time.sleep(0.05)
        store = st.ObjectStore(timeout_s=5.0)
        assert store.get_object(f"http://127.0.0.1:{port_file.read_text()}/x.bin") == \
            b"standalone"
    finally:
        proc.terminate()
        proc.wait(30)


# -- a real CPU polish over the store, under faults ----------------------------------------


from tests.test_torch_distpolish import project  # noqa: E402,F401  (module fixture)


def test_store_fed_polish_under_faults_byte_identical(project, tmp_path):
    """``python -m roko_tpu_torch polish s3://bkt/draft.fasta
    s3://bkt/reads.bam MODEL s3://bkt/polished.fasta --store-endpoint URL
    --device cpu`` with ``ROKO_STORE_FAULTS`` at the storage gate's rates
    (seed 42): rc 0, the FASTA read back from the bucket byte-identical to
    ``roko-tpu polish`` on the same inputs and weights, the injected
    faults absorbed by logged retries, and no torn object left."""
    from roko_tpu_torch.config import RokoConfig, StoreConfig

    bucket = tmp_path / "bucket" / "bkt"
    bucket.mkdir(parents=True)
    for name, src in (("draft.fasta", project["fasta"]), ("reads.bam", project["bam"]),
                      ("reads.bam.bai", project["bam"] + ".bai")):
        (bucket / name).write_bytes(open(src, "rb").read())
    srv = st.StubObjectStore(str(tmp_path / "bucket")).start()
    cfg = project["cfg"]
    cfg_json = tmp_path / "cfg.json"
    cfg_json.write_text(RokoConfig(model=cfg.model, region=cfg.region, serve=cfg.serve,
                                   store=StoreConfig(block_bytes=4096)).to_json())
    evlog = str(tmp_path / "events.jsonl")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(ROKO_STORE_FAULTS=GATE_RATES, ROKO_STORE_FAULT_SEED="42",
               ROKO_STORE_TIMEOUT_S="10", ROKO_COMPILE_CACHE="off", HOME=str(tmp_path / "home"))
    try:
        res = subprocess.run(
            [sys.executable, "-m", "roko_tpu_torch", "polish", "s3://bkt/draft.fasta",
             "s3://bkt/reads.bam", project["pth"], "s3://bkt/polished.fasta", "--config",
             str(cfg_json), "--store-endpoint", srv.url, "--store-cache",
             str(tmp_path / "cache"), "--b", "8", "--event-log", evlog, "--device", "cpu"],
            cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=300)
    finally:
        srv.shutdown()
        srv.server_close()
    assert res.returncode == 0, (res.stdout + res.stderr)[-4000:]
    assert (bucket / "polished.fasta").read_bytes() == project["reference"]
    assert sorted(p.name for p in bucket.iterdir()) == ["draft.fasta", "polished.fasta",
                                                        "reads.bam", "reads.bam.bai"]
    events = [json.loads(line) for line in open(evlog)]
    store_events = {e["event"] for e in events if e.get("subsystem") == "store"}
    assert "store_retry" in store_events, store_events
