"""The port's polishing service (``roko_tpu_torch/serve/server.py``,
``client.py`` and ``python -m roko_tpu_torch serve``) against the JAX
package's (``roko_tpu/serve``) on the CPU.

One module-scoped port session and one reference session hold the same
weights (``models/convert.py::state_dict_from_jax``) at ``TINY_GRU``
widths, each served by ``make_server(port=0)`` on a thread. The same
payloads go through both servers with the port's ``PolishClient``: the
``polished`` replies equal each other and the port's ``run_inference`` on
the same windows written to HDF5, under every batching policy; the ref +
bam form equals the reference server's; the status codes of bad
payloads, a full queue, a tenant quota, an open breaker, ``data_root``,
the cascade and work-unit forms, warming and draining equal the
reference's; ``/healthz`` has its keys and ``/metrics`` its series less
the listed ones. Then ``/tracez``, ``/profilez``, the CLI's usage errors
and config layering, and a ``serve`` subprocess drained by SIGTERM
during a request."""

import contextlib
import dataclasses
import http.client
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from roko_tpu.config import MeshConfig as JMesh
from roko_tpu.config import RokoConfig as JRoko
from roko_tpu.config import ServeConfig as JServe
from roko_tpu.config import TenantConfig as JTenant
from roko_tpu.models import RokoModel as JModel
from roko_tpu.parallel.mesh import make_mesh
from roko_tpu.serve import batcher as ref_batcher
from roko_tpu.serve import metrics as ref_metrics
from roko_tpu.serve import server as ref_server
from roko_tpu.serve.session import PolishSession as RefSession
from roko_tpu_torch import cli
from roko_tpu_torch import constants as C
from roko_tpu_torch.config import ModelConfig, RokoConfig, ServeConfig, TenantConfig
from roko_tpu_torch.data.hdf5 import DataWriter, iter_inference_windows, load_contigs
from roko_tpu_torch.infer import run_inference
from roko_tpu_torch.models.convert import state_dict_from_jax
from roko_tpu_torch.models.model import RokoModel
from roko_tpu_torch.serve import batcher as port_batcher
from roko_tpu_torch.serve import server as port_server
from roko_tpu_torch.serve.client import FleetDraining, PolishClient, ServerBusy
from roko_tpu_torch.serve.session import PolishSession
from tests.test_lingru import TINY_GRU
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
LADDER = (8, 16)
WIDTHS = {f: getattr(TINY_GRU, f) for f in ("embed_dim", "read_mlp", "hidden_size", "num_layers")}
MODEL = ModelConfig(**WIDTHS)
SERVE = dict(ladder=LADDER, max_delay_ms=20.0, max_queue=4, max_queue_age_ms=20.0)
# an explicit tenant table so both servers render the tenant rows
TENANTS = (("a", 2.0, 0, 0),)


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, JModel(TINY_GRU).init(jax.random.PRNGKey(3)))


@pytest.fixture(scope="module")
def port_session(params):
    model = RokoModel(MODEL)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    session = PolishSession(model, RokoConfig(model=MODEL, serve=ServeConfig(**SERVE)),
                            device="cpu")
    with _one_thread():
        session.warmup()
    return session


@pytest.fixture(scope="module")
def ref_session(params):
    cfg = JRoko(model=TINY_GRU, mesh=JMesh(dp=1), serve=JServe(**SERVE))
    session = RefSession(params, cfg, mesh=make_mesh(cfg.mesh, jax.devices()[:1]))
    session.warmup()
    return session


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _serve_cfg(port: bool, **over):
    tenants = tuple((TenantConfig if port else JTenant)(*t) for t in TENANTS)
    return (ServeConfig if port else JServe)(**{**SERVE, "tenants": tenants, **over})


class _Session:
    """A session seen through another config (the batchers read the
    tenant table from ``session.cfg.serve``), or with a device that fails
    every dispatch."""

    def __init__(self, session, serve=None, sick=False):
        self._s = session
        if serve is not None:
            self.cfg = dataclasses.replace(session.cfg, serve=serve)
        if sick:
            self.predict = self._fail

    def __getattr__(self, name):
        return getattr(self._s, name)

    @staticmethod
    def _fail(x):
        raise RuntimeError("injected device failure")


@contextlib.contextmanager
def serving(pkg, session, serve_cfg=None, **kw):
    """``make_server(port=0)`` of ``pkg`` (the port's or the reference's
    server module) on a thread; yields (server, client, base url)."""
    srv = pkg.make_server(session, serve_cfg, port=0, **kw)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        yield srv, PolishClient(base, timeout=60.0), base
    finally:
        srv.shutdown()
        srv.batcher.stop()
        srv.server_close()
        thread.join(5.0)


@contextlib.contextmanager
def both(port_session, ref_session, **over):
    with serving(port_server, port_session, _serve_cfg(True, **over)) as p, \
            serving(ref_server, ref_session, _serve_cfg(False, **over)) as r:
        yield p, r


def _windows(rng, n):
    x = rng.integers(0, C.FEATURE_VOCAB, (n, C.WINDOW_ROWS, C.WINDOW_COLS)).astype(np.uint8)
    positions = np.zeros((n, C.WINDOW_COLS, 2), np.int64)
    for i in range(n):
        positions[i, :, 0] = np.arange(i * C.WINDOW_STRIDE, i * C.WINDOW_STRIDE + C.WINDOW_COLS)
    return positions, x


def _raw(base, path, payload=None, headers=None, method=None):
    """(status, headers, parsed body) of one request, whatever its code."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, method=method or (
        "POST" if data is not None else "GET"), headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            status, hdrs, body = resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        status, hdrs, body = e.code, e.headers, e.read()
    try:
        parsed = json.loads(body)
    except ValueError:
        parsed = body.decode()
    return status, hdrs, parsed


# -- the windows form: byte-identical replies -------------------------------


@pytest.mark.parametrize("batching", ["deadline", "continuous", "ragged"])
def test_polish_equals_reference_and_run_inference(port_session, ref_session, tmp_path,
                                                   batching):
    """The same payloads through both servers: the ``polished`` bytes equal
    each other and the port's ``run_inference`` on the same windows
    written to HDF5, at 0, 3, 7 and 21 windows (above the top rung: two
    chunks or two steps)."""
    rng = np.random.default_rng(11)
    draft = "".join(rng.choice(list("ACGT"), 800))
    positions, x = _windows(rng, 21)
    with both(port_session, ref_session, batching=batching) as ((psrv, pc, _), (_, rc, _)):
        for n in (0, 3, 7, 21):
            path = str(tmp_path / f"w{n}.hdf5")
            with DataWriter(path, infer=True) as w:
                w.write_contigs([("ctg", draft)])
                if n:
                    w.store("ctg", list(positions[:n]), list(x[:n]), None)
            want = run_inference(iter_inference_windows(path, 8), load_contigs(path),
                                 port_session.model, device="cpu", log=lambda s: None)["ctg"]
            got = pc.polish(draft, positions[:n], x[:n], contig="ctg")
            ref = rc.polish(draft, positions[:n], x[:n], contig="ctg")
            assert got["polished"] == ref["polished"] == want, n
            assert got["windows"] == ref["windows"] == n
            assert set(got["timings"]) == set(ref["timings"])
        assert psrv.batcher.BATCHING_MODE == batching
        assert port_session.dispatched_shapes <= set(LADDER)


def test_polish_bam_equals_reference(port_session, ref_session, tmp_path):
    """The ref + bam form on a small simulated project: the port extracts
    in memory, the reference through an HDF5 file; the replies are equal."""
    from roko_tpu_torch.sim import build_synthetic_project

    paths = build_synthetic_project(str(tmp_path / "proj"), genome_len=3000, coverage=8)
    with both(port_session, ref_session) as ((_, pc, _), (_, rc, _)):
        got = pc.polish_bam(paths["draft_fasta"], paths["reads_bam"], workers=2, seed=4)
        want = rc.polish_bam(paths["draft_fasta"], paths["reads_bam"], workers=2, seed=4)
    assert got["contigs"] == want["contigs"] and got["windows"] == want["windows"] > 16


# -- status codes ------------------------------------------------------------


def _bad_payloads(rng):
    positions, x = _windows(rng, 1)
    good = {"draft": "".join(rng.choice(list("ACGT"), 200)), "n": 1,
            "positions": positions.tolist(), "examples": x.tolist()}
    neg = positions.copy()
    neg[0, 0, 0] = -1
    import base64

    return [
        ({"n": 1}, None),
        ({"draft": "ACGT", "n": 1, "positions": "!!", "examples": "!!"}, None),
        ({"draft": "ACGT", "n": 2, "positions": [[0, 0]], "examples": [1]}, None),
        ({"draft": "ACGT", "n": 1, "positions": base64.b64encode(b"1234567").decode(),
          "examples": base64.b64encode(b"x").decode()}, None),
        ({"draft": "ACGT", "n": 1, "positions": [[0, 0], [1]], "examples": []}, None),
        ({"draft": "ACGT", "n": -1}, None),
        (dict(good, draft="ACGT" * 10), None),  # positions past the draft
        (dict(good, positions=neg.tolist()), None),  # a negative position
        (good, {"X-Roko-Tenant": "bad tenant!"}),
        (good, {"X-Roko-Model": "v2"}),  # a pin on a process with no version
        (dict(good, cascade={"threshold": 0.1}), None),
        (dict(good, cascade="yes"), None),
        (dict(good, cascade=False), None),  # the plain path: 200
        ({"ref": "/nonexistent.fa", "bam": "/nonexistent.bam", "unit": "x"}, None),
        ([1, 2], None),
        (good, None),
    ]


def test_status_codes_equal_reference(port_session, ref_session):
    rng = np.random.default_rng(5)
    cases = _bad_payloads(rng)
    with both(port_session, ref_session) as ((_, _, pbase), (_, _, rbase)):
        for payload, headers in cases:
            got = _raw(pbase, "/polish", payload, headers)
            want = _raw(rbase, "/polish", payload, headers)
            assert got[0] == want[0], (payload, got[2], want[2])
        for path, method in (("/nope", "GET"), ("/nope", "POST"), ("/polish?x=1", "POST")):
            assert _raw(pbase, path, {} if method == "POST" else None)[0] == \
                _raw(rbase, path, {} if method == "POST" else None)[0] == 404
        for base in (pbase, rbase):
            host, port = base.split("//")[1].split(":")
            conn = http.client.HTTPConnection(host, int(port), timeout=10)
            conn.putrequest("POST", "/polish")
            conn.putheader("Content-Length", "-1")
            conn.endheaders()
            assert conn.getresponse().status == 400
            conn.close()
        # a cascade override on a server with no cascade, and a work unit
        # on paths that are not there, are refused with the reference's
        # messages
        for payload, says in ((cases[10][0], "no cascade configured"),
                              ({"ref": "r", "bam": "b", "unit": {}}, "readable data file")):
            got, want = _raw(pbase, "/polish", payload), _raw(rbase, "/polish", payload)
            assert got[0] == want[0] == 400 and got[2]["error"] == want[2]["error"]
            assert says in got[2]["error"]


def test_full_queue_is_503_with_retry_after(port_session, ref_session):
    """A deadline batcher that is not started holds its one queue slot:
    the next request is 503 + Retry-After in both, and the first one
    completes once the batcher starts."""
    rng = np.random.default_rng(0)
    positions, x = _windows(rng, 1)
    draft = "".join(rng.choice(list("ACGT"), 200))
    codes = []
    for pkg, session, batcher_mod, port in ((port_server, port_session, port_batcher, True),
                                            (ref_server, ref_session, ref_batcher, False)):
        batcher = batcher_mod.MicroBatcher(session, max_queue=1, start=False)
        with serving(pkg, session, _serve_cfg(port), batcher=batcher) as (_, client, base):
            first = {}
            t = threading.Thread(target=lambda: first.update(
                r=client.polish(draft, positions, x)), daemon=True)
            t.start()
            for _ in range(200):
                if batcher._q.qsize():
                    break
                time.sleep(0.02)
            status, hdrs, body = _raw(base, "/polish", {
                "draft": draft, "n": 1, "positions": positions.tolist(),
                "examples": x.tolist()})
            codes.append((status, hdrs.get("Retry-After"), body["retry_after_s"]))
            with pytest.raises(ServerBusy):
                client.polish(draft, positions, x, retries=0)
            batcher.start()
            t.join(30.0)
            assert first["r"]["windows"] == 1
    assert codes[0] == codes[1] == (503, "1", 1.0)


def test_tenant_quota_is_429(port_session, ref_session):
    """A tenant past its queued-window quota gets 429 with its name, in
    both; the default tenant is unaffected."""
    rng = np.random.default_rng(1)
    positions, x = _windows(rng, 6)
    draft = "".join(rng.choice(list("ACGT"), 300))
    payload = {"draft": draft, "n": 6, "positions": positions.tolist(), "examples": x.tolist()}
    got = []
    for pkg, session, port in ((port_server, port_session, True),
                               (ref_server, ref_session, False)):
        tenants = ((TenantConfig if port else JTenant)("small", 1.0, 4, 0),)
        serve = _serve_cfg(port, tenants=tenants)
        with serving(pkg, _Session(session, serve), serve) as (_, _, base):
            status, hdrs, body = _raw(base, "/polish", payload, {"X-Roko-Tenant": "small"})
            ok = _raw(base, "/polish", payload, {"X-Roko-Tenant": "other"})[0]
            got.append((status, body["tenant"], "Retry-After" in hdrs, ok))
    assert got[0] == got[1] == (429, "small", True, 200)


def test_open_breaker_sheds_and_healthz_is_unhealthy(port_session, ref_session):
    """Two device failures trip the breaker (500 each, the type only);
    then /polish is 503 with Retry-After and /healthz 503 "unhealthy", in
    both; the breaker's series render."""
    rng = np.random.default_rng(2)
    positions, x = _windows(rng, 2)
    payload = {"draft": "".join(rng.choice(list("ACGT"), 200)), "n": 2,
               "positions": positions.tolist(), "examples": x.tolist()}
    seqs = []
    for pkg, session, breaker_mod in (
            (port_server, port_session, port_server), (ref_server, ref_session, ref_server)):
        breaker = breaker_mod.CircuitBreaker(failure_threshold=2, reset_s=60.0)
        with serving(pkg, _Session(session, sick=True), _serve_cfg(pkg is port_server),
                     breaker=breaker) as (_, client, base):
            codes = [_raw(base, "/polish", payload)[0] for _ in range(3)]
            bodies = _raw(base, "/polish", payload)[2]
            health = _raw(base, "/healthz")
            text = client.metrics()
            seqs.append((codes, bodies["error"].split(";")[0], health[0],
                         health[2]["status"], health[2]["breaker"],
                         "roko_serve_breaker_state 2" in text,
                         "roko_serve_breaker_trips_total 1" in text))
    assert seqs[0] == seqs[1]
    assert seqs[0][0] == [500, 500, 503] and seqs[0][2:5] == (503, "unhealthy", "open")


def test_data_root_confines_extractor_paths(port_session, ref_session, tmp_path):
    outside = tmp_path / "outside.fasta"
    outside.write_text(">c\nACGT\n")
    root = tmp_path / "root"
    root.mkdir()
    for pkg, session, port in ((port_server, port_session, True),
                               (ref_server, ref_session, False)):
        with serving(pkg, session, _serve_cfg(port, data_root=str(root))) as (_, client, _):
            messages = set()
            for ref in (str(outside), str(root / "missing.fasta"), "/etc/passwd",
                        "gs://bucket/x.fa"):
                with pytest.raises(RuntimeError, match="HTTP 400") as exc:
                    client.polish_bam(ref, ref)
                messages.add(str(exc.value))
            assert len(messages) == 1


def test_warming_and_draining_are_503(port_session, ref_session):
    rng = np.random.default_rng(4)
    positions, x = _windows(rng, 1)
    payload = {"draft": "".join(rng.choice(list("ACGT"), 200)), "n": 1,
               "positions": positions.tolist(), "examples": x.tolist()}
    got = []
    for pkg, session, port in ((port_server, port_session, True),
                               (ref_server, ref_session, False)):
        with serving(pkg, session, _serve_cfg(port), warming=True) as (srv, _, base):
            warming = (_raw(base, "/healthz")[0], _raw(base, "/healthz")[2]["status"],
                       _raw(base, "/polish", payload)[0])
            srv._warming.clear()
            ready = _raw(base, "/polish", payload)[0]
            srv._draining.set()
            status, hdrs, body = _raw(base, "/polish", payload)
            draining = (status, body["error"], "Retry-After" in hdrs,
                        _raw(base, "/healthz")[2]["status"])
            with pytest.raises(FleetDraining):
                PolishClient(base).polish(payload["draft"], positions, x, retries=0)
            got.append((warming, ready, draining))
    assert got[0] == got[1]
    assert got[0][0] == (503, "warming", 503) and got[0][1] == 200


# -- observability -----------------------------------------------------------


def _series_names(text: str):
    names = set()
    for line in text.splitlines():
        if line and not line.startswith("#"):
            names.add(re.split(r"[{ ]", line, 1)[0])
    return names


def test_healthz_keys_and_metrics_series_equal_reference(port_session, ref_session):
    """After the same traffic (a tenant-tagged request and an untagged
    one): /healthz has the reference's keys, and /metrics the reference's
    series, the object-store client's ``roko_store_*`` counters among them,
    read with the reference's own parsers."""
    rng = np.random.default_rng(6)
    positions, x = _windows(rng, 5)
    draft = "".join(rng.choice(list("ACGT"), 300))
    with serving(port_server, _Session(port_session, _serve_cfg(True)), _serve_cfg(True)) as \
            (_, pc, _), serving(ref_server, _Session(ref_session, _serve_cfg(False)),
                                _serve_cfg(False)) as (_, rc, _):
        for c in (pc, rc):
            c.polish(draft, positions, x, tenant="a")
            c.polish(draft, positions[:2], x[:2])
        ph, rh = pc.healthz(), rc.healthz()
        ptext, rtext = pc.metrics(), rc.metrics()
    assert set(ph) == set(rh) and set(ph["tenants"]) == set(rh["tenants"])
    want = _series_names(rtext)
    assert _series_names(ptext) == want
    assert {n for n in want if n.startswith("roko_store_")}  # the store client's counters
    unlabeled = ref_metrics.parse_metric_values(ptext, want)
    for name in ("roko_serve_requests_total", "roko_serve_windows_total",
                 "roko_serve_cpu_fallback", "roko_serve_breaker_state"):
        assert unlabeled[name] == ref_metrics.parse_metric_values(rtext, want)[name], name
    assert ref_metrics.parse_labeled_rows(ptext, ref_metrics.LABELED_SERIES) == \
        ref_metrics.parse_labeled_rows(rtext, ref_metrics.LABELED_SERIES)


def test_launch_report_is_written_before_each_reply(port_session, tmp_path):
    """The serve process's launch report (``ROKO_KERNEL_LAUNCHES``):
    written at the warmup's end and, through ``on_polished``, before each
    answered ``/polish`` reply, so the file a SIGKILLed worker leaves counts
    every request it answered; a refused request writes nothing."""
    from roko_tpu_torch.serve.metrics import ServeMetrics

    metrics = ServeMetrics()
    report = cli._LaunchReport(str(tmp_path / "launches"), metrics)
    report.warm()

    def read():
        with open(report.path) as f:
            return json.load(f)

    assert report.path == str(tmp_path / f"launches.{os.getpid()}.json")
    assert read()["served"] == {"requests": 0, "windows": 0, "batches": 0}
    assert read()["warmup_launches"] == read()["launches"]
    seen = []

    def on_polished():
        report.write()
        seen.append(read()["served"])

    rng = np.random.default_rng(8)
    positions, x = _windows(rng, 4)
    draft = "".join(rng.choice(list("ACGT"), 300))
    with serving(port_server, port_session, _serve_cfg(True), metrics=metrics,
                 on_polished=on_polished) as (_, client, base):
        reply = client.polish(draft, positions, x)
        assert _raw(base, "/polish", {"draft": draft, "n": 2})[0] == 400
    assert reply["windows"] == 4 and len(seen) == 1
    assert seen[0]["windows"] == 4 and seen[0]["batches"] >= 1
    assert read()["served"] == seen[0] and read()["pid"] == os.getpid()
    assert set(read()["launches"]) == {"gru_fwd", "gru_fwd_bf16", "lingru_fwd",
                                       "lingru_fwd_bf16"}
    assert not os.path.exists(report.path + ".tmp")


def test_tracez_carries_request_ids_and_profilez_writes_a_trace(port_session):
    rng = np.random.default_rng(7)
    positions, x = _windows(rng, 3)
    draft = "".join(rng.choice(list("ACGT"), 200))
    with serving(port_server, port_session, _serve_cfg(True)) as (srv, client, base):
        ids = [client.polish(draft, positions, x, request_id=f"rid{i}")["request_id"]
               for i in range(2)]
        ids.append(client.polish(draft, positions, x)["request_id"])
        tz = client.tracez()
        assert [r["request_id"] for r in tz["last"]] == ids == ["rid0", "rid1", ids[2]]
        assert tz["scheduler"]["mode"] == "continuous" and tz["seen"] == 3
        assert {"queue_wait", "device", "stitch"} <= set(tz["last"][0]["spans"])
        result = {}
        t = threading.Thread(target=lambda: result.update(
            r=_raw(base, "/profilez?seconds=0.2", {})), daemon=True)
        t.start()
        time.sleep(0.05)
        busy = _raw(base, "/profilez?seconds=0.2", {})
        t.join(30.0)
        status, _, body = result["r"]
        assert status == 200 and busy[0] == 409
        files = os.listdir(body["trace_dir"])
        assert files and os.path.join(body["trace_dir"], files[0]) == body["trace_file"]
        with open(body["trace_file"]) as f:
            assert "traceEvents" in json.load(f)
        shutil.rmtree(body["trace_dir"])
        assert _raw(base, "/profilez?seconds=x", {})[0] == 400


def test_in_process_sigterm_drains_serve_forever(port_session):
    """SIGTERM to this process while ``serve_forever`` runs on the main
    thread: the handler drains and the loop returns."""
    srv = port_server.make_server(port_session, _serve_cfg(True), port=0)
    old = signal.getsignal(signal.SIGTERM)
    timer = threading.Timer(0.3, lambda: os.kill(os.getpid(), signal.SIGTERM))
    timer.start()
    msgs = []
    try:
        port_server.serve_forever(srv, log=msgs.append)
    finally:
        timer.cancel()
        signal.signal(signal.SIGTERM, old)
    assert any("draining" in m for m in msgs) and any("drained clean" in m for m in msgs)


# -- the command line --------------------------------------------------------


@pytest.mark.parametrize("argv,item", [
    (["--cascade", "1.5"], "cascade.threshold must lie in [0, 1]"),
    (["--cascade-tier", "model"], "cascade.tier='model' needs cascade.tier_version"),
])
def test_unported_serve_flags_are_usage_errors(argv, item, capsys, tmp_path):
    with pytest.raises(SystemExit) as e:
        cli.main(["serve", str(tmp_path / "m.pth"), "--device", "cpu", *argv])
    assert e.value.code == 2
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--host-id", "h7"], ["--federation"], ["--host-agent", "--join", "h:1", "--workers", "2"],
    ["--join", "127.0.0.1:9100", "--workers", "1"], ["--lease-ttl", "3"],
    ["--store-cache", "/c"], ["--store-endpoint", "http://127.0.0.1:9000"],
])
def test_federation_and_store_flags_layer_as_reference(argv):
    """The federation's and the store's serve flags are ported: each
    builds the reference's fleet and store sections (defaults < file <
    flags)."""
    from roko_tpu.cli import _build_config as ref_build
    from roko_tpu.cli import build_parser as ref_parser

    full = ["serve", "ckpt/", *argv]
    args = cli.build_parser().parse_args(full)
    got = json.loads(cli._build_config(args).to_json())
    want = json.loads(ref_build(ref_parser().parse_args(full)).to_json())
    assert got["fleet"] == want["fleet"] and got["store"] == want["store"]
    assert args.federation == ("--federation" in argv)


@pytest.mark.parametrize("argv,message", [
    (["m.pth", "--host-agent"], "--host-agent needs the front end as --join HOST:PORT"),
    (["m.pth", "--join", "h:1"], "a host agent supervises workers"),
    (["--port", "0"], "MODEL is required (only --federation runs model-less)"),
])
def test_federation_usage_errors_as_reference(argv, message, capsys):
    """The reference's usage errors of a host agent (no front to join, no
    workers to supervise) and of a serve with no MODEL, before anything
    starts."""
    with pytest.raises(SystemExit) as e:
        cli.main(["serve", *argv, "--device", "cpu"])
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_serve_flags_layer_into_config_as_reference():
    from roko_tpu.cli import _build_config as ref_build
    from roko_tpu.cli import build_parser as ref_parser

    argv = ["serve", "ckpt/", "--port", "0", "--ladder", "8,16", "--max-queue", "7",
            "--max-delay-ms", "5", "--batching", "ragged", "--max-queue-age-ms", "9",
            "--rung-upgrade-fill", "0.5", "--data-root", "/d", "--trace-ring", "3",
            "--tenants", "a:2:4:1,b", "--event-log", "/e.jsonl", "--breaker-failures", "2",
            "--breaker-reset-s", "3", "--drain-deadline", "4", "--predict-deadline", "5"]
    got = cli._build_config(cli.build_parser().parse_args(argv))
    want = ref_build(ref_parser().parse_args(argv))
    assert json.loads(got.to_json())["serve"] == json.loads(want.to_json())["serve"]
    port_res = json.loads(got.to_json())["resilience"]
    assert port_res == {k: v for k, v in json.loads(want.to_json())["resilience"].items()
                        if k in port_res}
    assert got.guard.event_log == "/e.jsonl"


def _model_pth(params, path):
    torch.save(state_dict_from_jax(params), path)
    return path


def test_serve_subprocess_drains_a_request_on_sigterm(params, tmp_path):
    """``python -m roko_tpu_torch serve`` with ``--announce``: /healthz
    leaves ``warming``; a request held by the deadline batcher's
    ``max_delay_ms`` is in flight when SIGTERM arrives, finishes with 200,
    a request sent during the drain gets 503, and the process exits 0."""
    pth = _model_pth(params, str(tmp_path / "m.pth"))
    announce = str(tmp_path / "announce.json")
    widths = ["--hidden-size", str(MODEL.hidden_size), "--num-layers", str(MODEL.num_layers)]
    cfg = tmp_path / "cfg.json"
    cfg.write_text(RokoConfig(model=MODEL).to_json())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "roko_tpu_torch", "serve", pth, "--device", "cpu", "--port",
         "0", "--announce", announce, "--ladder", "8,16", "--batching", "deadline",
         "--max-delay-ms", "1500", "--config", str(cfg), *widths],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        for _ in range(600):
            if os.path.exists(announce) or proc.poll() is not None:
                break
            time.sleep(0.05)
        assert proc.poll() is None, proc.stdout.read()
        base = f"http://127.0.0.1:{json.load(open(announce))['port']}"
        client = PolishClient(base)
        for _ in range(600):
            status, _, body = _raw(base, "/healthz")
            if status == 200:
                break
            assert body["status"] == "warming"
            time.sleep(0.05)
        assert body["status"] == "ok" and body["batching"] == "deadline"
        rng = np.random.default_rng(9)
        positions, x = _windows(rng, 4)
        draft = "".join(rng.choice(list("ACGT"), 300))
        result = {}
        t = threading.Thread(target=lambda: result.update(
            r=client.polish(draft, positions, x)), daemon=True)
        t.start()
        time.sleep(0.5)  # the request waits out the 1.5 s batching deadline
        proc.send_signal(signal.SIGTERM)
        for _ in range(100):
            status, _, body = _raw(base, "/healthz")
            if status == 503:
                break
            time.sleep(0.01)
        assert body["status"] == "draining"
        late = _raw(base, "/polish", {"draft": draft, "n": 0, "positions": [],
                                      "examples": []})
        assert late[0] == 503 and late[2]["error"] == "server draining"
        t.join(30.0)
        assert result["r"]["windows"] == 4 and len(result["r"]["polished"]) > 0
        assert proc.wait(30.0) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = proc.stdout.read()
    assert "accepting requests" in out and "drained clean" in out
