"""The port's cascade (``roko_tpu_torch/cascade/``, ``--cascade``) against
the JAX package's (``roko_tpu/cascade/``) on the CPU: the cases of
``tests/test_cascade.py``, each held to the reference's numbers where it
has them.

Calibration, ``majority_logits``, ``window_key`` and ``escalate_mask``
equal the reference's bit for bit; the majority tier's escalation sets
equal the reference router's; the window cache's LRU, its on-disk sidecar
(identity refusal, torn entries, a SIGKILL mid-write) and the router's
threshold endpoints; threshold 0's FASTA through ``run_inference``, the
streaming polish and the CLI byte-identical to the plain path's and to
``roko_tpu``'s; the ``model`` tier's logits against the reference model's
at the f32 bar (rtol 1e-4, atol 1e-5) with the escalation sets equal
outside the band where the two confidences straddle the keep floor; the
digest refusals, a reference-written cache and calibration among them; a
kernel bundle without the tier model's library refused at start; the
config round trip and the CLI's flag layering. ``TINY_GRU`` widths;
weights through ``models/convert.py``."""

import dataclasses
import hashlib
import os
import random
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from roko_tpu import cascade as ref_cascade
from roko_tpu.cascade import calibration as ref_cal
from roko_tpu.cascade import router as ref_router
from roko_tpu.config import CascadeConfig as JCascade
from roko_tpu.config import MeshConfig as JMesh
from roko_tpu.config import RegionConfig as JRegion
from roko_tpu.config import RokoConfig as JRoko
from roko_tpu.data.hdf5 import DataWriter
from roko_tpu.infer import run_inference as ref_run_inference
from roko_tpu.io.bam import write_sorted_bam
from roko_tpu.models import RokoModel as JModel
from roko_tpu.pipeline import run_streaming_polish as ref_streaming_polish
from roko_tpu_torch import cli
from roko_tpu_torch import constants as C
from roko_tpu_torch.cascade import (
    Calibration,
    CascadeFuture,
    CascadeMismatch,
    CascadeRouter,
    DiskWindowCache,
    WindowCache,
    build_router,
    cache_identity,
    confidence_scores,
    escalate_mask,
    fit_calibration,
    fit_temperature,
    params_digest,
    window_key,
)
from roko_tpu_torch.cascade.calibration import nll, window_confidence
from roko_tpu_torch.cascade.router import check_tier_kernels, majority_logits
from roko_tpu_torch.config import CascadeConfig, ModelConfig, RegionConfig, RokoConfig
from roko_tpu_torch.data.hdf5 import iter_inference_windows, load_contigs
from roko_tpu_torch.infer import run_inference
from roko_tpu_torch.io.fasta import write_fasta
from roko_tpu_torch.models.convert import state_dict_from_jax
from roko_tpu_torch.models.model import RokoModel
from roko_tpu_torch.pipeline import run_streaming_polish
from tests.helpers import random_seq, simulate_reads
from tests.test_lingru import TINY_GRU, TINY_LIN
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
WIDTHS = {f: getattr(TINY_GRU, f) for f in ("embed_dim", "read_mlp", "hidden_size", "num_layers")}
MODEL = ModelConfig(**WIDTHS)
REGION = dict(size=1200, overlap=100)
#: where the model tier's two confidences may fall on either side of the
#: keep floor: logits agree to the f32 bar, so confidences to about this
BAND = 1e-4


def quiet(*_a, **_k):
    pass


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, JModel(TINY_GRU).init(jax.random.PRNGKey(3)))


@pytest.fixture(scope="module")
def port_model(params):
    model = RokoModel(MODEL)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


def _synthetic_logits(rng, n=400, classes=5, scale=4.0):
    """Overconfident logits (the reference test's): the correct class
    boosted, label noise, then inflated by ``scale``."""
    labels = rng.integers(0, classes, n)
    logits = rng.normal(0, 1, (n, classes))
    logits[np.arange(n), labels] += 1.5
    flip = rng.random(n) < 0.25
    labels[flip] = rng.integers(0, classes, int(flip.sum()))
    return logits * scale, labels


# -- calibration: the reference's numbers bit for bit -------------------------


def test_fit_temperature_improves_nll(rng):
    logits, labels = _synthetic_logits(rng)
    t = fit_temperature(logits, labels)
    assert t > 1.0
    assert nll(logits, labels, t) < nll(logits, labels, 1.0)
    assert t == ref_cal.fit_temperature(logits, labels)
    assert nll(logits, labels, t) == ref_cal.nll(logits, labels, t)


def test_fit_calibration_carries_receipts(rng):
    logits, labels = _synthetic_logits(rng)
    cal = fit_calibration(logits, labels, method="margin", params_digest="d1")
    assert cal.method == "margin" and cal.fitted_on == len(labels)
    assert cal.nll_after < cal.nll_before
    ref = ref_cal.fit_calibration(logits, labels, method="margin", params_digest="d1")
    assert cal.to_json() == ref.to_json()


def test_margin_and_max_softmax_rank_agreement(rng):
    gaps = np.linspace(0.5, 6.0, 20)
    logits = np.zeros((20, 1, 5))
    logits[:, 0, 0] = gaps
    ms = window_confidence(logits, "max_softmax")
    mg = window_confidence(logits, "margin")
    assert (np.argsort(ms) == np.argsort(mg)).all()
    assert (np.diff(ms) > 0).all() and (np.diff(mg) > 0).all()
    noisy = rng.normal(0, 3, (30, 7, 5))
    for method in ("max_softmax", "margin"):
        for t in (1.0, 2.5):
            np.testing.assert_array_equal(
                window_confidence(noisy, method, t),
                ref_cal.window_confidence(noisy, method, t))


def test_escalate_mask_pinned_endpoints(rng):
    conf = np.array([0.0, 0.3, 0.999, 1.0])
    assert escalate_mask(conf, 0.0).all()
    assert not escalate_mask(conf, 1.0)[1:].any()
    with pytest.raises(ValueError):
        escalate_mask(conf, 1.5)
    conf = rng.random(200)
    for t in (0.0, 0.05, 0.5, 1.0):
        np.testing.assert_array_equal(escalate_mask(conf, t), ref_cal.escalate_mask(conf, t))


def test_window_confidence_is_min_over_columns(rng):
    logits = np.zeros((1, 3, 5))
    logits[0, 0, 0] = 10.0
    logits[0, 1, 0] = 10.0
    logits[0, 2, 0] = 0.1
    assert window_confidence(logits)[0] == pytest.approx(confidence_scores(logits)[0, 2])
    noisy = rng.normal(0, 2, (10, 9, 5))
    np.testing.assert_array_equal(confidence_scores(noisy, "margin", 1.7),
                                  ref_cal.confidence_scores(noisy, "margin", 1.7))


def test_calibration_roundtrip_and_digest_refusal(tmp_path):
    cal = Calibration(temperature=1.7, method="margin", params_digest="abc")
    path = cal.save(str(tmp_path / "cal.json"))
    assert Calibration.load(path, expect_params_digest="abc") == cal
    with pytest.raises(CascadeMismatch) as e:
        Calibration.load(path, expect_params_digest="def")
    assert e.value.diff == {"params_digest": ("abc", "def")}
    # the two packages read each other's artifact field for field
    ref_path = ref_cal.Calibration(temperature=2.5, method="margin",
                                   params_digest="x").save(str(tmp_path / "ref.json"))
    assert Calibration.load(ref_path).to_json() == ref_cal.Calibration.load(ref_path).to_json()


# -- the window cache -----------------------------------------------------------


def _ident(**over):
    base = dict(params_digest="p" * 64, quantize=None, tier="majority", threshold=0.9,
                method="max_softmax", temperature=1.0)
    base.update(over)
    return cache_identity(**base)


def test_lru_byte_cap_eviction():
    row = np.zeros(90, np.int32)
    cost = 64 + row.nbytes + 128
    cache = WindowCache(max_bytes=3 * cost)
    keys = [f"{i:02x}" * 32 for i in range(5)]
    for k in keys:
        cache.put(k, row)
        assert cache.bytes <= cache.max_bytes
    s = cache.stats()
    assert s["entries"] == 3 and s["evictions"] == 2
    assert cache.get(keys[0]) is None and cache.get(keys[1]) is None
    assert cache.get(keys[4]) is not None
    cache.put("big" * 22, np.zeros(10**6, np.int32))
    assert cache.stats()["entries"] == 3


def test_cache_key_disjoint_across_identity():
    w = bytes(range(200)) * 90
    base = window_key(w, _ident())
    for over in (dict(params_digest="q" * 64), dict(quantize="int8"), dict(threshold=0.5),
                 dict(tier="model", tier_version="v1"), dict(temperature=2.0)):
        assert window_key(w, _ident(**over)) != base
        # the key is the reference's, for the same identity
        assert window_key(w, _ident(**over)) == ref_cascade.window_key(
            w, ref_cascade.cache_identity(**{**dict(
                params_digest="p" * 64, quantize=None, tier="majority", threshold=0.9,
                method="max_softmax", temperature=1.0), **over}))
    assert window_key(w, _ident()) == base


def test_disk_sidecar_identity_refusal(tmp_path):
    root = str(tmp_path / "side")
    DiskWindowCache(root, _ident())
    DiskWindowCache(root, _ident())
    with pytest.raises(CascadeMismatch) as e:
        DiskWindowCache(root, _ident(params_digest="q" * 64, quantize="int8"))
    assert set(e.value.diff) == {"params_digest", "quantize"}
    assert "wrong bases" in str(e.value)


def test_disk_sidecar_roundtrip_and_torn_entry(tmp_path):
    root = str(tmp_path / "side")
    d = DiskWindowCache(root, _ident())
    k = window_key(b"w" * 100, d.identity)
    row = np.arange(90, dtype=np.int32)
    d.put(k, row)
    assert (d.get(k) == row).all()
    k2 = window_key(b"x" * 100, d.identity)
    path = os.path.join(root, k2[:2], k2 + ".npy")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x93NUMPY\x01\x00 torn")
    assert d.get(k2) is None


#: child of the SIGKILL test: writes ever larger entries to the shared
#: cache until it is killed; prints READY once the cache is open
_KILL_CHILD = """
import sys, numpy as np
sys.path.insert(0, {repo!r})
from roko_tpu_torch.cascade.cache import DiskWindowCache, cache_identity, window_key
ident = cache_identity(params_digest="p"*64, quantize=None, tier="majority",
                       threshold=0.9, method="max_softmax", temperature=1.0)
d = DiskWindowCache({root!r}, ident)
print("READY", flush=True)
i = 0
while True:
    d.put(window_key(i.to_bytes(4, "big"), ident), np.full(200_000, i, np.int32))
    i += 1
"""


def test_sigkill_mid_write_leaves_no_torn_or_stale_entries(tmp_path):
    root = str(tmp_path / "shared")
    proc = subprocess.Popen([sys.executable, "-c", _KILL_CHILD.format(repo=str(ROOT), root=root)],
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "READY"
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            done = sum(1 for s in os.listdir(root) if len(s) == 2
                       for name in os.listdir(os.path.join(root, s)) if name.endswith(".npy"))
            if done >= 3:
                break
            time.sleep(0.02)
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        proc.wait()
    d = DiskWindowCache(root, _ident())
    n_valid = 0
    for sub in os.listdir(root):
        p = os.path.join(root, sub)
        if len(sub) != 2 or not os.path.isdir(p):
            continue
        for name in os.listdir(p):
            if not name.endswith(".npy"):
                assert ".npy.tmp." in name, f"unexpected file: {name}"
                continue
            arr = np.load(os.path.join(p, name), allow_pickle=False)
            assert arr.shape == (200_000,) and (arr == arr[0]).all()
            n_valid += 1
    assert n_valid >= 3
    got = d.get(window_key((0).to_bytes(4, "big"), d.identity))
    assert got is None or (got == 0).all()
    with pytest.raises(CascadeMismatch):
        DiskWindowCache(root, _ident(params_digest="q" * 64))


# -- the router -------------------------------------------------------------------


def _windows(rng, n=6, rows=16, cols=9):
    return rng.integers(0, C.FEATURE_VOCAB, (n, rows, cols)).astype(np.uint8)


class _CountingTier2:
    def __init__(self):
        self.windows = 0

    def __call__(self, x):
        self.windows += len(x)
        return np.zeros((len(x), x.shape[2]), np.int32)


def test_router_threshold_endpoints(rng):
    x = _windows(rng)
    for threshold, want in ((0.0, len(x)), (1.0, 0)):
        tier2 = _CountingTier2()
        r = CascadeRouter(threshold=threshold, params_digest="p" * 64, cache_bytes=0)
        r.route(x, tier2)
        assert tier2.windows == want and r.stats()["escalated"] == want


def test_router_threshold0_scatters_tier2_verbatim(rng):
    x = _windows(rng)
    want = rng.integers(0, C.NUM_CLASSES, (len(x), x.shape[2])).astype(np.int32)
    r = CascadeRouter(threshold=0.0, params_digest="p" * 64, cache_bytes=0)
    assert (r.route(x, lambda xs: want[: len(xs)]) == want).all()


def test_router_cache_hits_on_repeat_batch(rng):
    x = _windows(rng)
    tier2 = _CountingTier2()
    r = CascadeRouter(threshold=1.0, params_digest="p" * 64, cache_bytes=2**20)
    r.route(x, tier2)
    r.route(x, tier2)
    s = r.stats()
    assert s["cache_hits"] == len(x) and s["cache_hit_rate"] == pytest.approx(0.5)
    assert tier2.windows == 0


def test_router_escalated_results_are_cached_too(rng):
    x = _windows(rng)
    tier2 = _CountingTier2()
    r = CascadeRouter(threshold=0.0, params_digest="p" * 64, cache_bytes=2**20)
    r.route(x, tier2)
    r.route(x, tier2)
    assert tier2.windows == len(x) and r.stats()["cache_hits"] == len(x)


def test_router_check_identity_refuses_drift():
    r = CascadeRouter(threshold=0.5, params_digest="p" * 64, quantize="int8")
    r.check_identity(params_digest="p" * 64, quantize="int8")
    with pytest.raises(CascadeMismatch) as e:
        r.check_identity(params_digest="q" * 64)
    assert "params_digest" in e.value.diff


def test_with_threshold_clone_shares_calibration_not_cache(rng):
    r = CascadeRouter(threshold=0.9, params_digest="p" * 64, cache_bytes=2**20)
    clone = r.with_threshold(0.5)
    assert clone.threshold == 0.5 and clone.calibration is r.calibration
    assert clone.cache is not r.cache and clone.identity != r.identity
    assert r.with_threshold(0.5) is clone
    w = _windows(rng, 1)[0].tobytes()
    assert window_key(w, r.identity) != window_key(w, clone.identity)


def test_cascade_future_matches_predict_future_interface():
    class _Inner:
        def done(self):
            return True

        def result(self, timeout=None):
            return np.ones((2, 4), np.int32)

    preds = np.zeros((3, 4), np.int32)
    out = CascadeFuture(preds, np.array([0, 2]), _Inner()).result(1.0)
    assert (out[[0, 2]] == 1).all() and (out[1] == 0).all()
    fut2 = CascadeFuture(preds, np.empty(0, np.int64), None)
    assert fut2.done() and fut2.result(0.0) is preds


def test_majority_logits_counts_folded_votes(rng):
    x = np.zeros((1, 4, 2), np.uint8)
    x[0, :, 0] = [0, 0, 6, 1]
    x[0, :, 1] = [3, 3, 3, 3]
    logits = majority_logits(x)
    assert logits.shape == (1, 2, C.NUM_CLASSES)
    assert logits[0, 0, 0] == 3.0 and logits[0, 0, 1] == 1.0 and logits[0, 1, 3] == 4.0
    # full-size windows: the reference's counts, and the reference
    # router's escalation set at every threshold
    x = _windows(rng, 40, 200, 90)
    np.testing.assert_array_equal(majority_logits(x), ref_router.majority_logits(x))
    for t in (0.0, 0.02, 0.05, 0.3, 1.0):
        ours = CascadeRouter(threshold=t, params_digest="p" * 64, cache_bytes=0,
                             calibration=Calibration(temperature=8.0))
        theirs = ref_cascade.CascadeRouter(threshold=t, params_digest="p" * 64, cache_bytes=0,
                                           calibration=ref_cal.Calibration(temperature=8.0))
        a, b = ours._decide(x), theirs._decide(x)
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(np.delete(a[0], a[1], 0), np.delete(b[0], b[1], 0))


# -- run_inference, the streaming polish and the CLI: threshold 0 -------------


def _write_corpus(rng, path, n=7):
    draft = "".join(rng.choice(list("ACGT"), 500))
    X = rng.integers(0, C.FEATURE_VOCAB, (n, 200, 90)).astype(np.uint8)
    positions = [np.stack([np.arange(i * C.WINDOW_STRIDE, i * C.WINDOW_STRIDE + 90),
                           np.zeros(90, np.int64)], axis=1) for i in range(n)]
    with DataWriter(str(path), infer=True) as w:
        w.write_contigs([("ctg", draft)])
        w.store("ctg", positions, list(X), None)


def _sha(d):
    h = hashlib.sha256()
    for name in sorted(d):
        h.update(name.encode() + b"\0" + d[name].encode() + b"\0")
    return h.hexdigest()


def _port_infer(path, model, cfg, stats=None):
    return run_inference(iter_inference_windows(str(path), 8), load_contigs(str(path)), model,
                         device="cpu", log=quiet, cfg=cfg, cascade_stats=stats)


def test_run_inference_threshold0_byte_identity(rng, tmp_path, params, port_model):
    path = tmp_path / "infer.hdf5"
    _write_corpus(rng, path)
    cfg = RokoConfig(model=MODEL)
    plain = _port_infer(path, port_model, cfg)
    stats = {}
    cascaded = _port_infer(path, port_model, dataclasses.replace(
        cfg, cascade=CascadeConfig(enabled=True, threshold=0.0)), stats)
    assert cascaded == plain and _sha(cascaded) == _sha(plain)
    assert stats["escalation_fraction"] == 1.0
    jcfg = JRoko(model=TINY_GRU, mesh=JMesh(dp=8),
                 cascade=JCascade(enabled=True, threshold=0.0))
    ref = ref_run_inference(str(path), params, jcfg, batch_size=8, log=quiet)
    assert _sha(ref) == _sha(cascaded)


def test_run_inference_cascade_threshold1_never_escalates(rng, tmp_path, port_model):
    path = tmp_path / "infer.hdf5"
    _write_corpus(rng, path)
    stats = {}
    out = _port_infer(path, port_model, RokoConfig(
        model=MODEL, cascade=CascadeConfig(enabled=True, threshold=1.0)), stats)
    assert set(out) == {"ctg"}
    assert stats["escalated"] == 0 and stats["windows"] > 0


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """One two-region contig with reads over it (the sim of
    ``tests/test_torch_stream.py``)."""
    root = tmp_path_factory.mktemp("torch_cascade")
    rng = random.Random(11)
    draft = random_seq(rng, 2000)
    fasta, bam = str(root / "draft.fasta"), str(root / "reads.bam")
    write_fasta(fasta, [("ctg", draft)])
    write_sorted_bam(bam, [("ctg", len(draft))], simulate_reads(rng, draft, 0, coverage=8,
                                                                 read_len=300))
    return fasta, bam


def test_streaming_polish_threshold0_byte_identity(project, tmp_path, params, port_model):
    fasta, bam = project
    cfg = RokoConfig(model=MODEL, region=RegionConfig(**REGION))
    outs = {}
    for name, c in (("plain", cfg), ("zero", dataclasses.replace(
            cfg, cascade=CascadeConfig(enabled=True, threshold=0.0)))):
        outs[name] = tmp_path / f"{name}.fasta"
        run_streaming_polish(fasta, bam, port_model, c, out_path=str(outs[name]), seed=2,
                             batch_size=16, device="cpu", log=quiet)
    ref = tmp_path / "ref.fasta"
    ref_streaming_polish(fasta, bam, params, JRoko(model=TINY_GRU, region=JRegion(**REGION)),
                         out_path=str(ref), seed=2, batch_size=16, log=quiet)
    got = outs["zero"].read_bytes()
    assert got == outs["plain"].read_bytes() == ref.read_bytes() and len(got) > 1000


def test_cli_threshold0_identity(rng, tmp_path, port_model):
    """``inference --cascade 0`` writes the plain ``inference``'s bytes
    (the reference's slow lane's live identity gate, without its
    training run)."""
    path = tmp_path / "infer.hdf5"
    _write_corpus(rng, path, n=9)
    pth, cfg_json = tmp_path / "model.pth", tmp_path / "cfg.json"
    torch.save(port_model.state_dict(), pth)
    cfg_json.write_text(RokoConfig(model=MODEL).to_json())
    outs = {}
    for name, extra in (("plain", []), ("casc", ["--cascade", "0"])):
        outs[name] = tmp_path / f"{name}.fasta"
        assert cli.main(["inference", str(path), str(pth), str(outs[name]), "--device", "cpu",
                         "--b", "8", "--config", str(cfg_json), *extra]) == 0
    assert outs["casc"].read_bytes() == outs["plain"].read_bytes()


# -- build_router: calibration, digests, the model tier -------------------------


def test_build_router_loads_calibration_and_refuses_drift(tmp_path, params, port_model):
    digest = params_digest(port_model)
    good = str(tmp_path / "cal.json")
    Calibration(temperature=2.0, params_digest=digest).save(good)
    cfg = RokoConfig(model=MODEL, cascade=CascadeConfig(enabled=True, calibration_path=good))
    assert build_router(cfg, params=port_model, device="cpu").calibration.temperature == 2.0
    # the digest is the state_dict's on the host: the module's, its
    # state_dict's and a CPU copy's are one
    assert params_digest(port_model.state_dict()) == digest
    bad = str(tmp_path / "bad.json")
    Calibration(temperature=2.0, params_digest="not-this-model").save(bad)
    with pytest.raises(CascadeMismatch):
        build_router(dataclasses.replace(cfg, cascade=dataclasses.replace(
            cfg.cascade, calibration_path=bad)), params=port_model, device="cpu")
    # a calibration and a cache that roko_tpu wrote for the SAME weights
    # are refused, naming params_digest: the two digests never agree
    ref_digest = ref_cascade.params_digest(params)
    assert ref_digest != digest
    jpath = ref_cal.Calibration(temperature=2.0, params_digest=ref_digest).save(
        str(tmp_path / "jax_cal.json"))
    with pytest.raises(CascadeMismatch) as e:
        build_router(dataclasses.replace(cfg, cascade=dataclasses.replace(
            cfg.cascade, calibration_path=jpath)), params=port_model, device="cpu")
    assert set(e.value.diff) == {"params_digest"}
    side = str(tmp_path / "jax_cache")
    ref_cascade.build_router(JRoko(model=TINY_GRU, cascade=JCascade(
        enabled=True, cache_dir=side)), params=params)
    with pytest.raises(CascadeMismatch) as e:
        build_router(dataclasses.replace(cfg, cascade=CascadeConfig(
            enabled=True, cache_dir=side)), params=port_model, device="cpu")
    assert "params_digest" in e.value.diff
    # int8 weights digest differently from their float source
    q = RokoModel(dataclasses.replace(MODEL, quantize="int8"))
    q.load_state_dict(port_model.state_dict(), strict=True)
    from roko_tpu_torch.models.quant import maybe_quantize

    assert params_digest(maybe_quantize(q)) != digest


@pytest.fixture(scope="module")
def tier_registry(tmp_path_factory):
    """A registered lingru version at ``TINY_LIN`` widths (a port bundle on
    the CPU, no library), with the JAX params its weights came from."""
    from roko_tpu_torch.compile.bundle import export_bundle
    from roko_tpu_torch.serve.registry import register_model

    root = tmp_path_factory.mktemp("tier_registry")
    jparams = jax.tree.map(np.asarray, JModel(TINY_LIN).init(jax.random.PRNGKey(9)))
    lin = ModelConfig(kind="lingru", **WIDTHS)
    model = RokoModel(lin)
    model.load_state_dict(state_dict_from_jax(jparams), strict=True)
    ckpt = root / "lin.pth"
    torch.save(model.state_dict(), ckpt)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        export_bundle(str(root / "bundle"), RokoConfig(model=lin), ladder=(8,), device="cpu",
                      log=quiet)
    finally:
        torch.set_num_threads(n)
    register_model(str(root / "reg"), "lin1", str(root / "bundle"), str(ckpt), log=quiet)
    return str(root / "reg"), jparams


def test_model_tier_logits_and_escalation_band(rng, tier_registry, port_model):
    reg, jparams = tier_registry
    cfg = RokoConfig(model=MODEL, cascade=CascadeConfig(
        enabled=True, tier="model", tier_version="lin1", cache_bytes=0))
    base = build_router(cfg, params=port_model, registry_dir=reg, device="cpu")
    x = _windows(rng, 24, 200, 90)
    ours = base._tier_logits(x)
    theirs = np.asarray(JModel(TINY_LIN).apply(jparams, x, deterministic=True), np.float32)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-5)
    conf_p = base.calibration.confidence(ours)
    conf_r = ref_cal.Calibration().confidence(theirs)
    # random weights are unsure of every window: a keep floor at the
    # median confidence splits them
    for threshold in (0.05, 1.0 - float(np.median(conf_r))):
        router = base.with_threshold(threshold)
        floor = 1.0 - threshold
        near = (np.abs(conf_p - floor) <= BAND) | (np.abs(conf_r - floor) <= BAND)
        esc_p = escalate_mask(conf_p, threshold)
        esc_r = ref_cal.escalate_mask(conf_r, threshold)
        # the windows within the band are counted, not held; the rest
        # escalate in both packages alike
        assert (esc_p[~near] == esc_r[~near]).all() and int(near.sum()) < len(x) // 2
        # routed: kept windows take the tier model's argmax, the rest tier 2's
        tier2 = _CountingTier2()
        got = router.route(x, tier2)
        assert tier2.windows == int(esc_p.sum())
        np.testing.assert_array_equal(got[~esc_p], ours[~esc_p].argmax(-1))
    assert 0 < esc_p.sum() < len(x)


def test_bundle_without_tier_library_refused_at_start(tmp_path):
    """On a card, a ``--bundle`` that lacks the tier model's kernel library
    is refused when the router is built, naming the library (nothing is
    built, nothing runs on the card to find out)."""
    import json

    from roko_tpu_torch.compile.bundle import BUNDLE_MANIFEST

    bundle = tmp_path / "b"
    bundle.mkdir()
    (bundle / BUNDLE_MANIFEST).write_text(json.dumps(
        {"digest": "d", "identity": {}, "libraries": {"gru_fwd": {"file": "lib/x.so"}}}))
    lin = ModelConfig(kind="lingru", **WIDTHS)
    with pytest.raises(RuntimeError, match=r"\['lingru_fwd'\]"):
        check_tier_kernels(lin, str(bundle), torch.device("cuda"))
    check_tier_kernels(MODEL, str(bundle), torch.device("cuda"))  # gru_fwd is there
    check_tier_kernels(lin, str(bundle), torch.device("cpu"))  # no library on the CPU


# -- serve override, config and CLI ----------------------------------------------


def test_polish_cascade_override_parsing():
    from roko_tpu_torch.serve.server import _BadRequest, _cascade_override

    r = CascadeRouter(threshold=0.9, params_digest="p" * 64, cache_bytes=0)
    assert _cascade_override({}, r) is r
    assert _cascade_override({"cascade": False}, r) is None
    got = _cascade_override({"cascade": {"threshold": 0.5}}, r)
    assert got.threshold == 0.5 and got is not r
    assert _cascade_override({"cascade": {"threshold": 0.9}}, r) is r
    for bad in ("yes", {"threshold": "x"}, {"threshold": 1.5}, {}):
        with pytest.raises(_BadRequest):
            _cascade_override({"cascade": bad}, r)
    with pytest.raises(_BadRequest, match="no cascade configured"):
        _cascade_override({"cascade": {"threshold": 0.5}}, None)


def test_cascade_config_validation_and_roundtrip():
    cfg = RokoConfig(cascade=CascadeConfig(enabled=True, threshold=0.7, method="margin"))
    assert RokoConfig.from_json(cfg.to_json()).cascade == cfg.cascade
    jcfg = JRoko(cascade=JCascade(enabled=True, threshold=0.7, method="margin",
                                  cache_dir="/c"))
    back = RokoConfig.from_json(jcfg.to_json())
    assert dataclasses.asdict(back.cascade) == dataclasses.asdict(jcfg.cascade)
    assert dataclasses.asdict(back.distpolish) == dataclasses.asdict(jcfg.distpolish)
    for bad in (dict(threshold=1.5), dict(tier="nope"), dict(tier="model"),
                dict(method="x"), dict(cache_bytes=-1)):
        with pytest.raises(ValueError):
            CascadeConfig(**bad)
        with pytest.raises(ValueError):
            JCascade(**bad)


def test_cli_cascade_flag_layering(tmp_path):
    from roko_tpu.cli import _build_config as ref_build
    from roko_tpu.cli import build_parser as ref_parser

    for argv in ([], ["--cascade"], ["--cascade", "0.5", "--cascade-method", "margin",
                                     "--cascade-cache-dir", str(tmp_path / "wc")],
                 ["--cascade", "0", "--cascade-tier", "model", "--cascade-version", "v1",
                  "--cascade-cache-bytes", "0", "--cascade-calibration", "c.json"]):
        for cmd in (["polish", "d.fa", "r.bam", "m.ckpt", "o.fa"],
                    ["inference", "x.hdf5", "m", "o.fa"], ["serve", "m"]):
            got = cli._build_config(cli.build_parser().parse_args(cmd + argv)).cascade
            want = ref_build(ref_parser().parse_args(cmd + argv)).cascade
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (cmd, argv)
    cfg = cli._build_config(cli.build_parser().parse_args(
        ["polish", "d.fa", "r.bam", "m", "o.fa", "--cascade"]))
    assert cfg.cascade.enabled and cfg.cascade.threshold == CascadeConfig().threshold


def test_server_with_cascade_replies_and_metrics_equal_reference(rng, params, port_model):
    """A server started with the cascade (majority tier at 0.05): each
    reply (the server's default, the plain path by ``"cascade": false``,
    and a threshold-0 override) equals the reference server's on the same
    weights and windows, threshold 0 equals the plain path, and
    ``/metrics`` carries the reference's cascade series with equal
    counters."""
    import threading

    from roko_tpu.config import ServeConfig as JServe
    from roko_tpu.parallel.mesh import make_mesh
    from roko_tpu.serve import server as ref_server
    from roko_tpu.serve.session import PolishSession as RefSession
    from roko_tpu_torch.config import ServeConfig
    from roko_tpu_torch.serve import server as port_server
    from roko_tpu_torch.serve.metrics import parse_metric_values
    from roko_tpu_torch.serve.session import PolishSession
    from tests.test_torch_serve import _raw

    casc = dict(enabled=True, threshold=0.05)
    port_cfg = RokoConfig(model=MODEL, serve=ServeConfig(ladder=(8,)),
                          cascade=CascadeConfig(**casc))
    ref_cfg = JRoko(model=TINY_GRU, mesh=JMesh(dp=1), serve=JServe(ladder=(8,)),
                    cascade=JCascade(**casc))
    session = PolishSession(port_model, port_cfg, device="cpu")
    session.warmup()
    ref_session = RefSession(params, ref_cfg, mesh=make_mesh(ref_cfg.mesh, jax.devices()[:1]))
    ref_session.warmup()
    n = 6
    x = _windows(rng, n, 200, 90)
    x[:2] = 1  # unanimous columns: confident, kept by tier 1
    positions = np.zeros((n, 90, 2), np.int64)
    for i in range(n):
        positions[i, :, 0] = np.arange(i * 30, i * 30 + 90)
    import base64

    draft = "".join(rng.choice(list("ACGT"), 300))
    payload = {"contig": "c", "draft": draft, "n": n,
               "positions": base64.b64encode(positions.astype("<i8").tobytes()).decode(),
               "examples": base64.b64encode(x.tobytes()).decode()}
    replies, texts = {}, {}
    for name, pkg, sess in (("port", port_server, session), ("ref", ref_server, ref_session)):
        srv = pkg.make_server(sess, None, port=0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            got = {}
            for what, extra in (("default", {}), ("plain", {"cascade": False}),
                                ("zero", {"cascade": {"threshold": 0.0}})):
                status, _, body = _raw(base, "/polish", dict(payload, **extra))
                assert status == 200, body
                got[what] = body["polished"]
            replies[name] = got
            texts[name] = _raw(base, "/metrics")[2]
        finally:
            srv.shutdown()
            srv.batcher.stop()
            srv.server_close()
            thread.join(5.0)
    assert replies["port"] == replies["ref"]
    assert replies["port"]["zero"] == replies["port"]["plain"]
    names = ["roko_serve_cascade_windows_total", "roko_serve_cascade_escalated_total",
             "roko_serve_cascade_cache_hits_total", "roko_serve_cascade_escalation_fraction",
             "roko_serve_cascade_cache_hit_rate"]
    got, want = parse_metric_values(texts["port"], names), parse_metric_values(texts["ref"], names)
    assert got == want and set(got) == set(names) and got[names[0]] == str(2 * n)
    assert "roko_cascade_tier_seconds_bucket" in texts["port"]
