"""The port's distributed polish (``roko_tpu_torch/pipeline/distpolish.py``,
``polish --distributed``, ``POST /job``) against the JAX package's
(``roko_tpu/pipeline/distpolish.py``) on the CPU: the cases of
``tests/test_distpolish.py``, and the port's copy of the real 2-worker
fleet with a worker SIGKILLed mid-unit (``tests/test_fault_injection.py``).

The coordinator's state machine runs against a fake fleet and a fake
transport (no processes, no HTTP): unit splitting (the table and uids
equal to the reference's), the journal's unit ledger and its torn line,
death, poison, draining, a 503, a malformed reply, a degraded fleet, the
autoscaler's park, span merges, resume and its refusals, ``/jobz`` and
``POST /job``. Then an in-process job over the real worker-side unit
executor and a warm session, whose FASTA is the port's single-process
polish's and ``roko_tpu``'s byte for byte, and one real fleet of
``python -m roko_tpu_torch serve --device cpu`` workers. ``TINY_GRU``
widths; weights through ``models/convert.py``."""

import dataclasses
import json
import os
import random
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from roko_tpu.config import RegionConfig as JRegion
from roko_tpu.config import RokoConfig as JRoko
from roko_tpu.io.bam import write_sorted_bam
from roko_tpu.models import RokoModel as JModel
from roko_tpu.pipeline import distpolish as ref_dp
from roko_tpu.pipeline import run_streaming_polish as ref_streaming_polish
from roko_tpu_torch import constants as C
from roko_tpu_torch.config import (
    DistPolishConfig,
    FleetConfig,
    ModelConfig,
    RegionConfig,
    ResilienceConfig,
    RokoConfig,
    ServeConfig,
)
from roko_tpu_torch.features.pipeline import generate_regions
from roko_tpu_torch.io.fasta import read_fasta, write_fasta
from roko_tpu_torch.models.convert import state_dict_from_jax
from roko_tpu_torch.models.model import RokoModel
from roko_tpu_torch.pipeline.distpolish import (
    DistPolishJob,
    PoisonedUnit,
    _run_job_core,
    b64_array,
    checkpoint_fingerprint,
    distributed_meta,
    make_job_starter,
    split_units,
)
from roko_tpu_torch.resilience import JournalMismatch, PolishJournal
from tests.helpers import random_seq, simulate_reads
from tests.test_lingru import TINY_GRU
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
WIDTHS = {f: getattr(TINY_GRU, f) for f in ("embed_dim", "read_mlp", "hidden_size", "num_layers")}
TINY = ModelConfig(**WIDTHS)
REGION = RegionConfig(size=1200, overlap=100)
#: fast coordinator knobs: no multi-second parks in unit tests
FAST = DistPolishConfig(unit_bases=0, unit_attempts=2, park_poll_s=0.01, ready_timeout_s=5.0)


def _quiet(*_a, **_k):
    pass


class FakeWorker:
    def __init__(self, wid):
        self.id = wid
        self.state = "ready"
        self.port = 9000 + wid


class FakeFleet:
    """What ``DistPolishJob`` reads of a fleet (pick, ready_count,
    workers, _draining, jobs_parked), round robin with exclusions as the
    real ``Fleet``."""

    def __init__(self, n=2):
        self.workers = [FakeWorker(i) for i in range(n)]
        self._draining = False
        self.jobs_parked = False
        self._rr = 0
        self.job = None

    def ready_count(self):
        return sum(1 for w in self.workers if w.state == "ready")

    def pick(self, exclude=()):
        ready = [w for w in self.workers if w.state == "ready" and w.id not in exclude]
        if not ready:
            return None
        self._rr += 1
        w = ready[self._rr % len(ready)]
        return w, w.port


def _refs(*specs):
    rng = random.Random(3)
    return [(name, random_seq(rng, n)) for name, n in specs]


def _cfg(**dist_kw):
    return RokoConfig(model=TINY, region=REGION,
                      distpolish=dataclasses.replace(FAST, **dist_kw))


def _polished_reply(payload):
    contig = payload["unit"]["contig"]
    return 200, json.dumps({"contig": contig, "polished": f"POLISHED-{contig}",
                            "windows": 3}).encode()


def _job(fleet, cfg, refs, transport, journal=None, writer=None, committed=None):
    units = [u for u in split_units(refs, cfg.region, cfg.distpolish.unit_bases)
             if u.contig not in (committed or {})]
    return DistPolishJob(fleet, cfg, ref="draft.fa", bam="reads.bam", seed=0, refs=refs,
                         units=units, journal=journal, writer=writer, committed=committed,
                         transport=transport, log=_quiet)


# -- unit splitting: the reference's table ----------------------------------------


def _table(units):
    return [(u.uid, u.contig, u.first_region, u.n_regions, u.start, u.end, u.whole)
            for u in units]


def _ref_table(refs, unit_bases):
    return _table(ref_dp.split_units(refs, JRegion(size=1200, overlap=100), unit_bases))


def test_split_units_whole_contigs_by_default():
    refs = _refs(("zulu", 3000), ("alpha", 900), ("empty", 0))
    units = split_units(refs, REGION, 0)
    by = {u.contig: u for u in units}
    assert len(units) == 3
    assert by["zulu"].whole and by["zulu"].n_regions == 3
    assert by["alpha"].whole and by["alpha"].n_regions == 1
    assert by["empty"].n_regions == 0
    assert _table(units) == _ref_table(refs, 0)


def test_split_units_span_splits_on_region_table():
    refs = _refs(("giant", 3000), ("small", 900))
    units = split_units(refs, REGION, 1500)
    giant = [u for u in units if u.contig == "giant"]
    small = [u for u in units if u.contig == "small"]
    assert [(u.first_region, u.n_regions, u.start, u.end) for u in giant] == [
        (0, 1, 0, 1200), (1, 1, 1100, 2300), (2, 1, 2200, 3000)]
    assert not any(u.whole for u in giant)
    assert len(small) == 1 and small[0].whole
    regions = list(generate_regions(3000, "giant", REGION))
    covered = sorted(i for u in giant for i in range(u.first_region, u.first_region + u.n_regions))
    assert covered == list(range(len(regions)))
    for bases in (0, 1500, 2500, 5000):
        big = _refs(("g", 7777), ("s", 300), ("e", 0), ("m", 2401))
        assert _table(split_units(big, REGION, bases)) == _ref_table(big, bases)


def test_split_units_uid_stable_across_runs():
    refs = _refs(("g", 5000))
    a = [u.uid for u in split_units(refs, REGION, 1500)]
    assert a == [u.uid for u in split_units(refs, REGION, 1500)]
    assert a == [row[0] for row in _ref_table(refs, 1500)]


# -- the journal's unit ledger ------------------------------------------------------


def test_unit_ledger_roundtrip_and_torn_line(tmp_path):
    out = str(tmp_path / "out.fa")
    j = PolishJournal(out)
    j.open({"x": 1}, resume=False)
    j.unit_event("c@0+1", "attempt", attempts=1, worker=0)
    j.unit_event("c@0+1", "attempt", attempts=2, worker=1)
    j.commit_unit("c@0+1", 7)
    j.unit_event("d@0+2", "quarantine", durable=True, attempts=3, error="boom")
    j.close()
    with open(j.units_path, "a") as fh:
        fh.write('{"unit": "e@0+1", "ev')
    j2 = PolishJournal(out)
    j2.open({"x": 1}, resume=True)
    units = j2.load_units()
    j2.close()
    assert units["c@0+1"] == {"state": "committed", "windows": 7, "attempts": 2}
    assert units["d@0+2"]["state"] == "quarantined" and "e@0+1" not in units
    # the reference's journal reads the port's ledger to the same records
    from roko_tpu.resilience import PolishJournal as RefJournal

    assert RefJournal(out).load_units() == units


def test_unit_ledger_span_preds_roundtrip(tmp_path):
    out = str(tmp_path / "out.fa")
    j = PolishJournal(out)
    j.open({"x": 1}, resume=False)
    pos = np.arange(2 * 90 * 2, dtype=np.int64).reshape(2, 90, 2)
    preds = (np.arange(2 * 90, dtype=np.int32) % 5).reshape(2, 90)
    j.commit_unit("g@0+1", 2, positions=pos, preds=preds, worker=1)
    rec = j.load_units()["g@0+1"]
    loaded = j.load_unit_preds(rec)
    j.close()
    np.testing.assert_array_equal(loaded[0], pos)
    np.testing.assert_array_equal(loaded[1], preds)
    path = os.path.join(j.dir, rec["file"])
    with open(path, "wb") as fh:
        fh.write(b"PK\x03\x04 torn npz")
    assert PolishJournal(out).load_unit_preds(rec) is None
    with open(path, "wb"):
        pass
    assert PolishJournal(out).load_unit_preds(rec) is None
    os.unlink(path)
    assert PolishJournal(out).load_unit_preds(rec) is None


# -- the coordinator's state machine ------------------------------------------------


def test_happy_path_commits_every_unit():
    refs = _refs(("zulu", 3000), ("alpha", 900), ("empty", 0))
    job = _job(FakeFleet(2), _cfg(), refs, lambda p, payload, t: _polished_reply(payload))
    polished = job.run()
    assert polished["zulu"] == "POLISHED-zulu" and polished["alpha"] == "POLISHED-alpha"
    assert polished["empty"] == dict(refs)["empty"]
    assert all(u.state == "committed" for u in job.units)
    assert job.snapshot()["state"] == "done" and job.snapshot()["counts"] == {"committed": 3}


def test_worker_death_redispatches_to_survivor_with_exclusion():
    refs = _refs(("zulu", 900), ("alpha", 900))
    calls, state = [], {"failed": False}

    def transport(port, payload, timeout):
        contig = payload["unit"]["contig"]
        calls.append((port - 9000, contig))
        if contig == "alpha" and not state["failed"]:
            state["failed"] = True
            raise ConnectionError("worker SIGKILLed mid-unit")
        return _polished_reply(payload)

    job = _job(FakeFleet(2), _cfg(), refs, transport)
    assert job.run()["alpha"] == "POLISHED-alpha"
    tried = [wid for wid, contig in calls if contig == "alpha"]
    assert len(tried) == 2 and tried[0] != tried[1]
    alpha = next(u for u in job.units if u.contig == "alpha")
    assert alpha.failures == 1 and alpha.state == "committed"


def test_poison_unit_quarantined_names_contig_and_commits_rest(tmp_path):
    refs = _refs(("good", 900), ("bad", 900))
    out = str(tmp_path / "out.fa")
    journal = PolishJournal(out)
    journal.open({"m": 1}, resume=False)

    def transport(port, payload, timeout):
        if payload["unit"]["contig"] == "bad":
            raise ConnectionError("poison")
        return _polished_reply(payload)

    job = _job(FakeFleet(2), _cfg(), refs, transport, journal=journal)
    with pytest.raises(PoisonedUnit, match="'bad'"):
        job.run()
    assert job.snapshot()["state"] == "failed"
    bad = next(u for u in job.units if u.contig == "bad")
    good = next(u for u in job.units if u.contig == "good")
    assert bad.state == "quarantined" and bad.failures == FAST.unit_attempts
    assert good.state == "committed"
    units = journal.load_units()
    journal.close()
    assert units[bad.uid]["state"] == "quarantined"
    assert units[good.uid]["state"] == "committed"
    j2 = PolishJournal(out)
    assert set(j2.open({"m": 1}, resume=True)) == {"good"}
    j2.close()


def test_draining_fleet_parks_units_then_completes():
    fleet = FakeFleet(2)
    fleet._draining = True
    calls = []

    def transport(port, payload, timeout):
        calls.append(port)
        return _polished_reply(payload)

    job = _job(fleet, _cfg(), _refs(("zulu", 900)), transport)
    t = threading.Thread(target=job.run, daemon=True)
    t.start()
    time.sleep(0.15)
    assert calls == []
    fleet._draining = False
    t.join(5.0)
    assert not t.is_alive()
    assert job.units[0].state == "committed" and job.units[0].failures == 0


def test_worker_503_draining_parks_without_burning_attempts():
    state = {"calls": 0}

    def transport(port, payload, timeout):
        state["calls"] += 1
        if state["calls"] == 1:
            return 503, json.dumps({"error": "server draining", "retry_after_s": 0.02}).encode()
        return _polished_reply(payload)

    job = _job(FakeFleet(1), _cfg(), _refs(("zulu", 900)), transport)
    job.run()
    u = job.units[0]
    assert u.state == "committed" and u.failures == 0 and u.excluded == []
    assert state["calls"] == 2


def test_malformed_200_reply_burns_one_attempt_not_the_job():
    state = {"calls": 0}

    def transport(port, payload, timeout):
        state["calls"] += 1
        if state["calls"] == 1:
            return 200, json.dumps({"contig": "zulu", "windows": None, "polished": 7}).encode()
        return _polished_reply(payload)

    job = _job(FakeFleet(2), _cfg(), _refs(("zulu", 900)), transport)
    assert job.run()["zulu"] == "POLISHED-zulu"
    assert job.units[0].failures == 1 and job.units[0].state == "committed"


def test_degraded_fleet_lowers_inflight_limit():
    fleet = FakeFleet(4)
    job = _job(fleet, _cfg(), _refs(("a", 900)), lambda *a: (_ for _ in ()))
    assert job._inflight_limit() == 2 * 4
    fleet.workers[0].state = "dead"
    fleet.workers[1].state = "warming"
    assert job._inflight_limit() == 2 * 2
    fleet._draining = True
    assert job._inflight_limit() == 0


def test_parked_fleet_gates_new_dispatch():
    fleet = FakeFleet(2)
    job = _job(fleet, _cfg(), _refs(("a", 900)), lambda *a: (_ for _ in ()))
    assert job._inflight_limit() == 4
    fleet.jobs_parked = True
    assert job._inflight_limit() == 0
    fleet.jobs_parked = False
    assert job._inflight_limit() == 4


def test_autoscaler_park_resume_zero_reruns():
    """Parked for longer than ``ready_timeout_s`` (a parked job waits by
    design, never trips the no-capacity abort), then resumed: every
    contig's transport fires once."""
    fleet = FakeFleet(1)
    refs = _refs(("zulu", 900), ("alpha", 900), ("mike", 900))
    calls = []
    unparked = threading.Event()

    def unpark():
        fleet.jobs_parked = False
        unparked.set()

    def transport(port, payload, timeout):
        calls.append(payload["unit"]["contig"])
        if len(calls) == 1:
            fleet.jobs_parked = True
            threading.Timer(0.5, unpark).start()
        return _polished_reply(payload)

    job = _job(fleet, _cfg(ready_timeout_s=0.2, inflight_per_worker=1), refs, transport)
    polished = job.run()
    assert unparked.is_set()
    assert sorted(calls) == ["alpha", "mike", "zulu"]
    assert all(u.state == "committed" for u in job.units) and polished["zulu"] == "POLISHED-zulu"


# -- span units: merge and resume ---------------------------------------------------


def _span_windows(region, k=4):
    cols = C.WINDOW_COLS
    span = region.end - region.start
    pos = np.zeros((k, cols, 2), np.int64)
    for j in range(k):
        pos[j, :, 0] = region.start + (j * 17 + np.arange(cols)) % span
    return pos, ((pos[:, :, 0] * 7 + 3) % C.NUM_CLASSES).astype(np.int32)


def _span_transport(refs, region_cfg):
    drafts = dict(refs)

    def transport(port, payload, timeout):
        unit = payload["unit"]
        contig = unit["contig"]
        if unit["emit"] == "contig":
            return _polished_reply(payload)
        regions = list(generate_regions(len(drafts[contig]), contig, region_cfg))
        sl = regions[unit["first_region"]:unit["first_region"] + unit["n_regions"]]
        pos = np.concatenate([_span_windows(r)[0] for r in sl])
        preds = np.concatenate([_span_windows(r)[1] for r in sl])
        return 200, json.dumps({"contig": contig, "windows": int(len(pos)),
                                "positions": b64_array(pos, np.int64),
                                "preds": b64_array(preds, np.int32)}).encode()

    return transport


def _span_reference(refs, region_cfg, contig):
    """ONE board fed every region's windows (the single process's), and
    the reference's board on the same votes."""
    from roko_tpu.infer import VoteBoard as RefBoard
    from roko_tpu_torch.infer import VoteBoard

    drafts = dict(refs)
    board, ref_board = VoteBoard({contig: drafts[contig]}), RefBoard({contig: drafts[contig]})
    for r in generate_regions(len(drafts[contig]), contig, region_cfg):
        pos, preds = _span_windows(r)
        board.add([contig] * len(pos), pos, preds)
        ref_board.add([contig] * len(pos), pos, preds)
    seq = board.stitch(contig)
    assert seq == ref_board.stitch(contig)
    return seq


def test_span_units_merge_byte_identical_to_single_board():
    refs = _refs(("giant", 3000))
    cfg = _cfg(unit_bases=1500)
    job = _job(FakeFleet(2), cfg, refs, _span_transport(refs, cfg.region))
    polished = job.run()
    assert len([u for u in job.units if not u.whole]) == 3
    assert polished["giant"] == _span_reference(refs, cfg.region, "giant")


def test_span_unit_resume_reloads_committed_preds(tmp_path):
    refs = _refs(("giant", 3000))
    cfg = _cfg(unit_bases=1500, unit_attempts=1)
    out, meta = str(tmp_path / "giant.fa"), {"m": "span"}

    def failing(port, payload, timeout):
        if payload["unit"]["first_region"] == 2:
            raise ConnectionError("killed")
        return _span_transport(refs, cfg.region)(port, payload, timeout)

    j1 = PolishJournal(out)
    j1.open(meta, resume=False)
    with pytest.raises(PoisonedUnit):
        _job(FakeFleet(2), cfg, refs, failing, journal=j1).run()
    j1.close()
    dispatched = []

    def healthy(port, payload, timeout):
        dispatched.append(payload["unit"]["first_region"])
        return _span_transport(refs, cfg.region)(port, payload, timeout)

    j2 = PolishJournal(out)
    assert j2.open(meta, resume=True) == {}
    polished = _job(FakeFleet(2), cfg, refs, healthy, journal=j2).run()
    j2.close()
    assert dispatched == [2]
    assert polished["giant"] == _span_reference(refs, cfg.region, "giant")


# -- _run_job_core: journal, writer, resume -----------------------------------------


def _core(fleet, cfg, tmp_path, refs, transport, out_name, resume=False, identity=None):
    fasta = str(tmp_path / "draft.fa")
    if not os.path.exists(fasta):
        write_fasta(fasta, refs)
    bam = str(tmp_path / "reads.bam")
    if not os.path.exists(bam):
        with open(bam, "wb") as fh:
            fh.write(b"\x1f\x8bstub")  # BGZF magic: passed through unconverted
    out = str(tmp_path / out_name)
    polished = _run_job_core(fleet, cfg, ref=fasta, bam=bam, out=out, seed=0, resume=resume,
                             model_identity=identity or {"version": "boot", "fp": "a" * 8},
                             transport=transport, log=_quiet)
    return out, polished


def test_job_core_writes_sorted_fasta_and_finalizes_journal(tmp_path):
    refs = _refs(("zulu", 900), ("alpha", 900))
    out, _ = _core(FakeFleet(2), _cfg(), tmp_path, refs,
                   lambda p, payload, t: _polished_reply(payload), "out.fa")
    assert list(read_fasta(out)) == [("alpha", "POLISHED-alpha"), ("zulu", "POLISHED-zulu")]
    assert not os.path.isdir(out + ".resume")


def test_coordinator_resume_skips_committed_contigs(tmp_path):
    refs = _refs(("zulu", 900), ("alpha", 900), ("mike", 900))

    def failing(port, payload, timeout):
        if payload["unit"]["contig"] == "mike":
            raise ConnectionError("coordinator died around here")
        return _polished_reply(payload)

    with pytest.raises(PoisonedUnit):
        _core(FakeFleet(2), _cfg(), tmp_path, refs, failing, "out.fa")
    assert not os.path.exists(str(tmp_path / "out.fa"))
    assert os.path.isdir(str(tmp_path / "out.fa") + ".resume")
    dispatched = []

    def healthy(port, payload, timeout):
        dispatched.append(payload["unit"]["contig"])
        return _polished_reply(payload)

    out, _ = _core(FakeFleet(2), _cfg(), tmp_path, refs, healthy, "out.fa", resume=True)
    assert dispatched == ["mike"]
    clean, _ = _core(FakeFleet(2), _cfg(), tmp_path, refs, healthy, "clean.fa")
    assert open(out, "rb").read() == open(clean, "rb").read()
    assert not os.path.isdir(out + ".resume")


def test_resume_refuses_quantize_and_version_change(tmp_path):
    refs = _refs(("zulu", 900), ("mike", 900))
    cfg = _cfg()

    def failing(port, payload, timeout):
        if payload["unit"]["contig"] == "mike":
            raise ConnectionError("die")
        return _polished_reply(payload)

    identity = {"version": "boot", "params_fingerprint": "f" * 16, "quantize": None}
    with pytest.raises(PoisonedUnit):
        _core(FakeFleet(2), cfg, tmp_path, refs, failing, "out.fa", identity=identity)
    healthy = lambda p, payload, t: _polished_reply(payload)  # noqa: E731
    int8 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, quantize="int8"))
    rebased = dataclasses.replace(cfg, distpolish=dataclasses.replace(cfg.distpolish,
                                                                      unit_bases=1234))
    for c, ident in ((int8, identity), (cfg, dict(identity, version="v2-rolled-out")),
                     (rebased, identity)):
        with pytest.raises(JournalMismatch):
            _core(FakeFleet(2), c, tmp_path, refs, healthy, "out.fa", resume=True,
                  identity=ident)
    out, _ = _core(FakeFleet(2), cfg, tmp_path, refs, healthy, "out.fa", resume=True,
                   identity=identity)
    assert len(read_fasta(out)) == 2


def test_distributed_meta_carries_quantize_and_model_identity(tmp_path):
    cfg = _cfg()
    meta = distributed_meta("r.fa", "x.bam", 7, cfg, {"version": "boot", "fp": "aa"})
    assert meta["mode"] == "distributed" and meta["quantize"] is None
    assert meta["config"]["model"]["quantize"] is None
    assert meta["model"] == {"version": "boot", "fp": "aa"}
    int8 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, quantize="int8"))
    assert distributed_meta("r.fa", "x.bam", 7, int8, {})["quantize"] == "int8"
    # the weights' fingerprint: the reference's, over the same bytes
    pth = tmp_path / "m.pth"
    torch.save(RokoModel(TINY).state_dict(), pth)
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "a.bin").write_bytes(b"x" * 10)
    for path in (str(pth), str(tmp_path / "d")):
        assert checkpoint_fingerprint(path) == ref_dp.checkpoint_fingerprint(path)


def test_job_core_converts_sam_input_before_shipping(tmp_path):
    from roko_tpu_torch.features import pipeline as featpl

    refs = _refs(("zulu", 900))
    fasta = str(tmp_path / "draft.fa")
    write_fasta(fasta, refs)
    shipped = []

    def transport(port, payload, timeout):
        shipped.append(payload["bam"])
        return _polished_reply(payload)

    converted = str(tmp_path / "converted.bam")
    real = featpl._ensure_bam
    featpl._ensure_bam = lambda path, stack: converted
    try:
        _run_job_core(FakeFleet(2), _cfg(), ref=fasta, bam="reads.sam",
                      out=str(tmp_path / "out.fa"), seed=0, resume=False,
                      model_identity={"version": "boot"}, transport=transport, log=_quiet)
    finally:
        featpl._ensure_bam = real
    assert shipped == [converted]
    assert distributed_meta(fasta, "reads.sam", 0, _cfg(), {"version": "boot"})["bam"] == \
        "reads.sam"
    # a store BAM ships as its URL (each worker downloads it through the
    # store client); a store SAM, which no worker could convert, is refused
    from roko_tpu_torch.datapipe import io as dio
    from roko_tpu_torch.datapipe import store

    bucket = tmp_path / "bucket"
    bucket.mkdir()
    (bucket / "r.bam").write_bytes(b"\x1f\x8bstub")
    (bucket / "r.sam").write_text("@HD\tVN:1.6\n")
    srv = store.StubObjectStore(str(bucket)).start()
    saved = store._default_store, dict(dio._OPENERS), dict(dio._WRITERS)
    store.install(store.ObjectStore(timeout_s=5.0))
    try:
        shipped.clear()
        _run_job_core(FakeFleet(2), _cfg(), ref=fasta, bam=srv.url + "/r.bam",
                      out=str(tmp_path / "o2.fa"), seed=0, resume=False,
                      model_identity={}, transport=transport, log=_quiet)
        assert shipped and set(shipped) == {srv.url + "/r.bam"}
        with pytest.raises(ValueError, match="needs sorted BAM input"):
            _run_job_core(FakeFleet(2), _cfg(), ref=fasta, bam=srv.url + "/r.sam",
                          out=str(tmp_path / "o3.fa"), seed=0, resume=False,
                          model_identity={}, transport=transport, log=_quiet)
    finally:
        srv.shutdown()
        srv.server_close()
        store._default_store = saved[0]
        for registry, old in ((dio._OPENERS, saved[1]), (dio._WRITERS, saved[2])):
            registry.clear()
            registry.update(old)


# -- the client's 503 classes (the coordinator's parse) -----------------------------


class _FixedReplyHandler(BaseHTTPRequestHandler):
    reply = (503, {"error": "fleet draining", "retry_after_s": 0.05})

    def log_message(self, *a):
        pass

    def do_POST(self):  # noqa: N802
        self.rfile.read(int(self.headers.get("Content-Length", "0")))
        code, body = self.reply
        raw = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)


def _fixed_server(reply):
    server = ThreadingHTTPServer(("127.0.0.1", 0),
                                 type("H", (_FixedReplyHandler,), {"reply": reply}))
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _client_polish(server, retries):
    from roko_tpu_torch.serve.client import PolishClient

    client = PolishClient(f"http://127.0.0.1:{server.server_address[1]}")
    sleeps = []
    client._sleep = sleeps.append
    try:
        client.polish("ACGT", np.zeros((0, 90, 2), np.int64), np.zeros((0, 200, 90), np.uint8),
                      retries=retries)
    finally:
        server.shutdown()
        server.server_close()
    return sleeps


def test_client_raises_typed_fleet_draining_without_retrying():
    from roko_tpu_torch.serve.client import FleetDraining, ServerBusy

    server = _fixed_server((503, {"error": "fleet draining", "retry_after_s": 2.5}))
    with pytest.raises(FleetDraining) as exc:
        _client_polish(server, 5)
    assert isinstance(exc.value, ServerBusy) and exc.value.retry_after_s == 2.5


def test_client_fleet_draining_survives_malformed_retry_after():
    from roko_tpu_torch.serve.client import FleetDraining, parse_503_body

    server = _fixed_server((503, {"error": "fleet draining", "retry_after_s": None}))
    with pytest.raises(FleetDraining) as exc:
        _client_polish(server, 5)
    assert exc.value.retry_after_s == 1.0
    from roko_tpu.serve.client import parse_503_body as ref_parse

    for body in (b'{"error": "server draining", "retry_after_s": 3}', b"junk", b"{}",
                 b'{"error": "busy", "retry_after_s": "x"}'):
        assert parse_503_body(body) == ref_parse(body)


def test_client_busy_503_still_retries_to_service_unavailable():
    from roko_tpu_torch.serve.client import ServiceUnavailable

    server = _fixed_server((503, {"error": "fleet at capacity", "retry_after_s": 0.01}))
    with pytest.raises(ServiceUnavailable) as exc:
        _client_polish(server, 2)
    assert exc.value.attempts == 3


# -- the supervisor's POST /job and GET /jobz ---------------------------------------


@pytest.fixture
def front(tmp_path):
    """A supervisor front end over a never-started real ``Fleet``."""
    from roko_tpu_torch.serve.fleet import Fleet
    from roko_tpu_torch.serve.supervisor import make_front_server

    cfg = RokoConfig(model=TINY, fleet=FleetConfig(workers=1, runtime_dir=str(tmp_path / "rt")))
    fleet = Fleet(cfg, worker_command=lambda *_: [], log=_quiet)
    server = make_front_server(fleet, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield cfg, fleet, server
    server.shutdown()
    server.server_close()
    thread.join(5.0)


def _http(port, path, payload=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"} if payload else {},
        method="POST" if payload is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def test_jobz_idle_then_snapshot(front):
    cfg, fleet, server = front
    port = server.server_address[1]
    assert _http(port, "/jobz") == (200, {"state": "idle"})
    fleet.job = _job(FakeFleet(1), _cfg(), _refs(("zulu", 900)),
                     lambda p, payload, t: _polished_reply(payload))
    fleet.job.run()
    code, body = _http(port, "/jobz")
    assert code == 200 and body["state"] == "done" and body["counts"] == {"committed": 1}
    assert "zulu@0+1" in body["units"]


def test_post_job_unconfigured_501_validation_and_409(front, tmp_path):
    cfg, fleet, server = front
    port = server.server_address[1]
    assert _http(port, "/job", {"ref": "x", "bam": "y", "out": "z"})[0] == 501
    server._start_job = make_job_starter(fleet, cfg, log=_quiet)
    code, body = _http(port, "/job", {"ref": "/nope.fa", "bam": "/nope.bam", "out": "z"})
    assert code == 400 and "readable data file" in body["error"]
    ref = tmp_path / "d.fa"
    write_fasta(str(ref), _refs(("zulu", 400)))
    bam = tmp_path / "r.bam"
    bam.write_bytes(b"\x1f\x8bstub")
    code, body = _http(port, "/job", {"ref": str(ref), "bam": str(bam)})
    assert code == 400 and "out" in body["error"]
    # a store output passes as it is, unless a data root confines the paths
    rooted = make_job_starter(
        fleet, dataclasses.replace(cfg, serve=ServeConfig(data_root=str(tmp_path))), log=_quiet)
    code, body = rooted({"ref": str(ref), "bam": str(bam), "out": "s3://b/o.fa"})
    assert code == 400 and "data root" in body["error"]

    class _Busy:
        def active(self):
            return True

        def snapshot(self):
            return {"state": "running"}

        def status(self):
            return {"state": "rolling"}

    fleet.job = _Busy()
    job = {"ref": str(ref), "bam": str(bam), "out": str(tmp_path / "o.fa")}
    for out in (job["out"], "s3://b/o.fa"):
        code, body = _http(port, "/job", dict(job, out=out))
        assert code == 409 and "already running" in body["error"]
    from roko_tpu_torch.serve.supervisor import make_rollout_starter

    code, body = make_rollout_starter(fleet, None, "ckpt", cfg, log=_quiet)({"name": "v2"})
    assert code == 409 and "distributed polish job" in body["error"]
    fleet.job = None
    fleet.rollout = _Busy()
    code, body = _http(port, "/job", job)
    assert code == 409 and "rollout is in progress" in body["error"]


# -- the real worker-side executor: byte identity -----------------------------------


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """Two contigs (one splits into span units at 1500 bases) with reads,
    JAX params at ``TINY_GRU`` widths and the port model converted from
    them, and the port's and the reference's single-process FASTA."""
    root = tmp_path_factory.mktemp("torch_distpolish")
    rng = random.Random(7)
    drafts = [("zulu", random_seq(rng, 3000)), ("beta", random_seq(rng, 900))]
    fasta, bam = str(root / "draft.fasta"), str(root / "reads.bam")
    write_fasta(fasta, drafts)
    reads = []
    for tid, (_, seq) in enumerate(drafts):
        reads += simulate_reads(rng, seq, tid, coverage=8, read_len=300)
    write_sorted_bam(bam, [(n, len(s)) for n, s in drafts], reads)
    params = jax.tree.map(np.asarray, JModel(TINY_GRU).init(jax.random.PRNGKey(0)))
    sd = state_dict_from_jax(params)
    pth = str(root / "m.pth")
    torch.save(sd, pth)
    cfg = RokoConfig(model=TINY, region=REGION, serve=ServeConfig(ladder=(8,)),
                     distpolish=dataclasses.replace(FAST, unit_bases=1500))
    model = RokoModel(TINY)
    model.load_state_dict(sd, strict=True)
    from roko_tpu_torch.pipeline import run_streaming_polish

    single = str(root / "single.fasta")
    run_streaming_polish(fasta, bam, model, cfg, out_path=single, batch_size=8, device="cpu",
                         log=_quiet)
    ref = str(root / "reference.fasta")
    ref_streaming_polish(fasta, bam, params, JRoko(model=TINY_GRU, region=JRegion(
        size=1200, overlap=100)), out_path=ref, batch_size=8, log=_quiet)
    return dict(root=root, fasta=fasta, bam=bam, pth=pth, cfg=cfg, model=model,
                single=open(single, "rb").read(), reference=open(ref, "rb").read())


def test_distpolish_in_process_byte_identical(project, tmp_path):
    """The coordinator and the real worker-side unit executor
    (``_polish_unit`` over a warm session and the continuous batcher):
    whole-contig and span units, the FASTA of the port's single-process
    polish and of ``roko_tpu``'s, byte for byte."""
    from roko_tpu_torch.serve.scheduler import ContinuousBatcher
    from roko_tpu_torch.serve.server import _polish_unit
    from roko_tpu_torch.serve.session import PolishSession

    cfg = project["cfg"]
    session = PolishSession(project["model"], cfg, device="cpu")
    batcher = ContinuousBatcher(session)
    try:
        def transport(port, payload, timeout):
            return 200, json.dumps(_polish_unit(batcher, payload, None, None)).encode()

        out = str(tmp_path / "distributed.fasta")
        _run_job_core(FakeFleet(2), cfg, ref=project["fasta"], bam=project["bam"], out=out,
                      seed=0, resume=False, model_identity={"version": "boot", "fp": "x"},
                      transport=transport, log=_quiet)
    finally:
        batcher.stop()
    got = open(out, "rb").read()
    assert got == project["single"] == project["reference"] and len(got) > 3000
    assert not os.path.isdir(out + ".resume")
    assert len([u for u in split_units(read_fasta(project["fasta"]), REGION, 1500)
                if not u.whole]) == 3


def _events(path):
    out = []
    try:
        with open(path) as fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("subsystem") == "job":
                    out.append(rec)
    except OSError:
        pass
    return out


def test_distpolish_worker_sigkill_one_contig_rerun(project, tmp_path):
    """``polish --distributed --device cpu`` on a REAL 2-worker fleet with
    the worker of the first dispatch SIGKILLed mid-unit: rc 0, the FASTA
    the single process's byte for byte, at most one unit run again, the
    fleet saw the death, ``/jobz`` answered, no process left."""
    runtime = str(tmp_path / "rt")
    cfg = dataclasses.replace(
        project["cfg"],
        fleet=FleetConfig(workers=2, heartbeat_interval_s=0.25, stable_after_s=1.0,
                          runtime_dir=runtime, spawn_deadline_s=120.0),
        distpolish=DistPolishConfig(unit_bases=0, inflight_per_worker=1, park_poll_s=0.05,
                                    unit_attempts=3, ready_timeout_s=180.0))
    cfg_json = tmp_path / "cfg.json"
    cfg_json.write_text(cfg.to_json())
    out, evlog = str(tmp_path / "out.fasta"), str(tmp_path / "events.jsonl")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["ROKO_COMPILE_CACHE"] = "off"
    proc = subprocess.Popen(
        [sys.executable, "-m", "roko_tpu_torch", "polish", project["fasta"], project["bam"],
         project["pth"], out, "--distributed", "--config", str(cfg_json), "--event-log", evlog,
         "--seed", "0", "--device", "cpu"],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        bufsize=1, start_new_session=True)
    lines = []
    pump = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    pump.start()
    pids = set()
    try:
        victim, deadline = None, time.monotonic() + 300
        while victim is None and time.monotonic() < deadline and proc.poll() is None:
            victim = next((e["worker"] for e in _events(evlog)
                           if e["event"] == "unit_dispatch"), None)
            time.sleep(0.02)
        assert victim is not None, "".join(lines[-40:])
        with open(os.path.join(runtime, f"worker-{victim}.announce.json")) as fh:
            killed = json.load(fh)["pid"]
        os.kill(killed, signal.SIGKILL)
        jobz = None
        while proc.poll() is None and time.monotonic() < deadline:
            for wid in (0, 1):
                try:
                    with open(os.path.join(runtime, f"worker-{wid}.announce.json")) as fh:
                        pids.add(json.load(fh)["pid"])
                except (OSError, ValueError, KeyError):
                    pass
            m = next((re.search(r"front end at http://[\d.]+:(\d+)", s) for s in lines
                      if "front end at" in s), None)
            if m and jobz is None:
                code, body = _http(int(m.group(1)), "/jobz")
                if code == 200 and body.get("units"):
                    jobz = body
            time.sleep(0.05)
        rc = proc.wait(300)
        pump.join(10)
        text = "".join(lines)
        assert rc == 0, text[-6000:]
        assert open(out, "rb").read() == project["single"]
        retries = [e for e in _events(evlog) if e["event"] == "unit_retry"]
        assert len(retries) <= 1, retries
        assert any("roko fleet: worker" in s and ("exited" in s or "dropped" in s
                                                 or "killed" in s) for s in lines), text[-6000:]
        assert jobz is not None and len(jobz["units"]) == 2
        assert not os.path.isdir(out + ".resume")
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                pass
        try:  # the coordinator leads its own group: nothing of the fleet outlives it
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        if proc.poll() is None:
            proc.wait()
    for pid in pids | {killed}:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def _group_members(pgid):
    """Pids of the live (not zombie) processes in process group ``pgid``."""
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[0] != "Z" and int(fields[2]) == pgid:
            out.append(int(name))
    return out


def test_distpolish_coordinator_sigkill_leaves_no_worker(project, tmp_path):
    """``polish --distributed --device cpu`` SIGKILLed mid-job: its
    fleet's workers ran in a process group of their own, whose leader
    drains and then kills them, so no worker outlives the coordinator."""
    runtime = str(tmp_path / "rt")
    cfg = dataclasses.replace(
        project["cfg"],
        fleet=FleetConfig(workers=1, heartbeat_interval_s=0.25, term_grace_s=1.0,
                          runtime_dir=runtime, spawn_deadline_s=120.0),
        resilience=ResilienceConfig(drain_deadline_s=2.0),
        distpolish=DistPolishConfig(unit_bases=0, inflight_per_worker=1, park_poll_s=0.05,
                                    ready_timeout_s=180.0))
    cfg_json = tmp_path / "cfg.json"
    cfg_json.write_text(cfg.to_json())
    out, evlog = str(tmp_path / "out.fasta"), str(tmp_path / "events.jsonl")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["ROKO_COMPILE_CACHE"] = "off"
    proc = subprocess.Popen(
        [sys.executable, "-m", "roko_tpu_torch", "polish", project["fasta"], project["bam"],
         project["pth"], out, "--distributed", "--config", str(cfg_json), "--event-log", evlog,
         "--seed", "0", "--device", "cpu"],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        bufsize=1, start_new_session=True)
    lines = []
    pump = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    pump.start()
    group = None
    try:
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and proc.poll() is None and not any(
                e["event"] == "unit_dispatch" for e in _events(evlog)):
            time.sleep(0.02)
        m = next((re.search(r"fleet workers in process group (\d+)", s) for s in lines
                  if "process group" in s), None)
        assert proc.poll() is None and m, "".join(lines[-40:])
        group = int(m.group(1))
        with open(os.path.join(runtime, "worker-0.announce.json")) as fh:
            worker = json.load(fh)["pid"]
        assert os.getpgid(worker) == group != os.getpgid(proc.pid)
        proc.kill()
        proc.wait(30)
        # the leader's grace is the drain deadline and the term grace (3 s)
        deadline = time.monotonic() + 30
        while _group_members(group) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert _group_members(group) == [], "".join(lines[-40:])
    finally:
        for pgid in (proc.pid, group):
            try:
                if pgid is not None:
                    os.killpg(pgid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        if proc.poll() is None:
            proc.wait()
