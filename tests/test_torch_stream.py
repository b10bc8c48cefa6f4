"""The port's streaming polish (``roko_tpu_torch.pipeline.stream``) on the
CPU, for ``kind="gru"`` and ``"lingru"`` (hidden 16, 2 layers, random
JAX weights carried over by the weights bridge), on the reference's
2-contig multi-region project (``tests/test_stream_pipeline.py``: region
size 1200, batch 16):

- the streamed FASTA is byte-identical to ``roko_tpu``'s
  ``run_streaming_polish`` and to the port's staged path, and the
  ``--keep-hdf5`` tee polishes to the same bytes;
- out-of-order regions, deadline-flushed partial batches, backpressure,
  worker exceptions (also under a full queue) and the ordered writer
  behave as the reference's tests check them;
- a run that fails after a contig was committed resumes to the same
  bytes, and a changed weight makes the resume raise
  ``JournalMismatch``.

Every wait in the engine is bounded, so a broken engine fails these
tests within seconds instead of hanging the run."""

import os
import queue
import random
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from roko_tpu.config import ModelConfig as JaxModelConfig
from roko_tpu.config import RegionConfig as JaxRegionConfig
from roko_tpu.config import RokoConfig as JaxRokoConfig
from roko_tpu.io.bam import write_sorted_bam
from roko_tpu.models import RokoModel as JaxRokoModel
from roko_tpu.pipeline import run_streaming_polish as ref_streaming_polish
from roko_tpu_torch.config import ModelConfig, RegionConfig, RokoConfig
from roko_tpu_torch.features.pipeline import open_region_stream, run_features
from roko_tpu_torch.infer import polish_to_fasta
from roko_tpu_torch.io.fasta import read_fasta, write_fasta
from roko_tpu_torch.models.convert import state_dict_from_jax
from roko_tpu_torch.models.model import RokoModel
from roko_tpu_torch.pipeline import run_streaming_polish
from roko_tpu_torch.pipeline.stream import _OrderedFastaWriter, _RegionProducer
from roko_tpu_torch.resilience import JournalMismatch
from roko_tpu_torch.serve.metrics import ServeMetrics
from roko_tpu_torch.serve.session import PolishSession
from roko_tpu_torch.utils.profiling import StageTimer
from tests.helpers import random_seq, simulate_reads
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

KINDS = {"gru": 4, "lingru": 6}  # kind -> init seed of the random JAX params
REGION = dict(size=1200, overlap=100)
SEED = 5
BATCH = 16


def quiet(*_):
    pass


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """Two multi-region contigs whose draft order is not sorted order,
    reads over both, and a port model of each kind with the JAX params
    it was converted from."""
    root = tmp_path_factory.mktemp("torch_stream")
    rng = random.Random(7)
    drafts = [("zulu", random_seq(rng, 3000)), ("alpha", random_seq(rng, 2400))]
    fasta = str(root / "draft.fasta")
    write_fasta(fasta, drafts)
    reads = []
    for tid, (_, seq) in enumerate(drafts):
        reads += simulate_reads(rng, seq, tid, coverage=10, read_len=300)
    bam = str(root / "reads.bam")
    write_sorted_bam(bam, [(n, len(s)) for n, s in drafts], reads)
    models, params = {}, {}
    for kind, seed in KINDS.items():
        jcfg = JaxModelConfig(kind=kind, hidden_size=16, num_layers=2)
        params[kind] = jax.tree.map(np.asarray, JaxRokoModel(jcfg).init(jax.random.PRNGKey(seed)))
        models[kind] = RokoModel(ModelConfig(kind=kind, hidden_size=16, num_layers=2))
        models[kind].load_state_dict(state_dict_from_jax(params[kind]), strict=True)
    with open_region_stream(fasta, bam, seed=SEED, config=_cfg("gru"), log=quiet) as stream:
        regions = SimpleNamespace(refs=stream.refs, counts=dict(stream.region_counts),
                                  results=list(stream.results))
    assert len(regions.results) >= 4  # really multi-region
    staged = {}
    for kind in KINDS:
        h5 = str(root / f"staged_{kind}.hdf5")
        run_features(fasta, bam, h5, seed=SEED, config=_cfg(kind), log=quiet)
        out = root / f"staged_{kind}.fasta"
        polish_to_fasta(h5, models[kind], str(out), device="cpu", batch_size=BATCH, log=quiet)
        staged[kind] = out.read_bytes()
    return SimpleNamespace(root=root, fasta=fasta, bam=bam, models=models, params=params,
                           regions=regions, staged=staged)


def _cfg(kind, **kw):
    kw.setdefault("region", RegionConfig(**REGION))
    return RokoConfig(model=ModelConfig(kind=kind, hidden_size=16, num_layers=2), **kw)


def _source(project, results=None):
    r = project.regions
    return SimpleNamespace(refs=r.refs, region_counts=dict(r.counts),
                           results=iter(r.results if results is None else results))


def _stream(project, kind="gru", **kw):
    kw.setdefault("batch_size", BATCH)
    kw.setdefault("log", quiet)
    return run_streaming_polish(None, None, project.models[kind], _cfg(kind), device="cpu",
                                region_source=_source(project, kw.pop("results", None)), **kw)


@pytest.mark.parametrize("kind", list(KINDS))
def test_streaming_byte_identical_to_reference_and_staged(project, tmp_path, kind):
    out, tee = tmp_path / "stream.fasta", tmp_path / "tee.hdf5"
    timer = StageTimer()
    polished = run_streaming_polish(
        project.fasta, project.bam, project.models[kind], _cfg(kind), out_path=str(out),
        seed=SEED, batch_size=BATCH, workers=2, device="cpu", tee_hdf5=str(tee), log=quiet,
        timer=timer)
    got = out.read_bytes()
    assert got == project.staged[kind] and len(got) > 5000
    assert polished == dict(read_fasta(str(out)))
    assert {"extract", "predict+d2h", "vote", "stitch", "journal", "write_fasta",
            "tee_hdf5"} <= set(timer.totals)
    assert not os.path.exists(str(out) + ".resume")  # finalized
    # the tee is a features file the staged path polishes to the same bytes
    tee_fa = tmp_path / "tee.fasta"
    polish_to_fasta(str(tee), project.models[kind], str(tee_fa), device="cpu",
                    batch_size=BATCH, log=quiet)
    assert tee_fa.read_bytes() == got
    # the reference's streaming engine on the same weights
    ref = tmp_path / "ref.fasta"
    ref_streaming_polish(
        project.fasta, project.bam, project.params[kind],
        JaxRokoConfig(model=JaxModelConfig(kind=kind, hidden_size=16, num_layers=2),
                      region=JaxRegionConfig(**REGION)),
        out_path=str(ref), seed=SEED, batch_size=BATCH, workers=2, log=quiet)
    assert ref.read_bytes() == got


def test_streaming_out_of_region_order(project, tmp_path):
    out = tmp_path / "ooo.fasta"
    _stream(project, out_path=str(out), results=list(reversed(project.regions.results)))
    assert out.read_bytes() == project.staged["gru"]


def test_streaming_deadline_flush_partial_batches(project, tmp_path):
    """A slow extractor with a batch far larger than any region block and
    a tiny deadline: every dispatch is an age flush of a partial batch."""
    def slow():
        for r in project.regions.results:
            time.sleep(0.05)
            yield r

    out = tmp_path / "slow.fasta"
    metrics = ServeMetrics()
    _stream(project, out_path=str(out), batch_size=512, batch_delay_ms=10.0, results=slow(),
            metrics=metrics)
    assert out.read_bytes() == project.staged["gru"]
    windows, padded = metrics.fill_totals()
    assert 0 < windows < padded  # partial batches were padded


def test_backpressure_blocks_producer(project):
    """With queue depth Q a stalled consumer lets the producer pull at
    most Q + 1 region blocks."""
    results = project.regions.results
    pulled = []

    def counting():
        for r in results:
            pulled.append(r[0])
            yield r

    depth = 2
    q = queue.Queue(maxsize=depth)
    producer = _RegionProducer(_source(project, counting()), q, StageTimer())
    producer.start()
    deadline = time.monotonic() + 5.0
    while len(pulled) < depth + 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.3)  # would keep growing if the queue were unbounded
    assert len(pulled) == depth + 1 < len(results)
    drained = 0
    while producer.thread.is_alive() or not q.empty():
        try:
            q.get(timeout=1.0)
            drained += 1
        except queue.Empty:
            break
    producer.thread.join(timeout=5.0)
    assert not producer.thread.is_alive()
    assert len(pulled) == len(results) and drained > depth


def test_worker_exception_propagates(project, tmp_path):
    results = project.regions.results

    def faulting():
        yield results[0]
        raise RuntimeError("worker exploded mid-extraction")

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="worker exploded"):
        _stream(project, out_path=str(tmp_path / "never.fasta"), results=faulting())
    assert time.monotonic() - t0 < 30.0
    assert not (tmp_path / "never.fasta").exists()  # no truncated FASTA left
    # no thread left parked: a second run in the same process works
    out = tmp_path / "again.fasta"
    _stream(project, out_path=str(out))
    assert out.read_bytes() == project.staged["gru"]


def test_worker_exception_propagates_under_full_queue(project):
    results = project.regions.results

    def faulting():
        yield from results[:-1]
        raise RuntimeError("late worker death")

    with pytest.raises(RuntimeError, match="late worker death"):
        _stream(project, queue_regions=1, results=faulting())


def test_ordered_fasta_writer_out_of_order(tmp_path):
    path = tmp_path / "w.fasta"
    seqs = {"a": "ACGT" * 50, "m": "", "z": "TTTT" * 21}
    with _OrderedFastaWriter(str(path), sorted(seqs)) as w:
        w.add("z", seqs["z"])
        w.add("m", seqs["m"])
        assert path.read_text() == ""  # "a" gates the order
        w.add("a", seqs["a"])
    ref = tmp_path / "ref.fasta"
    write_fasta(str(ref), sorted(seqs.items()))
    assert path.read_bytes() == ref.read_bytes()


def _fail_after_first_contig(project, out):
    """Every region of the first contig, then — once that contig's commit
    is in the journal beside ``out`` (at most 10 s) — a worker death."""
    results = project.regions.results
    first = results[0][0]
    manifest = Path(str(out) + ".resume") / "manifest.jsonl"

    def gen():
        yield from (r for r in results if r[0] == first)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and first not in (
                manifest.read_text() if manifest.exists() else ""):
            time.sleep(0.01)
        raise RuntimeError("killed after one contig")

    return first, gen()


def test_resume_after_failure_writes_the_same_bytes(project, tmp_path):
    out = tmp_path / "resume.fasta"
    first, failing = _fail_after_first_contig(project, out)
    with pytest.raises(RuntimeError, match="killed after one contig"):
        _stream(project, out_path=str(out), results=failing)
    journal = Path(str(out) + ".resume")
    assert (journal / "manifest.jsonl").read_text().count('"contig"') == 1
    assert not out.exists()
    lines = []
    _stream(project, out_path=str(out), resume=True, log=lines.append)
    assert out.read_bytes() == project.staged["gru"]
    assert any("resume: skipping 1 committed contig" in line for line in lines)
    committed = [line for line in lines if line.startswith("polish: committed contig")]
    assert len(committed) == 1 and first not in committed[0]
    assert not journal.exists()


def test_resume_refuses_a_journal_of_other_weights(project, tmp_path):
    out = tmp_path / "mismatch.fasta"
    _, failing = _fail_after_first_contig(project, out)
    with pytest.raises(RuntimeError, match="killed after one contig"):
        _stream(project, out_path=str(out), results=failing)
    other = RokoModel(project.models["gru"].cfg)
    other.load_state_dict(project.models["gru"].state_dict())
    with torch.no_grad():
        other.fc4.bias[0] += 1e-3
    with pytest.raises(JournalMismatch, match="different run"):
        run_streaming_polish(None, None, other, _cfg("gru"), device="cpu", batch_size=BATCH,
                             out_path=str(out), resume=True, log=quiet,
                             region_source=_source(project))
    # the same weights with another region geometry: refused too
    with pytest.raises(JournalMismatch, match="different run"):
        run_streaming_polish(None, None, project.models["gru"],
                             _cfg("gru", region=RegionConfig(1000, 100)), device="cpu",
                             batch_size=BATCH, out_path=str(out), resume=True, log=quiet,
                             region_source=_source(project))


def test_injected_session_stays_on_its_ladder(project):
    """A warm session injected into the engine dispatches ladder shapes
    only, and the engine reports padding_efficiency from the batcher's
    metrics."""
    session = PolishSession(project.models["gru"], _cfg("gru"), device="cpu", ladder=(8, 16))
    assert session.warmup() == 2 and session.dispatched_shapes == {8, 16}
    metrics, lines = ServeMetrics(), []
    polished = run_streaming_polish(None, None, None, _cfg("gru"), session=session,
                                    metrics=metrics, log=lines.append,
                                    region_source=_source(project))
    assert session.dispatched_shapes <= set(session.ladder)
    fill = metrics.fill_ratio()
    assert 0.0 < fill <= 1.0
    assert any(f"padding_efficiency {fill:.3f}" in line for line in lines)
    windows, padded = metrics.fill_totals()
    assert fill == windows / padded and metrics.counters["windows"] == windows
    staged = dict(read_fasta(str(project.root / "staged_gru.fasta")))
    assert polished == staged
