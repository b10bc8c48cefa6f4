"""Streaming polish engine: FASTA+BAM -> polished FASTA as ONE overlapped
pipeline (the port's counterpart of ``roko_tpu/pipeline/stream.py``).

The staged path (``features`` then ``inference``) is strictly serial:
every window is written to an HDF5 file and read back before the first
prediction dispatches, so the extraction threads and the card take turns
idling. This engine runs the three stages at once::

    extraction workers (features.open_region_stream threads/processes)
        │ per-region (positions, examples) blocks
        ▼
    producer thread ── bounded queue.Queue(queue_regions) ──┐  backpressure:
        │ optional tee -> DataWriter (--keep-hdf5)          │  full queue
        ▼                                                   │  blocks workers
    consumer: submit each block to the ContinuousBatcher — windows from
        adjacent regions pack densely into ladder-rung device steps of
        a warm PolishSession
        │ preds (futures, drained with bounded lookahead)
        ▼
    VoteBoard.add (incremental)  ──  contig's last window voted
                                       └─> stitch + journal + FASTA write NOW

``--batch-delay-ms`` maps onto the scheduler's ``max_queue_age_ms`` (the
oldest queued window's padded-flush bound).

Threads: the batcher's scheduler thread (through the session's watchdog
threads) issues all the card's work; the producer thread drains the
region fan-out, which runs the native extractor in threads (its ctypes
call releases the GIL) or the Python one in spawned processes — nothing
forks after CUDA has started.

Failure propagation: a worker exception travels through the region
queue as an ``("error", exc)`` item and re-raises in the caller — never
a silent deadlock. Abandoning the consumer sets a stop event that every
producer ``put`` polls, so no thread is left parked on a full queue; the
batcher's ``stop`` fails any in-flight futures loudly. Every wait is
bounded: ``_put`` polls every 0.1 s, a future waits 15 s at a time and
checks the scheduler thread is alive, the producer is joined for 5 s and
then 25 s, and the batcher's ``stop`` joins for 5 s.

Output identity: votes are order-independent sums and a window's class
ids do not depend on the other rows of its padded batch, so the streamed
FASTA is byte-identical to the staged path's on the same inputs —
asserted against both ``roko_tpu``'s streaming polish and the port's
``polish --staged`` in ``tests/test_torch_stream.py``, including
out-of-order region arrival.

The model's precision modes ride along: it runs in its resolved
``cfg.compute_dtype``, and a config that asks for int8 quantizes it once,
before the journal's identity hash.

``trace_dir`` writes a device trace of the run's extraction, batching
and inference loop (``utils/profiling.device_trace``).

Left out of the port: a stream over several processes or a device mesh
(a session over several ranks, A9.1; several processes polish staged) and
the cascade router (A10).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import queue
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import torch

from roko_tpu_torch import constants as C
from roko_tpu_torch.config import FeaturesConfig, RokoConfig, resolve_ladder
from roko_tpu_torch.data.hdf5 import DataWriter
from roko_tpu_torch.features.pipeline import open_region_stream
from roko_tpu_torch.infer import VoteBoard, tail_rungs
from roko_tpu_torch.io.fasta import write_fasta_record
from roko_tpu_torch.models.model import RokoModel
from roko_tpu_torch.models.quant import maybe_quantize
from roko_tpu_torch.resilience import PolishJournal
from roko_tpu_torch.resilience.watchdog import thread_stack
from roko_tpu_torch.serve.metrics import ServeMetrics
from roko_tpu_torch.serve.scheduler import ContinuousBatcher
from roko_tpu_torch.serve.session import PolishSession
from roko_tpu_torch.utils.profiling import StageTimer, device_trace

# queue item tags (first tuple element)
_BLOCK, _DONE, _ERROR, _END = "block", "done", "error", "end"


class _OrderedFastaWriter:
    """Streams polished contigs to a FASTA file, accepting completions
    in ANY order but writing in a fixed canonical order (sorted names —
    the order the staged path's HDF5 iteration gives, so the streamed file
    is byte-identical to ``polish_to_fasta``'s): a contig is written the
    moment it and every contig ahead of it in the order are done, and
    held in RAM only until then. Local paths only."""

    def __init__(self, path: str, order: List[str], line_width: int = 80):
        self.path = path
        self._order = list(order)
        self._line_width = line_width
        self._next = 0
        self._ready: Dict[str, str] = {}
        self._fh = open(path, "w")

    def add(self, name: str, seq: str) -> None:
        self._ready[name] = seq
        while (
            self._next < len(self._order)
            and self._order[self._next] in self._ready
        ):
            cur = self._order[self._next]
            write_fasta_record(
                self._fh, cur, self._ready.pop(cur), self._line_width
            )
            self._next += 1
        self._fh.flush()

    def __enter__(self) -> "_OrderedFastaWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        self._fh.close()
        if exc_type is not None:
            # a failed run must not leave a valid-looking but truncated
            # FASTA behind: the staged path writes the file only after
            # full success, and resume-style pipelines gate on existence
            with contextlib.suppress(OSError):
                os.unlink(self.path)


class _RegionProducer:
    """Thread that drains the extraction fan-out into the bounded region
    queue (and optionally tees every block to a features HDF5).

    Per-contig region counts come from the source up front, so the
    producer can emit a ``("done", contig, total_windows)`` notice the
    moment a contig's LAST region block has been queued — whatever
    order regions complete in. ``skip`` names contigs whose blocks and
    done-notices are dropped here (the resume path: a journal-committed
    contig needs no votes)."""

    def __init__(
        self,
        source,
        q: "queue.Queue",
        timer: StageTimer,
        tee: Optional[DataWriter] = None,
        flush_every: int = 10,
        skip: Optional[set] = None,
    ):
        self.source = source
        self.q = q
        self.timer = timer
        self.tee = tee
        self.flush_every = flush_every
        self.skip = skip or set()
        self.stop = threading.Event()
        self.thread = threading.Thread(
            target=self._run, name="roko-stream-extract", daemon=True
        )

    def start(self) -> None:
        self.thread.start()

    def _put(self, item) -> bool:
        """Bounded put that gives up when the consumer is gone — an
        abandoned engine must not leave this thread parked on a full
        queue forever."""
        while not self.stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        remaining = dict(self.source.region_counts)
        totals: Dict[str, int] = {}
        regions_done = 0
        try:
            it = iter(self.source.results)
            while True:
                # the span measures time BLOCKED on extraction workers;
                # it runs concurrently with the device predict spans, so
                # sum(spans) > wall time under real overlap
                with self.timer("extract"):
                    try:
                        result = next(it)
                    except StopIteration:
                        break
                if self.stop.is_set():
                    return
                contig, pos, x, _ = result
                if contig in self.skip:
                    continue
                if self.tee is not None:
                    with self.timer("tee_hdf5"):
                        self.tee.store(contig, pos, x, None)
                        regions_done += 1
                        if regions_done % self.flush_every == 0:
                            self.tee.write()
                n = len(pos)
                if n:
                    totals[contig] = totals.get(contig, 0) + n
                    if not self._put((_BLOCK, contig, pos, x)):
                        return
                left = remaining.get(contig, 1) - 1
                remaining[contig] = left
                if left == 0:
                    if not self._put((_DONE, contig, totals.get(contig, 0))):
                        return
        except BaseException as e:  # propagate to the consumer side
            self._put((_ERROR, e))
            return
        self._put((_END, None))


def _journal_identity(cfg: RokoConfig, model: RokoModel) -> Dict[str, Any]:
    """Everything, besides ref/bam/seed, that the polished bytes depend
    on: the model weights and the window/extraction geometry. A resume
    against a journal whose identity differs would splice two different
    polishes into one FASTA, so the journal refuses it
    (:class:`JournalMismatch`).

    The weights hash covers the ``state_dict`` in sorted name order: each
    tensor's name, dtype, shape and CPU bytes. The JAX package hashes its
    parameter tree by tree paths instead, so a journal written by one
    package does not resume in the other."""
    h = hashlib.sha1()
    for name, tensor in sorted(model.state_dict().items()):
        arr = tensor.detach().cpu().contiguous().numpy()
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    sections = {name: getattr(cfg, name) for name in ("window", "read_filter", "region")}
    sections["model"] = model.cfg
    return {
        "params_sha1": h.hexdigest(),
        "config": {name: dataclasses.asdict(v) for name, v in sections.items()},
    }


def run_streaming_polish(
    ref_path: Optional[str],
    bam_x: Optional[str],
    model: Optional[RokoModel],
    cfg: Optional[RokoConfig] = None,
    *,
    out_path: Optional[str] = None,
    workers: int = 1,
    seed: int = 0,
    batch_size: int = 128,
    device: str | torch.device = "cuda",
    prefetch: Optional[int] = None,
    queue_regions: Optional[int] = None,
    batch_delay_ms: Optional[float] = None,
    tee_hdf5: Optional[str] = None,
    log=print,
    timer: Optional[StageTimer] = None,
    metrics: Optional[ServeMetrics] = None,
    session: Optional[PolishSession] = None,
    job_retries: int = 1,
    job_timeout: Optional[float] = None,
    region_source=None,
    resume: bool = False,
    trace_dir: Optional[str] = None,
) -> Dict[str, str]:
    """Polish ``ref_path``+``bam_x`` to ``{contig: sequence}`` with
    feature extraction, host batching and device inference overlapped;
    writes ``out_path`` incrementally (each contig lands as soon as its
    last window is voted) when given, and tees the extracted windows to a
    features HDF5 at ``tee_hdf5`` when given (the ``--keep-hdf5`` path).

    ``model`` runs on ``device`` in a :class:`PolishSession` whose ladder
    is the serve ladder capped at ``batch_size`` (``tail_rungs``);
    ``session`` injects a warm one instead (``model`` may then be None).
    ``region_source`` overrides the extraction fan-out with any object
    exposing ``refs``, ``region_counts`` and ``results`` (tests inject
    out-of-order and faulting sources through it). ``metrics`` (created
    when not given) accumulates the batcher's ``padding_efficiency``.

    When ``out_path`` is given every finished contig is durably committed
    to a sidecar journal (``<out>.resume/``) before it reaches the FASTA;
    ``resume=True`` reloads a matching journal, skips extraction for the
    committed contigs, and the final FASTA is byte-identical to an
    uninterrupted run."""
    if model is None:
        if session is None:
            raise ValueError("run_streaming_polish needs a model or a session")
        model = session.model
    # conversion-time int8 (models/quant.py) before the journal's identity
    # hash, which must cover the weights that predict; the session's own
    # maybe_quantize then finds the model quantized
    maybe_quantize(model)
    cfg = cfg or RokoConfig(model=model.cfg)
    pcfg = cfg.pipeline
    prefetch = pcfg.prefetch if prefetch is None else prefetch
    queue_regions = (
        pcfg.queue_regions if queue_regions is None else queue_regions
    )
    deadline_s = (
        pcfg.max_batch_delay_ms if batch_delay_ms is None else batch_delay_ms
    ) / 1e3
    timer = timer if timer is not None else StageTimer()

    if resume and not out_path:
        raise ValueError(
            "resume needs an output path: the journal lives beside it"
        )
    if resume and tee_hdf5:
        raise ValueError(
            "resume cannot tee a features HDF5: committed contigs are not "
            "re-extracted, so the tee would be missing their windows"
        )
    journal: Optional[PolishJournal] = None
    committed: Dict[str, Tuple[str, int]] = {}
    if out_path:
        journal = PolishJournal(out_path)
        committed = journal.open(
            dict(
                {"ref": str(ref_path), "bam": str(bam_x), "seed": seed},
                **_journal_identity(cfg, model),
            ),
            resume=resume,
            log=log,
        )

    with contextlib.ExitStack() as stack:
        stack.callback(lambda: journal and journal.close())
        if session is None:
            # built AFTER the journal opens, so a failure here leaves the
            # journal behind for --resume; no warmup: a rung runs (and on
            # the card builds its kernels) on its first dispatch, so a
            # short polish does not pay for rungs it never uses
            session = PolishSession(
                model, cfg, device=device,
                ladder=tail_rungs(resolve_ladder(cfg.serve, 1), batch_size, 1),
            )
        if region_source is None:
            region_source = stack.enter_context(
                open_region_stream(
                    ref_path, bam_x, workers=workers, seed=seed,
                    config=FeaturesConfig(cfg.window, cfg.read_filter, cfg.region),
                    log=log, job_retries=job_retries, job_timeout=job_timeout,
                    skip_contigs=set(committed) or None,
                )
            )
        contigs = {name: seq for name, seq in region_source.refs}
        board = VoteBoard(contigs)
        writer = (
            stack.enter_context(
                _OrderedFastaWriter(out_path, sorted(contigs))
            )
            if out_path
            else None
        )

        q: "queue.Queue" = queue.Queue(maxsize=max(1, queue_regions))
        producer = _RegionProducer(
            region_source, q, timer, skip=set(committed)
        )
        # the tee is NOT ExitStack-managed: only the producer thread
        # touches the h5py handle once that thread starts, so it must be
        # closed only after the thread is confirmed dead (closing an h5py
        # file under a live writer corrupts it — see the finally).
        # Opened last so no other setup failure can strand the handle.
        tee = None
        if tee_hdf5:
            tee = DataWriter(tee_hdf5, infer=True)
            tee.__enter__()
            try:
                tee.write_contigs(region_source.refs)
            except BaseException:
                tee.__exit__(None, None, None)
                raise
            producer.tee = tee

        # contig -> final window count, known once its last region has
        # been extracted ("done" notices); zero-region contigs are final
        # from the start and stitch to the unchanged draft immediately.
        # Journal-committed contigs are done before the run starts.
        final_counts: Dict[str, int] = {
            name: 0
            for name in contigs
            if name not in committed
            and region_source.region_counts.get(name, 0) == 0
        }
        voted: Dict[str, int] = {
            name: 0 for name in contigs if name not in committed
        }
        polished: Dict[str, str] = {
            name: seq for name, (seq, _) in committed.items()
        }
        if writer is not None:
            for name in sorted(committed):
                writer.add(name, polished[name])

        def finish_ready() -> None:
            # final_counts holds only extraction-complete, not-yet-
            # stitched contigs, so this scan is O(awaiting-stitch)
            done = [
                name for name, total_w in final_counts.items()
                if voted[name] >= total_w
            ]
            for name in done:
                del final_counts[name]
                with timer("stitch"):
                    seq = board.stitch(name)
                polished[name] = seq
                if journal is not None:
                    # durable commit BEFORE the (non-atomic) FASTA
                    # append: the journal, not the FASTA, is what a
                    # crashed run resumes from
                    with timer("journal"):
                        journal.commit(name, seq, voted[name])
                    log(
                        f"polish: committed contig {name} "
                        f"({voted[name]} windows)"
                    )
                if writer is not None:
                    with timer("write_fasta"):
                        writer.add(name, seq)

        metrics = metrics if metrics is not None else ServeMetrics()
        inflight_bound = max(2, prefetch)
        batcher = ContinuousBatcher(
            session,
            metrics=metrics,
            # the consumer's bounded lookahead (inflight_bound) is the
            # real admission control; headroom on top so submit() can
            # never bounce a block with Backpressure
            max_queue=inflight_bound + queue_regions + 2,
            max_queue_age_ms=deadline_s * 1e3,
        )

        #: submitted blocks whose predictions are not yet voted
        inflight: "deque[Tuple[str, Any, int, Any]]" = deque()

        def drain_one() -> int:
            """Vote the oldest in-flight block (blocking on its future);
            the span measures time BLOCKED on the device plane."""
            contig, pos, n, fut = inflight.popleft()
            with timer("predict+d2h"):
                # the session watchdog deadlines each device step; this
                # wait only has to catch a DEAD scheduler thread
                while True:
                    try:
                        preds = fut.result(15.0)
                        break
                    except TimeoutError:
                        if not batcher.scheduler_alive() and not fut.done():
                            raise RuntimeError(
                                "streaming polish: the batching-plane "
                                "scheduler thread died with predictions "
                                "outstanding; aborting the run"
                            ) from None
            with timer("vote"):
                board.add([contig] * n, pos, preds)
            voted[contig] += n
            finish_ready()
            return n

        n_windows = 0
        t0 = time.perf_counter()
        try:
            finish_ready()  # zero-region contigs stitch immediately
            producer.start()
            with device_trace(trace_dir, session.device):
                end = False
                while not end:
                    # completed futures vote eagerly (a contig-complete
                    # notice must not sit behind a grinding extractor)
                    while inflight and inflight[0][3].done():
                        n_windows += drain_one()
                    if len(inflight) >= inflight_bound:
                        n_windows += drain_one()
                        continue
                    try:
                        item = q.get(timeout=0.25)
                    except queue.Empty:
                        continue
                    tag = item[0]
                    if tag == _BLOCK:
                        _, contig, pos, x = item
                        inflight.append((contig, pos, len(pos), batcher.submit(x)))
                    elif tag == _DONE:
                        final_counts[item[1]] = item[2]
                        finish_ready()
                    elif tag == _ERROR:
                        raise item[1]
                    else:  # _END
                        end = True
                while inflight:
                    n_windows += drain_one()
        finally:
            batcher.stop()
            producer.stop.set()
            # unblock a producer parked on a full queue, then reap it
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            if producer.thread.ident is not None:  # start() was reached
                producer.thread.join(timeout=5.0)
                if producer.thread.is_alive():
                    # a long tee flush can outlive the first grace period
                    producer.thread.join(timeout=25.0)
                if producer.thread.is_alive():
                    stack_text = thread_stack(producer.thread)
                    log(
                        "WARNING: abandoning producer thread "
                        f"{producer.thread.name!r} still running 30s "
                        "after shutdown; it is stuck at:\n"
                        + (stack_text or "<thread exited during the dump>")
                    )
            if tee is not None and not producer.thread.is_alive():
                # else leave the handle open: closing h5py under a live
                # writer thread corrupts the file
                tee.__exit__(None, None, None)

        missing = [n for n in contigs if n not in polished]
        if missing:  # pragma: no cover - every clean end delivers a
            # done-notice per contig before _END
            raise RuntimeError(
                f"streaming polish ended with unfinished contigs: "
                f"{missing[:5]}{'...' if len(missing) > 5 else ''}"
            )
    if journal is not None:
        # the run is whole (writer closed cleanly above): the journal
        # has nothing left to protect. On any failure path we never get
        # here and the journal survives for --resume.
        journal.finalize()
    dt = time.perf_counter() - t0
    log(f"extracted {n_windows} windows")
    log(
        f"streaming polish: {n_windows} windows in {dt:.1f}s "
        f"({n_windows / max(dt, 1e-9):.0f} windows/s, "
        f"{n_windows * C.WINDOW_STRIDE / max(dt, 1e-9):.0f} bases/s)"
    )
    fill = metrics.fill_ratio()
    if fill is not None:
        log(
            f"streaming polish: padding_efficiency {fill:.3f} "
            f"(ladder {session.ladder}, dp={session.dp})"
        )
    timer.report(log)
    return {name: polished[name] for name in sorted(polished)}
