"""Region fan-out and feature/label generation driver (copy of
``roko_tpu/features/pipeline.py``).

Contigs are cut into 100 kb regions overlapping by 300 bp (roko's
features.py); each region is a job that yields windows (and labels in
training mode). :func:`open_region_stream` is the fan-out: a context
manager owning the worker pool that yields per-region result blocks.
:func:`run_features` buffers them per contig and flushes them to an HDF5
file every 10 finished regions (``features`` and ``polish --staged``);
``chip_smoke.py`` feeds them straight to the model.

Workers use the native extractor when it builds, else the Python one;
both give bitwise-equal windows for a seed. Inference with the native
extractor runs its jobs in threads (the C++ call releases the GIL);
otherwise in processes, which are spawned, not forked: the parent may
hold a CUDA context, and a fork after CUDA has started is unsafe.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from roko_tpu_torch import constants as C
from roko_tpu_torch.config import FeaturesConfig, RegionConfig
from roko_tpu_torch.data.hdf5 import DataWriter
from roko_tpu_torch.features import labels as L
from roko_tpu_torch.features.backend import (
    extract_region_arrays,
    extract_region_windows,
)
from roko_tpu_torch.features.labels import Region
from roko_tpu_torch.io.bam import BamReader
from roko_tpu_torch.io.fasta import read_fasta
from roko_tpu_torch.utils.rng import derive_region_seed


def generate_regions(
    ref_len: int, name: str, cfg: Optional[RegionConfig] = None
) -> Iterator[Region]:
    """100 kb regions with 300 bp overlap (roko/features.py:16-27)."""
    cfg = cfg or RegionConfig()
    i = 0
    while i < ref_len:
        end = i + cfg.size
        yield Region(name, i, min(end, ref_len))
        if end >= ref_len:
            break
        i = end - cfg.overlap


@dataclass
class _Job:
    bam_x: str
    bam_y: Optional[str]
    region: Region
    seed: int
    config: FeaturesConfig
    # draft slice covering [region.start, region.end), shipped to
    # workers only when config.window.ref_rows > 0 (the draft-base rows
    # need it). A slice, not the contig: per-job IPC stays O(region)
    # instead of O(contig) x regions.
    ref_seq: Optional[str] = None
    ref_seq_offset: int = 0


def _is_in_region(pos: int, aligns: Sequence[L.TargetAlign]) -> bool:
    return any(a.start <= pos < a.end for a in aligns)


def _empty_arrays(config: FeaturesConfig):
    w = config.window
    return (
        np.empty((0, w.cols, 2), np.int64),
        np.empty((0, w.rows, w.cols), np.uint8),
    )


def generate_infer(job: _Job):
    """Feature windows for one region, inference mode
    (ref: roko/features.py:97-110). Returns stacked arrays — two
    contiguous buffers cross the worker boundary, not N small ones."""
    region = job.region
    positions, examples = extract_region_arrays(
        job.bam_x,
        region.name,
        region.start,
        region.end,
        job.seed,
        job.config.window,
        job.config.read_filter,
        ref_seq=job.ref_seq,
        ref_seq_offset=job.ref_seq_offset,
    )
    return region.name, positions, examples, None


def generate_train(job: _Job):
    """Feature windows + labels for one region, training mode
    (ref: roko/features.py:37-94)."""
    region = job.region
    with BamReader(job.bam_y) as truth:
        alignments = L.get_aligns(
            truth, ref_name=region.name, start=region.start, end=region.end
        )
    filtered = L.filter_aligns(alignments)
    if not filtered:
        return None

    positions, examples, labels = [], [], []

    for a in filtered:
        pos_labels = {}
        n_pos = set()

        t_pos, t_labels = L.get_pos_and_labels(a, region)
        for p, lab in zip(t_pos, t_labels):
            if lab == C.ENCODED_UNKNOWN:
                n_pos.add(p)
            else:
                pos_labels[p] = lab
        if not pos_labels:
            continue

        pos_sorted = sorted(pos_labels)
        # labeled span, end-exclusive: the last labeled position is
        # excluded, matching the reference's 1-based region string
        # `start+1`-`last` (ref: roko/features.py:62-63)
        span_start, span_end = pos_sorted[0][0], pos_sorted[-1][0]
        if span_end <= span_start:
            continue

        windows = extract_region_windows(
            job.bam_x,
            region.name,
            span_start,
            span_end,
            job.seed,
            job.config.window,
            job.config.read_filter,
            ref_seq=job.ref_seq,
            ref_seq_offset=job.ref_seq_offset,
        )

        for w in windows:
            Y = []
            keep = True
            for p in map(tuple, w.positions):
                if not _is_in_region(p[0], filtered):
                    raise AssertionError(
                        f"window position {p} outside filtered truth alignments"
                    )
                if p in n_pos:
                    keep = False
                    break
                try:
                    y = pos_labels[p]
                except KeyError:
                    if p[1] != 0:
                        # unlabeled insertion slot: the truth has no base
                        # there -> GAP (ref: roko/features.py:81-84)
                        y = C.ENCODED_GAP
                    else:
                        raise KeyError(f"no label mapping for position {p}")
                Y.append(y)

            if keep:
                positions.append(w.positions)
                examples.append(w.matrix)
                labels.append(np.asarray(Y, dtype=np.int64))

    if not positions:
        return region.name, *_empty_arrays(job.config), np.empty((0, job.config.window.cols), np.int64)
    return (
        region.name,
        np.stack(positions),
        np.stack(examples),
        np.stack(labels),
    )


def _use_thread_pool(inference: bool) -> bool:
    """Threads beat processes only when the per-region work releases the
    GIL: the C++ extractor does, but train-mode labeling
    (``generate_train``) is GIL-bound Python around it — a ThreadPool
    there loses most multi-core scaling."""
    from roko_tpu_torch.features.backend import _native_available

    return inference and _native_available()


@dataclass
class RegionStream:
    """A live region fan-out: per-region result blocks plus the metadata
    both consumers need before the first result lands.

    ``results`` yields ``(contig, positions, examples, labels)`` per
    region in job order (``None`` for skipped train-mode regions);
    ``region_counts`` maps contig -> region job count, so a streaming
    consumer can tell when a contig's last region has arrived whatever
    order results come back in."""

    refs: List[Tuple[str, str]]
    jobs: List[_Job]
    results: Iterator
    inference: bool
    region_counts: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if not self.region_counts:
            self.region_counts = dict(
                Counter(j.region.name for j in self.jobs)
            )


def run_features(
    ref_path: str,
    bam_x: str,
    out_path: str,
    bam_y: Optional[str] = None,
    workers: int = 1,
    seed: int = 0,
    config: Optional[FeaturesConfig] = None,
    flush_every: int = 10,
    log=print,
    job_retries: int = 1,
    job_timeout: Optional[float] = None,
) -> int:
    """Generate a features HDF5. Returns the number of windows written.

    ``bam_x``/``bam_y`` may also be SAM text files (htslib reads either
    transparently — models.cpp:37-44 — so the CLI contract matches):
    they are converted once to temp coordinate-sorted BAM+BAI so the
    native extractor and region fetches work identically. NB the
    conversion sorts in memory — fine for the modest SAMs this is for;
    genome-scale runs should hand over BAMs, which stream.
    """
    import time

    with open_region_stream(
        ref_path, bam_x, bam_y=bam_y, workers=workers, seed=seed,
        config=config, log=log, job_retries=job_retries,
        job_timeout=job_timeout,
    ) as stream:
        total = 0
        with DataWriter(out_path, stream.inference) as data:
            data.write_contigs(stream.refs)
            t0 = time.perf_counter()
            done = 0
            for result in stream.results:
                done += 1
                # progress heartbeat: a 5-species feature run is hours —
                # report every flush batch (ref printed per region,
                # roko/features.py:139; one line per flush is quieter)
                if done % flush_every == 0:
                    dt = time.perf_counter() - t0
                    rate = done / max(dt, 1e-9)
                    log(
                        f"features: {done}/{len(stream.jobs)} regions, "
                        f"{total} windows "
                        f"({rate:.1f} regions/s, eta {(len(stream.jobs) - done) / max(rate, 1e-9):.0f}s)"
                    )
                    data.write()
                if not result:
                    continue
                contig, p, x, y = result
                data.store(contig, p, x, y)
                total += len(p)
            data.write()
    return total


def _ensure_bam(path: str, stack) -> str:
    """Pass BAMs through; convert SAM text to a temp sorted BAM+BAI.
    A store URL is downloaded first (cached, atomic, its ``.bai`` with
    it): the native reader needs a real file name."""
    from roko_tpu_torch.datapipe.io import ensure_local

    path = ensure_local(path)
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":  # BGZF (BAM) — use as-is
        return path
    import tempfile

    from roko_tpu_torch.io.bam import write_sorted_bam
    from roko_tpu_torch.io.sam import SamReader

    tmpdir = stack.enter_context(tempfile.TemporaryDirectory())
    out = os.path.join(
        tmpdir, os.path.basename(path).rsplit(".", 1)[0] + ".bam"
    )
    with SamReader(path) as r:
        write_sorted_bam(out, r.references, list(r))
    return out


def _recovering_results(results, func, jobs, retries, timeout, log, pool=None):
    """Failure detection/recovery for the region fan-out.

    Region jobs are pure functions of (bam paths, region, seed), so a
    failed or lost job is safely re-runnable with identical output. Two
    failure classes are handled:

    - a job that RAISES (worker exception propagates through imap/map):
      re-run it in the parent up to ``retries`` times before giving up
      and re-raising — transient faults (OOM-killed sibling, flaky
      filesystem) don't abort an hours-long multi-species run;
    - a job whose worker process DIED (``imap`` would block forever on
      the lost result): when ``timeout`` is set and ``pool`` is a
      process pool, each result wait is bounded; on a timeout the pool
      is terminated and the remainder recomputed in the parent. Opt-in
      because the bound must exceed the slowest honest region, and
      process-pools only (threads cannot die out from under the queue).
    """
    import multiprocessing as mp

    from roko_tpu_torch.resilience.retry import RetryPolicy

    # region jobs are pure and cheap to re-dispatch, so the shared
    # policy runs with zero backoff: the retry IS the recovery, there
    # is no remote rate limit to be polite to
    policy = RetryPolicy(
        max_attempts=max(1, retries), base_delay_s=0.0, jitter=0.0,
        retryable=(Exception,),
    )

    def rerun(job, err):
        def describe(e):
            log(
                f"features: region {job.region.name}:{job.region.start} "
                f"failed ({type(e).__name__}: {e}); "
                f"retry {describe.attempt}/{retries} in the parent"
            )
            describe.attempt += 1

        describe.attempt = 1
        if retries <= 0:
            raise err
        describe(err)  # the pool-side failure that brought us here
        return policy.call(
            lambda: func(job),
            on_retry=lambda failures, e, delay: describe(e),
        )

    it = iter(results)
    can_timeout = (
        timeout is not None and pool is not None and hasattr(it, "next")
    )
    broken = False
    for i, job in enumerate(jobs):
        if broken:
            # pool results are untrustworthy after a lost-result event
            # (any late arrival would mis-align with later jobs) —
            # finish the remainder sequentially in the parent
            try:
                yield func(job)
            except Exception as e:
                yield rerun(job, e)
            continue
        try:
            result = it.next(timeout) if can_timeout else next(it)
        except StopIteration:  # pragma: no cover - defensive
            raise RuntimeError(
                f"result stream ended early at job {i}/{len(jobs)}"
            ) from None
        except mp.TimeoutError:
            log(
                f"features: region {job.region.name}:{job.region.start} "
                f"result not ready after {timeout}s (worker died?); "
                "abandoning the pool — remaining regions run in the parent"
            )
            broken = True
            # kill the orphaned workers NOW: left running they would
            # chew through every queued region in parallel with the
            # parent's recompute, wasting cores and I/O for the whole
            # recovery tail (results would be discarded anyway)
            pool.terminate()
            try:
                yield func(job)
            except Exception as e:
                yield rerun(job, e)
            continue
        except Exception as e:
            result = rerun(job, e)
        yield result


@contextlib.contextmanager
def open_region_stream(
    ref_path: str,
    bam_x: str,
    bam_y: Optional[str] = None,
    *,
    workers: int = 1,
    seed: int = 0,
    config: Optional[FeaturesConfig] = None,
    log=print,
    job_retries: int = 1,
    job_timeout: Optional[float] = None,
    skip_contigs: Optional[set] = None,
) -> Iterator[RegionStream]:
    """Open the region fan-out and yield a :class:`RegionStream`.

    ``skip_contigs`` names contigs to generate NO region jobs for (the
    crash-resume path: contigs already committed in a polish journal
    must not be re-extracted); they stay in ``refs`` so consumers keep
    the full draft picture.

    Owns the whole extraction lifecycle: SAM->BAM conversion temp files,
    pool creation, the failure-recovery wrapper, and pool teardown on
    exit (terminate for process pools — after a lost-result event the
    stream was deliberately abandoned and a hung worker would block
    ``join`` forever; close/join for thread pools, whose threads cannot
    die out from under the queue)."""
    config = config or FeaturesConfig()
    with contextlib.ExitStack() as stack:
        bam_x = _ensure_bam(bam_x, stack)
        if bam_y is not None:
            bam_y = _ensure_bam(bam_y, stack)
        inference = bam_y is None
        refs = read_fasta(ref_path)

        jobs: List[_Job] = []
        for name, seq in refs:
            if skip_contigs and name in skip_contigs:
                continue
            for region in generate_regions(len(seq), name, config.region):
                jobs.append(
                    _Job(
                        bam_x=bam_x,
                        bam_y=bam_y,
                        region=region,
                        seed=derive_region_seed(seed, name, region.start),
                        config=config,
                        ref_seq=(
                            seq[region.start : region.end]
                            if config.window.ref_rows > 0
                            else None
                        ),
                        ref_seq_offset=region.start,
                    )
                )

        func = generate_infer if inference else generate_train
        is_thread_pool = False
        if workers <= 1:
            results = map(func, jobs)
            pool = None
        elif _use_thread_pool(inference):
            # the C++ extractor releases the GIL, so threads give
            # full parallelism with zero IPC (results stay in-process
            # — no pickling of the window buffers)
            from multiprocessing.pool import ThreadPool

            pool = ThreadPool(processes=workers)
            results = pool.imap(func, jobs)
            is_thread_pool = True
        else:
            pool = multiprocessing.get_context("spawn").Pool(processes=workers)
            results = pool.imap(func, jobs)
        # job_timeout applies only to PROCESS pools: a thread cannot die
        # out from under the queue (the failure class the timeout
        # detects), and abandoning a ThreadPool would deadlock the
        # close/join on any genuinely hung thread — say so rather than
        # silently ignoring an explicit flag
        if job_timeout is not None and (is_thread_pool or pool is None):
            log(
                "--job-timeout applies only to process pools; ignored on "
                + ("the thread-pool path" if is_thread_pool else "serial runs")
            )
        results = _recovering_results(
            results, func, jobs, job_retries, job_timeout, log,
            pool=None if is_thread_pool else pool,
        )
        try:
            yield RegionStream(
                refs=refs, jobs=jobs, results=results, inference=inference
            )
        finally:
            if pool is not None:
                if is_thread_pool:
                    pool.close()
                    pool.join()
                else:
                    pool.terminate()
                    pool.join()
