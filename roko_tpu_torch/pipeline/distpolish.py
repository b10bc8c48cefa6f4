"""The distributed polish: the worker fleet as a fault-tolerant batch
compute tier (``python -m roko_tpu_torch polish --distributed``, and
``POST /job`` on a fleet's supervisor); the port's copy of
``roko_tpu/pipeline/distpolish.py``.

A whole-genome polish in one process loses the whole run when that
process dies. Here the same path (the extraction fan-out, a warm
``PolishSession``, the continuous batcher, the ``VoteBoard`` stitch) runs
as a map-reduce over the fleet (``serve/fleet.py``): a job is a
deterministically resumable set of work units, and any participant's
death costs one unit's re-run.

**Units.** :func:`split_units` cuts the draft on the extraction region
table the single-process fan-out walks: one unit per contig, and
contigs longer than ``distpolish.unit_bases`` into several region-aligned
SPAN units. A whole-contig unit runs end to end on one worker (extract,
predict, stitch), the single process's stitch byte for byte, since votes
are order-free sums and the predict step does not depend on what else
shares its batch. A span unit returns its raw per-window predictions; the
coordinator folds every span of the contig into ONE
:class:`~roko_tpu_torch.infer.VoteBoard` and stitches once: the single
process's vote set, however the contig was split.

**Failures.**

- a worker SIGKILLed mid-unit: the dispatch fails at the connection; the
  unit goes to a survivor with the dead worker excluded (the fleet's own
  supervision restarts the dead one). Cost: that unit's re-run.
- a poison unit: a unit that fails ``distpolish.unit_attempts`` attempts
  on distinct workers is QUARANTINED: recorded durably in the journal's
  ledger, announced, and the job fails naming the contig after the
  healthy rest commits; never a silent gap in the FASTA.
- the coordinator SIGKILLed mid-job: every finished unit and contig is
  already durably committed (the commit precedes the FASTA append);
  ``--resume`` replays the journal and dispatches only what is missing.
- a draining or degraded fleet: a 503 parks the unit (no attempt spent)
  and the in-flight limit follows the READY worker count; while the
  autoscaler sets ``fleet.jobs_parked`` no new unit is dispatched.

The journal (``resilience/journal.py``) is the streaming polish's, with
its unit ledger; its identity covers the model config (``model.quantize``
included) and the fleet's model version and weights, so a ``--resume``
under other weights, another quantize mode or a rolled-out version is
refused instead of splicing two models' contigs into one FASTA.

The coordinator never touches the card: only its workers load the model.
This module imports no torch; the stitch (``infer.VoteBoard``) and the
FASTA writer are imported where a job uses them. Store URLs (``gs://``,
``s3://``, ``http(s)://``) work for the draft, the BAM and the output: a
store BAM ships to the workers as its URL and each worker downloads it
through the store client's cache, and the final FASTA uploads through
``open_output`` when the job ends whole.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import http.client
import json
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from roko_tpu_torch.config import RegionConfig, RokoConfig
from roko_tpu_torch.features.pipeline import generate_regions
from roko_tpu_torch.io.fasta import read_fasta
from roko_tpu_torch.obs import events as obs_events
from roko_tpu_torch.resilience import PolishJournal, RetryPolicy

Log = Callable[[str], None]
#: ``transport(port, payload, timeout) -> (http_status, body_bytes)``;
#: connection-level failures raise (OSError / HTTPException /
#: TimeoutError) — the injection point tests use to simulate worker
#: death without a process
Transport = Callable[[int, Dict[str, Any], float], Tuple[int, bytes]]


class PoisonedUnit(RuntimeError):
    """A work unit failed its whole attempt budget on distinct workers:
    the contig is quarantined and the job fails NAMING it (the journal
    ledger keeps the evidence; committed contigs survive for
    ``--resume``)."""

    def __init__(self, unit: "WorkUnit", last_error: str):
        super().__init__(
            f"distributed polish: contig {unit.contig!r} (unit "
            f"{unit.uid}) failed {unit.failures} attempt(s) on distinct "
            f"workers and is quarantined; last error: {last_error}. "
            "Committed contigs are journaled — fix the input/worker and "
            "rerun with --resume to retry only the quarantined unit(s)."
        )
        self.contig = unit.contig
        self.uid = unit.uid


class WorkUnit:
    """One dispatchable slice of a polish job: a contig's full region
    table (``whole=True``) or a region-aligned span of a giant contig.
    Identity (``uid``) is a pure function of (contig, region slice), so
    a resumed run re-derives the same unit set and matches it against
    the journal ledger."""

    def __init__(
        self,
        contig: str,
        first_region: int,
        n_regions: int,
        start: int,
        end: int,
        whole: bool,
    ):
        self.contig = contig
        self.first_region = first_region
        self.n_regions = n_regions
        self.start = start
        self.end = end
        self.whole = whole
        self.state = "pending"  # pending|inflight|committed|quarantined
        self.failures = 0       # failed attempts (503 parks don't count)
        self.excluded: List[int] = []  # worker ids that failed this unit
        self.worker: Optional[int] = None
        self.windows = 0
        self.retry_at = 0.0     # monotonic backoff gate
        self.last_error = ""

    @property
    def uid(self) -> str:
        return f"{self.contig}@{self.first_region}+{self.n_regions}"

    def describe(self) -> Dict[str, Any]:
        return {
            "contig": self.contig,
            "span": [self.start, self.end],
            "regions": [self.first_region,
                        self.first_region + self.n_regions],
            "whole": self.whole,
            "state": self.state,
            "attempts": self.failures,
            "worker": self.worker,
            "windows": self.windows,
        }


def split_units(
    refs: Sequence[Tuple[str, str]],
    region_cfg: Optional[RegionConfig] = None,
    unit_bases: int = 0,
) -> List[WorkUnit]:
    """Cut the draft into work units along the deterministic
    extraction-region table. ``unit_bases`` > 0 splits contigs longer
    than it into span units of at most that many draft bases, each a
    contiguous run of whole regions — the union of the units' windows
    is EXACTLY the single-process window set (same region boundaries,
    same per-region seeds), which is what makes the merged output
    byte-identical."""
    units: List[WorkUnit] = []
    for name, seq in refs:
        regions = list(generate_regions(len(seq), name, region_cfg))
        if not regions:
            # zero-length contig: nothing to extract; the draft passes
            # through unchanged (committed locally, never dispatched)
            units.append(WorkUnit(name, 0, 0, 0, len(seq), True))
            continue
        if unit_bases <= 0 or len(seq) <= unit_bases:
            units.append(
                WorkUnit(name, 0, len(regions), 0, len(seq), True)
            )
            continue
        i = 0
        while i < len(regions):
            j = i + 1
            # greedy: widest run of whole regions under the budget (a
            # single oversized region still becomes one unit — span
            # boundaries must stay ON the region table)
            while (
                j < len(regions)
                and regions[j].end - regions[i].start <= unit_bases
            ):
                j += 1
            units.append(
                WorkUnit(
                    name, i, j - i,
                    regions[i].start, regions[j - 1].end,
                    whole=(i == 0 and j == len(regions)),
                )
            )
            i = j
    return units


#: per-process draft cache for worker-side unit extraction: one parse
#: of the reference FASTA serves every unit of a job instead of
#: O(units x genome) re-reads on a long-lived worker. Keyed by
#: (path, mtime, size) so a replaced file invalidates; bounded to the
#: last file (jobs polish one genome at a time).
_REF_CACHE: Dict[Tuple[str, float, int], Dict[str, str]] = {}
_REF_CACHE_LOCK = threading.Lock()


def _cached_refs(ref_path: str) -> Dict[str, str]:
    st = os.stat(ref_path)
    key = (os.path.realpath(ref_path), st.st_mtime, st.st_size)
    with _REF_CACHE_LOCK:
        cached = _REF_CACHE.get(key)
    if cached is not None:
        return cached
    refs = dict(read_fasta(ref_path))
    with _REF_CACHE_LOCK:
        _REF_CACHE.clear()
        _REF_CACHE[key] = refs
    return refs


def extract_unit_windows(
    ref_path: str,
    bam: str,
    contig: str,
    first_region: int,
    n_regions: int,
    seed: int,
    cfg: RokoConfig,
) -> Tuple[str, np.ndarray, np.ndarray]:
    """Worker-side unit extraction: ``(draft_seq, positions, examples)``
    for one unit's region slice. The region table and per-region seeds
    are re-derived from (contig length, config, job seed) exactly as
    the single-process fan-out derives them, so the windows are
    bit-identical to the ones an undistributed run extracts."""
    from roko_tpu_torch.datapipe.io import ensure_local
    from roko_tpu_torch.features.pipeline import _Job, generate_infer
    from roko_tpu_torch.utils.rng import derive_region_seed

    # the native BAM reader and the per-process ref cache below want a
    # real file name: store URLs download ONCE per worker process (cached,
    # atomic), so every unit of that worker reads local bytes
    ref_path = ensure_local(ref_path)
    bam = ensure_local(bam)
    seq = _cached_refs(ref_path).get(contig)
    if seq is None:
        raise ValueError(f"contig {contig!r} not present in {ref_path}")
    regions = list(generate_regions(len(seq), contig, cfg.region))
    if not (
        0 <= first_region
        and n_regions >= 0
        and first_region + n_regions <= len(regions)
    ):
        raise ValueError(
            f"unit regions [{first_region}, {first_region + n_regions}) "
            f"outside contig {contig!r}'s {len(regions)}-region table "
            "(the coordinator and worker disagree on the region config)"
        )
    pos_blocks, x_blocks = [], []
    for region in regions[first_region:first_region + n_regions]:
        job = _Job(
            bam_x=bam,
            bam_y=None,
            region=region,
            seed=derive_region_seed(seed, contig, region.start),
            config=cfg,
            ref_seq=(
                seq[region.start:region.end]
                if cfg.window.ref_rows > 0
                else None
            ),
            ref_seq_offset=region.start,
        )
        _, p, x, _ = generate_infer(job)
        if len(p):
            pos_blocks.append(p)
            x_blocks.append(x)
    if not pos_blocks:
        w = cfg.window
        return (
            seq,
            np.empty((0, w.cols, 2), np.int64),
            np.empty((0, w.rows, w.cols), np.uint8),
        )
    return seq, np.concatenate(pos_blocks), np.concatenate(x_blocks)


# -- wire helpers (base64 raw little-endian, the serve wire format) ----------

def b64_array(arr: np.ndarray, dtype) -> str:
    return base64.b64encode(
        np.ascontiguousarray(
            arr, dtype=np.dtype(dtype).newbyteorder("<")
        ).tobytes()
    ).decode("ascii")


def _decode_array(text: str, dtype, shape: Tuple[int, ...]) -> np.ndarray:
    buf = base64.b64decode(text.encode("ascii"), validate=True)
    arr = np.frombuffer(buf, dtype=np.dtype(dtype).newbyteorder("<"))
    return arr.astype(dtype, copy=False).reshape(shape)


def _http_transport(
    port: int, payload: Dict[str, Any], timeout: float
) -> Tuple[int, bytes]:
    """One POST /polish to one worker's port, no retries here (the
    coordinator owns retry/exclusion policy). The timeout is the
    per-unit deadline — the watchdog shape: a hung worker surfaces as
    a LOUD failed attempt, never a silent park (fleet heartbeats kill
    the hang independently)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(
            "POST", "/polish",
            body=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


# -- journal identity --------------------------------------------------------

def checkpoint_fingerprint(path: str) -> str:
    """sha256 over a checkpoint's file bytes (sorted relative paths
    mixed in): the coordinator's stand-in for the single-process
    journal's params hash — it never loads the params (workers do), but
    a resume against different weight BYTES must still refuse."""
    h = hashlib.sha256()

    def eat(full: str) -> None:
        with open(full, "rb") as fh:
            while True:
                chunk = fh.read(1 << 20)
                if not chunk:
                    break
                h.update(chunk)

    if os.path.isdir(path):
        # sorted() materializes the walk, so the (root, dirs, files)
        # triples are already in deterministic root order
        for root, _dirs, files in sorted(os.walk(path)):
            for fname in sorted(files):
                full = os.path.join(root, fname)
                h.update(os.path.relpath(full, path).encode())
                h.update(b"\0")
                eat(full)
    else:
        eat(path)
    return h.hexdigest()


def distributed_meta(
    ref: str,
    bam: str,
    seed: int,
    cfg: RokoConfig,
    model_identity: Dict[str, Any],
) -> Dict[str, Any]:
    """Everything the distributed FASTA's bytes depend on, journal-side:
    inputs, the window/extraction geometry, the model config (which
    carries ``quantize``), and the fleet's model identity (version +
    params fingerprint or bundle digest). A resume whose identity
    differs — int8 weights where the journal saw f32, a rolled-out new
    version — is refused (:class:`JournalMismatch`), never spliced."""
    return {
        "mode": "distributed",
        "ref": str(ref),
        "bam": str(bam),
        "seed": seed,
        "config": {
            name: dataclasses.asdict(getattr(cfg, name))
            for name in ("window", "read_filter", "region", "model")
        },
        # unit geometry is identity too: the ledger's unit uids derive
        # from the split, so a resume under a different --unit-bases
        # would silently miss every committed span unit and throw the
        # work away — refuse instead
        "unit_bases": cfg.distpolish.unit_bases,
        # explicit even though config.model carries it: the refusal
        # axis, kept greppable in meta.json
        "quantize": cfg.model.quantize,
        "model": dict(model_identity),
    }


# -- the coordinator ---------------------------------------------------------

class DistPolishJob:
    """Dispatch a unit set over a fleet, commit results through the
    journal, and stream the FASTA — byte-identical under any kill.

    The fleet dependency is narrow (``pick(exclude)``, ``ready_count``,
    ``workers``, the ``_draining`` flag) so tests drive the full
    retry/exclusion/quarantine state machine with a fake fleet and a
    fake transport — no processes, no HTTP."""

    def __init__(
        self,
        fleet,
        cfg: RokoConfig,
        *,
        ref: str,
        bam: str,
        seed: int,
        refs: Sequence[Tuple[str, str]],
        units: Sequence[WorkUnit],
        journal: Optional[PolishJournal] = None,
        writer=None,
        committed: Optional[Dict[str, str]] = None,
        transport: Optional[Transport] = None,
        log: Log = print,
    ):
        self.fleet = fleet
        self.cfg = cfg
        self.ref, self.bam, self.seed = ref, bam, seed
        self.refs = dict(refs)
        self.units = list(units)
        self.journal = journal
        self.writer = writer
        self.polished: Dict[str, str] = dict(committed or {})
        self._transport = transport or _http_transport
        self._log = log
        self._lock = threading.Lock()
        self.state = "running"
        self.reason: Optional[str] = None
        self._poisoned: List[Tuple[WorkUnit, str]] = []
        #: backoff shape for failed attempts (delay only; the attempt
        #: budget itself is ``distpolish.unit_attempts``)
        self._backoff = RetryPolicy(
            base_delay_s=0.5, max_delay_s=15.0, jitter=0.1
        )
        # reduce-side state for span-split contigs
        self._boards: Dict[str, Any] = {}
        self._span_left: Dict[str, int] = {}
        self._span_windows: Dict[str, int] = {}
        for u in self.units:
            if not u.whole:
                self._span_left[u.contig] = (
                    self._span_left.get(u.contig, 0) + 1
                )

    # -- observability ------------------------------------------------------

    def active(self) -> bool:
        with self._lock:
            return self.state in ("starting", "running")

    def snapshot(self) -> Dict[str, Any]:
        """The ``GET /jobz`` body: job state plus per-unit state —
        advisory reads of live fields (the commit path is the source of
        truth; this endpoint exists so an operator can see every unit's
        terminal state without grepping the event log)."""
        units = {u.uid: u.describe() for u in self.units}
        counts: Dict[str, int] = {}
        for u in self.units:
            counts[u.state] = counts.get(u.state, 0) + 1
        with self._lock:
            state, reason = self.state, self.reason
        body: Dict[str, Any] = {
            "state": state,
            "units": units,
            "counts": counts,
            "contigs_done": len(self.polished),
            "contigs_total": len(self.refs),
        }
        if reason:
            body["reason"] = reason
        return body

    # -- resume -------------------------------------------------------------

    def _restore_ledger(self) -> None:
        """Fold the journal's unit ledger into the fresh unit set:
        committed span units reload their predictions into the contig's
        board (no re-run); a committed unit whose ``.npz`` vanished
        simply re-runs. Attempt budgets reset — resume exists so the
        operator can retry after fixing something."""
        if self.journal is None:
            return
        ledger = self.journal.load_units()
        for u in self.units:
            rec = ledger.get(u.uid)
            if not rec or rec.get("state") != "committed" or u.whole:
                continue
            loaded = self.journal.load_unit_preds(rec)
            if loaded is None:
                continue
            positions, preds = loaded
            n = int(rec.get("windows", len(positions)))
            self._vote_span(u, positions, preds, n)
            u.state = "committed"
            u.windows = n
            self._log(
                f"distpolish: resume reloaded unit {u.uid} "
                f"({n} windows) from the journal ledger"
            )

    # -- scheduling ---------------------------------------------------------

    def _hard_cap(self) -> int:
        d = self.cfg.distpolish
        return d.max_inflight_units or (
            d.inflight_per_worker * max(1, len(self.fleet.workers))
        )

    def _inflight_limit(self) -> int:
        """Units the fleet may carry RIGHT NOW: scales with the ready
        worker count so a degraded fleet degrades the job (fewer units
        in flight) and a draining one parks it, instead of failing."""
        if getattr(self.fleet, "_draining", False):
            return 0
        if getattr(self.fleet, "jobs_parked", False):
            # the autoscaler parked background work while interactive
            # backlog spikes: stop dispatching NEW units (in-flight ones
            # finish and commit to the journal), resume when unparked —
            # at most one contig re-runs across the park
            return 0
        ready = self.fleet.ready_count()
        if ready == 0:
            return 0
        return min(
            self._hard_cap(),
            self.cfg.distpolish.inflight_per_worker * ready,
        )

    def run(self) -> Dict[str, str]:
        d = self.cfg.distpolish
        self._restore_ledger()
        # zero-region contigs never dispatch: the draft passes through
        for u in self.units:
            if u.state == "pending" and u.n_regions == 0:
                self._commit_contig(u, self.refs[u.contig], 0)
                u.state = "committed"
        pending = deque(u for u in self.units if u.state == "pending")
        inflight: Dict[str, Tuple[WorkUnit, Any, Any]] = {}
        pool = ThreadPoolExecutor(
            max_workers=self._hard_cap(),
            thread_name_prefix="roko-distpolish",
        )
        no_capacity_since: Optional[float] = None
        try:
            while pending or inflight:
                now = time.monotonic()
                limit = self._inflight_limit()
                if (
                    limit > 0 or inflight
                    or getattr(self.fleet, "jobs_parked", False)
                ):
                    # a PARKED job is waiting by design, not starved —
                    # the no-ready-worker abort timer must not run
                    no_capacity_since = None
                elif no_capacity_since is None:
                    no_capacity_since = now
                elif now - no_capacity_since > d.ready_timeout_s:
                    raise RuntimeError(
                        "distributed polish: no ready worker for "
                        f"{d.ready_timeout_s:.0f}s with {len(pending)} "
                        "unit(s) outstanding; aborting (committed work "
                        "is journaled for --resume)"
                    )
                progressed = self._schedule(pending, inflight, pool, limit)
                progressed |= self._reap(pending, inflight)
                if not progressed:
                    time.sleep(d.park_poll_s)
            if self._poisoned:
                unit, err = self._poisoned[0]
                with self._lock:
                    self.state = "failed"
                    self.reason = (
                        f"quarantined contig(s): "
                        + ", ".join(u.contig for u, _ in self._poisoned)
                    )
                obs_events.emit(
                    "job", "job_failed", log=self._log,
                    quarantined=len(self._poisoned),
                    committed=len(self.polished),
                    contig=unit.contig,
                )
                raise PoisonedUnit(unit, err)
            with self._lock:
                self.state = "done"
            obs_events.emit(
                "job", "job_done", log=self._log,
                units=len(self.units),
                committed=sum(
                    1 for u in self.units if u.state == "committed"
                ),
                contigs=len(self.polished),
            )
            return dict(self.polished)
        except PoisonedUnit:
            raise
        except BaseException as e:
            with self._lock:
                self.state = "failed"
                self.reason = self.reason or f"{type(e).__name__}: {e}"
            raise
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    def _schedule(self, pending, inflight, pool, limit) -> bool:
        progressed = False
        now = time.monotonic()
        per = self.cfg.distpolish.inflight_per_worker
        for _ in range(len(pending)):
            if len(inflight) >= limit:
                break
            # per-worker capacity: never stack more than
            # inflight_per_worker units on one worker — both load
            # balance AND blast radius (a SIGKILLed worker loses at
            # most that many units)
            loads: Dict[int, int] = {}
            for uu, ww, _f in inflight.values():
                loads[ww.id] = loads.get(ww.id, 0) + 1
            busy = [wid for wid, c in loads.items() if c >= per]
            u = pending[0]
            if u.retry_at > now:
                pending.rotate(-1)
                continue
            picked = self.fleet.pick(exclude=[*u.excluded, *busy])
            if picked is None:
                if u.excluded and self.fleet.pick(exclude=busy) is not None:
                    # every NON-busy ready worker already failed this
                    # unit: the exclusion memory exists to stop
                    # ping-pong between two workers, not to starve the
                    # unit — clear it and let the attempt budget bound
                    # a true poison
                    self._log(
                        f"distpolish: unit {u.uid} has excluded every "
                        "ready worker; clearing exclusions for the next "
                        "attempt"
                    )
                    u.excluded = []
                    continue
                pending.rotate(-1)
                continue
            w, port = picked
            pending.popleft()
            u.state = "inflight"
            u.worker = w.id
            attempt = u.failures + 1
            if self.journal is not None:
                self.journal.unit_event(
                    u.uid, "attempt", attempts=attempt, worker=w.id
                )
            obs_events.emit(
                "job", "unit_dispatch", quiet=True,
                unit=u.uid, contig=u.contig, worker=w.id, attempt=attempt,
            )
            payload = {
                "ref": self.ref,
                "bam": self.bam,
                "seed": self.seed,
                "unit": {
                    "contig": u.contig,
                    "first_region": u.first_region,
                    "n_regions": u.n_regions,
                    "emit": "contig" if u.whole else "preds",
                },
            }
            fut = pool.submit(
                self._transport, port, payload,
                self.cfg.distpolish.unit_timeout_s,
            )
            inflight[u.uid] = (u, w, fut)
            progressed = True
        return progressed

    def _reap(self, pending, inflight) -> bool:
        # ONE 503-body classifier with the client (serve/client.py), so
        # the draining/busy parse cannot drift
        from roko_tpu_torch.serve.client import parse_503_body

        done = [uid for uid, (_, _, f) in inflight.items() if f.done()]
        for uid in done:
            u, w, fut = inflight.pop(uid)
            try:
                code, body = fut.result()
            except (OSError, http.client.HTTPException, TimeoutError) as e:
                # the worker vanished (SIGKILL mid-unit) or blew the
                # per-unit deadline: a failed attempt, excluded worker —
                # and SUSPECTED (out of rotation until the fleet's
                # heartbeat probes it back), the front end's failover
                # rule, so the next units don't pile onto a corpse the
                # supervision loop has not yet noticed
                self._suspect(w)
                self._attempt_failed(
                    pending, u, w, f"{type(e).__name__}: {e}"
                )
                continue
            if code == 200:
                try:
                    result = json.loads(body.decode())
                    self._commit_result(u, w, result)
                except (ValueError, KeyError, TypeError, AttributeError,
                        UnicodeDecodeError) as e:
                    # int(None), .encode on a non-str, missing fields —
                    # ANY malformed 200 burns one attempt, never the job
                    self._attempt_failed(
                        pending, u, w, f"malformed worker reply: {e}"
                    )
                continue
            detail, retry_after = parse_503_body(body)
            if code == 503:
                # backpressure, not failure: busy/warming/draining
                # workers park the unit — no attempt burned, no
                # exclusion (the SAME worker may serve it after the
                # drain window)
                u.state = "pending"
                u.worker = None
                u.retry_at = time.monotonic() + max(0.5, retry_after)
                pending.append(u)
                obs_events.emit(
                    "job", "unit_park", quiet=True,
                    unit=u.uid, contig=u.contig, worker=w.id,
                    error=detail or "busy",
                    retry_after_s=retry_after,
                )
            else:
                self._attempt_failed(
                    pending, u, w, f"HTTP {code}: {detail or '?'}"
                )
        return bool(done)

    def _suspect(self, w) -> None:
        """A worker that dropped a connection leaves rotation NOW
        (:meth:`Fleet.suspect` — the front end's failover rule); the
        supervision loop confirms via waitpid/heartbeat and either
        restarts it or probes it straight back to ready. HTTP-level
        errors do NOT suspect — the worker answered; the request was
        the problem. Fleet stand-ins without a ``suspect`` method fall
        back to the state-string flip."""
        fn = getattr(self.fleet, "suspect", None)
        if fn is not None:
            fn(w)
        elif getattr(w, "state", None) == "ready":
            w.state = "unhealthy"

    def _attempt_failed(self, pending, u, w, msg: str) -> None:
        u.failures += 1
        u.last_error = msg
        if w.id not in u.excluded:
            u.excluded.append(w.id)
        if u.failures >= self.cfg.distpolish.unit_attempts:
            u.state = "quarantined"
            u.worker = None
            if self.journal is not None:
                self.journal.unit_event(
                    u.uid, "quarantine", durable=True,
                    attempts=u.failures, error=msg[:200],
                )
            obs_events.emit(
                "job", "unit_quarantine", log=self._log,
                unit=u.uid, contig=u.contig, attempts=u.failures,
                suffix=f"— {msg[:200]}",
            )
            self._poisoned.append((u, msg))
            return
        delay = self._backoff.delay_for(u.failures)
        u.state = "pending"
        u.worker = None
        u.retry_at = time.monotonic() + delay
        pending.append(u)
        obs_events.emit(
            "job", "unit_retry", log=self._log,
            unit=u.uid, contig=u.contig, worker=w.id,
            attempt=u.failures, delay_s=round(delay, 2),
            suffix=f"— {msg[:200]}",
        )

    # -- commits ------------------------------------------------------------

    def _commit_result(self, u: WorkUnit, w, result: Dict[str, Any]) -> None:
        if u.whole:
            seq = result.get("polished")
            if not isinstance(seq, str):
                raise KeyError("reply lacks 'polished'")
            windows = int(result.get("windows", 0))
            self._commit_contig(u, seq, windows, worker=w.id)
        else:
            n = int(result["windows"])
            cols = self.cfg.model.window_cols
            positions = _decode_array(
                result["positions"], np.int64, (n, cols, 2)
            )
            preds = _decode_array(result["preds"], np.int32, (n, cols))
            if self.journal is not None:
                self.journal.commit_unit(
                    u.uid, n, positions=positions, preds=preds, worker=w.id
                )
            u.windows = n
            self._log(
                f"distpolish: committed unit {u.uid} ({n} windows, "
                f"worker {w.id}, attempt {u.failures + 1})"
            )
            obs_events.emit(
                "job", "unit_commit", quiet=True,
                unit=u.uid, contig=u.contig, worker=w.id, windows=n,
            )
            # vote LAST: when this was the contig's final span the call
            # stitches and logs the contig commit, which must read
            # after its last unit's own commit line
            self._vote_span(u, positions, preds, n)
        u.state = "committed"
        u.worker = None

    def _vote_span(self, u: WorkUnit, positions, preds, n: int) -> None:
        """Reduce side of a span-split contig: fold one unit's raw
        predictions into the contig's vote board; stitch + commit the
        contig once its LAST span lands. Identical vote set to the
        single process — sums are order-independent."""
        contig = u.contig
        board = self._boards.get(contig)
        if board is None:
            from roko_tpu_torch.infer import VoteBoard

            board = self._boards[contig] = VoteBoard(
                {contig: self.refs[contig]}
            )
        if n:
            board.add([contig] * n, positions, preds)
        self._span_windows[contig] = self._span_windows.get(contig, 0) + n
        self._span_left[contig] -= 1
        if self._span_left[contig] == 0:
            seq = board.stitch(contig)
            del self._boards[contig]
            self._commit_contig(u, seq, self._span_windows[contig],
                                stitched=True)

    def _commit_contig(
        self, u: WorkUnit, seq: str, windows: int, *, worker=None,
        stitched: bool = False,
    ) -> None:
        """Durable commit BEFORE the (non-atomic) FASTA append — the
        journal, not the FASTA, is what a killed coordinator resumes
        from (the streaming engine's rule, unchanged)."""
        contig = u.contig
        if self.journal is not None:
            self.journal.commit(contig, seq, windows)
            if not stitched:
                self.journal.unit_event(
                    u.uid, "commit", durable=True, windows=windows,
                    **({"worker": worker} if worker is not None else {}),
                )
        if self.writer is not None:
            self.writer.add(contig, seq)
        self.polished[contig] = seq
        u.windows = windows
        self._log(
            f"distpolish: committed contig {contig} ({windows} windows"
            + (f", worker {worker}" if worker is not None else "")
            + (", stitched from spans" if stitched else "")
            + ")"
        )
        if stitched:
            # the spans already each emitted their own unit_commit —
            # this is the CONTIG-level terminal record, distinct so
            # event-log consumers counting per-unit commits (the CI
            # accounting) never double-count the last span
            obs_events.emit(
                "job", "contig_commit", quiet=True,
                contig=contig, windows=windows,
            )
        else:
            obs_events.emit(
                "job", "unit_commit", quiet=True,
                unit=u.uid, contig=contig, windows=windows,
                **({"worker": worker} if worker is not None else {}),
            )


# -- entry points ------------------------------------------------------------

class _PendingJob:
    """Placeholder registered as ``fleet.job`` between POST /job's 202
    and the coordinator thread opening the journal, so a racing second
    POST sees an active job; replaced by the real job (or marked failed
    if startup never got that far)."""

    def __init__(self, out: str):
        self.state = "starting"
        self.out = out
        self.reason: Optional[str] = None

    def active(self) -> bool:
        return self.state == "starting"

    def snapshot(self) -> Dict[str, Any]:
        body: Dict[str, Any] = {"state": self.state, "out": self.out}
        if self.reason:
            body["reason"] = self.reason
        return body


def _run_job_core(
    fleet,
    cfg: RokoConfig,
    *,
    ref: str,
    bam: str,
    out: str,
    seed: int,
    resume: bool,
    model_identity: Dict[str, Any],
    transport: Optional[Transport] = None,
    log: Log = print,
) -> Dict[str, str]:
    """Journal + unit split + coordinator run over an ALREADY-RUNNING
    fleet — shared by the CLI (which forks its own fleet) and the
    supervisor's ``POST /job`` thread."""
    import contextlib

    from roko_tpu_torch.datapipe.io import open_input, path_scheme
    from roko_tpu_torch.features.pipeline import _ensure_bam
    from roko_tpu_torch.pipeline.stream import _OrderedFastaWriter

    refs = read_fasta(ref)
    journal: Optional[PolishJournal] = None
    stack = contextlib.ExitStack()
    try:
        if path_scheme(bam) not in ("", "file"):
            # a store BAM ships as its URL: each worker downloads it
            # (cached), so the bytes every unit reads come from the store,
            # not relayed by the coordinator. It must be BGZF already: a
            # remote SAM's conversion would land where no worker can reach
            with open_input(bam) as fh:
                magic = fh.read(2)
            if magic != b"\x1f\x8b":
                raise ValueError(
                    f"distributed polish needs sorted BAM input; {bam!r} is not BGZF. "
                    "Convert the SAM locally and upload the .bam (+ .bai) first.")
            bam_ship = bam
        else:
            # SAM text converts ONCE to a temporary sorted BAM, as every
            # other polish path does (features/pipeline.py): workers on the
            # shared file system read the converted file; shipping the raw
            # .sam would fail on the workers and look like a poison contig
            bam_ship = _ensure_bam(bam, stack)
        if bam_ship != bam and cfg.serve.data_root is not None:
            # the conversion lands outside the data root, which every
            # worker's path check would refuse with 400
            raise ValueError(
                "distributed polish with serve.data_root set needs BAM "
                f"input: the SAM conversion of {bam!r} writes a temp "
                "file outside the data root that workers would refuse. "
                "Convert it to a sorted BAM under the data root first."
            )
        journal = PolishJournal(out)
        committed = journal.open(
            # identity records the ORIGINAL bam path (stable across
            # resumes), not the converted temp above
            distributed_meta(ref, bam, seed, cfg, model_identity),
            resume=resume,
            log=log,
        )
        units = [
            u
            for u in split_units(
                refs, cfg.region, cfg.distpolish.unit_bases
            )
            if u.contig not in committed
        ]
        obs_events.emit(
            "job", "job_start", log=log,
            units=len(units), resumed_contigs=len(committed), out=out,
        )
        with _OrderedFastaWriter(out, sorted(n for n, _ in refs)) as writer:
            for name in sorted(committed):
                writer.add(name, committed[name][0])
            job = DistPolishJob(
                fleet, cfg,
                ref=ref, bam=bam_ship, seed=seed,
                refs=refs, units=units,
                journal=journal, writer=writer,
                committed={n: s for n, (s, _) in committed.items()},
                transport=transport, log=log,
            )
            fleet.job = job
            polished = job.run()
        # the run is whole (writer closed cleanly): the journal has
        # nothing left to protect. Any failure path skips this and the
        # journal survives for --resume.
        journal.finalize()
        return polished
    finally:
        stack.close()  # reaps the temp BAM conversion dir, if any
        if journal is not None:
            journal.close()


def wait_fleet_ready(fleet, timeout_s: float, log: Log = print) -> None:
    """Block until at least one worker is in rotation (spawn + warmup);
    a fleet that never gets there fails LOUDLY with the per-worker
    states instead of parking the job forever."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fleet.ready_count() >= 1:
            return
        time.sleep(0.25)
    states = {str(w.id): w.state for w in fleet.workers}
    raise RuntimeError(
        f"distributed polish: no worker became ready within "
        f"{timeout_s:.0f}s (worker states: {states}); see the worker "
        f"logs under {fleet.runtime_dir}"
    )


def run_distributed_polish(
    ref: str,
    bam: str,
    model_path: str,
    out: str,
    cfg: Optional[RokoConfig] = None,
    *,
    seed: int = 0,
    resume: bool = False,
    device: str = "cuda",
    log: Log = print,
) -> Dict[str, str]:
    """The ``polish --distributed`` entry point: fork a worker fleet (the
    fleet's supervision: heartbeats, restarts with backoff, the
    restart-storm breaker), bind an observability front end (``GET
    /jobz``, ``/healthz``, ``/metrics`` on an ephemeral port), run the
    coordinator in THIS process, and stop the fleet, on success and on
    failure alike: a rolling-free drain (SIGTERM, then SIGKILL past the
    grace). Workers load the model on ``device``; this process never
    does, and never initialises CUDA.

    The workers run in a process group of their own
    (``Fleet(own_process_group=True)``): drained and then killed when this
    function returns or fails, and drained and killed by the group's
    leader should this process itself be killed. Workers and coordinator
    share the host's file system (workers open ``ref``/``bam`` by path)."""
    cfg = cfg or RokoConfig()
    from roko_tpu_torch.parallel.mesh import resolve_fleet_topology
    from roko_tpu_torch.serve.fleet import BOOT_VERSION, Fleet
    from roko_tpu_torch.serve.supervisor import make_front_server, worker_launch_spec

    fc = cfg.fleet
    if fc.workers == 0:
        log("distpolish: fleet worker count not set; defaulting to 2 (--workers to change)")
        fc = dataclasses.replace(fc, workers=2)
    fc = resolve_fleet_topology(fc, backend=device)
    cfg = dataclasses.replace(cfg, fleet=fc)
    if cfg.cascade.enabled and not cfg.cascade.cache_dir:
        # one on-disk window cache beside the output, shared by every
        # worker: each pins the identical cache identity (same weights and
        # config), so a job pays for each distinct window once. A store
        # output's cache needs a real file system: the journal's scratch
        # directory keyed by the output URL
        from roko_tpu_torch.resilience.journal import _journal_dir

        base = _journal_dir(out)[: -len(".resume")]
        cfg = dataclasses.replace(
            cfg, cascade=dataclasses.replace(cfg.cascade, cache_dir=base + ".cascade_cache"))
        log(f"distpolish: shared cascade cache at {base}.cascade_cache")

    model_identity = {
        "version": BOOT_VERSION,
        "params_fingerprint": checkpoint_fingerprint(model_path),
        "quantize": cfg.model.quantize,
    }

    fleet = Fleet(cfg, worker_command=lambda *_: [], log=log, own_process_group=True)
    os.makedirs(fleet.runtime_dir, exist_ok=True)
    fleet.install_boot_spec(
        worker_launch_spec(BOOT_VERSION, model_path, cfg, fleet.runtime_dir, device=device)
    )
    server = make_front_server(fleet, port=0)
    threading.Thread(
        target=server.serve_forever, name="roko-distpolish-front", daemon=True
    ).start()
    host, port = server.server_address[:2]
    log(f"distpolish: fleet front end at http://{host}:{port} (GET /jobz for per-unit state)")
    try:
        fleet.start()
        log(f"distpolish: fleet workers in process group {fleet.process_group}")
        wait_fleet_ready(fleet, cfg.distpolish.ready_timeout_s, log=log)
        return _run_job_core(
            fleet, cfg,
            ref=ref, bam=bam, out=out, seed=seed, resume=resume,
            model_identity=model_identity, log=log,
        )
    finally:
        server.shutdown()
        server.server_close()
        fleet.stop(rolling=False)


def make_job_starter(
    fleet, cfg: RokoConfig, log: Log = print
) -> Callable[[Dict[str, Any]], Tuple[int, Dict[str, Any]]]:
    """The supervisor's ``POST /job``: validate the server-side paths (the
    ``data_root`` confinement of the ref + bam form of /polish), refuse a
    second job (409) and a job during a rollout (409), and run the
    coordinator on a thread over the supervisor's own fleet. The model
    identity is the ACTIVE launch spec's and version's, so a ``resume``
    after a rollout is refused instead of splicing two versions' contigs.
    Returns ``(http_code, json_body)``."""
    lock = threading.Lock()

    def start(payload: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        from roko_tpu_torch.datapipe.io import STORE_SCHEMES, path_scheme
        from roko_tpu_torch.serve.httpbase import _BadRequest
        from roko_tpu_torch.serve.server import _check_data_path, path_under_root

        data_root = cfg.serve.data_root
        try:
            ref = _check_data_path("ref", payload.get("ref"), data_root)
            bam = _check_data_path("bam", payload.get("bam"), data_root)
        except _BadRequest as e:
            return 400, {"error": str(e)}
        out = payload.get("out")
        if not isinstance(out, str) or not out:
            return 400, {"error": 'body must carry "out" (server-side FASTA output path)'}
        if path_scheme(out) in STORE_SCHEMES:
            if data_root is not None:
                return 400, {"error": "field 'out' must lie under the configured data root"}
            # a store URL passes as it is (realpath would mangle the
            # scheme); the writer uploads it when the job ends whole
        elif data_root is not None and not path_under_root(out, data_root):
            return 400, {"error": "field 'out' must lie under the configured data root"}
        else:
            out = os.path.realpath(out)
        try:
            seed = int(payload.get("seed", 0))
        except (TypeError, ValueError):
            return 400, {"error": "'seed' must be an integer"}
        resume = bool(payload.get("resume", False))
        with lock:
            job = getattr(fleet, "job", None)
            if job is not None and job.active():
                return 409, {"error": "a polish job is already running",
                             "status": job.snapshot()}
            ctl = getattr(fleet, "rollout", None)
            if ctl is not None and ctl.active():
                # the mirror of the rollout starter's job check: units
                # committed across a version swap would splice two models'
                # contigs into one FASTA
                return 409, {"error": "a rollout is in progress; submit the job after it lands",
                             "rollout": ctl.status()}
            spec = fleet.launch_spec()
            model_identity = {
                "version": fleet.active_version,
                "model_path": spec.meta.get("model_path"),
                "bundle_digest": spec.meta.get("bundle_digest"),
                "quantize": cfg.model.quantize,
            }
            placeholder = _PendingJob(out)
            fleet.job = placeholder

            def _run() -> None:
                try:
                    _run_job_core(
                        fleet, cfg,
                        ref=ref, bam=bam, out=out, seed=seed, resume=resume,
                        model_identity=model_identity, log=log,
                    )
                except Exception as e:
                    log(f"distpolish: job failed: {e}")
                    if fleet.job is placeholder:
                        placeholder.state = "failed"
                        placeholder.reason = f"{type(e).__name__}: {e}"

            threading.Thread(target=_run, name="roko-distpolish-job", daemon=True).start()
            return 202, {"state": "starting", "out": out}

    return start
