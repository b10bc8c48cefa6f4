"""Sidecar journal that makes the streaming polish crash-resumable (the
port's copy of the contig half of ``roko_tpu/resilience/journal.py``).

The streaming engine writes the polished FASTA incrementally; a crash
(OOM kill, preemption, SIGKILL) mid-run would lose every finished
contig, because the partial FASTA is untrustworthy (a record may be half
written). :class:`PolishJournal` keeps a durable record NEXT to the
output so ``polish --resume`` recomputes only what is missing:

``<out>.resume/``
    ``meta.json``       run identity (ref/bam/seed, a sha1 of the model
                        weights, the window/extraction config + format
                        version) — a resume against different inputs,
                        weights or geometry is refused;
    ``<sha1>.seq``      one polished contig, written ATOMICALLY
                        (tmp file + fsync + ``os.replace``);
    ``manifest.jsonl``  one line per committed contig
                        ``{"contig", "file", "windows"}``, appended and
                        fsync'd only AFTER its ``.seq`` landed;
    ``units.jsonl``     the distributed polish's unit ledger (one event
                        a line: attempt / commit / quarantine, with the
                        attempt count and worker id), written by the
                        ``polish --distributed`` coordinator
                        (``pipeline/distpolish.py``);
    ``unit-<sha1>.npz`` a committed SPAN unit's raw predictions
                        (positions + preds), written atomically BEFORE
                        its ledger commit line, so a resumed coordinator
                        stitches a split contig again from them instead
                        of running its units again.

Commit order makes the journal crash-consistent at every byte: a torn
trailing manifest line (the crash hit mid-append) fails to parse and is
ignored; a parsed line whose ``.seq`` file is missing is ignored too.
Everything that does parse is a contig whose sequence is complete on
disk. On success the engine deletes the whole directory — the journal
exists only while a run is unfinished.

The port takes local paths only: a remote store URL is refused, naming
queue item A10.3 (the JAX package keeps such a journal in a local scratch
directory and mirrors the span payloads to the store).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
from typing import Callable, Dict, Optional, Tuple

Log = Callable[[str], None]

_FORMAT = 1

#: URL schemes of remote stores, which the port does not write
REMOTE_SCHEMES = ("gs://", "s3://", "http://", "https://")


class JournalMismatch(RuntimeError):
    """``--resume`` pointed at a journal written by a different run
    (other inputs, seed, weights or geometry) — resuming would splice
    two different polishes into one FASTA."""


def _fsync_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


class PolishJournal:
    def __init__(self, out_path: str):
        if out_path.startswith(REMOTE_SCHEMES):
            raise ValueError(
                f"{out_path}: remote stores (gs://, s3://, http(s)://) are not "
                "ported yet (queue item A10.3 of ROADMAP.md); write the polished "
                "FASTA to a local path")
        if out_path.startswith("file://"):
            out_path = out_path[len("file://"):]
        self.dir = out_path + ".resume"
        os.makedirs(os.path.dirname(self.dir) or ".", exist_ok=True)
        self.meta_path = os.path.join(self.dir, "meta.json")
        self.manifest_path = os.path.join(self.dir, "manifest.jsonl")
        self.units_path = os.path.join(self.dir, "units.jsonl")
        self._manifest_fh = None
        self._units_fh = None

    # -- lifecycle ----------------------------------------------------------

    def open(
        self, meta: Dict, *, resume: bool, log: Optional[Log] = None
    ) -> Dict[str, Tuple[str, int]]:
        """Create or reopen the journal. Returns the committed contigs
        as ``{name: (sequence, windows)}`` — empty unless ``resume`` is
        set and a matching journal exists."""
        committed: Dict[str, Tuple[str, int]] = {}
        # JSON round-trip so the comparison against a reloaded meta.json
        # is type-stable (tuples in caller config become lists, etc.)
        meta = json.loads(json.dumps(dict(meta, format=_FORMAT)))
        if os.path.isdir(self.dir):
            if resume:
                committed = self._load(meta)
            else:
                # a fresh (non-resume) run owns the path: stale state
                # from an abandoned earlier run must not leak into it
                shutil.rmtree(self.dir)
        elif resume and log is not None:
            log(f"resume: no journal at {self.dir}; running from scratch")
        os.makedirs(self.dir, exist_ok=True)
        if not os.path.exists(self.meta_path):
            _fsync_write(
                self.meta_path,
                json.dumps(meta, sort_keys=True).encode(),
            )
        self._manifest_fh = open(self.manifest_path, "a")
        if committed and log is not None:
            windows = sum(w for _, w in committed.values())
            log(
                f"resume: skipping {len(committed)} committed contig(s) "
                f"({windows} windows) from {self.dir}"
            )
        return committed

    def _load(self, meta: Dict) -> Dict[str, Tuple[str, int]]:
        try:
            with open(self.meta_path) as fh:
                have = json.load(fh)
        except (OSError, ValueError):
            raise JournalMismatch(
                f"journal at {self.dir} has no readable meta.json; "
                "delete the directory to start over"
            ) from None
        if have != meta:
            raise JournalMismatch(
                f"journal at {self.dir} was written by a different run "
                f"({have!r} != {meta!r}); delete it or rerun without "
                "--resume"
            )
        committed: Dict[str, Tuple[str, int]] = {}
        with contextlib.suppress(OSError):
            with open(self.manifest_path) as fh:
                for line in fh:
                    try:
                        rec = json.loads(line)
                        name, fname = rec["contig"], rec["file"]
                        windows = int(rec.get("windows", 0))
                    except (ValueError, KeyError, TypeError):
                        continue  # torn trailing append — not committed
                    seq_path = os.path.join(self.dir, fname)
                    try:
                        with open(seq_path) as sfh:
                            committed[name] = (sfh.read(), windows)
                    except OSError:
                        continue  # manifest ahead of a vanished file
        return committed

    # -- commits ------------------------------------------------------------

    def commit(self, name: str, seq: str, windows: int) -> None:
        """Durably record one polished contig: atomic ``.seq`` write,
        THEN the manifest line (fsync'd) — the manifest never references
        bytes that are not fully on disk."""
        fname = hashlib.sha1(name.encode()).hexdigest() + ".seq"
        _fsync_write(os.path.join(self.dir, fname), seq.encode())
        line = json.dumps(
            {"contig": name, "file": fname, "windows": windows}
        )
        self._manifest_fh.write(line + "\n")
        self._manifest_fh.flush()
        os.fsync(self._manifest_fh.fileno())

    # -- unit ledger (distributed polish) -----------------------------------

    def unit_event(self, uid: str, event: str, *, durable: bool = False, **fields) -> None:
        """Append one ledger event of work unit ``uid``. ``durable``
        fsyncs (commits and quarantines survive a power cut; attempt
        bookkeeping is best effort: a torn trailing line is skipped on
        load)."""
        if self._units_fh is None:
            self._units_fh = open(self.units_path, "a")
        line = json.dumps(dict({"unit": uid, "event": event}, **fields))
        self._units_fh.write(line + "\n")
        self._units_fh.flush()
        if durable:
            os.fsync(self._units_fh.fileno())

    def commit_unit(self, uid: str, windows: int, *, positions=None, preds=None,
                    worker=None) -> None:
        """Durably record one finished work unit. A span unit carries its
        predictions (``positions``/``preds``), written as an atomic,
        fsync'd ``.npz`` BEFORE the ledger line (the ledger never names
        bytes that are not whole on disk), so a resumed coordinator
        stitches its contig without running the unit again."""
        fields: Dict = {"windows": int(windows)}
        if worker is not None:
            fields["worker"] = worker
        if positions is not None:
            import numpy as np

            fname = "unit-" + hashlib.sha1(uid.encode()).hexdigest() + ".npz"
            path = os.path.join(self.dir, fname)
            tmp = path + ".tmp"
            with open(tmp, "wb") as fh:
                np.savez(fh, positions=positions, preds=preds)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
            fields["file"] = fname
        self.unit_event(uid, "commit", durable=True, **fields)

    def load_units(self) -> Dict[str, Dict]:
        """The unit ledger folded into each unit's latest state:
        ``{uid: {"state", "attempts", "windows", "file", ...}}``. Torn or
        unparsable lines are skipped (the contig manifest's rule). A
        quarantine is informational: a resumed run retries the unit with a
        fresh attempt budget."""
        out: Dict[str, Dict] = {}
        with contextlib.suppress(OSError):
            with open(self.units_path) as fh:
                for line in fh:
                    try:
                        rec = json.loads(line)
                        uid, event = rec["unit"], rec["event"]
                    except (ValueError, KeyError, TypeError):
                        continue  # torn trailing append
                    cur = out.setdefault(uid, {"state": "pending"})
                    if event == "attempt":
                        cur["attempts"] = int(rec.get("attempts", 0))
                    elif event == "commit":
                        cur["state"] = "committed"
                        cur["windows"] = int(rec.get("windows", 0))
                        if rec.get("file"):
                            cur["file"] = rec["file"]
                    elif event == "quarantine":
                        cur["state"] = "quarantined"
        return out

    def load_unit_preds(self, rec: Dict):
        """The committed span unit's ``(positions, preds)`` that a
        :meth:`load_units` record names, or ``None`` when its ``.npz`` is
        missing or unreadable (the unit then runs again: a vanished
        payload degrades to a recompute, never to a wrong FASTA)."""
        fname = rec.get("file")
        if not fname:
            return None
        import zipfile

        import numpy as np

        try:
            with np.load(os.path.join(self.dir, fname)) as z:
                return z["positions"], z["preds"]
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
            return None

    def close(self) -> None:
        if self._manifest_fh is not None:
            self._manifest_fh.close()
            self._manifest_fh = None
        if self._units_fh is not None:
            self._units_fh.close()
            self._units_fh = None

    def finalize(self) -> None:
        """The run completed and the FASTA is whole: the journal has
        served its purpose — remove it."""
        self.close()
        shutil.rmtree(self.dir, ignore_errors=True)
