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

For a store-scheme output (``gs://``, ``s3://``, ``http(s)://``) the
journal needs a real, fsync-able file system: it lives in a fixed local
scratch directory keyed by the URL, ``~/.cache/roko_tpu_torch/journal/
<sha256[:16]>.resume`` (the JAX package keeps its own under
``~/.cache/roko_tpu``, so the two never resume each other's journal), and
each committed span payload is mirrored to ``<out>.resume/`` in the store.
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

#: the local root of the journals of store-scheme outputs
SCRATCH_ROOT = os.path.join("~", ".cache", "roko_tpu_torch", "journal")


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


def _journal_dir(out_path: str) -> str:
    """Next to a local output; for a store URL a fixed directory under
    :data:`SCRATCH_ROOT` keyed by the URL, so the same host resuming the
    same remote output finds the same journal."""
    from roko_tpu_torch.datapipe.io import path_scheme, strip_file_scheme

    if path_scheme(out_path) in ("", "file"):
        return strip_file_scheme(out_path) + ".resume"
    key = hashlib.sha256(out_path.encode()).hexdigest()[:16]
    return os.path.join(os.path.expanduser(SCRATCH_ROOT), key + ".resume")


class PolishJournal:
    def __init__(self, out_path: str):
        from roko_tpu_torch.datapipe.io import path_scheme

        self.dir = _journal_dir(out_path)
        #: the remote ``<out>.resume/`` prefix span payloads mirror to
        #: (through open_output) when the output itself is remote
        self.remote_dir = (
            out_path + ".resume" if path_scheme(out_path) not in ("", "file") else None)
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
            if self.remote_dir is not None:
                self._mirror(uid, path, fname)
        self.unit_event(uid, "commit", durable=True, **fields)

    def _mirror(self, uid: str, path: str, fname: str) -> None:
        """Upload a committed span payload next to the remote output
        (a verified PUT through open_output), so the run's artifacts live
        with the output object too. The local ``.npz`` is what a resume
        reads, so a store failure here never fails the commit."""
        from roko_tpu_torch.datapipe.io import open_output
        from roko_tpu_torch.datapipe.store import StoreError
        from roko_tpu_torch.obs import events as obs_events

        url = self.remote_dir + "/" + fname
        with open(path, "rb") as src:
            data = src.read()
        try:
            dst = open_output(url, "wb")
            dst.write(data)
            dst.close()
        except (StoreError, OSError) as e:
            obs_events.emit("journal", "unit_mirror_failed", unit=uid, url=url,
                            error=f"{type(e).__name__}: {e}"[:200])

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
