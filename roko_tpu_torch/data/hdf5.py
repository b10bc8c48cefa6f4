"""Writer and reader of the feature HDF5 files, in the schema of
``roko_tpu/data/hdf5.py``: root groups ``{contig}_{start}-{end}`` holding
``positions`` int64[N,90,2] and ``examples`` uint8[N,200,90] (chunked 64
windows), attrs ``contig`` and ``size``, and a ``contigs/{name}`` group per
draft contig with attrs ``name``, ``seq`` (the draft) and ``len``. A
training file's groups hold ``labels`` int64[N,90] as well. A group name
gets a ``.{k}`` suffix when it is taken already.

``h5py`` is imported inside the functions: the inference path itself
takes any iterator of window batches, and a machine without ``h5py`` can
still run it.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

Batch = Tuple[List[str], np.ndarray, np.ndarray]


class _ContigBuffer:
    """Stacked [N, ...] blocks of one contig; ``write`` concatenates them
    into one group."""

    def __init__(self, name: str, infer: bool):
        self.name = name
        self.infer = infer
        self.pos: List[np.ndarray] = []
        self.X: List[np.ndarray] = []
        self.Y: List[np.ndarray] = []

    def extend(self, pos, X, Y) -> None:
        pos = np.asarray(pos, dtype=np.int64)
        X = np.asarray(X, dtype=np.uint8)
        if len(pos) == 0:
            return
        if len(pos) != len(X):
            raise ValueError(f"{len(pos)} positions for {len(X)} windows")
        if not self.infer:
            if Y is None:
                raise ValueError("a training file needs labels")
            Y = np.asarray(Y, dtype=np.int64)
            if len(Y) != len(pos):
                raise ValueError(f"{len(Y)} label rows for {len(pos)} windows")
            self.Y.append(Y)
        self.pos.append(pos)
        self.X.append(X)

    def write(self, fd) -> None:
        if not self.pos:
            return
        start = int(self.pos[0][0, 0, 0])
        end = int(self.pos[-1][-1, -1, 0])
        base = f"{self.name}_{start}-{end}"
        group_name, k = base, 0
        while group_name in fd:
            k += 1
            group_name = f"{base}.{k}"

        group = fd.create_group(group_name)
        positions = np.concatenate(self.pos)
        group["positions"] = positions
        if not self.infer:
            group["labels"] = np.concatenate(self.Y)
        group.attrs["contig"] = self.name
        group.attrs["size"] = len(positions)
        X = np.concatenate(self.X)
        # 64-window chunks: the readers read slices, so smaller chunks
        # only add HDF5 overhead
        group.create_dataset("examples", data=X, chunks=(min(64, len(X)),) + X.shape[1:])

        self.pos.clear()
        self.X.clear()
        self.Y.clear()


class DataWriter:
    """Buffers windows per contig; ``write()`` flushes the buffers to the
    file, one group per contig and flush."""

    def __init__(self, filename: str, infer: bool):
        self.filename = filename
        self.infer = infer
        self._buffers: Dict[str, _ContigBuffer] = {}
        self._fd = None

    def __enter__(self) -> "DataWriter":
        import h5py

        self._fd = h5py.File(self.filename, "w", libver="latest")
        return self

    def __exit__(self, *exc) -> None:
        try:
            self.write()
        finally:
            self._fd.close()
            self._fd = None

    def write_contigs(self, refs: Sequence[Tuple[str, str]]) -> None:
        group = self._fd.create_group("contigs")
        for name, seq in refs:
            contig = group.create_group(name)
            contig.attrs["name"] = name
            contig.attrs["seq"] = seq
            contig.attrs["len"] = len(seq)

    def store(self, contig: str, positions, examples, labels) -> None:
        buf = self._buffers.get(contig)
        if buf is None:
            buf = self._buffers[contig] = _ContigBuffer(contig, self.infer)
        buf.extend(positions, examples, labels)

    def write(self) -> None:
        for buf in self._buffers.values():
            buf.write(self._fd)


def data_group_names(fd) -> List[str]:
    """The window groups of an open file, in the file's key order."""
    return [g for g in fd.keys() if g not in ("contigs", "info")]


def file_identity(path: str):
    """(device, inode), which folds symlinked and hard-linked aliases of one
    file together, or the real path when ``stat`` fails."""
    try:
        st = os.stat(path)
        return (st.st_dev, st.st_ino)
    except OSError:
        return os.path.realpath(path)


def hdf5_files(path: str) -> List[str]:
    """A single file, or every ``*.hdf5``/``*.h5`` in a directory sorted by
    basename, with symlinked duplicates dropped (the order
    ``roko_tpu.data.hdf5.hdf5_files`` gives, which the epoch stream is a
    function of)."""
    if not os.path.isdir(path):
        return [path]
    out: List[str] = []
    seen: set = set()
    for f in sorted(os.listdir(path)):
        if not (f.endswith(".hdf5") or f.endswith(".h5")):
            continue
        p = os.path.join(path, f)
        ident = file_identity(p)
        if ident not in seen:
            seen.add(ident)
            out.append(p)
    return out


def read_training_groups(path: str) -> Iterator[Tuple[str, np.ndarray, np.ndarray]]:
    """``(group, examples uint8[N,200,90], labels int32[N,90])`` for every
    window group of one training file, in the file's order."""
    import h5py

    with h5py.File(path, "r") as fd:
        for g in data_group_names(fd):
            if "labels" not in fd[g]:
                raise ValueError(f"{path}:{g} has no labels; is it a training file?")
            yield (
                g,
                np.ascontiguousarray(fd[g]["examples"][()], np.uint8),
                np.ascontiguousarray(fd[g]["labels"][()], np.int32),
            )


def load_contigs(path: str) -> Dict[str, str]:
    """``{name: draft sequence}`` in the file's order."""
    import h5py

    with h5py.File(path, "r") as fd:
        return {str(name): fd["contigs"][name].attrs["seq"] for name in fd["contigs"]}


def iter_inference_windows(
    path: str, batch_size: int, slab: int = 4096, contig_filter: Optional[set] = None,
) -> Iterator[Batch]:
    """Yield ``(contig names, positions int64[B,90,2], examples
    uint8[B,200,90])`` batches in genome order; the last may be short.
    ``contig_filter`` restricts the walk to the windows of those contigs
    (a rank of a run of several processes reads only its own).

    Groups are walked by (contig, first position, name), not by name: in
    string order ``c_1000000-...`` would come before ``c_200000-...``. At
    most ``slab`` windows of a group are read at a time, so a genome in
    one group is never loaded whole."""
    import h5py

    with h5py.File(path, "r") as fd:
        pending: deque = deque()  # [contig, positions, examples, offset]
        total = 0

        def cut(size: int) -> Batch:
            names: List[str] = []
            ps, xs = [], []
            while size:
                rec = pending[0]
                contig, p, x, off = rec
                take = min(size, len(p) - off)
                names.extend([contig] * take)
                ps.append(p[off : off + take])
                xs.append(x[off : off + take])
                if off + take == len(p):
                    pending.popleft()
                else:
                    rec[3] = off + take
                size -= take
            return names, np.concatenate(ps), np.concatenate(xs)

        def genome_order(g: str):
            grp = fd[g]
            try:
                start = int(grp["positions"][0, 0, 0])
            except (KeyError, IndexError, ValueError):
                start = 0
            return (str(grp.attrs.get("contig", "")), start, g)

        for g in sorted(data_group_names(fd), key=genome_order):
            contig = str(fd[g].attrs["contig"])
            if contig_filter is not None and contig not in contig_filter:
                continue
            dpos, dx = fd[g]["positions"], fd[g]["examples"]
            n = dpos.shape[0]
            for s in range(0, n, slab):
                m = min(slab, n - s)
                pending.append([contig, dpos[s : s + m], dx[s : s + m], 0])
                total += m
                while total >= batch_size:
                    total -= batch_size
                    yield cut(batch_size)
        if total:
            yield cut(total)
