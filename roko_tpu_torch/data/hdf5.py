"""Reader of the feature HDF5 files that ``roko-tpu features`` writes
(schema in ``roko_tpu/data/hdf5.py``): root groups ``{contig}_{start}-{end}``
holding ``positions`` int64[N,90,2] and ``examples`` uint8[N,200,90], and a
``contigs/{name}`` group per draft contig whose ``seq`` attribute is the
draft. A training file's groups hold ``labels`` [N,90] as well.

``h5py`` is imported inside the functions: the inference path itself
takes any iterator of window batches, and a machine without ``h5py`` can
still run it.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Dict, Iterator, List, Tuple

import numpy as np

Batch = Tuple[List[str], np.ndarray, np.ndarray]


def data_group_names(fd) -> List[str]:
    """The window groups of an open file, in the file's key order."""
    return [g for g in fd.keys() if g not in ("contigs", "info")]


def _file_identity(path: str):
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
        ident = _file_identity(p)
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
    path: str, batch_size: int, slab: int = 4096
) -> Iterator[Batch]:
    """Yield ``(contig names, positions int64[B,90,2], examples
    uint8[B,200,90])`` batches in genome order; the last may be short.

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
