"""FASTA reader and writer for local paths, in the layout of
``roko_tpu/io/fasta.py``: ``>name`` then the sequence in 80-column lines."""

from __future__ import annotations

import gzip
from typing import Iterator, List, Sequence, Tuple


def iter_fasta(path: str) -> Iterator[Tuple[str, str]]:
    """Yield ``(name, sequence)`` per record; the name is the first
    whitespace-delimited token of the header line."""
    opener = gzip.open if path.endswith(".gz") else open
    name = None
    chunks: List[str] = []
    with opener(path, "rt") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            else:
                if name is None:
                    raise ValueError(f"{path}: sequence data before first header")
                chunks.append(line)
        if name is not None:
            yield name, "".join(chunks)


def read_fasta(path: str) -> List[Tuple[str, str]]:
    return list(iter_fasta(path))


def write_fasta_record(fh, name: str, seq: str, line_width: int = 80) -> None:
    """One record in this module's layout: the streaming polish's
    incremental writer calls it, so its file is byte-identical to
    :func:`write_fasta`'s."""
    fh.write(f">{name}\n")
    for i in range(0, len(seq), line_width):
        fh.write(seq[i : i + line_width])
        fh.write("\n")


def write_fasta(
    path: str, records: Sequence[Tuple[str, str]], line_width: int = 80
) -> None:
    with open(path, "w") as fh:
        for name, seq in records:
            write_fasta_record(fh, name, seq, line_width)
