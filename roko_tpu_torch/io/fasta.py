"""FASTA reader and writer in the layout of ``roko_tpu/io/fasta.py``:
``>name`` then the sequence in 80-column lines. Local paths read and write
directly; a store URL (``gs://``, ``s3://``, ``http(s)://``) reads through
the ranged, cached ``open_input`` seam and writes through ``open_output``'s
upload-on-close handle (``datapipe/io.py``)."""

from __future__ import annotations

import gzip
import io
from typing import Iterator, List, Sequence, Tuple


def _open_text(path: str):
    from roko_tpu_torch.datapipe.io import open_input, path_scheme, strip_file_scheme

    if path_scheme(path) in ("", "file"):
        local = strip_file_scheme(path)
        return gzip.open(local, "rt") if local.endswith(".gz") else open(local, "r")
    fh = open_input(path)
    return gzip.open(fh, "rt") if path.endswith(".gz") else io.TextIOWrapper(fh)


def iter_fasta(path: str) -> Iterator[Tuple[str, str]]:
    """Yield ``(name, sequence)`` per record; the name is the first
    whitespace-delimited token of the header line."""
    name = None
    chunks: List[str] = []
    with _open_text(path) as fh:
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
    """Write ``records``. Should the records' producer fail, a remote
    handle aborts (nothing is uploaded) and a local file is left as far as
    it got."""
    from roko_tpu_torch.datapipe.io import abort_output, open_output

    fh = open_output(path, "w")
    try:
        for name, seq in records:
            write_fasta_record(fh, name, seq, line_width)
    except BaseException:
        abort_output(fh)
        raise
    else:
        fh.close()
