"""The input and output seams behind the data plane's reads and writes:
the port's copy of ``roko_tpu/datapipe/io.py``.

- :func:`open_input` resolves a path to a binary file-like object: plain
  paths and ``file://`` URLs open locally; another scheme resolves through
  the registry of :func:`register_opener`;
- :func:`open_output` is the matching write seam, with
  :func:`register_writer` and :func:`abort_output` (a remote handle's
  ``abort()`` discards what it spooled);
- :func:`open_h5` opens one corpus HDF5 through the seam (``h5py`` is
  imported inside it);
- :func:`ensure_local` gives a real file name for a path: a local one
  passes through, a store URL downloads (cached, atomic) through the store
  client (the native BAM reader and the distributed polish's workers read
  through it).

``gs://``, ``s3://`` and ``http(s)://`` install the hardened object-store
client (``datapipe/store.py``) on first use when no handler is registered
for them; any other scheme refuses loudly, naming the registered ones.
"""

from __future__ import annotations

from typing import BinaryIO, Callable, Dict, Optional

#: ``opener(path, mode) -> file-like``, the fsspec signature
Opener = Callable[[str, str], BinaryIO]

#: process-wide scheme registries; ``file`` and plain paths never consult them
_OPENERS: Dict[str, Opener] = {}
_WRITERS: Dict[str, Opener] = {}

#: the schemes the object-store client (``datapipe/store.py``) serves; an
#: unregistered one installs the default client on first use
STORE_SCHEMES = ("gs", "s3", "http", "https")


def path_scheme(path: str) -> str:
    """The URL scheme of ``path``, empty for a plain local path (the
    marker is the whole ``://``, so a drive letter is no scheme)."""
    head, sep, _ = path.partition("://")
    return head.lower() if sep else ""


def strip_file_scheme(path: str) -> str:
    """``file:///x`` or ``file://x`` -> a plain local path."""
    if path_scheme(path) != "file":
        return path
    rest = path.split("://", 1)[1]
    return rest if not rest.startswith("/") else "/" + rest.lstrip("/")


def local_open(path: str, mode: str = "rb") -> BinaryIO:
    """The default opener: the local file system (``file://`` accepted)."""
    return open(strip_file_scheme(path), mode)


def _check_registrable(scheme: str) -> str:
    scheme = scheme.lower()
    if scheme in ("", "file"):
        raise ValueError(
            "local paths always open through the default opener; "
            f"cannot register scheme {scheme!r}"
        )
    return scheme


def register_opener(scheme: str, opener: Optional[Opener]) -> None:
    """Install (``None``: remove) the process-wide opener of ``scheme``."""
    scheme = _check_registrable(scheme)
    if opener is None:
        _OPENERS.pop(scheme, None)
    else:
        _OPENERS[scheme] = opener


def register_writer(scheme: str, writer: Optional[Opener]) -> None:
    """The :func:`open_output` counterpart of :func:`register_opener`."""
    scheme = _check_registrable(scheme)
    if writer is None:
        _WRITERS.pop(scheme, None)
    else:
        _WRITERS[scheme] = writer


def registered_schemes() -> Dict[str, tuple]:
    """``{"input": (...), "output": (...)}``: the registered schemes."""
    return {"input": tuple(sorted(_OPENERS)), "output": tuple(sorted(_WRITERS))}


def _autoinstall(scheme: str) -> bool:
    """Install the default store client for its schemes on first use, so
    a ``gs://`` or ``http://`` path works with no set-up."""
    if scheme not in STORE_SCHEMES:
        return False
    from roko_tpu_torch.datapipe import store

    store.install()
    return True


def _refuse(kind: str, registry: Dict[str, Opener], scheme: str, path: str,
            register_fn: str) -> ValueError:
    have = ", ".join(sorted(registry)) or "<none>"
    return ValueError(
        f"no {kind} registered for scheme {scheme!r} ({path!r}); currently "
        f"registered schemes: {have}. Call roko_tpu_torch.datapipe.io."
        f"{register_fn}({scheme!r}, fn) with an fsspec-style fn(path, mode) "
        "-> file-like"
    )


def open_input(path: str, mode: str = "rb", *, opener: Optional[Opener] = None) -> BinaryIO:
    """Open ``path`` for reading: an explicit ``opener`` wins, then the
    scheme registry, then the local default."""
    if opener is not None:
        return opener(path, mode)
    scheme = path_scheme(path)
    if scheme in ("", "file"):
        return local_open(path, mode)
    handler = _OPENERS.get(scheme)
    if handler is None and _autoinstall(scheme):
        handler = _OPENERS.get(scheme)
    if handler is None:
        raise _refuse("input opener", _OPENERS, scheme, path, "register_opener")
    return handler(path, mode)


def open_output(path: str, mode: str = "wb", *, writer: Optional[Opener] = None) -> BinaryIO:
    """Open ``path`` for writing through the seam. A registered remote
    handle may have ``abort()``: error paths call :func:`abort_output`
    instead of publishing a torn object."""
    if writer is not None:
        return writer(path, mode)
    scheme = path_scheme(path)
    if scheme in ("", "file"):
        return open(strip_file_scheme(path), mode)
    handler = _WRITERS.get(scheme)
    if handler is None and _autoinstall(scheme):
        handler = _WRITERS.get(scheme)
    if handler is None:
        raise _refuse("output writer", _WRITERS, scheme, path, "register_writer")
    return handler(path, mode)


def abort_output(fh) -> None:
    """Discard a partly written :func:`open_output` handle: a remote one
    aborts, a local file closes (its caller unlinks it)."""
    abort = getattr(fh, "abort", None)
    if abort is not None:
        abort()
    else:
        fh.close()


def ensure_local(path: str) -> str:
    """A local file-system path for ``path``, for readers that need a real
    file name (the native BAM reader): a plain or ``file://`` path passes
    through; a store URL downloads (cached, atomic, identity-checked)
    through ``ObjectStore.localize``, a BAM with its ``.bai``."""
    scheme = path_scheme(path)
    if scheme in ("", "file"):
        return strip_file_scheme(path)
    from roko_tpu_torch.datapipe import store

    s = store.install()
    if path.endswith(".bam"):
        return s.localize_bam(path)
    return s.localize(path)


def open_h5(path: str, *, opener: Optional[Opener] = None):
    """Open one corpus HDF5 read-only. A plain local path with no opener
    goes straight to ``h5py.File``; anything else through
    :func:`open_input` and h5py's file-object driver."""
    import h5py

    if opener is None and path_scheme(path) == "":
        return h5py.File(path, "r")
    return h5py.File(open_input(path, opener=opener), "r")
