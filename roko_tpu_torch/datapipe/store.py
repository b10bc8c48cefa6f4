"""The hardened object-store data plane (the port's copy of
``roko_tpu/datapipe/store.py``).

One generic ranged-read object-store client behind the ``open_input`` /
``open_output`` seams (``datapipe/io.py``), stdlib ``http.client`` only:

- **ranged GETs + block cache**: :class:`_StoreRawFile` reads in fixed
  ``block_bytes`` blocks through a bounded, sha256-checksummed local
  :class:`BlockCache` (atomic tmp+rename entries; a corrupt or torn entry
  is deleted and fetched again, never served). The cache directory
  carries an identity pin (``meta.json``); opening it under another
  format refuses with a :class:`StoreMismatch` field diff.
- **retry/hedge/breaker**: every request runs under the shared
  :class:`RetryPolicy` (``Retry-After`` is a delay *floor*), behind a
  :class:`CircuitBreaker` per endpoint; an optional hedged second read
  races a straggling range. Uploads are read-verify-commit: PUT with a
  sha256 header, HEAD-verify size and digest, PUT again on a mismatch, so
  a torn remote object is never left standing as the final state.
- **fault injection**: :class:`FaultyStore` wraps the transport and
  injects timeouts, 5xx replies, truncated bodies and torn writes at
  rates from the environment (``ROKO_STORE_FAULTS=timeout:0.1,http500:0.05``,
  seeded by ``ROKO_STORE_FAULT_SEED``), and :class:`StubObjectStore` is an
  in-process stdlib object-store server (Range GET, HEAD, checksum-verified
  atomic PUT) for tests and the card's smoke run.
- **observability**: ``emit()`` events (``store_retry``, ``store_hedge``,
  ``store_breaker_open``, ``cache_hit``) and process-wide counters that
  ``GET /metrics`` renders through :func:`store_metrics_lines`.

``gs://`` and ``s3://`` URLs resolve through ``ROKO_STORE_ENDPOINT`` (an
HTTP(S) gateway prefix; the bucket and key ride as the path): the client
speaks plain HTTP, which is what the stub server and any S3- or
GCS-compatible proxy expose. ``http(s)://`` URLs are used as they are.
This module imports no torch.
"""

from __future__ import annotations

import hashlib
import http.client
import io
import json
import os
import queue
import random
import socket
import tempfile
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple

from roko_tpu_torch.datapipe.io import path_scheme
from roko_tpu_torch.obs import events as obs_events
from roko_tpu_torch.resilience.breaker import CircuitBreaker
from roko_tpu_torch.resilience.retry import RetryPolicy

#: URL schemes this client serves through the opener/writer registries
STORE_SCHEMES = ("gs", "s3", "http", "https")

#: ranged-read block size: the unit the block cache keys on. 4 MiB
#: amortises per-request latency over object-store RTTs while keeping
#: the cache useful for the manifest's span-table reads (a 256-row span
#: of typical window geometry is well under one block).
DEFAULT_BLOCK_BYTES = 4 * 2**20
DEFAULT_CACHE_BYTES = 256 * 2**20

#: the checksum header the client sends on PUT and verifies on
#: read-back; the stub server enforces it server-side (422 on mismatch)
CHECKSUM_HEADER = "x-roko-content-sha256"

_FAULT_KINDS = ("timeout", "http500", "truncate", "torn_write")


# -- errors ------------------------------------------------------------------

class StoreError(RuntimeError):
    """Object-store client failure (after retries, where applicable)."""


class StoreHTTPError(StoreError):
    """A non-2xx response. 5xx/429 are retryable; other 4xx are a
    caller bug or a missing object and propagate immediately."""

    def __init__(self, url: str, status: int, reason: str = "",
                 retry_after: Optional[float] = None):
        super().__init__(f"HTTP {status} for {url!r}" +
                         (f": {reason}" if reason else ""))
        self.url = url
        self.status = status
        self.retry_after = retry_after


class TruncatedRead(StoreError):
    """Body shorter than the response promised — a cut connection or a
    misbehaving proxy. Retryable: the bytes are wrong, not the object."""


class ChecksumMismatch(StoreError):
    """Downloaded/uploaded bytes hash differently from the expected
    sha256 — corruption in flight or a torn remote object. Retryable."""


class BreakerOpen(StoreError):
    """The endpoint's circuit breaker is open: recent requests failed
    consecutively and the client is shedding load instead of hammering
    a sick endpoint. Carries the breaker's remaining cool-down."""

    def __init__(self, endpoint: str, retry_after: float):
        super().__init__(
            f"circuit breaker open for store endpoint {endpoint!r} "
            f"(retry in {retry_after:.1f}s)"
        )
        self.endpoint = endpoint
        self.retry_after = retry_after


class StoreMismatch(StoreError):
    """A store artifact (block-cache directory) carries a different
    identity than this client writes: the field-diff refusal shape of
    ``cascade.CascadeMismatch``, one line per differing field."""

    def __init__(self, what: str, where: str,
                 diff: Dict[str, Tuple[Any, Any]]):
        lines = [
            f"{key}: artifact={theirs!r} run={ours!r}"
            for key, (theirs, ours) in sorted(diff.items())
        ]
        super().__init__(
            f"store {what} at {where!r} belongs to a different "
            "format/run; refusing to use it. Differing fields:\n  "
            + "\n  ".join(lines or ["<identity mismatch>"])
            + "\nDelete the directory or point the store at a fresh one."
        )
        self.diff = diff


# -- counters (process-wide, /metrics) ---------------------------------------

_COUNTER_NAMES = (
    "requests", "request_failures", "retries", "hedges", "hedge_wins",
    "breaker_open", "cache_hits", "cache_misses", "cache_corrupt",
    "put_retries", "faults_injected",
)
_counters = {name: 0 for name in _COUNTER_NAMES}
_counters_lock = threading.Lock()


def _bump(name: str, n: int = 1) -> None:
    with _counters_lock:
        _counters[name] += n


def store_counters() -> Dict[str, int]:
    """A snapshot of the process-wide store counters."""
    with _counters_lock:
        return dict(_counters)


def reset_store_counters() -> None:
    """Zero the counters (tests only — /metrics counters are lifetime)."""
    with _counters_lock:
        for name in _COUNTER_NAMES:
            _counters[name] = 0


def store_metrics_lines() -> list:
    """Prometheus text lines for ``GET /metrics`` (serve/metrics.py)."""
    lines = []
    for name, value in sorted(store_counters().items()):
        full = f"roko_store_{name}_total"
        lines.append(f"# TYPE {full} counter")
        lines.append(f"{full} {value}")
    return lines


# -- fault injection ---------------------------------------------------------

def parse_fault_spec(spec: str) -> Dict[str, float]:
    """``"timeout:0.1,http500:0.05"`` -> ``{"timeout": 0.1, ...}``.
    Unknown kinds and out-of-range rates refuse with the valid set in
    the message (this parses an env var — a typo must not silently
    disable the fault it meant to enable)."""
    rates: Dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        kind, sep, rate_s = part.partition(":")
        kind = kind.strip()
        if not sep or kind not in _FAULT_KINDS:
            raise ValueError(
                f"bad fault spec entry {part!r}; expected kind:rate with "
                f"kind one of {', '.join(_FAULT_KINDS)}"
            )
        try:
            rate = float(rate_s)
        except ValueError:
            raise ValueError(
                f"bad fault rate in {part!r}: not a number"
            ) from None
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"fault rate in {part!r} outside [0, 1]")
        rates[kind] = rate
    return rates


class FaultyStore:
    """Transport wrapper injecting transient store faults at fixed
    per-request rates — the adversary the retry/verify machinery is
    tested against. Faults are *transient by construction* (a fresh
    coin flip per attempt), so a client with retries converges on the
    correct bytes; a client without them fails loudly.

    - ``timeout``: raise ``socket.timeout`` without touching the wire;
    - ``http500``: synthesize a 500 without touching the wire;
    - ``truncate``: forward the request, then drop the second half of a
      GET body (headers intact — the client's length check trips);
    - ``torn_write``: forward a PUT with the second half of the body
      missing (checksum header intact — the server/verify step trips).
    """

    def __init__(self, inner: Callable, rates: Dict[str, float],
                 seed: int = 0):
        bad = set(rates) - set(_FAULT_KINDS)
        if bad:
            raise ValueError(f"unknown fault kinds: {sorted(bad)}")
        self.inner = inner
        self.rates = dict(rates)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.injected: Dict[str, int] = {k: 0 for k in _FAULT_KINDS}

    def _roll(self, kind: str) -> bool:
        rate = self.rates.get(kind, 0.0)
        if rate <= 0.0:
            return False
        with self._lock:
            hit = self._rng.random() < rate
            if hit:
                self.injected[kind] += 1
        if hit:
            _bump("faults_injected")
        return hit

    def __call__(self, method: str, url: str, headers: Dict[str, str],
                 body: Optional[bytes], timeout: float):
        if self._roll("timeout"):
            raise socket.timeout(f"injected timeout for {method} {url}")
        if self._roll("http500"):
            return 500, {}, b"injected http500 fault"
        if method == "PUT" and body and self._roll("torn_write"):
            # half the body arrives, framed as if complete (the checksum
            # header still describes the full payload) — the tear must
            # be caught by CHECKSUM verification, not by the server
            # waiting out a short read
            body = body[: len(body) // 2]
            headers = dict(headers, **{"Content-Length": str(len(body))})
        status, hdrs, data = self.inner(method, url, headers, body, timeout)
        if (
            method == "GET" and status in (200, 206) and len(data) > 1
            and self._roll("truncate")
        ):
            data = data[: len(data) // 2]
        return status, hdrs, data


# -- the checksummed block cache ---------------------------------------------

_CACHE_META = {"kind": "roko-store-block-cache", "version": 1}


class BlockCache:
    """Bounded on-disk cache of sha256-checksummed byte blocks.

    Entry layout: ``<dir>/<key[:2]>/<key>.blk`` where ``key`` is the
    sha256 over (url, object identity, offset, length); each entry file
    is ``<64-hex payload digest>\\n<payload>``. Reads verify the digest
    — a torn or bit-rotted entry is deleted and treated as a miss,
    never returned. Writes are atomic (pid-suffixed tmp + ``os.replace``)
    so concurrent distpolish workers can share one directory. Eviction
    is LRU-by-mtime down to ``max_bytes``.
    """

    def __init__(self, cache_dir: str, max_bytes: int = DEFAULT_CACHE_BYTES):
        self.dir = cache_dir
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        os.makedirs(self.dir, exist_ok=True)
        self._pin_identity()

    def _pin_identity(self) -> None:
        meta_path = os.path.join(self.dir, "meta.json")
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as fh:
                    have = json.load(fh)
            except (OSError, ValueError):
                have = {}
            diff = {
                k: (have.get(k), v)
                for k, v in _CACHE_META.items()
                if have.get(k) != v
            }
            if diff:
                raise StoreMismatch("block cache", self.dir, diff)
            return
        tmp = f"{meta_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(_CACHE_META, fh, sort_keys=True)
        os.replace(tmp, meta_path)

    @staticmethod
    def key(url: str, ident: str, offset: int, length: int) -> str:
        h = hashlib.sha256()
        h.update(f"{url}\x00{ident}\x00{offset}\x00{length}".encode())
        return h.hexdigest()

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, key[:2], key + ".blk")

    def get(self, key: str) -> Optional[bytes]:
        path = self._path(key)
        try:
            with open(path, "rb") as fh:
                digest = fh.read(65)[:64].decode("ascii", "replace")
                payload = fh.read()
        except OSError:
            return None
        if hashlib.sha256(payload).hexdigest() != digest:
            # torn/corrupt entry: delete so the refetch can repopulate
            _bump("cache_corrupt")
            with self._lock:
                try:
                    os.unlink(path)
                except OSError:
                    pass
            return None
        return payload

    def put(self, key: str, payload: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        digest = hashlib.sha256(payload).hexdigest()
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as fh:
                fh.write(digest.encode("ascii") + b"\n")
                fh.write(payload)
            os.replace(tmp, path)
        except OSError:
            # a full/readonly cache disk degrades to uncached reads —
            # the data plane must not fail because the *cache* did
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return
        self._evict()

    def _entries(self):
        for sub in os.listdir(self.dir):
            d = os.path.join(self.dir, sub)
            if len(sub) != 2 or not os.path.isdir(d):
                continue
            for name in os.listdir(d):
                if name.endswith(".blk"):
                    yield os.path.join(d, name)

    def stats(self) -> Tuple[int, int]:
        """(entry count, total bytes) — what ``cache_probe`` prints."""
        entries = total = 0
        for path in self._entries():
            try:
                total += os.path.getsize(path)
                entries += 1
            except OSError:
                pass
        return entries, total

    def _evict(self) -> None:
        with self._lock:
            sized = []
            total = 0
            for path in self._entries():
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                sized.append((st.st_mtime, st.st_size, path))
                total += st.st_size
            if total <= self.max_bytes:
                return
            for _, size, path in sorted(sized):
                try:
                    os.unlink(path)
                except OSError:
                    continue
                total -= size
                if total <= self.max_bytes:
                    break


# -- transport ---------------------------------------------------------------

def http_transport(method: str, url: str, headers: Dict[str, str],
                   body: Optional[bytes], timeout: float):
    """One stdlib HTTP round-trip: ``(status, lowercase headers, body)``.
    A fresh connection per call — thread-safe and proxy-simple; the
    block cache, not keep-alive, is this client's latency lever."""
    u = urllib.parse.urlsplit(url)
    conn_cls = (
        http.client.HTTPSConnection if u.scheme == "https"
        else http.client.HTTPConnection
    )
    conn = conn_cls(u.hostname, u.port, timeout=timeout)
    try:
        path = u.path or "/"
        if u.query:
            path += "?" + u.query
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        try:
            data = resp.read()
        except http.client.IncompleteRead as e:
            # surface what DID arrive; the caller's length check refuses
            data = e.partial
        hdrs = {k.lower(): v for k, v in resp.getheaders()}
        return resp.status, hdrs, data
    finally:
        conn.close()


# -- the client --------------------------------------------------------------

def _parse_retry_after(value: Optional[str]) -> Optional[float]:
    if not value:
        return None
    try:
        return max(0.0, float(value))
    except ValueError:
        return None  # HTTP-date form: ignore, backoff still applies


def _parse_content_length(value: Optional[str]) -> Optional[int]:
    """A malformed Content-Length is treated as absent, never as a bare
    ValueError escaping the typed-error contract."""
    if value is None:
        return None
    try:
        return int(value)
    except ValueError:
        return None


class ObjectStore:
    """The hardened ranged-read client. Thread-safe; one instance
    serves a whole process (`default_store()`)."""

    def __init__(
        self,
        *,
        cache_dir: Optional[str] = None,
        cache_bytes: int = DEFAULT_CACHE_BYTES,
        block_bytes: int = DEFAULT_BLOCK_BYTES,
        timeout_s: float = 30.0,
        retry: Optional[RetryPolicy] = None,
        hedge_s: float = 0.0,
        breaker_failures: int = 5,
        breaker_reset_s: float = 30.0,
        endpoint: Optional[str] = None,
        transport: Optional[Callable] = None,
        log: Optional[Callable[[str], None]] = None,
    ):
        if block_bytes < 1:
            raise ValueError(f"block_bytes must be >= 1, got {block_bytes}")
        self.block_bytes = int(block_bytes)
        self.timeout_s = float(timeout_s)
        self.hedge_s = float(hedge_s)
        self.endpoint = endpoint
        self.log = log
        self.retry = retry or RetryPolicy(
            max_attempts=4, base_delay_s=0.2, max_delay_s=10.0,
            retryable=(StoreError, OSError),
        )
        self.transport = transport or http_transport
        self.cache = (
            BlockCache(cache_dir, cache_bytes) if cache_dir else None
        )
        self._breaker_failures = int(breaker_failures)
        self._breaker_reset_s = float(breaker_reset_s)
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._breakers_lock = threading.Lock()
        self._scratch: Optional[str] = None
        self._scratch_lock = threading.Lock()

    # -- URL resolution ------------------------------------------------------

    def resolve_url(self, url: str) -> str:
        """``gs://bucket/key`` / ``s3://bucket/key`` -> the configured
        HTTP(S) gateway; ``http(s)://`` passes through."""
        scheme = path_scheme(url)
        if scheme in ("http", "https"):
            return url
        if scheme in ("gs", "s3"):
            ep = self.endpoint or os.environ.get("ROKO_STORE_ENDPOINT")
            if not ep:
                raise StoreError(
                    f"cannot resolve {url!r}: {scheme}:// URLs need an "
                    "HTTP(S) gateway endpoint — set ROKO_STORE_ENDPOINT "
                    "(or StoreConfig.endpoint) to e.g. "
                    "http://storage-gateway:9000"
                )
            return ep.rstrip("/") + "/" + url.split("://", 1)[1]
        raise StoreError(
            f"unsupported store URL scheme {scheme!r} in {url!r} "
            f"(supported: {', '.join(STORE_SCHEMES)})"
        )

    def _breaker(self, url: str) -> Tuple[str, CircuitBreaker]:
        key = urllib.parse.urlsplit(self.resolve_url(url)).netloc
        with self._breakers_lock:
            br = self._breakers.get(key)
            if br is None:
                br = self._breakers[key] = CircuitBreaker(
                    failure_threshold=self._breaker_failures,
                    reset_s=self._breaker_reset_s,
                )
            return key, br

    # -- one attempt ---------------------------------------------------------

    def _request(
        self,
        method: str,
        url: str,
        headers: Optional[Dict[str, str]] = None,
        body: Optional[bytes] = None,
    ):
        """ONE breaker-guarded attempt; retry/hedge layer above."""
        endpoint, br = self._breaker(url)
        if not br.allow():
            _bump("breaker_open")
            obs_events.emit(
                "store", "store_breaker_open", log=self.log,
                endpoint=endpoint, retry_after_s=br.retry_after_s(),
            )
            raise BreakerOpen(endpoint, br.retry_after_s())
        resolved = self.resolve_url(url)
        _bump("requests")
        try:
            status, hdrs, data = self.transport(
                method, resolved, dict(headers or {}), body, self.timeout_s
            )
        except (OSError, http.client.HTTPException) as e:
            br.record_failure()
            _bump("request_failures")
            raise StoreError(f"{method} {url!r} failed: {e}") from e
        if status >= 500 or status == 429:
            br.record_failure()
            _bump("request_failures")
            raise StoreHTTPError(
                url, status, reason=data[:200].decode("utf-8", "replace"),
                retry_after=_parse_retry_after(hdrs.get("retry-after")),
            )
        # a body shorter than Content-Length is a transport fault, not
        # an object property — it counts against the endpoint's breaker.
        # An unparsable header is treated as absent (the typed-error
        # contract: callers only ever see StoreError/OSError).
        want = _parse_content_length(hdrs.get("content-length"))
        if (
            method != "HEAD" and want is not None
            and len(data) != want
        ):
            br.record_failure()
            _bump("request_failures")
            raise TruncatedRead(
                f"{method} {url!r}: body {len(data)}B != "
                f"Content-Length {want}B"
            )
        br.record_success()
        if status >= 400:
            raise StoreHTTPError(url, status,
                                 reason=data[:200].decode("utf-8", "replace"))
        return status, hdrs, data

    def _retrying(self, what: str, url: str, fn: Callable):
        """Wrap one-attempt ``fn`` in the shared RetryPolicy with
        ``Retry-After``/breaker-cooldown floors and the retry event."""

        def on_retry(failures: int, exc: BaseException, delay: float):
            _bump("retries")
            obs_events.emit(
                "store", "store_retry", log=self.log,
                op=what, url=url, attempt=failures, delay_s=delay,
                error=f"{type(exc).__name__}: {exc}"[:200],
            )

        def giveup(exc: BaseException) -> bool:
            # 4xx (other than 429, already excluded by _request raising
            # it as retryable-5xx class) is a caller bug or a missing
            # object: retrying cannot help
            return (
                isinstance(exc, StoreHTTPError)
                and 400 <= exc.status < 500 and exc.status != 429
            )

        return self.retry.call(
            fn,
            on_retry=on_retry,
            retry_after=lambda e: getattr(e, "retry_after", None),
            giveup=giveup,
        )

    # -- public ops ----------------------------------------------------------

    def stat(self, url: str) -> Tuple[int, str]:
        """``(size, identity)`` via HEAD. Identity is the server's
        checksum header or ETag (falls back to the size) — what block
        cache keys and localized copies pin against, so a replaced
        remote object invalidates every cached byte of the old one."""

        def attempt():
            _, hdrs, _ = self._request("HEAD", url)
            want = _parse_content_length(hdrs.get("content-length"))
            size = -1 if want is None else want
            ident = (
                hdrs.get(CHECKSUM_HEADER)
                or hdrs.get("etag", "").strip('"')
                or f"size={size}"
            )
            return size, ident

        return self._retrying("stat", url, attempt)

    def _ranged_get(self, url: str, offset: int, length: int) -> bytes:
        def attempt():
            end = offset + length - 1
            status, hdrs, data = self._request(
                "GET", url, headers={"Range": f"bytes={offset}-{end}"}
            )
            if status == 200:
                # server ignored Range: slice the full body
                data = data[offset:offset + length]
            if len(data) != length:
                raise TruncatedRead(
                    f"range [{offset}, {offset + length}) of {url!r}: "
                    f"got {len(data)}B, wanted {length}B"
                )
            return data

        if self.hedge_s <= 0:
            return self._retrying("read", url, attempt)
        return self._hedged(url, lambda: self._retrying("read", url, attempt))

    def _hedged(self, url: str, fn: Callable) -> bytes:
        """Race a second identical read against a straggling first one;
        first success wins, the loser's bytes are discarded (reads are
        idempotent, so duplication is safe)."""
        results: "queue.Queue" = queue.Queue()

        def run(tag: str):
            try:
                results.put((tag, fn(), None))
            except BaseException as e:  # noqa: BLE001 — reported below
                results.put((tag, None, e))

        legs = 1
        threading.Thread(
            target=run, args=("primary",), daemon=True
        ).start()
        try:
            tag, value, err = results.get(timeout=self.hedge_s)
        except queue.Empty:
            _bump("hedges")
            obs_events.emit(
                "store", "store_hedge", log=self.log,
                url=url, after_s=self.hedge_s,
            )
            legs = 2
            threading.Thread(
                target=run, args=("hedge",), daemon=True
            ).start()
            tag, value, err = results.get()
        if err is not None and legs == 2:
            # one of two legs failed: wait for the other before giving up
            tag, value, err2 = results.get()
            if err2 is not None:
                raise err
            err = None
        if err is not None:
            # sole leg failed (primary failed before the hedge fired):
            # there is no second result to wait for
            raise err
        if tag == "hedge":
            _bump("hedge_wins")
        return value

    def read_block(self, url: str, index: int, size: int,
                   ident: str) -> bytes:
        """One cache-backed block: block ``index`` of ``url`` whose
        total object size is ``size`` (the last block is short)."""
        offset = index * self.block_bytes
        length = min(self.block_bytes, size - offset)
        if length <= 0:
            return b""
        if self.cache is not None:
            key = BlockCache.key(url, ident, offset, length)
            data = self.cache.get(key)
            if data is not None:
                _bump("cache_hits")
                obs_events.emit(
                    "store", "cache_hit", quiet=True,
                    url=url, block=index, bytes=length,
                )
                return data
            _bump("cache_misses")
        data = self._ranged_get(url, offset, length)
        if self.cache is not None:
            self.cache.put(key, data)
        return data

    def get_object(self, url: str) -> bytes:
        """The whole object, length- and (when advertised) checksum-
        verified."""

        def attempt():
            _, hdrs, data = self._request("GET", url)
            want = hdrs.get(CHECKSUM_HEADER)
            if want and hashlib.sha256(data).hexdigest() != want:
                raise ChecksumMismatch(
                    f"GET {url!r}: body sha256 != advertised {want[:12]}…"
                )
            return data

        if self.hedge_s <= 0:
            return self._retrying("read", url, attempt)
        return self._hedged(url, lambda: self._retrying("read", url, attempt))

    def put_object(self, url: str, data: bytes) -> None:
        """Atomic read-verify-commit upload: PUT with the sha256
        header, then HEAD-verify size/identity; a mismatch (torn write)
        re-PUTs under the retry budget. The stub server (and any
        checksum-aware gateway) additionally verifies server-side and
        commits tmp+rename, so a torn body can never become the
        object."""
        sha = hashlib.sha256(data).hexdigest()
        first = [True]

        def attempt():
            if not first[0]:
                _bump("put_retries")
            first[0] = False
            self._request(
                "PUT", url, body=data,
                headers={
                    CHECKSUM_HEADER: sha,
                    "Content-Length": str(len(data)),
                },
            )
            size, ident = self.stat(url)
            diff = []
            if size != len(data):
                diff.append(f"size {size} != {len(data)}")
            if ident != sha and len(ident) == 64 and "-" not in ident:
                # only a plain sha256 identity is comparable — a
                # multipart/md5-style ETag says nothing either way
                diff.append(f"checksum {ident[:12]}… != {sha[:12]}…")
            if diff:
                raise ChecksumMismatch(
                    f"PUT {url!r} verification failed "
                    f"({'; '.join(diff)}) — torn write, re-uploading"
                )

        self._retrying("write", url, attempt)

    # -- file-like seams -----------------------------------------------------

    def open_read(self, url: str) -> io.BufferedReader:
        """Seekable read handle over ranged, block-cached GETs —
        what the ``open_input`` registry hands to h5py/fasta/json."""
        return io.BufferedReader(
            _StoreRawFile(self, url), buffer_size=self.block_bytes
        )

    def open_write(self, url: str, mode: str = "wb"):
        """Upload-on-close handle for ``open_output``: bytes spool in
        memory and commit atomically via :meth:`put_object` on
        ``close()``; ``abort()`` discards them (the error path of a
        partially produced output — never publish a torn artifact)."""
        buf = _StoreUploadBuffer(self, url)
        if "b" in mode:
            return buf
        return _TextUploadWrapper(buf)

    def opener(self, path: str, mode: str = "rb"):
        """The fsspec-style ``register_opener`` adapter."""
        if "r" not in mode or "+" in mode:
            raise ValueError(
                f"store opener is read-only; got mode {mode!r} for "
                f"{path!r} (writes go through open_output)"
            )
        return self.open_read(path)

    def writer(self, path: str, mode: str = "wb"):
        """The ``register_writer`` adapter."""
        if "w" not in mode or "+" in mode or "a" in mode:
            raise ValueError(
                f"store writer supports plain 'w'/'wb'; got {mode!r} "
                f"for {path!r}"
            )
        return self.open_write(path, mode)

    # -- whole-object localization -------------------------------------------

    def _scratch_dir(self) -> str:
        if self.cache is not None:
            d = os.path.join(self.cache.dir, "objects")
            os.makedirs(d, exist_ok=True)
            return d
        with self._scratch_lock:
            if self._scratch is None:
                self._scratch = tempfile.mkdtemp(prefix="roko-store-")
            return self._scratch

    def localize(self, url: str) -> str:
        """Download ``url`` to a local cached file and return its path
        — for consumers that need a real filename (the native BAM
        reader). Re-validated against the remote identity on every
        call: a replaced remote object re-downloads; an unchanged one
        is served from disk. Atomic (tmp + rename), so concurrent
        workers localizing the same URL never see a torn file."""
        size, ident = self.stat(url)
        if size < 0:
            # same refusal as _StoreRawFile: without a size we would
            # "download" zero blocks and commit an empty file as verified
            raise StoreError(
                f"localize {url!r}: server did not report an object size "
                "(Content-Length missing on HEAD)"
            )
        d = os.path.join(
            self._scratch_dir(),
            hashlib.sha256(url.encode()).hexdigest()[:16],
        )
        os.makedirs(d, exist_ok=True)
        dest = os.path.join(d, os.path.basename(
            urllib.parse.urlsplit(self.resolve_url(url)).path
        ) or "object")
        ident_path = dest + ".ident"
        try:
            with open(ident_path) as fh:
                have = json.load(fh)
            if (
                have.get("ident") == ident
                and os.path.getsize(dest) == size
            ):
                _bump("cache_hits")
                obs_events.emit(
                    "store", "cache_hit", quiet=True, url=url, bytes=size,
                )
                return dest
        except (OSError, ValueError):
            pass
        _bump("cache_misses")
        tmp = f"{dest}.tmp.{os.getpid()}"
        h = hashlib.sha256()
        with open(tmp, "wb") as out:
            n_blocks = max(1, -(-size // self.block_bytes))
            for i in range(n_blocks):
                block = self.read_block(url, i, size, ident)
                h.update(block)
                out.write(block)
        if ident == h.hexdigest() or ident.startswith("size="):
            pass  # identity verified (or server offered none beyond size)
        elif "-" not in ident and len(ident) == 64:
            os.unlink(tmp)
            raise ChecksumMismatch(
                f"localize {url!r}: assembled sha256 "
                f"{h.hexdigest()[:12]}… != remote {ident[:12]}…"
            )
        os.replace(tmp, dest)
        with open(f"{ident_path}.tmp.{os.getpid()}", "w") as fh:
            json.dump({"ident": ident, "size": size}, fh)
        os.replace(f"{ident_path}.tmp.{os.getpid()}", ident_path)
        return dest

    def localize_bam(self, url: str) -> str:
        """Localize a BAM plus its ``.bai`` sidecar (best-effort: an
        unindexed remote BAM still localizes; fetch() then scans)."""
        bam = self.localize(url)
        try:
            bai = self.localize(url + ".bai")
        except StoreError:
            return bam
        want = bam + ".bai"
        if os.path.realpath(bai) != os.path.realpath(want):
            tmp = f"{want}.tmp.{os.getpid()}"
            with open(bai, "rb") as src, open(tmp, "wb") as dst:
                dst.write(src.read())
            os.replace(tmp, want)
        return bam


class _StoreRawFile(io.RawIOBase):
    """Seekable raw reader over :meth:`ObjectStore.read_block`."""

    def __init__(self, store: ObjectStore, url: str):
        super().__init__()
        self._store = store
        self.url = url
        self._size, self._ident = store.stat(url)
        if self._size < 0:
            raise StoreError(
                f"{url!r}: server did not report an object size "
                "(Content-Length missing on HEAD)"
            )
        self._pos = 0

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        if whence == io.SEEK_SET:
            self._pos = offset
        elif whence == io.SEEK_CUR:
            self._pos += offset
        elif whence == io.SEEK_END:
            self._pos = self._size + offset
        else:
            raise ValueError(f"bad whence {whence}")
        if self._pos < 0:
            raise OSError(f"negative seek position {self._pos}")
        return self._pos

    def tell(self) -> int:
        return self._pos

    def readinto(self, b) -> int:
        n = min(len(b), self._size - self._pos)
        if n <= 0:
            return 0
        bb = self._store.block_bytes
        out = bytearray()
        first = self._pos // bb
        last = (self._pos + n - 1) // bb
        for i in range(first, last + 1):
            out.extend(
                self._store.read_block(self.url, i, self._size, self._ident)
            )
        start = self._pos - first * bb
        b[:n] = bytes(out[start:start + n])
        self._pos += n
        return n


class _StoreUploadBuffer(io.BytesIO):
    """Spool-then-commit write handle: ``close()`` uploads atomically
    through :meth:`ObjectStore.put_object`; ``abort()`` discards."""

    def __init__(self, store: ObjectStore, url: str):
        super().__init__()
        self._store = store
        self.url = url
        self._aborted = False
        self._committed = False

    def abort(self) -> None:
        self._aborted = True
        super().close()

    def close(self) -> None:
        if self.closed:
            return
        if not self._aborted and not self._committed:
            data = self.getvalue()
            super().close()
            self._committed = True
            self._store.put_object(self.url, data)
        else:
            super().close()


class _TextUploadWrapper(io.TextIOWrapper):
    """Text-mode face of :class:`_StoreUploadBuffer` (``open_output``
    mode ``"w"``), with ``abort()`` passed through."""

    def __init__(self, buf: _StoreUploadBuffer):
        super().__init__(buf, encoding="utf-8", newline="")
        self._buf = buf

    def abort(self) -> None:
        try:
            self.flush()
        except ValueError:
            pass
        self._buf.abort()


# -- default store wiring (open_input/open_output auto-install) --------------

_default_store: Optional[ObjectStore] = None
_default_lock = threading.Lock()


def _store_from_env() -> ObjectStore:
    env = os.environ
    store = ObjectStore(
        cache_dir=env.get("ROKO_STORE_CACHE") or None,
        cache_bytes=int(env.get("ROKO_STORE_CACHE_BYTES",
                                DEFAULT_CACHE_BYTES)),
        block_bytes=int(env.get("ROKO_STORE_BLOCK_BYTES",
                                DEFAULT_BLOCK_BYTES)),
        timeout_s=float(env.get("ROKO_STORE_TIMEOUT_S", 30.0)),
        hedge_s=float(env.get("ROKO_STORE_HEDGE_S", 0.0)),
        breaker_failures=int(env.get("ROKO_STORE_BREAKER_FAILURES", 5)),
        breaker_reset_s=float(env.get("ROKO_STORE_BREAKER_RESET_S", 30.0)),
        endpoint=env.get("ROKO_STORE_ENDPOINT") or None,
    )
    faults = env.get("ROKO_STORE_FAULTS")
    if faults:
        store.transport = FaultyStore(
            store.transport, parse_fault_spec(faults),
            seed=int(env.get("ROKO_STORE_FAULT_SEED", os.getpid())),
        )
    return store


def default_store() -> ObjectStore:
    """The process-wide client (built from ``ROKO_STORE_*`` env on
    first use; :func:`configure_store` replaces it)."""
    global _default_store
    with _default_lock:
        if _default_store is None:
            _default_store = _store_from_env()
        return _default_store


def install(store: Optional[ObjectStore] = None) -> ObjectStore:
    """Register ``store`` (default: the env-built client) as the
    process-wide opener/writer for every store scheme. Idempotent."""
    from roko_tpu_torch.datapipe import io as dio

    global _default_store
    if store is not None:
        with _default_lock:
            _default_store = store
    store = default_store()
    for scheme in STORE_SCHEMES:
        dio.register_opener(scheme, store.opener)
        dio.register_writer(scheme, store.writer)
    return store


def configure_store(cfg) -> ObjectStore:
    """Build + install the client from a ``StoreConfig`` (CLI path).
    ``ROKO_STORE_FAULTS`` applies on top — fault injection is an
    environment property, not a config one, so a CI lane can wrap ANY
    invocation. ``ROKO_STORE_ENDPOINT``/``ROKO_STORE_CACHE`` fill in
    fields the config left unset, same reason."""
    env = os.environ
    store = ObjectStore(
        cache_dir=cfg.cache_dir or env.get("ROKO_STORE_CACHE") or None,
        cache_bytes=cfg.cache_bytes,
        block_bytes=cfg.block_bytes,
        timeout_s=cfg.timeout_s,
        retry=RetryPolicy(
            max_attempts=cfg.max_attempts, base_delay_s=0.2,
            max_delay_s=10.0, retryable=(StoreError, OSError),
        ),
        hedge_s=cfg.hedge_s,
        breaker_failures=cfg.breaker_failures,
        breaker_reset_s=cfg.breaker_reset_s,
        endpoint=cfg.endpoint or env.get("ROKO_STORE_ENDPOINT") or None,
    )
    faults = os.environ.get("ROKO_STORE_FAULTS")
    if faults:
        store.transport = FaultyStore(
            store.transport, parse_fault_spec(faults),
            seed=int(os.environ.get("ROKO_STORE_FAULT_SEED", os.getpid())),
        )
    return install(store)


# -- the stub object-store server (tests and the card's smoke run) -----------

class _StubHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):  # quiet under pytest
        pass

    def _local(self) -> Optional[str]:
        rel = urllib.parse.unquote(self.path.lstrip("/"))
        root = os.path.realpath(self.server.root)
        full = os.path.realpath(os.path.join(root, rel))
        if full != root and not full.startswith(root + os.sep):
            return None
        return full

    def _scripted_fault(self) -> Optional[Dict[str, Any]]:
        with self.server.faults_lock:
            if self.server.faults:
                return self.server.faults.pop(0)
        return None

    def _apply_fault(self, fault: Dict[str, Any], data: bytes):
        kind = fault.get("kind", "status")
        if kind == "sleep":
            import time as _t

            _t.sleep(float(fault.get("s", 1.0)))
            return None, data  # sleep then serve normally
        status = int(fault.get("status", 500))
        # the faulted reply may leave an unread request body on the
        # socket (PUT): drop the connection so it can't be misparsed
        # as a next request
        self.close_connection = True
        self.send_response(status)
        if fault.get("retry_after") is not None:
            self.send_header("Retry-After", str(fault["retry_after"]))
        self.send_header("Content-Length", "0")
        self.end_headers()
        return status, data

    def _serve(self, head_only: bool) -> None:
        full = self._local()
        if full is None or not os.path.isfile(full):
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        with open(full, "rb") as fh:
            data = fh.read()
        size = len(data)
        sha = hashlib.sha256(data).hexdigest()
        fault = self._scripted_fault()
        truncate = fault is not None and fault.get("kind") == "truncate"
        if fault is not None and not truncate:
            handled, data = self._apply_fault(fault, data)
            if handled is not None:
                return
        status, body = 200, data
        rng = self.headers.get("Range")
        content_range = None
        if rng and rng.startswith("bytes=") and not head_only:
            try:
                start_s, _, end_s = rng[len("bytes="):].partition("-")
                start = int(start_s)
                end = min(int(end_s) if end_s else size - 1, size - 1)
            except ValueError:
                start, end = 0, size - 1
            body = body[start:end + 1]
            status = 206
            content_range = f"bytes {start}-{end}/{size}"
        if truncate:
            # truncate the bytes actually requested — a ranged read must
            # see the fault too, not just whole-object GETs
            body = body[: len(body) // 2]
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        self.send_header(CHECKSUM_HEADER, sha)
        self.send_header("ETag", f'"{sha}"')
        self.send_header("Accept-Ranges", "bytes")
        if content_range:
            self.send_header("Content-Range", content_range)
        self.end_headers()
        if not head_only:
            self.wfile.write(body)

    def do_GET(self) -> None:
        self._serve(head_only=False)

    def do_HEAD(self) -> None:
        self._serve(head_only=True)

    def do_PUT(self) -> None:
        full = self._local()
        if full is None:
            self.close_connection = True
            self.send_response(403)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        fault = self._scripted_fault()
        if fault is not None and fault.get("kind", "status") == "status":
            self._apply_fault(fault, b"")
            return
        length = int(self.headers.get("Content-Length", 0))
        data = self.rfile.read(length)
        want = self.headers.get(CHECKSUM_HEADER)
        if want and hashlib.sha256(data).hexdigest() != want:
            # the server-side torn-write refusal: the object is NOT
            # committed — "never a torn remote object"
            self.send_response(422)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        os.makedirs(os.path.dirname(full), exist_ok=True)
        tmp = f"{full}.tmp.{threading.get_ident()}"
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, full)
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()


class StubObjectStore(ThreadingHTTPServer):
    """In-process object-store stub over a directory: Range GET / HEAD
    / checksum-verified atomic PUT, plus a scripted fault queue
    (``fail_next``) for deterministic fault-matrix tests."""

    daemon_threads = True

    def __init__(self, root: str, host: str = "127.0.0.1", port: int = 0):
        self.root = root
        self.faults: list = []
        self.faults_lock = threading.Lock()
        super().__init__((host, port), _StubHandler)

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"

    def fail_next(self, times: int = 1, *, status: int = 500,
                  retry_after: Optional[float] = None) -> None:
        with self.faults_lock:
            self.faults.extend(
                {"kind": "status", "status": status,
                 "retry_after": retry_after}
                for _ in range(times)
            )

    def truncate_next(self, times: int = 1) -> None:
        with self.faults_lock:
            self.faults.extend({"kind": "truncate"} for _ in range(times))

    def delay_next(self, seconds: float, times: int = 1) -> None:
        with self.faults_lock:
            self.faults.extend(
                {"kind": "sleep", "s": seconds} for _ in range(times)
            )

    def start(self) -> "StubObjectStore":
        threading.Thread(target=self.serve_forever, daemon=True).start()
        return self


def main(argv=None) -> int:
    """``python -m roko_tpu_torch.datapipe.store --root DIR [--port N]``:
    the stub object-store server over a directory, standalone."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--root", required=True, help="directory to serve")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument(
        "--port-file", default=None,
        help="write the bound port here (for 0 = ephemeral)",
    )
    args = ap.parse_args(argv)
    server = StubObjectStore(args.root, host=args.host, port=args.port)
    port = server.server_address[1]
    print(f"stub object store: {server.url} root={args.root}", flush=True)
    if args.port_file:
        with open(args.port_file, "w") as fh:
            fh.write(str(port))
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
