"""Standard-library client of the polishing service (the port's copy of
``roko_tpu/serve/client.py``).

Encodes window arrays in the wire format ``server.py`` expects (base64
raw little-endian), maps the server's backpressure reply to
:class:`ServerBusy` with the parsed ``retry_after_s``, and retries
through busy replies with the shared
:class:`roko_tpu_torch.resilience.RetryPolicy` — exponential backoff and
jitter, FLOORED by the server's ``Retry-After``. An exhausted retry
budget raises the typed :class:`ServiceUnavailable` with the attempt
count.
"""

from __future__ import annotations

import base64
import json
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Optional

import numpy as np

from roko_tpu_torch.resilience import RetryPolicy


class ServerBusy(RuntimeError):
    """503 from the service: queue full, retry after ``retry_after_s``."""

    def __init__(self, retry_after_s: float):
        super().__init__(f"server busy; retry after {retry_after_s:.1f}s")
        self.retry_after_s = retry_after_s


class QuotaExceededBusy(ServerBusy):
    """429 from the service: THIS TENANT's quota (queue or in-flight
    cap) is exhausted, not the global queue — other tenants are still
    being served. Retryable like :class:`ServerBusy` (the Retry-After
    is sized from the tenant's own backlog and drain rate), typed so
    callers can distinguish their own quota from fleet-wide
    pressure."""

    def __init__(self, retry_after_s: float, tenant: Optional[str] = None):
        RuntimeError.__init__(
            self,
            f"tenant quota exceeded"
            + (f" ({tenant})" if tenant else "")
            + f"; retry after {retry_after_s:.1f}s",
        )
        self.retry_after_s = retry_after_s
        self.tenant = tenant


class FleetDraining(ServerBusy):
    """503 with a DRAINING status: the server is deliberately shedding
    all new work for a shutdown window — not transient queue pressure.
    Typed so callers PARK work and re-submit later instead of burning a
    retry budget against a wait that outlasts it;
    :meth:`PolishClient.polish` propagates it immediately rather than
    retrying."""


class ServiceUnavailable(ServerBusy):
    """The retry budget was exhausted against 503s: every one of
    ``attempts`` tries was shed (queue full, breaker open, fleet
    degraded, or draining). Typed — not a bare HTTPError — so
    fleet-level load shedding is debuggable from the client side:
    ``attempts`` says how hard the client pushed and ``retry_after_s``
    what the server last asked for. When the client's total-deadline
    budget (not the attempt count) ended the retries, ``deadline_s``
    carries it and the message names it."""

    def __init__(
        self,
        retry_after_s: float,
        attempts: int,
        deadline_s: Optional[float] = None,
    ):
        if deadline_s is not None:
            msg = (
                f"service unavailable: {attempts} attempt(s) got 503 "
                f"and the next Retry-After wait would overshoot the "
                f"client deadline budget deadline_s={deadline_s:.1f}s; "
                f"last Retry-After {retry_after_s:.1f}s"
            )
        else:
            msg = (
                f"service unavailable: all {attempts} attempt(s) got "
                f"503; last Retry-After {retry_after_s:.1f}s"
            )
        RuntimeError.__init__(self, msg)
        self.retry_after_s = retry_after_s
        self.attempts = attempts
        self.deadline_s = deadline_s


class _DeadlineExceeded(Exception):
    """Internal: the deadline-aware sleep refused to start a wait that
    would overshoot ``deadline_s`` (converted to
    :class:`ServiceUnavailable` at the retry-loop boundary)."""


def parse_503_body(body) -> "tuple[str, float]":
    """``(error_detail, retry_after_s)`` from a 503 reply body,
    tolerant of ANY malformation — detail parses FIRST so a junk
    ``retry_after_s`` never costs the draining classification; the
    wait falls back to 1.0."""
    detail, retry = "", 1.0
    try:
        parsed = json.loads(body)
        detail = str(parsed.get("error", ""))
        retry = float(parsed.get("retry_after_s", 1.0))
    except (ValueError, AttributeError, TypeError, UnicodeDecodeError):
        pass
    return detail, retry


def _b64(arr: np.ndarray, dtype) -> str:
    return base64.b64encode(
        np.ascontiguousarray(arr, dtype=np.dtype(dtype).newbyteorder("<"))
        .tobytes()
    ).decode("ascii")


class PolishClient:
    #: backoff shape behind ``retries`` (attempt budget layers on top);
    #: swap the attribute for a custom policy or a no-sleep test double
    retry_policy = RetryPolicy(
        base_delay_s=0.5, max_delay_s=30.0, retryable=(ServerBusy,)
    )

    def __init__(
        self,
        base_url: str,
        timeout: float = 120.0,
        deadline_s: Optional[float] = None,
    ):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        #: client-side TOTAL wall-clock budget across a whole retry
        #: loop: a fleet shedding load with large Retry-After hints can
        #: otherwise stretch `retries` waits far past what the caller
        #: can afford. A retry wait that would overshoot the budget is
        #: refused up front with :class:`ServiceUnavailable` naming the
        #: budget. None = unbounded (the historical behavior).
        self.deadline_s = deadline_s
        self._sleep = time.sleep  # injection point for tests

    # -- transport ----------------------------------------------------------

    def _request(
        self, path: str, payload: Optional[Dict[str, Any]] = None,
        headers: Optional[Dict[str, str]] = None,
    ) -> Any:
        url = self.base_url + path
        data = None if payload is None else json.dumps(payload).encode()
        hdrs = {"Content-Type": "application/json"} if data else {}
        hdrs.update(headers or {})
        req = urllib.request.Request(
            url,
            data=data,
            headers=hdrs,
            method="POST" if data else "GET",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                body = resp.read()
        except urllib.error.HTTPError as e:
            body = e.read()
            if e.code == 503:
                detail, retry = parse_503_body(body)
                if "draining" in detail:
                    # the server names a deliberate drain window
                    # (healthz=draining): typed, so callers can park
                    # instead of retrying into the drain
                    raise FleetDraining(retry) from None
                raise ServerBusy(retry) from None
            if e.code == 429:
                # per-tenant quota breach: the Retry-After header (or
                # body field) carries the tenant-sized wait
                try:
                    parsed = json.loads(body)
                    retry = float(parsed.get("retry_after_s", 1.0))
                    tenant = parsed.get("tenant")
                except (ValueError, TypeError, UnicodeDecodeError):
                    retry, tenant = 1.0, None
                try:
                    retry = max(
                        retry, float(e.headers.get("Retry-After", 0))
                    )
                except (TypeError, ValueError):
                    pass
                raise QuotaExceededBusy(retry, tenant) from None
            try:
                detail = json.loads(body).get("error", "")
            except ValueError:
                detail = body[:200].decode(errors="replace")
            raise RuntimeError(f"HTTP {e.code} from {path}: {detail}") from None
        return body

    # -- routes -------------------------------------------------------------

    def healthz(self) -> Dict[str, Any]:
        return json.loads(self._request("/healthz"))

    def metrics(self) -> str:
        return self._request("/metrics").decode()

    def tracez(self, last: Optional[int] = None) -> Dict[str, Any]:
        """The trace ring + scheduler snapshot."""
        path = "/tracez" + (f"?last={int(last)}" if last else "")
        return json.loads(self._request(path))

    def _post_with_retries(
        self, payload: Dict[str, Any], retries: int,
        request_id: Optional[str] = None,
        extra_headers: Optional[Dict[str, str]] = None,
        deadline_s: Optional[float] = None,
    ) -> Dict[str, Any]:
        """POST /polish, sleeping through up to ``retries``
        :class:`ServerBusy` replies (503: queue full, breaker open, or
        draining; 429: tenant quota) with the policy's backoff floored
        by the server's ``Retry-After`` — never failing on the first
        backpressure response unless asked to (``retries=0``).
        Exhausting the budget raises the typed
        :class:`ServiceUnavailable` (a ServerBusy subclass) carrying
        the attempt count. ``deadline_s`` (or the constructor's)
        additionally bounds the TOTAL wall clock: a retry wait that
        would overshoot it raises ServiceUnavailable naming the budget
        instead of sleeping into it."""
        import dataclasses

        policy = dataclasses.replace(
            self.retry_policy, max_attempts=retries + 1
        )
        deadline_s = self.deadline_s if deadline_s is None else deadline_s
        t0 = time.monotonic()
        attempts = [0]
        last_hint = [1.0]

        def probe():
            attempts[0] += 1
            return (
                self._request("/polish", payload, headers)
                if headers
                else self._request("/polish", payload)
            )

        def hint(e):
            v = getattr(e, "retry_after_s", None)
            if v is not None:
                last_hint[0] = v
            return v

        def budget_sleep(delay: float) -> None:
            if (
                deadline_s is not None
                and time.monotonic() - t0 + delay > deadline_s
            ):
                raise _DeadlineExceeded()
            self._sleep(delay)

        # the 2-arg call stays the default so _request stand-ins (tests)
        # keep working; headers ride only when something is pinned
        headers = dict(extra_headers or {})
        if request_id:
            headers["X-Roko-Request-Id"] = request_id
        headers = headers or None
        try:
            return json.loads(
                policy.call(
                    probe,
                    retry_after=hint,
                    sleep=budget_sleep,
                    # a draining fleet asks callers to PARK, not retry:
                    # propagate the typed signal with the budget intact
                    giveup=lambda e: isinstance(e, FleetDraining),
                )
            )
        except _DeadlineExceeded:
            raise ServiceUnavailable(
                last_hint[0], attempts[0], deadline_s=deadline_s
            ) from None
        except (ServiceUnavailable, FleetDraining):
            raise
        except ServerBusy as e:
            raise ServiceUnavailable(e.retry_after_s, retries + 1) from e

    def polish(
        self,
        draft: str,
        positions: np.ndarray,
        examples: np.ndarray,
        contig: str = "seq",
        retries: int = 4,
        request_id: Optional[str] = None,
        tenant: Optional[str] = None,
        model: Optional[str] = None,
        deadline_s: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Polish one contig from pre-extracted windows. ``retries``
        bounds how many :class:`ServerBusy` replies are slept through
        (honouring the server's retry-after as a backoff floor) before
        giving up; 0 surfaces the first busy reply. ``request_id`` pins
        the trace identity (``X-Roko-Request-Id``) — by default the
        service mints one and returns it in the reply.

        ``tenant`` names the fair-share/quota bucket this request bills
        to (``X-Roko-Tenant``; the default tenant otherwise). ``model``
        PINS a model version (``X-Roko-Model``): a server running another
        version (its ``ROKO_MODEL_VERSION``) refuses loudly
        (RegistryMismatch, HTTP 400) rather than silently serving it.

        ``deadline_s`` caps the TOTAL wall clock the retry loop may
        spend (overrides the constructor's): large fleet Retry-After
        hints are honoured only while they fit the budget, past it
        :class:`ServiceUnavailable` names the budget."""
        examples = np.asarray(examples)
        payload = {
            "contig": contig,
            "draft": draft,
            "n": int(examples.shape[0]),
            "positions": _b64(positions, np.int64),
            "examples": _b64(examples, np.uint8),
        }
        headers: Dict[str, str] = {}
        if tenant is not None:
            payload["tenant"] = tenant
            headers["X-Roko-Tenant"] = tenant
        if model is not None:
            payload["model"] = model
            headers["X-Roko-Model"] = model
        return self._post_with_retries(
            payload, retries, request_id, headers or None,
            deadline_s=deadline_s,
        )

    def polish_bam(
        self, ref: str, bam: str, workers: int = 1, seed: int = 0,
        retries: int = 4,
    ) -> Dict[str, Any]:
        """Extractor convenience path: ``ref``/``bam`` are paths on the
        SERVER's filesystem; ``seed`` is the row-sampling seed (matches
        the ``features`` CLI's ``--seed``). Busy replies retry as in
        :meth:`polish`."""
        return self._post_with_retries(
            {"ref": ref, "bam": bam, "workers": workers, "seed": seed},
            retries,
        )
