"""Fault-injectable TCP transport of the federated serving plane (the
port's copy of ``roko_tpu/serve/transport.py``).

A *transport* is the one seam every federation byte crosses: the front
end's relays to host agents, the agents' lease heartbeats back to the
front end, and the metrics scrapes in between all go through a callable
with the signature

    transport(method, host, port, path, headers=None, body=None,
              timeout=..., peer="") -> (status, headers_dict, body_bytes)

``HttpTransport`` is the real thing (http.client over TCP).
``FaultyTransport`` wraps any transport and injects scripted network
faults, the network-plane twin of ``datapipe.store.FaultyStore``: it
drives real multi-process fleets through drops, delays, duplicated
requests and named partitions on loopback.

Fault spec (env ``ROKO_FED_FAULTS``), comma-separated:

    drop:0.05,delay:0.1,duplicate:0.02,partition:front-h1

- ``drop:RATE``       raise ConnectionError before any byte is sent
- ``delay:RATE``      sleep ``ROKO_FED_DELAY_S`` (default 0.05 s) first
- ``duplicate:RATE``  send the request twice; the *second* reply is
                      returned (exercises idempotency and epoch fencing)
- ``partition:A-B``   total blackhole between endpoints named A and B
                      (unordered pair; repeatable)

Rates are in [0, 1]: rate 0 is the identity transport, ``drop:1`` a total
partition. Unknown kinds and out-of-range rates are refused loudly: a
chaos run that silently injects nothing is worse than none. Under one
spec and seed (``ROKO_FED_FAULTS_SEED``) the decisions are drawn in the
reference's order, so the drop, duplicate and partition outcomes are the
reference's, call for call.
"""

from __future__ import annotations

import http.client
import os
import random
import threading
import time
from typing import Dict, FrozenSet, Iterable, Optional, Set, Tuple

__all__ = [
    "FED_FAULT_KINDS",
    "FaultyTransport",
    "HttpTransport",
    "parse_fed_faults",
    "transport_from_env",
]

FED_FAULT_KINDS = ("drop", "delay", "duplicate", "partition")

TransportReply = Tuple[int, Dict[str, str], bytes]


class HttpTransport:
    """Plain HTTP/TCP transport. One connection per call — federation
    control traffic is low-rate and the simplicity buys clean failure
    semantics (every fault is a fresh ConnectionError, never a
    half-poisoned keep-alive socket)."""

    def __call__(
        self,
        method: str,
        host: str,
        port: int,
        path: str,
        headers: Optional[Dict[str, str]] = None,
        body: Optional[bytes] = None,
        timeout: float = 10.0,
        peer: str = "",
    ) -> TransportReply:
        conn = http.client.HTTPConnection(host, port, timeout=timeout)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, dict(resp.getheaders()), data
        finally:
            conn.close()


def parse_fed_faults(
    spec: str,
) -> Tuple[Dict[str, float], Set[FrozenSet[str]]]:
    """Parse a ``ROKO_FED_FAULTS`` spec into (rates, partition pairs).

    Refuses unknown kinds and out-of-range rates with a loud
    ValueError naming the valid kinds — mirrors the FaultyStore spec
    parser so a typo'd chaos config can never silently become a
    no-fault run.
    """
    rates: Dict[str, float] = {}
    partitions: Set[FrozenSet[str]] = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        kind, _, val = part.partition(":")
        kind = kind.strip()
        if kind not in FED_FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} in ROKO_FED_FAULTS "
                f"(valid: {', '.join(FED_FAULT_KINDS)})"
            )
        if kind == "partition":
            a, sep, b = val.partition("-")
            a, b = a.strip(), b.strip()
            if not sep or not a or not b or a == b:
                raise ValueError(
                    f"partition spec {part!r} must name two distinct "
                    "endpoints as partition:a-b"
                )
            partitions.add(frozenset((a, b)))
            continue
        try:
            rate = float(val)
        except ValueError:
            raise ValueError(
                f"fault rate {val!r} for {kind!r} is not a number"
            ) from None
        if not 0.0 <= rate <= 1.0:
            raise ValueError(
                f"fault rate {rate} for {kind!r} out of range [0, 1]"
            )
        rates[kind] = rate
    return rates, partitions


class FaultyTransport:
    """Wrap a transport and inject scripted network faults.

    ``name`` is this endpoint's identity for partition matching: a
    partition pair {A, B} blackholes any call where {self.name, peer}
    equals the pair. ``partition()`` / ``heal()`` script partitions
    mid-test; ``injected`` counts every fault actually fired so tests
    can assert the chaos really happened.
    """

    def __init__(
        self,
        inner,
        rates: Optional[Dict[str, float]] = None,
        partitions: Iterable[FrozenSet[str]] = (),
        seed: int = 0,
        name: str = "",
        delay_s: float = 0.05,
    ) -> None:
        rates = dict(rates or {})
        for kind, rate in rates.items():
            if kind not in FED_FAULT_KINDS or kind == "partition":
                raise ValueError(f"unknown fault kind {kind!r}")
            if not 0.0 <= rate <= 1.0:
                raise ValueError(
                    f"fault rate {rate} for {kind!r} out of range [0, 1]"
                )
        self.inner = inner
        self.rates = rates
        self.name = name
        self.delay_s = delay_s
        self._partitions: Set[FrozenSet[str]] = set(partitions)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.injected: Dict[str, int] = {k: 0 for k in FED_FAULT_KINDS}

    def partition(self, a: str, b: str) -> None:
        with self._lock:
            self._partitions.add(frozenset((a, b)))

    def heal(self, a: str, b: str) -> None:
        with self._lock:
            self._partitions.discard(frozenset((a, b)))

    def _roll(self, kind: str) -> bool:
        rate = self.rates.get(kind, 0.0)
        if rate <= 0.0:
            return False
        with self._lock:
            hit = self._rng.random() < rate
            if hit:
                self.injected[kind] += 1
        return hit

    def _partitioned(self, peer: str) -> bool:
        if not peer or not self.name:
            return False
        pair = frozenset((self.name, peer))
        with self._lock:
            if pair in self._partitions:
                self.injected["partition"] += 1
                return True
        return False

    def __call__(
        self,
        method: str,
        host: str,
        port: int,
        path: str,
        headers: Optional[Dict[str, str]] = None,
        body: Optional[bytes] = None,
        timeout: float = 10.0,
        peer: str = "",
    ) -> TransportReply:
        if self._partitioned(peer):
            raise ConnectionError(
                f"injected partition between {self.name!r} and {peer!r}"
            )
        if self._roll("drop"):
            raise ConnectionError(
                f"injected drop from {self.name!r} to {peer!r} ({path})"
            )
        if self._roll("delay"):
            time.sleep(self.delay_s)
        send = lambda: self.inner(  # noqa: E731
            method, host, port, path, headers=headers, body=body,
            timeout=timeout, peer=peer,
        )
        if self._roll("duplicate"):
            first = send()
            try:
                return send()
            except (OSError, http.client.HTTPException):
                return first
        return send()


def transport_from_env(
    name: str,
    inner=None,
    env: Optional[Dict[str, str]] = None,
):
    """Build this endpoint's transport, honoring ``ROKO_FED_FAULTS``.

    Returns a bare ``HttpTransport`` when no faults are configured, so
    the common path pays nothing for the chaos machinery.
    """
    env = os.environ if env is None else env
    inner = inner or HttpTransport()
    spec = env.get("ROKO_FED_FAULTS", "").strip()
    if not spec:
        return inner
    rates, partitions = parse_fed_faults(spec)
    if not rates and not partitions:
        return inner
    try:
        delay_s = float(env.get("ROKO_FED_DELAY_S", "0.05"))
    except ValueError:
        delay_s = 0.05
    try:
        seed = int(env.get("ROKO_FED_FAULTS_SEED", "0"))
    except ValueError:
        seed = 0
    return FaultyTransport(
        inner,
        rates,
        partitions=partitions,
        seed=seed,
        name=name,
        delay_s=delay_s,
    )
