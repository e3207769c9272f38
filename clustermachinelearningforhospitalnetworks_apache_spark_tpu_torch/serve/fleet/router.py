"""Tenant-aware request routing over a set of replicas.

Two policies, both health-aware (a breaker-OPEN, draining, or dead
replica is never picked):

* **least_loaded** — the replica with the fewest queued rows right now;
  the default for anonymous traffic, where stickiness buys nothing.
* **consistent_hash** — a hash ring with ``vnodes`` virtual nodes per
  replica: a tenant id always lands on the same replica (sticky slices —
  a hospital's farm traffic keeps hitting warm state), and adding or
  removing one replica reshuffles only ~1/N of tenants (the classic
  ring property; pinned by test).  When a tenant's home replica is
  unhealthy the walk continues clockwise, so failover is ALSO sticky:
  every orphaned tenant of a dead replica lands on its ring successor,
  and returns home when the replica does.

The router never answers requests itself — it picks; the
:class:`~.replica_set.ReplicaSet` owns admission and dispatch.  Pure
host-side state, unit-testable with stub replicas.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
from typing import Protocol, Sequence

POLICY_LEAST_LOADED = "least_loaded"
POLICY_CONSISTENT_HASH = "consistent_hash"
POLICIES = (POLICY_LEAST_LOADED, POLICY_CONSISTENT_HASH)


class NoReplicaAvailable(RuntimeError):
    """Every replica is dead, draining, or breaker-OPEN for the model —
    the caller sheds the request (unavailable), it does not hang."""


class RoutableReplica(Protocol):
    """What the router needs to know about a replica — satisfied by
    :class:`~.replica_set.Replica` and by test stubs."""

    index: int

    def healthy(self) -> bool: ...

    def load_rows(self) -> int: ...

    def breaker_open(self, model: str) -> bool: ...


def _hash64(key: str) -> int:
    """Stable 64-bit point on the ring (blake2b — crc32's 32-bit space
    shows measurable vnode collisions at a few hundred vnodes)."""
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "big"
    )


class ConsistentHashRing:
    """The ring itself: replica ids at ``vnodes`` hashed points each.

    ``preference(key)`` returns every distinct replica id in clockwise
    order from the key's point — element 0 is the sticky home, element 1
    the sticky failover, and so on.  Membership changes move only the
    arcs the changed replica owned: the ≤ ~1/N reshuffle contract."""

    def __init__(self, vnodes: int = 160):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = vnodes
        self._points: list[tuple[int, int]] = []  # sorted (hash, replica_id)
        self._ids: set[int] = set()
        self._lock = threading.Lock()
        #: bumped on every membership change — invalidates routing caches
        self.generation = 0

    def add(self, replica_id: int) -> None:
        with self._lock:
            if replica_id in self._ids:
                return
            self._ids.add(replica_id)
            for v in range(self.vnodes):
                h = _hash64(f"replica:{replica_id}#vnode:{v}")
                bisect.insort(self._points, (h, replica_id))
            self.generation += 1

    def remove(self, replica_id: int) -> None:
        with self._lock:
            if replica_id not in self._ids:
                return
            self._ids.discard(replica_id)
            self._points = [
                p for p in self._points if p[1] != replica_id
            ]
            self.generation += 1

    def members(self) -> set[int]:
        with self._lock:
            return set(self._ids)

    def preference(self, key: str) -> list[int]:
        """Distinct replica ids clockwise from ``key``'s ring point."""
        with self._lock:
            if not self._points:
                return []
            start = bisect.bisect_right(self._points, (_hash64(key), -1))
            seen: list[int] = []
            n = len(self._points)
            for step in range(n):
                rid = self._points[(start + step) % n][1]
                if rid not in seen:
                    seen.append(rid)
                    if len(seen) == len(self._ids):
                        break
            return seen

    def owner(self, key: str) -> int | None:
        pref = self.preference(key)
        return pref[0] if pref else None


class Router:
    """Policy + health filter over the fleet's replicas."""

    def __init__(
        self,
        replicas: Sequence[RoutableReplica],
        policy: str = POLICY_CONSISTENT_HASH,
        vnodes: int = 160,
    ):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")
        self.policy = policy
        self._replicas: dict[int, RoutableReplica] = {
            r.index: r for r in replicas
        }
        self.ring = ConsistentHashRing(vnodes=vnodes)
        for r in replicas:
            self.ring.add(r.index)
        #: tenant → (ring generation, preference list): the hash + ring
        #: walk runs once per tenant per membership change, not per
        #: request.  Bounded: evicted wholesale when it outgrows the cap
        #: (garbage tenant ids must not grow it without bound).
        self._pref_cache: dict[str, tuple[int, list[int]]] = {}
        self._pref_cap = 4096

    # ------------------------------------------------------------ membership
    def add_replica(self, replica: RoutableReplica) -> None:
        self._replicas[replica.index] = replica
        self.ring.add(replica.index)

    def remove_replica(self, index: int) -> None:
        """Scale-down: the replica leaves the RING (its tenants reshuffle
        to their ring successors — ~1/N of the key space).  A merely
        UNHEALTHY replica stays on the ring so its tenants fail over to
        the successor and come home on recovery."""
        self._replicas.pop(index, None)
        self.ring.remove(index)

    # ------------------------------------------------------------ routing
    def _eligible(self, model: str | None) -> list[RoutableReplica]:
        return [
            r for r in self._replicas.values()
            if r.healthy() and not (model is not None and r.breaker_open(model))
        ]

    def route(
        self, tenant_id: str | None = None, model: str | None = None
    ) -> RoutableReplica:
        """Pick the replica for this request.  Raises
        :class:`NoReplicaAvailable` when nothing is eligible."""
        eligible = self._eligible(model)
        if not eligible:
            raise NoReplicaAvailable(
                f"no healthy replica for model={model!r} "
                f"({len(self._replicas)} registered)"
            )
        if tenant_id is not None and self.policy == POLICY_CONSISTENT_HASH:
            key = str(tenant_id)
            gen = self.ring.generation
            cached = self._pref_cache.get(key)
            if cached is not None and cached[0] == gen:
                pref = cached[1]
            else:
                pref = self.ring.preference(key)
                if len(self._pref_cache) >= self._pref_cap:
                    self._pref_cache.clear()
                self._pref_cache[key] = (gen, pref)
            ok = {r.index for r in eligible}
            for rid in pref:
                if rid in ok:
                    return self._replicas[rid]
            # ring empty / all ring members ineligible — fall through
        return min(eligible, key=lambda r: (r.load_rows(), r.index))
