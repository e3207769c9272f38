"""Per-tenant quotas and SLO classes: admission control for the fleet.

The single server already degrades gracefully (its ladder: shed at a
saturated queue, drop at deadline, fallback answers) — but those rungs
are BLIND to who is asking and how urgent the ask is.  Under overload,
FIFO arrival order decides who suffers, which has two production
failure modes this module exists to close:

* **the noisy hospital** — one tenant flooding requests fills every
  queue and starves the other 4,000 hospitals.  Fix: a token bucket per
  tenant (``rate`` rows/s sustained, ``burst`` rows of headroom);
  over-quota traffic is shed AT THE DOOR, attributed to the tenant,
  before it costs a queue slot.
* **deadline deathspiral** — past saturation, queue sojourn exceeds the
  request deadline and EVERY admitted request expires before service:
  the server stays 100% busy producing 0 useful answers (the bare
  server's collapse that ``chip_smoke.py``'s fleet phase measures).  Fix: SLO classes with ordered load thresholds — as fleet
  load rises, ``best_effort`` sheds first, then ``batch``, and
  ``interactive`` keeps its queue short enough to meet its deadline.
  Degradation past saturation is ordered by CLASS, not by arrival.

These rungs sit ABOVE the existing ladder: an admitted request can
still be shed by its replica's bounded queue or dropped at its
deadline — admission only decides what deserves to contend at all.

Pure host-side state; the clock is injectable (breaker discipline) so
tests need no sleeps.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Mapping

from ...tune import knob

#: SLO classes, in SHED order: under rising load, earlier classes are
#: refused admission first.  interactive = a clinician waiting on the
#: answer; batch = a scheduled job that can retry; best_effort =
#: speculative/backfill traffic that deserves only idle capacity.
SLO_BEST_EFFORT = "best_effort"
SLO_BATCH = "batch"
SLO_INTERACTIVE = "interactive"
SLO_SHED_ORDER = (SLO_BEST_EFFORT, SLO_BATCH, SLO_INTERACTIVE)


@dataclass(frozen=True)
class SLOClass:
    """One class's contract: the fleet load factor past which it sheds,
    and the deadline stamped on its requests when the caller gives none.
    ``shed_load`` is a fraction of total fleet queue capacity — the
    ordered ladder comes from interactive's threshold sitting above
    batch's sitting above best_effort's."""

    name: str
    shed_load: float
    default_deadline_s: float | None

    def __post_init__(self):
        if not 0.0 < self.shed_load <= 1.0:
            raise ValueError(
                f"{self.name}: shed_load must be in (0, 1], got {self.shed_load}"
            )


def default_slo_classes() -> dict[str, SLOClass]:
    """The shipped ladder.  best_effort contends only while the routed
    queue is under a quarter full, batch under ~half; interactive is
    refused only when the queue is HARD-full (shed_load 1.0 — there is
    no class above it to protect, so it keeps contending to the end).
    The thresholds are queue-sojourn budgets, not fairness knobs: a
    class's floor bounds how many lower-class rows an interactive
    request can queue behind, which is what keeps its deadline
    meetable while the fleet is saturated.

    The batch/best_effort thresholds are owned by the knob registry
    (``serve.slo.*.shed_load``) — the live retuner moves them by
    swapping a fresh frozen :class:`SLOClass` into
    ``AdmissionController.classes`` (an atomic dict-entry store), never
    by mutating one in place.  interactive's 1.0 is not a knob: it is
    the ladder's invariant (nothing sits above it to protect)."""
    return {
        SLO_INTERACTIVE: SLOClass(SLO_INTERACTIVE, 1.0, 0.030),
        SLO_BATCH: SLOClass(
            SLO_BATCH, float(knob("serve.slo.batch.shed_load")), 0.500
        ),
        SLO_BEST_EFFORT: SLOClass(
            SLO_BEST_EFFORT,
            float(knob("serve.slo.best_effort.shed_load")), 2.0,
        ),
    }


class TokenBucket:
    """Classic token bucket in ROWS (the queue's own unit): sustained
    ``rate`` rows/s with ``burst`` rows of headroom.  ``take`` never
    blocks — admission answers immediately, like ``RequestQueue.offer``."""

    def __init__(
        self,
        rate: float,
        burst: float,
        clock: Callable[[], float] = time.monotonic,
    ):
        if rate <= 0 or burst <= 0:
            raise ValueError("token bucket rate and burst must be positive")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._t = clock()
        self._lock = threading.Lock()

    def take(self, rows: int) -> bool:
        now = self._clock()
        with self._lock:
            self._tokens = min(
                self.burst, self._tokens + (now - self._t) * self.rate
            )
            self._t = now
            if self._tokens >= rows:
                self._tokens -= rows
                return True
            return False

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens


@dataclass
class AdmissionDecision:
    admitted: bool
    reason: str = ""          # "quota:<tenant>" | "slo_load:<class>"
    deadline_s: float | None = None  # class default when caller gave none


class AdmissionController:
    """The fleet's front-door policy: the class's load threshold first
    (a load-shed must not charge quota), then the tenant's token
    bucket.  Stateless about replicas — the caller passes the routed
    queue's load factor, so this stays unit-testable with plain
    numbers."""

    def __init__(
        self,
        classes: Mapping[str, SLOClass] | None = None,
        default_quota: tuple[float, float] | None = None,
        tenant_quotas: Mapping[str, tuple[float, float]] | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.classes = dict(classes) if classes is not None else default_slo_classes()
        #: (rate, burst) applied to any tenant without an explicit quota;
        #: None = unlimited for unlisted tenants
        self.default_quota = default_quota
        self._clock = clock
        self._buckets: dict[str, TokenBucket] = {}
        self._explicit = {
            str(t): (float(r), float(b))
            for t, (r, b) in (tenant_quotas or {}).items()
        }
        self._lock = threading.Lock()

    def set_shed_load(self, slo: str, shed_load: float) -> None:
        """Atomically replace one class's threshold — the live-retune
        apply path.  A fresh frozen :class:`SLOClass` lands in the dict
        in ONE store; in-flight ``admit`` calls see the old or the new
        contract, never a mix."""
        cls = self.classes.get(slo)
        if cls is None:
            raise ValueError(
                f"unknown SLO class {slo!r}; one of {sorted(self.classes)}"
            )
        self.classes[slo] = SLOClass(
            cls.name, float(shed_load), cls.default_deadline_s
        )

    def set_quota(self, tenant_id: str, rate: float, burst: float) -> None:
        with self._lock:
            self._explicit[str(tenant_id)] = (float(rate), float(burst))
            self._buckets.pop(str(tenant_id), None)  # rebuild on next use

    def _bucket(self, tenant_id: str) -> TokenBucket | None:
        key = str(tenant_id)
        with self._lock:
            b = self._buckets.get(key)
            if b is not None:
                return b
            spec = self._explicit.get(key, self.default_quota)
            if spec is None:
                return None
            b = TokenBucket(spec[0], spec[1], clock=self._clock)
            self._buckets[key] = b
            return b

    def admit(
        self,
        tenant_id: str | None,
        slo: str,
        rows: int,
        load: float,
    ) -> AdmissionDecision:
        """One decision, never blocks.  ``load`` is the routed queue's
        rows / capacity (0..1).

        The load check runs FIRST: a request the ladder refuses must not
        drain its tenant's token bucket — charging quota for work the
        fleet never accepted would starve the tenant again after the
        load clears (and misattribute the shed as ``quota:``)."""
        cls = self.classes.get(slo)
        if cls is None:
            raise ValueError(
                f"unknown SLO class {slo!r}; one of {sorted(self.classes)}"
            )
        if load >= cls.shed_load:
            return AdmissionDecision(
                False, f"slo_load:{slo}", cls.default_deadline_s
            )
        if tenant_id is not None:
            bucket = self._bucket(tenant_id)
            if bucket is not None and not bucket.take(rows):
                return AdmissionDecision(
                    False, f"quota:{tenant_id}", cls.default_deadline_s
                )
        return AdmissionDecision(True, "", cls.default_deadline_s)
