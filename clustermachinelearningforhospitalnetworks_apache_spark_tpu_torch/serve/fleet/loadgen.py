"""Replayable open-loop load generator: seeded Poisson + diurnal bursts.

Serving benchmarks lie in two standard ways; this module is built to
dodge both:

* **closed-loop coordination** — clients that wait for an answer before
  sending the next request slow down exactly when the server does,
  hiding saturation (coordinated omission).  This generator is OPEN
  LOOP: arrivals follow a pre-built schedule whatever the fleet does;
  an overloaded fleet faces the same offered load a healthy one does.
* **unrepeatable load** — a throughput number nobody can re-drive is
  evidence of nothing.  The schedule is a pure function of
  (:class:`LoadProfile`, duration): seeded thinning over the rate
  curve, fixed tenant mix — the same profile replays the identical
  arrival sequence on any host (pinned by test).

The rate curve is the paper's hospital shape: a diurnal sinusoid over a
base rate, plus an optional burst window (morning admissions rush) —
``rate(t) = base · (1 + amp·sin(2πt/period + phase)) · burst(t)``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from .admission import SLO_INTERACTIVE, SLO_SHED_ORDER


@dataclass(frozen=True)
class TenantMix:
    """One tenant's share of the offered load: relative ``weight``, its
    SLO class, and its request size in rows."""

    tenant_id: str
    weight: float
    slo: str = SLO_INTERACTIVE
    rows: int = 1


@dataclass(frozen=True)
class Arrival:
    """One scheduled request (offsets in seconds from replay start)."""

    t: float
    tenant_id: str
    slo: str
    rows: int


@dataclass(frozen=True)
class LoadProfile:
    """The replayable description of an offered load."""

    base_rate_rps: float                      # mean requests/s at baseline
    tenants: tuple[TenantMix, ...]
    seed: int = 0
    diurnal_amplitude: float = 0.0            # 0..<1 sinusoidal swing
    diurnal_period_s: float = 86_400.0
    diurnal_phase: float = 0.0
    burst_start_s: float | None = None        # burst window (None = no burst)
    burst_dur_s: float = 0.0
    burst_mult: float = 1.0

    def __post_init__(self):
        if self.base_rate_rps <= 0:
            raise ValueError("base_rate_rps must be positive")
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            raise ValueError("diurnal_amplitude must be in [0, 1)")
        if not self.tenants:
            raise ValueError("tenant mix must name at least one tenant")
        if self.burst_mult < 1.0:
            raise ValueError("burst_mult must be >= 1")

    def rate_at(self, t: float) -> float:
        """Instantaneous request rate (req/s) at offset ``t``."""
        r = self.base_rate_rps * (
            1.0 + self.diurnal_amplitude * math.sin(
                2.0 * math.pi * t / self.diurnal_period_s + self.diurnal_phase
            )
        )
        if (
            self.burst_start_s is not None
            and self.burst_start_s <= t < self.burst_start_s + self.burst_dur_s
        ):
            r *= self.burst_mult
        return r

    @property
    def peak_rate(self) -> float:
        return self.base_rate_rps * (1.0 + self.diurnal_amplitude) * max(
            self.burst_mult, 1.0
        )


def build_schedule(profile: LoadProfile, duration_s: float) -> list[Arrival]:
    """Deterministic open-loop schedule: thinning (Lewis & Shedler) of a
    homogeneous Poisson stream at the peak rate down to ``rate_at`` —
    exact for any bounded rate curve — then a weighted tenant draw per
    accepted arrival.  Same (profile, duration) → same schedule, bit for
    bit."""
    rng = np.random.default_rng(profile.seed)
    peak = profile.peak_rate
    weights = np.asarray([m.weight for m in profile.tenants], dtype=np.float64)
    if np.any(weights < 0) or weights.sum() <= 0:
        raise ValueError("tenant weights must be non-negative, sum > 0")
    cdf = np.cumsum(weights / weights.sum())
    out: list[Arrival] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / peak)
        if t >= duration_s:
            break
        if rng.random() * peak > profile.rate_at(t):
            continue  # thinned: the instantaneous rate is below peak
        mix = profile.tenants[int(np.searchsorted(cdf, rng.random()))]
        out.append(Arrival(t, mix.tenant_id, mix.slo, mix.rows))
    return out


@dataclass
class ClassReport:
    """Per-SLO-class tally of one replay."""

    offered_requests: int = 0
    offered_rows: int = 0
    ok_rows: int = 0
    shed_rows: int = 0          # admission/queue refusals (rejected/unavailable)
    deadline_rows: int = 0
    other_rows: int = 0         # shutdown etc.
    #: (latency_s, rows) per OK answer — in-SLO goodput needs both
    ok_samples: list = field(default_factory=list, repr=False)

    @property
    def latencies_s(self) -> list:
        return [lat for lat, _ in self.ok_samples]

    def percentile_ms(self, q: float) -> float | None:
        lats = self.latencies_s
        if not lats:
            return None
        return round(float(np.percentile(np.asarray(lats), q)) * 1e3, 3)

    def in_slo(self, deadline_s: float) -> dict:
        """OK answers that also met ``deadline_s`` end to end — the
        goodput a latency SLO actually credits (an answer delivered
        after its deadline is ok-but-useless).  p50/p99 over the
        credited answers, so the pin bounds them by construction."""
        hit = [(lat, rows) for lat, rows in self.ok_samples if lat <= deadline_s]
        lats = np.asarray([lat for lat, _ in hit]) if hit else None
        return {
            "rows": int(sum(rows for _, rows in hit)),
            "p50_ms": None if lats is None else round(float(np.percentile(lats, 50)) * 1e3, 3),
            "p99_ms": None if lats is None else round(float(np.percentile(lats, 99)) * 1e3, 3),
        }

    def summary(self) -> dict:
        offered = max(self.offered_rows, 1)
        return {
            "offered_requests": self.offered_requests,
            "offered_rows": self.offered_rows,
            "ok_rows": self.ok_rows,
            "shed_rows": self.shed_rows,
            "deadline_rows": self.deadline_rows,
            "other_rows": self.other_rows,
            "ok_fraction": round(self.ok_rows / offered, 4),
            "shed_fraction": round(self.shed_rows / offered, 4),
            "p50_ms": self.percentile_ms(50),
            "p99_ms": self.percentile_ms(99),
        }


def replay(
    submit: Callable[[Arrival], object],
    schedule: Sequence[Arrival],
    speed: float = 1.0,
    wait_timeout_s: float = 10.0,
    mid_hook: Callable[[], None] | None = None,
    events: Sequence[tuple[float, Callable[[], None]]] | None = None,
) -> dict:
    """Drive a schedule open-loop against ``submit`` and tally the
    answers.

    ``submit(arrival)`` must return a :class:`~..queue.Request`-shaped
    object (``.wait(timeout) -> ServeResult``) and NEVER block — the
    fleet's and server's ``submit`` both qualify.  ``speed`` compresses
    the schedule's time axis (10.0 = drive a 30 s profile in 3 s).
    ``mid_hook`` fires once just past the schedule midpoint — the chaos
    lever (kill a replica mid-load).  ``events`` generalizes it: a
    sequence of ``(t, fn)`` in *schedule* time (same axis as
    ``Arrival.t``), each fired exactly once when the replay clock
    reaches ``t`` — ordered interleaving with arrivals is deterministic
    for a fixed schedule, which is what makes a seeded chaos schedule
    replayable.  Events left after the last arrival fire before harvest.
    Pacing lag is measured and reported: if this host can't generate the
    offered rate, the report says so instead of silently measuring a
    slower load.
    """
    per_class: dict[str, ClassReport] = {}
    pending: list[tuple[Arrival, object]] = []
    n = len(schedule)
    mid_at = n // 2
    ev = sorted(events, key=lambda e: e[0]) if events else []
    ev_next = 0
    max_lag = 0.0
    t0 = time.perf_counter()
    for i, a in enumerate(schedule):
        if mid_hook is not None and i == mid_at:
            mid_hook()
        while ev_next < len(ev) and ev[ev_next][0] <= a.t:
            ev[ev_next][1]()
            ev_next += 1
        target = t0 + a.t / speed
        now = time.perf_counter()
        if target > now:
            time.sleep(target - now)
        else:
            max_lag = max(max_lag, now - target)
        pending.append((a, submit(a)))
    while ev_next < len(ev):
        ev[ev_next][1]()
        ev_next += 1
    gen_wall = time.perf_counter() - t0
    # harvest: open loop never waited mid-stream, so waits happen here;
    # answers arrive roughly FIFO, making sequential waits cheap
    unanswered = 0
    for a, req in pending:
        rep = per_class.setdefault(a.slo, ClassReport())
        rep.offered_requests += 1
        rep.offered_rows += a.rows
        res = req.wait(wait_timeout_s)
        if res.ok:
            rep.ok_rows += a.rows
            rep.ok_samples.append((res.latency_s, a.rows))
        elif res.status in ("rejected", "unavailable"):
            rep.shed_rows += a.rows
        elif res.status == "deadline_exceeded":
            rep.deadline_rows += a.rows
            if res.detail == "client wait timed out":
                unanswered += 1
        else:
            rep.other_rows += a.rows
    wall = time.perf_counter() - t0
    ok_rows = sum(r.ok_rows for r in per_class.values())
    return {
        "offered_requests": n,
        "offered_rows": sum(r.offered_rows for r in per_class.values()),
        "ok_rows": ok_rows,
        "gen_wall_s": round(gen_wall, 4),
        "wall_s": round(wall, 4),
        "ok_rows_per_s": round(ok_rows / gen_wall, 1) if gen_wall > 0 else 0.0,
        "max_pacing_lag_s": round(max_lag, 4),
        "unanswered": unanswered,
        "per_class": {
            slo: per_class[slo].summary()
            for slo in SLO_SHED_ORDER if slo in per_class
        },
        #: the live ClassReport objects (in-SLO accounting, raw samples);
        #: callers serializing the report should drop this key
        "reports": per_class,
    }
