"""Soak schedules: the compressed diurnal day and the seeded chaos plan.

Two schedules, both pure functions of a :class:`SoakConfig` and host
code (no device):

* the **load schedule** — per diurnal phase, a rate multiplier over the
  base rate fed to the fleet's open-loop generator
  (``serve/fleet/loadgen.py``; same thinning, same seed → bit-identical
  arrivals);
* the **chaos schedule** — :func:`build_chaos_schedule`, a sorted list
  of :class:`ChaosEvent` (replica kills + revivals, armed
  ``InjectedCrash`` sites, one double-kill) placed by a
  ``np.random.default_rng(seed)`` draw.  Same config → same events at
  the same offsets, which is what makes a soak failure *replayable*:
  re-run with the seed from the report and the same kills land in the
  same order.  ``check_report`` re-derives the schedule from the
  report's embedded config and fails the report if they diverge.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, replace

import numpy as np

#: chaos event kinds
KIND_KILL = "kill_replica"        # target: replica index (as str)
KIND_REVIVE = "revive_replica"    # target: replica index (as str)
KIND_CRASH = "crash"              # target: fault site to arm + exercise
KIND_DOUBLE_KILL = "double_kill"  # target: the fit-checkpoint ladder

#: sites a KIND_CRASH event may arm.  Every entry has a covering
#: operation and a recovery path (``_SoakRun._exec_crash``);
#: keep the two in sync.
CRASH_SITES = (
    "stream.after_commit",   # kill the ingest stream right after commit
    "sql.view.maintain",     # kill view maintenance mid-fold
    "fleet.swap.prepare",    # kill a hot swap in its prepare phase
    "soak.schedule.tick",    # kill the chaos dispatcher itself
)


@dataclass(frozen=True)
class DiurnalPhase:
    """One segment of the compressed day."""

    name: str
    duration_s: float            # schedule-time length (pre-speedup)
    rate_mult: float             # multiplier over SoakConfig.base_rate_rps
    slo_deadline_s: float = 0.5  # interactive deadline credited as goodput
    min_goodput_frac: float = 0.5  # in-SLO rows / offered rows floor
    burst: bool = False          # morning-rush burst inside this phase


@dataclass(frozen=True)
class ChaosEvent:
    """One scheduled chaos action, in schedule time from soak start."""

    t: float
    kind: str
    target: str
    label: str

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass(frozen=True)
class SoakConfig:
    """Everything a soak run needs — JSON-able both ways, so the report
    can embed it and a re-run can be reconstructed from a report."""

    seed: int = 0
    phases: tuple[DiurnalPhase, ...] = ()
    base_rate_rps: float = 12.0
    speed: float = 2.0                 # schedule-time compression factor
    n_tenants: int = 6
    n_features: int = 4
    n_replicas: int = 3
    rows_per_tenant: int = 48          # training pool per hospital
    ingest_rows_per_phase: int = 60    # CSV rows streamed in per phase
    dirty_field_rate: float = 0.08     # mangled-field rate on dirty reads
    dirty_reads: int = 2               # how many CSV reads get dirtied
    replica_kills: int = 1
    crashes: int = 2
    double_kills: int = 1
    drift_tenants: int = 2             # tenants whose later phases shift
    drift_scale: float = 4.0           # feature shift driving PSI drift
    kmeans_k: int = 2
    kmeans_iters: int = 8
    checkpoint_every: int = 2
    stall_window_s: float = 60.0
    wait_timeout_s: float = 15.0
    max_disk_mb: float = 256.0         # resource-probe disk ceiling
    table_budget_mb: float = 32.0      # unbounded-table disk budget: the
    #                                    history lifecycle (seal/retire)
    #                                    must hold the table dir under
    #                                    this at EVERY probe sample
    max_metric_series: int = 4096      # resource-probe series ceiling
    rss_growth_ratio: float = 2.5      # last/first RSS ceiling

    @property
    def total_s(self) -> float:
        return float(sum(p.duration_s for p in self.phases))

    def to_dict(self) -> dict:
        d = asdict(self)
        d["phases"] = [asdict(p) for p in self.phases]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SoakConfig":
        d = dict(d)
        d["phases"] = tuple(DiurnalPhase(**p) for p in d.get("phases", ()))
        return cls(**d)


def _default_phases() -> tuple[DiurnalPhase, ...]:
    return (
        DiurnalPhase("night", 3.0, 0.5, slo_deadline_s=0.75,
                     min_goodput_frac=0.5),
        DiurnalPhase("morning_rush", 4.0, 1.5, slo_deadline_s=0.75,
                     min_goodput_frac=0.4, burst=True),
        DiurnalPhase("evening", 3.0, 1.0, slo_deadline_s=0.75,
                     min_goodput_frac=0.5),
    )


#: the smoke shape: a whole day in ~10 schedule-seconds, driven at 2x —
#: small enough for a test suite's budget, every chaos kind still
#: present (kill + revive, 2 crashes, 1 double-kill)
SMOKE_CONFIG = SoakConfig(seed=1107, phases=_default_phases())


def full_config(seed: int = 1107) -> SoakConfig:
    """The slow-marked full run: longer phases, more of everything."""
    return replace(
        SMOKE_CONFIG,
        seed=seed,
        phases=(
            DiurnalPhase("night", 8.0, 0.5, min_goodput_frac=0.5),
            DiurnalPhase("morning_rush", 10.0, 1.8, min_goodput_frac=0.4,
                         burst=True),
            DiurnalPhase("midday", 8.0, 1.2, min_goodput_frac=0.5),
            DiurnalPhase("evening", 8.0, 0.8, min_goodput_frac=0.5),
        ),
        n_tenants=10,
        rows_per_tenant=96,
        ingest_rows_per_phase=120,
        replica_kills=2,
        crashes=4,
        dirty_reads=4,
    )


def build_chaos_schedule(cfg: SoakConfig) -> list[ChaosEvent]:
    """The seeded chaos plan — pure function of ``cfg``.

    Kills and crashes land in the middle 10–85% of the day (chaos during
    the ramp-down tail would outlive the load that observes it); every
    replica kill is paired with a revival ~20% of the day later, so the
    run also exercises the tenants-come-home path.  Replica 0 is never
    killed: the run must always keep one live replica, or ``unanswered=0``
    would be vacuously unreachable.  The double-kill is pinned to the
    retrain window (after the burst phase starts) — it targets the
    fit-checkpoint ladder, not a wall-clock op, so its ``t`` orders it
    among the other events but the run executes it at the staged
    retrain."""
    rng = np.random.default_rng(cfg.seed)
    total = cfg.total_s
    events: list[ChaosEvent] = []
    for i in range(cfg.replica_kills):
        t = float(rng.uniform(0.10, 0.65)) * total
        replica = int(rng.integers(1, max(cfg.n_replicas, 2)))
        events.append(ChaosEvent(
            round(t, 3), KIND_KILL, str(replica), f"kill:r{replica}"
        ))
        t_back = min(t + 0.2 * total, 0.95 * total)
        events.append(ChaosEvent(
            round(float(t_back), 3), KIND_REVIVE, str(replica),
            f"revive:r{replica}",
        ))
    # crashes walk a seeded permutation of the sites, so n crashes cover
    # n distinct sites (mod the site count) instead of lottery repeats
    site_order = rng.permutation(len(CRASH_SITES))
    for i in range(cfg.crashes):
        t = float(rng.uniform(0.10, 0.85)) * total
        site = CRASH_SITES[int(site_order[i % len(CRASH_SITES)])]
        events.append(ChaosEvent(
            round(t, 3), KIND_CRASH, site, f"crash:{site}"
        ))
    for i in range(cfg.double_kills):
        t = float(rng.uniform(0.40, 0.80)) * total
        events.append(ChaosEvent(
            round(t, 3), KIND_DOUBLE_KILL, "fit_ckpt",
            "double_kill:fit_ckpt",
        ))
    events.sort(key=lambda e: (e.t, e.kind, e.target))
    return events
