"""Compressed-production-day soak harness.

One seeded run drives every subsystem together — dirty multi-hospital
CSVs through the firewall into the unbounded table, incremental views
feeding per-tenant drift, a multi-tenant farm served by a replica fleet
under open-loop diurnal load, drifted-subset retrains hot-swapped
mid-traffic — while a seeded, replayable chaos schedule kills replicas
and fires ``InjectedCrash`` at named sites (including a double-kill: a
crash during crash recovery).  The run's verdict is a single
machine-checked SoakReport (CRC-wrapped JSON, same discipline as
flight-recorder dumps).

Entry points: :func:`~.driver.run_soak` (library; ``device=`` defaults to
the card) and ``python -m <this package>`` (CLI, :mod:`.__main__`).  The
schedule, the report and the resource probe are host code.
"""

from .schedule import (
    ChaosEvent,
    DiurnalPhase,
    KIND_CRASH,
    KIND_DOUBLE_KILL,
    KIND_KILL,
    KIND_REVIVE,
    SMOKE_CONFIG,
    SoakConfig,
    build_chaos_schedule,
)
from .report import check_report, read_report, write_report
from .resource_probe import ResourceProbe
from .driver import run_soak

__all__ = [
    "ChaosEvent", "DiurnalPhase", "KIND_CRASH", "KIND_DOUBLE_KILL", "KIND_KILL",
    "KIND_REVIVE", "SMOKE_CONFIG", "SoakConfig", "build_chaos_schedule",
    "check_report", "read_report", "write_report", "ResourceProbe", "run_soak",
]
