"""Serving fleet: N replicas, a tenant-aware router, per-tenant SLOs
(the JAX package's ``serve/fleet/``).

The fabric over :mod:`..server`, the MLlib move of one uniform surface
over many executors, applied to serving:

* :mod:`placement` — replica→devices assignment as a first-class object
  (the RecML ``Partitioner`` shape)
* :mod:`router`    — least-loaded / consistent-hash-per-tenant routing,
  health-aware, minimal reshuffle on membership change
* :mod:`admission` — per-tenant token-bucket quotas + SLO classes with
  ORDERED shed thresholds (best_effort → batch → interactive)
* :mod:`replica_set` — the composed front door: atomic fleet-wide
  promotion, replica kill/drain/revive, pull-collector health
* :mod:`proc`      — the multi-process fleet: each replica a real OS
  process with its own CUDA context behind a length-prefixed frame RPC,
  same router/admission/swap semantics
* :mod:`loadgen`   — replayable open-loop Poisson load (diurnal bursts,
  fixed tenant mix)
* :mod:`watchdog`  — busy-but-no-progress stall detection; a wedge
  becomes a ``watchdog.stall`` flight dump + :class:`StallError`

Placement, routing, admission, the load generator, the watchdog and the
frame transport are host code and take no device; ``ReplicaSet`` and
``ProcReplicaSet`` serve on their devices, by default the card.
"""

from .admission import (
    AdmissionController,
    AdmissionDecision,
    SLO_BATCH,
    SLO_BEST_EFFORT,
    SLO_INTERACTIVE,
    SLO_SHED_ORDER,
    SLOClass,
    TokenBucket,
    default_slo_classes,
)
from .loadgen import Arrival, ClassReport, LoadProfile, TenantMix, build_schedule, replay
from .placement import EvenPlacement, PinnedPlacement, Placement, ReplicaSlice
from .proc import (
    FrameError,
    ProcReplica,
    ProcReplicaSet,
    ProcServerClient,
    RPCError,
)
from .replica_set import (
    DEFAULT_ADMISSION,
    REPLICA_DEAD,
    REPLICA_DRAINING,
    REPLICA_LIVE,
    Replica,
    ReplicaSet,
)
from .router import (
    ConsistentHashRing,
    NoReplicaAvailable,
    POLICY_CONSISTENT_HASH,
    POLICY_LEAST_LOADED,
    Router,
)
from .watchdog import StallError, StallWatchdog

__all__ = [
    "AdmissionController",
    "AdmissionDecision",
    "Arrival",
    "ClassReport",
    "ConsistentHashRing",
    "DEFAULT_ADMISSION",
    "EvenPlacement",
    "FrameError",
    "LoadProfile",
    "NoReplicaAvailable",
    "POLICY_CONSISTENT_HASH",
    "POLICY_LEAST_LOADED",
    "PinnedPlacement",
    "Placement",
    "ProcReplica",
    "ProcReplicaSet",
    "ProcServerClient",
    "REPLICA_DEAD",
    "REPLICA_DRAINING",
    "REPLICA_LIVE",
    "Replica",
    "ReplicaSet",
    "ReplicaSlice",
    "RPCError",
    "Router",
    "SLOClass",
    "SLO_BATCH",
    "SLO_BEST_EFFORT",
    "SLO_INTERACTIVE",
    "SLO_SHED_ORDER",
    "StallError",
    "StallWatchdog",
    "TenantMix",
    "TokenBucket",
    "build_schedule",
    "default_slo_classes",
    "replay",
]
