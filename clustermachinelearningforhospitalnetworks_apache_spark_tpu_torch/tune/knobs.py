"""The knob registry: every hand-set performance constant, declared
(the JAX package's ``tune/knobs.py``, the same twelve knobs).

A **knob** is one tunable performance constant — a micro-batch deadline,
a queue bound, a pipeline depth, a seal chunk size — declared once with
its name, its candidate **domain**, its hand-set **default**, and the obs
span or benchmark rate that scores it.  Call sites ask :func:`knob`
instead of carrying a literal:

    self.max_wait_s = knob("serve.microbatch.max_wait_ms") / 1e3

With nothing installed, :func:`knob` returns the declared default —
bit-identical to the literal it replaced, so migrating a call site
changes nothing until a selector is installed.  With a
:class:`~.select.Selector` installed (``tune.install`` /
``tune.active``), the lookup goes through the measured-cost model in
``tune/select.py``, which falls back to the same default when trial
coverage is thin and freezes during fenced A/Bs.

``py_names`` names the call-site identifiers each knob owns (assignment
targets and parameter names that no longer carry a raw literal).  The
declarations below are the JAX package's (names, defaults, domains,
metrics, modes, ``py_names``), so a trial store written by either
package scores the same knobs.

Units: knobs named ``*_ms`` are milliseconds; call sites divide by
``1e3``.  Every registered default converts bit-exactly (2.0/1e3 ==
0.002 etc.).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class Knob:
    """One tunable: identity, search space, default, and how to score it.

    ``metric`` names the signal that ranks candidate values — either a
    registered obs span (``span:serve.request``) or a benchmark rate
    (``bench:autotune.seal_scan``).  ``mode`` says which direction wins:
    ``"max"`` for throughput-like metrics, ``"min"`` for latencies.
    ``py_names`` are the call-site identifiers the knob owns.
    """

    name: str
    default: float | int
    domain: tuple = ()
    metric: str = ""
    mode: str = "max"
    py_names: tuple = ()
    description: str = ""

    def __post_init__(self) -> None:
        if self.mode not in ("max", "min"):
            raise ValueError(f"knob {self.name}: mode must be max|min")
        if self.domain and self.default not in self.domain:
            raise ValueError(
                f"knob {self.name}: default {self.default!r} not in domain"
            )


class KnobRegistry:
    """Name → :class:`Knob`.  Registration is declare-once: a second
    ``add`` under the same name must carry an identical declaration
    (idempotent re-import), anything else is a programming error."""

    def __init__(self) -> None:
        self._knobs: dict[str, Knob] = {}
        self._lock = threading.Lock()

    def add(self, knob: Knob) -> Knob:
        with self._lock:
            prev = self._knobs.get(knob.name)
            if prev is not None and prev != knob:
                raise ValueError(
                    f"knob {knob.name!r} re-registered with a different "
                    f"declaration"
                )
            self._knobs[knob.name] = knob
        return knob

    def get(self, name: str) -> Knob:
        try:
            return self._knobs[name]
        except KeyError:
            raise KeyError(f"unregistered knob {name!r}") from None

    def names(self) -> list[str]:
        return sorted(self._knobs)

    def __contains__(self, name: str) -> bool:
        return name in self._knobs

    def py_name_map(self) -> dict[str, str]:
        """identifier → knob name."""
        out: dict[str, str] = {}
        with self._lock:
            knobs = list(self._knobs.values())
        for k in knobs:
            for pn in k.py_names:
                out[pn] = k.name
        return out


#: the process-wide registry every call site resolves through
REGISTRY = KnobRegistry()

#: installed by tune/select.py — ``None`` means "declared defaults"
_RESOLVER: Callable | None = None


def set_resolver(fn: Callable | None) -> None:
    global _RESOLVER
    _RESOLVER = fn


def knob(name: str, shape: int | None = None):
    """Resolve one knob value.

    The no-selector path is two dict lookups and an ``is None`` test —
    cheap enough for ``__init__``-time call sites (hot inner loops
    should resolve once at construction, which is what every migrated
    call site does).  ``shape`` is the workload size hint (rows) the
    selector buckets trials by; without a selector it is ignored.
    """
    k = REGISTRY.get(name)
    r = _RESOLVER
    if r is None:
        return k.default
    return r(k, shape)


def default(name: str):
    """The declared default, bypassing any installed selector — for
    call sites that must never float (compat constants, parity tests)."""
    return REGISTRY.get(name).default


# ---------------------------------------------------------------------------
# The registered knob surface: each name, default, domain, metric, mode and
# py_names equal to the JAX package's.
# Each entry replaced a hand-set literal in serve/, streaming/, farm/ or
# core/, and each has its call site in the port but sql.rowbucket.min, by
# decision: eager torch keeps no compiled executables, so the
# compiled SQL executor keeps columns at their true length and pads to no
# row bucket.  It stays declared so the two packages' registries and
# trial stores agree.
# ---------------------------------------------------------------------------

REGISTRY.add(Knob(
    name="serve.microbatch.max_wait_ms",
    default=2.0,
    domain=(0.0, 0.5, 1.0, 2.0, 4.0, 8.0),
    metric="span:serve.request",
    mode="max",
    py_names=("max_wait_s", "DEFAULT_MAX_WAIT_S"),
    description="micro-batch linger deadline before a partial batch "
                "dispatches (serve/batcher.py)",
))

REGISTRY.add(Knob(
    name="serve.queue.max_rows",
    default=4096,
    domain=(1024, 2048, 4096, 8192, 16384),
    metric="span:fleet.request",
    mode="max",
    py_names=("max_queue_rows", "max_rows"),
    description="bound on queued rows per server/batcher before "
                "admission sheds (one knob; five diverged copies before)",
))

REGISTRY.add(Knob(
    name="serve.slo.batch.shed_load",
    default=0.45,
    domain=(0.25, 0.35, 0.45, 0.6, 0.8),
    metric="span:fleet.request",
    mode="max",
    py_names=("batch_shed_load",),
    description="queue-load fraction above which the batch SLO class "
                "sheds (serve/fleet/admission.py)",
))

REGISTRY.add(Knob(
    name="serve.slo.best_effort.shed_load",
    default=0.25,
    domain=(0.1, 0.15, 0.25, 0.4, 0.6),
    metric="span:fleet.request",
    mode="max",
    py_names=("best_effort_shed_load",),
    description="queue-load fraction above which best-effort sheds "
                "(serve/fleet/admission.py)",
))

REGISTRY.add(Knob(
    name="stream.pipeline.depth",
    default=2,
    domain=(1, 2, 3, 4, 8),
    metric="span:stream.batch",
    mode="max",
    py_names=("pipeline_depth",),
    description="prefetch pipeline depth: batches in flight ahead of "
                "the stream's commit loop (streaming/pipeline.py)",
))

REGISTRY.add(Knob(
    name="stream.worker.poll_interval_ms",
    default=50.0,
    domain=(5.0, 10.0, 25.0, 50.0, 100.0),
    metric="span:stream.batch",
    mode="max",
    py_names=("worker_poll_interval_s",),
    description="idle re-list cadence of the prefetch worker "
                "(streaming/pipeline.py)",
))

REGISTRY.add(Knob(
    name="stream.source.max_files_per_batch",
    default=0,
    domain=(0, 2, 4, 8, 16),
    metric="span:stream.batch",
    mode="max",
    py_names=("max_files_per_batch",),
    description="files folded into one micro-batch; 0 = unbounded "
                "(streaming/source.py)",
))

REGISTRY.add(Knob(
    name="sql.stage.min_compiled_rows",
    default=4096,
    domain=(512, 1024, 2048, 4096, 8192, 16384),
    metric="span:sql.query",
    mode="max",
    py_names=("min_compiled_rows",),
    description="batch size below which the SQL feature stage forces "
                "the interpreter (streaming/pipeline.py)",
))

REGISTRY.add(Knob(
    name="sql.rowbucket.min",
    default=256,
    domain=(32, 64, 128, 256, 512, 1024),
    metric="span:sql.query",
    mode="min",
    py_names=("_MIN_BUCKET", "min_bucket"),
    description="floor of the power-of-two row-bucket ladder the "
                "compiled SQL executor pads to (core/sql_compile.py)",
))

REGISTRY.add(Knob(
    name="table.seal.min_batches",
    default=4,
    domain=(2, 4, 8, 16),
    metric="span:table.seal",
    mode="min",
    py_names=("min_seal_batches",),
    description="cold batches worth a segment: fewer seals, larger "
                "segments (core/table_lifecycle.py)",
))

REGISTRY.add(Knob(
    name="table.seal.max_segment_batches",
    default=64,
    domain=(4, 8, 16, 32, 64, 128),
    metric="bench:autotune.seal_scan",
    mode="max",
    py_names=("max_segment_batches",),
    description="batches per sealed segment: smaller segments prune "
                "better on selective scans, larger amortize manifests "
                "(core/table_lifecycle.py)",
))

REGISTRY.add(Knob(
    name="farm.pack.r_floor",
    default=8,
    domain=(2, 4, 8, 16, 32),
    metric="span:farm.fit",
    mode="max",
    py_names=("r_floor",),
    description="floor of the power-of-two tenant-bucket R the farm "
                "pads fleets to (farm/farm.py)",
))
