"""Process-global metrics registry: counters, gauges, histograms.

The one metrics surface.  Before this module the repo held
three overlapping metric holders — ``utils/metrics.py`` (training-side
counters/gauges/stage timings), ``serve/metrics.py::ServingMetrics``
(latency reservoir + its own registry), and the streaming driver's
ad-hoc ``stream.*`` counter dict — none of which could answer a fleet
question ("what is this process's p99, PSI, and breaker state *right
now*") from one snapshot.  This registry is that place:

* **counters** monotonically accumulate (``inc``), **gauges** hold the
  last value (``set``) — both plain dicts updated under the GIL, the
  same cost profile the old ``utils.metrics`` had;
* **histograms** are fixed-bucket and **mergeable** — the
  ``quality/sketches.py`` discipline (explicit under/overflow bins,
  counts addable across shards/processes) applied to latency and fill
  distributions, so p50/p99 come from bounded state instead of an
  unbounded (or sampled) reservoir;
* **collectors** are pull-sources registered by subsystems that hold
  their own state (breaker snapshots, drift monitors, the lifecycle
  phase, SQL dispatch routes): they contribute at *export* time only,
  so the hot path never pays for observability it isn't using — the
  ``utils/faults.py`` uninstalled-site discipline.  Collectors are held
  by weakref: a test's server dying unregisters it automatically.

``global_registry()`` is the process-wide instance every exporter
reads; subsystem-owned registries (a server's, a stream's) stay
isolated for tests and fold upward through collectors.
"""

from __future__ import annotations

import math
import os
import re
import threading
import time
import weakref
import zlib
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Sequence

import numpy as np

#: default latency histogram edges (seconds): log-spaced 100µs → 10s,
#: 4 buckets/decade — coarse enough to stay tiny, fine enough that p99
#: interpolation lands within ~30% of the true tail
LATENCY_EDGES_S = tuple(
    round(10.0 ** (e / 4.0), 6) for e in range(-16, 5)
)

#: default ratio histogram edges (batch fill, shares): uniform on [0, 1]
RATIO_EDGES = tuple(i / 16.0 for i in range(17))


class FixedHistogram:
    """Fixed-edge, mergeable histogram with explicit under/overflow bins.

    ``counts`` has ``len(edges) + 1`` entries — ``counts[0]`` is the
    underflow bin (< edges[0]), ``counts[-1]`` the overflow bin
    (≥ edges[-1]) — exactly the ``quality/sketches.py::FeatureSketch``
    layout, so two histograms over the same edges merge by addition.
    ``sum``/``count`` ride along so the exact mean survives bucketing
    (Prometheus ``_sum``/``_count`` semantics).
    """

    __slots__ = ("edges", "counts", "count", "sum", "_lock")

    def __init__(self, edges: Sequence[float]):
        self.edges = np.asarray(edges, dtype=np.float64)
        if self.edges.size < 2:
            raise ValueError("FixedHistogram needs at least 2 bin edges")
        if np.any(np.diff(self.edges) <= 0):
            raise ValueError("histogram edges must be strictly increasing")
        self.counts = np.zeros(self.edges.size + 1, dtype=np.float64)
        self.count = 0.0
        self.sum = 0.0
        self._lock = threading.Lock()

    def observe(self, values) -> None:
        v = np.atleast_1d(np.asarray(values, dtype=np.float64)).ravel()
        if v.size == 0:
            return
        idx = np.searchsorted(self.edges, v, side="right")
        # a value exactly on the top edge belongs to the last interior
        # bin, not overflow (sketches.py discipline; keeps Prometheus
        # le-buckets inclusive: fill ratio 1.0 lands in le="1")
        idx[v == self.edges[-1]] = self.edges.size - 1
        with self._lock:
            self.counts += np.bincount(
                idx, minlength=self.counts.size
            ).astype(np.float64)
            self.count += float(v.size)
            self.sum += float(v.sum())

    def merge(self, other: "FixedHistogram") -> "FixedHistogram":
        if self.edges.size != other.edges.size or not np.allclose(
            self.edges, other.edges
        ):
            raise ValueError("cannot merge histograms with different edges")
        with self._lock:
            self.counts = self.counts + other.counts
            self.count += other.count
            self.sum += other.sum
        return self

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count > 0 else float("nan")

    def quantile(self, q: float) -> float:
        """Interpolated quantile over ALL mass.  The open-ended bins get
        synthetic extents (underflow: down to 0 or a mirrored width;
        overflow: one bin width past the top) so a distribution that
        lands mostly below/above the edges still yields a finite,
        monotone estimate instead of NaN."""
        with self._lock:
            counts = self.counts.copy()
        total = counts.sum()
        if total <= 0:
            return float("nan")
        e = self.edges
        lo0 = min(0.0, float(e[0]) - float(e[1] - e[0]))
        hi_end = float(e[-1]) + float(e[-1] - e[-2])
        lows = np.concatenate([[lo0], e])
        highs = np.concatenate([e, [hi_end]])
        cum = np.cumsum(counts)
        target = min(max(q, 0.0), 1.0) * total
        i = int(np.searchsorted(cum, target))
        i = min(i, counts.size - 1)
        prev = cum[i - 1] if i > 0 else 0.0
        frac = 0.0 if counts[i] == 0 else (target - prev) / counts[i]
        return float(lows[i] + frac * (highs[i] - lows[i]))

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "edges": [float(x) for x in self.edges],
                "counts": [float(c) for c in self.counts],
                "count": float(self.count),
                "sum": float(self.sum),
            }


@dataclass
class StageTiming:
    """One timed pipeline stage (the earlier ``utils.metrics``
    surface, kept verbatim — bench and examples consume it)."""

    name: str
    seconds: float
    rows: int | None = None

    @property
    def rows_per_sec(self) -> float | None:
        if self.rows is None or self.seconds <= 0:
            return None
        return self.rows / self.seconds


class MetricsRegistry:
    """Counters + gauges + histograms + stage timings, one object.

    Drop-in superset of the old ``utils.metrics.MetricsRegistry``: the
    ``counters``/``gauges`` dict attributes, ``inc``/``set``/``stage``/
    ``time_stage``/``snapshot`` all behave identically, so every
    existing call site (streaming drivers, serve metrics, health
    endpoints, tests) keeps working unchanged.
    """

    def __init__(self) -> None:
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, FixedHistogram] = {}
        self.timings: list[StageTiming] = []
        self._hist_lock = threading.Lock()
        #: key -> weakref-wrapped zero-arg callable returning a metrics
        #: fragment ``{"counters": {...}, "gauges": {...}}``
        self._collectors: dict[str, Callable[[], dict | None]] = {}
        self._collector_lock = threading.Lock()

    # ------------------------------------------------------------ write
    def inc(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def set(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def hist(
        self, name: str, edges: Sequence[float] = LATENCY_EDGES_S
    ) -> FixedHistogram:
        """Get-or-create the named histogram (edges bind on first use)."""
        h = self.histograms.get(name)
        if h is None:
            with self._hist_lock:
                h = self.histograms.get(name)
                if h is None:
                    h = FixedHistogram(edges)
                    self.histograms[name] = h
        return h

    def observe(
        self, name: str, value, edges: Sequence[float] = LATENCY_EDGES_S
    ) -> None:
        self.hist(name, edges).observe(value)

    @contextmanager
    def stage(self, name: str, rows: int | None = None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings.append(
                StageTiming(name=name, seconds=time.perf_counter() - t0, rows=rows)
            )

    def time_stage(self, name: str, fn, *args, rows: int | None = None, **kw):
        with self.stage(name, rows=rows):
            return fn(*args, **kw)

    # ------------------------------------------------------- collectors
    def register_collector(self, key: str, owner: Any, fn: Callable[[Any], dict]) -> None:
        """Register a pull-source: at export time ``fn(owner)`` runs and
        its ``{"counters": ..., "gauges": ...}`` fragment merges into the
        collected snapshot.  ``owner`` is held by WEAKREF — when it dies
        the collector silently unregisters, so a long-lived global
        registry never pins a test's server alive or reports its ghost.
        """
        ref = weakref.ref(owner)

        def pull() -> dict | None:
            o = ref()
            return None if o is None else fn(o)

        with self._collector_lock:
            self._collectors[key] = pull

    def unregister_collector(self, key: str) -> None:
        with self._collector_lock:
            self._collectors.pop(key, None)

    def collector_keys(self) -> list[str]:
        with self._collector_lock:
            return sorted(self._collectors)

    # ------------------------------------------------------------- read
    def snapshot(self) -> dict[str, Any]:
        """The earlier shape plus ``histograms`` — own state only
        (no collectors); :meth:`collect` is the full pull."""
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {
                k: h.to_dict() for k, h in sorted(self.histograms.items())
            },
            "stages": [
                {
                    "name": t.name,
                    "seconds": round(t.seconds, 6),
                    "rows": t.rows,
                    "rows_per_sec": None
                    if t.rows_per_sec is None
                    else round(t.rows_per_sec, 1),
                }
                for t in self.timings
            ],
        }

    def collect(self) -> dict[str, Any]:
        """Own state + every live collector's fragment — what the
        exporters serialize.  A collector that raises contributes an
        ``error`` note instead of taking the export down; dead weakrefs
        are pruned as a side effect."""
        out = self.snapshot()
        dead: list[str] = []
        with self._collector_lock:
            items = list(self._collectors.items())
        for key, pull in items:
            try:
                frag = pull()
            except Exception as e:  # noqa: BLE001 — observability must
                # never be the thing that breaks
                out["counters"][f"obs.collector_errors.{key}"] = (
                    out["counters"].get(f"obs.collector_errors.{key}", 0.0) + 1
                )
                out["gauges"][f"obs.collector_broken.{key}"] = 1.0
                continue
            if frag is None:
                dead.append(key)
                continue
            # counters SUM across sources (two servers' request counts
            # are one process total); gauges are point-in-time — last
            # writer wins, per-entity gauges disambiguate via labels
            for name, value in (frag.get("counters") or {}).items():
                out["counters"][name] = out["counters"].get(name, 0.0) + value
            for name, value in (frag.get("gauges") or {}).items():
                out["gauges"][name] = value
            # histogram fragments arrive pre-serialized (to_dict shape);
            # same-name fragments overwrite — per-source names/labels
            # disambiguate where that matters
            for name, value in (frag.get("histograms") or {}).items():
                out["histograms"][name] = value
        if dead:
            with self._collector_lock:
                for key in dead:
                    self._collectors.pop(key, None)
        # export-side cardinality backstop: a family that grew past the
        # series budget (per-tenant labels that skipped cohort_label)
        # leaves collect() cohort-bucketed, never 10k series wide
        return cap_label_cardinality(out)

    def merge_registry(self, other: "MetricsRegistry") -> None:
        """Fold another registry's state in (counters add, gauges take
        the other's value, histograms merge) — the cross-shard reduce."""
        for k, v in other.counters.items():
            self.inc(k, v)
        for k, v in other.gauges.items():
            self.set(k, v)
        for k, h in other.histograms.items():
            self.hist(k, h.edges).merge(h)


_GLOBAL = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    """The process-wide registry every exporter reads."""
    return _GLOBAL


# --------------------------------------------------------------------------
# Label-cardinality guard.
#
# A per-TENANT label on a farm metric is a 10,000-series Prometheus export
# waiting to happen (every scrape carries every series ever written).  Two
# defenses, both here so every writer and every exporter share them:
#
# * :func:`cohort_label` is the WRITE-side discipline — the farm labels
#   its metrics by a bounded tenant *cohort* (stable hash of the tenant id
#   into :data:`N_COHORTS` buckets), never by raw tenant id;
# * :func:`cap_label_cardinality` is the EXPORT-side backstop applied by
#   :meth:`MetricsRegistry.collect` — any labeled family that still grows
#   past :data:`MAX_SERIES_PER_FAMILY` distinct label combinations gets
#   its label VALUES cohort-bucketed at collect time (counters sum into
#   the bucket, gauges keep the max — the conservative alarm view — and
#   same-edge histograms merge), with an ``obs.cardinality_capped{metric=}``
#   counter recording that the cap fired.
# --------------------------------------------------------------------------

#: distinct label-combination budget per metric family at export; override
#: with the CMLHN_OBS_MAX_SERIES env var
MAX_SERIES_PER_FAMILY = int(os.environ.get("CMLHN_OBS_MAX_SERIES", "256"))

#: cohort bucket count for high-cardinality label values (tenant ids)
N_COHORTS = 32

_LABELED_RE = re.compile(r"^(?P<name>[^{]+)\{(?P<labels>.*)\}$")
_LABEL_RE = re.compile(r'(?P<k>[a-zA-Z0-9_.]+)="(?P<v>[^"]*)"')


def split_labels(name: str) -> tuple[str, dict[str, str]]:
    """``'x.y{model="los",state="open"}'`` → ``("x.y", {...})`` — the one
    parser for the brace-label convention (exporters re-use it)."""
    m = _LABELED_RE.match(name)
    if m is None:
        return name, {}
    labels = {
        lm.group("k"): lm.group("v")
        for lm in _LABEL_RE.finditer(m.group("labels"))
    }
    return m.group("name"), labels


def join_labels(base: str, labels: dict[str, str]) -> str:
    if not labels:
        return base
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{base}{{{inner}}}"


def cohort_label(value: str, n_cohorts: int = N_COHORTS) -> str:
    """Stable bounded bucket for a high-cardinality label value: the
    tenant-cohort name the farm labels its metrics with (``"c07"``)."""
    return f"c{zlib.crc32(str(value).encode()) % n_cohorts:02d}"


#: replica-count ceiling for per-replica metric labels — a fleet is a
#: few to a few dozen replicas, never tenant-shaped cardinality
MAX_REPLICAS_LABELED = 256


def replica_label(index: int) -> str:
    """Bounded, format-pinned label value for a serving-fleet replica
    (``"r03"``).  The ONLY sanctioned way to put a replica label on a
    metric — ``tools/check_obs.py`` fails the build on a brace-label
    built any other way, the same discipline that keeps tenant labels
    behind :func:`cohort_label`."""
    i = int(index)
    if not 0 <= i < MAX_REPLICAS_LABELED:
        raise ValueError(
            f"replica index {index} outside the labeled range "
            f"[0, {MAX_REPLICAS_LABELED})"
        )
    return f"r{i:02d}"


def _merge_hist_dicts(a: dict, b: dict) -> dict:
    """Bin-addition merge of two ``FixedHistogram.to_dict`` fragments when
    the edges agree; otherwise keep ``b`` (last wins, as collect does for
    same-name fragments)."""
    if a.get("edges") == b.get("edges"):
        return {
            "edges": a["edges"],
            "counts": [x + y for x, y in zip(a["counts"], b["counts"])],
            "count": a.get("count", 0.0) + b.get("count", 0.0),
            "sum": a.get("sum", 0.0) + b.get("sum", 0.0),
        }
    return b


def cap_label_cardinality(
    snap: dict[str, Any], max_series: int | None = None
) -> dict[str, Any]:
    """Enforce the per-family series budget on a collected snapshot
    (in place; returns it).  Families within budget pass through
    untouched — per-model breaker gauges etc. keep their exact labels."""
    budget = MAX_SERIES_PER_FAMILY if max_series is None else max_series
    if budget <= 0:
        return snap
    for kind in ("counters", "gauges", "histograms"):
        table = snap.get(kind)
        if not table:
            continue
        fams: dict[str, list[str]] = {}
        for raw in table:
            base, labels = split_labels(raw)
            if labels:
                fams.setdefault(base, []).append(raw)
        for base, raws in fams.items():
            if len(raws) <= budget:
                continue
            # bucket ONLY the label keys whose distinct-value count blew
            # the budget — a low-cardinality companion label (model=,
            # state=) keeps attributing series exactly
            values_by_key: dict[str, set] = {}
            for raw in raws:
                for k, v in split_labels(raw)[1].items():
                    values_by_key.setdefault(k, set()).add(v)
            hot_keys = {
                k for k, vals in values_by_key.items() if len(vals) > budget
            } or set(values_by_key)  # combinatorial blowup with no single
            # hot key: bucket everything rather than export 10k series
            capped: dict[str, Any] = {}
            for raw in raws:
                _, labels = split_labels(raw)
                new_raw = join_labels(
                    base,
                    {
                        k: cohort_label(v) if k in hot_keys else v
                        for k, v in labels.items()
                    },
                )
                old = capped.get(new_raw)
                v = table.pop(raw)
                if old is None:
                    capped[new_raw] = v
                elif kind == "counters":
                    capped[new_raw] = old + v
                elif kind == "gauges":
                    capped[new_raw] = max(old, v)
                else:
                    capped[new_raw] = _merge_hist_dicts(old, v)
            table.update(capped)
            c = snap.setdefault("counters", {})
            key = f'obs.cardinality_capped{{metric="{base}"}}'
            c[key] = c.get(key, 0.0) + float(len(raws))
    return snap


def is_finite_number(v: Any) -> bool:
    """Shared exporter guard: JSON/Prometheus emit numbers only."""
    return isinstance(v, (int, float)) and math.isfinite(v)
