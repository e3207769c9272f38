"""Registry exporters: Prometheus exposition text + JSON snapshots.

Both read the SAME :meth:`~.registry.MetricsRegistry.collect` pull (own
counters/gauges/histograms plus every live collector fragment), so the
text a scraper sees and the JSONL a dashboard tails can never disagree.

Naming convention (pinned by ``tests/test_obs.py`` — downstream
scrapers rely on it):

* internal dotted names (``stream.batches``, ``serve.latency_seconds``)
  become ``cmlhn_``-prefixed snake names (``cmlhn_stream_batches``);
  counters additionally get the Prometheus ``_total`` suffix;
* per-entity breakdowns ride as labels, written into the internal name
  with Prometheus brace syntax (``serve.breaker_open{model="los"}``) —
  :func:`split_labels` parses them back out;
* histograms export cumulative ``_bucket{le=...}`` + ``_sum`` +
  ``_count`` (the under/overflow bins fold into the first bucket and
  ``+Inf`` respectively).

The JSON snapshot keeps the internal dotted names verbatim — it is the
programmatic surface (``InferenceServer.health``/``bench.py`` consume
it), while the text form is the scrape surface.
"""

from __future__ import annotations

import re
import time
from typing import Any

from .registry import (
    MetricsRegistry,
    global_registry,
    is_finite_number,
    split_labels,  # noqa: F401 — the label parser lives with the label
    # writers in registry.py (cohort_label / cap_label_cardinality need
    # it too); re-exported here because exporters are its public home.
    # Both exporters read collect(), which has already applied the
    # label-cardinality backstop — a runaway tenant-labeled family
    # reaches the scrape page cohort-bucketed, never 10k series wide.
)

PREFIX = "cmlhn"

_BAD = re.compile(r"[^a-zA-Z0-9_]")


def prom_name(name: str) -> str:
    """Internal dotted name → Prometheus metric name."""
    return f"{PREFIX}_{_BAD.sub('_', name.strip())}"


def label_str(labels: dict[str, str], extra: str = "") -> str:
    parts = [
        f'{_BAD.sub("_", k)}="{v}"' for k, v in sorted(labels.items())
    ]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def prometheus_text(registry: MetricsRegistry | None = None) -> str:
    """The ``/metrics`` page: one TYPE line per family, values grouped
    under it, keys emitted in sorted order so the output is diffable."""
    reg = registry if registry is not None else global_registry()
    snap = reg.collect()
    families: dict[str, tuple[str, list[str]]] = {}

    def add(kind: str, raw: str, value: float, suffix: str = "") -> None:
        base, labels = split_labels(raw)
        fam = prom_name(base) + suffix
        families.setdefault(fam, (kind, []))[1].append(
            f"{fam}{label_str(labels)} {value:g}"
        )

    for raw, v in sorted(snap["counters"].items()):
        if is_finite_number(v):
            add("counter", raw, float(v), "_total")
    for raw, v in sorted(snap["gauges"].items()):
        if is_finite_number(v):
            add("gauge", raw, float(v))
    for raw, h in sorted(snap["histograms"].items()):
        base, labels = split_labels(raw)
        fam = prom_name(base)
        lines = families.setdefault(fam, ("histogram", []))[1]
        cum = 0.0
        # counts[0] is the underflow bin: cumulative ≤ edges[0] includes it
        for edge, c in zip(h["edges"], h["counts"][:-1]):
            cum += c
            le = 'le="%g"' % edge
            lines.append(f"{fam}_bucket{label_str(labels, le)} {cum:g}")
        inf = 'le="+Inf"'
        lines.append(
            f"{fam}_bucket{label_str(labels, inf)} {cum + h['counts'][-1]:g}"
        )
        lines.append(f"{fam}_sum{label_str(labels)} {h['sum']:g}")
        lines.append(f"{fam}_count{label_str(labels)} {h['count']:g}")
    out = []
    for fam in sorted(families):
        typ, lines = families[fam]
        out.append(f"# TYPE {fam} {typ}")
        out.extend(lines)
    return "\n".join(out) + "\n"


def json_snapshot(registry: MetricsRegistry | None = None) -> dict[str, Any]:
    """Schema-stable JSON view of :meth:`collect` (internal names kept):
    ``{time, counters, gauges, histograms}`` — the programmatic twin of
    the Prometheus page."""
    reg = registry if registry is not None else global_registry()
    snap = reg.collect()
    return {
        "time": round(time.time(), 3),
        "counters": {
            k: v for k, v in sorted(snap["counters"].items())
            if is_finite_number(v)
        },
        "gauges": {
            k: v for k, v in sorted(snap["gauges"].items())
            if is_finite_number(v)
        },
        "histograms": snap["histograms"],
    }


def write_snapshot(path: str, registry: MetricsRegistry | None = None) -> dict:
    """Append one JSON snapshot line to ``path`` (WAL append/torn-tail
    discipline — a scrape log survives crashes the same way every other
    log here does) and return the snapshot."""
    snap = json_snapshot(registry)
    from ..streaming.wal import append_lines  # lazy: avoids import cycle

    append_lines(path, [snap], site=None)
    return snap


def read_snapshots(path: str) -> list[dict]:
    """All intact snapshot lines (the WAL reader skips torn lines)."""
    from ..streaming.wal import read_lines  # lazy: avoids import cycle

    return [
        o for o in read_lines(path) if isinstance(o, dict) and "counters" in o
    ]


def schema(registry: MetricsRegistry | None = None) -> list[tuple]:
    """The scrape contract as data: sorted ``(prom_name, type,
    label_keys)`` triples — what the pinned-schema test freezes."""
    reg = registry if registry is not None else global_registry()
    snap = reg.collect()
    rows: set[tuple] = set()
    for kind, key in (
        ("counter", "counters"), ("gauge", "gauges"),
        ("histogram", "histograms"),
    ):
        for raw in snap[key]:
            base, labels = split_labels(raw)
            name = prom_name(base) + ("_total" if kind == "counter" else "")
            rows.add((name, kind, tuple(sorted(labels))))
    return sorted(rows)
