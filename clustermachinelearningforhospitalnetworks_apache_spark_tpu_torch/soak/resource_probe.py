"""Resource probe: is the soak run's footprint bounded?

The Spark perf study's core finding (arxiv 1612.01437) is that
sustained distributed-ML behavior diverges from microbenchmarks chiefly
through *growth* — memory creep, disk never reclaimed, metric
cardinality compounding per tenant/replica/retry label.  The probe
samples four footprints at every diurnal phase boundary:

* **RSS** — ``/proc/self/statm`` (current resident set; falls back to
  ``resource.getrusage`` peak RSS, which can only ratchet and is
  flagged as such so the growth check doesn't false-positive on it).
  On the card the RSS holds the CUDA context and its libraries, which
  the soak run loads before the first sample, so the ratio measures the
  day's growth and not the context's arrival;
* **disk** — recursive byte count of the soak workdir (the unbounded
  table, checkpoints, quarantine, artifacts, flight dumps);
* **metric cardinality** — distinct series across the sampled
  registries' ``collect()`` (counters + gauges + histogram families);
* **flight ring** — the recorder's event-ring length and dump-file
  count (both bounded by construction; the probe proves it held).

``report()`` turns the sample trail into the bounded-growth verdict the
``SoakReport`` embeds: last-vs-first RSS ratio under a ceiling, disk
under an absolute cap, series count under the cap and flat between the
mid and final samples, ring within capacity.
"""

from __future__ import annotations

import os
import time

from ..obs import flight_recorder as _flight

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def _rss_kb() -> tuple[float, bool]:
    """→ (resident KiB, exact) — exact=False means peak-RSS fallback."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE / 1024.0, True
    except (OSError, ValueError, IndexError):
        import resource

        return float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss), False


def _disk_kb(path: str) -> float:
    total = 0
    for dirpath, _dirnames, filenames in os.walk(path):
        for name in filenames:
            try:
                total += os.path.getsize(os.path.join(dirpath, name))
            except OSError:
                continue  # a file evicted/renamed mid-walk
    return total / 1024.0


def _series_count(registries) -> int:
    n = 0
    for reg in registries:
        try:
            snap = reg.collect()
        except Exception:  # noqa: BLE001 — a dying registry reads as empty
            continue
        n += len(snap.get("counters", {}))
        n += len(snap.get("gauges", {}))
        n += len(snap.get("histograms", {}))
    return n


class ResourceProbe:
    """Samples the run's footprint; verdicts bounded growth.

    ``registries`` is the list of :class:`~..obs.registry.MetricsRegistry`
    objects whose series count to watch (the global registry plus the
    fleet's); the flight recorder is read through the module-level
    install."""

    def __init__(self, workdir: str, registries=(), table_dir: str | None = None):
        self.workdir = workdir
        self.registries = list(registries)
        self.table_dir = table_dir
        self.samples: list[dict] = []
        self._t0 = time.monotonic()

    def sample(self, label: str) -> dict:
        rss, exact = _rss_kb()
        rec = _flight.recorder()
        dump_dir = rec.dump_dir or ""
        s = {
            "label": label,
            "t_s": round(time.monotonic() - self._t0, 3),
            "rss_kb": round(rss, 1),
            "rss_exact": exact,
            "disk_kb": round(_disk_kb(self.workdir), 1),
            "metric_series": _series_count(self.registries),
            "ring_events": len(rec.events),
            "ring_capacity": rec.events.maxlen,
            "dump_files": len([
                f for f in (os.listdir(dump_dir)
                            if dump_dir and os.path.isdir(dump_dir) else [])
                if f.endswith(".json")
            ]),
        }
        if self.table_dir is not None:
            # the unbounded table's own footprint, sampled per
            # boundary so check_report can hold it under the budget at
            # EVERY point of the day, not just the final sample
            s["table_kb"] = round(_disk_kb(self.table_dir), 1)
        self.samples.append(s)
        return s

    def report(
        self,
        rss_growth_ratio: float = 2.5,
        max_disk_mb: float = 256.0,
        max_metric_series: int = 4096,
    ) -> dict:
        """The bounded-growth verdict over the sample trail."""
        if len(self.samples) < 2:
            return {
                "bounded": False, "samples": list(self.samples),
                "violations": ["fewer than 2 samples — growth unobservable"],
            }
        first, last = self.samples[0], self.samples[-1]
        mid = self.samples[len(self.samples) // 2]
        violations: list[str] = []
        if first["rss_exact"] and last["rss_exact"]:
            ratio = last["rss_kb"] / max(first["rss_kb"], 1.0)
            if ratio > rss_growth_ratio:
                violations.append(
                    f"rss grew {ratio:.2f}x over the run "
                    f"(ceiling {rss_growth_ratio}x)"
                )
        if last["disk_kb"] > max_disk_mb * 1024.0:
            violations.append(
                f"workdir at {last['disk_kb'] / 1024.0:.1f} MiB "
                f"(cap {max_disk_mb} MiB)"
            )
        if last["metric_series"] > max_metric_series:
            violations.append(
                f"{last['metric_series']} metric series "
                f"(cap {max_metric_series})"
            )
        # cardinality must be FLAT once the run is warm: every phase adds
        # tenants' traffic, and a per-phase/per-retry label would compound
        grown = last["metric_series"] - mid["metric_series"]
        if grown > max(0.25 * mid["metric_series"], 16):
            violations.append(
                f"metric series grew by {grown} between mid-run and end "
                "— an unbounded label is compounding"
            )
        if last["ring_events"] > (last["ring_capacity"] or 0):
            violations.append(
                f"flight ring at {last['ring_events']} events > capacity "
                f"{last['ring_capacity']}"
            )
        return {
            "bounded": not violations,
            "violations": violations,
            "rss_first_kb": first["rss_kb"],
            "rss_last_kb": last["rss_kb"],
            "disk_last_kb": last["disk_kb"],
            "series_last": last["metric_series"],
            "samples": list(self.samples),
        }
