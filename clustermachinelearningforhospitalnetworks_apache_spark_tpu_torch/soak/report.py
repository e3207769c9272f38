"""SoakReport: one CRC-wrapped, machine-checked verdict per soak run.

The report is the run's ONLY pass/fail surface — no grepping logs, no
eyeballing dashboards.  ``write_report`` wraps the payload exactly like
a flight-recorder dump (``{"crc32c": <hex>, "payload": {...}}`` over
canonical JSON, atomic tmp+fsync+rename), so the same tamper/torn-write
guarantees hold and the chaos leg's verification block can reuse one
reading discipline for both artifact kinds.  ``check_report`` is the
machine check: every invariant of the soak, as code, returning the
(hopefully empty) violation list.  The file's bytes and the payload's
keys are the JAX package's, so either package reads and checks the
other's report.  Host code: nothing here touches a device.

Invariants checked:

1.  zero unhandled exceptions anywhere in the run;
2.  ``unanswered == 0`` — every request answered or cleanly shed,
    overall and per phase;
3.  interactive goodput within SLO at every diurnal phase
    (in-SLO rows / offered rows ≥ the phase's floor);
4.  every injected kill recovered, with a CRC-intact postmortem dump
    tagged with the killing site;
5.  at least one double-kill (a crash inside crash recovery), both of
    its crashes recovered, and the twice-restarted fit bit-identical to
    an uninterrupted run;
6.  memory / disk / metric-cardinality / flight-ring growth bounded
    (the resource probe's verdict), and the history
    lifecycle ticked all day (seal/retire/scrub, no unrebuilt
    quarantine) with the unbounded table under ``table_budget_mb``
    at EVERY probe sample;
7.  one trace id follows a raw CSV row through ingest → view
    maintenance → retrain → fleet promotion;
8.  replayability: the chaos schedule embedded in the report equals the
    one re-derived from the embedded config's seed.
"""

from __future__ import annotations

import json
import os

from ..io.fit_checkpoint import fsync_dir
from ..io.integrity import crc32c_hex
from ..utils.faults import fault_point
from .schedule import SoakConfig, build_chaos_schedule

SCHEMA_VERSION = 1

#: the span chain invariant 7 requires under the report's trace id
REQUIRED_TRACE_SPANS = (
    "stream.batch", "sql.view.maintain", "lifecycle.retrain",
    "fleet.promote",
)


def _canonical(payload: dict) -> str:
    return json.dumps(
        payload, sort_keys=True, separators=(",", ":"), default=str
    )


def write_report(payload: dict, path: str) -> str:
    """Atomically write the CRC-wrapped report; returns ``path``."""
    body = _canonical(payload)
    record = {"crc32c": crc32c_hex(body.encode()), "payload": payload}
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    fault_point("soak.report.commit", path=path)
    with open(tmp, "w") as f:
        json.dump(record, f, sort_keys=True, separators=(",", ":"),
                  default=str)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(parent)
    return path


def read_report(path: str) -> dict:
    """Load + CRC-verify one report; ``ValueError`` on tamper/torn."""
    with open(path) as f:
        record = json.load(f)
    if not isinstance(record, dict) or "payload" not in record:
        raise ValueError(f"{path}: not a SoakReport record")
    got = crc32c_hex(_canonical(record["payload"]).encode())
    want = record.get("crc32c")
    if got != want:
        raise ValueError(
            f"{path}: crc32c mismatch ({got} computed, {want} recorded)"
        )
    return record["payload"]


def check_report(payload: dict, verify_postmortems: bool = True) -> list[str]:
    """Machine-check every invariant; → violation list (empty = pass).

    ``verify_postmortems=False`` skips re-reading dump files from disk
    (for checking a report that moved hosts); everything in-payload is
    still checked."""
    v: list[str] = []

    # 1. zero unhandled exceptions
    unhandled = payload.get("unhandled", None)
    if unhandled is None:
        v.append("report carries no 'unhandled' record")
    elif unhandled:
        v.append(f"{len(unhandled)} unhandled exception(s): {unhandled[:3]}")

    # 2./3. per-phase answers + goodput
    phases = payload.get("phases", [])
    if not phases:
        v.append("report carries no phases")
    for p in phases:
        name = p.get("name", "?")
        ua = int(p.get("unanswered", -1))
        if ua != 0:
            v.append(f"phase {name}: unanswered={ua} (must be 0)")
        frac = p.get("goodput_frac")
        floor = p.get("min_goodput_frac")
        if frac is None or floor is None:
            v.append(f"phase {name}: goodput accounting missing")
        elif frac < floor:
            v.append(
                f"phase {name}: in-SLO goodput {frac:.3f} below the "
                f"{floor:.2f} floor"
            )
    if int(payload.get("unanswered_total", -1)) != 0:
        v.append(
            f"unanswered_total={payload.get('unanswered_total')} (must be 0)"
        )

    # 4. every injected kill recovered, postmortem CRC-intact + site-tagged
    kills = payload.get("kills", [])
    if not kills:
        v.append("no chaos events recorded — the schedule never ran")
    for k in kills:
        label = k.get("label", "?")
        if not k.get("recovered"):
            v.append(f"chaos event {label}: not recovered")
        for pm in k.get("postmortems", []):
            pm_path, pm_site = pm.get("path"), pm.get("site")
            if not pm_path:
                v.append(f"chaos event {label}: postmortem path missing")
                continue
            if not pm_site:
                v.append(f"chaos event {label}: postmortem has no site tag")
            if verify_postmortems:
                try:
                    from ..obs.flight_recorder import read_dump

                    dump = read_dump(pm_path)
                except (OSError, ValueError) as e:
                    v.append(
                        f"chaos event {label}: postmortem unreadable ({e})"
                    )
                    continue
                if dump.get("site") != pm_site:
                    v.append(
                        f"chaos event {label}: dump tagged "
                        f"{dump.get('site')!r}, report says {pm_site!r}"
                    )

    # 5. the double-kill: present, both crashes recovered, bit-identical
    dk = [k for k in kills if k.get("kind") == "double_kill"]
    if not dk:
        v.append("no double-kill executed (≥1 required)")
    for k in dk:
        if len(k.get("postmortems", [])) < 2:
            v.append(
                "double-kill left fewer than 2 postmortems — the second "
                "crash (inside recovery) never fired"
            )
        if not k.get("bit_identical"):
            v.append(
                "double-kill: twice-restarted fit is NOT bit-identical "
                "to the uninterrupted run"
            )

    # 6. bounded growth
    res = payload.get("resources", {})
    if not res.get("bounded"):
        for r in res.get("violations", ["resource verdict missing"]):
            v.append(f"resources: {r}")

    # 6b. the history lifecycle ran all day and held the
    # unbounded table under its disk budget at EVERY probe sample, not
    # just the final one (a mid-day spike the last sample misses is
    # exactly the pager that fires at 3am)
    lc = payload.get("lifecycle")
    if not lc or not lc.get("ticks"):
        v.append(
            "no lifecycle ticks recorded — seal/retire/scrub never ran"
        )
    else:
        for t in lc["ticks"]:
            scrub = t.get("scrub") or {}
            if int(scrub.get("quarantined", 0)) > 0:
                v.append(
                    f"lifecycle tick {t.get('tag')}: "
                    f"{scrub['quarantined']} segment(s) quarantined "
                    "without rebuild — history lost bytes mid-day"
                )
    budget_mb = (payload.get("config") or {}).get("table_budget_mb")
    if budget_mb is None:
        v.append("config carries no table_budget_mb — budget uncheckable")
    else:
        for s in res.get("samples", []):
            tk = s.get("table_kb")
            if tk is None:
                v.append(
                    f"sample {s.get('label', '?')}: table_kb not "
                    "recorded — table footprint unobservable"
                )
            elif tk > float(budget_mb) * 1024.0:
                v.append(
                    f"sample {s.get('label', '?')}: table at "
                    f"{tk / 1024.0:.1f} MiB over the "
                    f"{budget_mb} MiB budget"
                )

    # 6c. the mid-day live retune: the serving knob moved
    # through the journaled intent→apply→commit protocol, and goodput
    # did not regress across the retune boundary (the tuned value must
    # never buy probe throughput at the cost of in-SLO serving)
    rt = payload.get("retune")
    retune_crashed = any(
        "@retune:" in (k.get("label") or "") for k in kills
    )
    if rt is None:
        if not retune_crashed:
            v.append(
                "no mid-day retune recorded — the live-retune leg "
                "never ran"
            )
    else:
        if not rt.get("applied"):
            v.append(
                f"mid-day retune did not apply (reason "
                f"{rt.get('reason')!r}) — the serving knob never moved"
            )
        else:
            kinds = rt.get("journal_kinds") or []
            if "intent" not in kinds or (kinds and kinds[-1] != "commit"):
                v.append(
                    f"retune journal kinds {kinds} — an applied retune "
                    "must leave intent→commit, commit last"
                )
            if not str(rt.get("reason", "")).startswith("tuned:"):
                v.append(
                    f"applied retune carries reason {rt.get('reason')!r} "
                    "— an applied move must name its winning trial"
                )
        boundary = rt.get("boundary_after_phase")
        names = [p.get("name") for p in phases]
        if boundary not in names:
            v.append(
                f"retune boundary {boundary!r} names no phase in the "
                "report"
            )
        else:
            cut = names.index(boundary)
            before = [
                p.get("goodput_frac") for p in phases[: cut + 1]
                if p.get("goodput_frac") is not None
            ]
            after = [
                p.get("goodput_frac") for p in phases[cut + 1:]
                if p.get("goodput_frac") is not None
            ]
            if not after:
                v.append(
                    "no phases after the retune boundary — the retuned "
                    "value never served"
                )
            elif before and min(after) + 0.05 < min(before):
                v.append(
                    f"goodput regressed across the retune boundary: "
                    f"min {min(before):.3f} before vs {min(after):.3f} "
                    "after"
                )

    # 7. the end-to-end trace
    tr = payload.get("trace", {})
    if not tr.get("trace_id"):
        v.append("no end-to-end trace id recorded")
    else:
        have = set(tr.get("span_names", []))
        missing = [s for s in REQUIRED_TRACE_SPANS if s not in have]
        if missing:
            v.append(
                f"trace {tr['trace_id']}: span chain incomplete, "
                f"missing {missing}"
            )
        if not tr.get("csv_file"):
            v.append("trace does not name the raw CSV it started from")
        if not tr.get("promoted_model"):
            v.append("trace does not name the promoted model artifact")

    # 8. replayability: re-derive the chaos schedule from the embedded
    # config — same seed must mean the same kills in the same order
    cfg_d = payload.get("config")
    if not cfg_d:
        v.append("report carries no config — the run is not replayable")
    else:
        try:
            rebuilt = [
                e.to_dict() for e in
                build_chaos_schedule(SoakConfig.from_dict(cfg_d))
            ]
        except (TypeError, ValueError) as e:
            rebuilt = None
            v.append(f"embedded config does not rebuild: {e}")
        if rebuilt is not None and rebuilt != payload.get("chaos_schedule"):
            v.append(
                "chaos schedule in the report differs from the one "
                "re-derived from its seed — the run is not replayable"
            )

    if int(payload.get("version", -1)) != SCHEMA_VERSION:
        v.append(
            f"schema version {payload.get('version')} != {SCHEMA_VERSION}"
        )
    return v
