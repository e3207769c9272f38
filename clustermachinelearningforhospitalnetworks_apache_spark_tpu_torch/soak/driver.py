"""The compressed-production-day soak: one run of the whole day.

One :func:`run_soak` call replays a whole diurnal day against the full
stack, at schedule-time compression:

* **ingest** — per phase, seeded multi-hospital CSVs (a configured few
  dirtied at the ``ingest.csv_text`` boundary) stream through the
  firewall into the unbounded table; incremental views fold each commit;
* **serve** — a replica fleet serves the multi-tenant farm under the
  open-loop diurnal load (``serve/fleet/loadgen.py``; kills interleave
  with arrivals deterministically via the ``events=`` hook);
* **lifecycle** — at phase boundaries the per-tenant views feed drift
  scoring; drifted tenants get a masked refit whose successor farm is
  hot-swapped into the fleet *mid-traffic* in the next phase;
* **chaos** — the seeded schedule (:func:`~.schedule.build_chaos_schedule`)
  kills replicas (with later revival), arms ``InjectedCrash`` at named
  sites with a covering operation + recovery per site, and runs one
  double-kill: a checkpointed farm fit killed at ``fit_ckpt.save.commit``,
  killed AGAIN at ``fit_ckpt.resume`` inside the recovery path, then
  completed and compared bit-for-bit against an uninterrupted fit.

The verdict is the CRC-wrapped ``SoakReport``
(:mod:`~.report`); :func:`~.report.check_report` machine-checks every
acceptance invariant.  A wedged subsystem is converted into a named
failure by the :class:`~..serve.fleet.watchdog.StallWatchdog` instead of
hanging the suite.

This module is the recovery boundary of every injected kill: where it
catches an ``InjectedCrash``, the kill goes on as a site-tagged
postmortem in the report.

Every device entry point the day reaches — the farm fits and refits,
the fleet's replicas, the views and the stream — runs on the one
``device`` of :func:`run_soak` (default the card, which must be
present); with ``device="cpu"`` nothing touches CUDA.  The event order,
the chaos covering operations and the report's keys are the JAX
package's, so its ``check_report`` reads a report of this module's.
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np

from ..core.schema import hospital_event_schema
from ..core.table import Table
from ..core.sql_views import ViewRegistry
from ..core.table_lifecycle import RetentionPolicy, TableLifecycle
from ..device import resolve_device
from ..farm.farm import FarmKMeans
from ..io.csv import CSV_TEXT_SITE, write_csv
from ..lifecycle.farm import retrain_drifted
from ..obs import flight_recorder as _flight
from ..obs import trace as _trace
from ..obs.registry import global_registry
from ..quality.firewall import DataFirewall
from ..serve.fleet import loadgen
from ..serve.fleet.admission import SLO_BATCH, SLO_INTERACTIVE
from ..serve.fleet.replica_set import ReplicaSet
from ..serve.fleet.watchdog import StallWatchdog
from ..streaming import (
    FileStreamSource,
    StreamCheckpoint,
    StreamExecution,
    UnboundedTable,
)
from ..utils import faults
from ..utils.faults import fault_point
from ..utils.logging import get_logger
from .report import SCHEMA_VERSION, write_report
from .resource_probe import ResourceProbe
from .schedule import (
    KIND_CRASH,
    KIND_DOUBLE_KILL,
    KIND_KILL,
    KIND_REVIVE,
    ChaosEvent,
    SoakConfig,
    build_chaos_schedule,
)

log = get_logger("soak")

FEATURES = (
    "admission_count", "current_occupancy", "emergency_visits",
    "seasonality_index",
)
SERVING_NAME = "farm"
BUCKETS = (1, 8, 32)
#: per-tenant drift feed: the incremental view the boundary check reads
VIEW_QUERY = (
    "SELECT hospital_id, count(*) AS c, avg(admission_count) AS adm,"
    " avg(length_of_stay) AS alos FROM events GROUP BY hospital_id"
)
#: the history lifecycle the day runs under: seal everything
#: but the freshest two batches (each phase ingests one batch, so the
#: previous day-segment goes cold a phase later), retire the superseded
#: parts, scrub what's sealed.  Small chunks keep every tick exercising
#: seal + retire + scrub rather than waiting for a deep backlog.
RETENTION = RetentionPolicy(
    min_seal_batches=1, hot_batches=2, max_segment_batches=4,
)


class _SoakRun:
    """All mutable run state; one instance per :func:`run_soak` call."""

    def __init__(self, cfg: SoakConfig, workdir: str, device=None):
        self.cfg = cfg
        self.workdir = workdir
        #: every device entry point of the day runs here
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(cfg.seed)
        self.tenants = [f"H{i:02d}" for i in range(cfg.n_tenants)]
        self.drift_set = set(self.tenants[: cfg.drift_tenants])
        self.plan = faults.FaultPlan(seed=cfg.seed)
        self.views = ViewRegistry(device=self.device)
        # one firewall across stream incarnations: compiled once, and its
        # attempt-scoped counters survive crash-restart rebuilds
        self.firewall = DataFirewall(hospital_event_schema())
        self.unhandled: list[str] = []
        self.kills: list[dict] = []
        self.phase_rows: list[dict] = []
        self.lifecycle_ticks: list[dict] = []
        self.heartbeat = 0
        self._csv_seq = 0
        self._event_t0 = np.datetime64("2026-03-30T00:00:00")
        self._arrival_n = 0
        self.pending_swap = None
        self.current_model = None
        self.fleet: ReplicaSet | None = None
        self.stream: StreamExecution | None = None
        self._kill_records: dict[str, dict] = {}  # replica idx -> record
        self.retune_event: dict | None = None  # the mid-day retune record
        for sub in ("incoming", "table", "ckpt", "models", "flight",
                    "tune"):
            os.makedirs(os.path.join(workdir, sub), exist_ok=True)

    # ------------------------------------------------------------ data
    def _tenant_rows(self, tenant: str, n: int, drifted: bool) -> dict:
        """One tenant's feature draw; ``drifted`` shifts the admission/
        emergency distributions hard enough to clear PSI_DRIFT."""
        i = self.tenants.index(tenant)
        scale = self.cfg.drift_scale if drifted else 1.0
        r = self.rng
        return {
            "admission_count": np.clip(
                r.normal((18 + 3 * i) * scale, 4.0, n), 0, None
            ).astype(np.int64),
            "current_occupancy": np.clip(
                r.normal(120 + 10 * i, 20.0, n), 1, None
            ).astype(np.int64),
            "emergency_visits": np.clip(
                r.normal((8 + i) * scale, 2.5, n), 0, None
            ).astype(np.int64),
            "seasonality_index": r.uniform(0.5, 1.5, n),
            "length_of_stay": r.uniform(1.0, 9.0, n),
        }

    def day_zero_pools(self) -> dict[str, np.ndarray]:
        """Every tenant's training pool, in tenant order: the run's first
        draws, so a fresh run of the same config rebuilds them exactly."""
        return {
            t: np.column_stack([
                self._tenant_rows(t, self.cfg.rows_per_tenant, False)[f]
                .astype(np.float64)
                for f in FEATURES
            ])
            for t in self.tenants
        }

    def _write_phase_csv(self, tag: str, drift: bool) -> str:
        """One multi-hospital CSV into the incoming dir; event times keep
        advancing across the whole day."""
        cfg = self.cfg
        per = max(cfg.ingest_rows_per_phase // cfg.n_tenants, 4)
        cols: dict[str, list] = {k: [] for k in FEATURES}
        cols["length_of_stay"] = []
        ids: list[str] = []
        for t in self.tenants:
            draw = self._tenant_rows(t, per, drift and t in self.drift_set)
            for k in draw:
                cols[k].append(draw[k])
            ids.extend([t] * per)
        n = len(ids)
        times = self._event_t0 + np.arange(n).astype("timedelta64[s]")
        self._event_t0 = times[-1] + np.timedelta64(1, "s")
        table = Table.from_dict(
            {
                "hospital_id": np.array(ids, dtype=object),
                "event_time": times,
                **{k: np.concatenate(v) for k, v in cols.items()},
            },
            hospital_event_schema(),
        )
        self._csv_seq += 1
        path = os.path.join(
            self.workdir, "incoming", f"{tag}-{self._csv_seq:04d}.csv"
        )
        write_csv(table, path)
        return path

    # ------------------------------------------------------------ stack
    def build_stream(self) -> StreamExecution:
        schema = hospital_event_schema()
        return StreamExecution(
            source=FileStreamSource(
                os.path.join(self.workdir, "incoming"), schema
            ),
            sink=UnboundedTable(
                os.path.join(self.workdir, "table"), schema,
                disk_budget_bytes=int(
                    self.cfg.table_budget_mb * 1024 * 1024
                ),
            ),
            checkpoint=StreamCheckpoint(os.path.join(self.workdir, "ckpt")),
            firewall=self.firewall,
            views=self.views,
            device=self.device,
        )

    def ingest(self, tag: str, drift: bool) -> None:
        self.heartbeat += 1
        self._write_phase_csv(tag, drift)
        self.stream.run_once()

    def lifecycle_tick(self, tag: str) -> None:
        """One seal/retire/scrub pass over the unbounded table at a phase
        boundary — the retention mechanism that keeps the
        table under ``cfg.table_budget_mb`` all day.  The scrub verdict
        rides into the report; a lifecycle failure is an unhandled
        entry, never a hung or silently-skipped tick."""
        self.heartbeat += 1
        try:
            lc = TableLifecycle(self.stream.sink, RETENTION)
            out = lc.tick()
            scrub = lc.scrub()
            self.lifecycle_ticks.append({
                "tag": tag,
                "sealed": int(out["sealed"]),
                "retired": int(out["retired"]),
                "scrub": scrub,
                "table_bytes": int(self.stream.sink.on_disk_bytes()),
            })
        except Exception as e:  # noqa: BLE001 — the report must see it
            self.unhandled.append(f"lifecycle {tag}: {e!r}")

    def live_windows(self, window: int = 64) -> dict[str, np.ndarray]:
        tbl = self.stream.sink.read()
        if len(tbl) == 0:
            return {}
        hid = np.asarray(tbl.column("hospital_id"))
        mat = tbl.numeric_matrix(FEATURES)
        return {
            t: mat[hid == t][-window:]
            for t in self.tenants if int((hid == t).sum()) > 0
        }

    # ------------------------------------------------------------ serving
    def submit_arrival(self, a) -> object:
        self.heartbeat += 1
        self._arrival_n += 1
        model = self.fleet.registry.get(SERVING_NAME).model
        pool = self.req_pool[a.tenant_id]
        i = self._arrival_n % (len(pool) - a.rows + 1)
        x = pool[i: i + a.rows]
        return self.fleet.submit(
            SERVING_NAME, model.route_request(a.tenant_id, x),
            tenant_id=a.tenant_id, slo=a.slo,
        )

    def _swap_with_recovery(self, model, context: str) -> bool:
        """Fleet hot swap; an armed crash in the swap path is caught,
        recorded, and the swap retried once (phase-1 failures flip zero
        replicas, so the retry starts clean)."""
        for attempt in range(2):
            try:
                self.fleet.swap_model(SERVING_NAME, model)
                self.current_model = model
                return True
            except faults.InjectedCrash as e:
                self._record_event(
                    kind=KIND_CRASH, target=str(e.site),
                    label=f"crash:{e.site}@{context}", recovered=True,
                    postmortems=[self._last_postmortem(e)],
                )
        self.unhandled.append(f"{context}: swap failed twice")
        return False

    def _last_postmortem(self, exc) -> dict:
        return {
            "path": _flight.recorder().last_dump_path,
            "site": getattr(exc, "site", None),
        }

    def _record_event(self, **kw) -> dict:
        rec = {
            "kind": kw.get("kind"), "target": kw.get("target"),
            "label": kw.get("label"), "t_wall": round(time.monotonic(), 3),
            "recovered": bool(kw.get("recovered")),
            "postmortems": kw.get("postmortems", []),
        }
        if "bit_identical" in kw:
            rec["bit_identical"] = kw["bit_identical"]
        self.kills.append(rec)
        return rec

    # ------------------------------------------------------------ chaos
    def dispatch(self, ev: ChaosEvent) -> None:
        """Execute one chaos event.  The tick itself is an injectable
        site (the schedule can target the harness); a crash there is
        caught and the tick re-run — the one-shot rule self-exhausts."""
        self.heartbeat += 1
        try:
            for _ in range(2):
                try:
                    fault_point("soak.schedule.tick", event=ev.label)
                    break
                except faults.InjectedCrash as e:
                    self._record_event(
                        kind=KIND_CRASH, target="soak.schedule.tick",
                        label=f"crash:soak.schedule.tick@{ev.label}",
                        recovered=True,
                        postmortems=[self._last_postmortem(e)],
                    )
            if ev.kind == KIND_KILL:
                self._exec_kill(ev)
            elif ev.kind == KIND_REVIVE:
                self._exec_revive(ev)
            elif ev.kind == KIND_CRASH:
                self._exec_crash(ev)
            elif ev.kind == KIND_DOUBLE_KILL:
                self._exec_double_kill(ev)
        except faults.InjectedCrash as e:
            # a crash that escaped its covering op's recovery — recovered
            # control-flow-wise (the run goes on) but recorded unrecovered
            self._record_event(
                kind=ev.kind, target=ev.target, label=ev.label,
                recovered=False, postmortems=[self._last_postmortem(e)],
            )
        except Exception as e:  # noqa: BLE001 — the report must see it
            self.unhandled.append(f"chaos {ev.label}: {e!r}")

    def _exec_kill(self, ev: ChaosEvent) -> None:
        idx = int(ev.target)
        if not self.fleet.replicas[idx].healthy():
            # already dead (stacked kills in a dense schedule): a no-op
            # kill still records, paired revive will mark it recovered
            pass
        else:
            self.fleet.kill_replica(idx)
        pm_path = _flight.notify(
            "chaos", "soak.replica.kill", replica=idx, event=ev.label
        )
        rec = self._record_event(
            kind=KIND_KILL, target=ev.target, label=ev.label,
            recovered=False,
            postmortems=[{"path": pm_path, "site": "soak.replica.kill"}],
        )
        self._kill_records[ev.target] = rec

    def _exec_revive(self, ev: ChaosEvent) -> None:
        idx = int(ev.target)
        if self.fleet.replicas[idx].state == "dead":
            self.fleet.revive_replica(idx)
        revived = self.fleet.replicas[idx].healthy()
        self._record_event(
            kind=KIND_REVIVE, target=ev.target, label=ev.label,
            recovered=revived,
        )
        rec = self._kill_records.get(ev.target)
        if rec is not None and revived:
            rec["recovered"] = True

    def _exec_crash(self, ev: ChaosEvent) -> None:
        """Arm a one-shot crash at the target site, run the covering
        operation, recover, record."""
        ops = {
            "stream.after_commit": (self._op_ingest, self._recover_stream),
            "sql.view.maintain": (self._op_ingest, self._recover_views),
            "fleet.swap.prepare": (self._op_swap, self._op_swap),
            "soak.schedule.tick": (self._op_tick, lambda: None),
        }
        if ev.target not in ops:
            self.unhandled.append(f"chaos {ev.label}: no covering op")
            return
        op, recover = ops[ev.target]
        self.plan.crash(ev.target)
        try:
            op()
        except faults.InjectedCrash as e:
            pm = self._last_postmortem(e)
            try:
                recover()
            except faults.InjectedCrash as e2:
                self._record_event(
                    kind=KIND_CRASH, target=ev.target, label=ev.label,
                    recovered=False,
                    postmortems=[pm, self._last_postmortem(e2)],
                )
                return
            self._record_event(
                kind=KIND_CRASH, target=ev.target, label=ev.label,
                recovered=True, postmortems=[pm],
            )
        else:
            # the armed rule never fired: the covering op no longer
            # reaches the site — that's drift, and the report must fail
            self.plan.rules = [
                r for r in self.plan.rules
                if not (r.site == ev.target and r.action == "crash")
            ]
            self._record_event(
                kind=KIND_CRASH, target=ev.target, label=ev.label,
                recovered=False, postmortems=[],
            )

    # covering operations ------------------------------------------------
    def _op_ingest(self) -> None:
        self.ingest("chaos", drift=False)

    def _op_tick(self) -> None:
        fault_point("soak.schedule.tick", event="covering-op")

    def _op_swap(self) -> None:
        self.fleet.swap_model(SERVING_NAME, self.current_model)

    def _recover_stream(self) -> None:
        """Crash-restart discipline: a fresh stream over the same dirs
        resumes from the checkpoint (committed batches skip, uncommitted
        replay)."""
        self.stream = self.build_stream()
        self.ingest("recovery", drift=False)

    def _recover_views(self) -> None:
        self.stream = self.build_stream()
        self.views.maintain(self.stream.sink)

    def _exec_double_kill(self, ev: ChaosEvent) -> None:
        """The crash-during-crash-recovery case: kill a checkpointed farm
        fit at the commit site, kill the RESTARTED fit inside
        ``FitCheckpointer.resume``, finish on the third incarnation, and
        require bit-identity with an uninterrupted (same-config,
        checkpointed, never-killed) fit."""
        cfg = self.cfg
        ck = os.path.join(self.workdir, "fitckpt")
        est = FarmKMeans(
            k=cfg.kmeans_k, max_iter=cfg.kmeans_iters, seed=cfg.seed,
            feature_names=list(FEATURES), checkpoint_dir=ck,
            checkpoint_every=cfg.checkpoint_every,
        )
        pms = []
        # after=1: the FIRST commit must land — resume() bails out before
        # its own fault site when no commit record exists yet, so a crash
        # on commit #0 could never be followed by a crash inside recovery
        self.plan.crash("fit_ckpt.save.commit", after=1)
        try:
            est.fit(self.train_pool, device=self.device)
            self.unhandled.append("double-kill: first kill never fired")
            return
        except faults.InjectedCrash as e:
            pms.append(self._last_postmortem(e))
        self.plan.crash("fit_ckpt.resume")
        try:
            est.fit(self.train_pool, device=self.device)
            self.unhandled.append("double-kill: second kill never fired")
            return
        except faults.InjectedCrash as e:
            pms.append(self._last_postmortem(e))
        # third incarnation completes, resumed onto the same device
        model = est.fit(self.train_pool, device=self.device)
        clean = FarmKMeans(
            k=cfg.kmeans_k, max_iter=cfg.kmeans_iters, seed=cfg.seed,
            feature_names=list(FEATURES),
            checkpoint_dir=os.path.join(self.workdir, "fitckpt-clean"),
            checkpoint_every=cfg.checkpoint_every,
        ).fit(self.train_pool, device=self.device)
        identical = all(
            np.array_equal(model.arrays[k], clean.arrays[k])
            for k in ("centers", "sizes")
        )
        self._record_event(
            kind=KIND_DOUBLE_KILL, target=ev.target, label=ev.label,
            recovered=identical and len(pms) == 2, postmortems=pms,
            bit_identical=identical,
        )


def run_soak(
    cfg: SoakConfig, workdir: str, report_path: str | None = None,
    device=None,
) -> tuple[dict, str]:
    """Run the compressed day on ``device`` (default the card, raising
    without one); → ``(report_payload, report_path)``.

    The report is always written (CRC-wrapped, atomic) — pass/fail lives
    in :func:`~.report.check_report` over the payload, so a failing soak
    still leaves the full evidence trail."""
    run = _SoakRun(cfg, workdir, device)
    report_path = report_path or os.path.join(workdir, "soak_report.json")
    chaos = build_chaos_schedule(cfg)
    prev_recorder = _flight.recorder()
    rec = _flight.install(_flight.FlightRecorder(
        dump_dir=os.path.join(workdir, "flight")
    ))
    tracer = _trace.Tracer(path=None)
    t_wall0 = time.monotonic()
    try:
        with faults.active(run.plan), _trace.active(tracer):
            payload = _run_inner(run, chaos, tracer, t_wall0)
    finally:
        _flight.install(prev_recorder)
    path = write_report(payload, report_path)
    return payload, path


def _run_inner(run: _SoakRun, chaos, tracer, t_wall0) -> dict:
    cfg = run.cfg

    # dirty reads: a seeded handful of CSV ingests get fields mangled at
    # the text boundary — the firewall's quarantine lane, not a crash
    for j in range(cfg.dirty_reads):
        run.plan.mangle_fields(
            CSV_TEXT_SITE, rate=cfg.dirty_field_rate, times=1,
            after=1 + 2 * j,
            columns=("admission_count", "length_of_stay"),
        )

    # train the day-zero farm from the seeded per-tenant pools
    run.train_pool = run.day_zero_pools()
    run.req_pool = {
        t: run.train_pool[t][:32].copy() for t in run.tenants
    }
    day_zero = FarmKMeans(
        k=cfg.kmeans_k, max_iter=cfg.kmeans_iters, seed=cfg.seed,
        feature_names=list(FEATURES),
    ).fit(run.train_pool, device=run.device)
    day_zero.save(os.path.join(run.workdir, "models", "farm-day0"))
    run.current_model = day_zero

    run.fleet = ReplicaSet(
        n_replicas=cfg.n_replicas, devices=(run.device,) * cfg.n_replicas,
    )
    run.fleet.add_model(SERVING_NAME, day_zero, buckets=BUCKETS)
    run.fleet.start()

    run.stream = run.build_stream()
    run.ingest("seed", drift=False)
    run.views.register("per_tenant", VIEW_QUERY, run.stream.sink)
    seen_counts = {t: 0 for t in run.tenants}

    probe = ResourceProbe(
        run.workdir, registries=[global_registry(), run.fleet.metrics],
        table_dir=os.path.join(run.workdir, "table"),
    )
    probe.sample("start")

    wd = StallWatchdog(window_s=cfg.stall_window_s)
    wd.register("soak.driver", lambda: float(run.heartbeat))
    wd.watch_fleet(run.fleet)
    wd.register(
        "soak.stream",
        lambda: float(run.stream.sink.num_rows()),
        busy_fn=lambda: False,  # ingest progress shows in the heartbeat
    )

    phase_start = 0.0
    trace_info: dict = {}
    try:
        wd.start()
        for pi, phase in enumerate(cfg.phases):
            try:
                fault_point("soak.phase.transition", phase=phase.name)
            except faults.InjectedCrash as e:
                run._record_event(
                    kind=KIND_CRASH, target="soak.phase.transition",
                    label=f"crash:soak.phase.transition@{phase.name}",
                    recovered=True, postmortems=[run._last_postmortem(e)],
                )
            run.heartbeat += 1
            try:
                _run_phase(run, phase, pi, phase_start, chaos)
            except Exception as e:  # noqa: BLE001 — the report must see it
                run.unhandled.append(f"phase {phase.name}: {e!r}")
            phase_start += phase.duration_s
            run.lifecycle_tick(phase.name)
            probe.sample(f"after:{phase.name}")
            _boundary_lifecycle(run, phase, seen_counts)
            if pi == (len(cfg.phases) - 1) // 2:
                _midday_retune(run, phase.name)
            wd.check()

        trace_info = _traced_cycle(run)
        run.lifecycle_tick("final")
        wd.check()
    finally:
        wd.stop()
        if run.fleet is not None:
            run.fleet.stop()

    probe.sample("end")
    res = probe.report(
        rss_growth_ratio=cfg.rss_growth_ratio,
        max_disk_mb=cfg.max_disk_mb,
        max_metric_series=cfg.max_metric_series,
    )
    health = run.fleet.health()
    quarantined = int(run.firewall.rows_rejected)
    return {
        "version": SCHEMA_VERSION,
        "seed": cfg.seed,
        "config": cfg.to_dict(),
        "wall_s": round(time.monotonic() - t_wall0, 3),
        "phases": run.phase_rows,
        "unanswered_total": sum(
            int(p.get("unanswered", 0)) for p in run.phase_rows
        ),
        "unhandled": run.unhandled,
        "kills": run.kills,
        "double_kills": sum(
            1 for k in run.kills if k["kind"] == KIND_DOUBLE_KILL
        ),
        "chaos_schedule": [e.to_dict() for e in chaos],
        "resources": res,
        "lifecycle": {
            "ticks": run.lifecycle_ticks,
            "segments_sealed": sum(
                t["sealed"] for t in run.lifecycle_ticks
            ),
            "parts_retired": sum(
                t["retired"] for t in run.lifecycle_ticks
            ),
            "scrub_repairs": sum(
                int(t["scrub"].get("repaired", 0))
                for t in run.lifecycle_ticks
            ),
        },
        "trace": trace_info,
        "fleet_health": {
            "status": health["status"],
            "replicas_killed": health["replicas_killed"],
            "rerouted": health["rerouted"],
            "promotions": health["promotions"],
            "requests": health["requests"],
        },
        "ingest": {
            "rows_in_table": int(run.stream.sink.num_rows()),
            "rows_quarantined": quarantined,
            "csv_files": run._csv_seq,
        },
        "retune": run.retune_event,
    }


def _run_phase(run, phase, pi, phase_start, chaos) -> None:
    cfg = run.cfg
    run.ingest(phase.name, drift=pi > 0)

    profile = loadgen.LoadProfile(
        base_rate_rps=cfg.base_rate_rps * phase.rate_mult,
        tenants=tuple(
            loadgen.TenantMix(
                t,
                weight=2.0 if i < 2 else 1.0,
                slo=SLO_BATCH if i == len(run.tenants) - 1
                else SLO_INTERACTIVE,
                rows=1,
            )
            for i, t in enumerate(run.tenants)
        ),
        seed=cfg.seed + pi,
        burst_start_s=0.25 * phase.duration_s if phase.burst else None,
        burst_dur_s=0.5 * phase.duration_s if phase.burst else 0.0,
        burst_mult=2.0 if phase.burst else 1.0,
    )
    schedule = loadgen.build_schedule(profile, phase.duration_s)

    phase_end = phase_start + phase.duration_s
    is_last = pi == len(cfg.phases) - 1
    due = [
        e for e in chaos
        if phase_start <= e.t < phase_end or (is_last and e.t >= phase_end)
    ]
    events = [
        (e.t - phase_start, (lambda ev=e: run.dispatch(ev))) for e in due
    ]
    if run.pending_swap is not None:
        model, run.pending_swap = run.pending_swap, None
        events.append((
            0.3 * phase.duration_s,
            lambda m=model: run._swap_with_recovery(
                m, f"mid-traffic@{phase.name}"
            ),
        ))

    rep = loadgen.replay(
        run.submit_arrival, schedule, speed=cfg.speed,
        wait_timeout_s=cfg.wait_timeout_s, events=events,
    )
    inter = rep["reports"].get(SLO_INTERACTIVE)
    if inter is not None:
        slo = inter.in_slo(phase.slo_deadline_s)
        goodput = slo["rows"] / max(inter.offered_rows, 1)
        p99 = slo["p99_ms"]
    else:
        goodput, p99 = 1.0, None
    run.phase_rows.append({
        "name": phase.name,
        "offered_requests": rep["offered_requests"],
        "offered_rows": rep["offered_rows"],
        "ok_rows": rep["ok_rows"],
        "unanswered": rep["unanswered"],
        "goodput_frac": round(goodput, 4),
        "min_goodput_frac": phase.min_goodput_frac,
        "in_slo_p99_ms": p99,
        "max_pacing_lag_s": rep["max_pacing_lag_s"],
        "wall_s": rep["wall_s"],
        "per_class": rep["per_class"],
    })


def _boundary_lifecycle(run, phase, seen_counts) -> None:
    """Phase-boundary drift cycle: the per-tenant view names who has
    fresh rows, the sink supplies their live windows, drifted tenants
    get a masked refit staged for the NEXT phase's mid-traffic swap."""
    try:
        view = run.views.get("per_tenant")
        vt = view.read()
        fresh: set[str] = set()
        if len(vt) > 0:
            hids = np.asarray(vt.column("hospital_id"))
            counts = np.asarray(vt.column("c"))
            for h, c in zip(hids, counts):
                if int(c) - seen_counts.get(str(h), 0) >= 8:
                    fresh.add(str(h))
                seen_counts[str(h)] = int(c)
        if not fresh:
            return
        live = {
            t: w for t, w in run.live_windows().items() if t in fresh
        }
        new_model, rep = retrain_drifted(
            run.current_model, data=live, live=live, min_rows=8,
            device=run.device,
        )
        drifted = rep.get("drifted") or {}
        if drifted:
            run.pending_swap = new_model
            log.info(
                "drift retrain staged", phase=phase.name,
                drifted=sorted(drifted),
            )
    except faults.InjectedCrash as e:
        run._record_event(
            kind=KIND_CRASH, target=str(e.site),
            label=f"crash:{e.site}@boundary:{phase.name}",
            recovered=True, postmortems=[run._last_postmortem(e)],
        )
    except Exception as e:  # noqa: BLE001 — the report must see it
        run.unhandled.append(f"boundary {phase.name}: {e!r}")


def _midday_retune(run, phase_name: str) -> None:
    """The mid-day live-retune event.

    Between phases the loadgen is quiet, so the run probes the LIVE
    fleet — short synchronous single-row bursts through the front door,
    once at the deployed micro-batch linger and once at the 0 ms
    candidate (observed load on the serving fleet, not an offline
    sweep), each banked as a ``source="live"`` trial — then lets the
    :class:`~..tune.LiveRetuner` re-decide through its journaled
    intent → ``tune.select.apply`` → commit protocol.  The journal lives
    in the workdir, so a restarted soak resumes the tuned value;
    :func:`~.report.check_report` asserts interactive goodput does not
    regress across this boundary."""
    from .. import tune
    from ..streaming.wal import read_lines

    try:
        tune_dir = os.path.join(run.workdir, "tune")
        deployed_ms = float(run.fleet._server_kw["max_wait_s"]) * 1e3
        rt = tune.LiveRetuner(
            "serve.microbatch.max_wait_ms",
            journal_path=os.path.join(tune_dir, "retune.journal"),
            apply_fn=run.fleet.set_max_wait_s,
            selector=tune.Selector(
                tune.TrialStore(os.path.join(tune_dir, "trials.json"))
            ),
            convert=lambda ms: ms / 1e3,
        )
        model = run.fleet.registry.get(SERVING_NAME).model
        tenant = run.tenants[0]
        routed = model.route_request(tenant, run.req_pool[tenant][:1])

        def probe_rps(seconds: float = 0.2) -> float:
            # a full collection of the process's heap pauses every thread
            # for about as long as a window lasts and would decide the
            # A/B by itself: collect before the window, none inside it
            gc.collect()
            gc_on = gc.isenabled()
            gc.disable()
            try:
                n, t0 = 0, time.monotonic()
                while time.monotonic() - t0 < seconds:
                    run.fleet.predict(SERVING_NAME, routed, tenant_id=tenant)
                    run.heartbeat += 1
                    n += 1
                return n / max(time.monotonic() - t0, 1e-9)
            finally:
                if gc_on:
                    gc.enable()

        probes: dict[float, float] = {}
        for v in dict.fromkeys((0.0, deployed_ms)):  # each value once
            run.fleet.set_max_wait_s(v / 1e3)
            rt.current = v  # observe() records against the serving value
            probes[v] = probe_rps()
            rt.observe(probes[v], meta={"phase": phase_name})
        # restore the deployed value: the MOVE must go through the
        # journaled retune protocol, not through the probe loop
        run.fleet.set_max_wait_s(deployed_ms / 1e3)
        rt.current = deployed_ms
        out = rt.retune(shape_rows=1)
        run.retune_event = {
            **out,
            "boundary_after_phase": phase_name,
            "probe_rps": {str(k): round(p, 1) for k, p in probes.items()},
            "journal_kinds": [
                e.get("kind") for e in read_lines(rt.journal_path)
            ] if os.path.exists(rt.journal_path) else [],
        }
        log.info(
            "mid-day retune", knob=out["knob"], old=out["old"],
            new=out["new"], applied=out["applied"], reason=out["reason"],
        )
    except faults.InjectedCrash as e:
        run._record_event(
            kind=KIND_CRASH, target=str(e.site),
            label=f"crash:{e.site}@retune:{phase_name}",
            recovered=True, postmortems=[run._last_postmortem(e)],
        )
    except Exception as e:  # noqa: BLE001 — the report must see it
        run.unhandled.append(f"retune {phase_name}: {e!r}")


def _traced_cycle(run) -> dict:
    """The invariant-7 cycle, all on one thread under one root span:
    raw CSV row → stream batch → view maintenance → drifted retrain →
    fleet promotion.  Returns the trace evidence the report embeds."""
    promoted_path = os.path.join(run.workdir, "models", "farm-promoted")
    with _trace.span("soak.run", {"seed": run.cfg.seed}) as root:
        csv_path = run._write_phase_csv("traced", drift=True)
        run.heartbeat += 1
        run.stream.run_once()
        live = {
            t: w for t, w in run.live_windows().items()
            if len(w) >= 8
        }
        new_model, rep = retrain_drifted(
            run.current_model, data=live, live=live,
            threshold=0.0, min_rows=8,
            save_path=promoted_path,
            server=run.fleet, serving_name=SERVING_NAME,
            device=run.device,
        )
        run.current_model = new_model
        trace_id = root.trace_id
    tracer = _trace._TRACER
    names = sorted({
        s["name"] for s in (tracer.spans if tracer else [])
        if s["trace_id"] == trace_id
    })
    return {
        "trace_id": trace_id,
        "span_names": names,
        "csv_file": os.path.basename(csv_path),
        "promoted_model": promoted_path,
        "retrained_tenants": sorted(rep.get("drifted") or {}),
    }
