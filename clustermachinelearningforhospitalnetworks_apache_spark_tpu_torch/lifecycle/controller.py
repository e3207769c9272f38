"""LifecycleController: the closed continuous-learning loop (the JAX
package's ``lifecycle/controller.py``).

Every part of the loop exists on its own — the drift monitor trips
breakers, the streaming ingest commits exactly once, fit checkpoints
resume bit-identically, the registry swaps models — and this module
closes it into a state machine that *operates itself* under live traffic:

    SERVING ──sustained PSI / metric decay──▶ DRIFT_SUSPECTED
    DRIFT_SUSPECTED ──confirmed──▶ RETRAINING   (──recovered──▶ SERVING)
    RETRAINING ──candidate artifact committed──▶ SHADOW
    SHADOW ──parity gate pass──▶ CANARY         (──fail──▶ ROLLED_BACK)
    CANARY ──no regression──▶ PROMOTED          (──regression──▶ ROLLED_BACK)
    PROMOTED / ROLLED_BACK ──▶ SERVING          (new / prior baseline)

Durability: every transition is one CRC-verified journal append
(:mod:`.journal`), and every transition's side effects are idempotent —
the retrain warm-starts from the serving artifact and resumes through
``io/fit_checkpoint``, artifact saves displace-and-install, the registry
flip installs a *journaled* version.  Kill the process at ANY stage
boundary (the ``lifecycle.*`` fault sites) and a freshly constructed
controller resumes the loop exactly where it died, converging on the same
final model as an uninterrupted run.

The serving side talks to this object through three small hooks
(``on_request`` / ``on_result`` / ``health_fragment``) that
:class:`~..serve.server.InferenceServer` calls when a controller is
attached — canary routing, shadow scoring, and drift observation all ride
the normal request path.

Device work: the retrain is the port's ``KMeans.fit`` (the K1 kernel, on
the retrainer's ``device=``, default the card; resident or through
``HostDataset`` blocks), and the primary, the shadow ``ServingModel`` and
the canary answers run K2 on the server's device.  The journal, the gates,
the canary split and ``kmeans_cost`` are host work.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Any

import numpy as np

from ..io.model_io import (
    artifact_fingerprint,
    attach_data_profile,
    load_data_profile,
    load_model,
)
from ..obs import flight_recorder as _flight
from ..obs import trace as _trace
from ..quality.drift import DriftMonitor
from ..quality.sketches import DataProfile, PSI_DRIFT
from ..serve.bucketing import DEFAULT_BUCKETS
from ..serve.metrics import ServingMetrics
from ..serve.queue import STATUS_CANARY, ServeResult
from ..serve.registry import ServingModel
from ..utils.faults import fault_point
from ..utils.logging import get_logger
from .journal import LifecycleJournal
from .promotion import CanaryRouter, ParityGate, ShadowScorer

log = get_logger("lifecycle")

STATE_SERVING = "serving"
STATE_DRIFT_SUSPECTED = "drift_suspected"
STATE_RETRAINING = "retraining"
STATE_SHADOW = "shadow"
STATE_CANARY = "canary"
STATE_PROMOTED = "promoted"
STATE_ROLLED_BACK = "rolled_back"

#: every state the machine can journal, for validation
STATES = (
    STATE_SERVING, STATE_DRIFT_SUSPECTED, STATE_RETRAINING, STATE_SHADOW,
    STATE_CANARY, STATE_PROMOTED, STATE_ROLLED_BACK,
)

#: states during which a candidate model exists
_CANDIDATE_STATES = (
    STATE_RETRAINING, STATE_SHADOW, STATE_CANARY, STATE_PROMOTED,
    STATE_ROLLED_BACK,
)


def kmeans_cost(model, x: np.ndarray) -> float:
    """Mean squared distance to the nearest center — the lower-is-better
    evaluation metric the default retrainer/gates use.  Host numpy: the
    windows it scores are hundreds of rows, not millions."""
    c = np.asarray(model.cluster_centers, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    d2 = ((x[:, None, :] - c[None, :, :]) ** 2).sum(axis=-1)
    return float(d2.min(axis=1).mean())


@dataclass
class KMeansRetrainer:
    """Warm-started KMeans refit over an ingest-table snapshot.

    The serving artifact's centers seed the new fit
    (``KMeans.warm_start_centers``): the relative cluster geometry rarely
    moves as fast as the distribution, so the warm fit converges in the
    few Lloyd iterations the drift actually requires instead of paying
    k-means++ plus the full trajectory.  ``checkpoint_dir`` threads the
    exact-resume fit checkpoints through the fit, and tables at/over
    ``out_of_core_rows`` rows stream through the device in blocks
    (``parallel/outofcore``) so the unbounded table never has to fit in
    device memory.  The fit runs on ``device`` (default the card).
    """

    feature_cols: tuple
    k: int = 8
    max_iter: int = 50
    tol: float = 1e-4
    checkpoint_every: int = 1
    #: wrap the snapshot in a HostDataset at/over this many rows
    #: (None = always resident)
    out_of_core_rows: int | None = None
    warm: bool = True
    #: translate the warm centers by the observed mean shift before the
    #: fit.  Under covariate shift the whole cloud moves but the relative
    #: cluster geometry survives; RAW old centers can land outside the
    #: shifted cloud entirely, one center swallows every row, and Lloyd
    #: converges to a collapsed local optimum — aligning the first moment
    #: keeps the geometry AND the few-iteration convergence.
    recenter: bool = True
    device: Any = None

    def __call__(self, warm_model, table, ckpt_dir: str, seed: int):
        from ..models.kmeans import KMeans
        from ..parallel.outofcore import HostDataset

        x64 = np.column_stack(
            [np.asarray(table.column(c), dtype=np.float64)
             for c in self.feature_cols]
        )
        x = x64.astype(np.float32)
        warm_centers = None
        if self.warm and warm_model is not None:
            cc = getattr(warm_model, "cluster_centers", None)
            if cc is not None and np.asarray(cc).shape == (self.k, x.shape[1]):
                warm_centers = np.asarray(cc, dtype=np.float32)
        if warm_centers is not None and self.recenter:
            sizes = getattr(warm_model, "cluster_sizes", None)
            w = (
                np.maximum(np.asarray(sizes, dtype=np.float64), 0.0)
                if sizes is not None else np.ones(self.k)
            )
            w = w / max(w.sum(), 1e-9)
            old_mean = (w[:, None] * warm_centers).sum(axis=0)
            warm_centers = (
                warm_centers + (x64.mean(axis=0) - old_mean)
            ).astype(np.float32)
        est = KMeans(
            k=self.k, max_iter=self.max_iter, tol=self.tol, seed=seed,
            warm_start_centers=warm_centers,
            checkpoint_dir=ckpt_dir, checkpoint_every=self.checkpoint_every,
        )
        data = x
        if self.out_of_core_rows and x.shape[0] >= self.out_of_core_rows:
            data = HostDataset(x, max_device_rows=self.out_of_core_rows)
        model = est.fit(data, device=self.device)
        profile = DataProfile.from_matrix(x64, self.feature_cols)
        return model, profile


class _RecentRows:
    """Bounded ring of the latest traffic rows — the evaluation window the
    decay trigger and both promotion gates score models on."""

    def __init__(self, cap: int):
        self.cap = max(int(cap), 1)
        self._rows: np.ndarray | None = None
        self._lock = threading.Lock()

    def push(self, rows: np.ndarray) -> None:
        rows = np.atleast_2d(np.asarray(rows, dtype=np.float64))
        with self._lock:
            if self._rows is not None and self._rows.shape[1] != rows.shape[1]:
                self._rows = None  # width change: restart the window
            buf = rows if self._rows is None else np.concatenate(
                [self._rows, rows], axis=0
            )
            self._rows = buf[-self.cap:]

    def rows(self) -> np.ndarray | None:
        with self._lock:
            return None if self._rows is None else self._rows.copy()


class LifecycleController:
    """Drift-triggered warm retrain + shadow/canary promotion, journaled.

    ``root`` is the controller's durable home: ``journal.log``, one
    artifact directory per model version (``models/v<n>``), and one fit-
    checkpoint directory per retrain (``retrain/v<n>``).  Versions are
    never destroyed by promotion or rollback — the flip merely selects
    one — so a rollback restores the prior artifact byte-for-byte by
    construction and every decision stays auditable.

    Traffic reaches the machine through the serve hooks (attach with
    ``server.attach_lifecycle(controller)``); ``poll()`` advances the
    heavy transitions (retrain, gates, flip) on the caller's thread.

    ``server`` is anything with the promotion surface the controller
    drives — ``add_model`` / ``swap_model`` / ``registry.names()`` /
    ``attach_lifecycle`` — and a ``device`` (an
    :class:`~..serve.InferenceServer`): the candidate's shadow
    ``ServingModel`` is built there.
    """

    def __init__(
        self,
        root: str,
        server,
        model_name: str,
        retrainer,
        *,
        stream=None,
        sink=None,
        metric_fn=kmeans_cost,
        feedback=None,
        fallback=None,
        buckets=DEFAULT_BUCKETS,
        drift_threshold: float = PSI_DRIFT,
        drift_window_rows: int = 128,
        drift_trip_after: int = 2,
        metric_decay_ratio: float = 2.0,
        eval_rows: int = 256,
        gate: ParityGate | None = None,
        shadow_min_rows: int = 192,
        canary_fraction: float = 0.125,
        canary_min_rows: int = 48,
        recover_after_rows: int | None = None,
        base_seed: int = 0,
        training_view=None,
    ):
        self.root = root
        self.server = server
        self.model_name = model_name
        self.retrainer = retrainer
        self.stream = stream
        self.sink = sink if sink is not None else (
            stream.sink if stream is not None else None
        )
        #: materialized view the retrain reads its training
        #: window from — already delta-maintained per committed batch, so
        #: the ingest→retrain-snapshot path stops paying O(history); the
        #: journaled snapshot pin still applies (``read(upto_batch_id)``)
        self.training_view = training_view
        if training_view is not None and self.sink is not None and (
            os.path.abspath(training_view.source.path)
            != os.path.abspath(self.sink.path)
        ):
            raise ValueError(
                "training_view must be a view over the controller's sink"
            )
        self.metric_fn = metric_fn
        self.feedback = feedback
        self.fallback = fallback
        self.buckets = tuple(buckets)
        self.drift_threshold = drift_threshold
        self.drift_window_rows = drift_window_rows
        self.drift_trip_after = drift_trip_after
        self.metric_decay_ratio = metric_decay_ratio
        self.eval_rows = eval_rows
        self.gate = gate or ParityGate()
        self.shadow_min_rows = shadow_min_rows
        self.canary_fraction = canary_fraction
        self.canary_min_rows = canary_min_rows
        #: calm traffic rows after which DRIFT_SUSPECTED de-escalates back
        #: to SERVING (the "recovered" edge) — without it one transient
        #: hot window parks the machine in suspicion forever and ANY later
        #: noise reads as the confirming second signal
        self.recover_after_rows = (
            recover_after_rows if recover_after_rows is not None
            else 4 * drift_window_rows * drift_trip_after
        )
        self.base_seed = base_seed

        os.makedirs(root, exist_ok=True)
        self.journal = LifecycleJournal(os.path.join(root, "journal.log"))
        self._lock = threading.RLock()
        self._poll_lock = threading.Lock()
        self._recent = _RecentRows(eval_rows)

        self.state: str | None = None
        self.cycle = 0
        self.active_version: int | None = None
        self.candidate_version: int | None = None
        self.baseline_metric: float | None = None
        self.last_metric: float | None = None
        self._max_version = -1
        self._installed_version: int | None = None
        self._active_model = None
        self._active_profile: dict | None = None
        self._active_id: str | None = None
        self._monitor: DriftMonitor | None = None
        self._rows_since_eval = 0
        self._calm_rows = 0  # rows since the last drift/decay signal
        self._candidate_model = None
        self._candidate_profile: dict | None = None
        self._candidate_sm: ServingModel | None = None
        self._candidate_id: str | None = None
        self._scorer: ShadowScorer | None = None
        self._shadow_rows_seen = 0
        self._router: CanaryRouter | None = None
        self._canary_rows = 0
        self._canary_primary_rows = 0
        self._canary_failures = 0
        self._recover()

    # ------------------------------------------------------------ paths
    def _model_path(self, version: int) -> str:
        return os.path.join(self.root, "models", f"v{int(version)}")

    def _ckpt_path(self, version: int) -> str:
        return os.path.join(self.root, "retrain", f"v{int(version)}")

    # -------------------------------------------------------- bootstrap
    def bootstrap(self, model, profile: DataProfile, train_x=None) -> None:
        """Install the initial baseline (version 0): save the artifact
        with its training profile, journal SERVING.  No-op when the
        journal already has history (an idempotent construction step)."""
        if self.journal.last() is not None:
            return
        path = self._model_path(0)
        model.save(path)
        attach_data_profile(path, profile.to_dict())
        baseline = None
        if train_x is not None and self.metric_fn is not None:
            baseline = float(
                self.metric_fn(model, np.asarray(train_x)[: self.eval_rows * 4])
            )
        with _trace.span(
            "lifecycle.transition", {"state": STATE_SERVING, "cycle": 0}
        ):
            self.journal.append(
                STATE_SERVING, 0,
                {"active_version": 0, "baseline_metric": baseline},
            )
        self._recover()

    # ---------------------------------------------------------- recovery
    def _recover(self) -> None:
        entries = self.journal.entries()
        if not entries:
            return
        last = entries[-1]
        self.state = last["state"]
        self.cycle = last["cycle"]
        active = None
        baseline = None
        retrain_info = None
        max_v = 0
        for e in entries:
            info = e.get("info", {})
            if info.get("active_version") is not None:
                active = int(info["active_version"])
                max_v = max(max_v, active)
            if "baseline_metric" in info and info["baseline_metric"] is not None:
                baseline = float(info["baseline_metric"])
            if e["state"] == STATE_RETRAINING:
                retrain_info = (e["cycle"], info)
                max_v = max(max_v, int(info.get("candidate_version", 0)))
        self.active_version = active
        self.baseline_metric = baseline
        self._max_version = max_v
        if (
            retrain_info is not None
            and retrain_info[0] == self.cycle
            and self.state in _CANDIDATE_STATES
        ):
            self.candidate_version = int(retrain_info[1]["candidate_version"])
        else:
            self.candidate_version = None
        if (
            self.state in (STATE_RETRAINING, STATE_SHADOW, STATE_CANARY)
            and self.candidate_version is None
        ):
            # the cycle's RETRAINING record was lost to corruption while a
            # later entry survived: the candidate can no longer be
            # identified, so abandon the cycle instead of crashing every
            # future construction — the baseline keeps serving, and the
            # abandonment itself is journaled
            log.error(
                "journal damage: RETRAINING record lost for the live "
                "cycle; abandoning it", cycle=self.cycle, state=self.state,
                corrupt_skipped=self.journal.corrupt_skipped,
            )
            self.journal.append(STATE_ROLLED_BACK, self.cycle, {
                "active_version": active,
                "candidate_version": None,
                "reason": "journal damage: RETRAINING record lost",
            })
            self.state = STATE_ROLLED_BACK
        self._install_active()
        if self.state == STATE_SHADOW:
            self._arm_shadow()
        elif self.state == STATE_CANARY:
            self._arm_shadow()
            self._arm_canary()
        elif self.state in (STATE_PROMOTED, STATE_ROLLED_BACK):
            # the flip/rollback decision is journaled (and applied by
            # _install_active above); finish the hop back to SERVING
            self._finish_cycle()
        log.info(
            "lifecycle recovered", state=self.state, cycle=self.cycle,
            active_version=self.active_version,
            candidate_version=self.candidate_version,
        )

    def _install_active(self) -> None:
        """Make the journaled active version the one actually serving —
        idempotent, called at recovery and after a flip decision."""
        if self.active_version is None:
            return
        path = self._model_path(self.active_version)
        self._active_model = load_model(path)
        self._active_profile = load_data_profile(path)
        self._active_id = artifact_fingerprint(path)
        profile = (
            DataProfile.from_dict(self._active_profile)
            if self._active_profile is not None else None
        )
        if profile is not None:
            if self._monitor is None:
                self._monitor = DriftMonitor(
                    profile,
                    threshold=self.drift_threshold,
                    window_rows=self.drift_window_rows,
                    trip_after=self.drift_trip_after,
                )
            else:
                self._monitor.rebase(profile)
        if self.model_name in self.server.registry.names():
            self.server.swap_model(
                self.model_name, self._active_model,
                buckets=self.buckets, data_profile=self._active_profile,
            )
        else:
            # thread the controller's drift tuning through, so the
            # server-side monitor (the one that trips the breaker) runs
            # the configured windows, not the server's defaults
            self.server.add_model(
                self.model_name, path, buckets=self.buckets,
                fallback=self.fallback,
                drift_threshold=self.drift_threshold,
                drift_window_rows=self.drift_window_rows,
                drift_trip_after=self.drift_trip_after,
            )
        self._installed_version = self.active_version

    # ----------------------------------------------------------- journal
    def _journal_to(self, state: str, info: dict | None = None) -> None:
        # every journal hop is a span: the durable append is
        # the transition, so its span IS the lifecycle leg of a trace
        sp = _trace.span("lifecycle.transition")
        with sp:
            if sp.trace_id is not None:
                sp.note("state", state)
                sp.note("cycle", int(self.cycle))
            with self._lock:
                self.journal.append(state, self.cycle, info)
                self.state = state
        _flight.note("lifecycle", state, cycle=int(self.cycle))
        log.info("lifecycle transition", state=state, cycle=self.cycle,
                 **{k: v for k, v in (info or {}).items()
                    if isinstance(v, (int, float, str, bool, type(None)))})

    # ------------------------------------------------------- serve hooks
    def on_request(self, name: str, x) -> ServeResult | None:
        """Canary routing: during CANARY, a deterministic fraction of
        requests is answered by the candidate (tagged ``STATUS_CANARY``);
        None keeps the request on the primary path.  A candidate failure
        here silently falls back to the primary — the canary must never
        cost a client an answer."""
        if name != self.model_name or self.state != STATE_CANARY:
            return None
        router, sm = self._router, self._candidate_sm
        if router is None or sm is None or not router.take():
            return None
        rows = np.atleast_2d(np.asarray(x, dtype=np.float64))
        try:
            preds = sm.predict(rows)
        except Exception as e:  # noqa: BLE001 — candidate-only failure
            self._canary_failures += 1
            log.warning("canary predict failed; primary answers",
                        error=repr(e))
            return None
        return ServeResult(
            preds, STATUS_CANARY,
            detail=f"candidate v{self.candidate_version}",
        )

    def on_result(self, name: str, x, result: ServeResult) -> None:
        """Post-answer observation: drift windows, the decay trigger, the
        shadow scorer, and canary accounting all feed from here."""
        if name != self.model_name or self.state is None:
            return
        rows = np.atleast_2d(np.asarray(x, dtype=np.float64))
        # belt-and-braces for servers WITHOUT an input guard: a non-finite
        # row in the evaluation window turns every metric into NaN, which
        # would both disable the decay trigger (NaN > ratio is False) and
        # spuriously flunk a healthy candidate at the parity gate
        finite = np.isfinite(rows).all(axis=1)
        primary_vals = (
            None if result.value is None else np.asarray(result.value)
        )
        if not finite.all():
            rows = rows[finite]
            if primary_vals is not None and len(primary_vals) == len(finite):
                primary_vals = primary_vals[finite]
        if rows.shape[0] == 0:
            return
        self._recent.push(rows)
        st = self.state
        if st in (STATE_SERVING, STATE_DRIFT_SUSPECTED):
            self._observe_baseline(rows)
        elif st == STATE_SHADOW:
            self._shadow_rows_seen += rows.shape[0]
            self._observe_shadow(rows, result, primary_vals)
        elif st == STATE_CANARY:
            if result.status == STATUS_CANARY:
                self._canary_rows += rows.shape[0]
            else:
                self._canary_primary_rows += rows.shape[0]

    def _observe_baseline(self, rows: np.ndarray) -> None:
        tripped = False
        max_psi = 0.0
        if self._monitor is not None:
            self._monitor.observe(rows)
            tripped = self._monitor.should_trip()
            max_psi = self._monitor.max_psi
        decayed, ratio = self._metric_decay(rows.shape[0])
        if not (tripped or decayed):
            # the "recovered" edge: a transient hot window must not park
            # the machine in suspicion forever (where any later noise
            # would read as the confirming second signal)
            self._calm_rows += rows.shape[0]
            if (
                self.state == STATE_DRIFT_SUSPECTED
                and self._calm_rows >= self.recover_after_rows
            ):
                with self._lock:
                    if self.state == STATE_DRIFT_SUSPECTED:
                        self._journal_to(STATE_SERVING, {
                            "active_version": self.active_version,
                            "baseline_metric": self.baseline_metric,
                            "reason": "recovered: signal did not persist",
                        })
            return
        self._calm_rows = 0
        reason = (
            f"sustained PSI {max_psi:.3f}" if tripped
            else f"metric decay {ratio:.2f}x baseline"
        )
        with self._lock:
            if self.state == STATE_SERVING:
                self._journal_to(STATE_DRIFT_SUSPECTED, {
                    "reason": reason, "max_psi": round(max_psi, 4),
                    "metric_ratio": None if ratio is None else round(ratio, 4),
                })
            elif self.state == STATE_DRIFT_SUSPECTED:
                # second independent signal = confirmation
                self._begin_retrain(reason)

    def _metric_decay(self, n_new: int) -> tuple[bool, float | None]:
        if (
            self.baseline_metric is None or self.metric_fn is None
            or self.baseline_metric <= 0
        ):
            return False, None
        self._rows_since_eval += n_new
        if self._rows_since_eval < self.eval_rows:
            return False, None
        self._rows_since_eval = 0
        rows = self._recent.rows()
        if rows is None or rows.shape[0] < min(32, self.eval_rows):
            return False, None
        try:
            m = float(self.metric_fn(self._active_model, rows))
        except Exception as e:  # noqa: BLE001 — a broken metric must not
            # take down the serving path it piggybacks on
            log.warning("metric eval failed", error=repr(e))
            return False, None
        self.last_metric = m
        ratio = m / self.baseline_metric
        return ratio > self.metric_decay_ratio, ratio

    def _observe_shadow(
        self, rows: np.ndarray, result: ServeResult, primary_vals
    ) -> None:
        sm, scorer = self._candidate_sm, self._scorer
        if sm is None or scorer is None or not result.ok:
            return
        if primary_vals is None:
            return
        try:
            cand = sm.predict(rows)
        except Exception as e:  # noqa: BLE001 — shadow must not break serving
            log.warning("shadow predict failed", error=repr(e))
            return
        scorer.observe(primary_vals, cand)

    # -------------------------------------------------------- transitions
    def _begin_retrain(self, reason: str) -> None:
        """DRIFT_SUSPECTED → RETRAINING: journal the snapshot pin (sink
        batch id) and the derived seed, so a killed retrain resumes on
        EXACTLY the rows and trajectory the original attempt had."""
        cand = self._max_version + 1
        self._max_version = cand
        self.candidate_version = cand
        self.cycle = cand
        snapshot = self.sink.max_batch_id() if self.sink is not None else None
        self._journal_to(STATE_RETRAINING, {
            "candidate_version": cand,
            "snapshot_batch_id": snapshot,
            "seed": self.base_seed + cand,
            "reason": reason,
        })

    def poll(self) -> str | None:
        """Advance the machine one step (the heavy transitions run here,
        on the caller's thread): retrain when RETRAINING, gate when
        SHADOW/CANARY windows fill, finish a journaled flip/rollback.
        Returns the (possibly new) state.  Concurrent pollers don't
        stack: a poll that finds another in flight returns immediately
        (two threads must never both run the retrain)."""
        if not self._poll_lock.acquire(blocking=False):
            return self.state
        try:
            st = self.state
            if st == STATE_RETRAINING:
                self._run_retrain()
            elif st == STATE_SHADOW:
                self._maybe_gate_shadow()
            elif st == STATE_CANARY:
                self._maybe_decide_canary()
            elif st in (STATE_PROMOTED, STATE_ROLLED_BACK):
                if (
                    st == STATE_PROMOTED
                    and self._installed_version != self.active_version
                ):
                    # the flip was journaled but its in-process apply
                    # failed (e.g. a transient swap_model error escaped a
                    # prior poll): install the journaled version before
                    # finishing, mirroring what restart recovery does —
                    # else the server silently keeps serving the OLD
                    # model while everything reports the new one
                    self._install_active()
                self._finish_cycle()
        finally:
            self._poll_lock.release()
        return self.state

    def _retrain_entry(self) -> dict:
        for e in reversed(self.journal.entries()):
            if e["state"] == STATE_RETRAINING and e["cycle"] == self.cycle:
                return e["info"]
        raise RuntimeError(
            f"in state {self.state} with no RETRAINING journal entry for "
            f"cycle {self.cycle}"
        )

    def _run_retrain(self) -> None:
        with _trace.span("lifecycle.retrain", {"cycle": int(self.cycle)}):
            self._run_retrain_inner()

    def _run_retrain_inner(self) -> None:
        if self.sink is None:
            raise RuntimeError(
                "RETRAINING requires a sink (the unbounded ingest table)"
            )
        info = self._retrain_entry()
        cand = int(info["candidate_version"])
        seed = int(info["seed"])
        upto = info.get("snapshot_batch_id")
        if self.training_view is not None:
            # the view is already current per committed batch — the pinned
            # read folds retained deltas ≤ the journaled snapshot id
            # instead of re-scanning the table's history
            table = self.training_view.read(upto_batch_id=upto)
        else:
            table = self.sink.read(upto_batch_id=upto)
        if len(table) == 0:
            raise RuntimeError("retrain snapshot is empty")
        t0 = time.perf_counter()
        model, profile = self.retrainer(
            self._active_model, table, self._ckpt_path(cand), seed
        )
        retrain_s = time.perf_counter() - t0
        cand_path = self._model_path(cand)
        model.save(cand_path)
        attach_data_profile(cand_path, profile.to_dict())
        # the commit point: artifact + profile are durable; a kill here
        # replays the (checkpoint-resumed) retrain into the same bytes
        fault_point("lifecycle.retrain.commit", version=cand)
        self._journal_to(STATE_SHADOW, {
            "candidate_version": cand,
            "candidate_id": artifact_fingerprint(cand_path),
            "train_rows": len(table),
            "retrain_s": round(retrain_s, 3),
            "warm_started": bool(getattr(model, "n_iter", 0))
            and self._active_model is not None,
        })
        self._arm_shadow()

    def _arm_shadow(self) -> None:
        """Load the candidate for shadow scoring (idempotent re-arm on
        recovery — shadow stats restart, the gate decision doesn't care
        WHICH rows filled its window)."""
        fault_point("lifecycle.shadow.start", version=self.candidate_version)
        path = self._model_path(self.candidate_version)
        self._candidate_model = load_model(path)
        self._candidate_profile = load_data_profile(path)
        self._candidate_id = artifact_fingerprint(path)
        self._candidate_sm = ServingModel(
            self._candidate_model, buckets=self.buckets,
            metrics=ServingMetrics(), device=self.server.device,
        ).warmup()  # shadow scoring rides the request path: no cold compile
        self._scorer = ShadowScorer()
        self._shadow_rows_seen = 0

    def _arm_canary(self) -> None:
        self._router = CanaryRouter(self.canary_fraction)
        self._canary_rows = 0
        self._canary_primary_rows = 0
        self._canary_failures = 0

    def _window_metrics(self) -> tuple[float, float] | None:
        rows = self._recent.rows()
        if rows is None or rows.shape[0] < 16:
            return None
        pm = float(self.metric_fn(self._active_model, rows))
        cm = float(self.metric_fn(self._candidate_model, rows))
        return pm, cm

    def _maybe_gate_shadow(self) -> None:
        if self._scorer is None:
            return
        # normal path: a full divergence window.  Degraded path: sustained
        # drift legitimately OPENS the primary's breaker, so
        # primary answers carry no predictions to diverge against — the
        # loop must still make progress (it IS the cure), so after 2x the
        # window of observed traffic the metric-based gate decides alone.
        if (
            self._scorer.rows < self.shadow_min_rows
            and self._shadow_rows_seen < 2 * self.shadow_min_rows
        ):
            return
        metrics = self._window_metrics()
        if metrics is None:
            return
        pm, cm = metrics
        decision = self.gate.decide(pm, cm, self._scorer.snapshot())
        if decision:
            self._journal_to(STATE_CANARY, {"gate": decision.stats})
            self._arm_canary()
        else:
            self._rollback("shadow parity: " + "; ".join(decision.reasons))

    def _maybe_decide_canary(self) -> None:
        if self._canary_rows < self.canary_min_rows:
            return
        if self._canary_failures > 0:
            self._rollback(
                f"{self._canary_failures} candidate failures during canary"
            )
            return
        metrics = self._window_metrics()
        if metrics is None:
            return
        pm, cm = metrics
        decision = self.gate.decide(pm, cm)
        if decision:
            self._promote(decision)
        else:
            self._rollback("canary regression: " + "; ".join(decision.reasons))

    def _promote(self, decision) -> None:
        with _trace.span(
            "lifecycle.promote", {"candidate": self.candidate_version}
        ):
            self._promote_inner(decision)

    def _promote_inner(self, decision) -> None:
        cand = self.candidate_version
        fault_point("lifecycle.registry.flip", version=cand)
        new_baseline = decision.stats["candidate_metric"]
        # the durable flip decision FIRST: a kill between here and the
        # in-memory swap recovers into PROMOTED and re-applies the flip
        self._journal_to(STATE_PROMOTED, {
            "active_version": cand,
            "baseline_metric": new_baseline,
            "gate": decision.stats,
            "canary": self._router.snapshot() if self._router else None,
        })
        self.active_version = cand
        self.baseline_metric = float(new_baseline)
        self._apply_flip()
        self._finish_cycle()

    def _apply_flip(self) -> None:
        """The atomic registry flip: swap_model installs the candidate AND
        rebases the server's PSI reference to the candidate's profile
        under one lock (the DriftMonitor re-trip fix), and resets the
        breaker; the controller's own monitor rebases the same way."""
        self._active_model = self._candidate_model
        self._active_profile = self._candidate_profile
        self._active_id = self._candidate_id
        self.server.swap_model(
            self.model_name, self._active_model,
            buckets=self.buckets, data_profile=self._active_profile,
        )
        if self._monitor is not None and self._active_profile is not None:
            self._monitor.rebase(DataProfile.from_dict(self._active_profile))
        self._installed_version = self.active_version

    def _rollback(self, reason: str) -> None:
        cand = self.candidate_version
        # a refused candidate is a postmortem moment: dump the flight
        # ring BEFORE the transition, so the artifact holds the shadow/
        # canary evidence that led to the refusal
        _flight.notify(
            "lifecycle_rollback", "lifecycle.rollback",
            candidate_version=cand, reason=reason,
        )
        with _trace.span("lifecycle.rollback", {"candidate": cand}):
            fault_point("lifecycle.rollback", version=cand)
            # the prior artifact was never touched — the journal entry IS
            # the rollback; the candidate's artifact stays on disk as
            # evidence
            self._journal_to(STATE_ROLLED_BACK, {
                "active_version": self.active_version,
                "candidate_version": cand,
                "reason": reason,
            })
        log.error("candidate rolled back", candidate_version=cand,
                  reason=reason)
        self._finish_cycle()

    def _finish_cycle(self) -> None:
        self._candidate_model = None
        self._candidate_profile = None
        self._candidate_sm = None
        self._candidate_id = None
        self.candidate_version = None
        self._scorer = None
        self._router = None
        self._canary_rows = 0
        self._canary_primary_rows = 0
        self._canary_failures = 0
        self._rows_since_eval = 0
        self._journal_to(STATE_SERVING, {
            "active_version": self.active_version,
            "baseline_metric": self.baseline_metric,
        })

    # ----------------------------------------------------------- feedback
    def record_served(self, x_row, prediction: float) -> int | None:
        """Spool one served prediction into the feedback buffer (None
        when no buffer is attached); the returned id joins the outcome."""
        if self.feedback is None:
            return None
        return self.feedback.record_prediction(x_row, prediction)

    def record_outcome(self, feedback_id: int, outcome: float) -> None:
        if self.feedback is None:
            raise RuntimeError("no feedback buffer attached")
        self.feedback.record_outcome(feedback_id, outcome)

    def ingest_once(self):
        """One pump of the feedback loop: flush joined feedback rows into
        the incoming directory, then let the stream commit one batch."""
        if self.feedback is not None:
            self.feedback.flush()
        if self.stream is not None:
            return self.stream.run_once()
        return None

    # ------------------------------------------------------------- health
    def health_fragment(self) -> dict:
        """What ``InferenceServer.health()`` embeds under ``lifecycle``."""
        out = {
            "phase": self.state,
            "cycle": self.cycle,
            "active_version": self.active_version,
            "active_model_id": self._active_id,
            "candidate_version": self.candidate_version,
            "candidate_model_id": self._candidate_id,
            "baseline_metric": self.baseline_metric,
            "last_metric": self.last_metric,
            "shadow": (
                {**self._scorer.snapshot(),
                 "rows_observed": self._shadow_rows_seen}
                if self._scorer is not None else None
            ),
            "canary": None,
            "drift": (
                self._monitor.snapshot() if self._monitor is not None else None
            ),
            "journal_corrupt_skipped": self.journal.corrupt_skipped,
        }
        if self._router is not None:
            out["canary"] = {
                **self._router.snapshot(),
                "canary_rows": self._canary_rows,
                "primary_rows": self._canary_primary_rows,
                "candidate_failures": self._canary_failures,
            }
        if self.feedback is not None:
            out["feedback"] = {
                "pending_outcomes": self.feedback.pending_outcomes(),
                "joined_unflushed": len(self.feedback.joined_unflushed()),
            }
        return out
