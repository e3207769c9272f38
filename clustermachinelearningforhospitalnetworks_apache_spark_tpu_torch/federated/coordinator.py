"""Cross-silo federated fit coordinator (the JAX package's
``federated/coordinator.py``).

The coordinator drives rounds of the mergeable-partials loop over a set
of :class:`~.silo.Silo` participants:

    collect → merge → fit → broadcast

Each phase is a named fault site (``fed.round.{collect,merge,fit,
broadcast}``), the whole round runs under one ``fed.round`` span, and
every collected partial plus every applied state transition is journaled
through the torn-line-safe WAL (``streaming/wal.py``), in the reference's
line kinds and keys (``meta``, ``init``, ``partial``, ``commit``,
``final``) and under its signature, so a coordinator crash resumes the
round without re-asking silos for work they already did — and a journal
either package wrote resumes in the other.

Determinism contract: the merge is the zero-initialized ascending-silo-
order fold of :func:`~.partials.merge_partials`, so the fitted model is
bit-identical regardless of arrival order.  Silos compute on their own
devices; the coordinator's updates and solves run on ``device`` (default
the card), where the pooled fit would run them.

Straggler/dropout ladder: per-silo collects run under
:func:`~..utils.retry.call_with_retry` (transient faults are absorbed
*inside* the round, preserving bit-parity) behind a per-silo
:class:`~..serve.breaker.CircuitBreaker` (a repeatedly failing silo
stops being asked until its recovery timeout).  A round completes at
quorum; a silo that misses a round re-enters on a later round against
the then-current state version — stale partials never fold into a
version they were not computed against (enforced in the merge).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field, replace
from typing import Any, Mapping, Sequence

import numpy as np

from ..device import resolve_device
from ..obs.trace import span
from ..serve.breaker import CircuitBreaker
from ..streaming.wal import append_line, read_lines
from ..utils.faults import fault_point
from ..utils.retry import RetryPolicy, call_with_retry
from .partials import FitState, NoiseConfig, Partials, merge_partials
from .silo import Silo

__all__ = [
    "FED_COLLECT_SITE", "FED_MERGE_SITE", "FED_FIT_SITE",
    "FED_BROADCAST_SITE", "FederatedConfig", "FederatedCoordinator",
    "FederatedFitResult", "FederatedQuorumError", "RoundReport",
]

# Named fault sites — one per round phase (the ``fed.round.*`` family).
FED_COLLECT_SITE = "fed.round.collect"
FED_MERGE_SITE = "fed.round.merge"
FED_FIT_SITE = "fed.round.fit"
FED_BROADCAST_SITE = "fed.round.broadcast"

JOURNAL_NAME = "fed_round.journal"


class FederatedQuorumError(RuntimeError):
    """Raised when a round cannot gather ``quorum`` of the silos."""


@dataclass(frozen=True)
class FederatedConfig:
    """Coordinator knobs.

    ``quorum`` is the fraction of registered silos whose partials a
    round needs to commit; silos the breaker holds open or whose
    retries exhaust count as dropped for the round.  ``weights`` maps
    silo id → contribution weight (or the string ``"silo"`` to take
    each :attr:`Silo.weight`); any weighting forfeits pooled
    bit-parity, as does ``noise``."""

    quorum: float = 0.5
    max_rounds: int | None = None
    retry: RetryPolicy = field(
        default_factory=lambda: RetryPolicy(
            max_attempts=3, base_delay_s=0.01, max_delay_s=0.1
        )
    )
    breaker_threshold: int = 3
    breaker_recovery_s: float = 0.05
    weights: Mapping[str, float] | str | None = None
    noise: NoiseConfig | None = None
    journal_dir: str | None = None


@dataclass(frozen=True)
class RoundReport:
    round_id: int
    contributed: tuple[str, ...]
    dropped: tuple[str, ...]
    t_collect: float
    t_merge: float
    t_fit: float
    t_broadcast: float
    done: bool

    def to_payload(self) -> dict:
        return {
            "round_id": self.round_id,
            "contributed": list(self.contributed),
            "dropped": list(self.dropped),
            "t_collect": self.t_collect, "t_merge": self.t_merge,
            "t_fit": self.t_fit, "t_broadcast": self.t_broadcast,
            "done": self.done,
        }


@dataclass
class FederatedFitResult:
    model: Any
    rounds: list[RoundReport]
    state: FitState | None
    resumed_from_round: int | None = None


class FederatedCoordinator:
    """Drives federated rounds for one estimator over fixed silos; the
    updates and solves run on ``device`` (default the card)."""

    def __init__(
        self,
        estimator,
        silos: Sequence[Silo],
        config: FederatedConfig | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        if not silos:
            raise ValueError("need at least one silo")
        ids = [s.silo_id for s in silos]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate silo ids: {ids}")
        if not estimator.supports_partials():
            raise ValueError(
                f"{type(estimator).__name__} does not support the "
                "mergeable-partials protocol"
            )
        self.estimator = estimator
        # ascending id order everywhere — collects, folds, broadcasts
        self.silos = sorted(silos, key=lambda s: s.silo_id)
        self.config = config or FederatedConfig()
        self._breakers = {
            s.silo_id: CircuitBreaker(
                failure_threshold=self.config.breaker_threshold,
                recovery_timeout_s=self.config.breaker_recovery_s,
            )
            for s in self.silos
        }
        if self.config.journal_dir:
            os.makedirs(self.config.journal_dir, exist_ok=True)
            self._journal_path = os.path.join(
                self.config.journal_dir, JOURNAL_NAME
            )
        else:
            self._journal_path = None

    # ----------------------------------------------------------- journal
    def _journal(self, obj: dict) -> None:
        if self._journal_path is not None:
            append_line(self._journal_path, obj)

    def _signature(self, n_features: int) -> dict:
        return {
            "family": self.estimator.partials_family,
            "silos": [s.silo_id for s in self.silos],
            "n_features": int(n_features),
        }

    def _load_journal(self, n_features: int) -> dict:
        """Replay the round journal: returns the restored state, the
        pending (journaled but uncommitted) partials, and the terminal
        commit if the previous coordinator finished before crashing."""
        out = {
            "state": None, "pending": {}, "done": False, "converged": False,
            "merged": None, "resumed_from": None, "has_meta": False,
        }
        if self._journal_path is None or not os.path.exists(self._journal_path):
            return out
        sig = self._signature(n_features)
        for entry in read_lines(self._journal_path):
            kind = entry.get("kind")
            if kind == "meta":
                if entry["signature"] != sig:
                    raise ValueError(
                        "federated journal signature mismatch: journal "
                        f"has {entry['signature']}, coordinator has {sig}"
                    )
                out["has_meta"] = True
            elif kind == "init":
                out["state"] = FitState.from_payload(entry["state"])
            elif kind == "partial":
                p = Partials.from_payload(entry["part"])
                out["pending"][(p.state_version, p.silo_id)] = p
            elif kind in ("commit", "final"):
                out["state"] = FitState.from_payload(entry["state"])
                out["done"] = bool(entry["done"])
                out["converged"] = bool(entry.get("converged", entry["done"]))
                out["merged"] = entry.get("merged")
                out["resumed_from"] = int(entry["round"])
        return out

    # ----------------------------------------------------------- collect
    def _collect_round(
        self,
        state: FitState | None,
        round_id: int,
        pending: dict,
        final: bool = False,
        init: bool = False,
    ) -> tuple[dict[str, Partials], list[str]]:
        """Gather one round's partials from every silo not already in the
        journal, under the retry + breaker ladder.  Returns (parts by
        silo id, dropped silo ids)."""
        version = state.version if state is not None else -1
        parts: dict[str, Partials] = {}
        dropped: list[str] = []
        for silo in self.silos:
            sid = silo.silo_id
            journaled = pending.get((version, sid))
            if journaled is not None:
                # a crashed coordinator already banked this silo's work —
                # resume folds the journaled bytes, the silo is not
                # asked to recompute (pinned by compute_calls tests)
                parts[sid] = journaled
                continue
            breaker = self._breakers[sid]
            if not breaker.allow():
                dropped.append(sid)
                continue

            def attempt(silo=silo, sid=sid):
                fault_point(
                    FED_COLLECT_SITE, silo=sid, round=round_id,
                    final=final, init=init,
                )
                if init:
                    return silo.init_partials(self.estimator, round_id)
                return silo.compute_partials(
                    self.estimator, state, round_id, final=final,
                    noise=self.config.noise,
                )

            try:
                p = call_with_retry(attempt, self.config.retry)
            except Exception:
                # retries exhausted (InjectedCrash is a BaseException and
                # sails through) — the silo sits this round out and the
                # breaker decides when it may rejoin
                breaker.record_failure()
                dropped.append(sid)
                continue
            breaker.record_success()
            parts[sid] = p
            self._journal(
                {"kind": "partial", "round": round_id, "silo": sid,
                 "part": p.to_payload()}
            )
        return parts, dropped

    def _require_quorum(self, parts: dict, round_id: int) -> None:
        need = max(1, int(np.ceil(self.config.quorum * len(self.silos))))
        if len(parts) < need:
            raise FederatedQuorumError(
                f"round {round_id}: only {len(parts)}/{len(self.silos)} "
                f"silos contributed (quorum {need})"
            )

    def _merge_weights(self) -> Mapping[str, float] | None:
        w = self.config.weights
        if w == "silo":
            return {s.silo_id: s.weight for s in self.silos}
        return w

    # --------------------------------------------------------- broadcast
    def _broadcast(self, state: FitState | None, model, round_id: int) -> None:
        fault_point(FED_BROADCAST_SITE, round=round_id, n=len(self.silos))
        for silo in self.silos:
            if state is not None:
                silo.receive_state(state)
            if model is not None:
                silo.receive_model(model)

    # --------------------------------------------------------------- fit
    def fit(self, n_features: int | None = None) -> FederatedFitResult:
        est = self.estimator
        if n_features is None:
            n_features = self.silos[0].n_features
        journal = self._load_journal(n_features)
        if self._journal_path is not None and not journal["has_meta"]:
            self._journal(
                {"kind": "meta", "signature": self._signature(n_features)}
            )
        state = journal["state"]
        pending = journal["pending"]
        resumed_from = journal["resumed_from"]
        rounds: list[RoundReport] = []

        if journal["done"]:
            # previous coordinator finished the fit and crashed at (or
            # before) broadcast: rebuild the model from journaled bytes
            # and re-broadcast — no silo recomputes anything
            merged = (
                Partials.from_payload(journal["merged"])
                if journal["merged"] is not None
                else None
            )
            model = est.fit_from_partials(merged, state=state, device=self.device)
            self._broadcast(state, model, resumed_from or 0)
            return FederatedFitResult(
                model=model, rounds=rounds, state=state,
                resumed_from_round=resumed_from,
            )

        if state is None:
            state = est.init_partials_state(n_features, mesh=None)
        if state is None and self._needs_data_init():
            state = self._federated_init(pending)

        if state is None:
            model, state = self._fit_stateless(pending, rounds)
        else:
            model, state = self._fit_rounds(
                state, pending, rounds, converged=journal["converged"]
            )
        return FederatedFitResult(
            model=model, rounds=rounds, state=state,
            resumed_from_round=resumed_from,
        )

    # ------------------------------------------------------------- init
    def _needs_data_init(self) -> bool:
        from ..models.base import Estimator

        return type(self.estimator).local_init_stats is not Estimator.local_init_stats

    def _federated_init(self, pending: dict) -> FitState:
        """Round -1: concat-merge per-silo init candidates and seed the
        shared starting parameters from the pooled candidate set."""
        with span("fed.round", {"round": -1, "phase": "init"}):
            parts, _ = self._collect_round(None, -1, pending, init=True)
            self._require_quorum(parts, -1)
            fault_point(FED_MERGE_SITE, round=-1, n=len(parts))
            merged = merge_partials(list(parts.values()))
            fault_point(FED_FIT_SITE, round=-1)
            state = self.estimator.init_state_from_merged(merged)
            self._journal({"kind": "init", "state": state.to_payload()})
        return state

    # -------------------------------------------------------- stateless
    def _fit_stateless(self, pending: dict, rounds: list) -> tuple:
        """One-shot families (linear/RLS): accumulate partials across
        attempt rounds until every silo has contributed (or quorum after
        ``max_rounds``).  Late partials fold in exactly — the ascending
        zero-init merge is arrival-order independent."""
        est = self.estimator
        cfg = self.config
        collected: dict[str, Partials] = {
            sid: p for (ver, sid), p in pending.items() if ver == -1
        }
        max_attempts = cfg.max_rounds if cfg.max_rounds is not None else 3
        attempt = 0
        while True:
            t0 = time.perf_counter()
            with span("fed.round", {"round": attempt, "family": est.partials_family}):
                parts, dropped = self._collect_round(
                    None, attempt,
                    {(-1, sid): p for sid, p in collected.items()},
                )
                collected.update(parts)
                t1 = time.perf_counter()
                complete = len(collected) == len(self.silos)
                last = attempt + 1 >= max_attempts
                if not complete and not last:
                    rounds.append(RoundReport(
                        round_id=attempt,
                        contributed=tuple(sorted(parts)),
                        dropped=tuple(dropped),
                        t_collect=t1 - t0, t_merge=0.0, t_fit=0.0,
                        t_broadcast=0.0, done=False,
                    ))
                    attempt += 1
                    time.sleep(cfg.breaker_recovery_s)
                    continue
                self._require_quorum(collected, attempt)
                fault_point(FED_MERGE_SITE, round=attempt, n=len(collected))
                merged = merge_partials(
                    list(collected.values()), self._merge_weights()
                )
                t2 = time.perf_counter()
                fault_point(FED_FIT_SITE, round=attempt)
                model = est.fit_from_partials(merged, device=self.device)
                t3 = time.perf_counter()
                report = RoundReport(
                    round_id=attempt, contributed=tuple(sorted(collected)),
                    dropped=tuple(dropped), t_collect=t1 - t0,
                    t_merge=t2 - t1, t_fit=t3 - t2, t_broadcast=0.0,
                    done=True,
                )
                self._journal({
                    "kind": "commit", "round": attempt,
                    "state": FitState(
                        family=est.partials_family, version=-1
                    ).to_payload(),
                    "done": True, "merged": merged.to_payload(),
                    "report": report.to_payload(),
                })
                tb = time.perf_counter()
                self._broadcast(None, model, attempt)
                rounds.append(replace(
                    report, t_broadcast=time.perf_counter() - tb
                ))
            return model, None

    # -------------------------------------------------------- iterative
    def _fit_rounds(
        self,
        state: FitState,
        pending: dict,
        rounds: list,
        converged: bool = False,
    ) -> tuple:
        """Iterative families (k-means, GMM): rounds of collect → merge →
        apply until the family's own convergence test (mirrored on the
        host, bit-for-bit) says done.  ``converged`` resumes a crash that
        landed between convergence and the final exact collect."""
        est = self.estimator
        merged = None
        done = converged
        while not done:
            r = state.version
            t0 = time.perf_counter()
            with span("fed.round", {"round": r, "family": est.partials_family}):
                parts, dropped = self._collect_round(state, r, pending)
                self._require_quorum(parts, r)
                t1 = time.perf_counter()
                fault_point(FED_MERGE_SITE, round=r, n=len(parts))
                merged = merge_partials(
                    list(parts.values()), self._merge_weights()
                )
                t2 = time.perf_counter()
                fault_point(FED_FIT_SITE, round=r)
                state, done = est.apply_partials(state, merged, device=self.device)
                t3 = time.perf_counter()
                report = RoundReport(
                    round_id=r, contributed=tuple(sorted(parts)),
                    dropped=tuple(dropped), t_collect=t1 - t0,
                    t_merge=t2 - t1, t_fit=t3 - t2, t_broadcast=0.0,
                    done=done and not est.partials_final_collect(),
                )
                self._journal({
                    "kind": "commit", "round": r,
                    "state": state.to_payload(),
                    "done": done and not est.partials_final_collect(),
                    "converged": done,
                    "merged": merged.to_payload(),
                    "report": report.to_payload(),
                })
                tb = time.perf_counter()
                self._broadcast(state, None, r)
                rounds.append(replace(
                    report, t_broadcast=time.perf_counter() - tb
                ))

        if est.partials_final_collect():
            # one exact-precision pass against the converged parameters so
            # the model's cost/sizes describe the centers it returns
            r = state.version
            t0 = time.perf_counter()
            with span("fed.round", {"round": r, "family": est.partials_family,
                                    "phase": "final"}):
                parts, dropped = self._collect_round(
                    state, r, pending, final=True
                )
                self._require_quorum(parts, r)
                t1 = time.perf_counter()
                fault_point(FED_MERGE_SITE, round=r, n=len(parts), final=True)
                merged = merge_partials(
                    list(parts.values()), self._merge_weights()
                )
                t2 = time.perf_counter()
                fault_point(FED_FIT_SITE, round=r, final=True)
                model = est.fit_from_partials(merged, state=state, device=self.device)
                t3 = time.perf_counter()
                report = RoundReport(
                    round_id=r, contributed=tuple(sorted(parts)),
                    dropped=tuple(dropped), t_collect=t1 - t0,
                    t_merge=t2 - t1, t_fit=t3 - t2, t_broadcast=0.0,
                    done=True,
                )
                self._journal({
                    "kind": "final", "round": r,
                    "state": state.to_payload(), "done": True,
                    "merged": merged.to_payload(),
                    "report": report.to_payload(),
                })
                tb = time.perf_counter()
                self._broadcast(state, model, r)
                rounds.append(replace(
                    report, t_broadcast=time.perf_counter() - tb
                ))
        else:
            # the converged round's commit already journaled done=True
            # with its merged bytes — just materialize + hand out the model
            model = est.fit_from_partials(merged, state=state, device=self.device)
            self._broadcast(state, model, state.version)
        return model, state

    # ---------------------------------------------------------- profile
    def merged_profile(
        self, names: Sequence[str] | None = None, bins: int = 32
    ):
        """Network-wide :class:`~..quality.sketches.DataProfile` without
        pooling rows.  Two-phase because sketch merges require identical
        bin edges: the lowest silo id supplies the reference edges, the
        rest fold their rows into like-shaped empty sketches."""
        from ..quality.sketches import DataProfile

        first, rest = self.silos[0], self.silos[1:]
        ref_part = first.profile_partials(names=names, bins=bins)
        reference = DataProfile.from_dict(ref_part.payload)
        parts = [ref_part]
        for silo in rest:
            parts.append(silo.profile_partials(reference=reference))
        merged = merge_partials(parts)
        return DataProfile.from_dict(merged.payload)
