"""Shadow scoring, parity gating, and canary routing — the promotion gate.

A retrained candidate earns production in two stages, both measured on
LIVE traffic rather than a held-out file:

1. **Shadow** — the candidate scores every request the primary answers
   (same rows, its answer discarded), and a :class:`ShadowScorer`
   accumulates divergence.  When enough rows have been shadowed, the
   :class:`ParityGate` compares the two models' evaluation metric on the
   recent-traffic window: a candidate that is *worse than the serving
   model on the traffic it would inherit* is refused no matter how it
   looked in training.
2. **Canary** — a :class:`CanaryRouter` sends a deterministic fraction of
   requests to the candidate for real (responses tagged
   ``STATUS_CANARY``), and the same gate re-checks on the canary window
   before the registry flip.  Regression at this stage rolls back; the
   primary never stopped serving the other ``1 − fraction`` of traffic.

All three pieces are pure host-side state under locks — unit-testable
without a device, same stance as ``serve/breaker.py``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np


class ShadowScorer:
    """Accumulates primary-vs-candidate divergence over shadowed rows."""

    def __init__(self):
        self._lock = threading.Lock()
        self.rows = 0
        self._sum_abs = 0.0
        self._max_abs = 0.0
        self._disagree = 0

    def observe(self, primary, candidate) -> None:
        p = np.asarray(primary, dtype=np.float64).ravel()
        c = np.asarray(candidate, dtype=np.float64).ravel()
        if p.shape != c.shape:
            raise ValueError(
                f"shadow shapes diverge: primary {p.shape}, candidate {c.shape}"
            )
        diff = np.abs(p - c)
        with self._lock:
            self.rows += int(p.size)
            self._sum_abs += float(diff.sum())
            if diff.size:
                self._max_abs = max(self._max_abs, float(diff.max()))
            self._disagree += int(np.count_nonzero(p != c))

    def snapshot(self) -> dict:
        with self._lock:
            n = max(self.rows, 1)
            return {
                "rows": self.rows,
                "mean_abs_diff": round(self._sum_abs / n, 6),
                "max_abs_diff": round(self._max_abs, 6),
                # exact-match disagreement — for classifiers/clusterers
                # this is the fraction of rows the two models label apart
                "disagreement_rate": round(self._disagree / n, 6),
            }


@dataclass
class GateDecision:
    passed: bool
    reasons: list[str]
    stats: dict

    def __bool__(self) -> bool:
        return self.passed


@dataclass
class ParityGate:
    """Candidate-vs-primary evaluation parity on a traffic window.

    Metrics are *lower-is-better* (clustering cost, RMSE, log-loss).
    The candidate passes when its metric is within ``max_ratio`` of the
    primary's on the SAME rows — drifted traffic usually makes the
    candidate strictly better, but the gate only demands it not be
    materially worse (a deliberately degraded candidate fails loudly).
    """

    max_ratio: float = 1.05
    #: metric floor: below this, both models are effectively perfect and
    #: ratio noise must not flunk a fine candidate
    atol: float = 1e-9

    def decide(
        self, primary_metric: float, candidate_metric: float,
        shadow: dict | None = None,
    ) -> GateDecision:
        reasons: list[str] = []
        if not np.isfinite(candidate_metric):
            reasons.append(f"candidate metric is {candidate_metric}")
        elif candidate_metric > self.atol and (
            candidate_metric > primary_metric * self.max_ratio + self.atol
        ):
            reasons.append(
                f"candidate metric {candidate_metric:.6g} exceeds "
                f"{self.max_ratio}x primary {primary_metric:.6g}"
            )
        return GateDecision(
            passed=not reasons,
            reasons=reasons,
            stats={
                "primary_metric": float(primary_metric),
                "candidate_metric": float(candidate_metric),
                "max_ratio": self.max_ratio,
                **({"shadow": dict(shadow)} if shadow else {}),
            },
        )


@dataclass
class CanaryRouter:
    """Deterministic traffic split: every ``round(1/fraction)``-th request
    routes to the candidate.  Counter-based (not random) so tests and
    replays see the identical split."""

    fraction: float = 0.125

    def __post_init__(self):
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(
                f"canary fraction must be in (0, 1], got {self.fraction}"
            )
        self._stride = max(1, round(1.0 / self.fraction))
        self._lock = threading.Lock()
        self._seen = 0
        self.routed = 0

    def take(self) -> bool:
        """True when THIS request goes to the candidate."""
        with self._lock:
            self._seen += 1
            if self._seen % self._stride == 0:
                self.routed += 1
                return True
            return False

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "fraction": self.fraction,
                "stride": self._stride,
                "requests_seen": self._seen,
                "routed_to_candidate": self.routed,
            }
