"""Live drift monitoring + serving-input guards.

The serve/stream half of the sketch story (``sketches.py``): a
:class:`DriftMonitor` holds the *reference* :class:`DataProfile` frozen
into the model artifact at train time, accumulates the traffic actually
observed into a live profile with the same bin edges, and scores a PSI
per feature every ``window_rows`` rows.  ``trip_after`` consecutive hot
windows (max PSI above ``threshold``) is *sustained* drift — the signal
the :class:`~..serve.breaker.CircuitBreaker` consumes via ``trip()`` so
a drifting feed degrades to fallback answers instead of silently
mis-predicting on a distribution the model never saw.

Small windows are noisy: under NO drift, PSI of an n-row sample against
a B-bin reference has expectation ≈ (B−1)/n (it is a chi-square-like
statistic).  The monitor therefore compares each window's max PSI
against ``threshold + (B−1)/n`` — the *noise floor* — so a 16-row
window doesn't cry wolf while a genuine unit shift (PSI in the tens)
still trips immediately.

:class:`InputGuard` is the row-level bouncer in front of the same door:
non-finite or wildly out-of-reference-range values are either imputed
with the reference mean and flagged (policy ``"impute"``) or the request
is refused outright (policy ``"reject"``) — per model, chosen at
registration.
"""

from __future__ import annotations

import threading

import numpy as np

from .sketches import DataProfile, PSI_DRIFT

POLICY_IMPUTE = "impute"
POLICY_REJECT = "reject"


class DriftMonitor:
    """Windowed PSI of live traffic against a training-time reference."""

    def __init__(
        self,
        reference: DataProfile,
        threshold: float = PSI_DRIFT,
        window_rows: int = 512,
        trip_after: int = 3,
    ):
        if window_rows < 1:
            raise ValueError("window_rows must be >= 1")
        if trip_after < 1:
            raise ValueError("trip_after must be >= 1")
        self.reference = reference
        self.threshold = threshold
        self.window_rows = window_rows
        self.trip_after = trip_after
        self._live = DataProfile.like(reference)
        self._window_seen = 0
        self._lock = threading.Lock()
        self._scores: dict[str, float] = {}
        self._noise_floor = 0.0     # (B−1)/n of the last closed window
        self._windows = 0
        self._hot_windows = 0       # consecutive windows above threshold
        self._trip_pending = False  # a hot window closed since last signal
        self.trips = 0              # lifetime trip signals emitted
        self.rebases = 0            # lifetime reference swaps (promotions)

    # ------------------------------------------------------------ observe
    def observe(self, x: np.ndarray) -> None:
        """Fold a (n, d) batch of live feature rows in (columns in the
        reference profile's order); closes a window when enough rows
        accumulated."""
        x = np.asarray(x, dtype=np.float64)
        if x.ndim == 1:
            x = x[None, :]
        with self._lock:
            self._live.update_matrix(x)
            self._window_seen += x.shape[0]
            if self._window_seen < self.window_rows:
                return
            self._scores = self.reference.psi_against(self._live)
            self._windows += 1
            bins = max(
                (s.counts.size for s in self.reference.sketches.values()),
                default=2,
            )
            self._noise_floor = (bins - 1) / max(1, self._window_seen)
            if max(self._scores.values(), default=0.0) > self._hot_bar():
                self._hot_windows += 1
                if self._hot_windows >= self.trip_after:
                    # one signal per hot window while drift is sustained:
                    # each trip restarts the breaker's recovery clock, so
                    # the model stays degraded until the feed recovers
                    self._trip_pending = True
            else:
                self._hot_windows = 0
                self._trip_pending = False  # recovered
            self._live = DataProfile.like(self.reference)
            self._window_seen = 0

    def rebase(self, reference: DataProfile) -> None:
        """Swap the PSI reference — the promotion half of the continuous
        learning loop.  A promoted candidate was *trained on* the drifted
        distribution, so the traffic that tripped this monitor is exactly
        what the new model expects; scoring it against the old training
        profile would re-trip the breaker forever.  The caller must make
        this atomic with the registry flip (``InferenceServer.swap_model``
        holds one lock around both) so no window closes against the stale
        reference after the new model starts answering.

        Resets the open window, scores, and the hot-window/trip state:
        drift is measured against the NEW reference from row zero."""
        with self._lock:
            self.reference = reference
            self._live = DataProfile.like(reference)
            self._window_seen = 0
            self._scores = {}
            self._noise_floor = 0.0
            self._hot_windows = 0
            self._trip_pending = False
            self.rebases += 1

    def _hot_bar(self) -> float:
        """Drift bar for the last window: threshold + small-sample noise."""
        return self.threshold + self._noise_floor

    def should_trip(self) -> bool:
        """True once per *hot window* past ``trip_after`` — the caller
        forwards it to the model's circuit breaker, whose recovery clock
        restarts on every trip, so sustained drift keeps the model
        degraded and a recovered feed lets the breaker's normal
        half-open probe close it."""
        with self._lock:
            if self._trip_pending:
                self._trip_pending = False
                self.trips += 1
                return True
            return False

    # ------------------------------------------------------------ observe
    @property
    def max_psi(self) -> float:
        with self._lock:
            return max(self._scores.values(), default=0.0)

    @property
    def drifting(self) -> bool:
        with self._lock:
            return (
                max(self._scores.values(), default=0.0) > self._hot_bar()
            )

    def scores(self) -> dict[str, float]:
        with self._lock:
            return dict(self._scores)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "psi": {k: round(v, 4) for k, v in self._scores.items()},
                "max_psi": round(
                    max(self._scores.values(), default=0.0), 4
                ),
                "threshold": self.threshold,
                "noise_floor": round(self._noise_floor, 4),
                "drifting": max(self._scores.values(), default=0.0)
                > self._hot_bar(),
                "windows": self._windows,
                "hot_windows": self._hot_windows,
                "trips": self.trips,
                "rebases": self.rebases,
            }


class InputGuard:
    """Non-finite / out-of-reference-range guard for serving inputs.

    Bounds come from the reference profile: each feature admits
    ``[min − margin·span, max + margin·span]`` (span = max − min, so a
    value must be *wildly* outside training experience to flag).  Without
    a profile only non-finite values flag.
    """

    def __init__(
        self,
        profile: DataProfile | None = None,
        policy: str = POLICY_IMPUTE,
        margin: float = 1.0,
    ):
        if policy not in (POLICY_IMPUTE, POLICY_REJECT):
            raise ValueError(
                f"policy must be {POLICY_IMPUTE!r} or {POLICY_REJECT!r}, "
                f"got {policy!r}"
            )
        self.policy = policy
        self.names: tuple[str, ...] = ()
        self._lo = self._hi = self._fill = None
        if profile is not None:
            self.names = profile.names
            lo, hi, fill = [], [], []
            for n in profile.names:
                s = profile.sketches[n]
                mn = s.min if np.isfinite(s.min) else 0.0
                mx = s.max if np.isfinite(s.max) else 0.0
                # a constant (or near-constant) training column says
                # nothing about tolerable live variation — floor the span
                # at half the value's own scale (mirrors the ±0.5 edge
                # widening sketches.py applies to constant columns) so an
                # epsilon deviation is not flagged
                span = max(
                    mx - mn, 0.5 * max(abs(mx), abs(mn), 1.0)
                )
                lo.append(mn - margin * span)
                hi.append(mx + margin * span)
                fill.append(s.mean if s.count > 0 else 0.0)
            self._lo = np.asarray(lo)
            self._hi = np.asarray(hi)
            self._fill = np.asarray(fill)

    def _name(self, j: int) -> str:
        return self.names[j] if j < len(self.names) else f"f{j}"

    def inspect(self, x: np.ndarray) -> tuple[np.ndarray, int, list[str]]:
        """→ (guarded batch, number of flagged cells, reasons).

        ``impute`` policy returns a repaired copy; ``reject`` policy
        returns the input untouched — the caller refuses the request when
        the flag count is non-zero."""
        x = np.asarray(x, dtype=np.float64)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None, :]
        nonfinite = ~np.isfinite(x)
        ranged = np.zeros_like(nonfinite)
        if self._lo is not None and x.shape[1] == self._lo.size:
            with np.errstate(invalid="ignore"):
                ranged = (x < self._lo[None, :]) | (x > self._hi[None, :])
            ranged &= ~nonfinite  # ±Inf is non-finite first, not "ranged"
        bad = nonfinite | ranged
        n_bad = int(bad.sum())
        if n_bad == 0:
            return (x[0] if squeeze else x), 0, []
        # same reason vocabulary as quality.validators
        reasons = [
            f"non_finite:{self._name(int(j))}"
            for j in np.flatnonzero(nonfinite.any(axis=0))
        ] + [
            f"out_of_range:{self._name(int(j))}"
            for j in np.flatnonzero(ranged.any(axis=0))
        ]
        if self.policy == POLICY_IMPUTE:
            fill = (
                self._fill
                if self._fill is not None and x.shape[1] == self._fill.size
                else np.zeros(x.shape[1])
            )
            x = np.where(bad, fill[None, :], x)
        return (x[0] if squeeze else x), n_bad, reasons
