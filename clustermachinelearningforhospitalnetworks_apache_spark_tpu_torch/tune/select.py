"""The selector: a cheap interpolating cost model over stored trials.

Flare's discipline (arxiv 1703.08219), applied to knobs: **decide ahead
of the hot path, never during it**.  A :class:`Selector` resolves a
knob to a value once — at construction time of whatever consumes it —
by ranking the store's trials for that ``(platform, knob, fingerprint)``
key at the requested shape bucket.  Scores at absent buckets are
linearly interpolated in log2(bucket) between the nearest measured
buckets (the Spark-ML perf-study shape: model the cost from
measurements, then pick the configuration — arxiv 1612.01437).

Three outcomes, and only three, each named by a reason constant so
every selection is explainable after the fact:

* :data:`REASON_DEFAULT_NO_TRIALS` — coverage is thin (fewer than two
  distinct candidate values measured for the key): the declared default
  wins.  An autotuner with one data point has no gradient; guessing
  would be worse than the hand-set constant.
* ``tuned:<trial-id>`` (:data:`REASON_TUNED_PREFIX`) — the best
  measured value, tagged with the id of the winning trial so the
  decision is auditable back to the measurement that made it.
* :data:`REASON_FROZEN_FENCED` — a fenced A/B is in flight.  The fence
  is **queried, not hoped for**: timed A/B legs run inside
  :func:`ab_fence`, and any resolve during the fence returns the value
  already in effect (last selection, else default) without consulting
  trials — otherwise the autotuner would contaminate the very
  measurement meant to feed it.

``explain()`` returns the last decision per knob: value, reason, trials
considered, shape bucket.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from math import log2
from typing import Iterator

from . import knobs as _knobs
from .knobs import Knob
from .store import TrialStore, shape_bucket

REASON_DEFAULT_NO_TRIALS = "default:no-trials"
REASON_FROZEN_FENCED = "frozen:fenced-ab"
REASON_TUNED_PREFIX = "tuned:"

# --------------------------------------------------------------- the fence
# One process-global nested counter: timed A/B legs (and anything else
# whose timing must not be perturbed mid-measurement) hold it while a
# leg runs.  Nested fences stack; the selector asks `fence_active()`
# on EVERY resolve.
_FENCE_LOCK = threading.Lock()
_FENCE_DEPTH = 0


@contextmanager
def ab_fence() -> Iterator[None]:
    """Mark a fenced A/B region: no selection happens inside."""
    global _FENCE_DEPTH
    with _FENCE_LOCK:
        _FENCE_DEPTH += 1
    try:
        yield
    finally:
        with _FENCE_LOCK:
            _FENCE_DEPTH -= 1


def fence_active() -> bool:
    return _FENCE_DEPTH > 0


# ------------------------------------------------------------- the selector
class Selector:
    """Trial-backed knob resolution for one (platform, fingerprint)."""

    def __init__(
        self,
        store: TrialStore,
        *,
        platform: str = "cpu",
        fingerprint: str = "default",
        min_distinct_values: int = 2,
    ):
        self.store = store
        self.platform = str(platform)
        self.fingerprint = str(fingerprint)
        self.min_distinct_values = int(min_distinct_values)
        self._lock = threading.Lock()
        self._last: dict[str, dict] = {}   # knob -> last decision record

    # ------------------------------------------------------------ model
    def _score_at(self, by_bucket: dict[int, float], bucket: int) -> float:
        """Score of one candidate value at ``bucket``: exact if
        measured, else linear in log2(bucket) between the nearest
        measured buckets (clamped at the ends)."""
        if bucket in by_bucket:
            return by_bucket[bucket]
        marks = sorted(by_bucket)
        lo = [b for b in marks if b < bucket]
        hi = [b for b in marks if b > bucket]
        if not lo:
            return by_bucket[hi[0]]
        if not hi:
            return by_bucket[lo[-1]]
        b0, b1 = lo[-1], hi[0]
        w = (log2(bucket) - log2(b0)) / (log2(b1) - log2(b0))
        return by_bucket[b0] * (1.0 - w) + by_bucket[b1] * w

    def _rank(self, knob: Knob, bucket: int):
        """Best (value, winning-trial-id, n-trials) for the key, or
        ``None`` when coverage is thin."""
        trials = self.store.trials(
            knob=knob.name, platform=self.platform,
            fingerprint=self.fingerprint,
        )
        per_value: dict = {}
        for t in trials:
            per_value.setdefault(repr(t["value"]), []).append(t)
        if len(per_value) < self.min_distinct_values:
            return None, None, len(trials)
        sign = 1.0 if knob.mode == "max" else -1.0
        best = None
        for group in per_value.values():
            by_bucket: dict[int, float] = {}
            for t in group:
                b = int(t["shape_bucket"])
                # several reps at one bucket: keep the best leg, the
                # same best-of-N discipline a timed sweep applies
                s = float(t["score"])
                if b not in by_bucket or sign * s > sign * by_bucket[b]:
                    by_bucket[b] = s
            score = sign * self._score_at(by_bucket, bucket)
            nearest = min(group, key=lambda t: (
                abs(log2(max(int(t["shape_bucket"]), 1)) - log2(bucket)),
                t["trial_id"],
            ))
            cand = (score, repr(group[0]["value"]))
            if best is None or cand > best[0]:
                best = (cand, group[0]["value"], nearest["trial_id"])
        _, value, tid = best
        return value, tid, len(trials)

    # ---------------------------------------------------------- resolve
    def resolve(self, knob: Knob, shape: int | None = None):
        """The :func:`tune.knob` hook — fence first, trials second,
        default last; every path records an explainable decision."""
        bucket = shape_bucket(shape if shape is not None else 1)
        with self._lock:
            if fence_active():
                prev = self._last.get(knob.name)
                value = prev["value"] if prev else knob.default
                self._note(knob.name, value, REASON_FROZEN_FENCED, 0, bucket)
                return value
            value, tid, n = self._rank(knob, bucket)
            if tid is None:
                self._note(
                    knob.name, knob.default, REASON_DEFAULT_NO_TRIALS,
                    n, bucket,
                )
                return knob.default
            self._note(
                knob.name, value, REASON_TUNED_PREFIX + tid, n, bucket,
            )
            return value

    def _note(self, name, value, reason, n_trials, bucket) -> None:
        self._last[name] = {
            "value": value, "reason": reason,
            "trials_considered": int(n_trials), "shape_bucket": int(bucket),
        }

    def explain(self, name: str | None = None) -> dict:
        """Last decision per knob (or one knob): ``{value, reason,
        trials_considered, shape_bucket}``."""
        with self._lock:
            if name is not None:
                return dict(self._last.get(name, {}))
            return {k: dict(v) for k, v in self._last.items()}


# ------------------------------------------------------------ installation
_SELECTOR: Selector | None = None


def install(selector: Selector) -> Selector:
    """Route every :func:`tune.knob` lookup through ``selector``."""
    global _SELECTOR
    _SELECTOR = selector
    _knobs.set_resolver(selector.resolve)
    return selector


def clear() -> None:
    global _SELECTOR
    _SELECTOR = None
    _knobs.set_resolver(None)


def installed() -> Selector | None:
    return _SELECTOR


@contextmanager
def active(selector: Selector) -> Iterator[Selector]:
    """``with tune.active(Selector(store)): ...`` — installed for the
    block, uninstalled (back to declared defaults) on exit."""
    install(selector)
    try:
        yield selector
    finally:
        clear()
