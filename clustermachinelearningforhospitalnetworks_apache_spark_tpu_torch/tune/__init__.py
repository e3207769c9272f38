"""``tune/`` — the measurement-driven autotuner (the JAX package's
``tune/``, host code: JSON and Python, no device).

One subsystem owns every hand-set performance knob:

* :mod:`.knobs` — the registry: every tunable declares name, domain,
  default, and the metric that scores it; call sites resolve through
  :func:`knob` instead of carrying literals.
* :mod:`.store` — durable trials keyed by (platform, knob,
  config-fingerprint, shape-bucket), committed under the
  ``tune.store.commit`` fault site with content-hash exactly-once merge.
* :mod:`.select` — the interpolating cost model: defaults when coverage
  is thin, never selects inside a fenced A/B, every decision explained
  by a reason constant.
* :mod:`.live` — one serving knob retuned from observed load through a
  journaled intent/commit protocol (``tune.select.apply`` kill seam).
"""

from .knobs import REGISTRY, Knob, KnobRegistry, default, knob
from .live import LiveRetuner
from .select import (
    REASON_DEFAULT_NO_TRIALS, REASON_FROZEN_FENCED, REASON_TUNED_PREFIX,
    Selector, ab_fence, active, clear, fence_active, install, installed,
)
from .store import TrialStore, make_trial, shape_bucket, trial_id

__all__ = [
    "REGISTRY",
    "Knob",
    "KnobRegistry",
    "knob",
    "default",
    "TrialStore",
    "make_trial",
    "shape_bucket",
    "trial_id",
    "Selector",
    "ab_fence",
    "fence_active",
    "install",
    "installed",
    "active",
    "clear",
    "LiveRetuner",
    "REASON_DEFAULT_NO_TRIALS",
    "REASON_FROZEN_FENCED",
    "REASON_TUNED_PREFIX",
]
