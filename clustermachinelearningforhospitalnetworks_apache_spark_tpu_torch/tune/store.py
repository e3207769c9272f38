"""Durable trial store: every measurement the selector reasons over.

A **trial** is one scored observation of one knob value:

    {trial_id, knob, value, platform, fingerprint, shape_bucket,
     metric, score, reps, source, meta}

keyed by ``(platform, knob, config-fingerprint, shape-bucket)``.  Trials
come from offline sweeps (each candidate timed on a workload) and from
live serving (``tune/live.py`` records the observed rate at the value
currently deployed).

Durability is tmp → fsync → ``os.replace`` → directory fsync, under the
fault site ``tune.store.commit``.  ``trial_id`` is a content hash of the
trial's identity fields, so re-adding a replayed trial after a killed
commit is a no-op merge: the store is exactly-once.  The document, its
key order and the hash are the JAX package's, so a store written by
either package is read by the other.
"""

from __future__ import annotations

import hashlib
import json
import os

from ..io.fit_checkpoint import fsync_dir
from ..obs.trace import span
from ..utils.faults import fault_point

SCHEMA_VERSION = 1

#: identity fields hashed into ``trial_id`` — two trials that agree on
#: all of these are the same observation and merge to one row
_ID_FIELDS = (
    "knob", "value", "platform", "fingerprint", "shape_bucket",
    "metric", "score", "reps", "source",
)


def shape_bucket(rows: int) -> int:
    """Power-of-two workload-size bucket (min 1) — the shape key trials
    are stored and interpolated under."""
    n, b = max(int(rows), 1), 1
    while b < n:
        b <<= 1
    return b


def trial_id(trial: dict) -> str:
    """Deterministic content hash of the trial's identity fields."""
    key = json.dumps(
        [trial.get(f) for f in _ID_FIELDS], sort_keys=True,
        separators=(",", ":"),
    )
    return hashlib.sha256(key.encode()).hexdigest()[:16]


def make_trial(
    *,
    knob: str,
    value,
    score: float,
    platform: str = "cpu",
    fingerprint: str = "default",
    shape_rows: int = 1,
    metric: str = "",
    reps: int = 1,
    source: str = "sweep",
    meta: dict | None = None,
) -> dict:
    """Normalize one observation into a keyed, content-addressed trial."""
    t = {
        "knob": str(knob),
        "value": value,
        "platform": str(platform),
        "fingerprint": str(fingerprint),
        "shape_bucket": shape_bucket(shape_rows),
        "metric": str(metric),
        "score": float(score),
        "reps": int(reps),
        "source": str(source),
        "meta": dict(meta or {}),
    }
    t["trial_id"] = trial_id(t)
    return t


class TrialStore:
    """The persisted trial set, merged by ``trial_id``.

    One JSON document (not a log): small — hundreds of trials, not
    millions — and rewritten atomically per commit, so a reader never
    sees a half-merged state and a killed commit leaves either the old
    file or the new one, never a torn mix.
    """

    def __init__(self, path: str):
        self.path = str(path)
        self._trials: dict[str, dict] = {}
        self._load()

    # ------------------------------------------------------------- read
    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path) as f:
            doc = json.load(f)
        for t in doc.get("trials", []):
            tid = t.get("trial_id")
            if tid:
                self._trials[tid] = t

    def __len__(self) -> int:
        return len(self._trials)

    def trials(
        self,
        *,
        knob: str | None = None,
        platform: str | None = None,
        fingerprint: str | None = None,
    ) -> list[dict]:
        """Trials filtered on the store key, sorted for determinism."""
        out = [
            t for t in self._trials.values()
            if (knob is None or t["knob"] == knob)
            and (platform is None or t["platform"] == platform)
            and (fingerprint is None or t["fingerprint"] == fingerprint)
        ]
        out.sort(key=lambda t: (
            t["knob"], t["shape_bucket"], repr(t["value"]), t["trial_id"],
        ))
        return out

    # ------------------------------------------------------------ write
    def add(self, trials: list[dict]) -> int:
        """Merge trials by content hash and durably commit.

        Returns how many were new.  Replaying the same ``add`` after a
        killed commit merges to the identical document — exactly-once.
        """
        fresh = 0
        for t in trials:
            tid = t.get("trial_id") or trial_id(t)
            t = dict(t, trial_id=tid)
            if tid not in self._trials:
                fresh += 1
            self._trials[tid] = t
        self._commit()
        return fresh

    def _commit(self) -> None:
        doc = {
            "version": SCHEMA_VERSION,
            "trials": [self._trials[k] for k in sorted(self._trials)],
        }
        payload = json.dumps(doc, sort_keys=True, indent=1).encode()
        with span("tune.store", {"trials": len(self._trials)}):
            # the kill lands BEFORE the tmp exists: a crashed commit
            # leaves no litter, only the previous committed document
            fault_point("tune.store.commit", path=self.path)
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            fsync_dir(os.path.dirname(os.path.abspath(self.path)))
