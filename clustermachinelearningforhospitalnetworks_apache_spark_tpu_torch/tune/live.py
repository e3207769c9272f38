"""Live retuning: one serving knob re-decided from observed fleet load.

Offline sweeps measure candidates under a synthetic workload; the
fleet's *actual* load is the ground truth.  A :class:`LiveRetuner` closes
that loop for one knob (the micro-batch deadline or an SLO queue
threshold):

1. **observe** — the caller reports the rate the fleet is seeing at the
   currently-deployed value (pulled from the obs registry's stage
   timings or the soak probe); the observation lands in the trial store
   as a ``source="live"`` trial.
2. **select** — the fence-aware :class:`~.select.Selector` re-ranks.
   Inside a fenced A/B nothing moves (``frozen:fenced-ab``).
3. **apply** — if the winner differs from the deployed value, the
   change goes through a write-ahead protocol on the retune journal::

       append {kind: "intent", ...}      # durable: what we are about to do
       fault_point("tune.select.apply")  # the chaos kill seam
       apply_fn(value)                   # the existing atomic swap path
       append {kind: "commit", ...}      # durable: it is now in effect

   ``apply_fn`` is the *existing* atomic application path of the knob —
   a single attribute store on the micro-batcher (its worker reads
   ``max_wait_s`` fresh each iteration) or an admission-class dict-entry
   swap — never a new mutation protocol.

Crash story: a kill at
``tune.select.apply`` leaves an intent with no commit — :meth:`resume`
ignores it, so the previous value keeps serving; a kill after apply but
before commit dies with the process, and the restart resumes the last
*committed* value — again the previous one.  A committed retune is
re-applied by :meth:`resume` on restart, so the tuned value survives.
"""

from __future__ import annotations

from typing import Callable

from ..obs.trace import span
from ..utils.faults import fault_point
from .knobs import REGISTRY, Knob
from .select import Selector
from .store import make_trial


class LiveRetuner:
    """Observe → select → journal → apply, for one registered knob."""

    def __init__(
        self,
        knob_name: str,
        *,
        journal_path: str,
        apply_fn: Callable,
        selector: Selector,
        convert: Callable | None = None,
    ):
        self.knob: Knob = REGISTRY.get(knob_name)
        self.journal_path = str(journal_path)
        self.apply_fn = apply_fn
        self.selector = selector
        #: knob-units → call-site units (e.g. ms → s); identity when None
        self.convert = convert or (lambda v: v)
        self.current = self.knob.default
        self.events = 0

    # ------------------------------------------------------------ resume
    def resume(self):
        """Replay the journal: re-apply the last **committed** value.

        Uncommitted intents are ignored — a kill between intent and
        apply must leave the previous value serving, and the journal
        reader (``streaming/wal.read_lines``) already skips torn lines.
        Returns the resumed value, or ``None`` when nothing committed.
        """
        from ..streaming.wal import read_lines  # lazy: avoids import cycle

        committed = None
        for entry in read_lines(self.journal_path):
            if entry.get("kind") == "commit" and entry.get("knob") == \
                    self.knob.name:
                committed = entry
        if committed is None:
            return None
        value = committed["value"]
        self.apply_fn(self.convert(value))
        self.current = value
        return value

    # ------------------------------------------------------------ retune
    def observe(self, score: float, *, shape_rows: int = 1,
                reps: int = 1, meta: dict | None = None) -> dict:
        """Record what the deployed value is actually delivering."""
        trial = make_trial(
            knob=self.knob.name, value=self.current, score=score,
            platform=self.selector.platform,
            fingerprint=self.selector.fingerprint,
            shape_rows=shape_rows, metric=self.knob.metric,
            reps=reps, source="live", meta=meta,
        )
        self.selector.store.add([trial])
        return trial

    def retune(self, *, shape_rows: int = 1) -> dict:
        """One selection pass; applies (journaled) only on a change.

        Returns ``{knob, old, new, applied, reason}`` — the record the
        soak report banks for its retune-boundary invariant.
        """
        with span("tune.select", {"knob": self.knob.name}):
            new = self.selector.resolve(self.knob, shape_rows)
            reason = self.selector.explain(self.knob.name).get("reason", "")
            old = self.current
            out = {
                "knob": self.knob.name, "old": old, "new": new,
                "applied": False, "reason": reason,
            }
            if new == old:
                return out
            self.events += 1
            entry = {
                "knob": self.knob.name, "old": old, "value": new,
                "reason": reason, "seq": self.events,
            }
            # the span-log exemption does NOT apply here: this journal
            # IS the durability story, so appends keep the wal.append
            # torn-tail discipline under their own site name
            append_line_kind(self.journal_path, entry, "intent")
            fault_point("tune.select.apply", knob=self.knob.name)
            self.apply_fn(self.convert(new))
            append_line_kind(self.journal_path, entry, "commit")
            self.current = new
            out["applied"] = True
            return out


def append_line_kind(path: str, entry: dict, kind: str) -> None:
    from ..streaming.wal import append_line  # lazy: avoids import cycle

    append_line(path, dict(entry, kind=kind))
