"""Per-source schema reconciliation: tolerate drift, report it.

Every hospital in the network is an independent producer; its CSV drops
evolve independently of the canonical :class:`~..core.schema.Schema`
(columns added by an EHR upgrade, dropped by an export bug, reordered by
a rewrite, renamed by a vendor).  The reference pipeline — like any
MLlib-style schema-on-read path — turns each of those into a hard dtype
error for the whole file.  Here the source boundary *reconciles* instead:

* an **exact** header match maps 1:1 (the fast path — no event);
* a **reordered** header maps by name (``column_reordered`` event);
* a **renamed** column maps through the caller's alias table or a
  normalized-name match (case / non-alphanumeric insensitive;
  ``column_renamed`` event);
* a **missing** column is filled with nulls (``column_missing`` event) —
  downstream imputation or not-null validation decides its fate;
* an **extra** column is dropped (``column_added`` event).

Reconciliation never guesses silently: every non-exact decision is a
:class:`DriftEvent` the stream surfaces in metrics and quarantine
evidence, so "hospital H07 renamed los → length_of_stay last Tuesday"
is an observable fact, not an outage.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Mapping, Sequence

from ..core.schema import Schema

DRIFT_COLUMN_ADDED = "column_added"
DRIFT_COLUMN_MISSING = "column_missing"
DRIFT_COLUMN_RENAMED = "column_renamed"
DRIFT_COLUMN_REORDERED = "column_reordered"


@dataclass(frozen=True)
class DriftEvent:
    """One reconciliation decision that deviated from the exact schema."""

    kind: str                 # one of the DRIFT_* constants
    target: str | None = None  # canonical schema column involved (if any)
    source: str | None = None  # producer-side column involved (if any)
    context: str = ""          # file / hospital the event was observed at

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "target": self.target,
            "source": self.source,
            "context": self.context,
        }


def _norm(name: str) -> str:
    """Normalized column identity: case- and punctuation-insensitive."""
    return re.sub(r"[^a-z0-9]", "", name.lower())


@dataclass(frozen=True)
class ColumnMapping:
    """Resolved source→schema layout for one file."""

    #: schema column name → index into the source header (None = missing)
    indices: dict[str, int | None]
    events: tuple[DriftEvent, ...] = field(default_factory=tuple)

    @property
    def exact(self) -> bool:
        return not self.events

    @property
    def missing(self) -> tuple[str, ...]:
        return tuple(k for k, v in self.indices.items() if v is None)


def reconcile_columns(
    source_names: Sequence[str],
    schema: Schema,
    aliases: Mapping[str, str] | None = None,
    context: str = "",
) -> ColumnMapping:
    """Map a producer's header onto the canonical schema.

    ``aliases`` maps producer-side names to schema names for renames that
    normalization alone cannot see (e.g. ``{"los": "length_of_stay"}``).
    """
    source = [s.strip() for s in source_names]
    targets = schema.names
    events: list[DriftEvent] = []
    indices: dict[str, int | None] = {}
    claimed: set[int] = set()

    alias_to_target = {k: v for k, v in (aliases or {}).items()}
    norm_source = {}
    for i, s in enumerate(source):
        norm_source.setdefault(_norm(s), i)

    # pass 1: exact name matches
    exact_pos = {s: i for i, s in enumerate(source)}
    for t in targets:
        i = exact_pos.get(t)
        if i is not None and i not in claimed:
            indices[t] = i
            claimed.add(i)

    # pass 2: aliases, then normalized-name matches → renames
    for t in targets:
        if t in indices:
            continue
        src_i = None
        for s, tgt in alias_to_target.items():
            if tgt == t and s in exact_pos and exact_pos[s] not in claimed:
                src_i = exact_pos[s]
                break
        if src_i is None:
            j = norm_source.get(_norm(t))
            if j is not None and j not in claimed:
                src_i = j
        if src_i is not None:
            indices[t] = src_i
            claimed.add(src_i)
            events.append(
                DriftEvent(
                    DRIFT_COLUMN_RENAMED,
                    target=t, source=source[src_i], context=context,
                )
            )
        else:
            indices[t] = None
            events.append(
                DriftEvent(DRIFT_COLUMN_MISSING, target=t, context=context)
            )

    # pass 3: unclaimed producer columns are additions
    for i, s in enumerate(source):
        if i not in claimed:
            events.append(
                DriftEvent(DRIFT_COLUMN_ADDED, source=s, context=context)
            )

    # pass 4: order drift (only worth reporting when nothing else did)
    mapped = [indices[t] for t in targets if indices[t] is not None]
    if mapped != sorted(mapped):
        events.append(DriftEvent(DRIFT_COLUMN_REORDERED, context=context))

    return ColumnMapping(indices=indices, events=tuple(events))
