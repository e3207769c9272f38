"""The incremental-maintenance decisions of materialized views.

The JAX package's ``core/sql_views.py`` keeps materialized views over the
unbounded table; the views themselves (``ViewRegistry``, the fold
machinery, persistence) come with a later slice of the port.  What the
planner and ``explain`` report per plan node comes now: each clause's
decision, ``"incremental"`` or a ``"full-recompute:<reason>"`` constant,
the same literals as the JAX package's.
"""

from __future__ import annotations

#: per-clause-node incremental decisions (explain / the registry / tests
#: share these literals)
DECISION_INCREMENTAL = "incremental"
FULL_NOT_COMPILED = "full-recompute:plan-not-compiled"
FULL_WINDOW = "full-recompute:window-over-unbounded-partition"
FULL_LIMIT = "full-recompute:limit-order-dependent"
FULL_COMPILE_DISABLED = "full-recompute:compiled-dispatch-disabled"


def incremental_decisions(plan) -> list[str]:
    """One decision per plan node (aligned with ``plan.nodes``):
    :data:`DECISION_INCREMENTAL` or a ``full-recompute:<reason>``
    constant — the per-clause view-coverage surface ``explain``
    exposes."""
    if plan is None:
        return []
    out = []
    for n in plan.nodes:
        if not n.supported:
            out.append(FULL_NOT_COMPILED)
        elif n.op == "window":
            out.append(FULL_WINDOW)
        elif n.op == "limit":
            out.append(FULL_LIMIT)
        else:
            out.append(DECISION_INCREMENTAL)
    return out


def plan_is_incremental(plan) -> tuple[bool, list[str]]:
    """→ (maintainable incrementally?, the non-incremental reasons)."""
    ds = incremental_decisions(plan)
    reasons = sorted({d for d in ds if d != DECISION_INCREMENTAL})
    return bool(ds) and not reasons, reasons
