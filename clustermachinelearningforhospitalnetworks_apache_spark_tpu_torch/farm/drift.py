"""Per-tenant drift scoring for model farms (the JAX package's
``farm/drift.py``; host numpy).

The farm's saved per-tenant sketches (``farm/profiles.py``) are the
reference distributions; live traffic binned over the SAME shared edges
yields per-tenant PSI exactly as ``quality/sketches.py`` defines it —
sample-size-aware smoothing included, so a 40-row hospital window
doesn't read as drifted because it left bins unhit.

The retrain policy this feeds is the whole point of the farm's layout:
``lifecycle`` refits ONLY the drifted subset (``ModelFarmModel.refit``'s
masked scatter), not 4,000 stable hospitals.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from ..quality.sketches import (
    PSI_DRIFT,
    FeatureSketch,
    population_stability_index,
)
from .profiles import tenant_sketch


def tenant_psi(model, tenant_id: str, live_x: np.ndarray) -> dict[str, float]:
    """Per-feature PSI of a tenant's live rows against its training-time
    sketches.  ``live_x``: (n, d) raw feature rows for that tenant."""
    i = model.tenant_index(tenant_id, strict=True)
    live_x = np.atleast_2d(np.asarray(live_x, dtype=np.float64))
    edges = model.arrays["profile_edges"]
    out: dict[str, float] = {}
    for j, name in enumerate(model.feature_names):
        ref = tenant_sketch(model.arrays, i, j)
        live = FeatureSketch(edges=np.asarray(edges[j], dtype=np.float64))
        live.update(live_x[:, j])
        out[name] = population_stability_index(ref, live)
    return out


def drifted_tenants(
    model,
    live: Mapping[str, np.ndarray],
    threshold: float = PSI_DRIFT,
    min_rows: int = 16,
) -> dict[str, float]:
    """``{tenant_id: max-feature PSI}`` for every tenant whose live
    window clears ``threshold``.  Tenants with fewer than ``min_rows``
    live rows are skipped (no evidence is not drift), as are ids the
    farm doesn't know (they route to the global slot; there is no
    per-tenant reference to score against)."""
    out: dict[str, float] = {}
    for tid, rows in live.items():
        rows = np.atleast_2d(np.asarray(rows, dtype=np.float64))
        if rows.shape[0] < min_rows:
            continue
        if str(tid) not in model._index:
            continue
        score = max(tenant_psi(model, tid, rows).values())
        if score >= threshold:
            out[str(tid)] = float(score)
    return out
