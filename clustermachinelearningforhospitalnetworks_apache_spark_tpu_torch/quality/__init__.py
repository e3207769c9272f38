"""Data-quality firewall: validation, reconciliation, drift (the JAX
package's ``quality/``; host numpy, no device).

The streaming layer survives crashes, torn writes and poison batches;
this package hardens the *data* layer the same way, one rung lower on
the ladder:

    row reject (here) → batch quarantine (streaming) → breaker (serve)

* :mod:`validators` — declarative constraints compiled into vectorized
  row validation with machine-readable reject reasons
* :mod:`reconcile`  — per-hospital schema-drift tolerance (add / drop /
  reorder / rename) with explicit :class:`DriftEvent`\\ s
* :mod:`sketches`   — mergeable per-feature moment/histogram sketches +
  PSI, persisted in the model manifest as the training reference
* :mod:`drift`      — live PSI monitoring + serving input guards
* :mod:`firewall`   — the composed boundary object ingest paths use
"""

from .drift import DriftMonitor, InputGuard, POLICY_IMPUTE, POLICY_REJECT
from .firewall import DataFirewall, FirewallResult
from .reconcile import (
    ColumnMapping,
    DriftEvent,
    DRIFT_COLUMN_ADDED,
    DRIFT_COLUMN_MISSING,
    DRIFT_COLUMN_RENAMED,
    DRIFT_COLUMN_REORDERED,
    reconcile_columns,
)
from .sketches import (
    DataProfile,
    FeatureSketch,
    PSI_DRIFT,
    PSI_STABLE,
    population_stability_index,
)
from .validators import (
    Constraint,
    ConstraintSet,
    RowValidator,
    ValidationResult,
    hospital_constraints,
)

__all__ = [
    "ColumnMapping",
    "Constraint",
    "ConstraintSet",
    "DRIFT_COLUMN_ADDED",
    "DRIFT_COLUMN_MISSING",
    "DRIFT_COLUMN_RENAMED",
    "DRIFT_COLUMN_REORDERED",
    "DataFirewall",
    "DataProfile",
    "DriftEvent",
    "DriftMonitor",
    "FeatureSketch",
    "FirewallResult",
    "InputGuard",
    "POLICY_IMPUTE",
    "POLICY_REJECT",
    "PSI_DRIFT",
    "PSI_STABLE",
    "RowValidator",
    "ValidationResult",
    "hospital_constraints",
    "population_stability_index",
    "reconcile_columns",
]
