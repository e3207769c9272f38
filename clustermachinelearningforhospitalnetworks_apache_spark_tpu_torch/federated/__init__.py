"""Cross-silo federated fit over the mergeable-partials discipline (the
JAX package's ``federated/``).

Hospitals keep their rows; each silo computes its sufficient statistics
on its own device (the K1 kernel for KMeans on the card), the coordinator
folds them with the exact ascending-silo-order, zero-initialized
reduction, fits from the merged partials on its device, and broadcasts
the result back.  Partials, merges, noise and the round journal are host
code, ``==`` the JAX package's.
"""

from .coordinator import (
    FED_BROADCAST_SITE,
    FED_COLLECT_SITE,
    FED_FIT_SITE,
    FED_MERGE_SITE,
    FederatedConfig,
    FederatedCoordinator,
    FederatedFitResult,
    FederatedQuorumError,
    RoundReport,
)
from .partials import (
    FitState,
    NoiseConfig,
    Partials,
    apply_clipped_noise,
    family_mode,
    merge_partials,
    merge_profiles,
    register_family,
)
from .silo import Silo

__all__ = [
    "FED_BROADCAST_SITE", "FED_COLLECT_SITE", "FED_FIT_SITE",
    "FED_MERGE_SITE", "FederatedConfig", "FederatedCoordinator",
    "FederatedFitResult", "FederatedQuorumError", "RoundReport",
    "FitState", "NoiseConfig", "Partials", "apply_clipped_noise",
    "family_mode", "merge_partials", "merge_profiles", "register_family",
    "Silo",
]
