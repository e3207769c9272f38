"""Model farm: thousands of per-hospital models fit and served as one
artifact (the JAX package's ``farm/``).

Ragged tenant sizes ride the repo's pad-and-weight contract
(``data.stack_ragged``); every tenant is fit by one sequence of batched
torch ops on ``device`` (default the card), bit-equal to a loop over the
tenants; optional hierarchical partial pooling shrinks small-hospital
parameters toward the pooled global model.  One saved artifact carries
every tenant's parameters plus mergeable per-tenant feature sketches;
serving routes a request to its tenant's slice in-band; the lifecycle
refits only the drifted subset.  Packing, the sketches and the drift
scores are host numpy and take no ``device=``.
"""

from .drift import drifted_tenants, tenant_psi
from .farm import (
    FarmKMeans,
    FarmLinearRegression,
    ModelFarmModel,
    TenantBatch,
    pack_tenants,
)

__all__ = [
    "FarmKMeans",
    "FarmLinearRegression",
    "ModelFarmModel",
    "TenantBatch",
    "pack_tenants",
    "drifted_tenants",
    "tenant_psi",
]
