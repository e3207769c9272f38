"""Carry fitted parameters across from the JAX package.

Both take plain numpy arrays — exactly what the JAX models'
``_artifacts()`` hold — so this module needs nothing of the JAX package:

    name, params, arrays = jax_kmeans_model._artifacts()
    port_model = kmeans_model_from_jax_arrays(**arrays, **params)
"""

from __future__ import annotations

import numpy as np

from .features.scaler import StandardScalerModel
from .models.kmeans import KMeansModel


def kmeans_model_from_jax_arrays(
    cluster_centers, *, training_cost: float = 0.0, n_iter: int = 0,
    cluster_sizes=None, distance_measure: str = "euclidean",
) -> KMeansModel:
    """A port :class:`KMeansModel` with the JAX model's parameters."""
    return KMeansModel(
        cluster_centers=np.asarray(cluster_centers, dtype=np.float32),
        distance_measure=distance_measure,
        training_cost=float(training_cost),
        n_iter=int(n_iter),
        cluster_sizes=None if cluster_sizes is None else np.asarray(cluster_sizes),
    )


def scaler_model_from_jax_arrays(
    mean, std, with_mean: bool = True, with_std: bool = True
) -> StandardScalerModel:
    """A port :class:`StandardScalerModel` with the JAX model's moments."""
    return StandardScalerModel(
        np.asarray(mean), np.asarray(std), bool(with_mean), bool(with_std)
    )
