"""Carry fitted parameters across from the JAX package.

Every function takes plain numpy arrays — exactly what the JAX models'
``_artifacts()`` hold — so this module needs nothing of the JAX package:

    name, params, arrays = jax_kmeans_model._artifacts()
    port_model = kmeans_model_from_jax_arrays(**arrays, **params)

A model carried across predicts what it predicted in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .features.scaler import StandardScalerModel
from .models.kmeans import KMeansModel
from .models.linear_regression import LinearRegressionModel
from .models.tree import DecisionTreeModel, RandomForestModel


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


def linear_regression_model_from_jax_arrays(coefficients, intercept) -> LinearRegressionModel:
    """A port :class:`LinearRegressionModel` (CPU float32 tensors; predict
    moves them to the rows' device)."""
    return LinearRegressionModel(
        coefficients=torch.tensor(np.asarray(coefficients, dtype=np.float32)),
        intercept=torch.tensor(np.asarray(intercept, dtype=np.float32)),
    )


def tree_model_from_jax_arrays(
    split_feat, threshold, value, feature_importances, *, max_depth: int,
    task: str = "regression", num_classes: int = 2, split_catmask=None,
    cat_arities=None, name: str | None = None,
):
    """A port tree model with the JAX tree ensemble's heap arrays —
    ``DecisionTreeModel`` or ``RandomForestModel`` as ``name`` says (by
    default: one tree is a decision tree)."""
    split_feat = np.asarray(split_feat, dtype=np.int32)
    if name is None:
        name = "DecisionTreeModel" if split_feat.shape[0] == 1 else "RandomForestModel"
    cls = {"DecisionTreeModel": DecisionTreeModel, "RandomForestModel": RandomForestModel}[name]
    return cls(
        split_feat=split_feat,
        threshold=np.asarray(threshold, dtype=np.float32),
        value=np.asarray(value, dtype=np.float32),
        feature_importances=np.asarray(feature_importances, dtype=np.float64),
        max_depth=int(max_depth),
        task=str(task),
        num_classes=int(num_classes),
        split_catmask=None if split_catmask is None else np.asarray(split_catmask, np.uint32),
        cat_arities=None if cat_arities is None else np.asarray(cat_arities, np.int32),
    )
