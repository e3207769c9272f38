"""Carry fitted parameters across from the JAX package in memory.

A saved JAX artifact directory loads directly with
:func:`~.io.model_io.load_model` (one artifact format for both packages).
These functions are the in-memory bridge beside it: each takes plain
numpy arrays — exactly what the JAX models' ``_artifacts()`` hold — so
this module needs nothing of the JAX package:

    name, params, arrays = jax_kmeans_model._artifacts()
    port_model = kmeans_model_from_jax_arrays(**arrays, **params)

Each is one call of the model class's ``from_artifacts``, the body that
``load_model`` also runs, so the in-memory bridge and the on-disk path
build the same model.  A model carried across predicts what it predicted
in the JAX package.
"""

from __future__ import annotations

import numpy as np

from .features.scaler import StandardScalerModel
from .models.bisecting_kmeans import BisectingKMeansModel
from .models.gmm import GaussianMixtureModel
from .models.kmeans import KMeansModel
from .models.linear_regression import LinearRegressionModel
from .models.streaming_kmeans import StreamingKMeansModel
from .models.tree import DecisionTreeModel, GBTModel, RandomForestModel


def kmeans_model_from_jax_arrays(
    cluster_centers, *, training_cost: float = 0.0, n_iter: int = 0,
    cluster_sizes=None, distance_measure: str = "euclidean",
) -> KMeansModel:
    """A port :class:`KMeansModel` with the JAX model's parameters."""
    return KMeansModel.from_artifacts(
        {"distance_measure": distance_measure, "training_cost": training_cost,
         "n_iter": n_iter},
        {"cluster_centers": cluster_centers, "cluster_sizes": cluster_sizes},
    )


def scaler_model_from_jax_arrays(
    mean, std, with_mean: bool = True, with_std: bool = True
) -> StandardScalerModel:
    """A port :class:`StandardScalerModel` with the JAX model's moments."""
    return StandardScalerModel.from_artifacts(
        {"with_mean": with_mean, "with_std": with_std}, {"mean": mean, "std": std}
    )


def linear_regression_model_from_jax_arrays(coefficients, intercept) -> LinearRegressionModel:
    """A port :class:`LinearRegressionModel` (CPU float32 tensors; predict
    moves them to the rows' device)."""
    return LinearRegressionModel.from_artifacts(
        {}, {"coefficients": coefficients, "intercept": intercept}
    )


def tree_model_from_jax_arrays(
    split_feat, threshold, value, feature_importances, *, max_depth: int,
    task: str = "regression", num_classes: int = 2, split_catmask=None,
    cat_arities=None, name: str | None = None,
):
    """A port tree model with the JAX tree ensemble's heap arrays —
    ``DecisionTreeModel`` or ``RandomForestModel`` as ``name`` says (by
    default: one tree is a decision tree)."""
    if name is None:
        name = "DecisionTreeModel" if np.shape(split_feat)[0] == 1 else "RandomForestModel"
    cls = {"DecisionTreeModel": DecisionTreeModel, "RandomForestModel": RandomForestModel}[name]
    return cls.from_artifacts(
        {"max_depth": max_depth, "task": task, "num_classes": num_classes},
        {"split_feat": split_feat, "threshold": threshold, "value": value,
         "feature_importances": feature_importances,
         "split_catmask": split_catmask, "cat_arities": cat_arities},
    )


def gbt_model_from_jax_arrays(
    split_feat, threshold, value, feature_importances, *, task: str, init: float,
    learning_rate: float, max_depth: int, split_catmask=None, cat_arities=None,
) -> GBTModel:
    """A port :class:`GBTModel` with the JAX boosted trees' heap arrays,
    prior margin and step size."""
    return GBTModel.from_artifacts(
        {"task": task, "init": init, "learning_rate": learning_rate, "max_depth": max_depth},
        {"split_feat": split_feat, "threshold": threshold, "value": value,
         "feature_importances": feature_importances,
         "split_catmask": split_catmask, "cat_arities": cat_arities},
    )


def gaussian_mixture_model_from_jax_arrays(
    weights, means, covariances, *, log_likelihood: float = 0.0,
    avg_log_likelihood: float = 0.0, n_iter: int = 0,
) -> GaussianMixtureModel:
    """A port :class:`GaussianMixtureModel` with the JAX mixture's weights
    (k,), means (k, d) and covariances (k, d, d)."""
    return GaussianMixtureModel.from_artifacts(
        {"log_likelihood": log_likelihood, "avg_log_likelihood": avg_log_likelihood,
         "n_iter": n_iter},
        {"weights": weights, "means": means, "covariances": covariances},
    )


def bisecting_kmeans_model_from_jax_arrays(
    cluster_centers, cluster_sizes=None, *, training_cost: float = 0.0,
    n_iter: int = 0, distance_measure: str = "euclidean",
) -> BisectingKMeansModel:
    """A port :class:`BisectingKMeansModel` with the JAX tree's leaf
    centers and sizes."""
    return BisectingKMeansModel.from_artifacts(
        {"distance_measure": distance_measure, "training_cost": training_cost,
         "n_iter": n_iter},
        {"cluster_centers": cluster_centers, "cluster_sizes": cluster_sizes},
    )


def streaming_kmeans_model_from_jax_arrays(
    cluster_centers, cluster_weights, cluster_weights_lo=None, *, cluster_sizes=None,
    training_cost: float = 0.0, n_iter: int = 0, distance_measure: str = "euclidean",
) -> StreamingKMeansModel:
    """A port :class:`StreamingKMeansModel` with the JAX stream's centers
    and decayed weights.  Given the estimator's Kahan pair (its
    ``_weights`` and ``_weights_lo``), the weights are their float64 sum,
    as the JAX package's ``latest_model`` forms them."""
    w = np.asarray(cluster_weights, dtype=np.float64)
    if cluster_weights_lo is not None:
        w = w + np.asarray(cluster_weights_lo, dtype=np.float64)
    return StreamingKMeansModel.from_artifacts(
        {"distance_measure": distance_measure, "training_cost": training_cost,
         "n_iter": n_iter},
        {"cluster_centers": cluster_centers, "cluster_sizes": cluster_sizes,
         "cluster_weights": w},
    )
