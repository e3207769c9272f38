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
import torch

from .features.imputer import ImputerModel
from .features.indexer import StringIndexerModel
from .features.lsh import BucketedRandomProjectionLSHModel, MinHashLSHModel
from .features.minmax import MinMaxScalerModel
from .features.onehot import OneHotEncoderModel
from .features.pca import PCAModel
from .features.rformula import RFormulaModel
from .features.robust import MaxAbsScalerModel, RobustScalerModel
from .features.scaler import StandardScalerModel
from .features.selector import (
    UnivariateFeatureSelectorModel,
    VarianceThresholdSelectorModel,
    VectorIndexerModel,
)
from .features.text import CountVectorizerModel, IDFModel
from .features.word2vec import Word2VecModel
from .models.aft import AFTSurvivalRegressionModel
from .models.als import ALSModel
from .models.bisecting_kmeans import BisectingKMeansModel
from .models.fm import FMModel
from .models.glm import GeneralizedLinearRegressionModel
from .models.gmm import GaussianMixtureModel
from .models.isotonic import IsotonicRegressionModel
from .models.kmeans import KMeansModel
from .models.lda import LDAModel
from .models.linear_regression import LinearRegressionModel
from .models.linear_svc import LinearSVCModel
from .models.logistic_regression import (
    LogisticRegressionModel,
    MultinomialLogisticRegressionModel,
)
from .models.mlp import MultilayerPerceptronModel
from .models.naive_bayes import NaiveBayesModel
from .models.streaming_kmeans import StreamingKMeansModel
from .models.streaming_linear import StreamingLinearRegression, StreamingLogisticRegression
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


def logistic_regression_model_from_jax_arrays(
    coefficients, intercept, *, threshold: float = 0.5, n_iter: int = 0,
) -> LogisticRegressionModel:
    """A port binomial :class:`LogisticRegressionModel` (CPU float32
    tensors; predict moves them to the rows' device)."""
    return LogisticRegressionModel.from_artifacts(
        {"threshold": threshold, "n_iter": n_iter},
        {"coefficients": coefficients, "intercept": intercept},
    )


def multinomial_logistic_regression_model_from_jax_arrays(
    coefficient_matrix, intercept_vector, *, n_iter: int = 0,
) -> MultinomialLogisticRegressionModel:
    """A port :class:`MultinomialLogisticRegressionModel` with the JAX
    model's (K, d) coefficient matrix and (K,) intercepts."""
    return MultinomialLogisticRegressionModel.from_artifacts(
        {"n_iter": n_iter},
        {"coefficient_matrix": coefficient_matrix, "intercept_vector": intercept_vector},
    )


def linear_svc_model_from_jax_arrays(coefficients, *, intercept: float,
                                     n_iter: int = 0) -> LinearSVCModel:
    """A port :class:`LinearSVCModel` with the JAX model's coefficients
    and intercept."""
    return LinearSVCModel.from_artifacts({"intercept": intercept, "n_iter": n_iter},
                                         {"coefficients": coefficients})


def naive_bayes_model_from_jax_arrays(pi, theta, sigma=None, theta2=None, *,
                                      model_type: str) -> NaiveBayesModel:
    """A port :class:`NaiveBayesModel` with the JAX model's log priors,
    per-class parameters and, by type, variances or log(1 − p)."""
    arrays = {"pi": pi, "theta": theta}
    if sigma is not None:
        arrays["sigma"] = sigma
    if theta2 is not None:
        arrays["theta2"] = theta2
    return NaiveBayesModel.from_artifacts({"model_type": model_type}, arrays)


def glm_model_from_jax_arrays(
    coefficients, *, intercept: float, family: str, link: str, n_iter: int = 0,
    deviance: float = 0.0, variance_power: float = 0.0, link_power: float = 0.0,
) -> GeneralizedLinearRegressionModel:
    """A port :class:`GeneralizedLinearRegressionModel` with the JAX
    model's coefficients, family and link (tweedie's powers too)."""
    return GeneralizedLinearRegressionModel.from_artifacts(
        {"intercept": intercept, "family": family, "link": link, "n_iter": n_iter,
         "deviance": deviance, "variance_power": variance_power, "link_power": link_power},
        {"coefficients": coefficients})


def mlp_model_from_jax_arrays(*, layers, **arrays) -> MultilayerPerceptronModel:
    """A port :class:`MultilayerPerceptronModel` from the JAX model's
    ``w0, b0, w1, b1, …`` arrays and its ``layers``."""
    return MultilayerPerceptronModel.from_artifacts({"layers": list(layers)}, arrays)


def fm_model_from_jax_arrays(linear, factors, *, intercept: float,
                             task: str = "regression") -> FMModel:
    """A port :class:`FMModel` (regressor or classifier, by ``task``)."""
    return FMModel.from_artifacts({"intercept": intercept, "task": task},
                                  {"linear": linear, "factors": factors})


def aft_model_from_jax_arrays(coefficients, *, intercept: float, scale: float,
                              quantile_probabilities=()) -> AFTSurvivalRegressionModel:
    """A port :class:`AFTSurvivalRegressionModel` with the JAX model's
    coefficients, intercept and σ."""
    return AFTSurvivalRegressionModel.from_artifacts(
        {"intercept": intercept, "scale": scale,
         "quantile_probabilities": list(quantile_probabilities)},
        {"coefficients": coefficients})


def isotonic_model_from_jax_arrays(boundaries, predictions, *, isotonic: bool = True,
                                   feature_index: int = 0) -> IsotonicRegressionModel:
    """A port :class:`IsotonicRegressionModel` with the JAX model's
    boundary table."""
    return IsotonicRegressionModel.from_artifacts(
        {"isotonic": isotonic, "feature_index": feature_index},
        {"boundaries": boundaries, "predictions": predictions})


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def streaming_linear_regression_from_jax_arrays(
    gram, mom, wsum, *, n_batches: int, decay_factor: float = 1.0, reg_param: float = 0.0,
    label_col: str = "length_of_stay",
) -> StreamingLinearRegression:
    """A port :class:`StreamingLinearRegression` holding the JAX stream's
    decayed (XᵀWX, XᵀWy, Σw) state (the JAX object's ``_gram``, ``_mom``,
    ``_wsum``); it moves to the device of the next batch."""
    s = StreamingLinearRegression(decay_factor=decay_factor, reg_param=reg_param,
                                  label_col=label_col)
    s._gram, s._mom, s._wsum, s._n_batches = _f32(gram), _f32(mom), _f32(wsum), int(n_batches)
    return s


def streaming_logistic_regression_from_jax_arrays(
    theta, grad_hist, hess_hist, *, wsum: float, n_batches: int, decay_factor: float = 1.0,
    reg_param: float = 0.0, newton_steps_per_batch: int = 1, label_col: str = "LOS_binary",
    threshold: float = 0.5,
) -> StreamingLogisticRegression:
    """A port :class:`StreamingLogisticRegression` holding the JAX stream's
    θ and decayed Newton history (``_theta``, ``_grad_hist``,
    ``_hess_hist``, ``_wsum``)."""
    s = StreamingLogisticRegression(decay_factor=decay_factor, reg_param=reg_param,
                                    newton_steps_per_batch=newton_steps_per_batch,
                                    label_col=label_col, threshold=threshold)
    s._theta, s._grad_hist, s._hess_hist = _f32(theta), _f32(grad_hist), _f32(hess_hist)
    s._wsum, s._n_batches = float(wsum), int(n_batches)
    return s


# --------------------------------------------- slice 5c: the feature stages

def minmax_scaler_model_from_jax_arrays(data_min, data_max, *, min_out: float = 0.0,
                                        max_out: float = 1.0) -> MinMaxScalerModel:
    """A port :class:`MinMaxScalerModel` with the JAX model's extremes."""
    return MinMaxScalerModel.from_artifacts({"min_out": min_out, "max_out": max_out},
                                            {"data_min": data_min, "data_max": data_max})


def maxabs_scaler_model_from_jax_arrays(max_abs) -> MaxAbsScalerModel:
    """A port :class:`MaxAbsScalerModel` with the JAX model's |x| maxima."""
    return MaxAbsScalerModel.from_artifacts({}, {"max_abs": max_abs})


def robust_scaler_model_from_jax_arrays(median, iqr, *, with_centering: bool = False,
                                        with_scaling: bool = True) -> RobustScalerModel:
    """A port :class:`RobustScalerModel` with the JAX model's quantiles."""
    return RobustScalerModel.from_artifacts(
        {"with_centering": with_centering, "with_scaling": with_scaling},
        {"median": median, "iqr": iqr})


def pca_model_from_jax_arrays(components, explained_variance, mean) -> PCAModel:
    """A port :class:`PCAModel` with the JAX model's axes, variances and mean."""
    return PCAModel.from_artifacts({}, {"components": components,
                                        "explained_variance": explained_variance,
                                        "mean": mean})


def imputer_model_from_jax_arrays(*, input_cols, output_cols, surrogates,
                                  missing_value="nan") -> ImputerModel:
    """A port :class:`ImputerModel` with the JAX model's surrogates (its
    ``_artifacts()`` params; ``missing_value`` as saved: ``"nan"`` or a
    float)."""
    return ImputerModel.from_artifacts(
        {"input_cols": input_cols, "output_cols": output_cols, "surrogates": surrogates,
         "missing_value": missing_value}, {})


def string_indexer_model_from_jax_arrays(*, input_col: str, output_col: str, labels,
                                         handle_invalid: str = "error") -> StringIndexerModel:
    """A port :class:`StringIndexerModel` with the JAX model's labels."""
    return StringIndexerModel.from_artifacts(
        {"input_col": input_col, "output_col": output_col, "labels": labels,
         "handle_invalid": handle_invalid}, {})


def one_hot_encoder_model_from_jax_arrays(*, input_cols, output_cols, category_sizes,
                                          drop_last: bool = True,
                                          handle_invalid: str = "error") -> OneHotEncoderModel:
    """A port :class:`OneHotEncoderModel` with the JAX model's category
    sizes."""
    return OneHotEncoderModel.from_artifacts(
        {"input_cols": input_cols, "output_cols": output_cols,
         "category_sizes": category_sizes, "drop_last": drop_last,
         "handle_invalid": handle_invalid}, {})


def rformula_model_from_jax_arrays(*, label: str, terms, levels, label_levels=(),
                                   feature_names=()) -> RFormulaModel:
    """A port :class:`RFormulaModel` with the JAX model's resolved terms and
    factor levels."""
    return RFormulaModel.from_artifacts(
        {"label": label, "terms": terms, "levels": levels, "label_levels": label_levels,
         "feature_names": feature_names}, {})


# ------------------------- slices 5d + 5e: selectors, LSH, text, ALS, LDA

def vector_indexer_model_from_jax_arrays(*, num_features: int, category_maps,
                                         handle_invalid: str = "error") -> VectorIndexerModel:
    """A port :class:`VectorIndexerModel` with the JAX model's category maps
    (its ``_artifacts()`` params: string feature keys, value lists)."""
    return VectorIndexerModel.from_artifacts(
        {"num_features": num_features, "category_maps": category_maps,
         "handle_invalid": handle_invalid}, {})


def univariate_feature_selector_model_from_jax_arrays(*, selected
                                                      ) -> UnivariateFeatureSelectorModel:
    """A port :class:`UnivariateFeatureSelectorModel` with the JAX model's
    selected feature indices."""
    return UnivariateFeatureSelectorModel.from_artifacts({"selected": selected}, {})


def variance_threshold_selector_model_from_jax_arrays(*, selected
                                                      ) -> VarianceThresholdSelectorModel:
    """A port :class:`VarianceThresholdSelectorModel` with the JAX model's
    selected feature indices."""
    return VarianceThresholdSelectorModel.from_artifacts({"selected": selected}, {})


def bucketed_random_projection_lsh_model_from_jax_arrays(
        projections, *, bucket_length: float) -> BucketedRandomProjectionLSHModel:
    """A port :class:`BucketedRandomProjectionLSHModel` with the JAX model's
    projections (as saved: float32, widened to float64 as a load does)."""
    return BucketedRandomProjectionLSHModel.from_artifacts(
        {"bucket_length": bucket_length}, {"projections": projections})


def minhash_lsh_model_from_jax_arrays(coef_a, coef_b) -> MinHashLSHModel:
    """A port :class:`MinHashLSHModel` with the JAX model's hash
    coefficients."""
    return MinHashLSHModel.from_artifacts({}, {"coef_a": coef_a, "coef_b": coef_b})


def count_vectorizer_model_from_jax_arrays(*, vocabulary, binary: bool = False,
                                           min_tf: float = 1.0) -> CountVectorizerModel:
    """A port :class:`CountVectorizerModel` with the JAX model's vocabulary."""
    return CountVectorizerModel.from_artifacts(
        {"vocabulary": vocabulary, "binary": binary, "min_tf": min_tf}, {})


def idf_model_from_jax_arrays(idf) -> IDFModel:
    """A port :class:`IDFModel` with the JAX model's idf weights."""
    return IDFModel.from_artifacts({}, {"idf": np.asarray(idf)})


def word2vec_model_from_jax_arrays(vectors, *, vocabulary) -> Word2VecModel:
    """A port :class:`Word2VecModel` with the JAX model's vocabulary and
    vectors."""
    return Word2VecModel.from_artifacts({"vocabulary": vocabulary},
                                        {"vectors": np.asarray(vectors)})


def als_model_from_jax_arrays(user_factors, item_factors, *,
                              cold_start_strategy: str = "nan") -> ALSModel:
    """A port :class:`ALSModel` with the JAX model's factors."""
    return ALSModel.from_artifacts({"cold_start_strategy": cold_start_strategy},
                                   {"user_factors": np.asarray(user_factors),
                                    "item_factors": np.asarray(item_factors)})


def lda_model_from_jax_arrays(lam, *, alpha: float, eta: float, n_docs_trained: float = 0.0,
                              e_step_sweeps: int = 50) -> LDAModel:
    """A port :class:`LDAModel` with the JAX model's topic-word λ."""
    return LDAModel.from_artifacts(
        {"alpha": alpha, "eta": eta, "n_docs_trained": n_docs_trained,
         "e_step_sweeps": e_step_sweeps}, {"lam": np.asarray(lam)})
