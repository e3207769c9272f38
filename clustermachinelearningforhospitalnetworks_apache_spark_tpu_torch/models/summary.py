"""Training summaries (the JAX package's ``models/summary.py``: the
clustering summary, LinearRegression's training summary and the binary
and multiclass LogisticRegression training summaries).

Spark attaches a TrainingSummary to every freshly fitted model; loaded
models have ``hasSummary == False`` and raise.  Summaries are lazy: the
fit stores references (the model and the training ``DeviceDataset``
already on the device), and each metric is computed on first read, with
one weighted reduction on the device, and cached.

Memory note: the summary keeps the training ``DeviceDataset`` alive, and
so on the device, for the model's lifetime; ``model.release_summary()``
lets it go.  Saving a model never persists the summary.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Any

import numpy as np
import torch


def summary_unavailable(model_name: str):
    return RuntimeError(
        f"{model_name} has no training summary — summaries exist only on "
        "freshly fitted models (Spark parity: hasSummary is False after "
        "load_model)"
    )


class SummaryMixin:
    """``has_summary`` / ``release_summary`` / ``summary`` over a model's
    ``_summary`` field, which a fresh resident fit sets."""

    @property
    def has_summary(self) -> bool:
        return self._summary is not None

    def release_summary(self) -> None:
        """Drop the summary's reference to the training dataset, freeing
        its device memory."""
        self._summary = None

    @property
    def summary(self):
        """The training summary: fresh resident fits only, like Spark's
        ``hasSummary``."""
        if self._summary is None:
            raise summary_unavailable(type(self).__name__)
        return self._summary


def _xtwx_gram(x: torch.Tensor, w: torch.Tensor, fit_intercept: bool) -> torch.Tensor:
    """X'WX (the intercept column appended only when the model fitted
    one), summed per chunk of rows as the fit's Gram is
    (``linear_regression.chunked_gram``); the tiny (p, p) inverse runs on
    the host in float64, so collinearity is detected rather than turned
    into float32 garbage."""
    from .linear_regression import chunked_gram

    if fit_intercept:
        x = torch.cat([x, torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)], dim=1)
    return chunked_gram(x * w[:, None], x)


@dataclass(frozen=True)
class ClusteringSummary:
    """``pyspark.ml.clustering.*Summary`` surface (KMeans / Bisecting /
    GaussianMixture): sizes + objective, already computed by the fit."""

    k: int
    num_iter: int
    cluster_sizes: np.ndarray | None = None
    training_cost: float | None = None      # KMeans / Bisecting
    log_likelihood: float | None = None     # GaussianMixture


@dataclass
class LinearRegressionTrainingSummary:
    """``pyspark.ml.regression.LinearRegressionTrainingSummary`` surface."""

    _model: Any = field(repr=False)
    _ds: Any = field(repr=False)          # the DeviceDataset the fit consumed
    _reg_param: float = 0.0
    _elastic_net_param: float = 0.0
    _fit_intercept: bool = True

    @cached_property
    def predictions(self):
        from .base import PredictionResult

        return PredictionResult(
            prediction=self._model.predict(self._ds.x),
            label=self._ds.y,
            weight=self._ds.w,
        )

    @cached_property
    def residuals(self) -> np.ndarray:
        """Per-row label − prediction on the valid rows only (pad rows
        dropped: statistics over this array see ``num_instances``
        entries, like Spark's residuals column)."""
        p = self.predictions
        res = (p.prediction - p.label).cpu().numpy() * -1.0
        w = p.weight.cpu().numpy()
        return res[w > 0]

    @cached_property
    def _reg_metrics(self) -> dict[str, float]:
        # one device reduction for the sufficient statistics; every metric
        # is a host finish on the same sums
        from ..evaluation.regression import RegressionEvaluator, _sums

        p = self.predictions
        sums = _sums(p.prediction, p.label, p.weight)
        return {
            m: float(RegressionEvaluator(m)._finish(sums))
            for m in ("rmse", "mse", "mae", "r2", "var")
        }

    @property
    def root_mean_squared_error(self) -> float:
        return self._reg_metrics["rmse"]

    @property
    def mean_squared_error(self) -> float:
        return self._reg_metrics["mse"]

    @property
    def mean_absolute_error(self) -> float:
        return self._reg_metrics["mae"]

    @property
    def r2(self) -> float:
        return self._reg_metrics["r2"]

    @property
    def explained_variance(self) -> float:
        return self._reg_metrics["var"]

    @property
    def r2adj(self) -> float:
        """Spark's ``r2adj``: 1 − (1−r²)(n−1)/(n−p−1) with p the feature
        count (intercept excluded, Spark's convention)."""
        n = self.num_instances
        p = self._model.coefficients.shape[0]
        denom = n - p - (1 if self._fit_intercept else 0)
        if denom <= 0:
            return float("nan")
        return 1.0 - (1.0 - self.r2) * (n - (1 if self._fit_intercept else 0)) / denom

    @cached_property
    def num_instances(self) -> int:
        """Count of (w > 0) rows: Spark's numInstances is a row count, not
        the weight sum (they differ under fractional weights)."""
        return int((self._ds.w > 0).sum())

    @cached_property
    def weight_sum(self) -> float:
        """Σw over the valid rows."""
        return float(self._ds.w.sum())

    @property
    def degrees_of_freedom(self) -> int:
        p = self._model.coefficients.shape[0] + (1 if self._fit_intercept else 0)
        return max(self.num_instances - p, 0)

    # -- normal-solver-only inference statistics (Spark raises on the
    #    regularized path the same way) -------------------------------
    def _require_unregularized(self) -> None:
        if self._reg_param != 0.0:
            raise RuntimeError(
                "coefficient standard errors / t / p values are only "
                "available for an unregularized fit (reg_param=0), "
                "matching Spark's normal-solver restriction"
            )

    @cached_property
    def coefficient_standard_errors(self) -> np.ndarray:
        """Standard errors of (coefficients..., intercept if fitted),
        Spark's order.  Raises on a (near-)collinear design instead of
        returning a float32 inverse's garbage."""
        self._require_unregularized()
        g = _xtwx_gram(self._ds.x.to(torch.float32), self._ds.w,
                       self._fit_intercept).cpu().numpy().astype(np.float64)
        cond = np.linalg.cond(g)
        if not np.isfinite(cond) or cond > 1e7:  # the float32 data's Gram limit
            raise RuntimeError(
                "design matrix is (near-)collinear (Gram condition number "
                f"{cond:.2e}); standard errors are undefined — drop a "
                "redundant column (e.g. OneHotEncoder(drop_last=True))"
            )
        diag = np.diag(np.linalg.inv(g))
        dof = max(self.degrees_of_freedom, 1)
        # RSS = weighted mse × Σw (not × the row count: they differ under
        # fractional weights); dof stays a row count
        sigma2 = self.mean_squared_error * self.weight_sum / dof
        return np.sqrt(np.maximum(diag * sigma2, 0.0))

    @cached_property
    def t_values(self) -> np.ndarray:
        self._require_unregularized()
        beta = self._model.coefficients.cpu().numpy().astype(np.float64)
        if self._fit_intercept:
            beta = np.r_[beta, float(self._model.intercept)]
        return beta / self.coefficient_standard_errors

    @cached_property
    def p_values(self) -> np.ndarray:
        self._require_unregularized()
        try:
            from scipy import stats

            return 2.0 * stats.t.sf(np.abs(self.t_values), self.degrees_of_freedom)
        except ImportError:  # the normal approximation
            from math import erfc, sqrt

            return np.array([erfc(abs(t) / sqrt(2.0)) for t in self.t_values])


class _ConfusionMetricsMixin:
    """Confusion-matrix metrics shared by the binary and multiclass
    logistic summaries (Spark's ``LogisticRegressionSummary`` surface).
    Subclasses set the ``_model`` / ``_ds`` fields and ``_num_classes``."""

    @property
    def _num_classes(self) -> int:
        return 2

    @cached_property
    def predictions(self):
        from .base import PredictionResult

        return PredictionResult(
            prediction=self._model.predict(self._ds.x),
            label=self._ds.y,
            weight=self._ds.w,
        )

    @cached_property
    def accuracy(self) -> float:
        from ..evaluation.classification import MulticlassClassificationEvaluator

        return float(MulticlassClassificationEvaluator(
            "accuracy", num_classes=self._num_classes).evaluate(self.predictions))

    @cached_property
    def _confusion(self) -> np.ndarray:
        from ..evaluation.classification import MulticlassClassificationEvaluator

        p = self.predictions
        return MulticlassClassificationEvaluator(num_classes=self._num_classes) \
            .confusion_matrix(p.prediction, p.label, p.weight)

    def _by_label(self, metric: str) -> np.ndarray:
        cm = self._confusion
        support = cm.sum(axis=1)
        pred_ct = cm.sum(axis=0)
        tp = np.diag(cm)
        with np.errstate(invalid="ignore", divide="ignore"):
            prec = np.where(pred_ct > 0, tp / pred_ct, 0.0)
            rec = np.where(support > 0, tp / support, 0.0)
            f1 = np.where(prec + rec > 0, 2 * prec * rec / (prec + rec), 0.0)
        return {"precision": prec, "recall": rec, "f1": f1}[metric]

    @property
    def precision_by_label(self) -> np.ndarray:
        return self._by_label("precision")

    @property
    def recall_by_label(self) -> np.ndarray:
        return self._by_label("recall")

    @property
    def f_measure_by_label(self) -> np.ndarray:
        return self._by_label("f1")

    def _weighted(self, metric: str) -> float:
        # one copy of the math: the evaluator on the cached predictions
        from ..evaluation.classification import MulticlassClassificationEvaluator

        return float(MulticlassClassificationEvaluator(
            metric, num_classes=self._num_classes).evaluate(self.predictions))

    @property
    def _support_frac(self) -> np.ndarray:
        support = self._confusion.sum(axis=1)
        return support / max(support.sum(), 1e-30)

    @property
    def weighted_precision(self) -> float:
        return self._weighted("weightedPrecision")

    @property
    def weighted_recall(self) -> float:
        return self._weighted("weightedRecall")

    @property
    def weighted_f_measure(self) -> float:
        return self._weighted("f1")

    @property
    def weighted_true_positive_rate(self) -> float:
        return self.weighted_recall  # Spark: TPR is recall

    @property
    def weighted_false_positive_rate(self) -> float:
        return float(self._support_frac @ self.false_positive_rate_by_label)

    @property
    def true_positive_rate_by_label(self) -> np.ndarray:
        return self._by_label("recall")

    @property
    def false_positive_rate_by_label(self) -> np.ndarray:
        cm = self._confusion
        support = cm.sum(axis=1)
        total = max(support.sum(), 1e-30)
        fp = cm.sum(axis=0) - np.diag(cm)
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(total - support > 0, fp / (total - support), 0.0)


@dataclass
class MulticlassLogisticRegressionTrainingSummary(_ConfusionMetricsMixin):
    """``LogisticRegressionTrainingSummary`` of the multinomial family:
    accuracy, per-label P/R/F/TPR/FPR and their support-weighted
    aggregates (no ROC: Spark keeps the curves for the binary summary)."""

    _model: Any = field(repr=False)
    _ds: Any = field(repr=False)

    @property
    def _num_classes(self) -> int:
        return self._model.num_classes

    @property
    def num_classes(self) -> int:
        return self._model.num_classes


@dataclass
class BinaryLogisticRegressionTrainingSummary(_ConfusionMetricsMixin):
    """``BinaryLogisticRegressionSummary``: the confusion metrics plus the
    areas and the threshold curves, from P(class 1) on the training rows."""

    _model: Any = field(repr=False)
    _ds: Any = field(repr=False)

    @cached_property
    def _scores(self):
        return self._model.predict_proba(self._ds.x)

    def _area(self, metric: str) -> float:
        from ..evaluation.binary import BinaryClassificationEvaluator

        return BinaryClassificationEvaluator(metric).evaluate(self._scores, self._ds.y,
                                                               self._ds.w)

    @cached_property
    def area_under_roc(self) -> float:
        return self._area("areaUnderROC")

    @cached_property
    def area_under_pr(self) -> float:
        return self._area("areaUnderPR")

    # -- the threshold curves (Spark's roc / pr / *ByThreshold DataFrames,
    #    as (m, 2) arrays of curve points) --------------------------------
    @cached_property
    def _curves(self) -> dict:
        from ..evaluation.binary import binary_curves

        return binary_curves(self._scores, self._ds.y, self._ds.w)

    @cached_property
    def roc(self) -> np.ndarray:
        """(m, 2) [FPR, TPR] points anchored at (0, 0) and (1, 1)."""
        c = self._curves
        fpr = c["fp"] / max(c["total_neg"], 1e-30)
        tpr = c["tp"] / max(c["total_pos"], 1e-30)
        return np.column_stack([np.r_[0.0, fpr, 1.0], np.r_[0.0, tpr, 1.0]])

    @cached_property
    def pr(self) -> np.ndarray:
        """(m, 2) [recall, precision] points, anchored at recall 0 with the
        highest-threshold block's precision (Spark's first point)."""
        c = self._curves
        recall = c["tp"] / max(c["total_pos"], 1e-30)
        with np.errstate(invalid="ignore", divide="ignore"):
            precision = c["tp"] / np.maximum(c["tp"] + c["fp"], 1e-30)
        return np.column_stack([np.r_[0.0, recall], np.r_[precision[:1], precision]])

    def _by_threshold(self, kind: str, beta: float = 1.0) -> np.ndarray:
        c = self._curves
        with np.errstate(invalid="ignore", divide="ignore"):
            precision = c["tp"] / np.maximum(c["tp"] + c["fp"], 1e-30)
            recall = c["tp"] / max(c["total_pos"], 1e-30)
            if kind == "precision":
                val = precision
            elif kind == "recall":
                val = recall
            else:
                b2 = beta * beta
                val = np.where(
                    precision + recall > 0,
                    (1 + b2) * precision * recall / np.maximum(b2 * precision + recall, 1e-30),
                    0.0,
                )
        return np.column_stack([c["thresholds"], val])

    def precision_by_threshold(self) -> np.ndarray:
        """(m, 2) [threshold, precision] over the distinct score thresholds."""
        return self._by_threshold("precision")

    def recall_by_threshold(self) -> np.ndarray:
        return self._by_threshold("recall")

    def f_measure_by_threshold(self, beta: float = 1.0) -> np.ndarray:
        return self._by_threshold("f", beta)

    @property
    def max_f_measure_threshold(self) -> float:
        """The threshold of the largest F1 (Spark gives the curve; this is
        its argmax)."""
        curve = self.f_measure_by_threshold()
        return float(curve[np.argmax(curve[:, 1]), 0])
