"""Training summaries (the JAX package's ``models/summary.py``: the
clustering summary and LinearRegression's training summary).

Spark attaches a TrainingSummary to every freshly fitted model; loaded
models have ``hasSummary == False`` and raise.  Summaries are lazy: the
fit stores references (the model and the training ``DeviceDataset``
already on the device), and each metric is computed on first read, with
one weighted reduction on the device, and cached.

Memory note: the summary keeps the training ``DeviceDataset`` alive, and
so on the device, for the model's lifetime; ``model.release_summary()``
lets it go.  Saving a model never persists the summary.

The logistic summaries come with the slice of the port that ports
LogisticRegression.
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
