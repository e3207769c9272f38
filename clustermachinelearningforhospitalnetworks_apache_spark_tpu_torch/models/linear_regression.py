"""LinearRegression — weighted least squares on the device.

The JAX package's ``models/linear_regression.py`` (the reference
script's ``LinearRegression`` → ``length_of_stay``): one pass builds the
Gram matrix ``XᵀWX`` and the moments ``XᵀWy`` of the intercept-augmented
design, and the (d+1)×(d+1) normal equations are solved on the device in
float32 (TF32 off, ``device.py``).  Ridge (``reg_param``) is Spark's L2
on standardized coefficients, the intercept unpenalized.

The elastic-net path (``elastic_net_param > 0``, with the ``max_iter`` /
``tol`` that only it reads) and the training summary belong to a later
slice of the port and raise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..data import DeviceDataset
from ..io.model_io import register_model
from .base import Estimator, Model, as_device_dataset, check_features

_LATER = "slice 3 or later of the port"


def weighted_moments(x: torch.Tensor, w: torch.Tensor):
    """Weighted per-feature moments; a (near-)constant feature gets std
    1.0.  → (n, mean, std) with n = max(Σw, 1)."""
    n = torch.clamp(w.sum(), min=1.0)
    wcol = w[:, None]
    mean = (x * wcol).sum(dim=0) / n
    var = (x * x * wcol).sum(dim=0) / n - mean * mean
    std = torch.where(var > 1e-12, torch.sqrt(torch.clamp(var, min=1e-12)),
                      torch.ones_like(var))
    return n, mean, std


def standardized_design(x, w, reg_param: float, fit_intercept: bool, standardize: bool):
    """The intercept-augmented design and the ridge vector (L2 on
    standardized coefficients, intercept unpenalized).
    → (xa, ridge, nfeat, n)."""
    n, _, std = weighted_moments(x, w)
    scale = std if standardize else torch.ones_like(std)
    xa = torch.cat([x, torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)], dim=1) \
        if fit_intercept else x
    nfeat = x.shape[1]
    ridge = torch.zeros((xa.shape[1],), dtype=x.dtype, device=x.device)
    ridge[:nfeat] = reg_param * n * scale * scale
    return xa, ridge, nfeat, n


def _wls_fit(x, y, w, reg_param: float, fit_intercept: bool, standardize: bool):
    """Weighted least squares → (coefficients (d,), intercept ()), float32
    on the inputs' device."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    w = w.to(torch.float32)
    xa, ridge, nfeat, _ = standardized_design(x, w, reg_param, fit_intercept, standardize)
    d = xa.shape[1]
    xw = xa * w[:, None]
    gram = xw.T @ xa + torch.diag(ridge)
    mom = xw.T @ y
    eye = torch.eye(d, dtype=torch.float32, device=x.device)
    theta = torch.linalg.solve(gram + 1e-8 * eye, mom)
    coef = theta[:nfeat]
    intercept = theta[nfeat] if fit_intercept else torch.zeros((), dtype=x.dtype, device=x.device)
    return coef, intercept


@register_model("LinearRegressionModel")
@dataclass
class LinearRegressionModel(Model):
    """``coefficients`` (d,) and ``intercept`` () as float32 tensors."""

    coefficients: torch.Tensor
    intercept: torch.Tensor

    @property
    def summary(self):
        raise NotImplementedError(
            f"LinearRegressionModel.summary is not ported yet ({_LATER})"
        )

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        check_features(x, self.coefficients.shape[0], "LinearRegressionModel")
        coef = self.coefficients.to(x.device)
        return x.to(torch.float32) @ coef + self.intercept.to(x.device)

    def _artifacts(self):
        return (
            "LinearRegressionModel",
            {},
            {
                "coefficients": self.coefficients.detach().cpu().numpy(),
                "intercept": self.intercept.detach().cpu().numpy(),
            },
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        """CPU float32 tensors; ``predict`` moves them to the rows' device."""
        return cls(
            coefficients=torch.tensor(np.asarray(arrays["coefficients"], dtype=np.float32)),
            intercept=torch.tensor(np.asarray(arrays["intercept"], dtype=np.float32)),
        )


@dataclass(frozen=True)
class LinearRegression(Estimator):
    """Spark's ``LinearRegression``; ``elastic_net_param`` 0 (pure L2
    ridge, the closed-form WLS) is the ported path."""

    label_col: str = "length_of_stay"
    reg_param: float = 0.0
    elastic_net_param: float = 0.0
    fit_intercept: bool = True
    standardize: bool = True
    weight_col: str | None = None

    def fit(self, data, label_col: str | None = None, device=None) -> LinearRegressionModel:
        if self.elastic_net_param > 0.0 and self.reg_param > 0.0:
            raise NotImplementedError(
                f"the elastic-net path (models/_opt.py) is not ported yet ({_LATER})"
            )
        ds: DeviceDataset = as_device_dataset(
            data, label_col or self.label_col, device=device, weight_col=self.weight_col
        )
        coef, intercept = _wls_fit(
            ds.x, ds.y, ds.w, float(self.reg_param), self.fit_intercept, self.standardize
        )
        return LinearRegressionModel(coefficients=coef, intercept=intercept)


__all__ = [
    "LinearRegression", "LinearRegressionModel", "standardized_design",
    "weighted_moments",
]
