"""LinearRegression — weighted least squares on the device.

The JAX package's ``models/linear_regression.py`` (the reference
script's ``LinearRegression`` → ``length_of_stay``): one pass builds the
Gram matrix ``XᵀWX`` and the moments ``XᵀWy`` of the intercept-augmented
design, and the (d+1)×(d+1) normal equations are solved on the device in
float32 (TF32 off, ``device.py``).  Ridge (``reg_param``) is Spark's L2
on standardized coefficients, the intercept unpenalized.

A :class:`~..parallel.outofcore.HostDataset` takes the out-of-core
path: one pass over the streamed blocks sums weighted moments and the
Gram matrix of features shifted by a host-sample mean, then the small
(d, d) system is solved in centered, standardized coordinates.

The elastic-net path (``elastic_net_param > 0``, with the ``max_iter`` /
``tol`` that only it reads) comes with slice 3e of the port and raises,
as does the training summary (unavailable out of core in the reference
too).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..data import DeviceDataset
from ..device import resolve_device
from ..io.model_io import register_model
from ..parallel.outofcore import HostDataset, add_stats
from .base import Estimator, Model, as_device_dataset, check_features

_LATER = "slice 3e of the port"


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


def _lr_block_stats(x, y, w, shift):
    """One block's weighted moments and Gram on SHIFTED features
    (xs = x − shift; the host-sample mean as shift keeps the
    Gram-minus-mean-outer cancellation out of float32): → (Σw, Σw·xs,
    Σw·xs², Σw·y, XsᵀWXs, XsᵀWy)."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    w = w.to(torch.float32)
    xs = x - shift[None, :]
    xw = xs * w[:, None]
    return (w.sum(), xw.sum(dim=0), (xs * xs * w[:, None]).sum(dim=0), (y * w).sum(),
            xw.T @ xs, xw.T @ y)


def _lr_solve_from_stats(stats, shift, reg_param: float, fit_intercept: bool,
                         standardize: bool):
    """Summed block statistics → (coef, intercept): the ridge branch of
    the reference's solve, ``(g + λ·I)β̃ = c`` in centered, standardized
    coordinates (the resident WLS with Spark's unpenalized intercept)."""
    sw, sx, sxx, sy, gram, mom = stats
    n = torch.clamp(sw, min=1.0)
    mean_s = sx / n                       # mean of the shifted features
    var = sxx / n - mean_s * mean_s
    std = torch.where(var > 1e-12, torch.sqrt(torch.clamp(var, min=1e-12)),
                      torch.ones_like(var))
    scale = std if standardize else torch.ones_like(std)
    ybar = sy / n
    if fit_intercept:
        g_c = gram / n - torch.outer(mean_s, mean_s)
        c_c = mom / n - mean_s * ybar
    else:  # the shift is 0 here
        g_c = gram / n
        c_c = mom / n
    g = g_c / torch.outer(scale, scale)
    c = c_c / scale
    d = g.shape[0]
    lam = torch.tensor(reg_param, dtype=torch.float32, device=g.device) + 1e-8
    beta = torch.linalg.solve(g + lam * torch.eye(d, dtype=g.dtype, device=g.device), c)
    coef = beta / scale
    if fit_intercept:
        intercept = ybar - (mean_s + shift) @ coef
    else:
        intercept = torch.zeros((), dtype=g.dtype, device=g.device)
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
        """Fit on ``data`` (DeviceDataset, AssembledTable, (x, y[, w])) on
        ``device`` (default the card); a :class:`HostDataset` streams its
        blocks to ``device``."""
        if self.elastic_net_param > 0.0 and self.reg_param > 0.0:
            raise NotImplementedError(
                f"the elastic-net path is not ported yet ({_LATER})"
            )
        if isinstance(data, HostDataset):
            return self._fit_outofcore(data, resolve_device(device))
        ds: DeviceDataset = as_device_dataset(
            data, label_col or self.label_col, device=device, weight_col=self.weight_col
        )
        coef, intercept = _wls_fit(
            ds.x, ds.y, ds.w, float(self.reg_param), self.fit_intercept, self.standardize
        )
        return LinearRegressionModel(coefficients=coef, intercept=intercept)

    def _fit_outofcore(self, hd: HostDataset, dev) -> LinearRegressionModel:
        """Rows ≫ device memory: one pass of block statistics, then the
        (d, d) solve."""
        if hd.y is None:
            raise ValueError("LinearRegression needs labels: HostDataset(y=...)")
        if hd.n == 0:
            raise ValueError("LinearRegression fit on an empty dataset")
        # the shift is a host-sample mean, exactly 0 without an intercept to
        # absorb it (or when every weight is 0)
        sample = hd.sample_rows(65536, seed=0) if self.fit_intercept else None
        if sample is not None and sample.shape[0] > 0:
            shift = torch.from_numpy(sample.mean(axis=0).astype(np.float32)).to(dev)
        else:
            shift = torch.zeros((hd.n_features,), dtype=torch.float32, device=dev)
        tot = None
        for blk in hd.blocks(device=dev):
            s = _lr_block_stats(blk.x, blk.y, blk.w, shift)
            tot = s if tot is None else add_stats(tot, s)
        coef, intercept = _lr_solve_from_stats(tot, shift, float(self.reg_param),
                                               self.fit_intercept, self.standardize)
        return LinearRegressionModel(coefficients=coef, intercept=intercept)


__all__ = [
    "LinearRegression", "LinearRegressionModel", "standardized_design",
    "weighted_moments",
]
