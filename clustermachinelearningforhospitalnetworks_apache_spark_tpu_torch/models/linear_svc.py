"""LinearSVC — squared-hinge Newton classifier on the device.

The JAX package's ``models/linear_svc.py``: ``pyspark.ml.classification.
LinearSVC``'s surface (binary 0/1 labels, L2 ``reg_param`` on
standardized coefficients with the intercept unpenalized,
``rawPrediction`` the signed margin), with the reference's one documented
delta: the objective is the SQUARED hinge (sklearn ``LinearSVC``'s
default), whose generalized Hessian makes each iteration a Newton step
over the active set (margin < 1):

    λ/2 ‖β̃‖² + (1/Σw) Σᵢ wᵢ max(0, 1 − ỹᵢ(xᵢβ + b))²,   ỹ ∈ {−1, +1}.

The products are summed per chunk of rows (``row_sums``), and the
steps run in chunks on the device with a done flag
(``logistic_regression.newton_loop``), so ``n_iter`` is the reference's
unless a row on the margin flips its side between the two summation
orders.  A :class:`~..parallel.outofcore.HostDataset` streams its blocks
through the same active-set sums once a step.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..io.model_io import register_model
from ..parallel.outofcore import HostDataset, standardized_ridge, streamed_standardization
from .base import Estimator, Model, as_device_dataset, check_features
from .linear_regression import standardized_design
from .logistic_regression import newton_loop, row_sums, streamed_newton_loop, with_intercept


def _svc_solve(theta, grad, hess):
    """The squared hinge's Newton step: the trace-scaled jitter and, unlike
    the logistic step, no cap.  → (theta, max |step|)."""
    d = theta.shape[0]
    jitter = 1e-6 * torch.trace(hess) / d + 1e-8
    eye = torch.eye(d, dtype=hess.dtype, device=hess.device)
    delta = torch.linalg.solve_ex(hess + jitter * eye, grad)[0]
    return theta - delta, torch.max(torch.abs(delta))


def _svc_fit(x, y01, w, reg_param: float, tol: float, fit_intercept: bool,
             standardize: bool, max_iter: int):
    """→ (coef (d,), intercept (), n_iter, host syncs) on the inputs'
    device."""
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    ysign = 2.0 * y01.to(torch.float32) - 1.0               # {0,1} → {−1,+1}
    xa, ridge, nfeat, n = standardized_design(x, w, reg_param, fit_intercept, standardize)
    # the loss is divided by Σw: fold 1/n into the data term, and keep the
    # ridge at Spark's λ‖β̃‖² convention
    wn = w / n

    def step(theta):
        margin = ysign * (xa @ theta)
        act = (margin < 1.0).to(torch.float32) * wn          # the active set
        resid = 1.0 - margin
        grad = -2.0 * row_sums(xa, act * ysign * resid) + ridge / n * theta
        hess = 2.0 * row_sums(xa * act[:, None], xa) + torch.diag(ridge / n)
        return _svc_solve(theta, grad, hess)

    theta0 = torch.zeros((xa.shape[1],), dtype=torch.float32, device=x.device)
    theta, n_iter, syncs = newton_loop(step, theta0, tol, max_iter)
    coef = theta[:nfeat]
    intercept = theta[nfeat] if fit_intercept else torch.zeros((), device=x.device)
    return coef, intercept, n_iter, syncs


def _svc_block_stats(x, y01, w, theta, fit_intercept: bool):
    """One block's unnormalized (Σ gradient, Σ Hessian) of the squared
    hinge at ``theta``: the resident step's active-set sums."""
    xa = with_intercept(x.to(torch.float32), fit_intercept)
    w = w.to(torch.float32)
    ysign = 2.0 * y01.to(torch.float32) - 1.0
    margin = ysign * (xa @ theta)
    act = (margin < 1.0).to(torch.float32) * w
    resid = 1.0 - margin
    grad = -2.0 * row_sums(xa, act * ysign * resid)
    hess = 2.0 * row_sums(xa * act[:, None], xa)
    return grad, hess


def _svc_update_from_stats(theta, grad_sum, hess_sum, ridge, n):
    """The resident Newton solve on summed statistics (the same 1/n
    scaling, ridge and jitter)."""
    grad = grad_sum / n + ridge / n * theta
    hess = hess_sum / n + torch.diag(ridge / n)
    return _svc_solve(theta, grad, hess)


@register_model("LinearSVCModel")
@dataclass
class LinearSVCModel(Model):
    """``coefficients`` (d,) numpy and ``intercept`` a float, as in the JAX
    package."""

    coefficients: np.ndarray
    intercept: float
    n_iter: int = 0

    def predict_raw(self, x: torch.Tensor) -> torch.Tensor:
        """Signed margin (Spark's rawPrediction for the positive class)."""
        check_features(x, np.asarray(self.coefficients).shape[0], "LinearSVCModel")
        coef = torch.as_tensor(np.asarray(self.coefficients, dtype=np.float32), device=x.device)
        return x.to(torch.float32) @ coef + float(np.float32(self.intercept))

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return (self.predict_raw(x) > 0).to(torch.float32)

    def _artifacts(self):
        return (
            "LinearSVCModel",
            {"intercept": float(self.intercept), "n_iter": int(self.n_iter)},
            {"coefficients": np.asarray(self.coefficients)},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(coefficients=arrays["coefficients"], intercept=float(params["intercept"]),
                   n_iter=int(params.get("n_iter", 0)))


def _check_binary(valid_labels: np.ndarray) -> None:
    uniq = np.unique(valid_labels)
    if uniq.size == 0:
        raise ValueError("LinearSVC fit on an empty dataset")
    if not np.all(np.isin(uniq, (0.0, 1.0))):
        raise ValueError(f"LinearSVC is binary (labels 0/1); got labels {uniq[:5]}")


@dataclass(frozen=True)
class LinearSVC(Estimator):
    reg_param: float = 0.0          # Spark default
    max_iter: int = 100             # Spark default
    tol: float = 1e-6               # Spark default
    fit_intercept: bool = True
    standardize: bool = True
    label_col: str = "LOS_binary"
    features_col: str = "features"
    weight_col: str | None = None

    def fit(self, data, label_col: str | None = None, device=None) -> LinearSVCModel:
        """Fit on ``data`` on ``device`` (default the card); a
        :class:`HostDataset` streams its blocks to ``device``.
        ``model.fit_info["host_syncs"]`` counts the fit's host reads."""
        if isinstance(data, HostDataset):
            return self._fit_outofcore(data, resolve_device(device))
        ds = as_device_dataset(data, label_col or self.label_col, device=device,
                               weight_col=self.weight_col)
        # one host read for the label check; the labels themselves come to
        # the host only to name the bad ones
        valid = ds.w > 0
        some, bad = torch.stack([valid.any(), (valid & (ds.y != 0) & (ds.y != 1)).any()]).tolist()
        if bad or not some:
            _check_binary(ds.y[valid].cpu().numpy())
        coef, intercept, n_iter, syncs = _svc_fit(
            ds.x, ds.y, ds.w, float(self.reg_param), float(self.tol), self.fit_intercept,
            self.standardize, self.max_iter)
        out = torch.cat([coef, intercept.reshape(1)]).cpu().numpy()
        model = LinearSVCModel(coefficients=out[:-1], intercept=float(out[-1]), n_iter=n_iter)
        model.fit_info = {"host_syncs": syncs + 2}
        return model

    def _fit_outofcore(self, hd: HostDataset, dev) -> LinearSVCModel:
        """Rows ≫ device memory: each Newton step streams the blocks,
        summing the resident step's active-set (gradient, Hessian), then the
        same solve; one host read a step, as in the reference."""
        if hd.y is None:
            raise ValueError("LinearSVC needs labels: HostDataset(y=...)")
        w_host = np.asarray(hd.w) if hd.w is not None else np.ones(hd.n, np.float32)
        _check_binary(np.asarray(hd.y)[w_host > 0])
        nfeat = hd.n_features
        dd = nfeat + (1 if self.fit_intercept else 0)
        if self.reg_param > 0:
            # pass 0: the moments → the standardized ridge
            n, _, std, _ = streamed_standardization(hd, dev)
            ridge = standardized_ridge(n, std, self.reg_param, nfeat, self.fit_intercept,
                                       self.standardize)
        else:
            # the ridge is zero: Σw from the host weights, no pass needed
            n = max(float(np.sum(w_host)), 1.0)
            ridge = np.zeros((dd,), np.float32)
        ridge = torch.from_numpy(ridge).to(dev)
        n_dev = torch.tensor(n, dtype=torch.float32, device=dev)
        theta, it = streamed_newton_loop(
            hd, dev, lambda blk, th: _svc_block_stats(blk.x, blk.y, blk.w, th, self.fit_intercept),
            lambda th, g, h: _svc_update_from_stats(th, g, h, ridge, n_dev),
            torch.zeros((dd,), dtype=torch.float32, device=dev), self.tol, self.max_iter)
        th = theta.cpu().numpy()
        model = LinearSVCModel(coefficients=th[:nfeat],
                               intercept=float(th[nfeat]) if self.fit_intercept else 0.0,
                               n_iter=it)
        model.fit_info = {"host_syncs": it + 1 + (self.reg_param > 0)}
        return model


__all__ = ["LinearSVC", "LinearSVCModel"]
