"""AFTSurvivalRegression — Weibull accelerated-failure-time model.

The JAX package's ``models/aft.py`` (Spark's ``AFTSurvivalRegression``):
the censored log-likelihood of ``log T = xβ + b + σ·ε`` with ε standard
extreme-value, ``censor`` 1.0 = event observed / 0.0 = right-censored,
minimized over θ = (β, b, log σ) by full-batch L-BFGS (``models/_opt.py``,
the reference's ``optax.lbfgs`` steps, tol 1e-6).  Per row:

    z = (log y − xβ − b) / σ
    observed:  −log σ + z − eᶻ
    censored:  −eᶻ

A :class:`~..parallel.outofcore.HostDataset` trains by minibatch Adam
(lr 1e-2), one step a block, the blocks of each epoch in the order of
``default_rng(1).permutation``, ``max_iter`` epochs, as the reference.
``model.fit_info`` holds ``n_iter``, the loss evaluations and the host
reads of the resident fit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..io.model_io import register_model
from ..parallel.outofcore import HostDataset
from ._opt import Adam, lbfgs_minimize, value_and_grad
from .base import Estimator, Model, as_device_dataset, check_features

QUANTILES = (0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99)


def aft_loss(x, logy, censor, w, fit_intercept: bool):
    """The weighted mean negative log-likelihood as a function of
    ``[theta]`` (θ = (β, b, log σ), or (β, log σ) without an intercept)."""
    d = x.shape[1]
    wsum = torch.clamp(w.sum(), min=1.0)

    def loss_fn(params):
        theta = params[0]
        beta = theta[:d]
        log_sigma = theta[-1]
        sigma = torch.exp(log_sigma)
        r = logy - x @ beta
        if fit_intercept:
            r = r - theta[d]
        z = r / sigma
        ez = torch.exp(z)
        ll = torch.where(censor > 0, -log_sigma + z - ez, -ez)
        return -torch.sum(ll * w) / wsum

    return loss_fn


def _log_labels(y: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(y.to(torch.float32), min=1e-12))


def _check_censor(censor) -> np.ndarray:
    censor = np.asarray(censor, np.float32)
    if not np.all(np.isin(censor, (0.0, 1.0))):
        raise ValueError("censor values must be 0.0 (censored) or 1.0 (event)")
    return censor


@register_model("AFTSurvivalRegressionModel")
@dataclass
class AFTSurvivalRegressionModel(Model):
    """``coefficients`` (d,) float64 host array, as the reference holds
    them; ``scale`` is σ."""

    coefficients: np.ndarray
    intercept: float
    scale: float
    quantile_probabilities: tuple = QUANTILES

    def _eta(self, x: torch.Tensor) -> torch.Tensor:
        check_features(x, np.asarray(self.coefficients).shape[0], type(self).__name__)
        coef = torch.from_numpy(np.asarray(self.coefficients, np.float32)).to(x.device)
        return x.to(torch.float32) @ coef + float(np.float32(self.intercept))

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """exp(xβ + b): Spark's ``prediction`` column (the Weibull scale,
        not its mean)."""
        return torch.exp(self._eta(x))

    def predict_quantiles(self, x: torch.Tensor) -> torch.Tensor:
        """(n, len(quantile_probabilities)) survival-time quantiles
        exp(xβ + b)·(−log(1−p))^σ."""
        eta = self._eta(x)
        p = torch.tensor(np.asarray(self.quantile_probabilities, np.float32), device=x.device)
        q = (-torch.log1p(-p)) ** float(np.float32(self.scale))
        return torch.exp(eta)[:, None] * q[None, :]

    def _artifacts(self):
        return (
            "AFTSurvivalRegressionModel",
            {"intercept": float(self.intercept), "scale": float(self.scale),
             "quantile_probabilities": list(self.quantile_probabilities)},
            {"coefficients": np.asarray(self.coefficients)},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(coefficients=arrays["coefficients"], intercept=float(params["intercept"]),
                   scale=float(params["scale"]),
                   quantile_probabilities=tuple(params.get("quantile_probabilities", ())))


@dataclass(frozen=True)
class AFTSurvivalRegression(Estimator):
    """``censor_col`` rows: 1.0 = event observed, 0.0 = right-censored.
    Labels must be positive survival times."""

    censor_col: str = "censor"
    max_iter: int = 100
    fit_intercept: bool = True
    quantile_probabilities: tuple = QUANTILES
    label_col: str = "length_of_stay"
    features_col: str = "features"

    def _model(self, theta: np.ndarray, d: int, info: dict) -> AFTSurvivalRegressionModel:
        th = np.asarray(theta, np.float64)
        model = AFTSurvivalRegressionModel(
            coefficients=th[:d], intercept=float(th[d]) if self.fit_intercept else 0.0,
            scale=float(np.exp(th[-1])), quantile_probabilities=tuple(self.quantile_probabilities))
        model.fit_info = info
        return model

    def fit(self, data, label_col: str | None = None, device=None, censor=None):
        """``censor`` as an array for non-table inputs; a table input
        resolves ``censor_col``.  On ``device`` (default the card); a
        :class:`HostDataset` needs ``censor=`` and streams its blocks."""
        from ..features.assembler import AssembledTable

        if isinstance(data, HostDataset):
            if censor is None:
                raise ValueError("HostDataset inputs need censor= as an array (there is "
                                 "no table column to resolve)")
            return self._fit_outofcore(data, censor, resolve_device(device))
        if censor is None:
            if not isinstance(data, AssembledTable):
                raise ValueError(f"censor_col={self.censor_col!r} needs a table input "
                                 "(or pass censor= as an array)")
            if self.censor_col not in data.table.schema:
                raise KeyError(f"censor_col {self.censor_col!r} is not a column of the "
                               f"table; available: {data.table.schema.names}")
            censor = np.asarray(data.table.column(self.censor_col), np.float32)
        censor = _check_censor(censor)
        ds = as_device_dataset(data, label_col or self.label_col, device=device)
        w_host = ds.w.cpu().numpy()
        n_rows = int(np.sum(w_host > 0))
        if censor.shape[0] != n_rows:
            raise ValueError(
                f"censor has {censor.shape[0]} entries but the data has {n_rows} rows — a "
                "short censor array would silently mark the tail as censored")
        if (ds.y.cpu().numpy()[w_host > 0] <= 0).any():
            raise ValueError("survival times must be positive")
        cen = np.zeros((ds.n_padded,), np.float32)
        cen[: censor.shape[0]] = censor
        dev = ds.x.device
        d = ds.n_features
        loss_fn = aft_loss(ds.x.to(torch.float32), _log_labels(ds.y),
                           torch.from_numpy(cen).to(dev), ds.w.to(torch.float32),
                           self.fit_intercept)
        theta0 = torch.zeros((d + (2 if self.fit_intercept else 1),), dtype=torch.float32,
                             device=dev)
        params, loss, n_iter, opt = lbfgs_minimize(loss_fn, [theta0], self.max_iter, 1e-6)
        return self._model(params[0].cpu().numpy(), d, {
            "n_iter": n_iter, "loss": float(loss), "evaluations": opt.evaluations,
            "host_reads": opt.host_reads})

    def _fit_outofcore(self, hd: HostDataset, censor, dev):
        """Rows ≫ device memory: minibatch Adam, one step a block,
        ``max_iter`` epochs (the reference's trade of solver parity for
        bounded memory)."""
        if hd.y is None:
            raise ValueError("AFTSurvivalRegression needs labels (survival times): "
                             "HostDataset(y=...)")
        censor = _check_censor(censor)
        if censor.shape[0] != hd.n:
            raise ValueError(
                f"censor has {censor.shape[0]} entries but the data has {hd.n} rows — a "
                "short censor array would silently mark the tail as censored")
        y_host = np.asarray(hd.y)
        w_host = np.asarray(hd.w) if hd.w is not None else np.ones(hd.n, np.float32)
        if y_host[w_host > 0].size == 0:
            raise ValueError("AFTSurvivalRegression fit on an empty dataset")
        if (y_host[w_host > 0] <= 0).any():
            raise ValueError("survival times must be positive")
        d = hd.n_features
        theta = [torch.zeros((d + (2 if self.fit_intercept else 1),), dtype=torch.float32,
                             device=dev)]
        opt = Adam(theta, 1e-2)
        n_blocks, b = hd.block_shape()
        shuffle = np.random.default_rng(1)
        for _ in range(self.max_iter):
            perm = shuffle.permutation(n_blocks)
            for i, blk in zip(perm, hd.blocks(device=dev, order=perm)):
                s, e = int(i) * b, min(int(i) * b + b, hd.n)
                cb = np.zeros((b,), np.float32)
                cb[: e - s] = censor[s:e]
                loss_fn = aft_loss(blk.x.to(torch.float32), _log_labels(blk.y),
                                   torch.from_numpy(cb).to(dev), blk.w.to(torch.float32),
                                   self.fit_intercept)
                _, grads = value_and_grad(loss_fn, theta)
                theta = opt.step(theta, grads)
        return self._model(theta[0].cpu().numpy(), d, {"epochs": self.max_iter})


__all__ = ["AFTSurvivalRegression", "AFTSurvivalRegressionModel", "aft_loss"]
