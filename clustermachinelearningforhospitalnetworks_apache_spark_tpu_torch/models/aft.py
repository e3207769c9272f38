"""AFTSurvivalRegression — Weibull accelerated-failure-time model.

The JAX package's ``models/aft.py`` (Spark's ``AFTSurvivalRegression``):
the censored log-likelihood of ``log T = xβ + b + σ·ε`` with ε standard
extreme-value, ``censor`` 1.0 = event observed / 0.0 = right-censored,
minimized over θ = (β, b, log σ) by full-batch L-BFGS (``models/_opt.py``,
the reference's ``optax.lbfgs`` steps, tol 1e-6).  Per row:

    z = (log y − xβ − b) / σ
    observed:  −log σ + z − eᶻ
    censored:  −eᶻ

Over a mesh (``fit(..., mesh=)``; one device is one shard of
``base.Shards``) the loss is a sum of per-shard terms, each shard's
value and gradient taken on its device and added in ascending shard
order, the censor column row-sharded as the rows are.  A
:class:`~..parallel.outofcore.HostDataset` trains by minibatch Adam
(lr 1e-2), one step a block, the blocks of each epoch in the order of
``default_rng(1).permutation``, ``max_iter`` epochs, as the reference.
``model.fit_info`` holds ``n_iter``, the loss evaluations and the host
reads of the resident fit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..io.model_io import register_model
from ..parallel.outofcore import HostDataset, stream_home, stream_mesh
from ._opt import Adam, lbfgs_minimize, shard_value_and_grad
from .base import Estimator, Model, Shards, check_features, on_mesh, padded_column

QUANTILES = (0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99)


def aft_loss(x, logy, censor, w, fit_intercept: bool, wsum=None):
    """The weighted mean negative log-likelihood as a function of
    ``[theta]`` (θ = (β, b, log σ), or (β, log σ) without an intercept);
    ``wsum`` (default max(Σw, 1) of these rows) is the mean's divisor, a
    whole dataset's where these rows are one shard of it."""
    d = x.shape[1]
    if wsum is None:
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

    def fit(self, data, label_col: str | None = None, device=None, censor=None, mesh=None):
        """``censor`` as an array for non-table inputs; a table input
        resolves ``censor_col``.  On ``device`` (default the card) or over
        ``mesh``, the censor column laid out as the rows are; a
        :class:`HostDataset` needs ``censor=`` and streams its blocks."""
        from ..features.assembler import AssembledTable

        if isinstance(data, HostDataset):
            if censor is None:
                raise ValueError("HostDataset inputs need censor= as an array (there is "
                                 "no table column to resolve)")
            return self._fit_outofcore(data, censor, stream_mesh(mesh, device))
        if censor is None:
            if not isinstance(data, AssembledTable):
                raise ValueError(f"censor_col={self.censor_col!r} needs a table input "
                                 "(or pass censor= as an array)")
            if self.censor_col not in data.table.schema:
                raise KeyError(f"censor_col {self.censor_col!r} is not a column of the "
                               f"table; available: {data.table.schema.names}")
            censor = np.asarray(data.table.column(self.censor_col), np.float32)
        censor = _check_censor(censor)
        ds = on_mesh(data, label_col or self.label_col, device, None, mesh)
        sh = Shards(ds)
        yv = sh.valid_labels()
        if censor.shape[0] != yv.shape[0]:
            raise ValueError(
                f"censor has {censor.shape[0]} entries but the data has {yv.shape[0]} rows — a "
                "short censor array would silently mark the tail as censored")
        if (yv <= 0).any():
            raise ValueError("survival times must be positive")
        d = ds.n_features
        theta0 = torch.zeros((d + (2 if self.fit_intercept else 1),), dtype=torch.float32,
                             device=sh.home)
        params, loss, n_iter, opt = lbfgs_minimize(None, [theta0], self.max_iter, 1e-6,
                                                   self._grad_fn(sh, padded_column(censor, ds)))
        return self._model(params[0].cpu().numpy(), d, {
            "n_iter": n_iter, "loss": float(loss), "evaluations": opt.evaluations,
            "host_reads": opt.host_reads})

    def _grad_fn(self, sh, cen):
        """The loss's (value, gradients) over the shards of ``sh``: each
        shard's term, its rows' sum over the whole Σw, on its device
        (:func:`~._opt.shard_value_and_grad`); ``cen`` the censor column
        laid out as the rows are."""
        f32 = torch.float32
        wsum = torch.clamp(sh.sum(lambda i, s: (s.w.to(f32).sum(),))[0], min=1.0)
        cparts = sh.parts(cen)
        return shard_value_and_grad(sh.sum, lambda i, s: aft_loss(
            s.x.to(f32), _log_labels(s.y), cparts[i], s.w.to(f32), self.fit_intercept,
            wsum.to(s.x.device)))

    def _fit_outofcore(self, hd: HostDataset, censor, mesh):
        """Rows ≫ device memory: minibatch Adam over ``mesh``, one step a
        block (its gradient a shard at a time, summed), ``max_iter`` epochs
        (the reference's trade of solver parity for bounded memory); each
        block's censor flags sliced on the host and laid out as its rows."""
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
                             device=stream_home(mesh))]
        opt = Adam(theta, 1e-2)
        n_blocks, b = hd.block_shape(mesh)
        shuffle = np.random.default_rng(1)
        for _ in range(self.max_iter):
            perm = shuffle.permutation(n_blocks)
            for i, blk in zip(perm, hd.blocks(mesh, order=perm)):
                s = int(i) * b
                _, grads = self._grad_fn(Shards(blk), padded_column(censor[s:s + b], blk))(theta)
                theta = opt.step(theta, grads)
        return self._model(theta[0].cpu().numpy(), d, {"epochs": self.max_iter})


__all__ = ["AFTSurvivalRegression", "AFTSurvivalRegressionModel", "aft_loss"]
