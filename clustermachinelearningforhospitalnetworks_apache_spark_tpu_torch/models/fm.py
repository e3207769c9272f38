"""Factorization machines — FMRegressor / FMClassifier.

The JAX package's ``models/fm.py`` (Spark's ``FMRegressor`` /
``FMClassifier``, Rendle's second-order FM):

    ŷ(x) = w₀ + wᵀx + ½ Σ_f [(x·V)_f² − (x²·V²)_f]

two products a pass (``x @ V`` and ``x² @ V²``).  Training is full-batch
Adam (``models/_opt.py``, ``optax.adam``'s steps) for exactly
``max_iter`` steps with no stop, as the reference's ``lax.scan``: squared
loss (regressor) or logistic loss on ±1 labels (classifier), written as
``logaddexp(−m, 0)`` — the reference's ``jax.nn.softplus`` — and not
``torch.nn.functional.softplus``, which returns its input above 20; L2
``reg_param`` on w and V, the intercept unpenalized.  The loop makes no
host read.  Over a mesh (``fit(..., mesh=)``; one device is one shard of
``base.Shards``) the loss is a sum of per-shard terms (the penalty in
data shard 0's), each shard's value and gradient taken on its device and
added in ascending shard order.

A :class:`~..parallel.outofcore.HostDataset` trains by minibatch Adam,
one step a block, the blocks of each epoch in the order of
``default_rng(seed + 1).permutation``, ``max_iter`` epochs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..io.model_io import register_model
from ..parallel.outofcore import HostDataset, stream_home, stream_mesh
from ._opt import Adam, shard_value_and_grad
from .base import Estimator, Model, Shards, check_features, on_mesh


def fm_raw(w0, w, v, x):
    """(n,) FM response: bias + linear + ½((xV)² − x²V²)·1."""
    xv = x @ v
    x2v2 = (x * x) @ (v * v)
    return w0 + x @ w + 0.5 * torch.sum(xv * xv - x2v2, dim=1)


def fm_loss(x, y, wt, reg: float | None, loss: str, wsum=None):
    """The weighted mean loss plus reg·(‖w‖² + ‖V‖²) as a function of
    [w0, w, V]; ``wsum`` (default max(Σw, 1) of these rows) is the mean's
    divisor, a whole dataset's where these rows are one shard of it, and
    ``reg=None`` leaves the penalty out (a shard other than the first)."""
    if wsum is None:
        wsum = torch.clamp(wt.sum(), min=1.0)

    def loss_fn(params):
        w0, w, v = params
        raw = fm_raw(w0, w, v, x)
        if loss == "squared":
            r = raw - y
            per_row = r * r
        else:
            ypm = 2.0 * y - 1.0
            m = -ypm * raw
            per_row = torch.logaddexp(m, torch.zeros_like(m))
        data = torch.sum(per_row * wt) / wsum
        if reg is None:
            return data
        return data + float(np.float32(reg)) * (torch.sum(w * w) + torch.sum(v * v))

    return loss_fn


@register_model("FMModel")
@dataclass
class FMModel(Model):
    """``linear`` (d,) and ``factors`` (d, k) float32 tensors."""

    intercept: float
    linear: torch.Tensor
    factors: torch.Tensor
    task: str = "regression"      # "regression" | "classification"

    @property
    def factor_size(self) -> int:
        return int(self.factors.shape[1])

    @property
    def num_features(self) -> int:
        return int(self.linear.shape[0])

    def predict_raw(self, x: torch.Tensor) -> torch.Tensor:
        check_features(x, self.linear.shape[0], "FMModel")
        return fm_raw(float(np.float32(self.intercept)), self.linear.to(x.device),
                      self.factors.to(x.device), x.to(torch.float32))

    def predict_proba(self, x: torch.Tensor) -> torch.Tensor:
        if self.task != "classification":
            raise ValueError("predict_proba is classification-only")
        return torch.sigmoid(self.predict_raw(x))

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        raw = self.predict_raw(x)
        if self.task == "regression":
            return raw
        return (raw > 0).to(torch.float32)

    def _artifacts(self):
        return ("FMModel", {"intercept": float(self.intercept), "task": self.task},
                {"linear": self.linear.detach().cpu().numpy(),
                 "factors": self.factors.detach().cpu().numpy()})

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(intercept=float(params["intercept"]),
                   linear=torch.from_numpy(np.asarray(arrays["linear"], np.float32)),
                   factors=torch.from_numpy(np.asarray(arrays["factors"], np.float32)),
                   task=params.get("task", "regression"))


@dataclass(frozen=True)
class _FMParams:
    factor_size: int = 8          # Spark default
    max_iter: int = 100           # Spark default
    reg_param: float = 0.0
    step_size: float = 0.05       # full-batch Adam lr
    init_std: float = 0.01        # Spark default
    seed: int = 0
    label_col: str = "length_of_stay"
    features_col: str = "features"
    weight_col: str | None = None

    def _init(self, d: int, dev) -> list:
        rng = np.random.default_rng(self.seed)
        v = rng.normal(0, self.init_std, size=(d, self.factor_size)).astype(np.float32)
        return [torch.zeros((), dtype=torch.float32, device=dev),
                torch.zeros((d,), dtype=torch.float32, device=dev),
                torch.from_numpy(v).to(dev)]

    def _model(self, params: list, loss: str) -> FMModel:
        w0, w, v = params
        return FMModel(intercept=float(w0), linear=w, factors=v,
                       task="regression" if loss == "squared" else "classification")

    @staticmethod
    def _check_binary(yv: np.ndarray) -> None:
        uniq = np.unique(yv)
        if not np.all(np.isin(uniq, (0.0, 1.0))):
            raise ValueError(f"FMClassifier is binary (labels 0/1); got {uniq[:5]}")

    def _grad_fn(self, sh, loss: str):
        """The loss's (value, gradients) over the shards of ``sh``: each
        shard's mean term over the whole Σw on its device, the penalty in
        data shard 0's (:func:`~._opt.shard_value_and_grad`)."""
        f32 = torch.float32
        wsum = torch.clamp(sh.sum(lambda i, s: (s.w.to(f32).sum(),))[0], min=1.0)
        return shard_value_and_grad(sh.sum, lambda i, s: fm_loss(
            s.x.to(f32), s.y.to(f32), s.w.to(f32), self.reg_param if i == 0 else None, loss,
            wsum.to(s.x.device)))

    def _fit(self, data, label_col, device, mesh, loss: str) -> FMModel:
        if isinstance(data, HostDataset):
            return self._fit_outofcore(data, stream_mesh(mesh, device), loss)
        sh = Shards(on_mesh(data, label_col or self.label_col, device, self.weight_col, mesh))
        if self.factor_size < 1:
            raise ValueError(f"factor_size must be >= 1, got {self.factor_size}")
        if loss == "logistic":
            self._check_binary(sh.valid_labels())
        params = self._init(sh.n_features, sh.home)
        grad_fn = self._grad_fn(sh, loss)
        opt = Adam(params, self.step_size)
        for _ in range(self.max_iter):
            _, grads = grad_fn(params)
            params = opt.step(params, grads)
        return self._model(params, loss)

    def _fit_outofcore(self, hd: HostDataset, mesh, loss: str) -> FMModel:
        """Rows ≫ device memory: minibatch Adam over ``mesh``, one step a
        block (its gradient a shard at a time, summed), ``max_iter``
        epochs."""
        if hd.y is None:
            raise ValueError("FM fit needs labels: HostDataset(y=...)")
        if hd.n == 0 or hd.count() == 0.0:
            raise ValueError("FM fit on an empty dataset")
        if self.factor_size < 1:
            raise ValueError(f"factor_size must be >= 1, got {self.factor_size}")
        if loss == "logistic":
            w_host = np.asarray(hd.w) if hd.w is not None else np.ones(hd.n, np.float32)
            self._check_binary(np.asarray(hd.y)[w_host > 0])
        params = self._init(hd.n_features, stream_home(mesh))
        opt = Adam(params, self.step_size)
        n_blocks, _ = hd.block_shape(mesh)
        shuffle = np.random.default_rng(self.seed + 1)
        for _ in range(self.max_iter):
            for blk in hd.blocks(mesh, order=shuffle.permutation(n_blocks)):
                _, grads = self._grad_fn(Shards(blk), loss)(params)
                params = opt.step(params, grads)
        return self._model(params, loss)


@dataclass(frozen=True)
class FMRegressor(Estimator, _FMParams):
    def fit(self, data, label_col: str | None = None, device=None, mesh=None) -> FMModel:
        """Fit on ``device`` (default the card) or over ``mesh``."""
        return self._fit(data, label_col, device, mesh, "squared")


@dataclass(frozen=True)
class FMClassifier(Estimator, _FMParams):
    label_col: str = "LOS_binary"

    def fit(self, data, label_col: str | None = None, device=None, mesh=None) -> FMModel:
        """Fit on ``device`` (default the card) or over ``mesh``."""
        return self._fit(data, label_col, device, mesh, "logistic")


__all__ = ["FMClassifier", "FMModel", "FMRegressor", "fm_loss", "fm_raw"]
