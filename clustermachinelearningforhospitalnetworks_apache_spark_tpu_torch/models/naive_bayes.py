"""NaiveBayes — multinomial, bernoulli, complement and gaussian.

The JAX package's ``models/naive_bayes.py``: Spark 3.x's ``modelType``
surface — "multinomial" (Spark's default, Laplace ``smoothing``),
"bernoulli" (0/1 features), "complement" (Rennie's CNB, sklearn's
``ComplementNB(norm=False)``) and "gaussian".  Priors follow Spark:
``log(n_c + λ) − log(n + kλ)`` for the discrete types, unsmoothed for
gaussian.

The per-class statistics are one pass on the device: the one-hot product
``onehotᵀ·x`` as the reference takes it, summed per chunk of rows and then
over the chunks (``chunked_gram``) in a fixed order, never ``index_add_``
(whose order on the card varies from run to run).  Features of w = 0 rows
are masked before any product, so a NaN in such a row stays inert.  The
small (k, d) finish runs on the host in float64.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..data import DeviceDataset
from ..device import resolve_device
from ..io.model_io import register_model
from ..parallel.outofcore import HostDataset, add_stats, block_moments
from .base import Estimator, Model, as_device_dataset, check_features
from .linear_regression import chunked_gram

MODEL_TYPES = ("multinomial", "bernoulli", "complement", "gaussian")


def _onehot(y: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """(n, k) one-hot of the integer labels times the weights (a label
    outside 0..k−1 gives a zero row, as ``jax.nn.one_hot``)."""
    classes = torch.arange(k, device=y.device)
    return (y.to(torch.int64)[:, None] == classes[None, :]).to(torch.float32) * w[:, None]


def _masked(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.where(w[:, None] > 0, x, torch.zeros_like(x))


def _count_sums(x, y, w, k: int, binary: bool = False):
    """Per-class weighted (count (k,), Σx (k, d)) and a bad-feature flag
    (a device bool): features not exactly 0/1 for bernoulli, else
    negative or NaN (``~(x >= 0)`` catches both)."""
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    onehot = _onehot(y, w, k)
    xm = _masked(x, w)
    counts = onehot.sum(dim=0)
    s1 = chunked_gram(onehot, xm)
    if binary:
        bad = (~((xm == 0.0) | (xm == 1.0))).any()
    else:
        bad = (~(xm >= 0)).any()
    return counts, s1, bad


def _gaussian_stats_centered(x, y, w, k: int, gmean: torch.Tensor):
    """Per-class weighted (count, Σxc, Σxc²) at a fixed center: the
    per-block half of :func:`_gaussian_stats` for out-of-core fits."""
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    xc = _masked(x, w) - gmean[None, :]
    onehot = _onehot(y, w, k)
    return onehot.sum(dim=0), chunked_gram(onehot, xc), chunked_gram(onehot, xc * xc)


def _gaussian_stats(x, y, w, k: int):
    """Per-class weighted (count, Σxc, Σxc²) of globally centered features,
    and the center: centering keeps E[x²] − mean² out of float32 for
    features whose mean dwarfs their spread."""
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    n = torch.clamp(w.sum(), min=1.0)
    gmean = (_masked(x, w) * w[:, None]).sum(dim=0) / n
    return (*_gaussian_stats_centered(x, y, w, k, gmean), gmean)


@register_model("NaiveBayesModel")
@dataclass
class NaiveBayesModel(Model):
    """``pi`` (k,) log priors, ``theta`` (k, d) (log P(feature | class),
    means or complement weights), ``sigma`` (k, d) variances (gaussian),
    ``theta2`` (k, d) log(1 − p) (bernoulli); host numpy, as in the JAX
    package."""

    model_type: str
    pi: np.ndarray
    theta: np.ndarray
    sigma: np.ndarray | None = None
    theta2: np.ndarray | None = None

    @property
    def num_classes(self) -> int:
        return self.pi.shape[0]

    def predict_raw(self, x: torch.Tensor) -> torch.Tensor:
        """(n, k) joint log-likelihoods (Spark's rawPrediction)."""
        check_features(x, self.theta.shape[1], "NaiveBayesModel")
        x = x.to(torch.float32)

        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32), device=x.device)

        pi, th = t(self.pi), t(self.theta)
        if self.model_type == "multinomial":
            return x @ th.T + pi[None, :]
        if self.model_type == "bernoulli":
            # Σ x log p + (1−x) log(1−p) = x·(log p − log(1−p)) + Σ log(1−p),
            # on inputs binarized at 0 (sklearn BernoulliNB(binarize=0.0);
            # negatives and NaN map to 0)
            xb = (x > 0.0).to(torch.float32)
            th2 = t(self.theta2)
            return xb @ (th - th2).T + (pi + th2.sum(dim=1))[None, :]
        if self.model_type == "complement":
            # Rennie's CNB scores by the complement weights; priors do not
            # enter the multiclass argmax (sklearn ComplementNB)
            return x @ th.T
        var = t(self.sigma)
        # Σ_d −½log(2πσ²) − (x−μ)²/(2σ²) expanded into products, every term
        # shifted by the across-class mean first so that x² of a large raw
        # feature does not burn the float32 mantissa
        ref = th.mean(dim=0)
        xc = x - ref[None, :]
        thc = th - ref[None, :]
        const = pi - 0.5 * torch.log(2.0 * np.pi * var).sum(dim=1)
        inv = 1.0 / var
        quad = ((xc * xc) @ inv.T - 2.0 * xc @ (thc * inv).T
                + (thc * thc * inv).sum(dim=1)[None, :])
        return const[None, :] - 0.5 * quad

    def predict_proba(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.predict_raw(x), dim=1)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.predict_raw(x), dim=1).to(torch.float32)

    def _artifacts(self):
        arrays = {"pi": np.asarray(self.pi), "theta": np.asarray(self.theta)}
        if self.sigma is not None:
            arrays["sigma"] = np.asarray(self.sigma)
        if self.theta2 is not None:
            arrays["theta2"] = np.asarray(self.theta2)
        return ("NaiveBayesModel", {"model_type": self.model_type}, arrays)

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(model_type=params["model_type"], pi=arrays["pi"], theta=arrays["theta"],
                   sigma=arrays.get("sigma"), theta2=arrays.get("theta2"))


@dataclass(frozen=True)
class NaiveBayes(Estimator):
    model_type: str = "multinomial"   # Spark's default
    smoothing: float = 1.0            # Laplace λ (the discrete types)
    var_smoothing: float = 1e-9       # gaussian variance floor, sklearn's
    label_col: str = "LOS_binary"
    features_col: str = "features"
    weight_col: str | None = None

    def fit(self, data, label_col: str | None = None, device=None) -> NaiveBayesModel:
        """One pass of per-class statistics on ``device`` (default the
        card); a :class:`HostDataset` streams its blocks to ``device``."""
        if self.model_type not in MODEL_TYPES:
            raise ValueError(
                "model_type must be multinomial|bernoulli|complement|"
                f"gaussian, got {self.model_type!r}")
        if isinstance(data, HostDataset):
            return self._fit_outofcore(data, resolve_device(device))
        ds: DeviceDataset = as_device_dataset(
            data, label_col or self.label_col, device=device, weight_col=self.weight_col)
        # one host read: the class count (a shape), 0 when no row is valid
        k = int(torch.where(ds.w > 0, ds.y, torch.full_like(ds.y, -1.0)).max()) + 1
        k = max(k, 1)
        if self.model_type != "gaussian":
            counts, s1, bad = _count_sums(ds.x, ds.y, ds.w, k,
                                          binary=self.model_type == "bernoulli")
            flat = torch.cat([bad.to(torch.float32).reshape(1), counts,
                              s1.reshape(-1)]).cpu().numpy().astype(np.float64)
            if flat[0] > 0:
                self._raise_bad_features()
            return self._finalize_discrete(flat[1:1 + k], flat[1 + k:].reshape(k, -1), k)
        stats = _gaussian_stats(ds.x, ds.y, ds.w, k)
        return self._finalize_gaussian(*_host64(stats, k))

    def _raise_bad_features(self):
        if self.model_type == "bernoulli":
            raise ValueError(
                "bernoulli NaiveBayes requires 0/1 features; "
                "binarize first (features/binarizer.py)")
        raise ValueError(
            f"{self.model_type} NaiveBayes requires non-negative, "
            "non-NaN features (counts); use model_type='gaussian' "
            "for real-valued data")

    def _finalize_discrete(self, counts: np.ndarray, s1: np.ndarray, k: int):
        """(counts, Σx) → model, for the resident and out-of-core fits."""
        sm = self.smoothing
        pi = np.log(counts + sm) - np.log(counts.sum() + k * sm)
        if self.model_type == "multinomial":
            theta = np.log((s1 + sm) / (s1.sum(axis=1, keepdims=True) + sm * s1.shape[1]))
            return NaiveBayesModel("multinomial", pi, theta)
        if self.model_type == "bernoulli":
            # P(f = 1 | c) = (rows of c with f + λ) / (n_c + 2λ)
            p = (s1 + sm) / (counts[:, None] + 2.0 * sm)
            return NaiveBayesModel("bernoulli", pi, np.log(p), theta2=np.log1p(-p))
        # complement: per class, the feature mass of every other class's rows
        comp = s1.sum(axis=0, keepdims=True) - s1 + sm
        theta = -(np.log(comp) - np.log(comp.sum(axis=1, keepdims=True)))
        return NaiveBayesModel("complement", pi, theta)

    def _finalize_gaussian(self, counts, s1c, s2c, gmean):
        # gaussian priors are unsmoothed (Spark's trainGaussianImpl, sklearn)
        pi = np.log(np.maximum(counts, 1e-300) / max(counts.sum(), 1e-300))
        nk = np.maximum(counts[:, None], 1e-12)
        mean_c = s1c / nk
        var = s2c / nk - mean_c * mean_c
        if not np.isfinite(mean_c).all() or not np.isfinite(var).all():
            raise ValueError(
                "gaussian NaiveBayes saw NaN/Inf features; clean or impute "
                "first (features/imputer.py)")
        # sklearn's floor: a portion of the largest variance
        floor = self.var_smoothing * max(float(var.max()), 1e-12)
        var = np.maximum(var, floor)
        return NaiveBayesModel("gaussian", pi, mean_c + gmean[None, :], var)

    def _fit_outofcore(self, hd: HostDataset, dev) -> NaiveBayesModel:
        """Rows ≫ device memory: the same per-class statistics summed block
        by block (the bad-feature flag summed on the device, read once);
        gaussian takes two passes, the global mean and then the centered
        per-class sums."""
        if hd.y is None:
            raise ValueError("NaiveBayes needs labels: HostDataset(y=...)")
        if hd.n == 0:
            raise ValueError("NaiveBayes fit on an empty dataset")
        y_host = np.asarray(hd.y)
        w_host = np.asarray(hd.w) if hd.w is not None else np.ones(hd.n, np.float32)
        if not np.any(w_host > 0):
            raise ValueError("NaiveBayes fit with no positively-weighted rows")
        k = int(y_host[w_host > 0].max()) + 1

        if self.model_type != "gaussian":
            tot = None
            for blk in hd.blocks(device=dev):
                counts, s1, bad = _count_sums(blk.x, blk.y, blk.w, k,
                                              binary=self.model_type == "bernoulli")
                s = (counts, s1, bad.to(torch.float32))
                tot = s if tot is None else add_stats(tot, s)
            flat = torch.cat([tot[2].reshape(1), tot[0], tot[1].reshape(-1)]) \
                .cpu().numpy().astype(np.float64)
            if flat[0] > 0:
                self._raise_bad_features()
            return self._finalize_discrete(flat[1:1 + k], flat[1 + k:].reshape(k, -1), k)

        mtot = None
        for blk in hd.blocks(device=dev):
            s = block_moments(blk.x, blk.y, blk.w)
            mtot = s if mtot is None else add_stats(mtot, s)
        gmean = mtot[1] / torch.clamp(mtot[0], min=1.0)
        tot = None
        for blk in hd.blocks(device=dev):
            s = _gaussian_stats_centered(blk.x, blk.y, blk.w, k, gmean)
            tot = s if tot is None else add_stats(tot, s)
        return self._finalize_gaussian(*_host64((*tot, gmean), k))


def _host64(stats, k: int):
    """(counts (k,), s1c (k, d), s2c (k, d), gmean (d,)) in one copy to the
    host, as float64."""
    counts, s1c, s2c, gmean = stats
    d = gmean.shape[0]
    flat = torch.cat([counts, s1c.reshape(-1), s2c.reshape(-1), gmean]).cpu().numpy() \
        .astype(np.float64)
    return (flat[:k], flat[k:k + k * d].reshape(k, d),
            flat[k + k * d:k + 2 * k * d].reshape(k, d), flat[k + 2 * k * d:])


__all__ = ["NaiveBayes", "NaiveBayesModel"]
