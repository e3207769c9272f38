"""LogisticRegression — Newton/IRLS classifier on the device.

The JAX package's ``models/logistic_regression.py``: Spark's
``LogisticRegression`` (L2 ``reg_param`` on standardized coefficients,
the intercept unpenalized) fitted by damped Newton steps, binomial or,
for more than two classes (or ``family="multinomial"``), softmax.  The
reference script binarizes length of stay into ``LOS_binary``
(``mllearnforhospitalnetwork.py:176-198``), the label every classifier
here defaults to.

Each Newton step is one pass over the rows building the gradient and the
Hessian of the intercept-augmented design, summed per chunk of
``STAT_CHUNK`` rows and then over the chunks (``linear_regression.
chunked_gram``, as the reference's products are summed per device and
then ``psum``'d), then a small float32 solve (``solve_ex``: no host
sync).  The chunk is short because the stop compares the step with
``tol``: at the fixed point the step is the rounding of these sums, and
per 4,096-row chunk it sat above 1e-6 where the reference's sat below.  The reference's
``lax.while_loop`` stops on ``it < max_iter and dmax > tol``; here the
steps run ``NEWTON_CHUNK`` at a time on the device with a done flag that
freezes ``theta`` where the reference stops, and the host reads the flag
once a chunk, so ``n_iter`` equals the reference's.

The multinomial Hessian uses the reference's exact PSD factorization
``diag(p) − ppᵀ = BBᵀ`` with ``B = diag(√p) − p√pᵀ``: per chunk of rows,
``E[(n, c), (a, i)] = √wₙ·B[a, c]·xa[n, i]`` and ``H += EᵀE``.

The resident fit runs over data shards (``base.Shards``: one device is one
shard, ``fit(..., mesh=)`` or a ``ShardedDataset`` spread the rows over a
mesh): the standardization moments and, every Newton step, the (gradient,
Hessian) are computed once a data shard on its device against ``theta``
broadcast from the home device, summed in ascending shard order, and the
damped solve runs once on the home device.

A :class:`~..parallel.outofcore.HostDataset` streams its blocks, to one
device or over a mesh, through the same statistics once a Newton step
(each block's shards summed in ascending shard order, then the blocks),
after the moments pre-pass (``streamed_standardization`` over the same
shards), with one host read a step as in the reference; out-of-core fits
carry no training summary.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..io.model_io import register_model
from ..parallel.outofcore import (HostDataset, add_stats, shard_sum, stream_home, stream_mesh,
                                  streamed_standardization)
from ..parallel.collectives import gather_shards
from .base import Estimator, Model, PredictionResult, Shards, check_features, on_mesh
from .linear_regression import chunked_gram, shard_moments
from .summary import (
    BinaryLogisticRegressionTrainingSummary,
    MulticlassLogisticRegressionTrainingSummary,
    SummaryMixin,
)

#: Newton steps run on the device between two reads of the done flag
NEWTON_CHUNK = 4
#: rows summed by one partial product of a Newton step's statistics (on
#: 3,000-row parity inputs, 128 stops where the reference stops in 36 of 36
#: cases, 4,096 in 26)
STAT_CHUNK = 128


def row_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``aᵀb`` over the rows, per chunk of ``STAT_CHUNK`` rows and then
    over the chunks: a Newton step's gradient and Hessian."""
    return chunked_gram(a, b, STAT_CHUNK)


def newton_loop(step, theta: torch.Tensor, tol: float, max_iter: int):
    """The reference's ``while it < max_iter and dmax > tol: theta, dmax =
    step(theta)`` in chunks of ``NEWTON_CHUNK`` steps on the device: a done
    flag freezes ``theta`` at the step where the reference stops, and one
    host read a chunk returns the flag and the count.  ``tol`` is compared
    in float32, as the reference's ``jnp.float32(tol)``.
    → (theta, n_iter, host syncs)."""
    dev = theta.device
    tol32 = float(np.float32(tol))
    it = torch.zeros((), dtype=torch.int32, device=dev)
    dmax = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    n_iter, syncs = 0, 0
    for _ in range(0, max_iter, NEWTON_CHUNK):
        for _ in range(NEWTON_CHUNK):
            go = (it < max_iter) & (dmax > tol32)
            theta_new, dmax_new = step(theta)
            theta = torch.where(go, theta_new, theta)
            dmax = torch.where(go, dmax_new, dmax)
            it = it + go.to(torch.int32)
        more, n_iter = torch.stack([((it < max_iter) & (dmax > tol32)).to(torch.int32),
                                    it]).tolist()
        syncs += 1
        if not more:
            break
    return theta, n_iter, syncs


def streamed_newton_loop(hd: HostDataset, mesh, stats, update, theta: torch.Tensor,
                         tol: float, max_iter: int):
    """The out-of-core Newton loop over ``mesh`` (``outofcore.stream_mesh``:
    a device is its one-entry mesh): each step streams ``hd``'s blocks, runs
    ``stats(shard, theta)`` once a data shard of a block (``theta`` on the
    shard's device), sums the shards in ascending order and the blocks
    with ``add_stats``, then ``theta, dmax = update(theta, *sums)`` on
    ``theta``'s device; one host read of ``dmax`` a step, as in the
    reference.  → (theta, n_iter)."""
    it = 0
    for it in range(1, max_iter + 1):
        tot = None
        for blk in hd.blocks(mesh):
            s = shard_sum(blk, lambda i, sh: stats(sh, theta.to(sh.x.device)))
            tot = s if tot is None else add_stats(tot, s)
        theta, dmax = update(theta, *tot)
        if float(dmax) <= tol:
            break
    return theta, it


def with_intercept(x: torch.Tensor, fit_intercept: bool) -> torch.Tensor:
    """``x`` with a column of ones appended when the fit has an intercept."""
    if not fit_intercept:
        return x
    return torch.cat([x, torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)], dim=1)


def _logit_block_newton_stats(x, y, w, theta, fit_intercept: bool):
    """One block's (gradient, Hessian) at ``theta``: the resident step's
    per-row math (the IRLS weight floored at ``1e-10·w`` so the Hessian
    stays meaningful when p saturates), summed per chunk of rows."""
    xa = with_intercept(x.to(torch.float32), fit_intercept)
    y = y.to(torch.float32)
    w = w.to(torch.float32)
    p = torch.sigmoid(xa @ theta)
    grad = row_sums(xa, w * (p - y))
    r = torch.maximum(w * p * (1.0 - p), 1e-10 * w)
    hess = row_sums(xa * r[:, None], xa)
    return grad, hess


def _newton_update_from_stats(theta, grad, hess, ridge):
    """Summed (grad, hess) → the damped Newton step: ridge, a trace-scaled
    jitter (keeps the float32 solve finite under exact collinearity), and
    the step capped at 20 so separable data walks the margin out
    gradually.  → (theta, max |step|)."""
    d = theta.shape[0]
    grad = grad + ridge * theta
    hess = hess + torch.diag(ridge)
    jitter = 1e-6 * torch.trace(hess) / d + 1e-8
    eye = torch.eye(d, dtype=theta.dtype, device=theta.device)
    delta = torch.linalg.solve_ex(hess + jitter * eye, grad)[0]
    dmax = torch.max(torch.abs(delta))
    delta = delta * torch.clamp(20.0 / (dmax + 1e-30), max=1.0)
    return theta - delta, torch.max(torch.abs(delta))


def multinomial_chunk(k: int, dd: int) -> int:
    """Rows a multinomial Hessian chunk holds: its E factor is chunk·K²·D
    floats, so the chunk shrinks as K²·D grows (the reference's rule)."""
    return int(min(65536, max(256, (1 << 25) // max(1, k * k * dd))))


def _multinomial_block_stats(x, y, w, theta, num_classes: int, fit_intercept: bool,
                             chunk: int):
    """One block's softmax (gradient (K·D,), Hessian (K·D, K·D)) at
    ``theta``: per chunk of ``chunk`` rows the PSD factor E = √w·B⊗x, and
    EᵀE summed per chunk of its rows (:func:`row_sums`)."""
    k = num_classes
    xa = with_intercept(x.to(torch.float32), fit_intercept)
    w = w.to(torch.float32)
    yi = y.to(torch.int64)
    dd = xa.shape[1]
    kd = k * dd
    th = theta.reshape(k, dd)
    dev = xa.device
    classes = torch.arange(k, device=dev)
    eye_k = torch.eye(k, dtype=torch.float32, device=dev)
    g = torch.zeros((k, dd), dtype=torch.float32, device=dev)
    h = torch.zeros((kd, kd), dtype=torch.float32, device=dev)
    n = xa.shape[0]
    c = min(chunk, max(n, 1))
    for s in range(0, n, c):
        xc, yc, wc = xa[s:s + c], yi[s:s + c], w[s:s + c]
        p = torch.softmax(xc @ th.T, dim=1)                        # (C, K)
        yoh = (yc[:, None] == classes[None, :]).to(torch.float32)
        g = g + row_sums((p - yoh) * wc[:, None], xc)             # (K, D)
        sqp = torch.sqrt(p)
        b = sqp[:, :, None] * eye_k[None] - p[:, :, None] * sqp[:, None, :]   # b[n, a, c]
        e = torch.sqrt(wc)[:, None, None, None] * b[:, :, :, None] * xc[:, None, None, :]
        e2 = e.transpose(1, 2).reshape(-1, kd)                    # rows (n, c), cols (a, i)
        h = h + row_sums(e2, e2)
    return g.reshape(kd), h


def _newton_fit(sh, k: int | None, reg_param: float, tol: float, fit_intercept: bool,
                standardize: bool, max_iter: int, chunk: int = 0):
    """Damped Newton over the data shards of ``sh`` (``base.Shards``; one
    device is one shard): binomial for ``k=None``, else softmax over ``k``
    classes (Spark's ``family="multinomial"``: K coefficient vectors,
    standardized L2, intercepts unpenalized; the trace-scaled jitter pins
    the parameterization's null direction).  The standardization moments
    (→ the ridge) are summed in shard order, then every step's (gradient,
    Hessian) is computed a shard on its device against the broadcast
    ``theta``, summed, and solved on the home device.  → (coef (d,) or
    (K, d), intercept () or (K,), n_iter, host syncs), float32 on the home
    device."""
    f32 = torch.float32
    x = {i: s.x.to(f32) for i, s in sh.data.items()}
    y = {i: s.y.to(f32) for i, s in sh.data.items()}
    w = {i: s.w.to(f32) for i, s in sh.data.items()}
    n, _, std = shard_moments(sh)
    scale = std if standardize else torch.ones_like(std)
    nfeat = sh.n_features
    dd = nfeat + (1 if fit_intercept else 0)
    ridge = torch.zeros((dd,), dtype=f32, device=sh.home)
    ridge[:nfeat] = reg_param * n * scale * scale
    if k is not None:
        ridge = ridge.repeat(k)

        def stats(i, th):
            return _multinomial_block_stats(x[i], y[i], w[i], th, k, fit_intercept, chunk)
    else:
        def stats(i, th):
            return _logit_block_newton_stats(x[i], y[i], w[i], th, fit_intercept)

    def step(theta):
        th = sh.put(theta)
        g, h = sh.sum(lambda i, s: stats(i, th[i]))
        return _newton_update_from_stats(theta, g, h, ridge)

    theta0 = torch.zeros(((k or 1) * dd,), dtype=f32, device=sh.home)
    theta, n_iter, syncs = newton_loop(step, theta0, tol, max_iter)
    if k is None:
        intercept = theta[nfeat] if fit_intercept else torch.zeros((), device=sh.home)
        return theta[:nfeat], intercept, n_iter, syncs
    th = theta.reshape(k, dd)
    intercept = th[:, nfeat] if fit_intercept else torch.zeros((k,), device=sh.home)
    return th[:, :nfeat], intercept, n_iter, syncs


def _as_f32(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


@register_model("MultinomialLogisticRegressionModel")
@dataclass
class MultinomialLogisticRegressionModel(SummaryMixin, Model):
    """K-class softmax model: Spark's ``coefficientMatrix`` (K, d) and
    ``interceptVector`` (K,), float32 tensors."""

    coefficient_matrix: torch.Tensor
    intercept_vector: torch.Tensor
    n_iter: int = 0
    _summary: object | None = field(default=None, repr=False, compare=False)

    @property
    def num_classes(self) -> int:
        return int(self.coefficient_matrix.shape[0])

    def predict_raw(self, x: torch.Tensor) -> torch.Tensor:
        """(n, K) class margins."""
        check_features(x, self.coefficient_matrix.shape[1], "MultinomialLogisticRegressionModel")
        return (x.to(torch.float32) @ self.coefficient_matrix.to(x.device).T
                + self.intercept_vector.to(x.device)[None, :])

    def predict_proba(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.predict_raw(x), dim=1)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.predict_raw(x), dim=1).to(torch.float32)

    def _artifacts(self):
        return (
            "MultinomialLogisticRegressionModel",
            {"n_iter": self.n_iter},
            {"coefficient_matrix": self.coefficient_matrix.detach().cpu().numpy(),
             "intercept_vector": self.intercept_vector.detach().cpu().numpy()},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        """CPU float32 tensors; ``predict`` moves them to the rows' device."""
        return cls(coefficient_matrix=_as_f32(arrays["coefficient_matrix"]),
                   intercept_vector=_as_f32(arrays["intercept_vector"]),
                   n_iter=int(params.get("n_iter", 0)))


@register_model("LogisticRegressionModel")
@dataclass
class LogisticRegressionModel(SummaryMixin, Model):
    """Binomial model: ``coefficients`` (d,) and ``intercept`` (), float32
    tensors; ``predict`` is P(class 1) > ``threshold``."""

    coefficients: torch.Tensor
    intercept: torch.Tensor
    threshold: float = 0.5
    n_iter: int = 0
    _summary: object | None = field(default=None, repr=False, compare=False)

    def predict_raw(self, x: torch.Tensor) -> torch.Tensor:
        """Log-odds (Spark's rawPrediction margin)."""
        check_features(x, self.coefficients.shape[0], "LogisticRegressionModel")
        return x.to(torch.float32) @ self.coefficients.to(x.device) + self.intercept.to(x.device)

    def predict_proba(self, x: torch.Tensor) -> torch.Tensor:
        """P(class = 1)."""
        return torch.sigmoid(self.predict_raw(x))

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return (self.predict_proba(x) > self.threshold).to(torch.float32)

    def transform_proba(self, data, label_col: str | None = None, device=None,
                        mesh=None) -> PredictionResult:
        """Like ``transform``, with P(class 1) in the prediction column: the
        score ``BinaryClassificationEvaluator`` ranks (Spark's
        ``probability`` column); over a mesh, shard by shard."""
        return self._result(on_mesh(data, label_col, device, None, mesh), self.predict_proba)

    def _artifacts(self):
        return (
            "LogisticRegressionModel",
            {"threshold": self.threshold, "n_iter": self.n_iter},
            {"coefficients": self.coefficients.detach().cpu().numpy(),
             "intercept": self.intercept.detach().cpu().numpy()},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        """CPU float32 tensors; ``predict`` moves them to the rows' device."""
        return cls(coefficients=_as_f32(arrays["coefficients"]),
                   intercept=_as_f32(arrays["intercept"]),
                   threshold=float(params.get("threshold", 0.5)),
                   n_iter=int(params.get("n_iter", 0)))


def _family(family: str, num_classes: int) -> str:
    """Spark's rule: "auto" is binomial for at most 2 label values; a
    binomial fit on more is refused."""
    if family == "auto":
        return "binomial" if num_classes <= 2 else "multinomial"
    if family == "binomial" and num_classes > 2:
        raise ValueError(
            f"binomial family supports 1 or 2 outcome classes, found "
            f"{num_classes}; use family='multinomial'"
        )
    return family


@dataclass(frozen=True)
class LogisticRegression(Estimator):
    """``family`` mirrors Spark: "auto" picks binomial for ≤ 2 label values
    and multinomial otherwise; "binomial" / "multinomial" force the path.
    The multinomial fit returns a :class:`MultinomialLogisticRegressionModel`.
    ``model.fit_info["host_syncs"]`` counts the fit's host reads: the class
    count and one a chunk of Newton steps (out of core: the moments and
    one a step)."""

    features_col: str = "features"
    label_col: str = "LOS_binary"
    reg_param: float = 0.0
    max_iter: int = 100        # Spark default
    tol: float = 1e-6          # Spark default
    threshold: float = 0.5     # Spark default
    fit_intercept: bool = True
    standardize: bool = True
    family: str = "auto"       # Spark default
    weight_col: str | None = None

    #: ``fit`` runs over a mesh of more than one shard
    mesh_fit = True

    def fit(self, data, label_col: str | None = None, device=None, mesh=None):
        """Fit on ``data`` (DeviceDataset, ShardedDataset, AssembledTable,
        (x, y[, w])) on ``device`` (default the card) or over ``mesh``; a
        :class:`HostDataset` streams its blocks there."""
        if self.family not in ("auto", "binomial", "multinomial"):
            raise ValueError(f"family must be auto|binomial|multinomial, got {self.family!r}")
        if isinstance(data, HostDataset):
            return self._fit_outofcore(data, stream_mesh(mesh, device))
        ds = on_mesh(data, label_col or self.label_col, device, self.weight_col, mesh)
        sh = Shards(ds)
        # one host read: the class count is a shape parameter (and the
        # binomial-on-multiclass guard)
        tops: list = [None] * sh.D
        for i, s in sh.data.items():
            tops[i] = torch.where(s.w > 0, s.y, torch.zeros_like(s.y)).max().reshape(1)
        num_classes = int(torch.cat(gather_shards(tops, sh.mesh)).max()) + 1
        args = (float(self.reg_param), float(self.tol), self.fit_intercept, self.standardize,
                self.max_iter)
        if _family(self.family, num_classes) == "multinomial":
            k = max(num_classes, 2)
            dd = ds.n_features + (1 if self.fit_intercept else 0)
            coef, intercept, n_iter, syncs = _newton_fit(sh, k, *args, multinomial_chunk(k, dd))
            model = MultinomialLogisticRegressionModel(
                coefficient_matrix=coef, intercept_vector=intercept, n_iter=n_iter)
            model._summary = MulticlassLogisticRegressionTrainingSummary(model, ds)
        else:
            coef, intercept, n_iter, syncs = _newton_fit(sh, None, *args)
            model = LogisticRegressionModel(coefficients=coef, intercept=intercept,
                                            threshold=self.threshold, n_iter=n_iter)
            model._summary = BinaryLogisticRegressionTrainingSummary(model, ds)
        model.fit_info = {"host_syncs": syncs + 1}
        return model

    def _fit_outofcore(self, hd: HostDataset, mesh):
        """Rows ≫ device memory: each Newton step is one pass over the
        blocks on ``mesh`` summing the resident fit's (gradient, Hessian)
        a shard at a time, then the same damped solve on the home device;
        one host read of the step a pass, as in the reference.  No training
        summary (it would pin the whole dataset on the device)."""
        if hd.y is None:
            raise ValueError("LogisticRegression needs labels: HostDataset(y=...)")
        if hd.n == 0:
            raise ValueError("LogisticRegression fit on an empty dataset")
        # pass 0: the standardization moments (→ the ridge) and the class count
        dev = stream_home(mesh)
        n, _, std, ymax = streamed_standardization(hd, mesh, extra="ymax")
        scale = std if self.standardize else np.ones_like(std)
        num_classes = int(ymax) + 1
        family = _family(self.family, num_classes)
        nfeat = hd.n_features
        dd = nfeat + (1 if self.fit_intercept else 0)
        ridge1 = np.zeros((dd,), np.float32)
        ridge1[:nfeat] = self.reg_param * n * scale * scale

        if family == "multinomial":
            k = max(num_classes, 2)
            chunk = multinomial_chunk(k, dd)

            def stats(blk, theta):
                return _multinomial_block_stats(blk.x, blk.y, blk.w, theta, k,
                                                self.fit_intercept, chunk)

            ridge = torch.from_numpy(np.tile(ridge1, k)).to(dev)
        else:
            k = 1

            def stats(blk, theta):
                return _logit_block_newton_stats(blk.x, blk.y, blk.w, theta, self.fit_intercept)

            ridge = torch.from_numpy(ridge1).to(dev)
        theta, it = streamed_newton_loop(
            hd, mesh, stats, lambda th, g, h: _newton_update_from_stats(th, g, h, ridge),
            torch.zeros((k * dd,), dtype=torch.float32, device=dev), self.tol, self.max_iter)
        if family == "multinomial":
            th = theta.reshape(k, dd)
            model = MultinomialLogisticRegressionModel(
                coefficient_matrix=th[:, :nfeat],
                intercept_vector=(th[:, nfeat] if self.fit_intercept
                                  else torch.zeros((k,), device=dev)),
                n_iter=it)
        else:
            model = LogisticRegressionModel(
                coefficients=theta[:nfeat],
                intercept=theta[nfeat] if self.fit_intercept else torch.zeros((), device=dev),
                threshold=self.threshold, n_iter=it)
        model.fit_info = {"host_syncs": it + 1}
        return model


__all__ = [
    "LogisticRegression", "LogisticRegressionModel", "MultinomialLogisticRegressionModel",
    "multinomial_chunk", "newton_loop", "streamed_newton_loop",
]
