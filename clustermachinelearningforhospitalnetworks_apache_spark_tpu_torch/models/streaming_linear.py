"""StreamingLinearRegression / StreamingLogisticRegression — incremental
supervised learners over micro-batches (the JAX package's
``models/streaming_linear.py``; Spark's ``StreamingLinearRegressionWithSGD``
/ ``StreamingLogisticRegressionWithSGD`` surface).

- **Linear**: decayed recursive least squares.  Each batch adds its
  Gram, moments and weight sum (``linear_regression.chunked_gram``) to
  the running state decayed by ``decay_factor``; the state starts at
  zero, so the first batch is exact (a·0 + g = g).  At decay 1.0 the
  model after N batches is the normal-equation fit of all rows seen.
  An update makes no host read; ``latest_model`` solves with a ridge of
  ``reg_param·max(Σw, 1)`` (intercept unpenalized) + 1e-6.
- **Logistic**: decayed Newton statistics around the current estimate:
  each batch contributes its gradient and Hessian at θ, the history
  decays, and ``newton_steps_per_batch`` damped solves (jitter
  ``1e-6·tr/d + 1e-8``, the step capped at 20) update θ.  One host read
  a batch: its weight sum, for the ridge, as in the reference.

Over a mesh (``update(batch, mesh=)``) a host batch is laid over the
data axis when every shard gets at least 65,536 rows (the reference's
``microbatch_mesh`` at its default threshold), else it runs on the mesh's
first device; the batch statistics (Gram and moments, or the Newton
gradient and Hessian) are computed once a data shard on its device and
summed in ascending shard order (``collectives.aggregate_shards``), and
the state lives on the home device (``_place_state``).  One shard keeps
the one-device bits.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .base import Shards, stream_batch
from .linear_regression import LinearRegressionModel, chunked_gram
from .logistic_regression import LogisticRegressionModel, row_sums, with_intercept


def lin_batch_stats(x, y, w):
    """A batch's (XᵀWX, XᵀWy, Σw) with the intercept column appended."""
    xa = with_intercept(x.to(torch.float32), True)
    xw = xa * w.to(torch.float32)[:, None]
    return chunked_gram(xw, xa), chunked_gram(xw, y.to(torch.float32)), torch.sum(w)


def logit_batch_stats(x, y, w, theta):
    """A batch's Newton (gradient, Hessian) at θ (the batch fit's per-row
    math)."""
    xa = with_intercept(x.to(torch.float32), True)
    y = y.to(torch.float32)
    w = w.to(torch.float32)
    p = torch.sigmoid(xa @ theta)
    grad = row_sums(xa, w * (p - y))
    r = torch.maximum(w * p * (1.0 - p), 1e-10 * w)
    return grad, row_sums(xa * r[:, None], xa)


def _on(dev, *state) -> tuple:
    """The state on the batch's home device (a state carried across from
    the JAX package starts on the CPU)."""
    return tuple(None if t is None else t.to(dev) for t in state)


def _decay_ok(decay: float) -> None:
    if not 0.0 <= decay <= 1.0:
        raise ValueError(f"decay_factor must be in [0, 1], got {decay}")


@dataclass
class StreamingLinearRegression:
    """``update(batch)`` per micro-batch; ``latest_model`` is a
    :class:`LinearRegressionModel`."""

    decay_factor: float = 1.0
    reg_param: float = 0.0
    label_col: str = "length_of_stay"

    _gram: object = field(default=None, repr=False)
    _mom: object = field(default=None, repr=False)
    _wsum: object = field(default=None, repr=False)
    _n_batches: int = field(default=0, repr=False)

    def __post_init__(self):
        _decay_ok(self.decay_factor)

    @property
    def n_batches(self) -> int:
        return self._n_batches

    def _init_state(self, d: int, dev) -> None:
        self._gram = torch.zeros((d, d), dtype=torch.float32, device=dev)
        self._mom = torch.zeros((d,), dtype=torch.float32, device=dev)
        self._wsum = torch.zeros((), dtype=torch.float32, device=dev)

    def _accumulate(self, g, m, ws) -> None:
        a = float(np.float32(self.decay_factor))
        self._gram = a * self._gram + g
        self._mom = a * self._mom + m
        self._wsum = a * self._wsum + ws
        self._n_batches += 1

    def update(self, batch, mesh=None, device=None) -> "StreamingLinearRegression":
        """Fold one micro-batch (DeviceDataset, ShardedDataset,
        AssembledTable, (x, y[, w])) into the state on ``device`` (default
        the card), or over ``mesh`` (module docstring)."""
        sh = Shards(stream_batch(batch, self.label_col, device=device, mesh=mesh))
        if self._gram is None:
            self._init_state(sh.n_features + 1, sh.home)
        self._place_state(sh)
        self._accumulate(*sh.sum(lambda i, s: lin_batch_stats(s.x, s.y, s.w)))
        return self

    def _place_state(self, sh: Shards) -> None:
        self._gram, self._mom, self._wsum = _on(sh.home, self._gram, self._mom, self._wsum)

    def absorb_partials(self, merged) -> "StreamingLinearRegression":
        """Fold merged federated ``linear`` partials (an object with
        ``family`` and ``stats`` {"gram", "mom", "sw"}) into the state as
        one micro-batch."""
        if merged.family != "linear":
            raise ValueError(f"absorb_partials folds 'linear' partials, got "
                             f"{merged.family!r}")
        dev = self._gram.device if self._gram is not None else torch.device("cpu")
        g = torch.as_tensor(np.asarray(merged.stats["gram"], np.float32), device=dev)
        m = torch.as_tensor(np.asarray(merged.stats["mom"], np.float32), device=dev)
        ws = torch.tensor(np.float32(np.asarray(merged.stats["sw"])), device=dev)
        if g.shape[0] != m.shape[0]:
            raise ValueError("merged gram/mom shapes disagree")
        if self._gram is None:
            self._init_state(g.shape[0], dev)
        self._accumulate(g, m, ws)
        return self

    @property
    def latest_model(self) -> LinearRegressionModel:
        if self._gram is None:
            raise RuntimeError("no batches seen yet — call update() first")
        d = self._gram.shape[0]
        ridge = self.reg_param * max(float(self._wsum), 1.0)
        reg = torch.zeros((d,), dtype=torch.float32, device=self._gram.device)
        reg[:-1] = ridge
        reg = reg + 1e-6
        theta = torch.linalg.solve_ex(self._gram + torch.diag(reg), self._mom)[0].cpu()
        return LinearRegressionModel(coefficients=theta[:-1], intercept=theta[-1])


@dataclass
class StreamingLogisticRegression:
    """``update(batch)`` per micro-batch: each batch's Newton statistics
    at the current θ join the decayed history, then
    ``newton_steps_per_batch`` damped steps."""

    decay_factor: float = 1.0
    reg_param: float = 0.0
    newton_steps_per_batch: int = 1
    label_col: str = "LOS_binary"
    threshold: float = 0.5

    _theta: object = field(default=None, repr=False)
    _grad_hist: object = field(default=None, repr=False)
    _hess_hist: object = field(default=None, repr=False)
    _wsum: float = field(default=0.0, repr=False)
    _n_batches: int = field(default=0, repr=False)

    def __post_init__(self):
        _decay_ok(self.decay_factor)
        if self.newton_steps_per_batch < 1:
            raise ValueError("newton_steps_per_batch must be >= 1")

    @property
    def n_batches(self) -> int:
        return self._n_batches

    def update(self, batch, mesh=None, device=None) -> "StreamingLogisticRegression":
        """Fold one micro-batch into the state on ``device`` (default the
        card), or over ``mesh`` (module docstring); one host read (the
        batch's weight sum)."""
        sh = Shards(stream_batch(batch, self.label_col, device=device, mesh=mesh))
        d = sh.n_features + 1
        dev = sh.home
        if self._theta is None:
            self._theta = torch.zeros((d,), dtype=torch.float32, device=dev)
        self._place_state(sh)
        a = float(np.float32(self.decay_factor))
        w_batch = sh.count()
        eye = torch.eye(d, dtype=torch.float32, device=dev)

        def stats():
            theta = sh.put(self._theta)
            return sh.sum(lambda i, s: logit_batch_stats(s.x, s.y, s.w, theta[i]))

        for _ in range(self.newton_steps_per_batch):
            g, h = stats()
            if self._grad_hist is None:
                grad_tot, hess_tot = g, h
            else:
                grad_tot = a * self._grad_hist + g
                hess_tot = a * self._hess_hist + h
            ridge = self.reg_param * max(self.decay_factor * self._wsum + w_batch, 1.0)
            reg = torch.zeros((d,), dtype=torch.float32, device=dev)
            reg[:-1] = ridge
            grad_tot = grad_tot + reg * self._theta
            hess_r = hess_tot + torch.diag(reg)
            jitter = 1e-6 * torch.trace(hess_r) / d + 1e-8
            delta = torch.linalg.solve_ex(hess_r + jitter * eye, grad_tot)[0]
            dmax = torch.max(torch.abs(delta))
            delta = delta * torch.clamp(20.0 / (dmax + 1e-30), max=1.0)
            self._theta = self._theta - delta
        # the history takes this batch's statistics at its last θ
        g, h = stats()
        if self._grad_hist is None:
            self._grad_hist, self._hess_hist = g, h
        else:
            self._grad_hist = a * self._grad_hist + g
            self._hess_hist = a * self._hess_hist + h
        self._wsum = self.decay_factor * self._wsum + w_batch
        self._n_batches += 1
        return self

    def _place_state(self, sh: Shards) -> None:
        self._theta, self._grad_hist, self._hess_hist = _on(
            sh.home, self._theta, self._grad_hist, self._hess_hist)

    @property
    def latest_model(self) -> LogisticRegressionModel:
        if self._theta is None:
            raise RuntimeError("no batches seen yet — call update() first")
        theta = self._theta.cpu()
        return LogisticRegressionModel(coefficients=theta[:-1], intercept=theta[-1],
                                       threshold=self.threshold, n_iter=self._n_batches)


__all__ = ["StreamingLinearRegression", "StreamingLogisticRegression", "lin_batch_stats",
           "logit_batch_stats"]
