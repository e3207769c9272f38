"""MultilayerPerceptronClassifier — feedforward net, Spark's topology.

The JAX package's ``models/mlp.py`` (Spark's
``MultilayerPerceptronClassifier``): ``layers=[d, h₁, …, C]``, sigmoid
hidden layers, softmax output on the weighted cross-entropy, Glorot
initial weights from numpy ``default_rng(seed)`` (bit-equal to the
reference's), trained by full-batch L-BFGS (``models/_opt.py``: the
reference's ``optax.lbfgs`` steps and its ``|Δloss| ≤ tol·max(|loss|, 1)``
stop).  Gradients come from autograd; pad rows carry w = 0.  Over a mesh
(``fit(..., mesh=)``; one device is one shard of ``base.Shards``) the
loss is a sum of per-shard terms, each shard's value and gradient taken
on its device and added in ascending shard order.

A :class:`~..parallel.outofcore.HostDataset` trains by minibatch Adam
(lr 1e-2), one step a block, the blocks of each epoch in the order of
``default_rng(seed + 1).permutation``, stopping when the mean epoch loss
moves by at most ``tol`` (one host read an epoch).  ``model.fit_info``
holds ``n_iter`` (epochs out of core), the final loss, and the resident
fit's loss evaluations and host reads.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..io.model_io import register_model
from ..parallel.outofcore import HostDataset, stream_home, stream_mesh
from ._opt import Adam, lbfgs_minimize, shard_value_and_grad
from .base import Estimator, Model, Shards, check_features, on_mesh


def init_params(layers: tuple, seed: int, device) -> list:
    """Glorot-uniform weights and zero biases, [W0, b0, W1, b1, …]."""
    rng = np.random.default_rng(seed)
    params = []
    for fan_in, fan_out in zip(layers[:-1], layers[1:]):
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        params.append(torch.from_numpy(
            rng.uniform(-lim, lim, size=(fan_in, fan_out)).astype(np.float32)).to(device))
        params.append(torch.zeros((fan_out,), dtype=torch.float32, device=device))
    return params


def forward(params: list, x: torch.Tensor) -> torch.Tensor:
    """Sigmoid hidden layers, raw logits out; ``params`` = [W0, b0, …]."""
    h = x
    n = len(params) // 2
    for i in range(n - 1):
        h = torch.sigmoid(h @ params[2 * i] + params[2 * i + 1][None, :])
    return h @ params[-2] + params[-1][None, :]


def mlp_loss(x, y, w, wsum=None):
    """Weighted mean cross-entropy of the softmax over ``forward``'s logits,
    as a function of the parameter list; ``wsum`` (default max(Σw, 1) of
    these rows) is the mean's divisor, a whole dataset's where these rows
    are one shard of it."""
    yi = y.to(torch.int64)
    if wsum is None:
        wsum = torch.clamp(w.sum(), min=1.0)

    def loss_fn(params):
        ll = torch.log_softmax(forward(params, x), dim=1)
        nll = -torch.gather(ll, 1, yi[:, None])[:, 0]
        return torch.sum(nll * w) / wsum

    return loss_fn


def mlp_grad_fn(sh):
    """The loss's (value, gradients) over the shards of ``sh``
    (``base.Shards``): each shard's mean term over the whole Σw on its
    device, summed in ascending shard order
    (:func:`~._opt.shard_value_and_grad`)."""
    f32 = torch.float32
    wsum = torch.clamp(sh.sum(lambda i, s: (s.w.to(f32).sum(),))[0], min=1.0)
    return shard_value_and_grad(sh.sum, lambda i, s: mlp_loss(
        s.x.to(f32), s.y, s.w.to(f32), wsum.to(s.x.device)))


def _check_labels(valid: np.ndarray, n_out: int) -> None:
    if valid.size and ((valid < 0).any() or (valid >= n_out).any()
                       or not np.allclose(valid, np.round(valid))):
        bad = valid[(valid < 0) | (valid >= n_out) | ~np.isclose(valid, np.round(valid))]
        raise ValueError(f"labels must be integers in [0, layers[-1]={n_out}); got "
                         f"{np.unique(bad)[:5]}")


@register_model("MultilayerPerceptronModel")
@dataclass
class MultilayerPerceptronModel(Model):
    """``weights`` = [(W, b), …], float32 tensors."""

    weights: list
    layers: tuple = ()

    @property
    def num_classes(self) -> int:
        return int(self.layers[-1])

    @property
    def num_features(self) -> int:
        return int(self.layers[0])

    def predict_raw(self, x: torch.Tensor) -> torch.Tensor:
        check_features(x, int(self.layers[0]), "MultilayerPerceptronModel")
        flat = [t.to(x.device) for wb in self.weights for t in wb]
        return forward(flat, x.to(torch.float32))

    def predict_proba(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.predict_raw(x), dim=1)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.predict_raw(x), dim=1).to(torch.float32)

    def _artifacts(self):
        arrays = {}
        for i, (w, b) in enumerate(self.weights):
            arrays[f"w{i}"] = w.detach().cpu().numpy()
            arrays[f"b{i}"] = b.detach().cpu().numpy()
        return "MultilayerPerceptronModel", {"layers": [int(v) for v in self.layers]}, arrays

    @classmethod
    def from_artifacts(cls, params, arrays):
        layers = tuple(int(v) for v in params["layers"])
        weights = [(torch.from_numpy(np.asarray(arrays[f"w{i}"], np.float32)),
                    torch.from_numpy(np.asarray(arrays[f"b{i}"], np.float32)))
                   for i in range(len(layers) - 1)]
        return cls(weights=weights, layers=layers)


@dataclass(frozen=True)
class MultilayerPerceptronClassifier(Estimator):
    """Spark defaults: maxIter 100, tol 1e-6, solver "l-bfgs".  ``layers``
    names the whole topology [input, hidden…, output]; the output width is
    the class count."""

    layers: tuple = ()
    max_iter: int = 100
    tol: float = 1e-6
    seed: int = 0
    solver: str = "l-bfgs"
    label_col: str = "LOS_binary"
    features_col: str = "features"
    weight_col: str | None = None

    def _model(self, params: list, info: dict) -> MultilayerPerceptronModel:
        model = MultilayerPerceptronModel(
            weights=[(params[i], params[i + 1]) for i in range(0, len(params), 2)],
            layers=tuple(int(v) for v in self.layers))
        model.fit_info = info
        return model

    def fit(self, data, label_col: str | None = None, device=None, mesh=None):
        """Fit on ``data`` (DeviceDataset, ShardedDataset, AssembledTable,
        (x, y[, w])) on ``device`` (default the card) or over ``mesh``; a
        :class:`HostDataset` streams its blocks there."""
        if self.solver != "l-bfgs":
            raise ValueError(f"solver must be 'l-bfgs' (Spark's default and the only one "
                             f"implemented); got {self.solver!r}")
        if len(self.layers) < 2:
            raise ValueError(f"layers must name [input, hidden..., output] widths; got "
                             f"{self.layers}")
        if isinstance(data, HostDataset):
            return self._fit_outofcore(data, stream_mesh(mesh, device))
        sh = Shards(on_mesh(data, label_col or self.label_col, device, self.weight_col, mesh))
        d_in, n_out = int(self.layers[0]), int(self.layers[-1])
        if sh.n_features != d_in:
            raise ValueError(f"layers[0]={d_in} but the data has {sh.n_features} features")
        _check_labels(sh.valid_labels(), n_out)
        params = init_params(tuple(int(v) for v in self.layers), self.seed, sh.home)
        params, loss, n_iter, opt = lbfgs_minimize(None, params, self.max_iter, self.tol,
                                                   mlp_grad_fn(sh))
        return self._model(params, {"n_iter": n_iter, "loss": float(loss),
                                    "evaluations": opt.evaluations,
                                    "host_reads": opt.host_reads})

    def _fit_outofcore(self, hd: HostDataset, mesh):
        """Rows ≫ device memory: minibatch Adam over ``mesh``, one step a
        block (its gradient a shard at a time, summed), until the mean
        epoch loss stops moving by more than ``tol`` or ``max_iter``
        epochs."""
        if hd.y is None:
            raise ValueError("MultilayerPerceptronClassifier needs labels: HostDataset(y=...)")
        if hd.n == 0 or hd.count() == 0.0:
            raise ValueError("MultilayerPerceptronClassifier fit on an empty dataset")
        d_in, n_out = int(self.layers[0]), int(self.layers[-1])
        if hd.n_features != d_in:
            raise ValueError(f"layers[0]={d_in} but the data has {hd.n_features} features")
        w_host = np.asarray(hd.w) if hd.w is not None else np.ones(hd.n, np.float32)
        _check_labels(np.asarray(hd.y)[w_host > 0], n_out)
        params = init_params(tuple(int(v) for v in self.layers), self.seed, stream_home(mesh))
        opt = Adam(params, 1e-2)
        prev = np.inf
        n_blocks, _ = hd.block_shape(mesh)
        shuffle = np.random.default_rng(self.seed + 1)
        epochs = 0
        cur = 0.0
        for _ in range(self.max_iter):
            losses = []
            for blk in hd.blocks(mesh, order=shuffle.permutation(n_blocks)):
                loss, grads = mlp_grad_fn(Shards(blk))(params)
                params = opt.step(params, grads)
                losses.append(loss)
            epochs += 1
            # one host read an epoch: the blocks' losses, averaged in float64
            cur = float(np.mean(torch.stack(losses).tolist())) if losses else 0.0
            if abs(prev - cur) <= self.tol:
                break
            prev = cur
        return self._model(params, {"n_iter": epochs, "loss": cur})


__all__ = ["MultilayerPerceptronClassifier", "MultilayerPerceptronModel", "forward",
           "init_params", "mlp_loss"]
