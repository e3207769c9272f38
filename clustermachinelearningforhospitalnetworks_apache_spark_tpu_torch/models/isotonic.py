"""IsotonicRegression — pool-adjacent-violators, interpolation on the device.

The JAX package's ``models/isotonic.py`` (Spark's ``IsotonicRegression``):
one feature (``feature_index``), increasing (``isotonic=True``) or
decreasing, weighted; predictions interpolate linearly between the fitted
boundaries and clamp outside them (Spark's rule).

The fit is host work, as in the reference: one copy of (x, y, w) to the
host (over a mesh, the shards' rows gathered in global row order), a
stable sort, pooling of duplicate x (``np.unique``,
``np.add.reduceat``), then linear-time PAVA over the pooled groups.
``predict`` runs on the device: :func:`interp`, ``jnp.interp``'s
arithmetic (``searchsorted`` on the right, a lerp, the clamps) in
float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..io.model_io import register_model
from ..parallel.outofcore import HostDataset
from .base import Estimator, Model, Shards, on_mesh

#: ``jnp.interp``'s "dx is zero" threshold for float32 boundaries
_DX_EPS = float(np.spacing(np.finfo(np.float32).eps))


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)``: linear interpolation of the ascending
    table (xp, fp) at x, clamped to fp[0] / fp[-1] outside it."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    lo, hi = fp[i - 1], fp[i]
    df = hi - lo
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= _DX_EPS
    f = torch.where(dx0, lo, lo + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def pava(y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Pool-adjacent-violators (increasing), linear amortized time: a stack
    of monotone blocks; a new point merges backwards while it violates the
    previous block's mean."""
    starts: list[int] = []
    means: list[float] = []
    weights: list[float] = []
    for i in range(y.size):
        cs, cm, cw = i, float(y[i]), float(w[i])
        while means and means[-1] > cm:
            cm = (means[-1] * weights[-1] + cm * cw) / (weights[-1] + cw)
            cw += weights[-1]
            cs = starts[-1]
            starts.pop()
            means.pop()
            weights.pop()
        starts.append(cs)
        means.append(cm)
        weights.append(cw)
    fitted = np.empty(y.size, dtype=np.float64)
    bounds = starts + [y.size]
    for j, mval in enumerate(means):
        fitted[bounds[j]: bounds[j + 1]] = mval
    return fitted


@register_model("IsotonicRegressionModel")
@dataclass
class IsotonicRegressionModel(Model):
    """``boundaries`` (b,) ascending and ``predictions`` (b,), float64 host
    arrays as the reference holds them."""

    boundaries: np.ndarray
    predictions: np.ndarray
    isotonic: bool = True
    feature_index: int = 0

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        xv = x[:, self.feature_index] if x.ndim == 2 else x
        xb = torch.from_numpy(np.asarray(self.boundaries, np.float32)).to(x.device)
        yb = torch.from_numpy(np.asarray(self.predictions, np.float32)).to(x.device)
        return interp(xv.to(torch.float32).contiguous(), xb, yb)

    def _artifacts(self):
        return (
            "IsotonicRegressionModel",
            {"isotonic": bool(self.isotonic), "feature_index": int(self.feature_index)},
            {"boundaries": np.asarray(self.boundaries),
             "predictions": np.asarray(self.predictions)},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(boundaries=arrays["boundaries"], predictions=arrays["predictions"],
                   isotonic=bool(params.get("isotonic", True)),
                   feature_index=int(params.get("feature_index", 0)))


@dataclass(frozen=True)
class IsotonicRegression(Estimator):
    isotonic: bool = True          # Spark default: increasing
    feature_index: int = 0         # Spark's featureIndex
    label_col: str = "length_of_stay"
    features_col: str = "features"
    weight_col: str | None = None

    def _check_feature_index(self, n_features: int) -> None:
        if not 0 <= self.feature_index < n_features:
            raise ValueError(f"feature_index {self.feature_index} out of range "
                             f"[0, {n_features})")

    #: ``fit`` runs over a mesh of more than one shard
    mesh_fit = True

    def fit(self, data, label_col: str | None = None, device=None,
            mesh=None) -> IsotonicRegressionModel:
        """Fit on ``data``; its rows are staged on ``device`` (default the
        card) or over ``mesh`` as every estimator's are, the one column, the
        labels and the weights gathered to the host in global row order
        (data-shard order), then PAVA runs on the host.  A
        :class:`HostDataset` stages nothing: the one column is sliced from
        the host matrix."""
        if isinstance(data, HostDataset):
            if data.y is None:
                raise ValueError("IsotonicRegression needs labels: HostDataset(y=...)")
            self._check_feature_index(data.n_features)
            # the float32 round trip mirrors the resident path's staging cast
            x = np.asarray(data.x[:, self.feature_index], np.float32).astype(np.float64)
            y = np.asarray(data.y, np.float32).astype(np.float64)
            w = (np.asarray(data.w, np.float32).astype(np.float64) if data.w is not None
                 else np.ones(data.n, np.float64))
        else:
            sh = Shards(on_mesh(data, label_col or self.label_col, device, self.weight_col,
                                mesh))
            self._check_feature_index(sh.n_features)
            j = self.feature_index
            cols = sh.rows(lambda i, s: torch.stack(
                [s.x[:, j].to(torch.float64), s.y.to(torch.float64), s.w.to(torch.float64)],
                dim=1))
            x, y, w = cols[:, 0], cols[:, 1], cols[:, 2]
        valid = w > 0
        x, y, w = x[valid], y[valid], w[valid]
        if x.size == 0:
            raise ValueError("isotonic fit on an empty dataset")
        order = np.argsort(x, kind="stable")
        xs, ys, ws = x[order], y[order], w[order]
        # pool duplicate x (weighted means): one PAVA group per distinct x
        ux, first = np.unique(xs, return_index=True)
        sums = np.add.reduceat(ys * ws, first)
        wsum = np.add.reduceat(ws, first)
        gy = sums / wsum
        if not self.isotonic:
            gy = -gy
        fitted = pava(gy, wsum)
        if not self.isotonic:
            fitted = -fitted
        # runs of equal fitted values compress to their end points
        keep = np.ones(ux.size, dtype=bool)
        if ux.size > 2:
            keep[1:-1] = ~((fitted[1:-1] == fitted[:-2]) & (fitted[1:-1] == fitted[2:]))
        return IsotonicRegressionModel(boundaries=ux[keep], predictions=fitted[keep],
                                       isotonic=self.isotonic, feature_index=self.feature_index)


__all__ = ["IsotonicRegression", "IsotonicRegressionModel", "interp", "pava"]
