"""RobustScaler and MaxAbsScaler (the JAX package's ``features/robust.py``).

Parity with ``pyspark.ml.feature.RobustScaler`` (center by the median,
scale by the IQR) and ``MaxAbsScaler`` (scale to [-1, 1] by each column's
largest |x|, keeping signs and zeros).

MaxAbsScaler's statistic is one masked min / max pass on the device
(``ops.reductions.moment_stats``); a NaN in the rows makes that pass
non-finite, and the min / max are then taken again NaN-aware, still on
the device (the JAX package takes them again on the host).
RobustScaler's quantiles come from a bounded host sample of valid rows
(``parallel.sharding.sample_valid_rows``, the draw the JAX package makes,
the same rows on every mesh shape), as Spark takes them with
approxQuantile.  Fits take ``device=`` (default the card) or ``mesh=``;
a DeviceDataset or ShardedDataset fits where it lies.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ..data import DeviceDataset
from ..io.model_io import register_model
from ..parallel.collectives import gather_shards
from ..parallel.sharding import ShardedDataset, sample_valid_rows
from .scaler import _matrix, _stage_input
from .vector_ops import _dispatch


def _nan_min_max(x: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """(2, d) float64 [column minima, maxima] of ``x``'s ``valid`` rows (all
    rows by default) with NaN skipped (±inf where a column has no such
    value), on x's device."""
    x = x.to(torch.float64)
    skip = torch.isnan(x)
    if valid is not None:
        skip = skip | ~valid[:, None]
    lo = torch.where(skip, float("inf"), x).min(dim=0).values
    hi = torch.where(skip, float("-inf"), x).max(dim=0).values
    return torch.stack([lo, hi])


def _valid_nan_min_max(ds) -> np.ndarray:
    """``_nan_min_max`` of a dataset's valid rows, on the host: a shard at a
    time over a mesh, then the min / max of the shards'."""
    if not isinstance(ds, ShardedDataset):
        return _nan_min_max(ds.x, ds.w > 0).cpu().numpy()
    parts: list = [None] * ds.mesh.devices.shape[0]
    for i in ds.mesh.local_data_shards():
        s = ds.shard(i)
        parts[i] = _nan_min_max(s.x, s.w > 0)
    got = torch.stack([p.cpu() for p in gather_shards(parts, ds.mesh)])
    return torch.stack([got[:, 0].min(dim=0).values, got[:, 1].max(dim=0).values]).numpy()


@register_model("MaxAbsScalerModel")
@dataclass(frozen=True)
class MaxAbsScalerModel:
    max_abs: np.ndarray

    def _artifacts(self):
        return ("MaxAbsScalerModel", {}, {"max_abs": np.asarray(self.max_abs)})

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(arrays["max_abs"])

    def transform(self, x):
        """AssembledTable → AssembledTable, DeviceDataset → DeviceDataset
        (pad rows zeroed again), tensor → tensor on its device, ndarray →
        ndarray."""
        return _dispatch(x, self._rows)

    def _rows(self, x):
        if isinstance(x, torch.Tensor):
            m = torch.as_tensor(self.max_abs, dtype=x.dtype, device=x.device)
            return x / torch.where(m > 0, m, 1.0)[None, :]
        m = np.asarray(self.max_abs, x.dtype)
        return x / np.where(m > 0, m, 1.0)[None, :]   # an all-zero column stays zero


@dataclass(frozen=True)
class MaxAbsScaler:
    def fit(self, data, device=None, mesh=None) -> MaxAbsScalerModel:
        """``data`` as ``PCA.fit`` takes it; over ``mesh`` the extremes are
        the shards' min / max of min / max."""
        # ops.reductions imports models/, whose base imports this package
        from ..ops.reductions import host_moments

        data, device = _stage_input(data, device, mesh)
        if isinstance(data, (DeviceDataset, ShardedDataset)):
            s = host_moments(data.x, data.w)
            if s["count"] == 0.0:
                raise ValueError("MaxAbsScaler fit on an empty dataset")
            lo, hi = s["min"], s["max"]
            if not (np.isfinite(lo).all() and np.isfinite(hi).all()):
                # a NaN in the rows poisons the masked min / max: take them
                # again over the valid rows with NaN skipped
                lo, hi = _valid_nan_min_max(data)
        else:
            x = _matrix(data, device)
            if x.shape[0] == 0:
                raise ValueError("MaxAbsScaler fit on an empty dataset")
            # NaN-tolerant: one missing value must not de-scale a column
            lo, hi = _nan_min_max(x).cpu().numpy()
        m = np.maximum(np.abs(lo), np.abs(hi))
        return MaxAbsScalerModel(np.where(np.isfinite(m), m, 0.0))

    def fit_transform(self, data, device=None, mesh=None):
        return self.fit(data, device=device, mesh=mesh).transform(data)


@register_model("RobustScalerModel")
@dataclass(frozen=True)
class RobustScalerModel:
    median: np.ndarray     # per-column q50
    iqr: np.ndarray        # per-column q(upper) − q(lower)
    with_centering: bool = False
    with_scaling: bool = True

    def _artifacts(self):
        return (
            "RobustScalerModel",
            {"with_centering": self.with_centering, "with_scaling": self.with_scaling},
            {"median": np.asarray(self.median), "iqr": np.asarray(self.iqr)},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(
            arrays["median"], arrays["iqr"],
            bool(params.get("with_centering", False)),
            bool(params.get("with_scaling", True)),
        )

    def transform(self, x):
        """AssembledTable → AssembledTable, DeviceDataset → DeviceDataset
        (pad rows zeroed again), tensor → tensor on its device, ndarray →
        ndarray."""
        return _dispatch(x, self._rows)

    def _rows(self, x):
        if isinstance(x, torch.Tensor):
            def vec(a):
                return torch.as_tensor(a, dtype=x.dtype, device=x.device)
            where = torch.where
        else:
            def vec(a):
                return np.asarray(a, x.dtype)
            where = np.where
        out = x
        if self.with_centering:
            out = out - vec(self.median)[None, :]
        if self.with_scaling:
            s = vec(self.iqr)
            out = out / where(s > 0, s, 1.0)[None, :]   # a constant column stays unscaled
        return out


@dataclass(frozen=True)
class RobustScaler:
    """Spark's defaults: lower=0.25, upper=0.75, withCentering=False,
    withScaling=True."""

    lower: float = 0.25
    upper: float = 0.75
    with_centering: bool = False
    with_scaling: bool = True
    sample_size: int = 65536

    def __post_init__(self):
        if not 0.0 <= self.lower < self.upper <= 1.0:
            raise ValueError(f"need 0 <= lower < upper <= 1; got ({self.lower}, {self.upper})")

    def fit(self, data, device=None, mesh=None) -> RobustScalerModel:
        """``data`` as ``PCA.fit`` takes it; over ``mesh`` the sample is
        the one-device draw (``sample_valid_rows`` draws over the valid
        rows' global indices), read from the shards that hold it."""
        data, device = _stage_input(data, device, mesh)
        if isinstance(data, (DeviceDataset, ShardedDataset)):
            sample = sample_valid_rows(data, self.sample_size, seed=0)
        else:
            x = _matrix(data, device)
            if x.shape[0] > self.sample_size:
                # the JAX package's draw over all rows (NaN rows included)
                rng = np.random.default_rng(0)
                idx = np.sort(rng.choice(x.shape[0], self.sample_size, replace=False))
                x = x[torch.from_numpy(idx).to(x.device)]
            sample = x.cpu().numpy()
        if sample.shape[0] == 0:
            raise ValueError("RobustScaler fit on an empty dataset")
        # nanquantile: missing values do not poison the statistic; an
        # all-NaN column degrades to median 0 / iqr 0 (left unscaled)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # an all-NaN column
            q = np.nanquantile(sample, [self.lower, 0.5, self.upper], axis=0)
        median = np.where(np.isfinite(q[1]), q[1], 0.0)
        iqr = np.where(np.isfinite(q[2] - q[0]), q[2] - q[0], 0.0)
        return RobustScalerModel(
            median=median, iqr=iqr,
            with_centering=self.with_centering, with_scaling=self.with_scaling,
        )

    def fit_transform(self, data, device=None, mesh=None):
        return self.fit(data, device=device, mesh=mesh).transform(data)
