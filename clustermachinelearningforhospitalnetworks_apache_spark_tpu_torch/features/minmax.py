"""MinMaxScaler — per-feature rescale to [min, max] (the JAX package's
``features/minmax.py``).

Parity with ``pyspark.ml.feature.MinMaxScaler``: fit finds each column's
(min, max), transform maps linearly onto ``[min_out, max_out]``; a
constant column maps every value to the midpoint ``(min_out + max_out) /
2`` (Spark's rule).  A DeviceDataset fits where it lies, through
``moment_stats``' masked min / max (pad rows held out by the ±3.4e38
sentinel); an AssembledTable, ndarray or tensor fits on ``device``
(default the card), a matrix in float64 as the JAX package fits an
ndarray on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..data import DeviceDataset
from ..io.model_io import register_model
from .assembler import AssembledTable
from .scaler import _matrix
from .vector_ops import _dispatch


@register_model("MinMaxScalerModel")
@dataclass(frozen=True)
class MinMaxScalerModel:
    data_min: np.ndarray
    data_max: np.ndarray
    min_out: float = 0.0
    max_out: float = 1.0

    def _artifacts(self):
        return (
            "MinMaxScalerModel",
            {"min_out": self.min_out, "max_out": self.max_out},
            {"data_min": np.asarray(self.data_min), "data_max": np.asarray(self.data_max)},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(
            arrays["data_min"], arrays["data_max"],
            float(params.get("min_out", 0.0)), float(params.get("max_out", 1.0)),
        )

    def transform(self, x):
        """AssembledTable → AssembledTable, DeviceDataset → DeviceDataset
        (pad rows zeroed again), tensor → tensor on its device, ndarray →
        ndarray."""
        return _dispatch(x, self._rows)

    def _rows(self, x):
        out_span = self.max_out - self.min_out
        mid = 0.5 * (self.min_out + self.max_out)
        if isinstance(x, torch.Tensor):
            lo = torch.as_tensor(self.data_min, dtype=x.dtype, device=x.device)
            hi = torch.as_tensor(self.data_max, dtype=x.dtype, device=x.device)
            span = hi - lo
            safe = torch.where(span > 0, span, 1.0)
            scaled = (x - lo[None, :]) / safe[None, :] * out_span + self.min_out
            return torch.where((span > 0)[None, :], scaled, mid)
        lo = np.asarray(self.data_min, dtype=x.dtype)
        hi = np.asarray(self.data_max, dtype=x.dtype)
        span = hi - lo
        # a constant column → the midpoint (Spark's rule); guard the 0-div first
        safe = np.where(span > 0, span, 1.0)
        scaled = (x - lo[None, :]) / safe[None, :] * out_span + self.min_out
        return np.where((span > 0)[None, :], scaled, mid)


@dataclass(frozen=True)
class MinMaxScaler:
    min_out: float = 0.0   # Spark's min
    max_out: float = 1.0   # Spark's max

    def fit(self, data, device=None) -> MinMaxScalerModel:
        # ops.reductions imports models/, whose base imports this package
        from ..ops.reductions import host_moments

        if isinstance(data, AssembledTable):
            data = data.to_device(device=device)
        if isinstance(data, DeviceDataset):
            s = host_moments(data.x, data.w)
            # the float32 extremes, as the JAX package keeps them
            lo, hi = s["min"].astype(np.float32), s["max"].astype(np.float32)
        else:
            x = _matrix(data, device)
            lo, hi = torch.stack([x.min(dim=0).values, x.max(dim=0).values]).cpu().numpy()
        return MinMaxScalerModel(lo, hi, self.min_out, self.max_out)

    def fit_transform(self, data, device=None):
        # transform the ORIGINAL container, so the type that comes back is
        # fit(data).transform(data)'s
        return self.fit(data, device=device).transform(data)
