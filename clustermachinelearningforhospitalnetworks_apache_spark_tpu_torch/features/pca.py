"""PCA — project features onto the top-k principal components (the JAX
package's ``features/pca.py``).

Parity with ``pyspark.ml.feature.PCA``.  The fit is one weighted pass
over the rows on the device (``ops.reductions.host_moments``: n, Σw·x and
the chunked XᵀWX; over a mesh a shard on its device, summed in shard
order); only the (d, d) matrix reaches the host, where the
covariance's eigendecomposition runs in float64 (Spark likewise solves
it on one machine).  A matrix (ndarray or tensor) is fit in float64 on
``device`` (default the card), as the JAX package fits an ndarray on the
host.

Sign rule: each component's largest-|loading| entry is made positive,
so results are deterministic (eigenvectors are sign-ambiguous).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..data import DeviceDataset
from ..io.model_io import register_model
from ..parallel.sharding import ShardedDataset
from .scaler import _matrix, _stage_input
from .vector_ops import _dispatch


@register_model("PCAModel")
@dataclass(frozen=True)
class PCAModel:
    components: np.ndarray          # (d, k): columns are the principal axes
    explained_variance: np.ndarray  # (k,)
    mean: np.ndarray                # (d,): the centering vector

    @property
    def k(self) -> int:
        return self.components.shape[1]

    def _artifacts(self):
        return (
            "PCAModel",
            {},
            {
                "components": np.asarray(self.components),
                "explained_variance": np.asarray(self.explained_variance),
                "mean": np.asarray(self.mean),
            },
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(arrays["components"], arrays["explained_variance"], arrays["mean"])

    def transform(self, x):
        """AssembledTable → AssembledTable, DeviceDataset → DeviceDataset
        (pad rows zeroed again), tensor → tensor on its device, ndarray →
        ndarray."""
        return _dispatch(x, self._rows)

    def _rows(self, x):
        if isinstance(x, torch.Tensor):
            c = torch.as_tensor(self.components, dtype=x.dtype, device=x.device)
            m = torch.as_tensor(self.mean, dtype=x.dtype, device=x.device)
            return (x - m[None, :]) @ c
        c = np.asarray(self.components, dtype=x.dtype)
        m = np.asarray(self.mean, dtype=x.dtype)
        return (x - m[None, :]) @ c


@dataclass(frozen=True)
class PCA:
    k: int

    def fit(self, data, device=None, mesh=None) -> PCAModel:
        """``data``: a DeviceDataset or ShardedDataset (fit where it lies),
        an AssembledTable moved to ``device`` (default the card) or laid
        over ``mesh``, or a matrix (float64 on ``device``)."""
        # ops.reductions imports models/, whose base imports this package
        from ..ops.reductions import host_moments

        data, device = _stage_input(data, device, mesh)
        if isinstance(data, (DeviceDataset, ShardedDataset)):
            s = host_moments(data.x, data.w)
            n, s1, s2 = s["n"], s["s1"], s["xtx"]
        else:
            x = _matrix(data, device)
            n = float(x.shape[0])
            moments = torch.cat([x.sum(dim=0)[None, :], x.T @ x]).cpu().numpy()
            s1, s2 = moments[0], moments[1:]
        d = s1.shape[0]
        if not 1 <= self.k <= d:
            raise ValueError(f"k must be in [1, {d}], got {self.k}")
        n = max(float(n), 1.0)
        mean = s1 / n
        cov = s2 / n - np.outer(mean, mean)
        # the unbiased (n - 1) normalization, as sklearn and Spark
        cov = cov * (n / max(n - 1.0, 1.0))
        evals, evecs = np.linalg.eigh(cov)       # ascending
        order = np.argsort(evals)[::-1][: self.k]
        comps = evecs[:, order]
        evals = np.maximum(evals[order], 0.0)
        # the sign rule: each component's largest-|loading| entry positive
        flip = np.sign(comps[np.argmax(np.abs(comps), axis=0), np.arange(self.k)])
        comps = comps * np.where(flip == 0, 1.0, flip)[None, :]
        return PCAModel(comps, evals, mean)

    def fit_transform(self, data, device=None, mesh=None):
        # transform the ORIGINAL container, so the type that comes back is
        # fit(data).transform(data)'s
        return self.fit(data, device=device, mesh=mesh).transform(data)
