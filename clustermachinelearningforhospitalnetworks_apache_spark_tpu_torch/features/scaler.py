"""StandardScaler — fit/transform with mean/std, computed on the device.

The fit is one weighted float32 moment pass over the padded rows (the
JAX package's ``features/scaler.py``): population std from
E[x²] − E[x]², columns with std 0 left unscaled, pad rows re-zeroed after
the shift so weighted reductions downstream still ignore them.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..data import DeviceDataset
from ..device import resolve_device
from ..io.model_io import register_model
from .assembler import AssembledTable


def _moment_sums(x: torch.Tensor, w: torch.Tensor):
    """(Σw, Σw·x, Σw·x²) of one dataset or shard."""
    wcol = w[:, None]
    return w.sum(), (x * wcol).sum(dim=0), (x * x * wcol).sum(dim=0)


def _moments(x: torch.Tensor, w: torch.Tensor):
    return _from_sums(*_moment_sums(x, w))


def _from_sums(n, s1, s2):
    mean = s1 / torch.clamp(n, min=1.0)
    var = s2 / torch.clamp(n, min=1.0) - mean * mean
    return mean, torch.sqrt(torch.clamp(var, min=0.0)), n


@register_model("StandardScalerModel")
@dataclass(frozen=True)
class StandardScalerModel:
    """Not a :class:`~..models.base.Model` (as in the JAX package): saved
    with ``save_model(path, *scaler._artifacts())``, read back with
    ``load_model``."""

    mean: np.ndarray
    std: np.ndarray
    with_mean: bool = True
    with_std: bool = True

    def _artifacts(self):
        return (
            "StandardScalerModel",
            {"with_mean": self.with_mean, "with_std": self.with_std},
            {"mean": np.asarray(self.mean), "std": np.asarray(self.std)},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(
            np.asarray(arrays["mean"]),
            np.asarray(arrays["std"]),
            bool(params.get("with_mean", True)),
            bool(params.get("with_std", True)),
        )

    def transform(self, x):
        """AssembledTable → AssembledTable, DeviceDataset → DeviceDataset,
        ShardedDataset → ShardedDataset (each shard where it lies), tensor
        → tensor (on its device), ndarray → ndarray."""
        from ..parallel.sharding import ShardedDataset

        if isinstance(x, AssembledTable):
            return replace(x, features=self.transform(x.features))
        if isinstance(x, DeviceDataset):
            return self.transform_dataset(x)
        if isinstance(x, ShardedDataset):
            blocks = np.empty(x.blocks.shape, dtype=object)
            for ij in np.ndindex(blocks.shape):
                if x.blocks[ij] is not None:
                    blocks[ij] = self.transform_dataset(x.blocks[ij])
            return ShardedDataset(x.mesh, blocks)
        if isinstance(x, torch.Tensor):
            out = x
            if self.with_mean:
                out = out - torch.as_tensor(self.mean, dtype=out.dtype,
                                            device=out.device)
            if self.with_std:
                std = torch.as_tensor(self.std, device=out.device)
                safe = torch.where(std > 0, std, torch.ones_like(std))
                out = out / safe.to(out.dtype)
            return out
        out = x
        if self.with_mean:
            out = out - np.asarray(self.mean, dtype=out.dtype)
        if self.with_std:
            safe = np.where(np.asarray(self.std) > 0, np.asarray(self.std), 1.0)
            out = out / safe.astype(out.dtype)
        return out

    def transform_dataset(self, ds: DeviceDataset) -> DeviceDataset:
        # pad rows are zeros; re-zero them after the shift
        x = self.transform(ds.x) * (ds.w[:, None] > 0)
        return DeviceDataset(x=x, y=ds.y, w=ds.w)


@dataclass(frozen=True)
class StandardScaler:
    with_mean: bool = True
    with_std: bool = True

    def fit(self, data, device=None, mesh=None) -> StandardScalerModel:
        """``data``: DeviceDataset (fit where it lies), or an AssembledTable,
        ndarray or tensor, moved to ``device`` (default the card).  A matrix
        is fit in float64 with the population std, as the JAX package fits
        an ndarray on the host.  Over ``mesh`` (or for a ShardedDataset) an
        AssembledTable or dataset is laid over the data shards and the
        moments are summed a shard, in ascending shard order, as the
        reference's moments over its mesh."""
        from ..models.base import Shards, is_sharded, on_mesh

        if is_sharded(data) or (mesh is not None and not isinstance(
                data, (np.ndarray, torch.Tensor))):
            sh = Shards(on_mesh(data, None, device, None, mesh))
            mean, std, _ = _from_sums(*sh.sum(lambda i, s: _moment_sums(s.x, s.w)))
            return StandardScalerModel(
                mean.cpu().numpy(), std.cpu().numpy(), self.with_mean, self.with_std)
        if mesh is not None:
            device = mesh.device(0, 0)    # a matrix: the float64 host-equivalent fit
        if isinstance(data, AssembledTable):
            data = data.to_device(device=device)
        if isinstance(data, DeviceDataset):
            mean, std, _ = _moments(data.x, data.w)
        else:
            x = _matrix(data, device)
            mean, std = x.mean(dim=0), x.std(dim=0, correction=0)
        return StandardScalerModel(
            mean.cpu().numpy(), std.cpu().numpy(), self.with_mean, self.with_std
        )

    def fit_transform(self, data, device=None):
        """Fit then transform on ``device`` (default the card).  A
        DeviceDataset or AssembledTable comes back as a DeviceDataset; an
        ndarray comes back as a float64 ndarray, a tensor as a tensor."""
        if isinstance(data, AssembledTable):
            data = data.to_device(device=device)
        if isinstance(data, DeviceDataset):
            model = self.fit(data)
            return DeviceDataset(model.transform(data.x), data.y, data.w)
        x = _matrix(data, device)
        out = self.fit(x, device=x.device).transform(x)
        return out if isinstance(data, torch.Tensor) else out.cpu().numpy()


def _matrix(data, device) -> torch.Tensor:
    """An ndarray or tensor as a float64 matrix on ``device``."""
    if not isinstance(data, torch.Tensor):
        data = np.asarray(data, dtype=np.float64)
    return torch.as_tensor(data, dtype=torch.float64, device=resolve_device(device))
