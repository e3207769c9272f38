"""Stateless vector transforms: VectorSlicer, ElementwiseProduct,
Interaction (the JAX package's ``features/vector_ops.py``).

Parity with the ``pyspark.ml.feature`` stages of those names.  Each is
row-local and takes an ndarray, a tensor (on its device), an
AssembledTable or a DeviceDataset, as the other matrix stages do.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..data import DeviceDataset
from ..io.model_io import register_model
from .assembler import AssembledTable


def _dispatch(x, fn, cols_fn=None):
    """The container plumbing of every matrix stage's transform:
    AssembledTable / DeviceDataset (pad rows zeroed again) / matrix.
    ``cols_fn(feature_cols) -> new feature_cols`` keeps an AssembledTable's
    column names in step with the transformed matrix's width."""
    if isinstance(x, AssembledTable):
        cols = tuple(cols_fn(x.feature_cols)) if cols_fn is not None else x.feature_cols
        return replace(x, features=fn(x.features), feature_cols=cols)
    if isinstance(x, DeviceDataset):
        return DeviceDataset(x=fn(x.x) * (x.w[:, None] > 0), y=x.y, w=x.w)
    return fn(x)


def _columns(feats, idx: tuple[int, ...]):
    """``feats[:, idx]`` for an ndarray or a tensor."""
    if isinstance(feats, torch.Tensor):
        return feats[:, torch.as_tensor(idx, dtype=torch.long, device=feats.device)]
    return feats[:, np.asarray(idx, np.int32)]


@register_model("VectorSlicer")
@dataclass(frozen=True)
class VectorSlicer:
    """A column subset of the feature vector (Spark's ``indices``; slicing
    by name happens upstream, through ``VectorAssembler``'s columns)."""

    indices: tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "indices", tuple(int(i) for i in self.indices))
        if len(self.indices) == 0:
            raise ValueError("VectorSlicer needs at least one index")
        if len(set(self.indices)) != len(self.indices):
            raise ValueError(f"duplicate indices in {self.indices}")
        if any(i < 0 for i in self.indices):
            raise ValueError(f"negative index in {self.indices}")

    def _artifacts(self):
        return ("VectorSlicer", {"indices": list(self.indices)}, {})

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(tuple(params["indices"]))

    def transform(self, x):
        def fn(feats):
            if max(self.indices) >= feats.shape[1]:
                raise ValueError(
                    f"VectorSlicer index {max(self.indices)} out of range "
                    f"for {feats.shape[1]} features"
                )
            return _columns(feats, self.indices)

        return _dispatch(x, fn, lambda cols: tuple(cols[i] for i in self.indices))


@register_model("ElementwiseProduct")
@dataclass(frozen=True)
class ElementwiseProduct:
    """The Hadamard product with a fixed scaling vector (Spark's
    scalingVec)."""

    scaling_vec: tuple[float, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "scaling_vec", tuple(float(v) for v in self.scaling_vec))
        if len(self.scaling_vec) == 0:
            raise ValueError("ElementwiseProduct needs a non-empty scaling_vec")

    def _artifacts(self):
        return ("ElementwiseProduct", {"scaling_vec": list(self.scaling_vec)}, {})

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(tuple(params["scaling_vec"]))

    def transform(self, x):
        def fn(feats):
            if feats.shape[1] != len(self.scaling_vec):
                raise ValueError(
                    f"ElementwiseProduct scaling_vec has {len(self.scaling_vec)} "
                    f"entries but features have {feats.shape[1]} columns"
                )
            if isinstance(feats, torch.Tensor):
                v = torch.as_tensor(self.scaling_vec, dtype=feats.dtype, device=feats.device)
            else:
                v = np.asarray(self.scaling_vec, feats.dtype)
            return feats * v[None, :]

        return _dispatch(x, fn)


@register_model("Interaction")
@dataclass(frozen=True)
class Interaction:
    """Every pairwise product between two column groups: the two-input
    case of Spark's ``Interaction``, the groups being index tuples into
    the assembled feature matrix.  Output columns are left-major (Spark's
    nesting order)."""

    left: tuple[int, ...] = ()
    right: tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "left", tuple(int(i) for i in self.left))
        object.__setattr__(self, "right", tuple(int(i) for i in self.right))
        if not self.left or not self.right:
            raise ValueError("Interaction needs non-empty left and right index groups")
        if any(i < 0 for i in self.left + self.right):
            raise ValueError(
                f"negative index in {self.left + self.right} (indexing would "
                "silently wrap to the wrong feature)"
            )

    def _artifacts(self):
        return ("Interaction", {"left": list(self.left), "right": list(self.right)}, {})

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(tuple(params["left"]), tuple(params["right"]))

    def transform(self, x):
        def fn(feats):
            hi = max(max(self.left), max(self.right))
            if hi >= feats.shape[1]:
                raise ValueError(
                    f"Interaction index {hi} out of range for {feats.shape[1]} features"
                )
            a = _columns(feats, self.left)             # (n, L)
            b = _columns(feats, self.right)            # (n, R)
            prod = a[:, :, None] * b[:, None, :]       # (n, L, R)
            return prod.reshape(feats.shape[0], len(self.left) * len(self.right))

        return _dispatch(
            x, fn,
            lambda cols: tuple(f"{cols[i]}*{cols[j]}" for i in self.left for j in self.right),
        )
