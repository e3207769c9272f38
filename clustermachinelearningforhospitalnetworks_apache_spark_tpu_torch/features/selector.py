"""VectorIndexer and feature selectors (the JAX package's
``features/selector.py``) — the indexing/selection tail of
``pyspark.ml.feature``.

``VectorIndexer`` (Spark): scan an assembled feature matrix, decide which
columns are categorical (≤ ``max_categories`` distinct values), and
re-encode those columns to category indices, exposing the decision as a
``categorical_features`` dict — exactly the ``{index: arity}`` spec the
tree estimators consume.  Host numpy, no ``device=``.

``UnivariateFeatureSelector`` (Spark 3.1+): pick features by a statistical
test chosen from (featureType, labelType) — chi2 for categorical/
categorical, ANOVA F for continuous features vs categorical label, F-value
for continuous/continuous — through the port's ``stat`` tests on
``device`` (default the card).  ``ChiSqSelector`` is the classic (pre-3.1)
chi2-only spelling.  ``VarianceThresholdSelector`` reads its variances
from one device moment pass (a table or a dataset), or from numpy on an
ndarray.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from ..data import DeviceDataset
from ..io.model_io import register_model, save_model
from .assembler import AssembledTable


class _Saveable:
    """Direct save/write sugar for stage models (same artifact layout the
    Pipeline persistence machinery writes)."""

    def save(self, path: str, overwrite: bool = True) -> None:
        name, meta, arrays = self._artifacts()
        save_model(path, name, meta, arrays, overwrite=overwrite)

    def write(self):
        from ..models.base import _Writer

        return _Writer(self)


def _as_matrix(data: Any) -> np.ndarray:
    if isinstance(data, AssembledTable):
        return np.asarray(data.features, dtype=np.float64)
    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy().astype(np.float64)
    return np.asarray(data, dtype=np.float64)


def _rewrap(data: Any, mat: np.ndarray, cols: Sequence[str] | None = None):
    """Return the transformed matrix in the caller's container shape."""
    if isinstance(data, AssembledTable):
        return AssembledTable(
            table=data.table,
            feature_cols=tuple(cols) if cols is not None else data.feature_cols,
            features=mat,
            output_col=data.output_col,
        )
    return mat


# ------------------------------------------------------------ VectorIndexer
@register_model("VectorIndexerModel")
@dataclass(frozen=True)
class VectorIndexerModel(_Saveable):
    """``category_maps``: feature index → tuple of ORIGINAL values, in
    ascending order; the value's position is its category index."""

    num_features: int
    category_maps: dict[int, tuple[float, ...]]
    handle_invalid: str = "error"   # "error" | "keep" | "skip"

    @property
    def categorical_features(self) -> dict[int, int]:
        """The ``{index: arity}`` spec the tree estimators accept —
        "keep" mode reserves one extra index for unseen values."""
        extra = 1 if self.handle_invalid == "keep" else 0
        return {f: len(v) + extra for f, v in self.category_maps.items()}

    def transform(self, data):
        x = _as_matrix(data).copy()
        drop = np.zeros(x.shape[0], dtype=bool)
        for f, values in self.category_maps.items():
            # values is ascending (np.unique at fit), so one searchsorted
            # maps the whole column
            va = np.asarray(values)
            col = x[:, f]
            codes = np.searchsorted(va, col)
            unseen = (codes >= va.size) | (va[np.minimum(codes, va.size - 1)] != col)
            if unseen.any():
                if self.handle_invalid == "error":
                    bad = col[unseen][0]
                    raise ValueError(
                        f"unseen value {bad!r} in categorical feature {f} "
                        "(handle_invalid='error')"
                    )
                if self.handle_invalid == "skip":
                    drop |= unseen
                    codes = np.where(unseen, 0, codes)
                else:  # keep → the reserved extra category
                    codes = np.where(unseen, va.size, codes)
            x[:, f] = codes
        if self.handle_invalid == "skip" and drop.any():
            if not isinstance(data, AssembledTable):
                return x[~drop]
            return AssembledTable(
                table=data.table.mask(~drop),
                feature_cols=data.feature_cols,
                features=x[~drop],
                output_col=data.output_col,
            )
        return _rewrap(data, x)

    def _artifacts(self):
        return (
            "VectorIndexerModel",
            {
                "num_features": self.num_features,
                "handle_invalid": self.handle_invalid,
                "category_maps": {
                    str(k): list(map(float, v)) for k, v in self.category_maps.items()
                },
            },
            {},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(
            num_features=int(params["num_features"]),
            category_maps={
                int(k): tuple(v) for k, v in params["category_maps"].items()
            },
            handle_invalid=params.get("handle_invalid", "error"),
        )


@dataclass(frozen=True)
class VectorIndexer:
    max_categories: int = 20        # Spark default
    handle_invalid: str = "error"

    def fit(self, data, label_col=None, mesh=None) -> VectorIndexerModel:
        """Host work: ``mesh`` is accepted and unused, as in the reference."""
        if self.handle_invalid not in ("error", "keep", "skip"):
            raise ValueError(
                f"handle_invalid must be error|keep|skip, got "
                f"{self.handle_invalid!r}"
            )
        x = _as_matrix(data)
        maps: dict[int, tuple[float, ...]] = {}
        for f in range(x.shape[1]):
            distinct = np.unique(x[:, f])
            if distinct.size <= self.max_categories:
                maps[f] = tuple(float(v) for v in distinct)
        return VectorIndexerModel(
            num_features=x.shape[1],
            category_maps=maps,
            handle_invalid=self.handle_invalid,
        )


# ------------------------------------------------- UnivariateFeatureSelector
@register_model("UnivariateFeatureSelectorModel")
@dataclass(frozen=True)
class UnivariateFeatureSelectorModel(_Saveable):
    selected: tuple[int, ...]       # ascending feature indices

    def transform(self, data):
        x = _as_matrix(data)
        idx = list(self.selected)
        cols = None
        if isinstance(data, AssembledTable):
            cols = [data.feature_cols[i] for i in idx]
        return _rewrap(data, x[:, idx], cols)

    def _artifacts(self):
        return (
            "UnivariateFeatureSelectorModel",
            {"selected": list(map(int, self.selected))},
            {},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(selected=tuple(int(i) for i in params["selected"]))


@dataclass(frozen=True)
class UnivariateFeatureSelector:
    """Spark's test matrix: (featureType, labelType) → chi2 | ANOVA F |
    F-value.  ``selection_mode``: numTopFeatures (default, Spark too),
    percentile, fpr (p-value threshold)."""

    feature_type: str = "continuous"     # "continuous" | "categorical"
    label_type: str = "categorical"      # "continuous" | "categorical"
    selection_mode: str = "numTopFeatures"
    selection_threshold: float | None = None  # mode-dependent default
    label_col: str = "LOS_binary"

    def _p_values(self, x, y, device, mesh=None):
        from ..stat import ANOVATest, ChiSquareTest, FValueTest

        ft, lt = self.feature_type, self.label_type
        if ft == "categorical" and lt == "categorical":
            # host work, as in the reference
            return ChiSquareTest.test(
                x, y, device=device if mesh is None else mesh.device(0, 0)).p_values
        if ft == "continuous" and lt == "categorical":
            return ANOVATest.test(
                x.astype(np.float32), y.astype(np.float32), mesh, device=device
            ).p_values
        if ft == "continuous" and lt == "continuous":
            return FValueTest.test(
                x.astype(np.float32), y.astype(np.float32), mesh, device=device
            ).p_values
        raise ValueError(
            "categorical features with a continuous label have no Spark "
            "test; bucketize the label or use feature_type='continuous'"
        )

    def fit(self, data, label_col: str | None = None, device=None, mesh=None):
        """Test every feature of ``data`` (an AssembledTable) against its
        label column on ``device`` (default the card), or over ``mesh``
        (the ANOVA and F-value sums a shard, in shard order)."""
        x = _as_matrix(data)
        if isinstance(data, AssembledTable):
            y = data.label(label_col or self.label_col)
        else:
            raise ValueError(
                "UnivariateFeatureSelector needs an AssembledTable (the "
                "label column resolves against the table)"
            )
        p = np.asarray(self._p_values(x, y, device, mesh), dtype=np.float64)
        d = x.shape[1]
        mode = self.selection_mode
        if mode == "numTopFeatures":
            top = int(self.selection_threshold or 50)
            sel = np.sort(np.argsort(p, kind="stable")[: min(top, d)])
        elif mode == "percentile":
            frac = self.selection_threshold if self.selection_threshold is not None else 0.1
            keep = max(1, int(d * float(frac)))
            sel = np.sort(np.argsort(p, kind="stable")[:keep])
        elif mode == "fpr":
            alpha = self.selection_threshold if self.selection_threshold is not None else 0.05
            sel = np.flatnonzero(p < float(alpha))
        else:
            raise ValueError(
                f"selection_mode must be numTopFeatures|percentile|fpr, got "
                f"{mode!r}"
            )
        return UnivariateFeatureSelectorModel(selected=tuple(int(i) for i in sel))


@dataclass(frozen=True)
class ChiSqSelector:
    """Classic chi2 selector (Spark pre-3.1) — categorical features vs a
    categorical label, top-N by p-value."""

    num_top_features: int = 50
    label_col: str = "LOS_binary"

    def fit(self, data, label_col: str | None = None, device=None, mesh=None):
        return UnivariateFeatureSelector(
            feature_type="categorical",
            label_type="categorical",
            selection_mode="numTopFeatures",
            selection_threshold=self.num_top_features,
            label_col=label_col or self.label_col,
        ).fit(data, label_col=label_col, device=device, mesh=mesh)


# --------------------------------------------- VarianceThresholdSelector
@register_model("VarianceThresholdSelectorModel")
@dataclass(frozen=True)
class VarianceThresholdSelectorModel(_Saveable):
    selected: tuple[int, ...]

    def transform(self, data):
        from ..parallel.sharding import ShardedDataset, map_shards

        idx = list(self.selected)
        if isinstance(data, ShardedDataset):
            return map_shards(data, self.transform)
        if isinstance(data, DeviceDataset):
            # the column subset stays where the dataset lies
            cols = torch.as_tensor(idx, dtype=torch.int64, device=data.x.device)
            return DeviceDataset(x=data.x[:, cols], y=data.y, w=data.w)
        x = _as_matrix(data)
        cols = None
        if isinstance(data, AssembledTable):
            cols = [data.feature_cols[i] for i in idx]
        return _rewrap(data, x[:, idx], cols)

    def _artifacts(self):
        return (
            "VarianceThresholdSelectorModel",
            {"selected": list(map(int, self.selected))},
            {},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(selected=tuple(int(i) for i in params["selected"]))


@dataclass(frozen=True)
class VarianceThresholdSelector:
    """Drop features whose SAMPLE variance is ≤ ``variance_threshold``
    (Spark 3.1's selector; default 0 keeps everything non-constant).
    A table moves to ``device`` (default the card) or is laid over
    ``mesh``, and a dataset or a tensor stays where it lies, for one
    device moment pass (a shard on its device over a mesh, summed in shard
    order); an ndarray's variances are numpy float64."""

    variance_threshold: float = 0.0

    def fit(self, data, label_col: str | None = None, device=None, mesh=None):
        # ops.reductions imports models/, whose base imports this package
        from ..ops.reductions import host_moments
        from ..parallel.sharding import ShardedDataset
        from .scaler import _stage_input

        data, _ = _stage_input(data, device, mesh)
        if isinstance(data, (DeviceDataset, ShardedDataset)):
            ds = data
        elif isinstance(data, torch.Tensor):
            ds = DeviceDataset(x=data, y=data.new_zeros(data.shape[0]),
                               w=data.new_ones(data.shape[0], dtype=torch.float32))
        else:
            x = np.asarray(data, np.float64)
            n = x.shape[0]
            var = x.var(axis=0, ddof=1) if n > 1 else np.zeros(x.shape[1])
            sel = np.flatnonzero(var > self.variance_threshold)
            return VarianceThresholdSelectorModel(
                selected=tuple(int(i) for i in sel)
            )
        s = host_moments(ds.x, ds.w)
        n = s["n"]
        if n <= 1:
            raise ValueError("VarianceThresholdSelector needs at least 2 rows")
        mean = s["s1"] / n
        # weighted SAMPLE variance (ddof=1 at unit weights — Spark's)
        var = np.maximum(s["s2"] / n - mean * mean, 0.0) * (n / max(n - 1.0, 1.0))
        sel = np.flatnonzero(var > self.variance_threshold)
        return VarianceThresholdSelectorModel(selected=tuple(int(i) for i in sel))


__all__ = [
    "ChiSqSelector", "UnivariateFeatureSelector", "UnivariateFeatureSelectorModel",
    "VarianceThresholdSelector", "VarianceThresholdSelectorModel", "VectorIndexer",
    "VectorIndexerModel",
]
