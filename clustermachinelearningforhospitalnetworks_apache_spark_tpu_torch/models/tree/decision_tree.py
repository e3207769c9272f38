"""DecisionTreeRegressor / DecisionTreeClassifier (the JAX package's
``models/tree/decision_tree.py``, resident fits).

A decision tree is the one-tree case of the level-order histogram engine
(``engine.py``); ``fit(..., mesh=)`` grows it over the mesh's data shards
and ``transform(..., mesh=)`` predicts shard by shard.  Spark defaults: maxDepth 5, maxBins 32,
minInstancesPerNode 1, minInfoGain 0.  A
:class:`~...parallel.outofcore.HostDataset` streams through the engine's
out-of-core grower, on ``device`` or over ``mesh``, which alone reads
``checkpoint_dir``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...io.model_io import register_model
from ...parallel.outofcore import HostDataset
from ..base import Estimator, Model, check_features, on_mesh
from .engine import GrownForest, grow_forest, grow_forest_outofcore, predict_forest


def _fit_grown(data, label_col, weight_col, device, subset_strategy: str | None = None,
               mesh=None, **kw) -> GrownForest:
    """Shared fit for every tree estimator: a HostDataset streams through
    ``grow_forest_outofcore`` (to ``device``, or over ``mesh``); anything
    else is staged on ``device``, or over ``mesh`` (each data shard on its
    device, ``engine.grow_forest``'s sharded path), and grown resident.  ``subset_strategy`` (forests)
    resolves to a per-node feature count once the dataset's width is
    known."""
    def subset_kw(d: int) -> dict:
        if subset_strategy is None:
            return {}
        from .random_forest import _subset_size

        return {"feature_subset_size": _subset_size(subset_strategy, d, kw["task"])}

    if isinstance(data, HostDataset):
        if data.y is None:
            raise ValueError("tree fit needs labels: HostDataset(y=...)")
        return grow_forest_outofcore(data, device=device, mesh=mesh,
                                     **subset_kw(data.n_features), **kw)
    # checkpoints serve the long streaming fits; a resident fit is one
    # device pass a level and restarts cheaply
    kw.pop("checkpoint_dir", None)
    kw.pop("checkpoint_every", None)
    ds = on_mesh(data, label_col, device, weight_col, mesh)
    return grow_forest(ds, **subset_kw(ds.n_features), **kw)


@dataclass
class _TreeEnsembleModel(Model):
    """Shared prediction for single trees and forests: host numpy heap
    arrays, traversed on the device of the rows."""

    split_feat: np.ndarray
    threshold: np.ndarray
    value: np.ndarray
    feature_importances: np.ndarray
    max_depth: int
    task: str = "regression"
    num_classes: int = 2
    split_catmask: np.ndarray | None = None
    cat_arities: np.ndarray | None = None

    @property
    def num_trees(self) -> int:
        return self.split_feat.shape[0]

    @property
    def total_num_nodes(self) -> int:
        """Count of populated nodes across trees (split nodes + their leaves)."""
        splits = (self.split_feat >= 0).sum()
        return int(2 * splits + self.num_trees)

    def _tree_outputs(self, x: torch.Tensor) -> torch.Tensor:
        check_features(x, self.feature_importances.shape[-1], type(self).__name__)
        cat_mask = cat_flags = None
        if self.split_catmask is not None:
            cat_mask = self.split_catmask
            cat_flags = np.asarray(self.cat_arities) > 0
        return predict_forest(x, self.split_feat, self.threshold, self.value,
                              cat_mask, cat_flags)  # (T, n, V)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        out = self._tree_outputs(x).mean(dim=0)  # (n, V)
        if self.task == "regression":
            return out[:, 0]
        return torch.argmax(out, dim=1).to(torch.float32)

    def predict_proba(self, x: torch.Tensor) -> torch.Tensor:
        if self.task != "classification":
            raise ValueError("predict_proba is classification-only")
        return self._tree_outputs(x).mean(dim=0)

    # persistence: the JAX package's keys, with the heap arrays' dtypes
    def _meta(self) -> dict:
        return {
            "task": self.task,
            "num_classes": self.num_classes,
            "max_depth": self.max_depth,
        }

    def _arrays(self) -> dict:
        arrays = {
            "split_feat": np.asarray(self.split_feat, np.int32),
            "threshold": np.asarray(self.threshold, np.float32),
            "value": np.asarray(self.value, np.float32),
            "feature_importances": np.asarray(self.feature_importances, np.float64),
        }
        if self.split_catmask is not None:
            arrays["split_catmask"] = np.asarray(self.split_catmask, np.uint32)
            arrays["cat_arities"] = np.asarray(self.cat_arities, np.int32)
        return arrays

    @classmethod
    def from_artifacts(cls, params, arrays):
        def arr(key, dtype):
            v = arrays.get(key)
            return None if v is None else np.asarray(v, dtype=dtype)

        return cls(
            split_feat=arr("split_feat", np.int32),
            threshold=arr("threshold", np.float32),
            value=arr("value", np.float32),
            feature_importances=arr("feature_importances", np.float64),
            max_depth=int(params["max_depth"]),
            task=params["task"],
            num_classes=int(params.get("num_classes", 2)),
            split_catmask=arr("split_catmask", np.uint32),
            cat_arities=arr("cat_arities", np.int32),
        )


def _from_grown(cls, grown: GrownForest, task: str, num_classes: int):
    imp = grown.importances.mean(axis=0)
    s = imp.sum()
    return cls(
        split_feat=grown.split_feat,
        threshold=grown.threshold,
        value=grown.value,
        feature_importances=imp / s if s > 0 else imp,
        max_depth=grown.max_depth,
        task=task,
        num_classes=num_classes,
        split_catmask=grown.split_catmask,
        cat_arities=grown.cat_arities,
    )


@register_model("DecisionTreeModel")
@dataclass
class DecisionTreeModel(_TreeEnsembleModel):
    def _artifacts(self):
        return ("DecisionTreeModel", self._meta(), self._arrays())


@dataclass(frozen=True)
class _TreeParams:
    max_depth: int = 5
    max_bins: int = 32
    min_instances_per_node: int = 1
    min_info_gain: float = 0.0
    seed: int = 0
    label_col: str = "length_of_stay"
    weight_col: str | None = None  # Spark's weightCol
    # MLlib's categoricalFeaturesInfo: feature index → arity
    categorical_features: dict[int, int] | None = None
    # out-of-core (HostDataset) fits commit every `checkpoint_every` tree
    # levels, so a preempted streaming fit resumes mid-growth; resident
    # fits ignore both
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1

    def _grow_kw(self) -> dict:
        return dict(
            max_depth=self.max_depth, max_bins=self.max_bins,
            min_instances_per_node=self.min_instances_per_node,
            min_info_gain=self.min_info_gain, seed=self.seed,
            categorical_features=self.categorical_features,
            checkpoint_dir=self.checkpoint_dir, checkpoint_every=self.checkpoint_every,
        )


@dataclass(frozen=True)
class DecisionTreeRegressor(Estimator, _TreeParams):
    mesh_fit = True

    def fit(self, data, label_col: str | None = None, device=None,
            mesh=None) -> DecisionTreeModel:
        grown = _fit_grown(data, label_col or self.label_col, self.weight_col, device,
                           mesh=mesh, task="regression", num_trees=1, **self._grow_kw())
        return _from_grown(DecisionTreeModel, grown, "regression", 2)


@dataclass(frozen=True)
class DecisionTreeClassifier(Estimator, _TreeParams):
    num_classes: int = 2
    label_col: str = "LOS_binary"
    mesh_fit = True

    def fit(self, data, label_col: str | None = None, device=None,
            mesh=None) -> DecisionTreeModel:
        grown = _fit_grown(data, label_col or self.label_col, self.weight_col, device,
                           mesh=mesh, task="classification", num_classes=self.num_classes,
                           num_trees=1, **self._grow_kw())
        return _from_grown(DecisionTreeModel, grown, "classification", self.num_classes)
