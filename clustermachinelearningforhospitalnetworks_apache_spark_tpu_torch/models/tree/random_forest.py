"""RandomForestRegressor / RandomForestClassifier (the JAX package's
``models/tree/random_forest.py``).

Spark defaults: numTrees 20, maxDepth 5, subsamplingRate 1.0 with a
Poisson bootstrap, featureSubsetStrategy "onethird" (regression) /
"sqrt" (classification).  All trees grow at once: the tree axis is the
leading axis of every level's K3 launch; over a mesh, K3 runs once a data
shard a level and the bootstrap is the global draw cut by columns
(``engine.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ...io.model_io import register_model
from ..base import Estimator
from .decision_tree import _fit_grown, _from_grown, _TreeEnsembleModel, _TreeParams


def _subset_size(strategy: str, d: int, task: str) -> int | None:
    if strategy == "auto":
        strategy = "onethird" if task == "regression" else "sqrt"
    if strategy == "all":
        return None
    if strategy == "sqrt":
        return max(1, int(math.sqrt(d)))
    if strategy == "onethird":
        return max(1, d // 3)
    if strategy == "log2":
        return max(1, int(math.log2(d)))
    raise ValueError(f"unknown featureSubsetStrategy {strategy!r}")


@register_model("RandomForestModel")
@dataclass
class RandomForestModel(_TreeEnsembleModel):
    def _artifacts(self):
        return ("RandomForestModel", self._meta(), self._arrays())


@dataclass(frozen=True)
class RandomForestRegressor(Estimator, _TreeParams):
    num_trees: int = 20
    subsampling_rate: float = 1.0
    feature_subset_strategy: str = "auto"

    def fit(self, data, label_col: str | None = None, device=None,
            mesh=None) -> RandomForestModel:
        grown = _fit_grown(
            data, label_col or self.label_col, self.weight_col, device, mesh=mesh,
            subset_strategy=self.feature_subset_strategy, task="regression",
            num_trees=self.num_trees, bootstrap=True,
            subsampling_rate=self.subsampling_rate, **self._grow_kw(),
        )
        return _from_grown(RandomForestModel, grown, "regression", 2)


@dataclass(frozen=True)
class RandomForestClassifier(Estimator, _TreeParams):
    num_trees: int = 20
    num_classes: int = 2
    subsampling_rate: float = 1.0
    feature_subset_strategy: str = "auto"
    label_col: str = "LOS_binary"

    def fit(self, data, label_col: str | None = None, device=None,
            mesh=None) -> RandomForestModel:
        grown = _fit_grown(
            data, label_col or self.label_col, self.weight_col, device, mesh=mesh,
            subset_strategy=self.feature_subset_strategy, task="classification",
            num_classes=self.num_classes, num_trees=self.num_trees, bootstrap=True,
            subsampling_rate=self.subsampling_rate, **self._grow_kw(),
        )
        return _from_grown(RandomForestModel, grown, "classification", self.num_classes)
