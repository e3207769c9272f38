"""Level-order histogram trees: decision trees, random forests and
gradient-boosted trees."""

from .decision_tree import (
    DecisionTreeClassifier,
    DecisionTreeModel,
    DecisionTreeRegressor,
)
from .engine import (
    DeferredForest,
    GrownForest,
    device_tree_arrays,
    grow_forest,
    grow_forest_outofcore,
    predict_forest,
)
from .binning import digitize, quantile_thresholds
from .gbt import GBTClassifier, GBTModel, GBTRegressor
from .random_forest import (
    RandomForestClassifier,
    RandomForestModel,
    RandomForestRegressor,
)

__all__ = [
    "DecisionTreeClassifier", "DecisionTreeModel", "DecisionTreeRegressor",
    "DeferredForest", "GBTClassifier", "GBTModel", "GBTRegressor", "GrownForest", "RandomForestClassifier", "RandomForestModel",
    "RandomForestRegressor", "device_tree_arrays", "grow_forest", "grow_forest_outofcore",
    "predict_forest", "digitize", "quantile_thresholds",
]
