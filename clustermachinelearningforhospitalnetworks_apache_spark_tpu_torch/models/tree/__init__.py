"""Level-order histogram trees: decision trees and random forests."""

from .decision_tree import (
    DecisionTreeClassifier,
    DecisionTreeModel,
    DecisionTreeRegressor,
)
from .engine import GrownForest, grow_forest, grow_forest_outofcore, predict_forest
from .random_forest import (
    RandomForestClassifier,
    RandomForestModel,
    RandomForestRegressor,
)

__all__ = [
    "DecisionTreeClassifier", "DecisionTreeModel", "DecisionTreeRegressor",
    "GrownForest", "RandomForestClassifier", "RandomForestModel",
    "RandomForestRegressor", "grow_forest", "grow_forest_outofcore", "predict_forest",
]
