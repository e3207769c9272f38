"""Evaluators."""

from .binary import BinaryClassificationEvaluator, binary_curves
from .classification import MulticlassClassificationEvaluator
from .clustering import ClusteringEvaluator, inertia
from .ranking import MultilabelClassificationEvaluator, RankingEvaluator
from .regression import RegressionEvaluator

__all__ = [
    "BinaryClassificationEvaluator", "ClusteringEvaluator", "MulticlassClassificationEvaluator",
    "MultilabelClassificationEvaluator", "RankingEvaluator", "RegressionEvaluator",
    "binary_curves", "inertia",
]
