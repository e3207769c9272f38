"""Evaluators."""

from .binary import BinaryClassificationEvaluator, binary_curves
from .classification import MulticlassClassificationEvaluator
from .clustering import ClusteringEvaluator
from .regression import RegressionEvaluator

__all__ = [
    "BinaryClassificationEvaluator", "ClusteringEvaluator", "MulticlassClassificationEvaluator",
    "RegressionEvaluator", "binary_curves",
]
