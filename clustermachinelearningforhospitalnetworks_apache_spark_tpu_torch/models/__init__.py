"""Estimators and models."""

from .linear_svc import LinearSVC, LinearSVCModel
from .logistic_regression import (
    LogisticRegression,
    LogisticRegressionModel,
    MultinomialLogisticRegressionModel,
)
from .naive_bayes import NaiveBayes, NaiveBayesModel
from .one_vs_rest import OneVsRest, OneVsRestModel
from .summary import (
    BinaryLogisticRegressionTrainingSummary,
    MulticlassLogisticRegressionTrainingSummary,
)

__all__ = [
    "BinaryLogisticRegressionTrainingSummary", "LinearSVC", "LinearSVCModel",
    "LogisticRegression", "LogisticRegressionModel", "MulticlassLogisticRegressionTrainingSummary",
    "MultinomialLogisticRegressionModel", "NaiveBayes", "NaiveBayesModel", "OneVsRest",
    "OneVsRestModel",
]
