"""Estimators and models."""

from .aft import AFTSurvivalRegression, AFTSurvivalRegressionModel
from .fm import FMClassifier, FMModel, FMRegressor
from .glm import (
    GeneralizedLinearRegression,
    GeneralizedLinearRegressionModel,
    GeneralizedLinearRegressionTrainingSummary,
)
from .isotonic import IsotonicRegression, IsotonicRegressionModel
from .linear_svc import LinearSVC, LinearSVCModel
from .logistic_regression import (
    LogisticRegression,
    LogisticRegressionModel,
    MultinomialLogisticRegressionModel,
)
from .mlp import MultilayerPerceptronClassifier, MultilayerPerceptronModel
from .naive_bayes import NaiveBayes, NaiveBayesModel
from .one_vs_rest import OneVsRest, OneVsRestModel
from .streaming_linear import StreamingLinearRegression, StreamingLogisticRegression
from .summary import (
    BinaryLogisticRegressionTrainingSummary,
    MulticlassLogisticRegressionTrainingSummary,
)

__all__ = [
    "BinaryLogisticRegressionTrainingSummary", "LinearSVC", "LinearSVCModel",
    "LogisticRegression", "LogisticRegressionModel", "MulticlassLogisticRegressionTrainingSummary",
    "MultinomialLogisticRegressionModel", "NaiveBayes", "NaiveBayesModel", "OneVsRest",
    "OneVsRestModel",
    # slice 5b
    "AFTSurvivalRegression", "AFTSurvivalRegressionModel", "FMClassifier", "FMModel",
    "FMRegressor", "GeneralizedLinearRegression", "GeneralizedLinearRegressionModel",
    "GeneralizedLinearRegressionTrainingSummary", "IsotonicRegression",
    "IsotonicRegressionModel", "MultilayerPerceptronClassifier", "MultilayerPerceptronModel",
    "StreamingLinearRegression", "StreamingLogisticRegression",
]
