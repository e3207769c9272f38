"""Estimators and models."""

from .aft import AFTSurvivalRegression, AFTSurvivalRegressionModel
from .als import ALS, ALSModel
from .base import Estimator, Model, PredictionResult, as_device_dataset
from .bisecting_kmeans import BisectingKMeans, BisectingKMeansModel
from .fm import FMClassifier, FMModel, FMRegressor
from .fpm import FPGrowth, FPGrowthModel, PrefixSpan
from .glm import (
    GeneralizedLinearRegression,
    GeneralizedLinearRegressionModel,
    GeneralizedLinearRegressionTrainingSummary,
)
from .gmm import GaussianMixture, GaussianMixtureModel
from .isotonic import IsotonicRegression, IsotonicRegressionModel
from .kmeans import KMeans, KMeansModel
from .lda import LDA, LDAModel
from .linear_regression import LinearRegression, LinearRegressionModel
from .linear_svc import LinearSVC, LinearSVCModel
from .logistic_regression import (
    LogisticRegression,
    LogisticRegressionModel,
    MultinomialLogisticRegressionModel,
)
from .mlp import MultilayerPerceptronClassifier, MultilayerPerceptronModel
from .naive_bayes import NaiveBayes, NaiveBayesModel
from .one_vs_rest import OneVsRest, OneVsRestModel
from .pic import PowerIterationClustering
from .streaming_kmeans import StreamingKMeans, StreamingKMeansModel
from .streaming_linear import StreamingLinearRegression, StreamingLogisticRegression
from .summary import (
    BinaryLogisticRegressionTrainingSummary,
    MulticlassLogisticRegressionTrainingSummary,
)
from .tree import (
    DecisionTreeClassifier,
    DecisionTreeModel,
    DecisionTreeRegressor,
    GBTClassifier,
    GBTModel,
    GBTRegressor,
    RandomForestClassifier,
    RandomForestModel,
    RandomForestRegressor,
)

__all__ = [
    "AFTSurvivalRegression", "AFTSurvivalRegressionModel",
    "BinaryLogisticRegressionTrainingSummary", "BisectingKMeans", "BisectingKMeansModel",
    "DecisionTreeClassifier", "DecisionTreeModel", "DecisionTreeRegressor", "Estimator",
    "FMClassifier", "FMModel", "FMRegressor", "GBTClassifier", "GBTModel", "GBTRegressor",
    "GaussianMixture", "GaussianMixtureModel", "GeneralizedLinearRegression",
    "GeneralizedLinearRegressionModel", "GeneralizedLinearRegressionTrainingSummary",
    "IsotonicRegression", "IsotonicRegressionModel", "KMeans", "KMeansModel",
    "LinearRegression", "LinearRegressionModel", "LinearSVC", "LinearSVCModel",
    "LogisticRegression", "LogisticRegressionModel", "Model",
    "MulticlassLogisticRegressionTrainingSummary", "MultilayerPerceptronClassifier",
    "MultilayerPerceptronModel", "MultinomialLogisticRegressionModel", "NaiveBayes",
    "NaiveBayesModel", "OneVsRest", "OneVsRestModel", "PredictionResult",
    "RandomForestClassifier", "RandomForestModel", "RandomForestRegressor", "StreamingKMeans",
    "StreamingKMeansModel", "StreamingLinearRegression", "StreamingLogisticRegression",
    "as_device_dataset",
    # slice 5e
    "ALS", "ALSModel", "FPGrowth", "FPGrowthModel", "LDA", "LDAModel",
    "PowerIterationClustering", "PrefixSpan",
]
