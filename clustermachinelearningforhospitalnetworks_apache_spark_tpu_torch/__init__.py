"""PyTorch + CUDA port of the hospital-network ML framework.

Mirrors the JAX package's module paths and public names.  Slice 1 covers
the KMeans k=256 path: Table → VectorAssembler → StandardScaler → KMeans
fit/predict → silhouette, and the online server that answers requests
with the fitted model.  Slice 2 covers the hospital pipeline's model
stage: CSV → Binarizer → seed-42 split → VectorAssembler →
LinearRegression, decision-tree and random-forest regressors and
classifiers → RMSE, accuracy and feature importances.  Models save to
and load from the JAX package's artifact layout (``io/model_io.py``:
``model.write().overwrite().save(path)``, ``load_model(path)``), so a
model fitted by either package serves from the other.  Slice 3b covers
the SQL training window: the parser, the planner and the numpy
interpreter, with the compiled executor running fully supported
single-table plans as torch ops over columns on the card
(``sql_execute``, ``sql_explain``, ``extract_training_window``).  Slice
3c covers ingest and the whole job: CSV files streamed through the
watermark into the checkpointed, exactly-once unbounded table
(``Session``, ``read_stream … write_stream … table``, ``StreamExecution``),
the window through ``Session.sql``, the model stage, plots, saves and the
report (``run_pipeline``; the ``hospital-pipeline-torch`` console entry).
Slices 4a–4c add the other clusterings (StreamingKMeans, GaussianMixture,
BisectingKMeans), the out-of-core fits (``HostDataset``) and KMeans' and
GaussianMixture's reduced-precision modes; slice 3e the gradient-boosted
trees (``GBTRegressor``, ``GBTClassifier``) and LinearRegression's elastic
net and training summary.  Slice 5a adds the ``LOS_binary`` classifiers:
LogisticRegression (binomial and multinomial, resident and out of core)
with its training summaries and ROC / PR curves,
BinaryClassificationEvaluator, LinearSVC, NaiveBayes, OneVsRest, and the
composites ``Pipeline`` / ``PipelineModel``, ``CrossValidator`` and
``TrainValidationSplit``.
Hand-written
Hopper kernels (``csrc/``) carry the Lloyd step, the assignment and the
trees' level histograms on the card; entry points default to
``device="cuda"`` and run on the CPU only when asked.
"""

from . import serve, viz
from .config import PipelineConfig
from .convert import (
    bisecting_kmeans_model_from_jax_arrays,
    gaussian_mixture_model_from_jax_arrays,
    gbt_model_from_jax_arrays,
    kmeans_model_from_jax_arrays,
    linear_regression_model_from_jax_arrays,
    linear_svc_model_from_jax_arrays,
    logistic_regression_model_from_jax_arrays,
    multinomial_logistic_regression_model_from_jax_arrays,
    naive_bayes_model_from_jax_arrays,
    scaler_model_from_jax_arrays,
    streaming_kmeans_model_from_jax_arrays,
    tree_model_from_jax_arrays,
)
from .core.schema import FEATURE_COLS, LABEL_COL, Field, Schema, hospital_event_schema
from .core.split import random_split, split_indices, train_test_split
from .core.sql import execute as sql_execute
from .core.sql import explain as sql_explain
from .core.table import Table
from .data import DeviceDataset, device_dataset
from .device import resolve_device
from .evaluation.binary import BinaryClassificationEvaluator, binary_curves
from .evaluation.classification import MulticlassClassificationEvaluator
from .evaluation.clustering import ClusteringEvaluator
from .evaluation.regression import RegressionEvaluator
from .features.assembler import AssembledTable, VectorAssembler
from .features.binarizer import Binarizer
from .features.scaler import StandardScaler, StandardScalerModel
from .io.csv import read_csv, read_csv_dir, write_csv
from .io.fit_checkpoint import FitCheckpointer
from .io.model_io import CorruptArtifactError, load_model
from .models.base import PredictionResult
from .models.bisecting_kmeans import BisectingKMeans, BisectingKMeansModel
from .models.gmm import GaussianMixture, GaussianMixtureModel
from .models.kmeans import KMeans, KMeansModel
from .models.linear_regression import LinearRegression, LinearRegressionModel
from .models.linear_svc import LinearSVC, LinearSVCModel
from .models.logistic_regression import (
    LogisticRegression,
    LogisticRegressionModel,
    MultinomialLogisticRegressionModel,
)
from .models.naive_bayes import NaiveBayes, NaiveBayesModel
from .models.one_vs_rest import OneVsRest, OneVsRestModel
from .models.summary import (
    BinaryLogisticRegressionTrainingSummary,
    MulticlassLogisticRegressionTrainingSummary,
)
from .models.streaming_kmeans import StreamingKMeans, StreamingKMeansModel
from .models.tree import (
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
from .parallel.outofcore import HostDataset
from .pipeline.ml_pipeline import Pipeline, PipelineModel, load_pipeline_model
from .pipeline.hospital_pipeline import (
    PipelineResult,
    StageResult,
    extract_training_window,
    run_model_stage,
    run_pipeline,
)
from .session import Session
from .streaming import (
    FileStreamSource,
    StreamCheckpoint,
    StreamExecution,
    UnboundedTable,
    WatermarkTracker,
)
from .tuning import (
    CrossValidator,
    CrossValidatorModel,
    ParamGridBuilder,
    TrainValidationSplit,
    TrainValidationSplitModel,
)
from .version import __version__

__all__ = [
    "AssembledTable", "Binarizer", "BisectingKMeans", "BisectingKMeansModel",
    "ClusteringEvaluator", "GaussianMixture", "GaussianMixtureModel",
    "StreamingKMeans", "StreamingKMeansModel",
    "bisecting_kmeans_model_from_jax_arrays", "gaussian_mixture_model_from_jax_arrays",
    "gbt_model_from_jax_arrays",
    "streaming_kmeans_model_from_jax_arrays", "CorruptArtifactError",
    "DecisionTreeClassifier",
    "DecisionTreeModel", "DecisionTreeRegressor", "DeviceDataset", "FEATURE_COLS",
    "Field", "FitCheckpointer", "GBTClassifier", "GBTModel", "GBTRegressor",
    "HostDataset", "KMeans", "KMeansModel", "LABEL_COL",
    "LinearRegression",
    "LinearRegressionModel", "MulticlassClassificationEvaluator", "PipelineConfig",
    "FileStreamSource", "PipelineResult",
    "PredictionResult", "RandomForestClassifier", "RandomForestModel",
    "RandomForestRegressor", "RegressionEvaluator", "Schema", "Session", "StageResult",
    "StandardScaler", "StandardScalerModel", "StreamCheckpoint", "StreamExecution",
    "Table", "UnboundedTable", "VectorAssembler", "WatermarkTracker",
    "__version__", "device_dataset", "extract_training_window", "hospital_event_schema",
    "kmeans_model_from_jax_arrays", "linear_regression_model_from_jax_arrays",
    "load_model", "random_split", "read_csv", "read_csv_dir", "resolve_device", "run_model_stage",
    "run_pipeline", "write_csv",
    "scaler_model_from_jax_arrays", "serve", "split_indices", "sql_execute", "sql_explain",
    "train_test_split",
    "tree_model_from_jax_arrays",
    # slice 5a
    "BinaryClassificationEvaluator", "BinaryLogisticRegressionTrainingSummary",
    "CrossValidator", "CrossValidatorModel", "LinearSVC", "LinearSVCModel",
    "LogisticRegression", "LogisticRegressionModel",
    "MulticlassLogisticRegressionTrainingSummary", "MultinomialLogisticRegressionModel",
    "NaiveBayes", "NaiveBayesModel", "OneVsRest", "OneVsRestModel", "ParamGridBuilder",
    "Pipeline", "PipelineModel", "TrainValidationSplit", "TrainValidationSplitModel",
    "binary_curves", "linear_svc_model_from_jax_arrays",
    "load_pipeline_model", "logistic_regression_model_from_jax_arrays",
    "multinomial_logistic_regression_model_from_jax_arrays",
    "naive_bayes_model_from_jax_arrays", "viz",
]
