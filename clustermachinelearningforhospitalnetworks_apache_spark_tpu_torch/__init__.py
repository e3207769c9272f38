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
(``sql_execute``, ``sql_explain``, ``extract_training_window``).
Hand-written
Hopper kernels (``csrc/``) carry the Lloyd step, the assignment and the
trees' level histograms on the card; entry points default to
``device="cuda"`` and run on the CPU only when asked.
"""

from . import serve
from .config import PipelineConfig
from .convert import (
    kmeans_model_from_jax_arrays,
    linear_regression_model_from_jax_arrays,
    scaler_model_from_jax_arrays,
    tree_model_from_jax_arrays,
)
from .core.schema import FEATURE_COLS, LABEL_COL, Field, Schema, hospital_event_schema
from .core.split import random_split, split_indices, train_test_split
from .core.sql import execute as sql_execute
from .core.sql import explain as sql_explain
from .core.table import Table
from .data import DeviceDataset, device_dataset
from .device import resolve_device
from .evaluation.classification import MulticlassClassificationEvaluator
from .evaluation.clustering import ClusteringEvaluator
from .evaluation.regression import RegressionEvaluator
from .features.assembler import AssembledTable, VectorAssembler
from .features.binarizer import Binarizer
from .features.scaler import StandardScaler, StandardScalerModel
from .io.csv import read_csv, read_csv_dir
from .io.model_io import CorruptArtifactError, load_model
from .models.base import PredictionResult
from .models.kmeans import KMeans, KMeansModel
from .models.linear_regression import LinearRegression, LinearRegressionModel
from .models.tree import (
    DecisionTreeClassifier,
    DecisionTreeModel,
    DecisionTreeRegressor,
    RandomForestClassifier,
    RandomForestModel,
    RandomForestRegressor,
)
from .pipeline.hospital_pipeline import StageResult, extract_training_window, run_model_stage
from .version import __version__

__all__ = [
    "AssembledTable", "Binarizer", "ClusteringEvaluator", "CorruptArtifactError",
    "DecisionTreeClassifier",
    "DecisionTreeModel", "DecisionTreeRegressor", "DeviceDataset", "FEATURE_COLS",
    "Field", "KMeans", "KMeansModel", "LABEL_COL", "LinearRegression",
    "LinearRegressionModel", "MulticlassClassificationEvaluator", "PipelineConfig",
    "PredictionResult", "RandomForestClassifier", "RandomForestModel",
    "RandomForestRegressor", "RegressionEvaluator", "Schema", "StageResult",
    "StandardScaler", "StandardScalerModel", "Table", "VectorAssembler",
    "__version__", "device_dataset", "extract_training_window", "hospital_event_schema",
    "kmeans_model_from_jax_arrays", "linear_regression_model_from_jax_arrays",
    "load_model", "random_split", "read_csv", "read_csv_dir", "resolve_device", "run_model_stage",
    "scaler_model_from_jax_arrays", "serve", "split_indices", "sql_execute", "sql_explain",
    "train_test_split",
    "tree_model_from_jax_arrays",
]
