"""PyTorch + CUDA port of the hospital-network ML framework.

Mirrors the JAX package's module paths and public names.  Slice 1 covers
the KMeans k=256 path: Table → VectorAssembler → StandardScaler → KMeans
fit/predict → silhouette, and the online server that answers requests
with the fitted model.  Hand-written Hopper kernels (``csrc/``) carry the
Lloyd step and the assignment on the card; entry points default to
``device="cuda"`` and run on the CPU only when asked.
"""

from . import serve
from .convert import kmeans_model_from_jax_arrays, scaler_model_from_jax_arrays
from .core.schema import Field, Schema
from .core.table import Table
from .data import DeviceDataset, device_dataset
from .device import resolve_device
from .evaluation.clustering import ClusteringEvaluator
from .features.assembler import AssembledTable, VectorAssembler
from .features.scaler import StandardScaler, StandardScalerModel
from .models.kmeans import KMeans, KMeansModel
from .version import __version__

__all__ = [
    "AssembledTable", "ClusteringEvaluator", "DeviceDataset", "Field",
    "KMeans", "KMeansModel", "Schema", "StandardScaler", "StandardScalerModel",
    "Table", "VectorAssembler", "__version__", "device_dataset",
    "kmeans_model_from_jax_arrays", "resolve_device",
    "scaler_model_from_jax_arrays", "serve",
]
