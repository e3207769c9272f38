"""Training summaries (the clustering part of the JAX package's
``models/summary.py``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ClusteringSummary:
    """``pyspark.ml.clustering.*Summary`` surface (KMeans / Bisecting /
    GaussianMixture): sizes + objective, already computed by the fit."""

    k: int
    num_iter: int
    cluster_sizes: np.ndarray | None = None
    training_cost: float | None = None      # KMeans / Bisecting
    log_likelihood: float | None = None     # GaussianMixture
