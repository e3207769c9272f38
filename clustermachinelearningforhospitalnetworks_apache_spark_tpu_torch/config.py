"""Pipeline configuration: the ``PipelineConfig`` fields that the
hospital pipeline's training window, its model stage and its model save
read (the JAX package's ``config.py``, which mirrors the
reference script's ``CONFIG`` dict).  Ingest, the streaming checkpoint
and plots read the other fields, which come with them in a later slice
of the port."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class PipelineConfig:
    output_table: str = "hospital_unbounded_table"  # the table the window query reads
    training_window_start: str = "2025-03-31 22:00:00"
    training_window_end: str = "2025-03-31 23:00:00"
    los_threshold: float = 5.0            # LOS_binary = LOS > threshold
    train_fraction: float = 0.7           # randomSplit([0.7, 0.3], seed=42)
    split_seed: int = 42
    tree_max_depth: int = 5               # Spark's DT/RF defaults
    rf_num_trees: int = 20
    model_save_path: str = "./data/models/hospital"  # modelSavePath

    def replace(self, **kw: Any) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)
