"""The hospital pipeline's training window and model stage: §5–§11 of the
JAX package's ``pipeline/hospital_pipeline.py::_run``.

§5, ``extract_training_window``: the reference's window query
(``SELECT * … WHERE event_time BETWEEN …``) through the SQL dispatcher,
which compiles it to torch ops over the table's columns on ``device``,
then ``na_drop``.  §6–§11, ``run_model_stage``, from the windowed table: the LOS_binary label (LOS > threshold),
the seed-42 70/30 split, the assembled features; LinearRegression,
DecisionTreeRegressor and RandomForestRegressor scored by RMSE;
DecisionTreeClassifier and RandomForestClassifier scored by accuracy; and
the feature importances; with ``save_models``, §11: each model written
with ``model.write().overwrite().save`` under ``cfg.model_save_path``.
Every fit and evaluation runs on ``device`` (default the card); the trees
grow through K3.

Ingest, plots and the report wrap these into ``run_pipeline`` in a later
slice of the port.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..config import PipelineConfig
from ..core import sql as _sql
from ..core.schema import FEATURE_COLS, LABEL_COL
from ..core.split import train_test_split
from ..core.table import Table
from ..device import resolve_device
from ..evaluation.classification import MulticlassClassificationEvaluator
from ..evaluation.regression import RegressionEvaluator
from ..features.assembler import VectorAssembler
from ..features.binarizer import Binarizer
from ..models.linear_regression import LinearRegression
from ..models.tree import (
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    RandomForestClassifier,
    RandomForestRegressor,
)
from ..utils.logging import get_logger

log = get_logger("pipeline")

BINARY_LABEL = "LOS_binary"

#: §11's artifact directory names under ``cfg.model_save_path``
SAVE_NAMES = {
    "LinearRegression": "lr",
    "DecisionTreeRegressor": "dt",
    "RandomForestRegressor": "rf",
    "DecisionTreeClassifier": "dt_class",
    "RandomForestClassifier": "rf_class",
}


@dataclass
class StageResult:
    """What the model stage hands on — the same fields as the JAX
    ``PipelineResult`` it fills, plus host seconds per fit, evaluation
    and save (each ends with the device idle)."""

    regression_rmse: dict[str, float]
    classification_accuracy: dict[str, float]
    feature_importances: dict[str, dict[str, float]]
    training_rows: int
    models: dict[str, Any] = field(default_factory=dict)
    seconds: dict[str, float] = field(default_factory=dict)
    model_paths: dict[str, str] = field(default_factory=dict)


def _timed(seconds: dict, key: str, dev: torch.device, fn):
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds[key] = time.perf_counter() - t0
    return out


def extract_training_window(table: Table, cfg: PipelineConfig | None = None,
                            device=None) -> Table:
    """§5: the reference's window query over ``table`` (answering for
    ``cfg.output_table``), compiled on ``device`` (default the card),
    then ``na_drop``; the route taken is logged, so a fall back to the
    interpreter is visible."""
    cfg = cfg or PipelineConfig()
    window_query = (
        f"SELECT * FROM {cfg.output_table} WHERE event_time BETWEEN "
        f"'{cfg.training_window_start}' AND '{cfg.training_window_end}'"
    )
    resolve = {cfg.output_table: table}.__getitem__
    training_df = _sql.execute(window_query, resolve, device=device).na_drop()
    n_rows = training_df.num_rows
    disp = _sql.last_dispatch()
    log.info(
        "training window extracted",
        rows=n_rows,
        sql_route=disp.route if disp else "unknown",
        sql_fallback=list(disp.reasons) if disp else [],
    )
    if n_rows < 10:
        raise ValueError(
            f"training window has only {n_rows} rows; check input_path/"
            "training_window_start/end"
        )
    return training_df


def run_model_stage(training_df: Table, cfg: PipelineConfig | None = None,
                    device=None, save_models: bool = False) -> StageResult:
    """§6–§10 on the windowed training table (after ``na_drop``), and
    §11 when ``save_models``."""
    cfg = cfg or PipelineConfig()
    dev = resolve_device(device)
    n_rows = training_df.num_rows
    if n_rows < 10:
        raise ValueError(
            f"training window has only {n_rows} rows; check input_path/"
            "training_window_start/end"
        )
    seconds: dict[str, float] = {}

    # §6: the label is binarized before the split, so one split + one
    # assembly pass serves both the regressors and the classifiers
    assembler = VectorAssembler(FEATURE_COLS)
    binarizer = Binarizer(LABEL_COL, BINARY_LABEL, cfg.los_threshold)
    train_t, test_t = train_test_split(
        binarizer.transform(training_df), cfg.train_fraction, cfg.split_seed
    )
    train = assembler.transform(train_t)
    test = assembler.transform(test_t)

    # §7: three regressors + RMSE
    reg_eval = RegressionEvaluator("rmse", label_col=LABEL_COL)
    depth, ntrees = cfg.tree_max_depth, cfg.rf_num_trees
    regressors = {
        "LinearRegression": LinearRegression(),
        "DecisionTreeRegressor": DecisionTreeRegressor(max_depth=depth),
        "RandomForestRegressor": RandomForestRegressor(max_depth=depth, num_trees=ntrees),
    }
    models: dict[str, Any] = {}
    rmse: dict[str, float] = {}
    for name, est in regressors.items():
        model = _timed(seconds, f"fit:{name}", dev,
                       lambda: est.fit(train, label_col=LABEL_COL, device=dev))
        rmse[name] = _timed(seconds, f"eval:{name}", dev, lambda: reg_eval.evaluate(
            model.transform(test, label_col=LABEL_COL, device=dev)))
        models[name] = model

    # §8: two classifiers on the binarized label + accuracy
    cls_eval = MulticlassClassificationEvaluator("accuracy", label_col=BINARY_LABEL)
    classifiers = {
        "DecisionTreeClassifier": DecisionTreeClassifier(max_depth=depth),
        "RandomForestClassifier": RandomForestClassifier(max_depth=depth, num_trees=ntrees),
    }
    accuracy: dict[str, float] = {}
    for name, est in classifiers.items():
        model = _timed(seconds, f"fit:{name}", dev,
                       lambda: est.fit(train, label_col=BINARY_LABEL, device=dev))
        accuracy[name] = _timed(seconds, f"eval:{name}", dev, lambda: cls_eval.evaluate(
            model.transform(test, label_col=BINARY_LABEL, device=dev)))
        models[name] = model

    # §10: feature importances of the tree models
    importances = {
        name: dict(zip(FEATURE_COLS, np.round(m.feature_importances, 6).tolist()))
        for name, m in models.items()
        if hasattr(m, "feature_importances")
    }

    # §11: persistence with overwrite, classifiers too
    model_paths: dict[str, str] = {}
    if save_models:
        for name, model in models.items():
            path = os.path.join(cfg.model_save_path, SAVE_NAMES[name])
            _timed(seconds, f"save:{name}", dev,
                   lambda: model.write().overwrite().save(path))
            model_paths[name] = path
    return StageResult(
        regression_rmse=rmse,
        classification_accuracy=accuracy,
        feature_importances=importances,
        training_rows=n_rows,
        models=models,
        seconds=seconds,
        model_paths=model_paths,
    )
