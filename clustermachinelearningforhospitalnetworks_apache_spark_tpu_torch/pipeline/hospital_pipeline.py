"""The end-to-end hospital pipeline — the reference script, working (the
JAX package's ``pipeline/hospital_pipeline.py``), on the session's mesh
(default every card; one card is a (1, 1) mesh, the single-device path):

  §1-2  config + session                     (:40-58)   → PipelineConfig/Session
  §3    schema + streaming ingest, watermark (:64-82)   → read_stream.csv + with_watermark
  §4    stream → unbounded table + ckpt      (:111-118) → write_stream.table (exactly-once)
  §5    training window extraction           (:123-128) → session.sql BETWEEN, compiled
  §6    features + split                     (:134-139) → VectorAssembler + seed-42 split
  §7    LR/DT/RF regression + RMSE           (:146-169)
  §8    LOS binarization + DT/RF cls + acc   (:176-198)
  §9    plots (files, not plt.show)          (:204-223)
  §10   feature importances                  (:228-235)
  §11   model save (overwrite)               (:241-243) — classifiers saved too
  §12   insights report + stop               (:245-258)

``run_pipeline`` runs them all.  Its parts are callable alone:
``extract_training_window`` is §5 over a bare ``Table``, and
``run_model_stage`` is §6–§11 over the windowed table (the trees grow
through K3 on the card); given ``mesh=`` it fits and transforms every
estimator over the mesh's data shards, as the reference's stage does with
``mesh=spark.mesh``.

Run: ``hospital-pipeline-torch --input-path ... [--device cuda] [--no-plots]
[--mesh-data N] [--mesh-model M]``
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..config import PipelineConfig
from ..core import sql as _sql
from ..core.schema import FEATURE_COLS, LABEL_COL, hospital_event_schema
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
from ..obs.registry import StageTiming
from ..session import Session
from ..utils.logging import get_logger
from ..utils.report import InsightsReport
from ..viz import plots

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
    """What the model stage hands on to ``PipelineResult``, plus host
    seconds per fit, evaluation and save (each ends with the device idle)
    and LinearRegression's test predictions and labels as host arrays
    (what §9 plots)."""

    regression_rmse: dict[str, float]
    classification_accuracy: dict[str, float]
    feature_importances: dict[str, dict[str, float]]
    training_rows: int
    models: dict[str, Any] = field(default_factory=dict)
    seconds: dict[str, float] = field(default_factory=dict)
    model_paths: dict[str, str] = field(default_factory=dict)
    lr_predictions: tuple[np.ndarray, np.ndarray] | None = None


@dataclass
class PipelineResult:
    regression_rmse: dict[str, float]
    classification_accuracy: dict[str, float]
    feature_importances: dict[str, dict[str, float]]
    model_paths: dict[str, str]
    plot_paths: dict[str, str]
    report: str
    training_rows: int
    models: dict[str, Any] = field(default_factory=dict)
    #: this run's stage timings by name (``ingest``, ``window``,
    #: ``fit:*``, ``eval:*``, ``save:*``), host seconds
    seconds: dict[str, float] = field(default_factory=dict)


def _window(run_sql, cfg: PipelineConfig) -> Table:
    """§5 through ``run_sql``: the reference's window query, then
    ``na_drop``; the route taken is logged, so a fall back to the
    interpreter is visible."""
    window_query = (
        f"SELECT * FROM {cfg.output_table} WHERE event_time BETWEEN "
        f"'{cfg.training_window_start}' AND '{cfg.training_window_end}'"
    )
    training_df = run_sql(window_query).na_drop()
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


def extract_training_window(table: Table, cfg: PipelineConfig | None = None,
                            device=None) -> Table:
    """§5 over ``table`` (answering for ``cfg.output_table``): the window
    query compiled on ``device`` (default the card), then ``na_drop``."""
    cfg = cfg or PipelineConfig()
    resolve = {cfg.output_table: table}.__getitem__
    return _window(lambda q: _sql.execute(q, resolve, device=device), cfg)


def run_model_stage(training_df: Table, cfg: PipelineConfig | None = None,
                    device=None, save_models: bool = False, mesh=None) -> StageResult:
    """§6–§10 on the windowed training table (after ``na_drop``), and
    §11 when ``save_models``: on ``device`` (default the card), or over
    ``mesh`` (each estimator fits, and each model transforms, over its
    data shards; a one-entry mesh is its device)."""
    cfg = cfg or PipelineConfig()
    if mesh is not None:
        if device is not None:
            raise ValueError("pass a mesh or a device, not both")
        where = {"mesh": mesh}
        devs = {e.device for e in mesh.devices.flat}
    else:
        dev = resolve_device(device)
        where = {"device": dev}
        devs = {dev}
    n_rows = training_df.num_rows
    if n_rows < 10:
        raise ValueError(
            f"training window has only {n_rows} rows; check input_path/"
            "training_window_start/end"
        )
    seconds: dict[str, float] = {}

    def timed(key: str, fn):
        t0 = time.perf_counter()
        out = fn()
        for d in devs:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        seconds[key] = time.perf_counter() - t0
        return out

    def scored(model, label: str, evaluator):
        preds = model.transform(test, label_col=label, **where)
        return preds, evaluator.evaluate(preds)

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
    preds = {}
    for name, est in regressors.items():
        model = timed(f"fit:{name}", lambda: est.fit(train, label_col=LABEL_COL, **where))
        preds[name], rmse[name] = timed(f"eval:{name}",
                                        lambda: scored(model, LABEL_COL, reg_eval))
        models[name] = model

    # §8: two classifiers on the binarized label + accuracy
    cls_eval = MulticlassClassificationEvaluator("accuracy", label_col=BINARY_LABEL)
    classifiers = {
        "DecisionTreeClassifier": DecisionTreeClassifier(max_depth=depth),
        "RandomForestClassifier": RandomForestClassifier(max_depth=depth, num_trees=ntrees),
    }
    accuracy: dict[str, float] = {}
    for name, est in classifiers.items():
        model = timed(f"fit:{name}", lambda: est.fit(train, label_col=BINARY_LABEL, **where))
        _, accuracy[name] = timed(f"eval:{name}", lambda: scored(model, BINARY_LABEL, cls_eval))
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
            timed(f"save:{name}", lambda: model.write().overwrite().save(path))
            model_paths[name] = path
    return StageResult(
        regression_rmse=rmse,
        classification_accuracy=accuracy,
        feature_importances=importances,
        training_rows=n_rows,
        models=models,
        seconds=seconds,
        model_paths=model_paths,
        lr_predictions=preds["LinearRegression"].to_numpy(),
    )


def run_pipeline(
    config: PipelineConfig | None = None,
    session: Session | None = None,
    save_models: bool = True,
    make_plots: bool = True,
    device=None,
    mesh=None,
) -> PipelineResult:
    """The whole job, §1–§12, over ``session``'s mesh, or a new session's
    (``mesh``, else the one-entry mesh of ``device``, else
    ``build_mesh(config.mesh)`` over every card; raises without one).
    ``make_plots`` needs matplotlib (the ``viz`` extra), checked before
    any work starts."""
    cfg = config or (session.config if session is not None else PipelineConfig())
    if make_plots:
        plots.figure_class()
    if session is not None:
        want = None if device is None else resolve_device(device)
        if ((mesh is not None and mesh != session.mesh) or (want is not None and (
                want.type != session.device.type
                or want.index not in (None, session.device.index)))):
            raise ValueError(f"device {device!r} / mesh {mesh} is not the session's "
                             f"({session.mesh})")
    owns_session = session is None
    spark = session or Session(cfg, device=device, mesh=mesh)
    try:
        return _run(cfg, spark, save_models, make_plots)
    finally:
        # §12 "stop" (:258): release the active-session slot only for a
        # session this call created — a caller's session stays theirs
        if owns_session:
            spark.stop()


def _run(cfg: PipelineConfig, spark: Session, save_models: bool,
         make_plots: bool) -> PipelineResult:
    metrics = spark.metrics
    first_timing = len(metrics.timings)

    # §3-4: streaming ingest → watermarked, checkpointed unbounded table
    with metrics.stage("ingest"):
        sdf = (
            spark.read_stream.schema(hospital_event_schema())
            .csv(cfg.input_path)
            .with_watermark("event_time", f"{cfg.watermark_minutes:g} minutes")
        )
        query = (
            sdf.write_stream.output_mode("append")
            .option("checkpointLocation", cfg.checkpoint_location)
            .table(cfg.output_table)
        )
        query.process_available()

    # §5: the training window, compiled on the session's device
    with metrics.stage("window"):
        training_df = _window(spark.sql, cfg)

    # §6-§8, §10, §11
    stage = run_model_stage(training_df, cfg, save_models=save_models, mesh=spark.mesh)
    metrics.timings.extend(StageTiming(name=k, seconds=v) for k, v in stage.seconds.items())

    # §9: plots → PNG files (:204-223)
    plot_paths: dict[str, str] = {}
    if make_plots:
        lr_pred, lr_actual = stage.lr_predictions
        plot_paths["predicted_vs_actual"] = plots.plot_predicted_vs_actual(
            lr_actual, lr_pred, cfg.plot_dir
        )
        plot_paths["residuals"] = plots.plot_residuals(lr_actual, lr_pred, cfg.plot_dir)

    # §12: insights report (:245-255)
    report = InsightsReport(
        app_name=cfg.app_name,
        regression_rmse=stage.regression_rmse,
        classification_accuracy=stage.classification_accuracy,
        feature_importances=stage.feature_importances,
        feature_cols=FEATURE_COLS,
        los_threshold=cfg.los_threshold,
    ).render()

    return PipelineResult(
        regression_rmse=stage.regression_rmse,
        classification_accuracy=stage.classification_accuracy,
        feature_importances=stage.feature_importances,
        model_paths=stage.model_paths,
        plot_paths=plot_paths,
        report=report,
        training_rows=stage.training_rows,
        models=stage.models,
        seconds={t.name: t.seconds for t in metrics.timings[first_timing:]},
    )


def main(argv=None) -> None:
    """Console entry: ``--device`` (one device; default the session's
    mesh over every card, shaped by ``--mesh-data`` / ``--mesh-model``),
    ``--no-plots`` (skip §9, for a machine without matplotlib), then every
    ``PipelineConfig`` flag; prints the report."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=None)
    p.add_argument("--no-plots", dest="make_plots", action="store_false")
    ns, rest = p.parse_known_args(argv)
    cfg = PipelineConfig.from_flags(rest)
    if ns.device is not None and (cfg.mesh.data > 1 or cfg.mesh.model > 1):
        # a mesh of more than one entry on the named device: its shards
        # repeat the device (the port's virtual mesh)
        from ..parallel.mesh import build_mesh

        size = cfg.mesh.data * max(cfg.mesh.model, 1)
        result = run_pipeline(cfg, mesh=build_mesh(cfg.mesh, [ns.device] * size),
                              make_plots=ns.make_plots)
    else:
        result = run_pipeline(cfg, device=ns.device, make_plots=ns.make_plots)
    print(result.report)


if __name__ == "__main__":
    main()
