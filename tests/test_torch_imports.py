"""The port stands alone: it imports neither jax nor the JAX package, and
its entry points refuse to run on the CPU unless asked."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port

# the suite runs several worker processes on a few cores: one intra-op
# thread per worker keeps torch from oversubscribing them
torch.set_num_threads(1)

PORT_DIR = Path(port.__file__).resolve().parent
REPO = PORT_DIR.parent
JAX_PKG = "clustermachinelearningforhospitalnetworks_apache_spark_tpu"

_IMPORT_ALL = f"""
import sys, pkgutil, importlib
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import {port.__name__} as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(k for k in sys.modules
             if k == "{JAX_PKG}" or k.startswith("{JAX_PKG}.")
             or (k.startswith("jax") and sys.modules[k] is not None))
print("LEAKED", bad)
"""


def test_whole_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


def test_no_port_source_names_the_jax_package():
    pat = re.compile(rf"\b{JAX_PKG}(?!_torch)\b|^\s*(import|from)\s+jax\b", re.M)
    files = [p for p in PORT_DIR.rglob("*") if p.suffix in (".py", ".cu", ".cuh", ".cpp")]
    assert len(files) > 10
    hits = [str(p) for p in files if pat.search(p.read_text())]
    assert hits == []


def test_every_module_is_walkable():
    names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    for expected in ("ops.lloyd", "ops.distance", "models.kmeans", "serve.server",
                     "evaluation.clustering", "features.scaler", "convert", "data",
                     "prng", "config", "core.split", "io.csv", "features.binarizer",
                     "evaluation.regression", "evaluation.classification",
                     "models.linear_regression", "models.tree.binning",
                     "models.tree.engine", "models.tree.decision_tree",
                     "models.tree.random_forest", "ops.tree_hist",
                     "pipeline.hospital_pipeline", "utils.faults", "utils.logging",
                     "io.integrity", "io.model_io", "obs.registry", "obs.trace",
                     "obs.flight_recorder", "obs.export", "streaming.wal",
                     "core.sql_parse", "core.sql_plan", "core.sql_views",
                     "core.sql_compile", "core.sql", "streaming.watermark",
                     "streaming.checkpoint", "streaming.source",
                     "streaming.unbounded_table", "streaming.microbatch", "session",
                     "viz.plots", "utils.metrics", "utils.retry", "utils.report",
                     "io.native", "models.streaming_kmeans", "models.gmm",
                     "models.bisecting_kmeans", "parallel", "parallel.outofcore",
                     "io.fit_checkpoint", "models.tree.gbt", "models.summary",
                     "models.logistic_regression", "models.linear_svc", "models.naive_bayes",
                     "models.one_vs_rest", "evaluation.binary", "pipeline.ml_pipeline",
                     "tuning", "tuning.tuning"):
        assert f"{port.__name__}.{expected}" in names


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(0).normal(size=(16, 3)).astype(np.float32)
    y01 = (x[:, 0] > 0).astype(np.float32)
    model = port.KMeansModel(x[:2].copy())
    # saving and loading compute nothing, so they need no device
    model.save(str(tmp_path / "km"))
    loaded = port.load_model(str(tmp_path / "km"))
    table = port.VectorAssembler(["a", "b", "c"]).transform(
        port.Table.from_dict({"a": x[:, 0], "b": x[:, 1], "c": x[:, 2]}))
    sql_table = port.Table.from_dict({"a": x[:, 0]})
    calls = [
        lambda: port.KMeans(k=2).fit(x),
        lambda: port.device_dataset(x),
        lambda: port.StandardScaler().fit(
            port.VectorAssembler(["a"]).transform(port.Table.from_dict({"a": x[:, 0]}))
        ),
        lambda: port.StandardScaler().fit(x),
        lambda: port.StandardScaler().fit_transform(x),
        lambda: port.ClusteringEvaluator().evaluate(x, np.zeros(16, np.int32), k=2),
        lambda: model.predict_numpy(x),
        lambda: port.serve.InferenceServer(),
        lambda: port.serve.bulk_score(model, x),
        lambda: port.LinearRegression().fit((x, x[:, 0])),
        lambda: port.DecisionTreeRegressor(max_depth=2).fit((x, x[:, 0])),
        lambda: port.RandomForestClassifier(num_trees=2).fit((x, x[:, 0] > 0)),
        lambda: port.linear_regression_model_from_jax_arrays(np.ones(3), 0.0).transform(x),
        lambda: port.run_model_stage(port.Table.from_dict(
            {c: np.arange(16.0) for c in (*port.FEATURE_COLS, port.LABEL_COL)})),
        lambda: port.serve.ModelRegistry().load("km", str(tmp_path / "km")),
        lambda: loaded.transform(table),
        lambda: port.sql_execute("SELECT * FROM t WHERE a > 0", lambda _n: sql_table),
        lambda: port.extract_training_window(sql_table),
        lambda: port.Session(),
        lambda: port.Session.builder.app_name("x").get_or_create(),
        lambda: port.run_pipeline(port.PipelineConfig(
            input_path=str(tmp_path / "in"), checkpoint_location=str(tmp_path / "ck")),
            make_plots=False),
        lambda: port.StreamExecution(
            source=port.FileStreamSource(str(tmp_path / "in"), port.hospital_event_schema()),
            sink=port.UnboundedTable(str(tmp_path / "t"), port.hospital_event_schema()),
            checkpoint=port.StreamCheckpoint(str(tmp_path / "ck2"))),
        lambda: port.StreamingKMeans(k=2).update(x),
        lambda: port.StreamingKMeans(k=2).update_many([x, x]),
        lambda: port.GaussianMixture(k=2).fit(x),
        lambda: port.BisectingKMeans(k=2).fit(x),
        lambda: port.gaussian_mixture_model_from_jax_arrays(
            np.full(2, 0.5), x[:2], np.stack([np.eye(3)] * 2)).predict_numpy(x),
        lambda: list(port.HostDataset(x).blocks()),
        lambda: port.KMeans(k=2).fit(port.HostDataset(x)),
        lambda: port.KMeans(k=2, distance_measure="cosine").fit(x),
        lambda: port.LinearRegression().fit(port.HostDataset(x, x[:, 0])),
        lambda: port.GaussianMixture(k=2).fit(port.HostDataset(x)),
        lambda: port.DecisionTreeRegressor(max_depth=2).fit(port.HostDataset(x, x[:, 0])),
        lambda: port.RandomForestClassifier(num_trees=2).fit(
            port.HostDataset(x, (x[:, 0] > 0).astype(np.float32))),
        lambda: port.GBTRegressor(max_iter=1).fit((x, x[:, 0])),
        lambda: port.GBTClassifier(max_iter=1).fit((x, (x[:, 0] > 0).astype(np.float32))),
        lambda: port.GBTRegressor(max_iter=1).fit(port.HostDataset(x, x[:, 0])),
        lambda: port.gbt_model_from_jax_arrays(
            -np.ones((1, 3), np.int32), np.zeros((1, 3)), np.zeros((1, 3, 1)), np.ones(3),
            task="regression", init=0.0, learning_rate=0.1, max_depth=1).predict_numpy(x),
        lambda: port.LinearRegression(reg_param=0.1, elastic_net_param=0.5).fit((x, x[:, 0])),
        lambda: port.KMeans(k=2, matmul_precision="bf16").fit(x),
        lambda: port.GaussianMixture(k=2, matmul_precision="bf16").fit(x),
        lambda: port.BisectingKMeans(k=2, distance_measure="cosine").fit(x),
        lambda: port.BisectingKMeans(k=2).fit(port.HostDataset(x)),
        # slice 5a
        lambda: port.LogisticRegression().fit((x, y01)),
        lambda: port.LogisticRegression(family="multinomial").fit((x, y01)),
        lambda: port.LogisticRegression().fit(port.HostDataset(x, y01)),
        lambda: port.BinaryClassificationEvaluator().evaluate(x[:, 0], y01),
        lambda: port.binary_curves(x[:, 0], y01),
        lambda: port.LinearSVC().fit((x, y01)),
        lambda: port.LinearSVC(reg_param=0.1).fit(port.HostDataset(x, y01)),
        lambda: port.NaiveBayes().fit((np.abs(x), y01)),
        lambda: port.NaiveBayes(model_type="gaussian").fit(port.HostDataset(x, y01)),
        lambda: port.OneVsRest(port.DecisionTreeClassifier(max_depth=2)).fit((x, y01)),
        lambda: port.Pipeline([port.VectorAssembler(["a", "b", "c"]),
                               port.LogisticRegression(label_col="y")]).fit(
            port.Table.from_dict({"a": x[:, 0], "b": x[:, 1], "c": x[:, 2], "y": y01})),
        lambda: port.CrossValidator(port.LogisticRegression(), [{"reg_param": 0.0}],
                                    port.BinaryClassificationEvaluator()).fit((x, y01)),
        lambda: port.TrainValidationSplit(port.LinearSVC(), [{"reg_param": 0.0}],
                                          port.MulticlassClassificationEvaluator()).fit((x, y01)),
        lambda: port.logistic_regression_model_from_jax_arrays(np.ones(3), 0.0).predict_numpy(x),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asked explicitly, the CPU works
    assert port.KMeans(k=2).fit(x, device="cpu").n_iter >= 1


def test_launch_counts_cover_every_kernel():
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import ops

    ops.reset_launch_counts()
    assert ops.launch_counts() == {"fused_lloyd_stats": 0, "fused_assign": 0,
                                   "fused_level_hist": 0}


SLICE_5B = ("ops.reductions", "stat", "stat.stat", "models.glm", "models.isotonic",
            "models.streaming_linear", "models._opt", "models.aft", "models.mlp", "models.fm")

_IMPORT_5B = f"""
import sys, importlib
sys.modules["jax"] = None          # any `import jax` or `import optax` now raises
sys.modules["optax"] = None
for m in {SLICE_5B!r}:
    importlib.import_module("{port.__name__}." + m)
bad = sorted(k for k in sys.modules
             if k == "{JAX_PKG}" or k.startswith("{JAX_PKG}.")
             or (k.split(".")[0] in ("jax", "optax") and sys.modules[k] is not None))
print("LEAKED", bad)
"""


def test_slice_5b_modules_import_neither_jax_nor_optax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_5B], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout
    names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    for expected in SLICE_5B:
        assert f"{port.__name__}.{expected}" in names
    pat = re.compile(r"^\s*(import|from)\s+optax\b", re.M)
    assert not [p for p in PORT_DIR.rglob("*.py") if pat.search(p.read_text())]


def test_slice_5b_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 3)).astype(np.float32)
    y01 = (x[:, 0] > 0).astype(np.float32)
    pos = np.exp(x[:, 0]).astype(np.float32)
    cen = np.ones(16, np.float32)
    calls = [
        lambda: port.GeneralizedLinearRegression(family="poisson").fit((x, pos)),
        lambda: port.GeneralizedLinearRegression().fit(port.HostDataset(x, pos)),
        lambda: port.IsotonicRegression().fit((x, pos)),
        lambda: port.StreamingLinearRegression().update((x, pos)),
        lambda: port.StreamingLogisticRegression().update((x, y01)),
        lambda: port.AFTSurvivalRegression().fit((x, pos), censor=cen),
        lambda: port.AFTSurvivalRegression().fit(port.HostDataset(x, pos), censor=cen),
        lambda: port.MultilayerPerceptronClassifier(layers=(3, 2)).fit((x, y01)),
        lambda: port.MultilayerPerceptronClassifier(layers=(3, 2)).fit(port.HostDataset(x, y01)),
        lambda: port.FMRegressor().fit((x, pos)),
        lambda: port.FMClassifier().fit(port.HostDataset(x, y01)),
        lambda: port.stat.Summarizer.summary(x),
        lambda: port.stat.Correlation.corr(x),
        lambda: port.stat.Correlation.corr(x, "spearman"),
        lambda: port.stat.ChiSquareTest.test(np.round(x), y01),
        lambda: port.stat.KolmogorovSmirnovTest.test(x[:, :1]),
        lambda: port.stat.ANOVATest.test(x, y01),
        lambda: port.stat.FValueTest.test(x, pos),
        lambda: port.isotonic_model_from_jax_arrays(np.ones(2), np.ones(2)).predict_numpy(x),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
