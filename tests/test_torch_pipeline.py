"""The whole job: the port's ``run_pipeline`` against the JAX package's on
the same CSV drops (three files, 600 events of the pipeline test's law),
3 trees of depth 3, on the CPU; and the port's ``Session`` surface and
config loading.

Tolerances, and why (as ``tests/test_torch_hospital_stage.py``):
- the training rows, the accuracies and the artifact directory names are
  equal: the same parsed values through the same window and split;
- float LOS: RMSE at rtol 1e-4 — regression gains are float32 sums in
  another order, where a near tie may flip a split (ROADMAP queue 3);
- integer LOS: every histogram sum is exact, so the trees, their
  importances and the report text are equal; the trees' RMSE at rtol
  1e-6 (float32 predictions and float32 metric sums in another order),
  LinearRegression's at rtol 1e-5 (its two fits differ, below; 1.65e-6
  read);
- LinearRegression's predictions at rtol 1e-6, atol 1e-5: a float32 dot
  product summed in another order (its coefficients differ by up to
  ~4e-4 of the smallest one, ROADMAP queue 3);
- the predictions §9 plots come from each package's own LinearRegression
  fit, so they carry that coefficient difference: rtol 1e-5 (3.2e-6 read
  on float LOS), the plotted labels equal;
- a tree model's raw tree outputs are equal across packages, a random
  forest's mean over trees at rtol 1e-6.
"""

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.config import (
    MeshConfig,
    PipelineConfig as JConfig,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.io import write_csv as j_write_csv
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.session import (
    parse_duration_minutes as j_parse_duration,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.session import (
    Session,
    parse_duration_minutes,
)

# the suite runs several worker processes on a few cores: one intra-op
# thread per worker keeps torch from oversubscribing them
torch.set_num_threads(1)

J_PIPE = importlib.import_module(
    "clustermachinelearningforhospitalnetworks_apache_spark_tpu.pipeline.hospital_pipeline")
P_PLOTS = importlib.import_module(
    "clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.viz.plots")
CSV = str(Path(__file__).resolve().parents[1] / "data" / "hospital_patients.csv")
DEPTH, TREES = 3, 3
REGRESSORS = ("LinearRegression", "DecisionTreeRegressor", "RandomForestRegressor")
CLASSIFIERS = ("DecisionTreeClassifier", "RandomForestClassifier")
LR_TOL = dict(rtol=1e-6, atol=1e-5)


def _make_input(dirpath, n=600, seed=5, rounded=False):
    """``tests/test_pipeline.py``'s three drops, written by the port."""
    rng = np.random.default_rng(seed)
    os.makedirs(dirpath, exist_ok=True)
    base = np.datetime64("2025-03-31T22:00:00")
    for part in range(3):
        m = n // 3
        adm = rng.integers(0, 50, m)
        occ = rng.integers(20, 400, m)
        emer = rng.integers(0, 30, m)
        sea = rng.uniform(0.5, 1.5, m)
        los = 3.0 + 0.01 * occ + 0.08 * emer + rng.normal(0, 0.15, m)
        t = P.Table.from_dict(
            {
                "hospital_id": np.array([f"H{i % 4:02d}" for i in range(m)], dtype=object),
                "event_time": base + (part * m + np.arange(m)).astype("timedelta64[s]"),
                "admission_count": adm,
                "current_occupancy": occ,
                "emergency_visits": emer,
                "seasonality_index": sea,
                "length_of_stay": np.round(los) if rounded else los,
            },
            P.hospital_event_schema(),
        )
        P.write_csv(t, os.path.join(dirpath, f"drop_{part}.csv"))


def _fields(root, tag):
    return dict(
        input_path=str(root / "incoming"),
        checkpoint_location=str(root / tag / "ckpt"),
        model_save_path=str(root / tag / "models"),
        plot_dir=str(root / tag / "plots"),
        tree_max_depth=DEPTH,
        rf_num_trees=TREES,
    )


@pytest.fixture(scope="module", params=[False, True], ids=["float LOS", "integer LOS"])
def runs(request, tmp_path_factory):
    """One JAX ``run_pipeline`` and one port ``run_pipeline`` (on the CPU)
    over the same drops, each recording the data it plotted (when
    matplotlib is installed)."""
    plots = importlib.util.find_spec("matplotlib") is not None
    root = tmp_path_factory.mktemp("pipeline")
    _make_input(str(root / "incoming"), rounded=request.param)
    plotted = {"jax": [], "port": []}

    def recorder(tag, fn):
        def wrapped(actual, predicted, out_dir, *a, **k):
            plotted[tag].append((np.asarray(actual), np.asarray(predicted)))
            return fn(actual, predicted, out_dir, *a, **k)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J_PIPE, "plot_predicted_vs_actual",
                   recorder("jax", J_PIPE.plot_predicted_vs_actual))
        mp.setattr(P_PLOTS, "plot_predicted_vs_actual",
                   recorder("port", P_PLOTS.plot_predicted_vs_actual))
        jr = J_PIPE.run_pipeline(JConfig(**_fields(root, "jax"), mesh=MeshConfig(data=1)),
                                 make_plots=plots)
        pr = P.run_pipeline(P.PipelineConfig(**_fields(root, "port")), device="cpu",
                            make_plots=plots)
    return request.param, root, jr, pr, plotted


def test_training_rows_and_metrics(runs):
    rounded, _, jr, pr, _ = runs
    assert pr.training_rows == jr.training_rows == 600
    assert list(pr.regression_rmse) == list(REGRESSORS)
    assert list(pr.classification_accuracy) == list(CLASSIFIERS)
    for name, v in jr.regression_rmse.items():
        rtol = 1e-4 if not rounded else 1e-5 if name == "LinearRegression" else 1e-6
        np.testing.assert_allclose(pr.regression_rmse[name], v, rtol=rtol)
    assert pr.classification_accuracy == jr.classification_accuracy
    if not rounded:       # linear data: LinearRegression near the 0.15 noise
        assert pr.regression_rmse["LinearRegression"] < 0.3


def test_importances_and_report(runs):
    rounded, _, jr, pr, _ = runs
    assert list(pr.feature_importances) == list(jr.feature_importances)
    for name, imp in pr.feature_importances.items():
        assert list(imp) == list(P.FEATURE_COLS)
        assert abs(sum(imp.values()) - 1.0) < 1e-5
    if rounded:
        assert pr.feature_importances == jr.feature_importances
        assert pr.report == jr.report
    else:
        assert pr.report.splitlines()[:4] == jr.report.splitlines()[:4]
    assert "OPERATIONAL INSIGHTS" in pr.report


def test_stage_seconds_carry_the_stage_names(runs):
    _, _, _, pr, _ = runs
    names = list(pr.seconds)
    assert names[:2] == ["ingest", "window"]
    for name in (*REGRESSORS, *CLASSIFIERS):
        for kind in ("fit", "eval", "save"):
            assert f"{kind}:{name}" in names
    assert all(v >= 0 for v in pr.seconds.values())


def _predict_both(pm, jm, name):
    x = np.random.default_rng(7).uniform(0, 400, size=(64, 4)).astype(np.float32)
    got = pm.predict(torch.from_numpy(x)).numpy()
    ref = np.asarray(jm.predict(jnp.asarray(x)))
    if name == "LinearRegression":
        np.testing.assert_allclose(got, ref, **LR_TOL)
        return
    np.testing.assert_array_equal(pm._tree_outputs(torch.from_numpy(x)).numpy(),
                                  np.asarray(jm._tree_outputs(jnp.asarray(x))))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_artifacts_have_the_same_names_and_load_across_packages(runs):
    _, root, jr, pr, _ = runs
    assert sorted(os.listdir(root / "port" / "models")) == sorted(os.listdir(root / "jax" / "models"))
    assert {k: os.path.basename(v) for k, v in pr.model_paths.items()} == \
        {k: os.path.basename(v) for k, v in jr.model_paths.items()}
    for name, path in pr.model_paths.items():
        _predict_both(pr.models[name], J.load_model(path), name)
    for name, path in jr.model_paths.items():
        _predict_both(P.load_model(path), jr.models[name], name)


def test_plots_written_from_the_same_data(runs):
    pytest.importorskip("matplotlib")
    _, _, jr, pr, plotted = runs
    assert set(pr.plot_paths) == set(jr.plot_paths) == {"predicted_vs_actual", "residuals"}
    for path in pr.plot_paths.values():
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    ((pa, pp),), ((ja, jp),) = plotted["port"], plotted["jax"]
    np.testing.assert_array_equal(pa, ja)
    np.testing.assert_allclose(pp, jp, rtol=1e-5)
    assert pa.shape == pp.shape and pa.shape[0] > 100      # the 30 % test split


def test_plots_without_matplotlib_name_the_extra(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.figure", None)
    cfg = P.PipelineConfig(**_fields(tmp_path, "port"))
    with pytest.raises(ImportError, match="'viz' extra"):
        P.run_pipeline(cfg, device="cpu")
    assert not os.path.exists(cfg.checkpoint_location)   # refused before any work


def test_rerun_and_resume_do_not_duplicate_rows(tmp_path):
    """A second run over the same checkpoint runs no batch; a new drop
    lands as batch 1 and the window grows by exactly its rows."""
    _make_input(str(tmp_path / "incoming"))
    cfg = P.PipelineConfig(**{**_fields(tmp_path, "port"), "tree_max_depth": 2, "rf_num_trees": 2})
    r1 = P.run_pipeline(cfg, device="cpu", make_plots=False, save_models=False)
    r2 = P.run_pipeline(cfg, device="cpu", make_plots=False, save_models=False)
    assert r1.training_rows == r2.training_rows == 600
    assert r1.regression_rmse == r2.regression_rmse
    sink = P.UnboundedTable(cfg.checkpoint_location + "_table_" + cfg.output_table,
                            P.hospital_event_schema())
    assert sink.max_batch_id() == 0 and sink.num_rows() == 600
    extra = P.read_csv(str(tmp_path / "incoming" / "drop_0.csv"), P.hospital_event_schema())
    P.write_csv(extra.mask(np.arange(30)), str(tmp_path / "incoming" / "drop_3.csv"))
    r3 = P.run_pipeline(cfg, device="cpu", make_plots=False, save_models=False)
    assert r3.training_rows == 630 and sink.max_batch_id() == 1


def test_run_pipeline_uses_the_session_and_its_device(tmp_path, monkeypatch):
    _make_input(str(tmp_path / "incoming"), n=90)
    cfg = P.PipelineConfig(**{**_fields(tmp_path, "port"), "tree_max_depth": 2, "rf_num_trees": 2})
    spark = Session(cfg, device="cpu")
    try:
        res = P.run_pipeline(session=spark, make_plots=False, save_models=False)
        assert res.training_rows == 90
        assert [t.name for t in spark.metrics.timings[:2]] == ["ingest", "window"]
        # a caller's session stays theirs: run_pipeline did not stop it
        assert Session.builder.get_or_create() is spark
        assert spark.table(cfg.output_table).num_rows == 90
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        with pytest.raises(ValueError, match="session"):
            P.run_pipeline(session=spark, device="cuda", make_plots=False)
    finally:
        spark.stop()


def test_console_entry_runs_the_pipeline(tmp_path, capsys):
    _make_input(str(tmp_path / "incoming"), n=90)
    f = _fields(tmp_path, "port")
    argv = ["--device", "cpu", "--input-path", f["input_path"],
            "--checkpoint-location", f["checkpoint_location"],
            "--model-save-path", f["model_save_path"], "--plot-dir", f["plot_dir"],
            "--tree-max-depth", "2", "--rf-num-trees", "2", "--mesh-data", "4"]
    P.pipeline.hospital_pipeline.main(argv)
    out = capsys.readouterr().out
    assert "OPERATIONAL INSIGHTS — HospitalResourceDemandPrediction" in out
    assert sorted(os.listdir(f["model_save_path"])) == ["dt", "dt_class", "lr", "rf", "rf_class"]


def test_console_entry_without_plots_needs_no_matplotlib(tmp_path, capsys, monkeypatch):
    """``--no-plots`` is how the console entry runs on a machine without
    matplotlib: the report prints, no plot is drawn."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.figure", None)
    _make_input(str(tmp_path / "incoming"), n=90)
    f = _fields(tmp_path, "port")
    argv = ["--device", "cpu", "--no-plots", "--input-path", f["input_path"],
            "--checkpoint-location", f["checkpoint_location"],
            "--model-save-path", f["model_save_path"], "--plot-dir", f["plot_dir"],
            "--tree-max-depth", "2", "--rf-num-trees", "2"]
    P.pipeline.hospital_pipeline.main(argv)
    assert "OPERATIONAL INSIGHTS — HospitalResourceDemandPrediction" in capsys.readouterr().out
    assert not os.path.exists(f["plot_dir"])
    with pytest.raises(ImportError, match="'viz' extra"):
        P.pipeline.hospital_pipeline.main([a for a in argv if a != "--no-plots"])


# ============================================================== the config
def test_config_shared_fields_equal_the_jax_defaults():
    jf = {f.name: f.default for f in dataclasses.fields(JConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(P.PipelineConfig)}
    assert pf == jf
    for name in pf:
        if name != "mesh":
            assert type(getattr(P.PipelineConfig(), name)) is type(getattr(JConfig(), name)), name
    assert dataclasses.asdict(P.PipelineConfig().mesh) == dataclasses.asdict(JConfig().mesh)


def test_config_reads_a_jax_config_with_a_mesh(tmp_path):
    path = str(tmp_path / "cfg.json")
    JConfig(input_path="/in", rf_num_trees=7, mesh=MeshConfig(data=4, model=2)).save_json(path)
    cfg = P.PipelineConfig.from_json(path)
    assert cfg.input_path == "/in" and cfg.rf_num_trees == 7
    assert cfg.to_dict() == JConfig.from_json(path).to_dict()
    assert cfg.mesh == P.MeshConfig(data=4, model=2)
    camel = P.PipelineConfig.from_dict({"hdfsInputPath": "/h", "losThreshold": 6.0,
                                        "hdfsMaster": "spark://m:7077", "appName": "x"})
    assert (camel.input_path, camel.los_threshold, camel.app_name) == ("/h", 6.0, "x")
    flags = P.PipelineConfig.from_flags(["--config", path, "--mesh-data", "8",
                                         "--mesh-model", "1", "--los-threshold", "4.5"])
    assert flags.los_threshold == 4.5 and flags.rf_num_trees == 7
    assert flags.mesh == P.MeshConfig(data=8, model=1)
    out = str(tmp_path / "back.json")
    flags.save_json(out)
    assert json.load(open(out)) == flags.to_dict()
    assert JConfig.from_json(out).los_threshold == 4.5


# ============================================================= the session
def test_parse_duration_equals_jax():
    for text in ("10 minutes", "1 hour", "30 seconds", "2 days", "1.5 minute"):
        assert parse_duration_minutes(text) == j_parse_duration(text)
    with pytest.raises(ValueError):
        parse_duration_minutes("fortnight")


def test_session_sql_and_builder():
    spark = Session.builder.app_name("t").device("cpu").get_or_create()
    try:
        assert spark.config.app_name == "t" and spark.device == torch.device("cpu")
        assert Session.builder.app_name("two").get_or_create() is spark
        t = P.Table.from_dict({
            "event_time": np.datetime64("2025-01-01T00:00:00") + np.arange(10).astype("timedelta64[m]"),
            "v": np.arange(10).astype(float),
        })
        spark.register_table("events", t)
        out = spark.sql("SELECT * FROM events WHERE event_time BETWEEN "
                        "'2025-01-01 00:02:00' AND '2025-01-01 00:05:00'")
        assert out.num_rows == 4
        assert spark.sql_explain("SELECT * FROM events WHERE v > 3")["route"] == "compiled"
        assert spark.sql("SELECT count(*) AS n FROM events").column("n")[0] == 10
        with pytest.raises(KeyError):
            spark.table("nope")
    finally:
        spark.stop()
    s3 = Session.builder.appName("three").device("cpu").getOrCreate()
    assert s3 is not spark and s3.config.app_name == "three"
    s3.stop()


def test_fluent_streaming_api_with_foreach_batch(tmp_path):
    """The reference's chain shape (:75-82, :111-115)."""
    _make_input(str(tmp_path / "in"), n=90)
    spark = Session(P.PipelineConfig(checkpoint_location=str(tmp_path / "ck")), device="cpu")
    seen = []
    try:
        q = (
            spark.readStream.schema(P.hospital_event_schema())
            .csv(str(tmp_path / "in"))
            .withWatermark("event_time", "10 minutes")
            .writeStream.foreachBatch(lambda df, bid: seen.append((bid, df.num_rows)))
            .outputMode("append")
            .format("delta")
            .option("checkpointLocation", str(tmp_path / "ck"))
            .table("hospital_unbounded_table")
        )
        infos = q.processAllAvailable()
        assert sum(i.num_appended_rows for i in infos) == 90 and seen == [(0, 90)]
        assert spark.table("hospital_unbounded_table").num_rows == 90
        assert q.last_progress is infos[-1]
        assert q.awaitTermination(0.05) == []
        assert os.path.isfile(str(tmp_path / "ck") + "_table_hospital_unbounded_table/_commits.log")
        with pytest.raises(ValueError, match="append"):
            spark.read_stream.schema(P.hospital_event_schema()).csv("x").write_stream.output_mode("complete")
        with pytest.raises(ValueError, match="schema"):
            spark.read_stream.csv("x")
        with pytest.raises(ValueError, match="timeout"):
            q.await_termination()
    finally:
        spark.stop()


def test_headerless_stream_option_and_start(tmp_path):
    os.makedirs(tmp_path / "in")
    t = P.Table.from_dict(
        {
            "hospital_id": np.array(["H0", "H1"], dtype=object),
            "event_time": np.datetime64("2025-03-31T22:00:00") + np.arange(2).astype("timedelta64[s]"),
            "admission_count": [1, 2],
            "current_occupancy": [10, 20],
            "emergency_visits": [0, 1],
            "seasonality_index": [1.0, 1.1],
            "length_of_stay": [3.0, 4.0],
        },
        P.hospital_event_schema(),
    )
    P.write_csv(t, str(tmp_path / "in" / "x.csv"), header=False)
    spark = Session(P.PipelineConfig(), device="cpu")
    try:
        q = (
            spark.read_stream.schema(P.hospital_event_schema())
            .option("header", "false")
            .csv(str(tmp_path / "in"))
            .write_stream.option("checkpointLocation", str(tmp_path / "ck"))
            .start()
        )
        assert q.name == "stream_query_0"
        assert sum(i.num_appended_rows for i in q.process_available()) == 2
    finally:
        spark.stop()


def test_write_csv_equals_jax_bytes(tmp_path):
    t = P.read_csv(CSV, P.hospital_event_schema()).mask(np.arange(200))
    jt = J.Table.from_dict(dict(t.columns), J.hospital_event_schema())
    P.write_csv(t, str(tmp_path / "p.csv"))
    j_write_csv(jt, str(tmp_path / "j.csv"))
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    back = P.read_csv(str(tmp_path / "p.csv"), P.hospital_event_schema())
    for c in t.schema.names:
        np.testing.assert_array_equal(back[c], t[c])
