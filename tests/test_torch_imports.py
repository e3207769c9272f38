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
                     "tuning", "tuning.tuning", "features.bucketizer", "features.discretizer",
                     "features.indexer", "features.onehot", "features.imputer",
                     "features.normalizer", "features.minmax", "features.robust", "features.pca",
                     "features.vector_ops", "features.rformula", "features.sql_transformer",
                     "io.libsvm", "features.selector", "features.lsh", "features.text",
                     "features.word2vec", "evaluation.ranking", "models.als", "models.lda",
                     "models.pic", "models.fpm", "core.segments", "core.table_lifecycle",
                     "core.sql_fuzz", "tune", "tune.knobs", "tune.store", "tune.select",
                     "tune.live", "quality", "quality.sketches", "quality.validators",
                     "quality.reconcile", "quality.drift", "quality.firewall",
                     "serve.breaker", "farm", "farm.farm", "farm.profiles", "farm.drift",
                     "lifecycle", "lifecycle.journal", "lifecycle.feedback",
                     "lifecycle.promotion", "lifecycle.controller", "lifecycle.farm",
                     "serve.fleet", "serve.fleet.placement", "serve.fleet.router",
                     "serve.fleet.admission", "serve.fleet.loadgen", "serve.fleet.watchdog",
                     "serve.fleet.replica_set", "serve.fleet.proc",
                     "serve.fleet._proc_worker", "soak", "soak.schedule", "soak.report",
                     "soak.resource_probe", "soak.driver", "soak.__main__",
                     "parallel.mesh", "parallel.distributed", "parallel.partitioner",
                     "parallel.sharding", "parallel.collectives", "parallel.federation"):
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


def test_slice_8c_2_block_shape_is_host_work_and_the_streams_default_to_the_card(
        monkeypatch):
    """Slice 8c-2's split: ``block_shape(mesh)`` is host arithmetic (a CPU
    mesh, no card), while ``blocks()`` / ``blocks(None)`` and
    ``streamed_standardization`` with neither a mesh nor a device stream to
    the card and raise without one; named CPU meshes run."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel as P
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.parallel import (
        outofcore,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.arange(90, dtype=np.float32).reshape(30, 3)
    y = (x[:, 0] > 40).astype(np.float32)
    hd = port.HostDataset(x, y, max_device_rows=7)
    mesh = P.build_mesh(port.MeshConfig(data=4, model=1), [torch.device("cpu")] * 4)
    assert hd.block_shape(mesh) == (4, 8) and hd.block_shape() == (5, 7)
    for call in (lambda: list(hd.blocks()), lambda: list(hd.blocks(None, np.float32)),
                 lambda: outofcore.streamed_standardization(hd),
                 lambda: outofcore.streamed_standardization(hd, extra="ymax"),
                 lambda: port.KMeans(k=2).fit(hd, device=None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert len(list(hd.blocks(mesh))) == 4
    assert outofcore.streamed_standardization(hd, mesh, extra="ymax")[3] == 1.0


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


def test_slice_5c_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.sql_compile import (
        compile_rowlevel,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(0).normal(size=(16, 3)).astype(np.float32)
    table = port.Table.from_dict({"a": x[:, 0], "b": x[:, 1], "c": x[:, 2]})
    asm = port.VectorAssembler(["a", "b", "c"]).transform(table)
    calls = [lambda: port.SQLTransformer("SELECT *, a + b AS s FROM __THIS__").transform(table),
             lambda: compile_rowlevel("SELECT a, b FROM t WHERE a > 0", lambda _n: table),
             lambda: port.Session().sql_to_device("SELECT a, b FROM t", feature_cols=("a",)),
             lambda: port.Pipeline([port.VectorAssembler(["a", "b"]), port.MinMaxScaler()]).fit(
                 table)]
    for est in (port.MinMaxScaler(), port.MaxAbsScaler(), port.RobustScaler(), port.PCA(2)):
        calls += [lambda est=est: est.fit(x), lambda est=est: est.fit(asm),
                  lambda est=est: est.fit(torch.from_numpy(x)),
                  lambda est=est: est.fit_transform(x)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asked explicitly, the CPU works
    assert port.PCA(2).fit(x, device="cpu").k == 2


def test_table_stages_are_host_work_and_need_no_card(monkeypatch):
    """The table stages compute in numpy on a host Table, as in the JAX
    package (and as Binarizer and VectorAssembler do): nothing of theirs
    runs on a device, so they run without one; the card starts at the
    matrix stages, ``to_device`` or ``device_dataset``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(1)
    t = port.Table.from_dict({"h": np.array(["a", "b", "a", "c"] * 4, dtype=object),
                              "v": rng.normal(size=16), "y": rng.normal(size=16)})
    t = port.StringIndexer("h", "hi").fit(t).transform(t)
    t = port.OneHotEncoder(["hi"]).fit(t).transform(t)
    t = port.Imputer(["v"], ["vi"]).fit(t).transform(t)
    t = port.QuantileDiscretizer(3, "v", "vb").fit(t).transform(t)
    t = port.IndexToString("hi", "h2", ("a", "b", "c")).transform(t)
    a = port.RFormula("y ~ h + v").fit_transform(t)
    assert a.features.shape == (16, 3) and list(t.column("h2")) == list(t.column("h"))
    for stage in (port.Normalizer(), port.PolynomialExpansion(2), port.VectorSlicer((0,)),
                  port.ElementwiseProduct((1.0, 2.0, 3.0)), port.Interaction((0,), (1,)),
                  port.VectorSizeHint(3)):
        assert isinstance(stage.transform(a), port.AssembledTable)



def test_slices_5d_5e_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(16, 3)).astype(np.float32)
    counts = rng.poisson(2.0, size=(16, 6)).astype(np.float32)
    table = port.Table.from_dict({"a": x[:, 0], "b": np.round(x[:, 1]), "y": x[:, 2] > 0})
    asm = port.VectorAssembler(["a", "b"]).transform(table)
    uu, ii = np.repeat(np.arange(4), 3), np.tile(np.arange(3), 4)
    ratings = (uu, ii, rng.normal(size=12).astype(np.float32))
    als = port.als_model_from_jax_arrays(x[:4], x[:3])
    lda = port.lda_model_from_jax_arrays(np.ones((2, 6), np.float32), alpha=0.5, eta=0.5)
    docs = [["a", "b", "a"], ["b", "c"]] * 4
    calls = [
        lambda: port.UnivariateFeatureSelector(label_col="y").fit(asm),
        lambda: port.UnivariateFeatureSelector("continuous", "continuous", label_col="a").fit(
            asm),
        lambda: port.ChiSqSelector(label_col="y").fit(asm),
        lambda: port.VarianceThresholdSelector().fit(asm),
        lambda: port.DCT().transform(x),
        lambda: port.Word2Vec(min_count=1).fit(docs),
        lambda: port.ALS(rank=2).fit(ratings),
        lambda: als.recommend_for_all_users(2),
        lambda: als.recommend_for_all_items(2),
        lambda: als.recommend_for_user_subset([0], 2),
        lambda: als.recommend_for_item_subset([0], 2),
        lambda: port.LDA(k=2).fit(counts),
        lambda: port.LDA(k=2).fit(port.HostDataset(counts)),
        lambda: lda.transform(counts),
        lambda: lda.log_perplexity(counts),
        lambda: port.PowerIterationClustering().assign_clusters([0, 1], [1, 2]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asked explicitly, the CPU works; a tensor computes where it lies
    assert port.DCT().transform(torch.from_numpy(x)).device.type == "cpu"
    assert port.ALS(rank=2, max_iter=1).fit(ratings, device="cpu").rank == 2
    assert port.VarianceThresholdSelector().fit(port.device_dataset(x, device="cpu")).selected


def test_slices_5d_5e_host_stages_take_no_device_and_need_no_card(monkeypatch):
    """VectorIndexer, the LSH families, the text stages, FeatureHasher,
    FPGrowth, PrefixSpan, the ranking evaluators and ``ALSModel.predict``
    compute in numpy, as in the JAX package: none takes ``device=`` and
    none needs a card."""
    import inspect

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(3).normal(size=(20, 3))
    texts = ["Patient admitted to the ICU", "the ward", "ICU discharge note"]
    toks = port.Tokenizer().transform(texts)
    stages = [
        (port.VectorIndexer(), lambda s: s.fit(x).transform(x)),
        (port.BucketedRandomProjectionLSH(1.0, 2),
         lambda s: s.fit(x).approx_similarity_join(x, x, 1.0)),
        (port.MinHashLSH(2), lambda s: s.fit(np.abs(x) > 0.1).approx_nearest_neighbors(
            np.abs(x) > 0.1, np.ones(3), 2)),
        (port.Tokenizer(), lambda s: s.transform(texts)),
        (port.RegexTokenizer(), lambda s: s.transform(texts)),
        (port.StopWordsRemover(), lambda s: s.transform(toks)),
        (port.NGram(2), lambda s: s.transform(toks)),
        (port.CountVectorizer(), lambda s: s.fit(toks).transform(toks)),
        (port.HashingTF(16), lambda s: s.transform(toks)),
        (port.IDF(), lambda s: s.fit(np.ones((3, 4))).transform(np.ones((3, 4)))),
        (port.FeatureHasher(8), lambda s: s.transform([{"a": 1.0, "b": "x"}])),
        (port.FPGrowth(0.3), lambda s: s.fit(toks).transform(toks)),
        (port.PrefixSpan(0.3), lambda s: s.find_frequent_sequential_patterns([[["a"], ["b"]]])),
        (port.RankingEvaluator(), lambda s: s.evaluate([[1, 2]], [[2]])),
        (port.MultilabelClassificationEvaluator(), lambda s: s.evaluate([[1, 2]], [[2]])),
        (port.als_model_from_jax_arrays(np.ones((2, 2)), np.ones((2, 2))),
         lambda s: s.predict([0, 1], [1, 0])),
    ]
    for stage, run in stages:
        model = run(stage)
        for obj in (stage, model):
            # ALSModel's recommend_* score on a device; its predict is host work
            names = ("predict",) if isinstance(obj, port.ALSModel) else (
                "fit", "transform", "evaluate", "find_frequent_sequential_patterns",
                "approx_similarity_join", "approx_nearest_neighbors")
            for name in names:
                fn = getattr(obj, name, None)
                if callable(fn):
                    assert "device" not in inspect.signature(fn).parameters, (obj, name)

def test_slice_6_entry_points_default_to_the_card_and_raise_without_one(monkeypatch, tmp_path):
    """The views, the incremental partials and the fuzz checkers compute
    on ``device=`` (default the card); asked for the CPU, they run."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import sql_fuzz
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.sql_compile import (
        run_partial_aggregate,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.sql_parse import (
        parse,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.sql_plan import (
        plan_query,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.sql_views import (
        MaterializedView,
        ViewRegistry,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    table = sql_fuzz.random_table(rng, 30)
    sink = port.UnboundedTable(str(tmp_path / "t"), table.schema, name="fuzz")
    sink.append_batch(table, 0)
    q = "SELECT i1, count(*) AS c, sum(f1) AS s FROM fuzz GROUP BY i1"
    plan = plan_query(parse(q), lambda _n: table)
    spec = sql_fuzz.random_query(rng)
    seq = sql_fuzz.ReplaySeq((table,))
    calls = [
        lambda: ViewRegistry(),
        lambda: MaterializedView("v", q, sink),
        lambda: run_partial_aggregate(plan, table),
        lambda: sql_fuzz.check_spec(spec, table),
        lambda: sql_fuzz.check_view_spec(spec, seq),
        lambda: sql_fuzz.run_fuzz(2),
        lambda: sql_fuzz.run_fuzz_incremental(1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    view = ViewRegistry(device="cpu").register("v", q, sink)
    assert view.device.type == "cpu" and len(view.read()) == len(set(table.column("i1")))
    assert run_partial_aggregate(plan, table, device="cpu")[1].shape[1] == 3


def test_slice_6_host_entry_points_take_no_device_and_need_no_card(monkeypatch, tmp_path):
    """Segments, the lifecycle, the table's reads and pruning, the partial
    rewrite and the fuzz generators compute in numpy and pyarrow, as in
    the JAX package: none takes ``device=`` and none needs a card."""
    import inspect

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import (
        segments,
        sql_fuzz,
        table_lifecycle,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.sql_compile import (
        partial_plan_outputs,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fns = [segments.zone_maps, segments.write_segment, segments.read_segment,
           segments.load_manifest, segments.quarantine_segment, segments.segment_may_match,
           table_lifecycle.RetentionPolicy, table_lifecycle.TableLifecycle,
           table_lifecycle.TableLifecycle.seal, table_lifecycle.TableLifecycle.retire,
           table_lifecycle.TableLifecycle.scrub, table_lifecycle.TableLifecycle.tick,
           port.UnboundedTable.read, port.UnboundedTable.prune_stats,
           port.UnboundedTable.scan_pruned, port.UnboundedTable.read_sealed_batch,
           partial_plan_outputs, sql_fuzz.random_table, sql_fuzz.random_query,
           sql_fuzz.mergeable_query, sql_fuzz.compare_tables, sql_fuzz.shrink]
    for fn in fns:
        assert "device" not in inspect.signature(fn).parameters, fn
    rng = np.random.default_rng(1)
    sink = port.UnboundedTable(str(tmp_path / "t"), sql_fuzz.random_table(rng, 1).schema)
    for bid in range(6):
        sink.append_batch(sql_fuzz.random_table(rng, 20), bid)
    out = table_lifecycle.TableLifecycle(sink, table_lifecycle.RetentionPolicy(
        min_seal_batches=2, hot_batches=1, max_segment_batches=2)).tick()
    assert out == {"sealed": 2, "retired": 4}
    assert len(sink.read()) == 120 and len(sink.read_sealed_batch(0)) == 20
    assert sink.prune_stats(("cmp", "i2", ">", 1000))["segments_pruned"] == 2
    assert sql_fuzz.compare_tables(sink.read(), sink.read()) is None


def test_slice_7a_entry_points_default_to_the_card_and_raise_without_one(monkeypatch,
                                                                         tmp_path):
    """The server takes ``device=`` (default the card) and raises without
    one; ``add_model`` and ``prepare_swap`` build on the server's device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(4).normal(size=(16, 3)).astype(np.float32)
    model = port.KMeansModel(x[:2].copy())
    model.save(str(tmp_path / "km"))
    calls = [
        lambda: port.serve.InferenceServer(),
        lambda: port.serve.InferenceServer(breaker_failure_threshold=2, breaker_recovery_s=0.5,
                                           ingest_metrics=port.utils.MetricsRegistry()),
        lambda: port.serve.InferenceServer(max_wait_s=None, max_queue_rows=None),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    srv = port.serve.InferenceServer(device="cpu")
    profile = port.DataProfile.from_matrix(x.astype(np.float64), ["a", "b", "c"])
    assert srv.add_model("km", str(tmp_path / "km"), input_policy="impute",
                         data_profile=profile.to_dict()).device.type == "cpu"
    assert srv.prepare_swap("km", model).sm.device.type == "cpu"
    assert srv.prepare_swap("km", str(tmp_path / "km")).sm.device.type == "cpu"


def test_slice_7a_host_entry_points_take_no_device_and_need_no_card(monkeypatch, tmp_path):
    """The quality stages, the firewall and its salvage parser, the knob
    registry, the trial store, the selector, the live retuner and the
    circuit breaker are host code, as in the JAX package: none takes
    ``device=`` and none needs a card."""
    import inspect

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import io, quality, tune
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve import (
        CircuitBreaker,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fns = [quality.FeatureSketch, quality.FeatureSketch.update, quality.DataProfile.from_matrix,
           quality.DataProfile.update_matrix, quality.DataProfile.psi_against,
           quality.population_stability_index, quality.ConstraintSet, quality.RowValidator,
           quality.RowValidator.validate, quality.hospital_constraints,
           quality.reconcile_columns, quality.DriftMonitor, quality.DriftMonitor.observe,
           quality.InputGuard, quality.InputGuard.inspect, quality.DataFirewall,
           quality.DataFirewall.ingest_file, quality.DataFirewall.ingest_table,
           io.read_csv_salvage, io.read_csv_dir_salvage, io.csv.salvage_from_text,
           tune.knob, tune.default, tune.TrialStore, tune.make_trial, tune.Selector,
           tune.Selector.resolve, tune.LiveRetuner, tune.LiveRetuner.retune, CircuitBreaker,
           port.FileStreamSource.read_files_audited, port.StreamCheckpoint.quarantine_rows]
    for fn in fns:
        assert "device" not in inspect.signature(fn).parameters, fn
    schema = port.hospital_event_schema()
    rows = ["hospital_id,event_time,admission_count,current_occupancy,emergency_visits,"
            "seasonality_index,length_of_stay",
            "H1,2025-03-31 10:00:00,5,100,3,1.0,4.0",
            "H1,2025-03-31 10:01:00,oops,100,3,1.0,4.0",
            "H2,2025-03-31 10:02:00,5,-1,3,1.0,4.0"]
    (tmp_path / "a.csv").write_text("\n".join(rows) + "\n")
    fw = port.DataFirewall(schema, port.hospital_constraints())
    res = fw.ingest_file(str(tmp_path / "a.csv"))
    assert len(res.table) == 1 and res.histogram == {"parse:admission_count": 1,
                                                      "range:current_occupancy": 1}
    store = tune.TrialStore(str(tmp_path / "trials.json"))
    store.add([tune.make_trial(knob="serve.queue.max_rows", value=v, score=s)
               for v, s in ((1024, 1.0), (8192, 2.0))])
    with tune.active(tune.Selector(store)):
        assert tune.knob("serve.queue.max_rows") == 8192
    assert tune.knob("serve.queue.max_rows") == 4096
    b = CircuitBreaker(failure_threshold=1)
    b.record_failure()
    assert b.state == "open"


def test_slice_7b_entry_points_default_to_the_card_and_raise_without_one(monkeypatch,
                                                                         tmp_path):
    """The farm's fits, refit and predicts, the retrainer and the
    controller (through its server) take ``device=`` (default the card)
    and raise without one."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import farm, lifecycle

    x = np.random.default_rng(5).normal(size=(12, 3))
    data = {"a": (x[:6], x[:6, 0]), "b": (x[6:], x[6:, 1])}
    m = farm.FarmLinearRegression().fit(data, device="cpu")
    table = port.Table.from_dict({"f0": x[:, 0], "f1": x[:, 1], "f2": x[:, 2]})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: farm.FarmLinearRegression().fit(data),
        lambda: farm.FarmKMeans(k=2).fit({t: v[0] for t, v in data.items()}),
        lambda: m.refit({"a": data["a"]}),
        lambda: m.predict(m.route_request("a", x[:2])),
        lambda: m.predict_tenant("a", x[:2]),
        lambda: lifecycle.retrain_drifted(m, {"a": (x[:6] + 9.0, x[:6, 0])}, min_rows=1),
        lambda: lifecycle.KMeansRetrainer(("f0", "f1", "f2"), k=2)(
            None, table, str(tmp_path / "ck"), 0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    fn = m.serving_predict_fn()
    assert fn(torch.from_numpy(m.route_request("b", x[:2]).astype(np.float32))).shape == (2,)
    srv = port.serve.InferenceServer(device="cpu")
    ctrl = lifecycle.LifecycleController(
        str(tmp_path / "lc"), srv, "m",
        lifecycle.KMeansRetrainer(("f0", "f1", "f2"), k=2, device="cpu"))
    srv.attach_lifecycle(ctrl)
    assert srv.health()["lifecycle"]["phase"] is None


def test_slice_7b_host_entry_points_take_no_device_and_need_no_card(monkeypatch, tmp_path):
    """Packing, the tenant sketches and drift scores, the journal, the
    feedback spool, the shadow scorer, the gate, the canary router and
    ``kmeans_cost`` are host code, as in the JAX package: none takes
    ``device=`` and none needs a card."""
    import inspect

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import farm, lifecycle
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.farm import profiles

    x = np.random.default_rng(6).normal(size=(12, 3))
    data = {"a": (x[:6], x[:6, 0]), "b": (x[6:], x[6:, 1])}
    m = farm.FarmLinearRegression().fit(data, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fns = [farm.pack_tenants, farm.tenant_psi, farm.drifted_tenants, profiles.shared_edges,
           profiles.build_profile_stack, profiles.tenant_sketch, profiles.profile_of,
           farm.ModelFarmModel.route_request, farm.ModelFarmModel.tenant_profile,
           farm.ModelFarmModel.save, lifecycle.LifecycleJournal,
           lifecycle.LifecycleJournal.append, lifecycle.FeedbackBuffer,
           lifecycle.FeedbackBuffer.flush, lifecycle.ShadowScorer, lifecycle.ParityGate,
           lifecycle.CanaryRouter, lifecycle.kmeans_cost, lifecycle.feedback_schema]
    for fn in fns:
        assert "device" not in inspect.signature(fn).parameters, fn
    b = farm.pack_tenants(data)
    assert b.x.shape == (2, 8, 3) and b.n_rows.tolist() == [6, 6]
    assert farm.drifted_tenants(m, {"a": x[:6] + 9.0, "b": x[6:]}, min_rows=1).keys() == {"a"}
    m.save(str(tmp_path / "farm"))
    assert port.load_model(str(tmp_path / "farm")).tenant_ids == ("a", "b")
    j = lifecycle.LifecycleJournal(str(tmp_path / "j.log"))
    j.append("serving", 0, {"active_version": 0})
    assert j.last()["state"] == "serving"
    fb = lifecycle.FeedbackBuffer(str(tmp_path / "fb"), ("f0", "f1", "f2"), str(tmp_path / "in"))
    fb.record_outcome(fb.record_prediction(x[0], 1.0), 2.0)
    assert fb.flush().endswith("feedback-000000.csv")
    assert lifecycle.CanaryRouter(0.5).take() is False
    assert lifecycle.kmeans_cost(port.KMeansModel(x[:2].copy()), x) >= 0.0


def test_slice_7c_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    """The in-process and the multi-process fleet place their replicas on
    every card by default and raise without one, before any replica
    server or worker process is built; named devices serve there."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve import fleet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: fleet.ReplicaSet(),
        lambda: fleet.ReplicaSet(n_replicas=4, max_queue_rows=384),
        lambda: fleet.ProcReplicaSet(),
        lambda: fleet.ProcReplicaSet(n_replicas=1, proc_env={"OMP_NUM_THREADS": "1"}),
        lambda: fleet.replica_set.default_devices(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    fs = fleet.ReplicaSet(n_replicas=3, devices=("cpu",) * 3)
    assert fs.device == torch.device("cpu")
    assert [r.server.device.type for r in fs.replicas] == ["cpu"] * 3
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.ReplicaSet(n_replicas=2, devices=("cuda:0", "cuda:0"))


def test_slice_7c_host_entry_points_take_no_device_and_need_no_card(monkeypatch):
    """Placement, the router, admission, the load generator, the watchdog
    and the frame transport are host code, as in the JAX package: none
    takes ``device=`` and none needs a card."""
    import inspect
    import socket

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve import fleet
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve.fleet import (
        placement,
        proc,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fns = [placement.partition_devices, fleet.EvenPlacement.assign, fleet.PinnedPlacement,
           fleet.PinnedPlacement.assign, fleet.ConsistentHashRing,
           fleet.ConsistentHashRing.preference, fleet.Router, fleet.Router.route,
           fleet.TokenBucket, fleet.AdmissionController, fleet.AdmissionController.admit,
           fleet.default_slo_classes, fleet.LoadProfile, fleet.build_schedule, fleet.replay,
           fleet.ClassReport.summary, fleet.StallWatchdog, fleet.StallWatchdog.watch_fleet,
           proc.send_frame, proc.recv_frame]
    for fn in fns:
        assert "device" not in inspect.signature(fn).parameters, fn
    assert [s.primary for s in fleet.EvenPlacement().assign(4, [0])] == [0, 0, 0, 0]
    router = fleet.Router([type("R", (), {"index": 0, "healthy": lambda s: True,
                                          "load_rows": lambda s: 0,
                                          "breaker_open": lambda s, m: False})()])
    assert router.route(tenant_id="H1", model="m").index == 0
    assert fleet.AdmissionController().admit("H1", "interactive", 4, 0.5).admitted
    prof = fleet.LoadProfile(base_rate_rps=50.0, tenants=(fleet.TenantMix("H1", 1.0),))
    assert len(fleet.build_schedule(prof, 1.0)) > 10
    a, b = socket.socketpair()
    with a, b:
        proc.send_frame(a, {"op": "ping"})
        assert proc.recv_frame(b) == {"op": "ping"}
    with fleet.StallWatchdog(window_s=1.0) as wd:
        wd.register("idle", lambda: 0.0, busy_fn=lambda: False)
        wd.check()


def test_slice_7c_federation_entry_points_default_to_the_card_and_raise_without_one(
        monkeypatch):
    """A silo computes on its device and the coordinator updates and
    solves on its own (default the card); each raises without one, as do
    the partials protocol's device calls and a silo from a CSV drop."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import federated

    x = np.random.default_rng(6).normal(size=(16, 3)).astype(np.float32)
    silo = federated.Silo("s0", (x, x[:, 0]), device="cpu")
    part = silo.compute_partials(port.LinearRegression(), None, 0)
    km = port.KMeans(k=2, warm_start_centers=x[:2])
    state = km.init_partials_state(3)
    kpart = federated.merge_partials([federated.Silo("s0", x, device="cpu").compute_partials(
        km, state, 0)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: federated.Silo("s0", x),
        lambda: federated.FederatedCoordinator(port.KMeans(k=2), [silo]),
        lambda: port.LinearRegression().fit_from_partials(federated.merge_partials([part])),
        lambda: port.LinearRegression().partial_fit_stats((x, x[:, 0])),
        lambda: km.partial_fit_stats(x, state=state),
        lambda: km.local_init_stats(x),
        lambda: km.apply_partials(state, kpart),
        lambda: port.GaussianMixture(k=2).local_init_stats(x),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    coord = federated.FederatedCoordinator(port.LinearRegression(), [silo], device="cpu")
    assert coord.device == torch.device("cpu") and silo.device == torch.device("cpu")
    assert coord.fit().model.coefficients.device == torch.device("cpu")


def test_slice_7c_federation_host_entry_points_take_no_device_and_need_no_card(monkeypatch):
    """Partials, merges, noise, the family registry, the profile merge and
    the config are host code, as in the JAX package: none takes
    ``device=`` and none needs a card."""
    import inspect

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import federated

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fns = [federated.Partials, federated.Partials.to_payload, federated.Partials.from_payload,
           federated.FitState, federated.merge_partials, federated.merge_profiles,
           federated.apply_clipped_noise, federated.NoiseConfig, federated.register_family,
           federated.family_mode, federated.FederatedConfig, federated.RoundReport,
           federated.Silo.profile_partials, federated.Silo.feature_matrix,
           port.KMeans.init_partials_state, port.KMeans.init_state_from_merged,
           port.GaussianMixture.init_state_from_merged]
    for fn in fns:
        assert "device" not in inspect.signature(fn).parameters, fn
    p = federated.Partials(family="linear", stats={"g": np.ones(2, np.float32)}, silo_id="a")
    q = federated.Partials(family="linear", stats={"g": np.ones(2, np.float32)}, silo_id="b")
    assert federated.merge_partials([q, p]).sources == ("a", "b")
    noisy = federated.apply_clipped_noise(p, federated.NoiseConfig(noise_multiplier=1e-9))
    assert noisy.noised
    cand = federated.Partials(family="kmeans.init", silo_id="a", stats={
        "candidates": np.random.default_rng(0).normal(size=(8, 2))})
    st = port.KMeans(k=2).init_state_from_merged(federated.merge_partials([cand]))
    assert st.params["centers"].shape == (2, 2)


def test_slice_7d_entry_points_default_to_the_card_and_raise_without_one(monkeypatch,
                                                                         tmp_path):
    """The pipelined stream (its table's device), the update consumer and
    the SQL stage hook take ``device=`` (default the card) and raise
    without one."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import streaming
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.streaming import (
        pipeline,
    )

    schema = port.hospital_event_schema()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: streaming.PipelinedStreamExecution(
            source=streaming.FileStreamSource(str(tmp_path / "in"), schema),
            sink=streaming.UnboundedTable(str(tmp_path / "t"), schema),
            checkpoint=streaming.StreamCheckpoint(str(tmp_path / "ck"))),
        lambda: streaming.ModelUpdateConsumer(port.StreamingKMeans(k=2)),
        lambda: pipeline.make_sql_feature_stage("SELECT * FROM __THIS__", ["f0"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    cons = streaming.ModelUpdateConsumer(port.StreamingKMeans(k=2), device="cpu")
    cons(np.random.default_rng(0).normal(size=(16, 2)).astype(np.float32), 0)
    assert cons.updates == 1


def test_slice_7d_host_entry_points_take_no_device_and_need_no_card(monkeypatch, tmp_path):
    """The stage clock, the sync census, the trace annotation and capture,
    the fences, ``batch_rows`` and the worker's hand-off are host code:
    none takes ``device=`` and none needs a card."""
    import inspect

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import data, streaming
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import (
        profiling,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fns = [profiling.StageClock, profiling.StageClock.stage, profiling.StageClock.shares,
           profiling.host_sync_census, profiling.trace_annotation, profiling.capture_trace,
           profiling.device_fence, profiling.block_until_ready, data.batch_rows,
           streaming.Prefetched, streaming.FileStreamSource.seen_snapshot]
    for fn in fns:
        assert "device" not in inspect.signature(fn).parameters, fn
    clock = profiling.StageClock()
    with clock.stage("ingest"):
        pass
    assert clock.counts == {"ingest": 1}
    with profiling.host_sync_census(count_puts=True) as c:
        torch.ones(2).sum().item()
    assert c == {"device_get": 0, "device_put": 0}
    with profiling.capture_trace(str(tmp_path / "tr")):
        with profiling.trace_annotation("x"):
            torch.ones(2).sum()
    assert (tmp_path / "tr" / "trace.json").is_file()
    assert data.batch_rows((np.zeros((3, 2)), np.zeros(3))) == 3


def test_slice_7d2_entry_points_default_to_the_card_and_raise_without_one(monkeypatch,
                                                                          tmp_path):
    """``run_soak`` and the CLI's run mode default to the card and raise
    without one, before the day writes a file; ``device="cpu"`` builds the
    run on the host."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import soak
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.soak import driver
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.soak.__main__ import (
        main,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: soak.run_soak(soak.SMOKE_CONFIG, str(tmp_path / "a")),
        lambda: driver._SoakRun(soak.SMOKE_CONFIG, str(tmp_path / "b")),
        lambda: main(["--workdir", str(tmp_path / "c")]),
        lambda: main(["--workdir", str(tmp_path / "d"), "--device", "cuda"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert sorted(p.name for p in tmp_path.iterdir()) == []
    run = driver._SoakRun(soak.SMOKE_CONFIG, str(tmp_path / "e"), device="cpu")
    assert run.device == torch.device("cpu") and run.views.device == torch.device("cpu")
    stream = run.build_stream()
    assert stream.device == torch.device("cpu")


def test_slice_7d2_host_entry_points_take_no_device_and_need_no_card(monkeypatch, tmp_path,
                                                                     capsys):
    """The schedule, the report, the resource probe and the CLI's
    ``--check`` are host code, as in the JAX package: none takes
    ``device=`` and none needs a card."""
    import inspect

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import soak
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.soak import schedule
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.soak.__main__ import (
        main,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fns = [soak.SoakConfig, soak.SoakConfig.from_dict, soak.DiurnalPhase, soak.ChaosEvent,
           schedule.full_config, soak.build_chaos_schedule, soak.write_report,
           soak.read_report, soak.check_report, soak.ResourceProbe,
           soak.ResourceProbe.sample, soak.ResourceProbe.report]
    for fn in fns:
        assert "device" not in inspect.signature(fn).parameters, fn
    cfg = schedule.full_config(3)
    assert soak.build_chaos_schedule(cfg) == soak.build_chaos_schedule(
        soak.SoakConfig.from_dict(cfg.to_dict()))
    probe = soak.ResourceProbe(str(tmp_path), table_dir=str(tmp_path))
    probe.sample("start")
    probe.sample("end")
    assert probe.report()["bounded"]
    payload = {"version": 1, "config": cfg.to_dict(), "unhandled": []}
    path = soak.write_report(payload, str(tmp_path / "r.json"))
    assert soak.read_report(path) == payload
    assert soak.check_report(payload)      # an incomplete day: violations, no device
    assert main(["--check", path]) == 1
    assert main(["--check", str(tmp_path / "missing.json")]) == 2
    assert "FAIL: report unreadable" in capsys.readouterr().out


def test_slice_8a_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    """The mesh's device entry points span every card by default and raise
    without one: the default mesh, ``build_mesh`` with no devices, a
    mesh-laid dataset, the per-hospital layout and the sharded fit; named
    CPU devices run there."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel

    x = np.random.default_rng(8).normal(size=(16, 3)).astype(np.float32)
    ids = np.arange(16) % 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    parallel.set_default_mesh(None)
    calls = [
        parallel.default_mesh,
        parallel.build_mesh,
        lambda: parallel.build_hybrid_mesh(1),
        lambda: parallel.device_dataset(x, mesh=parallel.default_mesh()),
        lambda: parallel.device_dataset(x),
        lambda: port.federated_dataset(x, ids),
        lambda: port.KMeans(k=2).fit(x, mesh=port.default_mesh()),
        lambda: port.KMeans(k=2).fit(x),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    mesh = parallel.build_mesh(port.MeshConfig(data=2), [torch.device("cpu")] * 2)
    ds = parallel.device_dataset(x, mesh=mesh)
    assert ds.shard(0).x.device == torch.device("cpu")
    assert port.federated_dataset(x, ids, mesh=mesh).n_rows == 16
    assert port.KMeans(k=2).fit(x, mesh=mesh).cluster_centers.shape == (2, 3)


def test_slice_8b_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    """The session's mesh, the sharded model stage and the estimators'
    ``mesh=`` span every card by default and raise without one; a named
    CPU mesh runs there."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel

    rng = np.random.default_rng(9)
    x = rng.normal(size=(40, 4)).astype(np.float32)
    y, yb = x[:, 0] + 1.0, (x[:, 1] > 0).astype(np.float32)
    cols = {c: np.round(rng.uniform(1, 9, 40)) for c in (*port.FEATURE_COLS, port.LABEL_COL)}
    table = port.Table.from_dict(cols)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    parallel.set_default_mesh(None)
    calls = [
        lambda: port.Session(),
        lambda: port.Session(port.PipelineConfig(mesh=port.MeshConfig(data=2))),
        lambda: port.run_model_stage(table),
        lambda: port.run_model_stage(table, mesh=port.default_mesh()),
        lambda: port.LinearRegression().fit((x, y), mesh=port.default_mesh()),
        lambda: port.DecisionTreeRegressor().fit((x, y), mesh=port.default_mesh()),
        lambda: port.GBTRegressor(max_iter=2).fit((x, y), mesh=port.default_mesh()),
        lambda: port.GaussianMixture(k=2).fit(x, mesh=port.default_mesh()),
        lambda: port.LogisticRegression().fit((x, yb), mesh=port.default_mesh()),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    mesh = parallel.build_mesh(port.MeshConfig(data=2), [torch.device("cpu")] * 2)
    spark = port.Session(mesh=mesh)
    try:
        assert spark.mesh is mesh and spark.device == torch.device("cpu")
        assert parallel.default_mesh() is mesh
    finally:
        spark.stop()
    assert parallel.mesh._DEFAULT_MESH is None
    res = port.run_model_stage(table, port.PipelineConfig(tree_max_depth=2, rf_num_trees=2),
                               mesh=mesh)
    assert res.training_rows == 40
    assert isinstance(res.models["LinearRegression"].coefficients, torch.Tensor)


def test_slice_8a_host_entry_points_take_no_device_and_need_no_card(monkeypatch, tmp_path):
    """``MeshConfig``, the partitioner's resolution, ``partition_devices``,
    ``place_hospitals``, ``pad_rows`` and a single-process ``initialize()``
    are host code, as in the JAX package: none takes ``device=`` and none
    needs a card."""
    import inspect

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.parallel import (
        distributed,
        partitioner,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fns = [port.MeshConfig, port.PipelineConfig.from_flags, partitioner.Partitioner.spec,
           partitioner.Partitioner.round_rows, partitioner.family, partitioner.register_family,
           partitioner.partition_devices, parallel.place_hospitals, parallel.pad_rows]
    for fn in fns:
        assert "device" not in inspect.signature(fn).parameters, fn
    cfg = port.PipelineConfig.from_flags(["--mesh-data", "4", "--mesh-model", "2"])
    assert cfg.mesh == port.MeshConfig(data=4, model=2)
    assert partitioner.family("kmeans").spec("state/centers", 2) == ("model", None)
    assert partitioner.partition_devices(["a", "b", "c"], 2) == (("a", "b"), ("c",))
    assert parallel.place_hospitals(np.array([1, 1, 2]), 2) == {1: 0, 2: 1}
    assert parallel.pad_rows(9, 4) == 12
    distributed.shutdown()
    try:
        ctx = distributed.initialize()
        assert (ctx.process_id, ctx.num_processes, ctx.backend) == (0, 1, None)
        assert ctx.devices[0].device == torch.device("cpu")
    finally:
        distributed.shutdown()


# The reference's public names that the port does not have yet, by the
# subpackage whose ``__all__`` lists them, each with the slice of ROADMAP
# queue 1 that ports its module.  Every other name of the reference's
# ``__all__`` must be in the port's.
def _tagged(slice_: str, names) -> dict:
    return {n: slice_ for n in names}


EXPECTED_GAPS = {
    "": {},
    "models": {},
    "models.tree": {},
    "features": {},
    "io": {},
    "core": {},
    "parallel": {},
    "serve": {},
    "serve.fleet": {},
    "ops": {},
    "utils": {},
    "pipeline": {},
    "evaluation": {},
    "streaming": {},
    "stat": {},
    "tuning": {},
    "obs": {},
    "viz": {},
    "quality": {},
    "tune": {},
    "farm": {},
    "lifecycle": {},
    "federated": {},
    "soak": {},
}


def _public_names(mod) -> set:
    """A package's ``__all__``, or, where it has none (the reference's
    ``soak``), the public names its ``__init__`` binds other than its
    submodules."""
    import inspect

    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {n for n, v in vars(mod).items() if not n.startswith("_") and not inspect.ismodule(v)}


@pytest.mark.parametrize("sub", sorted(EXPECTED_GAPS))
def test_package_surfaces_cover_the_reference(sub):
    """Each subpackage's ``__all__`` holds every name of the reference's
    whose module the port has, and each of its names resolves; the rest
    are the expected gaps, each tagged with the slice that ports it."""
    import importlib

    ref = importlib.import_module(JAX_PKG + (f".{sub}" if sub else ""))
    mine = importlib.import_module(port.__name__ + (f".{sub}" if sub else ""))
    missing = _public_names(ref) - set(mine.__all__)
    assert missing == set(EXPECTED_GAPS[sub]), (
        f"unexpected gaps {sorted(missing - set(EXPECTED_GAPS[sub]))}; "
        f"filled gaps still listed {sorted(set(EXPECTED_GAPS[sub]) - missing)}")
    assert set(EXPECTED_GAPS[sub].values()) <= {"7c", "7d", "8"}
    for name in mine.__all__:
        assert getattr(mine, name) is not None, name
    if sub == "soak":
        assert set(mine.__all__) == _public_names(ref) and len(mine.__all__) == 14


def test_the_surface_imports_of_a_line_for_line_port():
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import (  # noqa: F401
        Correlation,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import (  # noqa
        Table,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.features import (  # noqa
        Imputer,
        VectorAssembler,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.io import (  # noqa
        load_model,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models import (  # noqa
        KMeans,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import (  # noqa
        assign_clusters,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.parallel import (  # noqa
        DeviceDataset,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.pipeline import (  # noqa
        run_pipeline,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import (  # noqa
        MetricsRegistry,
    )

    assert DeviceDataset is port.DeviceDataset and KMeans is port.KMeans


def test_surface_helpers_match_the_reference():
    """The three helpers added to complete the surfaces: ``normalize_rows``,
    ``inertia`` (float32 sums in another order: rtol 1e-6) and
    ``fill_ratio`` (equal)."""
    import jax.numpy as jnp

    import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J

    rng = np.random.default_rng(3)
    x = rng.normal(size=(50, 4)).astype(np.float32)
    x[0] = 0.0
    c = rng.normal(size=(3, 4)).astype(np.float32)
    a = rng.integers(0, 3, 50)
    w = rng.uniform(0, 1, 50).astype(np.float32)
    np.testing.assert_allclose(port.ops.normalize_rows(torch.from_numpy(x)).numpy(),
                               np.asarray(J.ops.normalize_rows(jnp.asarray(x))), rtol=2.4e-7)
    got = port.evaluation.inertia(torch.from_numpy(x), torch.from_numpy(c),
                                  torch.from_numpy(a), torch.from_numpy(w))
    want = J.evaluation.inertia(jnp.asarray(x), jnp.asarray(c), jnp.asarray(a), jnp.asarray(w))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    for n, b in ((3, 8), (0, 0), (8, 8)):
        assert port.serve.fill_ratio(n, b) == J.serve.fill_ratio(n, b)


def test_slice_8c1_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    """Slice 8c-1's device entry points span every card by default and
    raise without one: bulk scoring and the sharded scorer (on their
    device or the default mesh), ``Table.to_device``, the clustering
    family's and the streams' ``mesh=``; named CPU meshes run there."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel, streaming

    rng = np.random.default_rng(10)
    x = rng.normal(size=(40, 3)).astype(np.float32)
    y, yb = x[:, 0] + 1.0, (x[:, 1] > 0).astype(np.float32)
    model = port.KMeansModel(x[:2].copy())
    table = port.Table.from_dict({"a": x[:, 0], "b": x[:, 1], "c": x[:, 2]})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    parallel.set_default_mesh(None)
    calls = [
        lambda: port.serve.bulk_score(model, x),
        lambda: port.serve.bulk_score(model, x, mesh=port.default_mesh()),
        lambda: port.serve.ShardedScorer(model),
        lambda: port.serve.ShardedScorer(model, mesh=port.default_mesh()),
        lambda: table.to_device(["a", "b"]),
        lambda: table.to_device(["a", "b"], mesh=port.default_mesh()),
        lambda: port.BisectingKMeans(k=2).fit(x, mesh=port.default_mesh()),
        lambda: port.StreamingKMeans(k=2).update(x, mesh=port.default_mesh()),
        lambda: port.StreamingKMeans(k=2).update_many([x, x], mesh=port.default_mesh()),
        lambda: port.StreamingLinearRegression().update((x, y), mesh=port.default_mesh()),
        lambda: port.StreamingLogisticRegression().update((x, yb), mesh=port.default_mesh()),
        lambda: streaming.ModelUpdateConsumer(port.StreamingKMeans(k=2),
                                              mesh=port.default_mesh()),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    mesh = parallel.build_mesh(port.MeshConfig(data=2), [torch.device("cpu")] * 2)
    assert port.serve.bulk_score(model, x, mesh=mesh).shape == (40,)
    assert port.serve.ShardedScorer(model, mesh=mesh, chunk_rows=7).chunk_rows == 8
    assert table.to_device(["a"], mesh=mesh).n_padded == 40
    assert table.to_device(["a"], device="cpu").x.device == torch.device("cpu")
    assert port.StreamingKMeans(k=2).update(x, mesh=mesh).latest_model.k == 2


def test_slice_8c1_host_entry_points_take_no_device_and_need_no_card(monkeypatch, capsys):
    """The Table's relational, display and pandas methods, the schema's
    numeric names, the evaluator's ``is_larger_better`` and the queue's
    depth are host code, as in the JAX package: none takes ``device=`` and
    none needs a card."""
    import inspect

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve.queue import (
        RequestQueue,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = port.Table.from_dict({"h": np.array(["a", "b", "a"], dtype=object),
                              "v": np.array([3.0, 1.0, 2.0])})
    T = port.Table
    fns = [T.from_pandas, T.filter, T.sample, T.with_column_renamed, T.sort_by, T.group_count,
           T.show, T.describe, T.to_pandas, port.Schema.numeric_names]
    for fn in fns:
        assert "device" not in inspect.signature(fn).parameters, fn
    assert T.from_pandas(t.to_pandas()).columns.keys() == t.columns.keys()
    assert t.filter(lambda tb: tb["v"] > 1.5).num_rows == 2
    assert t.sample(0.5, seed=1).num_rows <= 3
    assert list(t.with_column_renamed("v", "w").columns) == ["h", "w"]
    assert list(t.sort_by("v")["v"]) == [1.0, 2.0, 3.0]
    assert t.group_count("h") == {"a": 2, "b": 1}
    t.show()
    assert "only showing" not in capsys.readouterr().out
    assert t.describe()["v"][0] == 3.0 and t.schema.numeric_names() == ["v"]
    assert port.ClusteringEvaluator().is_larger_better
    assert RequestQueue().depth_requests == 0


# Every module of the reference that the port has, compared name by name:
# its public functions and classes (those it defines) must be bound in the
# port's module, and each class's public methods and properties must exist
# on the port's class.  What the port leaves out on purpose is listed here,
# each with its ROADMAP "Decided" reason.
JAX_DIR = REPO / JAX_PKG
MODULE_GAPS = {
    # the three Pallas kernels are ported as CUDA C++ (port csrc/, ops/lloyd.py,
    # ops/tree_hist.py): ROADMAP queue 2
    "ops.pallas_kernels": "the TPU kernels; Hopper kernels in port ops/",
    # jax version shims: the port imports no jax (ROADMAP "Decided")
    "utils.compat": "jax version shims",
}
NAME_GAPS = {
    # eager torch keeps no executable to reuse, so columns keep their true
    # length (ROADMAP "Decided": the executable cache)
    "core.sql_compile": {"bucket_for_rows", "clear_executable_cache", "executable_cache_info"},
}


def _module_names(root: Path) -> set:
    out = set()
    for p in root.rglob("*.py"):
        parts = p.relative_to(root).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        if parts and "_build" not in parts:
            out.add(".".join(parts))
    return out


SHARED_MODULES = sorted(_module_names(JAX_DIR) & _module_names(PORT_DIR))


def test_every_reference_module_is_ported_or_decided():
    assert _module_names(JAX_DIR) - _module_names(PORT_DIR) == set(MODULE_GAPS)
    assert len(SHARED_MODULES) > 150


def _defined_public(mod) -> dict:
    import inspect

    return {n: v for n, v in vars(mod).items()
            if not n.startswith("_") and (inspect.isfunction(v) or inspect.isclass(v))
            and getattr(v, "__module__", None) == mod.__name__}


def _members(cls) -> set:
    import inspect

    return {n for n, v in vars(cls).items() if not n.startswith("_") and (
        inspect.isfunction(v) or isinstance(v, (property, classmethod, staticmethod)))}


@pytest.mark.parametrize("name", SHARED_MODULES)
def test_module_names_cover_the_reference(name):
    """Each public function, class, method and property of the reference's
    module exists in the port's module (or is a recorded gap)."""
    import importlib
    import inspect

    ref = importlib.import_module(f"{JAX_PKG}.{name}")
    mine = importlib.import_module(f"{port.__name__}.{name}")
    missing = set()
    for n, v in _defined_public(ref).items():
        got = getattr(mine, n, None)
        if got is None:
            missing.add(n)
        elif inspect.isclass(v) and inspect.isclass(got):
            missing |= {f"{n}.{m}" for m in _members(v) if not hasattr(got, m)}
    assert missing == NAME_GAPS.get(name, set())


def test_slice_8c3_estimators_fit_over_a_mesh_and_8c4_ones_still_raise(monkeypatch):
    """Slice 8c-3's estimators run their fits over shards (``mesh_fit``,
    ``fit(..., mesh=)``), default to the card and raise without one; the
    fits left to slice 8c-4 (LDA, PIC, ALS; PCA inside a pipeline) raise
    over a mesh of more than one shard, naming it."""
    import inspect

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models import base

    assert base.MESH_SLICE == "8c-4"
    ests = [port.LinearSVC, port.NaiveBayes, port.OneVsRest, port.GeneralizedLinearRegression,
            port.AFTSurvivalRegression, port.FMRegressor, port.FMClassifier,
            port.MultilayerPerceptronClassifier, port.IsotonicRegression]
    for cls in ests:
        assert cls.mesh_fit and "mesh" in inspect.signature(cls.fit).parameters, cls
    rng = np.random.default_rng(12)
    x = rng.normal(size=(24, 2)).astype(np.float32)
    yb = (x[:, 0] > 0).astype(np.float32)
    mesh = parallel.build_mesh(port.MeshConfig(data=2), [torch.device("cpu")] * 2)
    for est in (port.LinearSVC(), port.NaiveBayes(model_type="gaussian"),
                port.OneVsRest(port.LogisticRegression()), port.IsotonicRegression()):
        est.fit((x, yb), mesh=mesh)
    counts = np.abs(np.round(x * 3))
    for call in (lambda: port.LDA(k=2).fit(counts, mesh=mesh),
                 lambda: port.Pipeline([port.PCA(k=1)]).fit(x, mesh=mesh)):
        with pytest.raises(NotImplementedError, match="slice 8c-4"):
            call()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for est in (port.LinearSVC(), port.GeneralizedLinearRegression(family="binomial"),
                port.MultilayerPerceptronClassifier(layers=(2, 2))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            est.fit((x, yb))


def test_slice_8c3_composites_take_the_reference_order():
    """``Pipeline.fit`` / ``PipelineModel.transform`` and the tuners' ``fit``
    / ``transform`` take the reference's positional order ``(data,
    label_col, mesh)``; the port's ``device`` is a keyword."""
    import inspect

    import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J

    pairs = [(port.Pipeline.fit, J.Pipeline.fit),
             (port.PipelineModel.transform, J.PipelineModel.transform),
             (port.CrossValidator.fit, J.CrossValidator.fit),
             (port.TrainValidationSplit.fit, J.TrainValidationSplit.fit),
             (port.CrossValidatorModel.transform, J.CrossValidatorModel.transform),
             (port.TrainValidationSplitModel.transform, J.TrainValidationSplitModel.transform)]
    for mine, ref in pairs:
        got, want = inspect.signature(mine).parameters, inspect.signature(ref).parameters
        positional = [n for n, p in got.items() if p.kind is p.POSITIONAL_OR_KEYWORD]
        assert positional == list(want) == ["self", "data", "label_col", "mesh"], mine
        assert [n for n, p in got.items() if p.kind is p.KEYWORD_ONLY] == ["device"], mine
