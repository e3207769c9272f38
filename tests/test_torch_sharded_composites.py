"""The composites over a mesh: the port's ``Pipeline`` / ``PipelineModel``
and ``CrossValidator`` / ``TrainValidationSplit`` taking ``mesh=`` in the
reference's positional order, against the JAX package's on the same mesh
shape (its own mesh8 calls, ``tests/test_ml_pipeline.py`` and
``tests/test_tuning.py``), on the CPU; a stage that does not run over
shards raises inside a pipeline over a mesh.

The port's meshes are over ``[torch.device("cpu")] * 8``; the JAX side
runs on ``tests/conftest.py``'s 8 virtual CPU devices (``mesh8``).

Tolerances, and why:
- the reference's own checks, as they stand (the pipeline against the
  stages chained by hand rtol 1e-6, the RMSE bounds, the accuracy floor,
  the chosen index);
- against the JAX package: LinearRegression's coefficients within 1e-4 of
  the largest and RMSE at rtol 1e-4 (float32 sums a shard, then in shard
  order, against XLA's psum: ``tests/test_torch_sharded_models.py``);
  the tree's accuracy, KMeans' assignments and every chosen index ``==``
  (0/1 histogram counts are exact; the KMeans fit holds its centers to
  the reference's within 1e-4 on these rows, far from any tie); the
  averaged metrics at rtol 1e-4;
- a (1, 1) mesh is the single-device path: ``==``.
"""

import os

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as ht
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel as P

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
LR_TOL = 1e-4


def _mesh(data=8, model=1):
    return P.build_mesh(port.MeshConfig(data=data, model=model), CPU8)


def _port_table(table):
    """The JAX fixture's hospital table, column for column, as a port
    Table."""
    schema = ht.hospital_event_schema()
    return port.Table.from_dict({c: np.asarray(table.column(c)) for c in schema.names},
                                port.hospital_event_schema())


def _splits(hospital_table):
    return (ht.train_test_split(hospital_table, 0.7, 42),
            port.train_test_split(_port_table(hospital_table), 0.7, 42))


def _scaled_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _regression_stages(pkg):
    return [pkg.VectorAssembler(pkg.FEATURE_COLS), pkg.StandardScaler(), pkg.LinearRegression()]


# ---------------------------------------------------------------- Pipeline
def test_supervised_pipeline_matches_manual_chain(hospital_table, mesh8):
    (jtrain, jtest), (train, test) = _splits(hospital_table)
    mesh = _mesh()
    pm = port.Pipeline(_regression_stages(port)).fit(train, mesh=mesh)
    assert isinstance(pm, port.PipelineModel) and len(pm.stages) == 3
    asm = port.VectorAssembler(port.FEATURE_COLS)
    a_train = asm.transform(train)
    scaler = port.StandardScaler().fit(a_train, mesh=mesh)
    lr = port.LinearRegression().fit(scaler.transform(a_train), mesh=mesh)
    np.testing.assert_allclose(pm.stages[2].coefficients.numpy(), lr.coefficients.numpy(),
                               rtol=1e-6)
    pred = pm.transform(test, mesh=mesh)
    rmse = port.RegressionEvaluator("rmse").evaluate(pred)
    manual = port.RegressionEvaluator("rmse").evaluate(
        lr.transform(scaler.transform(asm.transform(test)), mesh=mesh))
    np.testing.assert_allclose(rmse, manual, rtol=1e-6)
    assert rmse < 0.2
    jpm = ht.Pipeline(_regression_stages(ht)).fit(jtrain, mesh=mesh8)
    _scaled_close(pm.stages[2].coefficients.numpy(), jpm.stages[2].coefficients, LR_TOL)
    jrmse = ht.RegressionEvaluator("rmse").evaluate(jpm.transform(jtest, mesh=mesh8))
    np.testing.assert_allclose(rmse, jrmse, rtol=1e-4)
    # a (1, 1) mesh is the device path
    one = port.Pipeline(_regression_stages(port)).fit(train, device="cpu")
    m11 = port.Pipeline(_regression_stages(port)).fit(train, mesh=_mesh(1))
    assert torch.equal(one.stages[2].coefficients, m11.stages[2].coefficients)


def test_classification_pipeline_with_binarizer(hospital_table, mesh8):
    (jtrain, jtest), (train, test) = _splits(hospital_table)

    def stages(pkg):
        return [pkg.Binarizer("length_of_stay", "LOS_binary", 5.0),
                pkg.VectorAssembler(pkg.FEATURE_COLS),
                pkg.DecisionTreeClassifier(max_depth=4, label_col="LOS_binary")]

    mesh = _mesh()
    pm = port.Pipeline(stages(port)).fit(train, "LOS_binary", mesh)
    acc = port.MulticlassClassificationEvaluator("accuracy").evaluate(
        pm.transform(test, "LOS_binary", mesh))
    assert acc > 0.85
    jpm = ht.Pipeline(stages(ht)).fit(jtrain, label_col="LOS_binary", mesh=mesh8)
    jacc = ht.MulticlassClassificationEvaluator("accuracy").evaluate(
        jpm.transform(jtest, label_col="LOS_binary", mesh=mesh8))
    assert acc == pytest.approx(jacc, rel=1e-6)
    assert np.array_equal(pm.stages[2].split_feat, np.asarray(jpm.stages[2].split_feat))


def test_clustering_pipeline_appends_prediction_column(hospital_table, mesh8):
    def stages(pkg):
        return [pkg.VectorAssembler(pkg.FEATURE_COLS), pkg.StandardScaler(),
                pkg.KMeans(k=4, seed=0)]

    table = _port_table(hospital_table)
    mesh = _mesh()
    pm = port.Pipeline(stages(port)).fit(table, mesh=mesh)
    out = pm.transform(table, mesh=mesh)
    assert isinstance(out, port.Table) and "prediction" in out.schema
    p = out.column("prediction")
    assert p.shape == (len(hospital_table),) and set(np.unique(p)) <= set(range(4))
    jpm = ht.Pipeline(stages(ht)).fit(hospital_table, mesh=mesh8)
    want = jpm.transform(hospital_table, mesh=mesh8).column("prediction")
    assert np.array_equal(p, want)


def test_string_indexer_stage(hospital_table, mesh8):
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.features.indexer import (
        StringIndexerModel,
    )

    pm = port.Pipeline([port.StringIndexer("hospital_id", "hospital_idx"),
                        port.VectorAssembler(port.FEATURE_COLS + ("hospital_idx",)),
                        port.LinearRegression()]).fit(_port_table(hospital_table), mesh=_mesh())
    assert isinstance(pm.stages[0], StringIndexerModel)
    assert len(pm.stages[2].coefficients) == 5


def test_pipeline_save_load_roundtrip(hospital_table, tmp_path):
    _, (train, test) = _splits(hospital_table)
    mesh = _mesh()
    pm = port.Pipeline(_regression_stages(port)).fit(train, mesh=mesh)
    path = os.path.join(tmp_path, "pm")
    pm.write().overwrite().save(path)
    for loader in (port.load_pipeline_model, port.load_model):
        back = loader(path)
        assert isinstance(back, port.PipelineModel)
        assert [type(s).__name__ for s in back.stages] == [type(s).__name__ for s in pm.stages]
        p0, l0 = pm.transform(test, mesh=mesh).to_numpy()
        p1, l1 = back.transform(test, mesh=mesh).to_numpy()
        np.testing.assert_allclose(p0, p1, rtol=1e-6)
        np.testing.assert_allclose(l0, l1)
    # the JAX package loads the port's mesh-fitted pipeline
    jback = ht.load_pipeline_model(path)
    np.testing.assert_allclose(np.asarray(jback.stages[2].coefficients),
                               pm.stages[2].coefficients.numpy(), rtol=1e-6)


def test_device_stages_fit_over_shards_inside_a_pipeline(hospital_table):
    """Slice 8c-4's stages (PCA: a device fit; LDA behind a scaler) fit over
    a mesh of more than one shard inside a pipeline, a shard on its device,
    and never fit the rows of every shard on one device: the (8, 1) PCA is
    within 5e-5 of the one-device PCA (float32 moments summed in another
    order); a one-entry mesh names their device (``==``); a mesh and a
    device together are refused."""
    table = _port_table(hospital_table)
    pca8 = port.Pipeline([port.VectorAssembler(port.FEATURE_COLS), port.PCA(k=2)]).fit(
        table, mesh=_mesh())
    lda8 = port.Pipeline([port.VectorAssembler(port.FEATURE_COLS), port.MaxAbsScaler(),
                          port.LDA(k=2, max_iter=3)]).fit(table, mesh=_mesh())
    assert lda8.stages[2].lam.shape == (2, len(port.FEATURE_COLS))
    pm = port.Pipeline([port.VectorAssembler(port.FEATURE_COLS), port.PCA(k=2)]).fit(
        table, mesh=_mesh(1))
    one = port.Pipeline([port.VectorAssembler(port.FEATURE_COLS), port.PCA(k=2)]).fit(
        table, device="cpu")
    assert np.array_equal(pm.stages[1].components, one.stages[1].components)
    np.testing.assert_allclose(pca8.stages[1].explained_variance,
                               one.stages[1].explained_variance, rtol=5e-5)
    np.testing.assert_allclose(np.abs(pca8.stages[1].components.T @ one.stages[1].components),
                               np.eye(2), atol=5e-5)
    with pytest.raises(ValueError, match="not both"):
        port.Pipeline(_regression_stages(port)).fit(table, mesh=_mesh(), device="cpu")


# ---------------------------------------------------------------- tuning
def _ridge_data(rng, n=3000, d=8):
    x = rng.normal(size=(n, d)).astype(np.float32)
    beta = np.array([2.0, -1.0, 1.5, 0.0, 0.0, 0.5, -2.5, 1.0])
    y = (x @ beta + 0.2 * rng.normal(size=n)).astype(np.float32)
    return x, y


def test_cross_validator_selects_lowest_rmse(rng, mesh8):
    x, y = _ridge_data(rng)

    def cv(pkg):
        grid = pkg.ParamGridBuilder().add_grid("reg_param", [0.0, 1000.0]).build()
        return pkg.CrossValidator(estimator=pkg.LinearRegression(), param_maps=grid,
                                  evaluator=pkg.RegressionEvaluator("rmse"), num_folds=3, seed=7)

    mesh = _mesh()
    cvm = cv(port).fit((x, y), mesh=mesh)
    assert cvm.best_index == 0
    assert cvm.avg_metrics[0] < cvm.avg_metrics[1]
    assert cvm.avg_metrics.shape == (2,) and cvm.fold_metrics.shape == (2, 3)
    rmse = port.RegressionEvaluator("rmse").evaluate(cvm.transform((x, y), mesh=mesh))
    assert rmse < 0.3
    jcvm = cv(ht).fit((x, y), mesh=mesh8)
    assert cvm.best_index == jcvm.best_index
    np.testing.assert_allclose(cvm.avg_metrics, jcvm.avg_metrics, rtol=1e-4)
    one = cv(port).fit((x, y), device="cpu")
    assert np.array_equal(cv(port).fit((x, y), mesh=_mesh(1)).avg_metrics, one.avg_metrics)


def test_cross_validator_larger_better_metric(hospital_table, mesh8):
    def cv(pkg):
        pipe = pkg.Pipeline([pkg.Binarizer("length_of_stay", "LOS_binary", 5.0),
                             pkg.VectorAssembler(pkg.FEATURE_COLS),
                             pkg.DecisionTreeClassifier(label_col="LOS_binary")])
        grid = pkg.ParamGridBuilder().add_grid("max_depth", [1, 5]).build()
        return pkg.CrossValidator(estimator=pipe, param_maps=grid,
                                  evaluator=pkg.MulticlassClassificationEvaluator("accuracy"),
                                  num_folds=2, seed=3)

    cvm = cv(port).fit(_port_table(hospital_table), "LOS_binary", _mesh())
    assert cvm.best_index == 1 and cvm.avg_metrics[1] >= cvm.avg_metrics[0]
    jcvm = cv(ht).fit(hospital_table, label_col="LOS_binary", mesh=mesh8)
    np.testing.assert_allclose(cvm.avg_metrics, jcvm.avg_metrics, rtol=1e-6)


def test_cross_validator_on_assembled_table(hospital_table, mesh8):
    asm = port.VectorAssembler(port.FEATURE_COLS).transform(_port_table(hospital_table))
    grid = port.ParamGridBuilder().add_grid("reg_param", [0.0, 100.0]).build()
    cvm = port.CrossValidator(estimator=port.LinearRegression(), param_maps=grid,
                              evaluator=port.RegressionEvaluator("rmse"), num_folds=2,
                              seed=0).fit(asm, mesh=_mesh())
    assert cvm.best_index == 0


def test_train_validation_split(rng, mesh8):
    x, y = _ridge_data(rng)
    grid = port.ParamGridBuilder().add_grid("reg_param", [0.0, 1000.0]).build()
    tvs = port.TrainValidationSplit(estimator=port.LinearRegression(), param_maps=grid,
                                    evaluator=port.RegressionEvaluator("rmse"), train_ratio=0.75,
                                    seed=5)
    m = tvs.fit((x, y), mesh=_mesh())
    assert m.best_index == 0 and m.validation_metrics.shape == (2,)
    jm = ht.TrainValidationSplit(ht.LinearRegression(), ht.ParamGridBuilder().add_grid(
        "reg_param", [0.0, 1000.0]).build(), ht.RegressionEvaluator("rmse"), train_ratio=0.75,
        seed=5).fit((x, y), mesh=mesh8)
    np.testing.assert_allclose(m.validation_metrics, jm.validation_metrics, rtol=1e-4)
    with pytest.raises(ValueError, match="train_ratio"):
        port.TrainValidationSplit(port.LinearRegression(), grid, port.RegressionEvaluator(),
                                  train_ratio=1.5).fit((x, y))


def test_train_validation_split_over_kmeans_silhouette(mesh8):
    """The clustering branch of ``_score``: the assignments a shard at a
    time, the silhouette over the same mesh; the chosen k and the metrics
    against the JAX package's on mesh8 and ``==`` the (1, 1) fit's."""
    rng = np.random.default_rng(4)
    centers = rng.normal(0, 6, size=(4, 3))
    x = (centers[rng.integers(0, 4, 1600)] + rng.normal(size=(1600, 3))).astype(np.float32)

    def tvs(pkg):
        grid = pkg.ParamGridBuilder().add_grid("k", [2, 4]).build()
        return pkg.TrainValidationSplit(pkg.KMeans(seed=0), grid, pkg.ClusteringEvaluator(),
                                        seed=1)

    m = tvs(port).fit(x, mesh=_mesh())
    jm = tvs(ht).fit(x, mesh=mesh8)
    assert m.best_index == jm.best_index == 1
    np.testing.assert_allclose(m.validation_metrics, jm.validation_metrics, rtol=1e-4)
    one = tvs(port).fit(x, device="cpu")
    assert np.array_equal(tvs(port).fit(x, mesh=_mesh(1)).validation_metrics,
                          one.validation_metrics)


def test_selection_model_persistence(rng, tmp_path):
    x, y = _ridge_data(rng)
    grid = port.ParamGridBuilder().add_grid("reg_param", [0.0, 10.0]).build()
    mesh = _mesh()
    cvm = port.CrossValidator(port.LinearRegression(), grid, port.RegressionEvaluator("rmse"),
                              num_folds=2, seed=1).fit((x, y), mesh=mesh)
    p = os.path.join(tmp_path, "cvm")
    cvm.write().overwrite().save(p)
    back = port.load_model(p)
    assert isinstance(back, port.CrossValidatorModel)
    np.testing.assert_allclose(back.avg_metrics, cvm.avg_metrics)
    assert back.best_index == cvm.best_index and back.param_maps == cvm.param_maps
    a, _ = cvm.transform((x, y), mesh=mesh).to_numpy()
    b, _ = back.transform((x, y), mesh=mesh).to_numpy()
    np.testing.assert_allclose(a, b, rtol=1e-6)
    tvm = port.TrainValidationSplit(port.LinearRegression(), grid,
                                    port.RegressionEvaluator("rmse"), seed=2).fit((x, y), mesh=mesh)
    p2 = os.path.join(tmp_path, "tvm")
    tvm.save(p2)
    back2 = port.load_model(p2)
    assert isinstance(back2, port.TrainValidationSplitModel)
    np.testing.assert_allclose(back2.validation_metrics, tvm.validation_metrics)
