"""The whole job over a mesh: the port's ``run_pipeline`` under a
``Session(mesh=)`` of 8 CPU entries against the JAX package's
``run_pipeline`` under ``Session(PipelineConfig(mesh=MeshConfig(data=8,
model=1)))`` (as ``tests/test_pipeline.py`` sets it up) on the same CSV
drops; and the session's mesh rule, the builder's ``.mesh(cfg)`` and the
default mesh's restore on ``stop()``.

Tolerances, and why (as ``tests/test_torch_pipeline.py``, whose drops
these are):
- the training rows and the accuracies are equal: the same parsed values
  through the same window and split, and 0/1 counts are exact;
- float LOS: RMSE at rtol 1e-4 — the gains and the Gram are float32 sums
  in another order (per shard, then in shard order, against XLA's psum);
- the trees' importances within 1e-4: the gains behind them are float32
  sums in another order;
- integer LOS: every histogram sum is exact, so the port's sharded
  decision trees equal its single-device ones: splits, values,
  importances and accuracy ``==``, RMSE at rtol 1e-6 (float32 metric
  sums in shard order).  The forests are not compared to one device: the
  420 training rows pad to 424 over 8 shards, and the bootstrap draws
  over the padded rows (the reference's draw on the same mesh shape).
"""

import importlib

import numpy as np
import pytest
import torch

from clustermachinelearningforhospitalnetworks_apache_spark_tpu.config import (
    MeshConfig as JMeshConfig,
    PipelineConfig as JConfig,
)
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.session import Session
from test_torch_pipeline import CLASSIFIERS, REGRESSORS, _fields, _make_input

torch.set_num_threads(1)

J_PIPE = importlib.import_module(
    "clustermachinelearningforhospitalnetworks_apache_spark_tpu.pipeline.hospital_pipeline")
J_SESSION = importlib.import_module(
    "clustermachinelearningforhospitalnetworks_apache_spark_tpu.session")
CPU8 = [torch.device("cpu")] * 8


def _mesh8():
    return parallel.build_mesh(P.MeshConfig(data=8, model=1), CPU8)


@pytest.fixture(scope="module", params=[False, True], ids=["float LOS", "integer LOS"])
def runs(request, tmp_path_factory):
    """The JAX job under an (8, 1) mesh session, the port's under a
    ``Session(mesh=)`` of 8 CPU entries, and (integer LOS) the port's on
    one CPU device."""
    root = tmp_path_factory.mktemp("sharded_pipeline")
    _make_input(str(root / "incoming"), rounded=request.param)
    jcfg = JConfig(**_fields(root, "jax"), mesh=JMeshConfig(data=8, model=1))
    jspark = J_SESSION.Session(jcfg)
    try:
        jr = J_PIPE.run_pipeline(jcfg, session=jspark, make_plots=False)
    finally:
        jspark.stop()
    spark = Session(P.PipelineConfig(**_fields(root, "port")), mesh=_mesh8())
    try:
        pr = P.run_pipeline(session=spark, make_plots=False)
    finally:
        spark.stop()
    one = None
    if request.param:
        one = P.run_pipeline(P.PipelineConfig(**_fields(root, "one")), device="cpu",
                             make_plots=False, save_models=False)
    return request.param, jr, pr, one


def test_rows_metrics_and_importances_against_the_jax_mesh_run(runs):
    _, jr, pr, _ = runs
    assert pr.training_rows == jr.training_rows == 600
    assert list(pr.regression_rmse) == list(REGRESSORS)
    assert list(pr.classification_accuracy) == list(CLASSIFIERS)
    for name, v in jr.regression_rmse.items():
        np.testing.assert_allclose(pr.regression_rmse[name], v, rtol=1e-4)
    assert pr.classification_accuracy == jr.classification_accuracy
    assert list(pr.feature_importances) == list(jr.feature_importances)
    for name, imp in jr.feature_importances.items():
        np.testing.assert_allclose(list(pr.feature_importances[name].values()),
                                   list(imp.values()), atol=1e-4)


def test_the_mesh_run_fitted_over_the_shards_and_equals_one_device(runs):
    rounded, _, pr, one = runs
    lr = pr.models["LinearRegression"]
    assert lr.summary._ds.mesh.shape == {"data": 8, "model": 1}
    assert sorted(pr.model_paths) == sorted((*REGRESSORS, *CLASSIFIERS))
    if not rounded:
        return
    for name in ("DecisionTreeRegressor", "DecisionTreeClassifier"):
        assert pr.feature_importances[name] == one.feature_importances[name]
        np.testing.assert_array_equal(pr.models[name].split_feat, one.models[name].split_feat)
        np.testing.assert_array_equal(pr.models[name].value, one.models[name].value)
    assert (pr.classification_accuracy["DecisionTreeClassifier"]
            == one.classification_accuracy["DecisionTreeClassifier"])
    np.testing.assert_allclose(pr.regression_rmse["DecisionTreeRegressor"],
                               one.regression_rmse["DecisionTreeRegressor"], rtol=1e-6)


def test_session_mesh_rule_builder_and_restore(monkeypatch):
    parallel.set_default_mesh(None)
    a, b = _mesh8(), parallel.build_mesh(P.MeshConfig(data=2), [torch.device("cpu")] * 2)
    s1 = Session(mesh=a)
    s2 = Session(mesh=b, device="cpu")          # the device names the mesh's first entry
    assert parallel.default_mesh() is b
    s1.stop()                                    # not LIFO: the default stays s2's
    assert parallel.default_mesh() is b
    s2.stop()
    assert parallel.default_mesh() is a          # what s2 displaced
    parallel.set_default_mesh(None)
    s3 = Session(device="cpu")
    assert s3.mesh.shape == {"data": 1, "model": 1} and s3.device == torch.device("cpu")
    s3.stop()
    assert parallel.mesh._DEFAULT_MESH is None
    meta = parallel.build_mesh(P.MeshConfig(data=1), [torch.device("meta")])
    with pytest.raises(ValueError, match="first device"):
        Session(mesh=meta, device="cpu")
    builder = Session.builder.app_name("m").mesh(P.MeshConfig(data=8, model=1))
    assert builder._config.mesh == P.MeshConfig(data=8, model=1)
    assert builder._config.app_name == "m"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(J_SESSION, "_ACTIVE_SESSION", None)
    import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.session as PS
    monkeypatch.setattr(PS, "_ACTIVE_SESSION", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        builder.get_or_create()                  # the mesh spans every card
