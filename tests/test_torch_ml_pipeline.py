"""The port's Pipeline / PipelineModel against the JAX package's
``pipeline/ml_pipeline.py``, on the CPU, and the composite artifacts both
ways.

The chains are the reference's: Binarizer → VectorAssembler →
StandardScaler → LogisticRegression on hospital-law rows.  The scaler's
moments are float32 sums in two orders: means rtol 1e-6, stds 1e-5 (a
difference of float32 second moments); the fitted
coefficients within 2e-5 of the largest (the binomial parity limit); hard
predictions equal; a chain saved by either package loads in the other and
predicts ``==``.
"""

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P

torch.set_num_threads(1)
FEATS = ("admission_count", "current_occupancy", "emergency_visits", "seasonality_index")


def _columns(n=1500, seed=0):
    rng = np.random.default_rng(seed)
    cols = {
        "admission_count": rng.integers(0, 50, n).astype(np.float64),
        "current_occupancy": rng.integers(20, 400, n).astype(np.float64),
        "emergency_visits": rng.integers(0, 30, n).astype(np.float64),
        "seasonality_index": rng.uniform(0.5, 1.5, n),
    }
    x = np.stack([cols[c] for c in FEATS], axis=1)
    cols["length_of_stay"] = x @ np.array([0.05, 0.008, 0.12, 2.0]) + rng.normal(0, 1.0, n)
    return cols


def _stages(pkg, **lr):
    return [pkg.Binarizer("length_of_stay", "LOS_binary", 4.0),
            pkg.VectorAssembler(list(FEATS)),
            pkg.StandardScaler(),
            pkg.LogisticRegression(**lr)]


def _lr_close(pm, jm):
    want = np.r_[np.asarray(jm.coefficients), float(jm.intercept)]
    got = np.r_[pm.coefficients.numpy(), float(pm.intercept)]
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max())


def test_pipeline_fit_and_transform_match_reference():
    cols = _columns()
    jt, pt_ = J.Table.from_dict(cols), P.Table.from_dict(cols)
    jm = J.Pipeline(_stages(J, reg_param=0.01)).fit(jt)
    pm = P.Pipeline(_stages(P, reg_param=0.01)).fit(pt_, device="cpu")
    assert [type(s).__name__ for s in pm.stages] == [type(s).__name__ for s in jm.stages]
    np.testing.assert_allclose(pm.stages[2].mean, jm.stages[2].mean, rtol=1e-6)
    np.testing.assert_allclose(pm.stages[2].std, jm.stages[2].std, rtol=1e-5)
    _lr_close(pm.stages[3], jm.stages[3])
    jr = jm.transform(jt)
    pr = pm.transform(pt_, device="cpu")
    np.testing.assert_array_equal(pr.to_numpy()[0], np.asarray(jr.to_numpy()[0]))
    np.testing.assert_array_equal(pr.to_numpy()[1], np.asarray(jr.to_numpy()[1]))


def test_manual_chain_equals_pipeline():
    cols = _columns(seed=1)
    t = P.Binarizer("length_of_stay", "LOS_binary", 4.0).transform(P.Table.from_dict(cols))
    a = P.VectorAssembler(list(FEATS)).transform(t)
    sc = P.StandardScaler().fit(a, device="cpu")
    lr = P.LogisticRegression().fit(sc.transform(a), device="cpu")
    pm = P.Pipeline(_stages(P)).fit(P.Table.from_dict(cols), device="cpu")
    np.testing.assert_array_equal(pm.stages[3].coefficients.numpy(), lr.coefficients.numpy())
    assert pm.stages[3].n_iter == lr.n_iter


def test_pipeline_artifacts_cross_both_ways(tmp_path):
    cols = _columns(n=800, seed=2)
    jt, pt_ = J.Table.from_dict(cols), P.Table.from_dict(cols)
    pm = P.Pipeline(_stages(P)).fit(pt_, device="cpu")
    jm = J.Pipeline(_stages(J)).fit(jt)
    pm.write().overwrite().save(str(tmp_path / "p"))
    jm.save(str(tmp_path / "j"))
    # port → JAX
    jl = J.load_model(str(tmp_path / "p"))
    assert type(jl).__name__ == "PipelineModel"
    np.testing.assert_array_equal(np.asarray(jl.transform(jt).to_numpy()[0]),
                                  pm.transform(pt_, device="cpu").to_numpy()[0])
    # JAX → port: the PipelineModel composite resolves in the port
    pl = P.load_model(str(tmp_path / "j"))
    assert type(pl) is P.PipelineModel and not pl.stages[3].has_summary
    np.testing.assert_array_equal(pl.transform(pt_, device="cpu").to_numpy()[0],
                                  np.asarray(jm.transform(jt).to_numpy()[0]))
    assert type(P.load_pipeline_model(str(tmp_path / "j"))) is P.PipelineModel
    # a round trip in the port predicts ==
    rt = P.load_model(str(tmp_path / "p"))
    np.testing.assert_array_equal(rt.transform(pt_, device="cpu").to_numpy()[0],
                                  pm.transform(pt_, device="cpu").to_numpy()[0])


def test_nested_composites_cross_both_ways(tmp_path):
    """A pipeline whose stages hold a OneVsRestModel and a
    CrossValidatorModel, saved by each package and loaded by the other."""
    cols = _columns(n=600, seed=3)
    cols["tier"] = np.digitize(cols["length_of_stay"],
                               np.quantile(cols["length_of_stay"], [0.5, 0.85])).astype(np.int64)
    models = {}
    for name, pkg, kw in (("p", P, {"device": "cpu"}), ("j", J, {})):
        t = pkg.Table.from_dict(cols)
        a = pkg.VectorAssembler(list(FEATS)).transform(t)
        ovr = pkg.OneVsRest(pkg.DecisionTreeClassifier(max_depth=3), label_col="tier").fit(a, **kw)
        cv = pkg.CrossValidator(pkg.LogisticRegression(label_col="tier", family="multinomial",
                                                       max_iter=5),
                                pkg.ParamGridBuilder().add_grid("reg_param", [0.0, 0.1]).build(),
                                pkg.MulticlassClassificationEvaluator(num_classes=3),
                                num_folds=2).fit(a, **kw)
        outer = pkg.PipelineModel((pkg.VectorAssembler(list(FEATS)),
                                   pkg.PipelineModel((ovr,)), cv))
        outer.save(str(tmp_path / name))
        models[name] = (outer, a)
    for saved, loader, pkg in (("p", J.load_model, J), ("j", P.load_model, P)):
        got = loader(str(tmp_path / saved))
        assert type(got).__name__ == "PipelineModel"
        assert type(got.stages[1].stages[0]).__name__ == "OneVsRestModel"
        assert type(got.stages[2]).__name__ == "CrossValidatorModel"
        orig, _ = models[saved]
        assert got.stages[2].best_index == orig.stages[2].best_index
        np.testing.assert_allclose(np.asarray(got.stages[2].avg_metrics),
                                   np.asarray(orig.stages[2].avg_metrics))
        x = models["p"][1].features.astype(np.float32)
        if pkg is P:
            pred = got.stages[1].stages[0].predict_numpy(x, device="cpu")
            want = np.asarray(orig.stages[1].stages[0].predict(x))
        else:
            pred = np.asarray(got.stages[1].stages[0].predict(x))
            want = orig.stages[1].stages[0].predict_numpy(x, device="cpu")
        np.testing.assert_array_equal(pred, want)


def test_errors_like_reference(tmp_path):
    cols = _columns(n=100, seed=4)
    for pkg in (J, P):
        with pytest.raises(TypeError, match="neither fit nor transform"):
            pkg.Pipeline([object()]).fit(pkg.Table.from_dict(cols))
    pm = P.Pipeline(_stages(P)).fit(P.Table.from_dict(cols), device="cpu")
    pm.save(str(tmp_path / "p"))
    # an unpersistable stage fails before the existing artifact is touched
    with pytest.raises(TypeError, match="not persistable"):
        P.PipelineModel(pm.stages + (object(),)).save(str(tmp_path / "p"))
    assert type(P.load_model(str(tmp_path / "p"))) is P.PipelineModel
    with pytest.raises(FileExistsError):
        pm.save(str(tmp_path / "p"), overwrite=False)
    P.LogisticRegression().fit((np.ones((4, 2)), np.array([0, 1, 0, 1.0])), device="cpu").save(
        str(tmp_path / "single"))
    with pytest.raises(ValueError, match="not a PipelineModel"):
        P.load_pipeline_model(str(tmp_path / "single"))
