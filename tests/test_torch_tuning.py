"""The port's ParamGridBuilder / CrossValidator / TrainValidationSplit
against the JAX package's ``tuning/tuning.py``, on the CPU.

The folds are the same ``np.random.default_rng(seed)`` permutation in both
packages, so every (param, fold) fit sees the same rows.  Metrics that
count hard predictions (accuracy, and AUC on hard labels, as the reference
scores ``transform``) are equal where the predictions are (rtol 1e-6 for
float32 sums of weights); RMSE within rtol 1e-5 (float32 residual sums in
two orders); the selected index is the same.
"""

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.tuning import tuning as jtun
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.tuning import tuning as ptun

torch.set_num_threads(1)


def _binary(n=1200, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 4)) * [1.0, 2.0, 0.5, 1.0] + [0.0, 3.0, -1.0, 5.0]).astype(np.float32)
    logits = x @ np.array([1.0, -0.5, 0.8, 0.3]) - 0.5
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    return x, y


def test_param_grid_and_apply_params_match_reference():
    for pkg in (J, P):
        grid = (pkg.ParamGridBuilder().add_grid("reg_param", [0.0, 0.1])
                .add_grid("max_iter", [5, 10]).base_on({"tol": 1e-4}).build())
        assert grid == [{"reg_param": r, "max_iter": m, "tol": 1e-4}
                        for r in (0.0, 0.1) for m in (5, 10)]
        with pytest.raises(ValueError, match="empty value list"):
            pkg.ParamGridBuilder().add_grid("reg_param", [])
    pipe = P.Pipeline([P.StandardScaler(), P.LogisticRegression(), P.LinearSVC()])
    out = ptun.apply_params(pipe, {"reg_param": 0.3, "1.max_iter": 7})
    assert out.stages[2].reg_param == 0.3 and out.stages[1].reg_param == 0.0
    assert out.stages[1].max_iter == 7 and pipe.stages[1].max_iter == 100
    jout = jtun.apply_params(J.Pipeline([J.StandardScaler(), J.LogisticRegression(),
                                         J.LinearSVC()]), {"reg_param": 0.3, "1.max_iter": 7})
    assert (out.stages[2].reg_param, out.stages[1].max_iter) == \
        (jout.stages[2].reg_param, jout.stages[1].max_iter)
    for bad, msg in (({"nope": 1}, "no pipeline stage has param"),
                     ({"5.reg_param": 1}, "out of range"),
                     ({"1.nope": 1}, "has no param")):
        with pytest.raises(ValueError, match=msg):
            ptun.apply_params(pipe, bad)
    assert ptun.apply_params(P.LogisticRegression(), {"reg_param": 0.2}).reg_param == 0.2


@pytest.mark.parametrize("metric", ["areaUnderROC", "accuracy"])
def test_cross_validator_matches_reference(metric):
    x, y = _binary()
    grid = [{"reg_param": r} for r in (0.0, 0.01, 0.1)]

    def evaluator(pkg):
        if metric == "accuracy":
            return pkg.MulticlassClassificationEvaluator("accuracy")
        return pkg.BinaryClassificationEvaluator(metric)

    jm = J.CrossValidator(J.LogisticRegression(), grid, evaluator(J), num_folds=3,
                          seed=7).fit((x, y))
    pm = P.CrossValidator(P.LogisticRegression(), grid, evaluator(P), num_folds=3,
                          seed=7).fit((x, y), device="cpu")
    assert pm.best_index == jm.best_index
    np.testing.assert_allclose(pm.fold_metrics, jm.fold_metrics, rtol=1e-6)
    np.testing.assert_allclose(pm.avg_metrics, jm.avg_metrics, rtol=1e-6)
    best = np.r_[np.asarray(jm.best_model.coefficients), float(jm.best_model.intercept)]
    np.testing.assert_allclose(np.r_[pm.best_model.coefficients.numpy(),
                                     float(pm.best_model.intercept)], best,
                               atol=2e-5 * np.abs(best).max())


def test_cross_validator_over_a_pipeline_and_sub_models():
    rng = np.random.default_rng(1)
    n = 900
    cols = {"a": rng.normal(size=n), "b": rng.normal(size=n) * 3 + 1, "c": rng.uniform(0, 5, n)}
    cols["length_of_stay"] = cols["a"] - 0.4 * cols["b"] + 0.3 * cols["c"] + rng.normal(size=n)
    grid = P.ParamGridBuilder().add_grid("2.reg_param", [0.0, 0.5]).build()
    res = {}
    for pkg, kw in ((J, {}), (P, {"device": "cpu"})):
        pipe = pkg.Pipeline([pkg.VectorAssembler(["a", "b", "c"]), pkg.StandardScaler(),
                             pkg.LinearRegression()])
        res[pkg] = pkg.CrossValidator(pipe, grid, pkg.RegressionEvaluator("rmse"), num_folds=2,
                                      seed=3, collect_sub_models=True).fit(
            pkg.Table.from_dict(cols), label_col="length_of_stay", **kw)
    pm, jm = res[P], res[J]
    assert pm.best_index == jm.best_index == 0        # rmse: smaller is better
    np.testing.assert_allclose(pm.avg_metrics, jm.avg_metrics, rtol=1e-5)
    assert len(pm.sub_models) == 2 and len(pm.sub_models[0]) == 2


def test_train_validation_split_matches_reference():
    x, y = _binary(seed=2)
    grid = [{"reg_param": r} for r in (0.0, 0.05)]
    jm = J.TrainValidationSplit(J.LinearSVC(), grid, J.MulticlassClassificationEvaluator(),
                                train_ratio=0.7, seed=5).fit((x, y))
    pm = P.TrainValidationSplit(P.LinearSVC(), grid, P.MulticlassClassificationEvaluator(),
                                train_ratio=0.7, seed=5).fit((x, y), device="cpu")
    assert pm.best_index == jm.best_index
    np.testing.assert_allclose(pm.validation_metrics, jm.validation_metrics, rtol=1e-6)
    np.testing.assert_array_equal(pm.transform((x, y), device="cpu").to_numpy()[0],
                                  np.asarray(jm.transform((x, y)).to_numpy()[0]))


def test_clustering_selection_matches_reference():
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.normal(c, 0.3, size=(150, 2)) for c in ((0, 0), (4, 0), (0, 4))])
    x = x.astype(np.float32)
    grid = [{"k": 2}, {"k": 3}]
    jm = J.TrainValidationSplit(J.KMeans(seed=0), grid, J.ClusteringEvaluator(), seed=1).fit(x)
    pm = P.TrainValidationSplit(P.KMeans(seed=0), grid, P.ClusteringEvaluator(), seed=1).fit(
        x, device="cpu")
    assert pm.best_index == jm.best_index == 1
    np.testing.assert_allclose(pm.validation_metrics, jm.validation_metrics, rtol=1e-5)


def test_selection_errors_like_reference():
    x, y = _binary(n=100, seed=6)
    for pkg, kw in ((J, {}), (P, {"device": "cpu"})):
        ev = pkg.MulticlassClassificationEvaluator()
        with pytest.raises(ValueError, match="num_folds"):
            pkg.CrossValidator(pkg.LogisticRegression(), [{}], ev, num_folds=1).fit((x, y), **kw)
        with pytest.raises(ValueError, match="param_maps is empty"):
            pkg.CrossValidator(pkg.LogisticRegression(), [], ev).fit((x, y), **kw)
        with pytest.raises(ValueError, match="train_ratio"):
            pkg.TrainValidationSplit(pkg.LogisticRegression(), [{}], ev,
                                     train_ratio=1.0).fit((x, y), **kw)
    with pytest.raises(ValueError, match="scored NaN"):
        ptun._best_index(np.array([np.nan, np.nan]), True)
    assert ptun._best_index(np.array([np.nan, 0.3, 0.2]), True) == 1


@pytest.mark.parametrize("kind", ["cv", "tvs"])
def test_selection_artifacts_cross_both_ways(kind, tmp_path):
    x, y = _binary(n=500, seed=8)
    grid = [{"reg_param": r} for r in (0.0, 0.1)]
    models = {}
    for name, pkg, kw in (("p", P, {"device": "cpu"}), ("j", J, {})):
        ev = pkg.BinaryClassificationEvaluator()
        if kind == "cv":
            sel = pkg.CrossValidator(pkg.LogisticRegression(), grid, ev, num_folds=2,
                                     collect_sub_models=True)
        else:
            sel = pkg.TrainValidationSplit(pkg.LogisticRegression(), grid, ev)
        models[name] = sel.fit((x, y), **kw)
        models[name].write().overwrite().save(str(tmp_path / name))
    tag = "CrossValidatorModel" if kind == "cv" else "TrainValidationSplitModel"
    jl = J.load_model(str(tmp_path / "p"))
    pl = P.load_model(str(tmp_path / "j"))
    assert type(jl).__name__ == type(pl).__name__ == tag
    assert jl.best_index == models["p"].best_index and pl.best_index == models["j"].best_index
    assert pl.param_maps == models["j"].param_maps
    np.testing.assert_array_equal(pl.best_model.predict_numpy(x, device="cpu"),
                                  np.asarray(models["j"].best_model.predict(x)))
    np.testing.assert_array_equal(np.asarray(jl.best_model.predict(x)),
                                  models["p"].best_model.predict_numpy(x, device="cpu"))
    if kind == "cv":
        assert len(pl.sub_models) == 2 and len(jl.sub_models[0]) == 2
