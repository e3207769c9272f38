"""The port's OneVsRest against the JAX package's
``models/one_vs_rest.py``, on the CPU.

Over a DecisionTreeClassifier the k one-vs-all fits run the port's K3 in
its plain version (CPU tensors): on integer-valued features every split is
an exact float32 sum, so the trees are equal and so are the predictions;
per-class confidences (leaf class frequencies) within 1e-6.  Over
LogisticRegression the per-class coefficients within 2e-5 of the largest
(the binomial parity tests' limit) and predictions equal.
"""

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P

torch.set_num_threads(1)


def _tiers(n=1500, seed=0, k=3, integer=True):
    rng = np.random.default_rng(seed)
    if integer:
        x = np.stack([rng.integers(0, 50, n), rng.integers(20, 400, n), rng.integers(0, 30, n),
                      rng.integers(0, 10, n)], axis=1).astype(np.float32)
    else:
        x = (rng.normal(size=(n, 4)) * [1.0, 2.0, 0.5, 1.0] + [0, 3, -1, 5]).astype(np.float32)
    s = (x - x.mean(0)) / x.std(0) @ np.array([1.0, 0.6, -0.8, 0.3]) + rng.normal(0, 0.5, n)
    y = np.digitize(s, np.quantile(s, np.linspace(0, 1, k + 1)[1:-1])).astype(np.float32)
    return x, y


def _trees_equal(pm, jm):
    assert len(pm.models) == len(jm.models)
    for p, j in zip(pm.models, jm.models):
        np.testing.assert_array_equal(p.split_feat, np.asarray(j.split_feat))
        np.testing.assert_array_equal(p.threshold, np.asarray(j.threshold))
        np.testing.assert_allclose(p.value, np.asarray(j.value), atol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_over_decision_trees_matches_reference(weighted):
    x, y = _tiers()
    w = np.random.default_rng(1).integers(0, 3, len(y)).astype(np.float32) if weighted else None
    inp = (x, y) if w is None else (x, y, w)
    jm = J.OneVsRest(J.DecisionTreeClassifier(max_depth=4)).fit(inp)
    pm = P.OneVsRest(P.DecisionTreeClassifier(max_depth=4)).fit(inp, device="cpu")
    assert pm.num_classes == 3
    _trees_equal(pm, jm)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(pm.predict_raw(xt).numpy(), np.asarray(jm.predict_raw(x)),
                               atol=1e-6)
    np.testing.assert_array_equal(pm.predict(xt).numpy(), np.asarray(jm.predict(x)))


def test_over_decision_trees_out_of_core():
    x, y = _tiers(n=1024, seed=2)
    jm = J.OneVsRest(J.DecisionTreeClassifier(max_depth=3)).fit(
        J.HostDataset(x=x, y=y, max_device_rows=256))
    pm = P.OneVsRest(P.DecisionTreeClassifier(max_depth=3)).fit(
        P.HostDataset(x=x, y=y, max_device_rows=256), device="cpu")
    rm = P.OneVsRest(P.DecisionTreeClassifier(max_depth=3)).fit((x, y), device="cpu")
    _trees_equal(pm, jm)
    _trees_equal(pm, rm)


def test_over_logistic_regression_matches_reference():
    x, y = _tiers(integer=False, seed=3)
    jm = J.OneVsRest(J.LogisticRegression(reg_param=0.01)).fit((x, y))
    pm = P.OneVsRest(P.LogisticRegression(reg_param=0.01)).fit((x, y), device="cpu")
    # (the middle tier's fit, intercept about -10, stops at its float32
    # noise floor: n_iter is held by the binomial parity tests instead)
    for p, j in zip(pm.models, jm.models):
        want = np.r_[np.asarray(j.coefficients), float(j.intercept)]
        np.testing.assert_allclose(np.r_[p.coefficients.numpy(), float(p.intercept)], want,
                                   atol=2e-5 * np.abs(want).max())
    np.testing.assert_array_equal(pm.predict(torch.from_numpy(x)).numpy(),
                                  np.asarray(jm.predict(x)))
    # over LinearSVC: the confidence is the margin (predict_raw)
    jm = J.OneVsRest(J.LinearSVC(reg_param=0.01)).fit((x, y))
    pm = P.OneVsRest(P.LinearSVC(reg_param=0.01)).fit((x, y), device="cpu")
    np.testing.assert_array_equal(pm.predict(torch.from_numpy(x)).numpy(),
                                  np.asarray(jm.predict(x)))


def test_guards_like_reference():
    x, y = _tiers(n=200, seed=4)
    for pkg, kw in ((J, {}), (P, {"device": "cpu"})):
        with pytest.raises(ValueError, match="needs a classifier"):
            pkg.OneVsRest().fit((x, y), **kw)
        with pytest.raises(ValueError, match="at least 2 classes"):
            pkg.OneVsRest(pkg.LogisticRegression()).fit((x, np.zeros_like(y)), **kw)
        with pytest.raises(ValueError, match="empty dataset"):
            pkg.OneVsRest(pkg.LogisticRegression()).fit((x, y, np.zeros_like(y)), **kw)
        with pytest.raises(ValueError, match="weight_col on OneVsRest"):
            pkg.OneVsRest(pkg.LogisticRegression(weight_col="w")).fit((x, y), **kw)
        with pytest.raises(ValueError, match="weight_col on OneVsRest"):
            pkg.OneVsRest(pkg.LogisticRegression(weight_col="w")).fit(
                pkg.HostDataset(x=x, y=y), **kw)
    with pytest.raises(ValueError, match="needs labels"):
        P.OneVsRest(P.LogisticRegression()).fit(P.HostDataset(x=x), device="cpu")
    with pytest.raises(TypeError, match="per-class confidence"):
        P.OneVsRestModel((object(),)).predict(torch.from_numpy(x))


def test_composite_artifacts_cross_both_ways(tmp_path):
    x, y = _tiers(n=600, seed=5)
    pm = P.OneVsRest(P.DecisionTreeClassifier(max_depth=3)).fit((x, y), device="cpu")
    jm = J.OneVsRest(J.DecisionTreeClassifier(max_depth=3)).fit((x, y))
    pm.save(str(tmp_path / "p"))
    jm.save(str(tmp_path / "j"))
    jl = J.load_model(str(tmp_path / "p"))
    pl = P.load_model(str(tmp_path / "j"))
    assert type(jl).__name__ == "OneVsRestModel" and type(pl) is P.OneVsRestModel
    np.testing.assert_array_equal(np.asarray(jl.predict(x)), pm.predict_numpy(x, device="cpu"))
    np.testing.assert_array_equal(pl.predict_numpy(x, device="cpu"), np.asarray(jm.predict(x)))
    with pytest.raises(FileExistsError):
        pm.save(str(tmp_path / "p"), overwrite=False)
