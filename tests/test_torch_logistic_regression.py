"""The port's LogisticRegression (binomial, multinomial, out of core) and
its training summaries against the JAX package's, on the CPU.

The same numpy rows go through the JAX estimator on its 8-device CPU mesh
and the port's (``device="cpu"``).

Tolerances, and why:
- binomial coefficients and intercept within 2e-5 of the largest
  coefficient: the gradient and Hessian are float32 sums over the rows,
  reduced per device and psum'd by the JAX package and per 128-row chunk
  by the port (``STAT_CHUNK``), and the Newton steps carry the rounding (about 1e-6
  of the largest here); ``n_iter`` equal where the stop is decided above
  the float32 noise floor of the step (the cases below); where ``tol`` is
  below that floor (raw hospital features, occupancy up to 400, with an
  intercept) the stop is decided by rounding in both packages, a fault
  recorded in ROADMAP queue 3 and shown by
  ``test_binomial_stop_below_the_float32_noise_floor``;
- multinomial: the unregularized (or intercept-unpenalized) softmax has a
  null direction, a vector added to every class, that the trace-scaled
  jitter pins only weakly, so both packages drift along it by rounding;
  the identifiable part, the class-centred [coefficients | intercept]
  matrix, within 1e-5 of its largest entry, and the probabilities within
  2e-6; the fully penalized fit (ridge, no intercept) converges and its
  raw coefficients agree within 1e-5;
- out-of-core fits against resident within 2e-5 of the largest (blocks
  summed in another order), n_iter equal in the converging cases;
- AUC and AUPR within 2e-6 (float32 cumulative sums in two orders),
  curves and thresholds within 1e-5; confusion-matrix metrics equal
  unweighted (the same hard predictions, integer counts) and within 1e-6
  relative weighted (float32 sums of the weights in two orders).
"""

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.models import (
    logistic_regression as jlog,
)
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models import (
    logistic_regression as plog,
)

torch.set_num_threads(1)

COEF_TOL = 2e-5
MULTI_TOL = 1e-5
PROBA_TOL = 2e-6
AUC_TOL = 2e-6


def _binary_data(n=3000, seed=0, weighted=False):
    """Gaussian features of mixed scale and offset, labels drawn from a
    logistic law (not separable)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 4)) * [1.0, 2.0, 0.5, 1.0] + [0.0, 3.0, -1.0, 5.0]).astype(np.float32)
    logits = x @ np.array([1.0, -0.5, 0.8, 0.3]) - 0.5
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    w = rng.uniform(0.2, 2.0, n).astype(np.float32) if weighted else None
    return x, y, w


def _tiers(n=3000, seed=0, k=3):
    """Class labels 0..k-1 at quantiles of a noisy linear score."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 4)) * [1.0, 2.0, 0.5, 1.0] + [0.0, 3.0, -1.0, 5.0]).astype(np.float32)
    s = x @ np.array([1.0, -0.5, 0.3, 0.2]) + rng.normal(size=n)
    y = np.digitize(s, np.quantile(s, np.linspace(0, 1, k + 1)[1:-1])).astype(np.float32)
    return x, y


def _inputs(x, y, w):
    return (x, y) if w is None else (x, y, w)


def _theta(coef, intercept) -> np.ndarray:
    return np.r_[np.asarray(coef, np.float64).ravel(), np.asarray(intercept, np.float64).ravel()]


def _close(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, atol=tol * scale)


BIN_CASES = [
    dict(),
    dict(reg_param=0.1),
    dict(reg_param=0.05, standardize=False),
    dict(fit_intercept=False),
    dict(max_iter=3),
    dict(tol=1e-3),
]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kw", BIN_CASES)
def test_binomial_matches_reference(kw, weighted):
    x, y, w = _binary_data(weighted=weighted)
    jm = J.LogisticRegression(**kw).fit(_inputs(x, y, w))
    pm = P.LogisticRegression(**kw).fit(_inputs(x, y, w), device="cpu")
    assert type(pm) is P.LogisticRegressionModel
    assert pm.n_iter == jm.n_iter
    _close(_theta(pm.coefficients.numpy(), pm.intercept), _theta(jm.coefficients, jm.intercept),
           COEF_TOL)
    # the host reads: the class count and one a chunk of Newton steps
    assert pm.fit_info["host_syncs"] == 1 + -(-max(pm.n_iter, 1) // plog.NEWTON_CHUNK) \
        or pm.n_iter == kw.get("max_iter", 100)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(pm.predict_proba(xt).numpy(), np.asarray(jm.predict_proba(x)),
                               atol=PROBA_TOL)
    np.testing.assert_array_equal(pm.predict(xt).numpy(), np.asarray(jm.predict(x)))


def test_irls_fit_function_matches_reference():
    x, y, w = _binary_data(n=1000, seed=4, weighted=True)
    jc, ji, jn = jlog._irls_fit(x, y, w, np.float32(0.01), np.float32(1e-6), True, True, 100)
    pc, pi, pn, syncs = plog._irls_fit(torch.from_numpy(x), torch.from_numpy(y),
                                       torch.from_numpy(w), 0.01, 1e-6, True, True, 100)
    assert pn == int(jn) and syncs == -(-pn // plog.NEWTON_CHUNK)
    _close(_theta(pc.numpy(), pi), _theta(jc, ji), COEF_TOL)


def test_newton_loop_stops_where_the_reference_stops():
    """The chunked loop: the done flag freezes theta at the reference's
    stop whatever the chunk, and max_iter 0 returns the start."""
    steps = iter(range(1, 100))

    def step(theta):  # dmax halves each step: 1/2, 1/4, ...
        i = next(steps)
        return theta + 1.0, torch.tensor(0.5 ** i, dtype=torch.float32)

    theta, n_iter, syncs = plog.newton_loop(step, torch.zeros(2), 0.01, 100)
    assert n_iter == 7 and syncs == 2 and theta.tolist() == [7.0, 7.0]   # 2^-7 < 0.01
    theta, n_iter, syncs = plog.newton_loop(step, torch.zeros(2), 0.0, 5)
    assert n_iter == 5 and theta.tolist() == [5.0, 5.0]
    assert plog.newton_loop(step, torch.zeros(2), 0.01, 0)[1:] == (0, 0)


def _hospital_binary(n_per_hospital=1000, seed=7):
    rng = np.random.default_rng(seed)
    n = 5 * n_per_hospital
    x = np.stack([rng.integers(0, 50, n), rng.integers(20, 400, n), rng.integers(0, 30, n),
                  rng.uniform(0.5, 1.5, n)], axis=1).astype(np.float32)
    los = x.astype(np.float64) @ np.array([0.05, 0.008, 0.12, 2.0]) + rng.normal(0.0, 0.4, n)
    return x, (los > np.median(los)).astype(np.float32)


def test_binomial_stop_below_the_float32_noise_floor():
    """Raw hospital features (occupancy up to 400) with an intercept: the
    trace-scaled jitter makes Newton converge linearly (each step about
    0.77 of the last), and near tol = 1e-6 the step is float32 rounding in
    both packages, so each stops a few iterations from where the same
    update in float64 stops, where its own rounding decides (ROADMAP queue
    3).  The coefficients agree all the same; with tol above the noise
    floor the stop is the same."""
    x, y = _hospital_binary()
    # the same damped update in float64: where the stop would be
    xa = np.c_[x.astype(np.float64), np.ones(len(y))]
    theta = np.zeros(5)
    n64, steps = 0, []
    for n64 in range(1, 101):
        p = 1.0 / (1.0 + np.exp(-(xa @ theta)))
        r = np.maximum(p * (1 - p), 1e-10)
        h = (xa * r[:, None]).T @ xa
        delta = np.linalg.solve(h + (1e-6 * np.trace(h) / 5 + 1e-8) * np.eye(5), xa.T @ (p - y))
        delta *= min(1.0, 20.0 / (np.abs(delta).max() + 1e-30))
        theta -= delta
        steps.append(np.abs(delta).max())
        if steps[-1] <= 1e-6:
            break
    assert 0.6 < steps[-1] / steps[-2] < 0.9        # linear convergence
    jm = J.LogisticRegression().fit((x, y))
    pm = P.LogisticRegression().fit((x, y), device="cpu")
    assert abs(jm.n_iter - n64) <= 10 and abs(pm.n_iter - n64) <= 10
    _close(_theta(pm.coefficients.numpy(), pm.intercept), _theta(jm.coefficients, jm.intercept),
           1e-4)
    jm = J.LogisticRegression(tol=1e-4).fit((x, y))
    pm = P.LogisticRegression(tol=1e-4).fit((x, y), device="cpu")
    assert pm.n_iter == jm.n_iter < 100


MULTI_CASES = [
    dict(),
    dict(reg_param=0.05),
    dict(fit_intercept=False),
    dict(reg_param=0.05, fit_intercept=False),
    dict(max_iter=8, standardize=False, reg_param=0.02),
]
# a ridge with an unpenalized intercept: the step along the intercepts'
# null direction is float32 rounding once the rest has converged, so where
# it first falls below tol is decided by rounding in both packages
# (ROADMAP queue 3); the other cases stop at max_iter or converge
NOISE_STOP = dict(reg_param=0.05)


def _centred(coef, intercept) -> np.ndarray:
    m = np.c_[np.asarray(coef, np.float64), np.asarray(intercept, np.float64)]
    return m - m.mean(axis=0)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kw", MULTI_CASES)
def test_multinomial_matches_reference(kw, weighted):
    x, y = _tiers(seed=1)
    w = np.random.default_rng(2).uniform(0.2, 2.0, len(y)).astype(np.float32) if weighted else None
    jm = J.LogisticRegression(family="multinomial", **kw).fit(_inputs(x, y, w))
    pm = P.LogisticRegression(family="multinomial", **kw).fit(_inputs(x, y, w), device="cpu")
    assert type(pm) is P.MultinomialLogisticRegressionModel and pm.num_classes == 3
    if kw != NOISE_STOP:
        assert pm.n_iter == jm.n_iter
    _close(_centred(pm.coefficient_matrix.numpy(), pm.intercept_vector.numpy()),
           _centred(jm.coefficient_matrix, jm.intercept_vector), MULTI_TOL)
    if kw.get("reg_param", 0) > 0 and kw.get("fit_intercept") is False:
        _close(pm.coefficient_matrix.numpy(), np.asarray(jm.coefficient_matrix), MULTI_TOL)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(pm.predict_proba(xt).numpy(), np.asarray(jm.predict_proba(x)),
                               atol=PROBA_TOL)
    np.testing.assert_array_equal(pm.predict(xt).numpy(), np.asarray(jm.predict(x)))


def test_multinomial_chunk_rule_and_block_stats():
    for k, dd in ((2, 5), (3, 5), (10, 33), (64, 129)):
        assert plog.multinomial_chunk(k, dd) == int(
            min(65536, max(256, (1 << 25) // max(1, k * k * dd))))
    x, y = _tiers(n=700, seed=3)
    w = np.random.default_rng(0).uniform(0.0, 2.0, len(y)).astype(np.float32)
    theta = np.random.default_rng(1).normal(size=15).astype(np.float32) * 0.1
    jg, jh = jlog._multinomial_block_stats(x, y, w, theta, 3, True, 256)
    pg, ph = plog._multinomial_block_stats(torch.from_numpy(x), torch.from_numpy(y),
                                           torch.from_numpy(w), torch.from_numpy(theta), 3, True,
                                           256)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5 * np.abs(jg).max())
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5 * np.abs(jh).max())


def test_binomial_stats_and_update_match_reference():
    x, y, w = _binary_data(n=900, seed=5, weighted=True)
    theta = np.array([0.3, -0.1, 0.2, 0.05, -0.4], np.float32)
    jg, jh = jlog._logit_block_newton_stats(x, y, w, theta, True)
    pg, ph = plog._logit_block_newton_stats(torch.from_numpy(x), torch.from_numpy(y),
                                            torch.from_numpy(w), torch.from_numpy(theta), True)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), atol=1e-5 * np.abs(jg).max())
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), rtol=1e-5)
    ridge = np.array([1.0, 2.0, 0.5, 0.0, 0.0], np.float32)
    jt, jd = jlog._newton_update_from_stats(theta, jg, jh, ridge)
    pt, pd = plog._newton_update_from_stats(torch.from_numpy(theta), torch.from_numpy(
        np.asarray(jg)), torch.from_numpy(np.asarray(jh)), torch.from_numpy(ridge))
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(pd), float(jd), rtol=1e-4)


@pytest.mark.parametrize("family", ["binomial", "multinomial"])
@pytest.mark.parametrize("kw", [dict(), dict(reg_param=0.05), dict(fit_intercept=False)])
def test_outofcore_matches_reference_and_resident(family, kw):
    if family == "binomial":
        x, y, w = _binary_data(n=2048, seed=6, weighted=True)
    else:
        x, y = _tiers(n=2048, seed=6)
        w = np.random.default_rng(3).uniform(0.2, 2.0, len(y)).astype(np.float32)
    kw = dict(kw, family=family, max_iter=12)
    jm = J.LogisticRegression(**kw).fit(J.HostDataset(x=x, y=y, w=w, max_device_rows=512))
    pm = P.LogisticRegression(**kw).fit(P.HostDataset(x=x, y=y, w=w, max_device_rows=512),
                                        device="cpu")
    rm = P.LogisticRegression(**kw).fit((x, y, w), device="cpu")
    assert not pm.has_summary and pm.n_iter == jm.n_iter
    assert pm.fit_info["host_syncs"] == pm.n_iter + 1
    if family == "binomial":
        got = _theta(pm.coefficients.numpy(), pm.intercept)
        _close(got, _theta(jm.coefficients, jm.intercept), COEF_TOL)
        _close(got, _theta(rm.coefficients.numpy(), rm.intercept), COEF_TOL)
        assert pm.n_iter == rm.n_iter
    else:
        got = _centred(pm.coefficient_matrix.numpy(), pm.intercept_vector.numpy())
        _close(got, _centred(jm.coefficient_matrix, jm.intercept_vector), MULTI_TOL)
        _close(got, _centred(rm.coefficient_matrix.numpy(), rm.intercept_vector.numpy()),
               MULTI_TOL)


def test_streamed_standardization_matches_reference():
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu.parallel import (
        outofcore as joc,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.parallel import (
        outofcore as poc,
    )

    rng = np.random.default_rng(0)
    x = rng.normal(size=(1000, 3)).astype(np.float32) * [1.0, 1e-8, 3.0] + [0.0, 7.0, 2.0]
    y = rng.integers(0, 4, 1000).astype(np.float32)
    w = rng.uniform(0.0, 2.0, 1000).astype(np.float32)
    for extra in ("none", "ysum", "ymax"):
        jr = joc.streamed_standardization(J.HostDataset(x=x, y=y, w=w, max_device_rows=256),
                                          J.build_mesh(), extra=extra)
        pr = poc.streamed_standardization(P.HostDataset(x=x, y=y, w=w, max_device_rows=256),
                                          "cpu", extra=extra)
        np.testing.assert_allclose(pr[0], jr[0], rtol=1e-6)
        np.testing.assert_allclose(pr[1], jr[1], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(pr[2], jr[2], rtol=1e-4)
        assert pr[2][1] == jr[2][1] == 1.0          # the degenerate-variance rule
        if extra != "none":
            np.testing.assert_allclose(pr[3], jr[3], rtol=1e-6)
        for flags in ((True, True), (False, True), (True, False)):
            np.testing.assert_array_equal(
                poc.standardized_ridge(jr[0], jr[2], 0.3, 3, *flags),
                joc.standardized_ridge(jr[0], jr[2], 0.3, 3, *flags))


def test_family_rules_and_errors():
    x, y = _tiers(n=300, seed=2)
    for pkg, kw in ((J, {}), (P, {"device": "cpu"})):
        with pytest.raises(ValueError, match="binomial family supports"):
            pkg.LogisticRegression(family="binomial").fit((x, y), **kw)
        with pytest.raises(ValueError, match="family must be"):
            pkg.LogisticRegression(family="poisson").fit((x, y), **kw)
        assert isinstance(pkg.LogisticRegression().fit((x, y), **kw),
                          pkg.MultinomialLogisticRegressionModel)
    with pytest.raises(ValueError, match="needs labels"):
        P.LogisticRegression().fit(P.HostDataset(x=x), device="cpu")
    with pytest.raises(ValueError, match="empty dataset"):
        P.LogisticRegression().fit(P.HostDataset(x=x[:0], y=y[:0]), device="cpu")
    with pytest.raises(ValueError, match="binomial family supports"):
        P.LogisticRegression(family="binomial").fit(P.HostDataset(x=x, y=y), device="cpu")


def test_table_input_weight_col_and_transform_proba():
    x, y, w = _binary_data(n=600, seed=8, weighted=True)
    cols = {"a": x[:, 0], "b": x[:, 1], "c": x[:, 2], "LOS_binary": y.astype(np.int64), "w": w}
    jt = J.VectorAssembler(["a", "b", "c"]).transform(J.Table.from_dict(cols))
    pt_ = P.VectorAssembler(["a", "b", "c"]).transform(P.Table.from_dict(cols))
    jm = J.LogisticRegression(weight_col="w").fit(jt)
    pm = P.LogisticRegression(weight_col="w").fit(pt_, device="cpu")
    assert pm.n_iter == jm.n_iter
    _close(_theta(pm.coefficients.numpy(), pm.intercept), _theta(jm.coefficients, jm.intercept),
           COEF_TOL)
    jr = jm.transform_proba(jt, label_col="LOS_binary")
    pr = pm.transform_proba(pt_, label_col="LOS_binary", device="cpu")
    np.testing.assert_allclose(pr.prediction.numpy()[:600], np.asarray(jr.prediction)[:600],
                               atol=PROBA_TOL)
    np.testing.assert_array_equal(pr.label.numpy()[:600], np.asarray(jr.label)[:600])
    with pytest.raises(ValueError, match="weight_col"):
        P.LogisticRegression(weight_col="w").fit((x, y), device="cpu")


# ----------------------------------------------------------------- summaries
SUMMARY_FLOATS = ("accuracy", "weighted_precision", "weighted_recall", "weighted_f_measure",
                  "weighted_true_positive_rate", "weighted_false_positive_rate")
SUMMARY_ARRAYS = ("precision_by_label", "recall_by_label", "f_measure_by_label",
                  "true_positive_rate_by_label", "false_positive_rate_by_label")


def _summary_metrics_equal(ps, js, rel):
    for name in SUMMARY_FLOATS:
        assert getattr(ps, name) == pytest.approx(getattr(js, name), rel=rel), name
    for name in SUMMARY_ARRAYS:
        np.testing.assert_allclose(getattr(ps, name), getattr(js, name), rtol=rel,
                                   err_msg=name)


@pytest.mark.parametrize("weighted", [False, True])
def test_binary_summary_matches_reference(weighted):
    x, y, w = _binary_data(n=2000, seed=9, weighted=weighted)
    jm = J.LogisticRegression(reg_param=0.01).fit(_inputs(x, y, w))
    pm = P.LogisticRegression(reg_param=0.01).fit(_inputs(x, y, w), device="cpu")
    js, ps = jm.summary, pm.summary
    assert pm.has_summary
    # unweighted: integer counts, equal; weighted: float32 sums of the
    # weights in two orders
    _summary_metrics_equal(ps, js, 1e-6 if weighted else 1e-12)
    assert ps.area_under_roc == pytest.approx(js.area_under_roc, abs=AUC_TOL)
    assert ps.area_under_pr == pytest.approx(js.area_under_pr, abs=AUC_TOL)
    # the curves: one point per distinct float32 score; scores within
    # 2e-6 of each other may split or merge a tie block, so the curves are
    # compared where both have the same length (they do here)
    for name in ("roc", "pr"):
        assert getattr(ps, name).shape == getattr(js, name).shape, name
        np.testing.assert_allclose(getattr(ps, name), getattr(js, name), atol=1e-5, err_msg=name)
    for name in ("precision_by_threshold", "recall_by_threshold", "f_measure_by_threshold"):
        np.testing.assert_allclose(getattr(ps, name)(), getattr(js, name)(), atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(ps.f_measure_by_threshold(beta=0.5),
                               js.f_measure_by_threshold(beta=0.5), atol=1e-5)
    assert ps.max_f_measure_threshold == pytest.approx(js.max_f_measure_threshold, abs=1e-5)
    pm.release_summary()
    assert not pm.has_summary
    with pytest.raises(RuntimeError, match="no training summary"):
        pm.summary


def test_multiclass_summary_matches_reference():
    x, y = _tiers(n=2000, seed=10)
    jm = J.LogisticRegression(max_iter=10).fit((x, y))
    pm = P.LogisticRegression(max_iter=10).fit((x, y), device="cpu")
    js, ps = jm.summary, pm.summary
    assert ps.num_classes == js.num_classes == 3
    _summary_metrics_equal(ps, js, 1e-12)
    assert not hasattr(ps, "roc")


def test_summary_absent_after_load_and_artifacts_cross(tmp_path):
    x, y, _ = _binary_data(n=500, seed=11)
    xm, ym = _tiers(n=500, seed=11)
    pm = P.LogisticRegression(threshold=0.4).fit((x, y), device="cpu")
    pmm = P.LogisticRegression().fit((xm, ym), device="cpu")
    jm = J.LogisticRegression(threshold=0.4).fit((x, y))
    jmm = J.LogisticRegression().fit((xm, ym))
    for name, m in (("pb", pm), ("pm", pmm)):
        m.save(str(tmp_path / name))
    jm.save(str(tmp_path / "jb"))
    jmm.write().overwrite().save(str(tmp_path / "jm"))
    # port → JAX
    jb = J.load_model(str(tmp_path / "pb"))
    assert type(jb).__name__ == "LogisticRegressionModel" and jb.threshold == 0.4
    np.testing.assert_array_equal(np.asarray(jb.predict(x)), pm.predict(torch.from_numpy(x)).numpy())
    jmu = J.load_model(str(tmp_path / "pm"))
    np.testing.assert_array_equal(np.asarray(jmu.predict(xm)),
                                  pmm.predict(torch.from_numpy(xm)).numpy())
    # JAX → port
    pb = P.load_model(str(tmp_path / "jb"))
    assert not pb.has_summary and pb.n_iter == jm.n_iter and pb.threshold == 0.4
    np.testing.assert_array_equal(pb.predict_numpy(x, device="cpu"), np.asarray(jm.predict(x)))
    pmu = P.load_model(str(tmp_path / "jm"))
    assert type(pmu) is P.MultinomialLogisticRegressionModel
    np.testing.assert_array_equal(pmu.predict_numpy(xm, device="cpu"), np.asarray(jmm.predict(xm)))
    with pytest.raises(RuntimeError, match="no training summary"):
        pmu.summary
    # in memory, through convert
    _, params, arrays = jm._artifacts()
    cm = P.logistic_regression_model_from_jax_arrays(**arrays, **params)
    np.testing.assert_array_equal(cm.predict_numpy(x, device="cpu"), np.asarray(jm.predict(x)))
    _, params, arrays = jmm._artifacts()
    cmm = P.multinomial_logistic_regression_model_from_jax_arrays(**arrays, **params)
    np.testing.assert_array_equal(cmm.predict_numpy(xm, device="cpu"),
                                  np.asarray(jmm.predict(xm)))
    # the same bytes either way
    pb.save(str(tmp_path / "pb2"))
    assert (tmp_path / "pb2" / "arrays.npz").read_bytes() == \
        (tmp_path / "jb" / "arrays.npz").read_bytes()


def test_plot_roc_and_pr(tmp_path):
    pytest.importorskip("matplotlib")
    x, y, _ = _binary_data(n=400, seed=12)
    s = P.LogisticRegression().fit((x, y), device="cpu").summary
    roc = P.viz.plot_roc(s, str(tmp_path))
    pr = P.viz.plot_pr(s, str(tmp_path), filename="pr_curve.png")
    assert roc.endswith("roc.png") and pr.endswith("pr_curve.png")
    for path in (roc, pr):
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_plots_without_matplotlib_name_the_extra(monkeypatch, tmp_path):
    import sys

    x, y, _ = _binary_data(n=200, seed=13)
    s = P.LogisticRegression().fit((x, y), device="cpu").summary
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.figure", None)
    for fn in (P.viz.plot_roc, P.viz.plot_pr):
        with pytest.raises(ImportError, match="viz"):
            fn(s, str(tmp_path))
