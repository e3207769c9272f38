"""The port's GeneralizedLinearRegression against the JAX package's, on the CPU.

The same numpy rows (made from a seed) go through the JAX estimator on its
8-device CPU mesh and the port's (``device="cpu"``): every family and
link, weights, an offset column, ridge, no intercept, no standardization,
the training summary, predictions and the out-of-core fit.

Tolerances, and why:
- coefficients and intercept within 2e-5 of the largest (2.6e-6
  measured): the Gram and moment are float32 sums over the rows, per
  device and psum'd in the JAX package, per 128-row chunk in the port
  (``STAT_CHUNK``), and each IRLS step carries the rounding; deviance,
  null deviance, Pearson χ², log-likelihood sums within 1e-5 relative
  (1.1e-7 measured on the deviance);
- ``n_iter`` equal at tol 1e-4, where the stop is the algorithm's: the
  relative step of the last iteration is orders above float32 rounding
  on these inputs.  At the default tol 1e-6 the last step is a few ulps
  of the coefficients and rounding decides the stop in both packages:
  ``test_stop_at_tol_1e6_is_decided_by_rounding`` shows it (ROADMAP
  queue 3);
- standard errors, t-values within 1e-4 relative and p-values within
  1e-4 absolute: the weighted Gram is read in float32 and inverted in
  float64 on the host (the rounding of a float32 Gram sum, amplified by
  its condition number);
- residuals within 1e-5 of the largest; predictions at rtol 1e-5;
- out of core against resident within 2e-5 of the largest, ``n_iter``
  equal at tol 1e-4;
- the gaussian GLM's distance from LinearRegression on raw hospital-scale
  features: 1e-2–1.6e-2 of the largest coefficient in the JAX package
  (the IRLS jitter, held within 1e-4 of its float64 solve), and the
  port's within 1e-4 of it.
"""

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models import glm as pglm

torch.set_num_threads(1)

COEF_TOL = 2e-5
REL_TOL = 1e-5
SE_RTOL = 1e-4
P_ATOL = 1e-4
TOL = 1e-4

N = 2000


def _x(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 3)) * [1.0, 2.0, 0.5] + [0.0, 1.0, -1.0]).astype(np.float32)
    return x, rng, x @ [0.3, -0.2, 0.4] + 0.5


def _labels(family, link, vp, lp, n=N, seed=0):
    """Labels of the family's law from a linear predictor of the rows."""
    x, rng, eta = _x(n, seed)
    y = {
        ("gaussian", "identity"): lambda: eta + rng.normal(size=n) * 0.5,
        ("gaussian", "log"): lambda: np.exp(eta * 0.3) + rng.uniform(0.01, 0.2, n),
        ("binomial", "logit"): lambda: (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(float),
        ("poisson", "log"): lambda: rng.poisson(np.exp(eta * 0.5)).astype(float),
        ("poisson", "identity"): lambda: rng.poisson(np.exp(eta * 0.3) + 1).astype(float),
        ("poisson", "sqrt"): lambda: rng.poisson(np.exp(eta * 0.3)).astype(float),
        ("gamma", "inverse"): lambda: rng.gamma(2.0, 1 / (2.0 * (1 + np.exp(eta * 0.2)))),
        ("gamma", "log"): lambda: rng.gamma(2.0, np.exp(eta * 0.3) / 2),
        ("gamma", "identity"): lambda: rng.gamma(2.0, (np.exp(eta * 0.3) + 1) / 2),
        ("tweedie", 1.5): lambda: rng.poisson(np.exp(eta * 0.3) + 0.5) * rng.gamma(2, 0.5, n),
        ("tweedie", 0.0): lambda: eta + rng.normal(size=n),
        ("tweedie", 2.5): lambda: rng.gamma(2.0, np.exp(eta * 0.3) / 2),
    }[(family, link if family != "tweedie" else vp)]()
    return x, y.astype(np.float32)


FAMILIES = [
    ("gaussian", "identity", 0.0, None), ("gaussian", "log", 0.0, None),
    ("binomial", "logit", 0.0, None), ("poisson", "log", 0.0, None),
    ("poisson", "identity", 0.0, None), ("poisson", "sqrt", 0.0, None),
    ("gamma", "inverse", 0.0, None), ("gamma", "log", 0.0, None),
    ("gamma", "identity", 0.0, None), ("tweedie", None, 1.5, None),
    ("tweedie", None, 1.5, 0.5), ("tweedie", None, 0.0, 1.0), ("tweedie", None, 2.5, 0.0),
]


def _kw(family, link, vp, lp):
    return dict(family=family, link=link, variance_power=vp, link_power=lp)


def _theta(m):
    coef = m.coefficients.numpy() if hasattr(m.coefficients, "numpy") else m.coefficients
    return np.r_[np.asarray(coef, np.float64), float(m.intercept)]


def _close_fit(pm, jm):
    tp, tj = _theta(pm), _theta(jm)
    assert np.abs(tp - tj).max() <= COEF_TOL * np.abs(tj).max()
    assert abs(pm.deviance - jm.deviance) <= REL_TOL * max(abs(jm.deviance), 1e-30)
    assert (pm.family, pm.link, pm.variance_power, pm.link_power) == \
        (jm.family, jm.link, jm.variance_power, jm.link_power)


@pytest.mark.parametrize("family,link,vp,lp", FAMILIES)
def test_every_family_and_link_matches_jax(family, link, vp, lp):
    x, y = _labels(family, "power" if link is None else link, vp, lp)
    kw = _kw(family, link, vp, lp)
    jm = J.GeneralizedLinearRegression(tol=TOL, **kw).fit((x, y))
    pm = P.GeneralizedLinearRegression(tol=TOL, **kw).fit((x, y), device="cpu")
    assert pm.n_iter == jm.n_iter and pm.fit_info["n_iter"] == pm.n_iter
    _close_fit(pm, jm)
    xs = torch.from_numpy(x[:200])
    np.testing.assert_allclose(pm.predict(xs).numpy(), np.asarray(jm.predict(x[:200])),
                               rtol=REL_TOL, atol=1e-6)
    np.testing.assert_allclose(pm.predict_link(xs).numpy(),
                               np.asarray(jm.predict_link(x[:200])), rtol=REL_TOL, atol=1e-5)


@pytest.mark.parametrize("options", [
    {"reg_param": 0.1}, {"fit_intercept": False}, {"standardize": False},
    {"reg_param": 0.05, "standardize": False}, {"max_iter": 2},
])
@pytest.mark.parametrize("family,link", [("poisson", "log"), ("binomial", "logit"),
                                         ("gamma", "log")])
def test_ridge_intercept_and_standardization_options(options, family, link):
    x, y = _labels(family, link, 0.0, None, seed=3)
    jm = J.GeneralizedLinearRegression(family=family, link=link, tol=TOL, **options).fit((x, y))
    pm = P.GeneralizedLinearRegression(family=family, link=link, tol=TOL, **options).fit(
        (x, y), device="cpu")
    assert pm.n_iter == jm.n_iter
    _close_fit(pm, jm)
    if not options.get("fit_intercept", True):
        assert pm.intercept == 0.0


@pytest.mark.parametrize("family,link", [("poisson", "log"), ("gamma", "inverse"),
                                         ("gaussian", "identity")])
def test_sample_weights(family, link):
    x, y = _labels(family, link, 0.0, None, seed=5)
    w = np.random.default_rng(5).uniform(0.2, 2.0, N).astype(np.float32)
    w[::17] = 0.0
    jm = J.GeneralizedLinearRegression(family=family, link=link, tol=TOL).fit((x, y, w))
    pm = P.GeneralizedLinearRegression(family=family, link=link, tol=TOL).fit(
        (x, y, w), device="cpu")
    assert pm.n_iter == jm.n_iter
    _close_fit(pm, jm)
    assert pm.summary.num_instances == jm.summary.num_instances == int((w > 0).sum())


def _tables(x, y, offset):
    cols = {"a": x[:, 0], "b": x[:, 1], "c": x[:, 2], "length_of_stay": y, "exposure": offset}
    return (J.VectorAssembler(["a", "b", "c"]).transform(J.Table.from_dict(cols)),
            P.VectorAssembler(["a", "b", "c"]).transform(P.Table.from_dict(cols)))


@pytest.mark.parametrize("fit_intercept", [True, False])
def test_offset_column_and_its_summary(fit_intercept):
    x, rng, eta = _x(seed=7)
    offset = np.log(rng.integers(1, 20, N)).astype(np.float32)
    y = rng.poisson(np.exp(0.4 * eta + offset)).astype(np.float32)
    jt, pt = _tables(x, y, offset)
    kw = dict(family="poisson", offset_col="exposure", tol=TOL, fit_intercept=fit_intercept)
    jm = J.GeneralizedLinearRegression(**kw).fit(jt)
    pm = P.GeneralizedLinearRegression(**kw).fit(pt, device="cpu")
    assert pm.n_iter == jm.n_iter
    _close_fit(pm, jm)
    js, ps = jm.summary, pm.summary
    for a in ("deviance", "null_deviance", "pearson_chi_squared", "aic"):
        assert abs(getattr(ps, a) - getattr(js, a)) <= REL_TOL * abs(getattr(js, a)), a
    np.testing.assert_allclose(pm.predict(torch.from_numpy(x), offset=offset).numpy(),
                               np.asarray(jm.predict(x, offset=offset)), rtol=REL_TOL)
    with pytest.raises(ValueError, match="needs a table input"):
        P.GeneralizedLinearRegression(**kw).fit((x, y), device="cpu")
    with pytest.raises(KeyError, match="not a column"):
        P.GeneralizedLinearRegression(family="poisson", offset_col="nope").fit(pt, device="cpu")


SUMMARY_CASES = [("gaussian", "identity", 0.0, None), ("binomial", "logit", 0.0, None),
                 ("poisson", "log", 0.0, None), ("gamma", "log", 0.0, None),
                 ("tweedie", None, 1.5, None)]


@pytest.mark.parametrize("family,link,vp,lp", SUMMARY_CASES)
def test_training_summary_matches_jax(family, link, vp, lp):
    x, y = _labels(family, "power" if link is None else link, vp, lp, seed=11)
    kw = _kw(family, link, vp, lp)
    jm = J.GeneralizedLinearRegression(tol=TOL, **kw).fit((x, y))
    pm = P.GeneralizedLinearRegression(tol=TOL, **kw).fit((x, y), device="cpu")
    js, ps = jm.summary, pm.summary
    for a in ("deviance", "null_deviance", "pearson_chi_squared", "dispersion"):
        assert abs(getattr(ps, a) - getattr(js, a)) <= REL_TOL * abs(getattr(js, a)), a
    for a in ("num_instances", "rank", "degrees_of_freedom", "residual_degree_of_freedom",
              "residual_degree_of_freedom_null"):
        assert getattr(ps, a) == getattr(js, a), a
    if family == "tweedie":
        with pytest.raises(RuntimeError, match="tweedie"):
            ps.aic
    else:
        assert abs(ps.aic - js.aic) <= REL_TOL * abs(js.aic)
    for kind in ("deviance", "pearson", "working", "response"):
        r, rj = ps.residuals(kind), js.residuals(kind)
        assert r.shape == rj.shape == (N,)
        if kind == "deviance":
            # sign(y − μ)·√(w·d): d is a float32 difference of O(1) terms
            # that cancel where y ≈ μ, and √ magnifies that rounding near
            # 0, so the signed squares w·d are compared
            r, rj = r * np.abs(r), rj * np.abs(rj)
        assert np.abs(r - rj).max() <= REL_TOL * np.abs(rj).max(), kind
    with pytest.raises(ValueError, match="residuals_type"):
        ps.residuals("raw")
    np.testing.assert_allclose(ps.coefficient_standard_errors, js.coefficient_standard_errors,
                               rtol=SE_RTOL)
    np.testing.assert_allclose(ps.t_values, js.t_values, rtol=SE_RTOL)
    np.testing.assert_allclose(ps.p_values, js.p_values, atol=P_ATOL)


def test_regularized_fit_refuses_inference_and_loaded_model_has_no_summary(tmp_path):
    x, y = _labels("poisson", "log", 0.0, None)
    pm = P.GeneralizedLinearRegression(family="poisson", reg_param=0.1).fit((x, y), device="cpu")
    for a in ("coefficient_standard_errors", "t_values", "p_values"):
        with pytest.raises(RuntimeError, match="unregularized"):
            getattr(pm.summary, a)
    pm.save(str(tmp_path / "glm"))
    loaded = P.load_model(str(tmp_path / "glm"))
    assert not loaded.has_summary
    with pytest.raises(RuntimeError, match="no training summary"):
        loaded.summary
    pm.release_summary()
    assert not pm.has_summary


def test_collinear_design_refuses_standard_errors():
    x, y = _labels("poisson", "log", 0.0, None)
    xc = np.c_[x, x[:, 0] * 2.0].astype(np.float32)
    pm = P.GeneralizedLinearRegression(family="poisson", tol=TOL).fit((xc, y), device="cpu")
    with pytest.raises(RuntimeError, match="collinear"):
        pm.summary.coefficient_standard_errors


@pytest.mark.parametrize("bad,match", [
    (dict(family="nope"), "family must be one of"),
    (dict(family="binomial", link="log"), "not supported"),
    (dict(family="tweedie", variance_power=0.5), "variance_power must be"),
])
def test_family_and_link_checks(bad, match):
    x, y = _labels("poisson", "log", 0.0, None, n=50)
    for pkg in (J, P):
        with pytest.raises(ValueError, match=match):
            kw = {"device": "cpu"} if pkg is P else {}
            pkg.GeneralizedLinearRegression(**bad).fit((x, y), **kw)


@pytest.mark.parametrize("family,link,vp,labels,match", [
    ("binomial", None, 0.0, [0.0, 2.0], "0/1 labels"),
    ("poisson", None, 0.0, [-1.0, 1.0], "non-negative"),
    ("gamma", None, 0.0, [0.0, 1.0], "positive"),
    ("tweedie", None, 2.5, [0.0, 1.0], "needs positive"),
    ("tweedie", None, 1.5, [-1.0, 1.0], "non-negative"),
    ("gaussian", "log", 0.0, [0.0, 1.0], "log link needs positive"),
])
def test_label_checks(family, link, vp, labels, match):
    x = np.random.default_rng(0).normal(size=(2, 3)).astype(np.float32)
    y = np.asarray(labels, np.float32)
    est = dict(family=family, link=link, variance_power=vp)
    with pytest.raises(ValueError, match=match):
        J.GeneralizedLinearRegression(**est).fit((x, y))
    with pytest.raises(ValueError, match=match):
        P.GeneralizedLinearRegression(**est).fit((x, y), device="cpu")
    with pytest.raises(ValueError, match=match):
        P.GeneralizedLinearRegression(**est).fit(P.HostDataset(x, y), device="cpu")


@pytest.mark.parametrize("family,link,vp", [("poisson", "log", 0.0), ("binomial", "logit", 0.0),
                                            ("gamma", "inverse", 0.0), ("tweedie", None, 1.5)])
def test_out_of_core_matches_resident_and_jax(family, link, vp):
    x, y = _labels(family, "power" if link is None else link, vp, None, seed=13)
    kw = _kw(family, link, vp, None)
    resident = P.GeneralizedLinearRegression(tol=TOL, **kw).fit((x, y), device="cpu")
    hd = P.HostDataset(x=x, y=y, max_device_rows=512)
    ooc = P.GeneralizedLinearRegression(tol=TOL, **kw).fit(hd, device="cpu")
    assert ooc.n_iter == resident.n_iter and not ooc.has_summary
    tr = _theta(resident)
    assert np.abs(_theta(ooc) - tr).max() <= COEF_TOL * np.abs(tr).max()
    assert abs(ooc.deviance - resident.deviance) <= REL_TOL * abs(resident.deviance)
    jooc = J.GeneralizedLinearRegression(tol=TOL, **kw).fit(J.HostDataset(x=x, y=y,
                                                                          max_device_rows=512))
    assert ooc.n_iter == jooc.n_iter
    _close_fit(ooc, jooc)
    with pytest.raises(ValueError, match="HostDataset has no columns"):
        P.GeneralizedLinearRegression(family=family, offset_col="e").fit(hd, device="cpu")


def test_stop_at_tol_1e6_is_decided_by_rounding():
    # the default tol 1e-6: on these inputs the last relative step is a
    # few float32 ulps, so rounding decides the stop in both packages
    # (ROADMAP queue 3).  Measured: gamma/inverse stops at 7 here and 9 in
    # the JAX package, tweedie p = 1.5 with link power 0.5 at 8 and 7; the
    # other families stop together.  The fits agree and the stops lie
    # within two iterations of each other.
    for family, link, vp, lp in FAMILIES:
        x, y = _labels(family, "power" if link is None else link, vp, lp)
        kw = _kw(family, link, vp, lp)
        jm = J.GeneralizedLinearRegression(**kw).fit((x, y))
        pm = P.GeneralizedLinearRegression(**kw).fit((x, y), device="cpu")
        _close_fit(pm, jm)
        assert abs(pm.n_iter - jm.n_iter) <= 2, (family, link, vp, lp, pm.n_iter, jm.n_iter)


def test_link_functions_invert_and_differentiate():
    mu = torch.tensor([0.2, 0.5, 0.9, 1.7], dtype=torch.float64)
    for link, lp in (("identity", 0.0), ("log", 0.0), ("inverse", 0.0), ("sqrt", 0.0),
                     ("power", 0.5), ("power", -0.5), ("power", 2.0)):
        g, ginv, gprime = pglm.link_fns(link, lp)
        m = mu if link != "logit" else mu / 2
        torch.testing.assert_close(ginv(g(m)), m)
        h = 1e-6
        torch.testing.assert_close(gprime(m), (g(m + h) - g(m - h)) / (2 * h), rtol=1e-5,
                                   atol=1e-8)
    g, ginv, _ = pglm.link_fns("power", 0.5)
    assert torch.isnan(ginv(torch.tensor([-1.0]))).all()


def test_artifacts_cross_both_ways(tmp_path):
    x, y = _labels("tweedie", "power", 1.5, 0.5)
    kw = _kw("tweedie", None, 1.5, 0.5)
    jm = J.GeneralizedLinearRegression(tol=TOL, **kw).fit((x, y))
    pm = P.GeneralizedLinearRegression(tol=TOL, **kw).fit((x, y), device="cpu")
    jm.save(str(tmp_path / "j"))
    pm.save(str(tmp_path / "p"))
    pl, jl = P.load_model(str(tmp_path / "j")), J.load_model(str(tmp_path / "p"))
    # the same parameters; μ = η² through each backend's power (torch
    # squares, XLA's pow differs in the last bit)
    np.testing.assert_allclose(pl.predict_numpy(x, device="cpu"), np.asarray(jm.predict(x)),
                               rtol=REL_TOL)
    np.testing.assert_allclose(np.asarray(jl.predict(x)), pm.predict_numpy(x, device="cpu"),
                               rtol=REL_TOL)
    np.testing.assert_array_equal(pl.coefficients.numpy(), jm.coefficients)
    pl.save(str(tmp_path / "j2"))
    assert (tmp_path / "j2" / "arrays.npz").read_bytes() == \
        (tmp_path / "j" / "arrays.npz").read_bytes()
    _, params, arrays = jm._artifacts()
    cm = P.glm_model_from_jax_arrays(**arrays, **params)
    np.testing.assert_array_equal(cm.predict_numpy(x, device="cpu"),
                                  pl.predict_numpy(x, device="cpu"))


def test_gaussian_glm_sits_off_linear_regression_by_the_reference_jitter():
    # Raw hospital-scale features (the example generator's law: admission
    # count 0–49, occupancy 20–399, emergency visits 0–29, seasonality
    # 0.5–1.5): the IRLS solve adds 1e-7·tr(XᵀX)/d, where occupancy² fills
    # the trace, to a Gram whose smallest direction is seasonality's
    # spread.  That shrinks the gaussian / identity fit by about 1.3e-2 of
    # the largest coefficient in the JAX package and the port alike, while
    # LinearRegression (jitter 1e-8) sits on the float64 least squares.
    # chip_smoke.py holds the card's gap to LinearRegression under 2e-2.
    n = 20_000
    rng = np.random.default_rng(7)
    x = np.c_[rng.integers(0, 50, n), rng.integers(20, 400, n), rng.integers(0, 30, n),
              rng.uniform(0.5, 1.5, n)].astype(np.float32)
    y = (x.astype(np.float64) @ [0.05, 0.008, 0.12, 2.0]
         + rng.normal(0.0, 0.4, n)).astype(np.float32)
    xa = np.c_[x.astype(np.float64), np.ones(n)]
    gram, mom = xa.T @ xa, xa.T @ y.astype(np.float64)
    lstsq = np.linalg.solve(gram, mom)
    jittered = np.linalg.solve(gram + (1e-7 * np.trace(gram) / 5 + 1e-9) * np.eye(5), mom)

    def rel(a, b):
        return np.abs(a - b).max() / np.abs(b).max()

    jg = J.GeneralizedLinearRegression(family="gaussian", tol=TOL).fit((x, y))
    jl = J.LinearRegression().fit((x, y))
    pg = P.GeneralizedLinearRegression(family="gaussian", tol=TOL).fit((x, y), device="cpu")
    pl = P.LinearRegression().fit((x, y), device="cpu")
    assert 1e-2 < rel(_theta(jg), lstsq) < 1.6e-2
    assert rel(_theta(jg), jittered) < 1e-4
    assert rel(_theta(jl), lstsq) < 1e-4
    assert abs(rel(_theta(pg), _theta(pl)) - rel(_theta(jg), _theta(jl))) < 1e-4
    assert rel(_theta(pg), _theta(jg)) <= COEF_TOL
