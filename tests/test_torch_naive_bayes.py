"""The port's NaiveBayes (all four model types, resident and out of core)
against the JAX package's ``models/naive_bayes.py``, on the CPU.

Tolerances, and why:
- the discrete types on integer counts: the statistics are float32 sums of
  integers below 2**24, exact in any order, and the finish is the same
  float64 numpy, so ``pi`` / ``theta`` are equal (rtol 1e-12 covers the
  float64 logs); with fractional weights the sums are float32 in two
  orders: rtol 1e-6;
- gaussian: per-class sums of centred float32 features in two orders:
  means within 1e-5 of the largest |mean|, variances rtol 1e-4 (a
  difference of second moments), priors rtol 1e-6;
- predictions equal and ``predict_raw`` within 1e-4 relative of the
  largest |log-likelihood| (float32 products of the same parameters).
"""

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.models import naive_bayes as jnb
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models import (
    naive_bayes as pnb,
)

torch.set_num_threads(1)
TYPES = ["multinomial", "bernoulli", "complement", "gaussian"]


def _data(model_type: str, n=1500, d=6, k=3, seed=0, weighted=False):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n).astype(np.float32)
    if model_type == "gaussian":
        x = (rng.normal(size=(n, d)) + y[:, None] * 0.8 + np.arange(d) * 3.0).astype(np.float32)
        x[:, 0] += 2000.0                  # a year-like column: the centring matters
    elif model_type == "bernoulli":
        x = (rng.random((n, d)) < 0.2 + 0.2 * (y[:, None] == np.arange(d) % k)).astype(np.float32)
    else:
        x = rng.poisson(2.0 + y[:, None] * (np.arange(d) % 3), (n, d)).astype(np.float32)
    w = rng.uniform(0.2, 2.0, n).astype(np.float32) if weighted else None
    return x, y, w


def _inputs(x, y, w):
    return (x, y) if w is None else (x, y, w)


def _models_close(pm, jm, exact: bool):
    assert pm.model_type == jm.model_type
    if pm.model_type == "gaussian":
        np.testing.assert_allclose(pm.pi, jm.pi, rtol=1e-6)
        np.testing.assert_allclose(pm.theta, jm.theta, atol=1e-5 * np.abs(jm.theta).max())
        np.testing.assert_allclose(pm.sigma, jm.sigma, rtol=1e-4)
        return
    rtol = 1e-12 if exact else 1e-6
    np.testing.assert_allclose(pm.pi, jm.pi, rtol=rtol)
    np.testing.assert_allclose(pm.theta, jm.theta, rtol=rtol)
    if pm.model_type == "bernoulli":
        np.testing.assert_allclose(pm.theta2, jm.theta2, rtol=rtol)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("model_type", TYPES)
def test_fit_and_predict_match_reference(model_type, weighted):
    x, y, w = _data(model_type, weighted=weighted)
    jm = J.NaiveBayes(model_type=model_type).fit(_inputs(x, y, w))
    pm = P.NaiveBayes(model_type=model_type).fit(_inputs(x, y, w), device="cpu")
    _models_close(pm, jm, exact=not weighted)
    xt = torch.from_numpy(x)
    jr = np.asarray(jm.predict_raw(x))
    np.testing.assert_allclose(pm.predict_raw(xt).numpy(), jr, atol=1e-4 * np.abs(jr).max())
    np.testing.assert_array_equal(pm.predict(xt).numpy(), np.asarray(jm.predict(x)))
    np.testing.assert_allclose(pm.predict_proba(xt).numpy(), np.asarray(jm.predict_proba(x)),
                               atol=1e-4)


@pytest.mark.parametrize("model_type", TYPES)
def test_outofcore_matches_reference_and_resident(model_type):
    x, y, w = _data(model_type, n=2048, seed=1, weighted=True)
    jm = J.NaiveBayes(model_type=model_type).fit(J.HostDataset(x=x, y=y, w=w,
                                                               max_device_rows=512))
    pm = P.NaiveBayes(model_type=model_type).fit(P.HostDataset(x=x, y=y, w=w,
                                                               max_device_rows=512), device="cpu")
    rm = P.NaiveBayes(model_type=model_type).fit((x, y, w), device="cpu")
    _models_close(pm, jm, exact=False)
    _models_close(pm, rm, exact=False)


def test_statistics_functions_match_reference():
    x, y, w = _data("multinomial", n=700, seed=2, weighted=True)
    jc, js, jbad = jnb._count_sums(x, y, w, 3)
    pc, ps, pbad = pnb._count_sums(torch.from_numpy(x), torch.from_numpy(y),
                                   torch.from_numpy(w), 3)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-6)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-6)
    assert bool(pbad) == bool(jbad) is False
    xg, yg, wg = _data("gaussian", n=700, seed=3, weighted=True)
    jr = jnb._gaussian_stats(xg, yg, wg, 3)
    pr = pnb._gaussian_stats(torch.from_numpy(xg), torch.from_numpy(yg), torch.from_numpy(wg), 3)
    # the centre is a float32 weighted mean of ~2000-valued features: one
    # ulp apart shifts every centred sum by its count times that ulp, so the
    # centred sums are compared at the same centre below
    np.testing.assert_allclose(pr[0].numpy(), np.asarray(jr[0]), rtol=1e-6)
    np.testing.assert_allclose(pr[3].numpy(), np.asarray(jr[3]), rtol=1e-6)
    centre = np.asarray(jr[3])
    jc2 = jnb._gaussian_stats_centered(xg, yg, wg, 3, centre)
    pc2 = pnb._gaussian_stats_centered(torch.from_numpy(xg), torch.from_numpy(yg),
                                       torch.from_numpy(wg), 3, torch.from_numpy(centre))
    for a, b in zip(pc2, jc2):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("model_type", ["multinomial", "complement", "bernoulli"])
def test_bad_features_raise_like_reference(model_type):
    x, y, _ = _data(model_type, n=200, seed=4)
    bad = x.copy()
    bad[3, 1] = -1.0 if model_type != "bernoulli" else 0.5
    nan = x.copy()
    nan[7, 2] = np.nan
    for data in (bad, nan):
        for fit in (lambda d: J.NaiveBayes(model_type=model_type).fit((d, y)),
                    lambda d: P.NaiveBayes(model_type=model_type).fit((d, y), device="cpu"),
                    lambda d: P.NaiveBayes(model_type=model_type).fit(
                        P.HostDataset(x=d, y=y, max_device_rows=64), device="cpu")):
            with pytest.raises(ValueError, match="requires"):
                fit(data)


def test_gaussian_non_finite_and_estimator_errors():
    x, y, _ = _data("gaussian", n=200, seed=5)
    x[4, 0] = np.inf
    for fit in (lambda: J.NaiveBayes(model_type="gaussian").fit((x, y)),
                lambda: P.NaiveBayes(model_type="gaussian").fit((x, y), device="cpu")):
        with pytest.raises(ValueError, match="NaN/Inf"):
            fit()
    with pytest.raises(ValueError, match="model_type must be"):
        P.NaiveBayes(model_type="poisson").fit((x, y), device="cpu")
    with pytest.raises(ValueError, match="needs labels"):
        P.NaiveBayes().fit(P.HostDataset(x=x), device="cpu")
    with pytest.raises(ValueError, match="no positively-weighted"):
        P.NaiveBayes().fit(P.HostDataset(x=x, y=y, w=np.zeros(len(y), np.float32)),
                           device="cpu")


@pytest.mark.parametrize("model_type", ["multinomial", "complement", "gaussian"])
def test_nan_in_zero_weight_rows_is_inert(model_type):
    """A NaN in a w = 0 row: the port masks the row's features before any
    product, so the model equals the fit with that row's features zeroed.
    The reference's discrete types take onehotᵀ·x unmasked and come out
    NaN (ROADMAP queue 3); its gaussian type masks, as the port does."""
    x, y, _ = _data(model_type, n=300, seed=6)
    w = np.ones(len(y), np.float32)
    w[5] = 0.0
    clean = x.copy()
    clean[5] = 0.0
    x[5, 2] = np.nan
    pm = P.NaiveBayes(model_type=model_type).fit((x, y, w), device="cpu")
    jm_clean = J.NaiveBayes(model_type=model_type).fit((clean, y, w))
    _models_close(pm, jm_clean, exact=True)
    jm = J.NaiveBayes(model_type=model_type).fit((x, y, w))
    assert np.isnan(jm.theta).any() == (model_type != "gaussian")


@pytest.mark.parametrize("model_type", TYPES)
def test_artifacts_cross_both_ways(model_type, tmp_path):
    x, y, _ = _data(model_type, n=300, seed=7)
    pm = P.NaiveBayes(model_type=model_type).fit((x, y), device="cpu")
    jm = J.NaiveBayes(model_type=model_type).fit((x, y))
    pm.save(str(tmp_path / "p"))
    jm.save(str(tmp_path / "j"))
    jl = J.load_model(str(tmp_path / "p"))
    pl = P.load_model(str(tmp_path / "j"))
    assert type(pl) is P.NaiveBayesModel and pl.model_type == model_type
    np.testing.assert_array_equal(np.asarray(jl.predict(x)), pm.predict_numpy(x, device="cpu"))
    np.testing.assert_array_equal(pl.predict_numpy(x, device="cpu"), np.asarray(jm.predict(x)))
    _, params, arrays = jm._artifacts()
    cm = P.naive_bayes_model_from_jax_arrays(**arrays, **params)
    np.testing.assert_array_equal(cm.predict_numpy(x, device="cpu"), np.asarray(jm.predict(x)))
    pl.save(str(tmp_path / "p2"))
    assert (tmp_path / "p2" / "arrays.npz").read_bytes() == \
        (tmp_path / "j" / "arrays.npz").read_bytes()
