"""The port's LinearRegression elastic net and training summary against
the JAX package's, on the CPU.

The same numpy rows go through the JAX estimator on its 8-device CPU mesh
and the port's (``device="cpu"``).

Tolerances, and why:
- elastic-net coefficients and intercept within 1e-4 of the largest
  coefficient: the (d, d) Gram is a float32 sum over the rows, reduced per
  device and psum'd by the JAX package and per 4,096-row chunk by the
  port, and FISTA carries the rounding through its iterations; ``n_iter``
  equal (the port's chunked loop stops at the reference's iteration).
  The cases keep ``tol`` at 1e-6 or above: with β near 1, a step of 1e-7
  is one float32 ulp, and there the stop is decided by the Gram's last
  bit, which the two summation orders round differently;
- summary metrics (rmse, mse, mae, r2, r2adj) at rtol 1e-5: float32
  sums of the same residuals in two orders; the explained variance at
  rtol 1e-4, since it is a difference of float32 second moments of the
  predictions (Σp²/n − 2ȳΣp/n + ȳ²) that cancels about twentyfold here;
  counts and degrees of freedom equal; standard errors at rtol 1e-4 (the
  float64 inverse of two float32 Grams summed in other orders); t-values
  at rtol 1e-4 plus 1e-4 of the largest |t|, because a coefficient near 0
  has a t-value that is its float32 rounding (1e-6 of the largest
  coefficient) over its standard error; p-values no further apart than
  0.8·|Δt| (twice the largest Student t density); residuals and
  predictions within 1e-5 of the largest |y|;
- the resident fit at 400,000 hospital rows within 3x the reference's
  own distance from float64 (both measured here).
"""

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.models import (
    linear_regression as jlr,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.parallel.outofcore import (
    HostDataset as JHostDataset,
)
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models import (
    linear_regression as plr,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.data import DeviceDataset
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models.base import Shards

torch.set_num_threads(1)


def _data(n=3000, d=4, seed=0, weighted=False):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * np.array([1.0, 5.0, 0.3, 2.0])[:d]
         + np.array([3.0, -20.0, 0.5, 8.0])[:d]).astype(np.float32)
    y = (x @ np.array([1.5, -0.2, 4.0, 0.0])[:d] + 2.0 + rng.normal(0, 0.5, n)).astype(np.float32)
    w = rng.uniform(0.2, 2.0, n).astype(np.float32) if weighted else None
    return x, y, w


def _hospital_rows(n_per_hospital=80_000, seed=7):
    """The example generator's law (``examples/run_hospital_pipeline.py``):
    4 features, occupancy up to 400, LOS linear in them plus noise."""
    rng = np.random.default_rng(seed)
    n = 5 * n_per_hospital
    x = np.stack([rng.integers(0, 50, n), rng.integers(20, 400, n), rng.integers(0, 30, n),
                  rng.uniform(0.5, 1.5, n)], axis=1).astype(np.float64)
    y = x @ np.array([0.05, 0.008, 0.12, 2.0]) + rng.normal(0.0, 0.4, n)
    return x, y


def _inputs(x, y, w):
    return (x, y) if w is None else (x, y, w)


def _close(pm_coef, pm_int, jm_coef, jm_int):
    jc = np.asarray(jm_coef, np.float64)
    scale = max(float(np.abs(jc).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(pm_coef, np.float64), jc, atol=1e-4 * scale)
    np.testing.assert_allclose(float(pm_int), float(jm_int), atol=1e-4 * scale)


EN_CASES = [
    dict(reg_param=0.1, elastic_net_param=0.5),
    dict(reg_param=0.05, elastic_net_param=1.0),
    dict(reg_param=0.3, elastic_net_param=0.2, standardize=False),
    dict(reg_param=0.1, elastic_net_param=0.5, fit_intercept=False),
    dict(reg_param=0.1, elastic_net_param=0.5, max_iter=5),
    dict(reg_param=0.02, elastic_net_param=0.9, max_iter=17, tol=1e-5),
]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kw", EN_CASES)
def test_elastic_net_matches_reference(kw, weighted):
    x, y, w = _data(weighted=weighted)
    wv = np.ones(len(y), np.float32) if w is None else w
    est = dict(max_iter=100, tol=1e-6, fit_intercept=True, standardize=True)
    est.update({k: v for k, v in kw.items() if k in est})
    args = (float(kw["reg_param"]), float(kw["elastic_net_param"]), est["tol"],
            est["fit_intercept"], est["standardize"], est["max_iter"])
    jc, ji, jn = jlr._elastic_net_fit(x, y, wv, np.float32(args[0]), np.float32(args[1]),
                                      np.float32(args[2]), *args[3:])
    one = Shards(DeviceDataset(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(wv)))
    pc, pi, pn, syncs = plr._elastic_net_fit(one, *args)
    assert pn == int(jn)
    assert syncs == -(-max(pn, 1) // plr.FISTA_CHUNK) or pn == est["max_iter"]
    _close(pc.numpy(), pi, np.asarray(jc), ji)
    # the estimators end to end
    jm = J.LinearRegression(**kw).fit(_inputs(x, y, w))
    pm = P.LinearRegression(**kw).fit(_inputs(x, y, w), device="cpu")
    _close(pm.coefficients.numpy(), pm.intercept, jm.coefficients, jm.intercept)
    assert pm.fit_info["n_iter"] == pn


@pytest.mark.parametrize("kw", EN_CASES[:4])
def test_elastic_net_outofcore_matches_reference(kw):
    x, y, w = _data(n=2048, weighted=True)
    jm = J.LinearRegression(**kw).fit(JHostDataset(x=x, y=y, w=w, max_device_rows=512))
    pm = P.LinearRegression(**kw).fit(P.HostDataset(x=x, y=y, w=w, max_device_rows=512),
                                      device="cpu")
    _close(pm.coefficients.numpy(), pm.intercept, jm.coefficients, jm.intercept)
    # and the resident fit on the same rows
    rm = P.LinearRegression(**kw).fit((x, y, w), device="cpu")
    _close(pm.coefficients.numpy(), pm.intercept, rm.coefficients.numpy(), rm.intercept)
    assert pm.fit_info["n_iter"] > 0 and not pm.has_summary


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("fit_intercept", [True, False])
def test_summary_matches_reference(weighted, fit_intercept):
    x, y, w = _data(n=2000, weighted=weighted, seed=3)
    jm = J.LinearRegression(fit_intercept=fit_intercept).fit(_inputs(x, y, w))
    pm = P.LinearRegression(fit_intercept=fit_intercept).fit(_inputs(x, y, w), device="cpu")
    js, ps = jm.summary, pm.summary
    assert pm.has_summary
    for name in ("root_mean_squared_error", "mean_squared_error", "mean_absolute_error",
                 "r2", "r2adj", "weight_sum"):
        np.testing.assert_allclose(getattr(ps, name), getattr(js, name), rtol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(ps.explained_variance, js.explained_variance, rtol=1e-4)
    for name in ("num_instances", "degrees_of_freedom"):
        assert getattr(ps, name) == getattr(js, name), name
    np.testing.assert_allclose(ps.coefficient_standard_errors, js.coefficient_standard_errors,
                               rtol=1e-4)
    jt = np.asarray(js.t_values)
    np.testing.assert_allclose(ps.t_values, jt, rtol=1e-4, atol=1e-4 * np.abs(jt).max())
    # |Δp| ≤ max|dp/dt|·|Δt| = 2·max(Student t density)·|Δt| ≤ 0.8·|Δt|
    assert (np.abs(ps.p_values - js.p_values)
            <= 0.8 * np.abs(ps.t_values - jt) + 1e-12).all()
    # predictions of |y| up to about 40 from coefficients 1e-6 apart
    tol = 1e-5 * float(np.abs(y).max())
    np.testing.assert_allclose(ps.residuals, js.residuals, atol=tol)
    pr = ps.predictions.to_numpy()
    np.testing.assert_allclose(pr[0], np.asarray(js.predictions.prediction)[:len(y)], atol=tol)
    pm.release_summary()
    assert not pm.has_summary


def test_summary_on_padded_and_table_inputs():
    """A table input with a weight column: the pad-free residuals and the
    row count against the weight sum."""
    x, y, w = _data(n=500, weighted=True, seed=5)
    cols = {"a": x[:, 0], "b": x[:, 1], "y": y, "w": w}
    jt = J.VectorAssembler(["a", "b"]).transform(J.Table.from_dict(cols))
    pt_ = P.VectorAssembler(["a", "b"]).transform(P.Table.from_dict(cols))
    js = J.LinearRegression(label_col="y", weight_col="w").fit(jt).summary
    ps = P.LinearRegression(label_col="y", weight_col="w").fit(pt_, device="cpu").summary
    assert ps.num_instances == js.num_instances == 500
    np.testing.assert_allclose(ps.weight_sum, js.weight_sum, rtol=1e-6)
    np.testing.assert_allclose(ps.t_values, js.t_values, rtol=1e-4)
    assert ps.residuals.shape == js.residuals.shape == (500,)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_summary_inference_raises_like_reference(pkg):
    x, y, _ = _data(n=300)
    if pkg == "jax":
        m = J.LinearRegression(reg_param=0.1).fit((x, y))
    else:
        m = P.LinearRegression(reg_param=0.1).fit((x, y), device="cpu")
    assert np.isfinite(m.summary.r2)
    with pytest.raises(RuntimeError, match="unregularized"):
        m.summary.t_values
    # a collinear design (a duplicated column)
    xc = np.c_[x, x[:, :1]]
    if pkg == "jax":
        m = J.LinearRegression().fit((xc, y))
    else:
        m = P.LinearRegression().fit((xc, y), device="cpu")
    with pytest.raises(RuntimeError, match="collinear"):
        m.summary.coefficient_standard_errors


def test_summary_raises_on_loaded_model(tmp_path):
    x, y, _ = _data(n=300)
    pm = P.LinearRegression().fit((x, y), device="cpu")
    pm.save(str(tmp_path / "lr"))
    loaded = P.load_model(str(tmp_path / "lr"))
    assert not loaded.has_summary
    with pytest.raises(RuntimeError, match="no training summary"):
        loaded.summary
    # the reference's own message, word for word
    jl = J.load_model(str(tmp_path / "lr"))
    with pytest.raises(RuntimeError) as je:
        jl.summary
    with pytest.raises(RuntimeError) as pe:
        loaded.summary
    assert str(pe.value) == str(je.value)


def test_chunked_gram_equals_product():
    """The chunked sum is the same product: exact on integer rows, any
    chunk, padded or not."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-8, 8, (1000, 5)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-8, 8, (1000, 3)).astype(np.float32))
    for chunk in (1, 7, 256, 4096):
        assert torch.equal(plr.chunked_gram(a, b, chunk), a.T @ b)
        assert torch.equal(plr.chunked_gram(a, b[:, 0], chunk), a.T @ b[:, 0])


def test_resident_fit_holds_reference_accuracy_at_scale(mesh8):
    """400,000 hospital rows (occupancy up to 400): the port's resident
    fit lands within 3x the reference's own distance from the float64
    solution (one float32 pass over the rows landed 1.7e-3 of the largest
    coefficient off, the reference 6.3e-6)."""
    x, y = _hospital_rows()
    exact = np.linalg.lstsq(np.c_[x, np.ones(len(y))], y, rcond=None)[0]

    def err(m):
        c = np.r_[np.asarray(m.coefficients, np.float64), float(m.intercept)]
        return float(np.abs(c - exact).max())

    ref = err(J.LinearRegression().fit((x, y), mesh=mesh8))
    got = err(P.LinearRegression().fit((x, y), device="cpu"))
    assert got <= 3.0 * ref, (got, ref)
    # the summary's Gram is summed the same way: its standard errors hold
    # the float64 ones
    pm = P.LinearRegression().fit((x, y), device="cpu")
    xa = np.c_[x.astype(np.float32).astype(np.float64), np.ones(len(y))]
    inv = np.linalg.inv(xa.T @ xa)
    se64 = np.sqrt(np.diag(inv) * pm.summary.mean_squared_error * len(y)
                   / (len(y) - xa.shape[1]))
    np.testing.assert_allclose(pm.summary.coefficient_standard_errors, se64, rtol=1e-3)
