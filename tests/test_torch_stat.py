"""The port's ``stat`` (``pyspark.ml.stat``) and ``ops/reductions.py``
against the JAX package's, on the CPU, and against float64 numpy / scipy.

Tolerances, and why:
- Summarizer: the masked min / max, the count and the weight sum are
  equal (no arithmetic, or integer-valued float32 sums); means,
  variances, norms and the non-zero counts within 1e-6 relative of the
  JAX package (float32 column sums in another order) and within 1e-5 of
  float64 numpy;
- pearson Correlation within 1e-5 of the JAX package and of float64
  numpy among well-scaled columns; both packages form ``xtx/n −
  mean·meanᵀ`` from float32 sums, which cancels on a column whose mean
  dwarfs its spread, so each entry is held within 1e-5 + 4e-6·E|xi·xj| /
  (σi·σj) (4.3e-4 measured beside a column of mean 5 and std 0.01);
  ``chunked_gram`` sums the port's ``xtx`` per 4,096-row chunk; spearman
  (host float64 ranks) equal to the JAX package and to scipy within
  1e-12;
- Summarizer variances within 1e-6 of mean² + variance (the rounding of
  the raw second moment they are formed from);
- ChiSquareTest equal (the same host contingency tables);
- KS statistic within 1e-6 of the JAX package (``torch.special.ndtr``
  against XLA's normal CDF, a few ulps) and of scipy's ``kstest``;
- ANOVA and FValue F-values within 1e-5 relative of the JAX package and
  of scipy / float64 numpy (float32 sums of centred columns).
"""

import numpy as np
import pytest
import torch
from scipy import stats as sps

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.ops import reductions as jred
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import reductions as pred

torch.set_num_threads(1)

REL = 1e-6
CORR_TOL = 1e-5
F_RTOL = 1e-5


def _rows(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    x = np.c_[rng.normal(size=n), rng.poisson(3.0, n), rng.uniform(50, 400, n),
              rng.normal(size=n) * 0.01 + 5.0].astype(np.float32)
    x[rng.random(n) < 0.1, 0] = 0.0
    return x


@pytest.mark.parametrize("weighted", [False, True])
def test_moment_stats_match_jax(weighted):
    x = _rows()
    w = (np.random.default_rng(1).uniform(0, 2, len(x)) if weighted else np.ones(len(x)))
    w = w.astype(np.float32)
    w[::13] = 0.0
    got = pred.host_moments(torch.from_numpy(x), torch.from_numpy(w))
    want = jred.host_moments(x, w)
    assert set(got) == set(want)
    for k in ("min", "max", "count"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("n", "s1", "s2", "xtx", "l1", "nnz"):
        np.testing.assert_allclose(got[k], want[k], rtol=REL, err_msg=k)
    # the masked sentinel keeps an all-pad column finite
    pad = pred.host_moments(torch.from_numpy(x[:4]), torch.zeros(4))
    assert np.all(pad["min"] == np.float32(3.4e38)) and np.all(pad["max"] == -np.float32(3.4e38))


def test_summarizer_matches_jax_and_numpy():
    x = _rows()
    w = np.random.default_rng(2).uniform(0.1, 2, len(x)).astype(np.float32)
    ps = P.stat.Summarizer.summary((x, np.zeros(len(x)), w), device="cpu")
    js = J.stat.Summarizer.summary((x, np.zeros(len(x)), w))
    assert ps.count == js.count == len(x)
    for a in ("weight_sum", "mean", "norm_l1", "norm_l2", "num_non_zeros"):
        np.testing.assert_allclose(getattr(ps, a), getattr(js, a), rtol=REL, err_msg=a)
    # variance = Σw·x²/Σw − mean²: its error is the float32 rounding of the
    # raw second moment, so it is held relative to mean² + variance (column
    # 3, mean 5 and std 0.01, cancels to 2 % in both packages)
    raw = js.mean ** 2 + js.variance
    np.testing.assert_allclose(ps.variance, js.variance, rtol=0, atol=REL * raw.max())
    assert np.all(np.abs(ps.variance - js.variance) <= REL * raw)
    assert abs(ps.variance[3] - js.variance[3]) > 1e-3 * js.variance[3]   # the cancellation
    for a in ("min", "max"):
        np.testing.assert_array_equal(getattr(ps, a), getattr(js, a))
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    mean = (x64 * w64[:, None]).sum(0) / w64.sum()
    np.testing.assert_allclose(ps.mean, mean, rtol=1e-5)
    np.testing.assert_allclose(ps.norm_l1, (np.abs(x64) * w64[:, None]).sum(0), rtol=1e-5)


@pytest.mark.parametrize("method", ["pearson", "spearman"])
def test_correlation_matches_jax_and_numpy(method):
    x = _rows(seed=3)
    x[:, 1] = x[:, 0] * 2 + x[:, 1]       # a correlated pair
    got = P.stat.Correlation.corr(x, method, device="cpu")
    want = J.stat.Correlation.corr(x, method)
    ref = (np.corrcoef(x.astype(np.float64), rowvar=False) if method == "pearson"
           else sps.spearmanr(x.astype(np.float64)).statistic)
    if method == "pearson":
        # cov = xtx/n − mean·meanᵀ in float32 sums: the error of r_ij is the
        # float32 rounding of Σ xi·xj, so it scales with E|xi·xj| / (σi·σj),
        # 360 to 1.1e3 for column 3 (mean 5, std 0.01): up to 4.3e-4 there,
        # in both packages (ROADMAP queue 3)
        a = np.abs(x.astype(np.float64))
        sd = x.std(0).astype(np.float64)
        tol = CORR_TOL + 4e-6 * (a.T @ a / len(x)) / np.outer(sd, sd)
        assert np.all(np.abs(got - want) <= tol)
        assert np.all(np.abs(got - ref) <= tol)
        assert np.abs(got - want)[:3, :3].max() <= CORR_TOL
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, ref, atol=1e-12)


def test_correlation_constant_column_and_checks():
    x = _rows(n=50)
    x[:, 2] = 7.0
    r = P.stat.Correlation.corr(x, device="cpu")
    assert np.isnan(r[2, 0]) and r[2, 2] == 1.0
    with pytest.raises(ValueError, match="pearson\\|spearman"):
        P.stat.Correlation.corr(x, "kendall", device="cpu")
    ds = P.device_dataset(x, weights=np.full(50, 0.5), device="cpu")
    with pytest.raises(ValueError, match="fractional sample weights"):
        P.stat.Correlation.corr(ds, "spearman", device="cpu")


def test_chi_square_matches_jax_and_scipy():
    rng = np.random.default_rng(4)
    x = np.c_[rng.integers(0, 4, 600), rng.integers(0, 3, 600)].astype(np.float32)
    y = ((x[:, 0] > 1) ^ (rng.random(600) < 0.2)).astype(np.float32)
    got = P.stat.ChiSquareTest.test(x, y, device="cpu")
    want = J.stat.ChiSquareTest.test(x, y)
    for a in ("p_values", "degrees_of_freedom", "statistics"):
        np.testing.assert_array_equal(getattr(got, a), getattr(want, a))
    table = np.zeros((4, 2))
    np.add.at(table, (x[:, 0].astype(int), y.astype(int)), 1)
    ref = sps.chi2_contingency(table, correction=False)
    assert abs(got.statistics[0] - ref.statistic) <= 1e-9 * ref.statistic
    with pytest.raises(ValueError, match="labels rows"):
        P.stat.ChiSquareTest.test(x, y[:-1], device="cpu")
    ds = P.device_dataset(x, device="cpu")
    np.testing.assert_array_equal(P.stat.ChiSquareTest.test(ds, y, device="cpu").statistics,
                                  got.statistics)


@pytest.mark.parametrize("mean,std", [(0.0, 1.0), (0.3, 2.0)])
def test_ks_matches_jax_and_scipy(mean, std):
    v = np.random.default_rng(5).normal(0.2, 1.5, 700).astype(np.float32)
    got = P.stat.KolmogorovSmirnovTest.test(v[:, None], "norm", mean, std, device="cpu")
    want = J.stat.KolmogorovSmirnovTest.test(v[:, None], "norm", mean, std)
    ref = sps.kstest(v.astype(np.float64), "norm", args=(mean, std))
    assert abs(got.statistic - want.statistic) <= 1e-6
    assert abs(got.statistic - ref.statistic) <= 1e-6
    assert abs(got.p_value - want.p_value) <= 1e-5
    with pytest.raises(ValueError, match="single-column"):
        P.stat.KolmogorovSmirnovTest.test(_rows(n=10), device="cpu")
    with pytest.raises(ValueError, match="'norm'"):
        P.stat.KolmogorovSmirnovTest.test(v[:, None], "expon", device="cpu")
    with pytest.raises(ValueError, match="std must be positive"):
        P.stat.KolmogorovSmirnovTest.test(v[:, None], std=0.0, device="cpu")


def test_anova_matches_jax_and_scipy():
    rng = np.random.default_rng(6)
    y = rng.integers(0, 3, 900).astype(np.float32)
    x = np.c_[rng.normal(size=900) + y * 0.3, rng.uniform(1000, 1001, 900) + y * 0.01,
              rng.normal(size=900)].astype(np.float32)
    got = P.stat.ANOVATest.test(x, y, device="cpu")
    want = J.stat.ANOVATest.test(x, y)
    np.testing.assert_allclose(got.f_values, want.f_values, rtol=F_RTOL)
    np.testing.assert_allclose(got.p_values, want.p_values, rtol=1e-4, atol=1e-12)
    np.testing.assert_array_equal(got.degrees_of_freedom, want.degrees_of_freedom)
    ref = [sps.f_oneway(*[x[y == c, j].astype(np.float64) for c in range(3)]).statistic
           for j in range(3)]
    np.testing.assert_allclose(got.f_values, ref, rtol=F_RTOL)
    with pytest.raises(ValueError, match="at least 2 label classes"):
        P.stat.ANOVATest.test(x, np.zeros(900), device="cpu")
    with pytest.raises(ValueError, match="valid feature rows extend"):
        P.stat.ANOVATest.test(x, y[:10], device="cpu")


def test_fvalue_matches_jax_and_numpy():
    rng = np.random.default_rng(7)
    x = np.c_[rng.normal(size=800), rng.uniform(100, 101, 800),
              rng.normal(size=800)].astype(np.float32)
    y = (x[:, 0] * 0.5 + (x[:, 1] - 100) * 0.2 + rng.normal(size=800)).astype(np.float32)
    got = P.stat.FValueTest.test(x, y, device="cpu")
    want = J.stat.FValueTest.test(x, y)
    np.testing.assert_allclose(got.f_values, want.f_values, rtol=F_RTOL)
    np.testing.assert_allclose(got.p_values, want.p_values, rtol=1e-4, atol=1e-12)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    r = np.array([np.corrcoef(x64[:, j], y64)[0, 1] for j in range(3)])
    np.testing.assert_allclose(got.f_values, r * r / (1 - r * r) * (800 - 2), rtol=F_RTOL)
    with pytest.raises(ValueError, match="exceed the padded row count"):
        P.stat.FValueTest.test(x[:5], y, device="cpu")
