"""KMeans' and GaussianMixture's reduced-precision modes in the port
against the JAX package's same modes, on the CPU.

The same numpy rows go through the JAX estimators on their 8-device CPU
mesh and the port's (``device="cpu"``).  On the CPU both packages give
``"bf16"`` the same meaning: operands rounded to bfloat16, products and
sums in float32; ``"high"`` / ``"default"`` are float32 there (XLA on the
CPU, and the port off the card).

Tolerances, and why:
- KMeans ``n_iter`` and cluster sizes equal, centers within 1e-4 and the
  training cost at rtol 1e-5: the blobs leave no row within the bf16
  products' rounding of a tie, and the float32 sums of the two packages
  differ in order (per device and psum'd, or per chunk);
- GMM ``n_iter`` equal, the log-likelihood at rtol 1e-5, means and
  covariances within 1e-3 and weights within 1e-5.  The float32 modes
  ("high", "default" on the CPU) are compared over five EM iterations,
  bf16 over one: bf16 also rounds the (d, k·d) factor matrix, whose
  float32 entries differ in their last bits between the packages from the
  second iteration on (the moments' summation order); a rounding that
  flips moves an entry by 2^-8 of its value and EM feeds it back, so the
  weights sit 2.1e-5 apart after two iterations and the means 0.03 after
  five (measured here), while the first iteration agrees to 1.5e-8.
"""

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.models import (
    gmm as jgmm,
    kmeans as jkm,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.ops import distance as jdist
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models import (
    gmm as pgmm,
    kmeans as pkm,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import distance as pdist

torch.set_num_threads(1)


def _blobs(n=4000, d=3, k=6, seed=0, offset=0.0):
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 6, (k, d))
    return (c[rng.integers(0, k, n)] + rng.normal(size=(n, d)) + offset).astype(np.float32)


@pytest.mark.parametrize("precision", ["bf16", "high", "default", "highest"])
def test_matmul_p_matches_reference(precision):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(64, 9)).astype(np.float32)
    b = rng.normal(size=(9, 5)).astype(np.float32)
    got = pdist.matmul_p(torch.from_numpy(a), torch.from_numpy(b), precision).numpy()
    want = np.asarray(jdist.matmul_p(a, b, precision))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if precision == "bf16":
        a16 = torch.from_numpy(a).to(torch.bfloat16).to(torch.float32)
        b16 = torch.from_numpy(b).to(torch.bfloat16).to(torch.float32)
        np.testing.assert_allclose(got, (a16 @ b16).numpy(), rtol=1e-6, atol=1e-6)
    jprec = precision if precision == "bf16" else jax_precision(precision)
    d2 = pdist.pairwise_sqdist(torch.from_numpy(a), torch.from_numpy(b.T),
                               precision=precision).numpy()
    np.testing.assert_allclose(d2, np.asarray(jdist.pairwise_sqdist(a, b.T, precision=jprec)),
                               rtol=1e-5, atol=1e-5)


def jax_precision(name):
    from jax import lax

    return lax.Precision(name.lower())


def test_validate_matmul_precision():
    for ok in pdist.MATMUL_PRECISIONS:
        pdist.validate_matmul_precision(ok)
    assert pdist.MATMUL_PRECISIONS == jdist.MATMUL_PRECISIONS
    with pytest.raises(ValueError) as pe:
        pdist.validate_matmul_precision("fp8")
    with pytest.raises(ValueError) as je:
        jdist.validate_matmul_precision("fp8")
    assert str(pe.value) == str(je.value)


KM_CASES = [
    dict(matmul_precision="bf16"),
    dict(matmul_precision="bf16", fused_stats=True),
    dict(matmul_precision="high"),
    dict(matmul_precision="bf16", fused_stats=True, distance_measure="cosine"),
    dict(matmul_precision="bf16", chunk_rows=512),
]


@pytest.mark.parametrize("kw", KM_CASES)
def test_kmeans_reduced_precision_matches_reference(kw):
    x = _blobs()
    jm = J.KMeans(k=6, seed=0, max_iter=10, **kw).fit(x)
    pm = P.KMeans(k=6, seed=0, max_iter=10, **kw).fit(x, device="cpu")
    assert pm.n_iter == jm.n_iter
    np.testing.assert_array_equal(pm.cluster_sizes, np.asarray(jm.cluster_sizes))
    np.testing.assert_allclose(pm.cluster_centers, np.asarray(jm.cluster_centers), atol=1e-4)
    np.testing.assert_allclose(pm.training_cost, jm.training_cost, rtol=1e-5)


@pytest.mark.parametrize("kw", KM_CASES[:2])
def test_kmeans_reduced_precision_outofcore(kw):
    x = _blobs(n=2048)
    jm = J.KMeans(k=6, seed=0, max_iter=10, **kw).fit(
        J.HostDataset(x=x, max_device_rows=512))
    pm = P.KMeans(k=6, seed=0, max_iter=10, **kw).fit(
        P.HostDataset(x=x, max_device_rows=512), device="cpu")
    res = P.KMeans(k=6, seed=0, max_iter=10, **kw).fit(x, device="cpu")
    for other in (jm, res):
        assert pm.n_iter == other.n_iter
        np.testing.assert_array_equal(pm.cluster_sizes, np.asarray(other.cluster_sizes))
        np.testing.assert_allclose(pm.cluster_centers, np.asarray(other.cluster_centers),
                                   atol=1e-4)
        np.testing.assert_allclose(pm.training_cost, other.training_cost, rtol=1e-5)


def test_kmeans_lloyd_stats_reduced_matches_reference_step():
    """One Lloyd pass's (sums, counts, cost) against the reference's shard
    stats at the same precision (one device, chunks of 256 rows)."""
    x = _blobs(n=1024, d=4)
    w = np.ones(len(x), np.float32)
    rng = np.random.default_rng(2)
    cen = x[rng.choice(len(x), 8, replace=False)]
    c_valid = np.r_[np.ones(7), 0.0].astype(np.float32)
    import jax
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    for prec, fuse in (("bf16", False), ("bf16", True), ("high", False)):
        step = jkm._make_stats_step(mesh, len(x), 8, 4, 256, prec, fuse)
        js, jc, jcost = (np.asarray(v) for v in step(x, w, cen, c_valid))
        ps, pc, pcost = (v.numpy() for v in pkm.lloyd_stats_reduced(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(cen),
            torch.from_numpy(c_valid), prec, fuse, 256))
        np.testing.assert_array_equal(pc, jc)
        np.testing.assert_allclose(ps, js, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(pcost, jcost, rtol=1e-5)


def test_kmeans_precision_errors():
    x = _blobs(n=64)
    with pytest.raises(ValueError, match="matmul_precision"):
        P.KMeans(k=2, matmul_precision="fp8").fit(x, device="cpu")
    with pytest.raises(ValueError, match="fuse_stats"):
        P.KMeans(k=2, fused_stats=True).fit(x, device="cpu")
    with pytest.raises(ValueError, match="fuse_stats"):
        P.KMeans(k=2, matmul_precision="high", fused_stats=True).fit(x, device="cpu")
    # use_pallas is the reference's switch and changes nothing here
    a = P.KMeans(k=3, seed=0, use_pallas=True).fit(x, device="cpu")
    b = P.KMeans(k=3, seed=0).fit(x, device="cpu")
    np.testing.assert_array_equal(a.cluster_centers, b.cluster_centers)


@pytest.mark.parametrize("precision, max_iter", [("bf16", 1), ("high", 5), ("default", 5)])
def test_gmm_reduced_precision_matches_reference(precision, max_iter):
    x = _blobs(n=3000, d=3, k=4, offset=50.0)
    kw = dict(k=4, max_iter=max_iter, seed=0, matmul_precision=precision)
    jm = J.GaussianMixture(**kw).fit(x)
    pm = P.GaussianMixture(**kw).fit(x, device="cpu")
    assert pm.n_iter == jm.n_iter
    np.testing.assert_allclose(pm.log_likelihood, jm.log_likelihood, rtol=1e-5)
    np.testing.assert_allclose(pm.weights, np.asarray(jm.weights), atol=1e-5)
    np.testing.assert_allclose(pm.means, np.asarray(jm.means), atol=1e-3)
    np.testing.assert_allclose(pm.covariances, np.asarray(jm.covariances), atol=1e-3)


def test_gmm_reduced_precision_outofcore():
    x = _blobs(n=2048, d=3, k=4)
    kw = dict(k=4, max_iter=1, seed=0, matmul_precision="bf16")
    jm = J.GaussianMixture(**kw).fit(J.HostDataset(x=x, max_device_rows=512))
    pm = P.GaussianMixture(**kw).fit(P.HostDataset(x=x, max_device_rows=512), device="cpu")
    assert pm.n_iter == jm.n_iter
    np.testing.assert_allclose(pm.log_likelihood, jm.log_likelihood, rtol=1e-5)
    np.testing.assert_allclose(pm.means, np.asarray(jm.means), atol=1e-3)


def test_gmm_factor_form_log_pdf_matches_reference():
    """The factor-form densities against the reference's and against the
    per-component solves (float32, the same values up to rounding)."""
    rng = np.random.default_rng(5)
    k, d = 4, 3
    means = rng.normal(size=(k, d)).astype(np.float32)
    a = rng.normal(size=(k, d, d)).astype(np.float32)
    covs = (a @ a.transpose(0, 2, 1) + 0.5 * np.eye(d)).astype(np.float32)
    chols = np.linalg.cholesky(covs).astype(np.float32)
    xb = rng.normal(size=(200, d)).astype(np.float32)
    pw, po, pc = pgmm._pdf_factors(torch.from_numpy(means), torch.from_numpy(chols))
    jw, jo, jc = jgmm._pdf_factors(means, chols)
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-6)
    for prec in ("highest", "bf16"):
        got = pgmm._batched_log_pdf(torch.from_numpy(xb), pw, po, pc, prec).numpy()
        want = np.asarray(jgmm._batched_log_pdf(xb, jw, jo, jc, prec))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    solved = pgmm._log_pdf(torch.from_numpy(xb), torch.from_numpy(means),
                           torch.from_numpy(chols)).numpy()
    got = pgmm._batched_log_pdf(torch.from_numpy(xb), pw, po, pc).numpy()
    np.testing.assert_allclose(got, solved, rtol=1e-5, atol=1e-4)
