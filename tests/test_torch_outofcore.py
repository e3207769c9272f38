"""The port's out-of-core fits against the JAX package's, on the CPU.

The same numpy-seeded rows go through the JAX package's ``HostDataset``
fits (its 8-device CPU mesh, ``max_device_rows`` a multiple of 8 so both
packages cut the same blocks) and the port's (``device="cpu"``, each
block's statistics from the kernels' plain versions).

Tolerances, and why:
- bit-equal where every float32 sum is exact in any order: KMeans centers
  and sizes on integer-valued rows (sums far below 2**24), tree splits on
  integer-valued labels with 0/1 or Poisson weights, and the per-block
  Poisson draws (the same threefry bits);
- KMeans ``training_cost`` at rtol 1e-5: a float32 sum of the rows'
  x² − 2x·c + c², which the two packages reduce in other orders (as in
  ``test_torch_kmeans.py``);
- float-valued KMeans centers at rtol 1e-5 / atol 1e-5 and cosine
  centers at atol 1e-5: float32 sums in another order (per device and
  psum'd in JAX, in one order per block here), and the unit rows' norms
  summed in another order;
- LinearRegression: the port's coefficients and intercept within
  max(1e-4, κ·2⁻²³) of the largest coefficient from the float64 solution
  of the same system (κ the condition number of its standardized Gram):
  float32 normal equations carry a forward error of about κ·u (1e-4 is
  the port's resident tolerance, ROADMAP queue 3); without an intercept
  the features are not recentered, and on rows offset by 30 (κ ≈ 5e3)
  both packages land up to 8e-4 off the float64 solution;
- GaussianMixture as in ``test_torch_gmm.py``: log-likelihood rtol 1e-5,
  means and covariances atol 1e-4, weights atol 1e-6 (float32 EM sums
  in another order, the solves and ``logsumexp`` rounding apart).  A
  warm-started GMM runs unshifted (the reference's design), so its test
  rows sit near 0, where the float32 covariance refit does not cancel.
"""

import jax
import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.models.tree import (
    engine as jeng,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.parallel.outofcore import (
    HostDataset as JHostDataset,
)
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models.tree import (
    engine as peng,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.parallel import (
    outofcore as pooc,
)

# the suite runs several worker processes on a few cores: one intra-op
# thread per worker keeps torch from oversubscribing them
torch.set_num_threads(1)


def _int_blobs(n, d, k, seed=0, spread=3):
    """Integer-valued clustered rows: every Lloyd statistic is exact in
    float32, so any summation order gives the same bits."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-40, 40, size=(k, d))
    x = centers[rng.integers(0, k, size=n)] + rng.integers(-spread, spread + 1, size=(n, d))
    return x.astype(np.float32)


def _both(x, y=None, w=None, mdr=512):
    return (P.HostDataset(x=x, y=y, w=w, max_device_rows=mdr),
            JHostDataset(x=x, y=y, w=w, max_device_rows=mdr))


@pytest.fixture
def block_count(monkeypatch):
    """Counts the blocks ``HostDataset.blocks`` yields (the streamed path
    was taken, one pass per epoch)."""
    seen = {"blocks": 0, "passes": 0}
    orig = pooc.HostDataset.blocks

    def counting(self, *a, **k):
        seen["passes"] += 1
        for blk in orig(self, *a, **k):
            seen["blocks"] += 1
            yield blk

    monkeypatch.setattr(pooc.HostDataset, "blocks", counting)
    return seen


# ------------------------------------------------------------ HostDataset
@pytest.mark.parametrize("n, mdr", [(1000, 256), (1024, 128), (4096, 512), (40, 64),
                                    (8, 8)])
def test_blocks_are_the_jax_packages_blocks(n, mdr, mesh8):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 3))                     # float64: numpy casts
    y = rng.integers(0, 5, size=n)                  # int labels: numpy casts
    w = rng.uniform(0.5, 2.0, size=n)
    ph, jh = _both(x, y, w, mdr)
    assert ph.block_shape() == jh.block_shape(mesh8)
    pbs = list(ph.blocks(device="cpu"))
    jbs = list(jh.blocks(mesh8))
    assert len(pbs) == len(jbs) == ph.block_shape()[0]
    for pb, jb in zip(pbs, jbs):
        assert pb.x.dtype == torch.float32 and pb.w.dtype == torch.float32
        np.testing.assert_array_equal(pb.x.numpy(), np.asarray(jb.x))
        np.testing.assert_array_equal(pb.y.numpy(), np.asarray(jb.y))
        np.testing.assert_array_equal(pb.w.numpy(), np.asarray(jb.w))


def test_last_block_is_zero_padded_with_zero_weight():
    x = np.arange(30, dtype=np.float32).reshape(10, 3) + 1
    hd = P.HostDataset(x=x, y=np.ones(10), max_device_rows=4)
    assert hd.block_shape() == (3, 4)
    last = list(hd.blocks(device="cpu"))[-1]
    np.testing.assert_array_equal(last.x[2:].numpy(), 0)
    np.testing.assert_array_equal(last.w.numpy(), [1, 1, 0, 0])
    np.testing.assert_array_equal(last.y.numpy(), [1, 1, 0, 0])


def test_weights_labels_and_counts_stream_through():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(100, 3)).astype(np.float32)
    y = rng.normal(size=100).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=100).astype(np.float32)
    hd = P.HostDataset(x=x, y=y, w=w, max_device_rows=32)
    ys, ws, xs = [], [], []
    for blk in hd.blocks(device="cpu"):
        keep = blk.w.numpy() > 0
        ys.append(blk.y.numpy()[keep])
        ws.append(blk.w.numpy()[keep])
        xs.append(blk.x.numpy()[keep])
    np.testing.assert_array_equal(np.concatenate(xs), x)
    np.testing.assert_array_equal(np.concatenate(ys), y)
    np.testing.assert_array_equal(np.concatenate(ws), w)
    assert hd.count() == pytest.approx(float(w.sum()))
    unweighted = P.HostDataset(x=x, max_device_rows=32)
    assert unweighted.count() == 100.0
    assert sum(float(b.w.sum()) for b in unweighted.blocks(device="cpu")) == 100.0
    assert all(not b.y.any() for b in unweighted.blocks(device="cpu"))


def test_order_reorders_the_stream():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    hd = P.HostDataset(x=x, max_device_rows=2)
    firsts = [float(b.x[0, 0]) for b in hd.blocks(device="cpu", order=[2, 0, 1])]
    assert firsts == [8.0, 0.0, 4.0]


def test_empty_dataset_yields_no_blocks(mesh8):
    ph, jh = _both(np.empty((0, 4), np.float32))
    assert list(ph.blocks(device="cpu")) == [] == list(jh.blocks(mesh8))
    assert ph.block_shape()[0] == 0 == jh.block_shape(mesh8)[0]
    assert ph.sample_rows(10, 0).shape == (0, 4)


@pytest.mark.parametrize("kw", [
    dict(x=np.ones((10,), np.float32)),
    dict(x=np.ones((10, 2), np.float32), y=np.ones(5)),
    dict(x=np.ones((10, 2), np.float32), w=np.ones(3)),
    dict(x=np.ones((10, 2), np.float32), w=-np.ones(10)),
    dict(x=np.ones((10, 2), np.float32), max_device_rows=0),
])
def test_validation_matches_the_jax_package(kw):
    with pytest.raises(ValueError) as pe:
        P.HostDataset(**kw)
    with pytest.raises(ValueError) as je:
        JHostDataset(**kw)
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("w", [None, "half-zero"])
@pytest.mark.parametrize("size", [50, 10_000])
def test_sample_rows_is_the_jax_packages_sample(size, w):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(600, 4))
    wv = None if w is None else (np.arange(600) % 2).astype(np.float32)
    ph, jh = _both(x, w=wv)
    np.testing.assert_array_equal(ph.sample_rows(size, 7), jh.sample_rows(size, 7))


def test_memmap_streams_the_same_blocks(tmp_path):
    x = _int_blobs(2000, 4, k=3, seed=2)
    np.save(tmp_path / "rows.npy", x)
    xm = np.load(tmp_path / "rows.npy", mmap_mode="r")
    a = list(P.HostDataset(x=xm, max_device_rows=256).blocks(device="cpu"))
    b = list(P.HostDataset(x=x, max_device_rows=256).blocks(device="cpu"))
    assert len(a) == len(b) == 8
    for u, v in zip(a, b):
        assert torch.equal(u.x, v.x) and torch.equal(u.w, v.w)


def test_add_stats_adds_tuples_elementwise():
    a = (torch.ones(2), torch.tensor(3.0))
    b = (torch.full((2,), 2.0), torch.tensor(4.0))
    s = P.parallel.add_stats(a, b)
    assert torch.equal(s[0], torch.full((2,), 3.0)) and float(s[1]) == 7.0


# ------------------------------------------------------------------ KMeans
@pytest.mark.parametrize("n, d, k, mdr, seed", [(4096, 4, 5, 512, 3), (3000, 3, 8, 256, 0),
                                                 (2048, 8, 16, 1024, 1)])
def test_kmeans_bit_equal_to_jax_outofcore_on_exact_data(n, d, k, mdr, seed, mesh8,
                                                         block_count):
    x = _int_blobs(n, d, k, seed=seed)
    ph, jh = _both(x, mdr=mdr)
    jm = J.KMeans(k=k, max_iter=8, seed=seed).fit(jh, mesh=mesh8)
    pm = P.KMeans(k=k, max_iter=8, seed=seed).fit(ph, device="cpu")
    np.testing.assert_array_equal(pm.cluster_centers, np.asarray(jm.cluster_centers))
    np.testing.assert_array_equal(pm.cluster_sizes, np.asarray(jm.cluster_sizes))
    assert pm.n_iter == jm.n_iter
    np.testing.assert_allclose(pm.training_cost, jm.training_cost, rtol=1e-5)
    # streamed, not made resident: every Lloyd step and the final pass
    # read each block once
    n_blocks = ph.block_shape()[0]
    assert block_count["passes"] == pm.n_iter + 1
    assert block_count["blocks"] == (pm.n_iter + 1) * n_blocks
    # and the resident fit agrees bit for bit (exact sums)
    res = P.KMeans(k=k, max_iter=8, seed=seed).fit(x, device="cpu")
    np.testing.assert_array_equal(res.cluster_centers, pm.cluster_centers)


def test_kmeans_float_data_close_to_jax(mesh8):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3000, 6)) + 5 * rng.integers(0, 4, size=(3000, 1))).astype(np.float32)
    ph, jh = _both(x, mdr=640)
    jm = J.KMeans(k=4, max_iter=10, seed=0).fit(jh, mesh=mesh8)
    pm = P.KMeans(k=4, max_iter=10, seed=0).fit(ph, device="cpu")
    assert pm.n_iter == jm.n_iter
    np.testing.assert_array_equal(pm.cluster_sizes, np.asarray(jm.cluster_sizes))
    np.testing.assert_allclose(pm.cluster_centers, np.asarray(jm.cluster_centers),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pm.training_cost, jm.training_cost, rtol=1e-5)


@pytest.mark.parametrize("outofcore", [True, False])
def test_kmeans_cosine_matches_jax(outofcore, mesh8):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1024, 5)).astype(np.float32)
    ph, jh = _both(x, mdr=256)
    est = dict(k=3, max_iter=6, seed=1, distance_measure="cosine")
    if outofcore:
        jm = J.KMeans(**est).fit(jh, mesh=mesh8)
        pm = P.KMeans(**est).fit(ph, device="cpu")
    else:
        jm = J.KMeans(**est).fit(x, mesh=mesh8)
        pm = P.KMeans(**est).fit(x, device="cpu")
    assert pm.distance_measure == "cosine" and pm.n_iter == jm.n_iter
    np.testing.assert_allclose(pm.cluster_centers, np.asarray(jm.cluster_centers), atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(pm.cluster_centers, axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(pm.training_cost, jm.training_cost, rtol=1e-5)
    np.testing.assert_array_equal(pm.predict_numpy(x, device="cpu"),
                                  np.asarray(jm.predict(jax.numpy.asarray(x))))
    np.testing.assert_allclose(pm.compute_cost(x, device="cpu"), jm.compute_cost(x),
                               rtol=1e-5)


def test_kmeans_weighted_rows_bit_equal(mesh8):
    x = _int_blobs(2048, 3, k=3, seed=1)
    w = np.random.default_rng(0).integers(0, 4, size=2048).astype(np.float32)
    ph, jh = _both(x, w=w, mdr=304)
    jm = J.KMeans(k=3, max_iter=5, seed=0).fit(jh, mesh=mesh8)
    pm = P.KMeans(k=3, max_iter=5, seed=0).fit(ph, device="cpu")
    np.testing.assert_array_equal(pm.cluster_centers, np.asarray(jm.cluster_centers))
    np.testing.assert_array_equal(pm.cluster_sizes, np.asarray(jm.cluster_sizes))
    # weight_col on the resident path: the table's column, as the JAX
    # package resolves it
    cols = {f"f{j}": x[:, j] for j in range(3)}
    jt = J.VectorAssembler(list(cols)).transform(J.Table.from_dict({**cols, "w": w}))
    pt = P.VectorAssembler(list(cols)).transform(P.Table.from_dict({**cols, "w": w}))
    jr = J.KMeans(k=3, max_iter=5, seed=0, weight_col="w").fit(jt, mesh=mesh8)
    pr = P.KMeans(k=3, max_iter=5, seed=0, weight_col="w").fit(pt, device="cpu")
    np.testing.assert_array_equal(pr.cluster_centers, np.asarray(jr.cluster_centers))
    np.testing.assert_array_equal(pr.cluster_centers, pm.cluster_centers)


@pytest.mark.parametrize("outofcore", [True, False])
def test_kmeans_on_iteration_reports_the_jax_trajectory(outofcore, mesh8):
    x = _int_blobs(1024, 2, k=4, seed=5, spread=9)
    ph, jh = _both(x, mdr=128)
    js, ps = [], []
    J.KMeans(k=4, max_iter=6, seed=0).fit(jh if outofcore else x, mesh=mesh8,
                                          on_iteration=lambda *a: js.append(a))
    P.KMeans(k=4, max_iter=6, seed=0).fit(ph if outofcore else x, device="cpu",
                                          on_iteration=lambda *a: ps.append(a))
    assert [a[0] for a in ps] == [a[0] for a in js] and ps[0][0] == 1
    # d=2: each move is one float32 add of exact-sum centers, so bit-equal
    assert [a[2] for a in ps] == [a[2] for a in js]
    np.testing.assert_allclose([a[1] for a in ps], [a[1] for a in js], rtol=1e-5)


@pytest.mark.parametrize("outofcore", [True, False])
@pytest.mark.parametrize("measure", ["euclidean", "cosine"])
def test_kmeans_warm_start_matches_jax(measure, outofcore, mesh8):
    x = _int_blobs(1536, 3, k=4, seed=6)
    warm = x[[0, 400, 800, 1200]] + 0.5
    ph, jh = _both(x, mdr=512)
    est = dict(k=4, max_iter=4, seed=0, distance_measure=measure, warm_start_centers=warm)
    jm = J.KMeans(**est).fit(jh if outofcore else x, mesh=mesh8)
    pm = P.KMeans(**est).fit(ph if outofcore else x, device="cpu")
    assert pm.n_iter == jm.n_iter
    if measure == "euclidean":
        np.testing.assert_array_equal(pm.cluster_centers, np.asarray(jm.cluster_centers))
    else:
        np.testing.assert_allclose(pm.cluster_centers, np.asarray(jm.cluster_centers),
                                   atol=1e-5)
    with pytest.raises(ValueError, match="warm_start_centers"):
        P.KMeans(k=3, warm_start_centers=warm).fit(ph, device="cpu")


def test_kmeans_stopping_rule_follows_each_reference_loop(mesh8):
    """A ``move`` placed between float32(tol²) and tol² (in float64): the
    reference's device loop (resident, no hook) stops there, its host loop
    (out of core, or with on_iteration) goes on; the port does each."""
    x = _int_blobs(1024, 2, k=4, seed=5, spread=9)
    moves = []
    P.KMeans(k=4, max_iter=8, seed=0, tol=0.0).fit(
        x, device="cpu", on_iteration=lambda it, c, m: moves.append(m))
    j = 1                                            # stop after step 2
    m = moves[j]
    assert m > 0 and moves[j + 1] < m
    tol = float(np.sqrt(m) * (1 - 1e-12))            # tol² just under m
    assert tol * tol < m <= float(np.float32(tol * tol))
    ph, jh = _both(x, mdr=128)
    runs = {
        "resident": (J.KMeans(k=4, max_iter=8, seed=0, tol=tol).fit(x, mesh=mesh8),
                     P.KMeans(k=4, max_iter=8, seed=0, tol=tol).fit(x, device="cpu")),
        "outofcore": (J.KMeans(k=4, max_iter=8, seed=0, tol=tol).fit(jh, mesh=mesh8),
                      P.KMeans(k=4, max_iter=8, seed=0, tol=tol).fit(ph, device="cpu")),
        "hooked": (J.KMeans(k=4, max_iter=8, seed=0, tol=tol).fit(
                       x, mesh=mesh8, on_iteration=lambda *a: None),
                   P.KMeans(k=4, max_iter=8, seed=0, tol=tol).fit(
                       x, device="cpu", on_iteration=lambda *a: None)),
    }
    for name, (jm, pm) in runs.items():
        assert pm.n_iter == jm.n_iter, name
        np.testing.assert_array_equal(pm.cluster_centers, np.asarray(jm.cluster_centers))
    assert runs["resident"][1].n_iter == j + 1
    assert runs["outofcore"][1].n_iter > j + 1 and runs["hooked"][1].n_iter > j + 1


def test_kmeans_memmap_input(tmp_path, mesh8):
    x = _int_blobs(2000, 4, k=3, seed=2)
    np.save(tmp_path / "rows.npy", x)
    xm = np.load(tmp_path / "rows.npy", mmap_mode="r")
    jm = J.KMeans(k=3, max_iter=5, seed=0).fit(JHostDataset(x=xm, max_device_rows=256),
                                               mesh=mesh8)
    pm = P.KMeans(k=3, max_iter=5, seed=0).fit(P.HostDataset(x=xm, max_device_rows=256),
                                               device="cpu")
    np.testing.assert_array_equal(pm.cluster_centers, np.asarray(jm.cluster_centers))


def test_kmeans_empty_and_unknown_measure_raise():
    with pytest.raises(ValueError, match="empty"):
        P.KMeans(k=2).fit(P.HostDataset(x=np.zeros((0, 3), np.float32)), device="cpu")
    with pytest.raises(ValueError, match="empty"):
        P.KMeans(k=2, warm_start_centers=np.zeros((2, 3))).fit(
            P.HostDataset(x=np.zeros((0, 3), np.float32)), device="cpu")
    with pytest.raises(ValueError, match="distance_measure"):
        P.KMeans(k=2, distance_measure="manhattan").fit(np.zeros((4, 3)), device="cpu")


# -------------------------------------------------------- LinearRegression
def _lr_data(n=5000, d=6, seed=0, offset=0.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) + offset).astype(np.float32)
    y = (x @ rng.normal(size=d) + 2.5 + rng.normal(0, 0.1, size=n)).astype(np.float32)
    return x, y


def _lr_float64(x, y, w, reg_param=0.0, fit_intercept=True, standardize=True):
    """The out-of-core solve in float64: (coef, intercept)."""
    x, y, w = (np.asarray(a, np.float64) for a in (x, y, w))
    n = max(w.sum(), 1.0)
    mean = (x * w[:, None]).sum(0) / n
    var = (x * x * w[:, None]).sum(0) / n - mean * mean
    std = np.where(var > 1e-12, np.sqrt(np.maximum(var, 1e-12)), 1.0)
    scale = std if standardize else np.ones_like(std)
    ybar = (y * w).sum() / n
    xc, yc = (x - mean, y - ybar) if fit_intercept else (x, y)
    g = (xc * w[:, None]).T @ xc / n / np.outer(scale, scale) + reg_param * np.eye(len(mean))
    c = (xc * w[:, None]).T @ yc / n / scale
    coef = np.linalg.solve(g, c) / scale
    return coef, (ybar - mean @ coef if fit_intercept else 0.0), float(np.linalg.cond(g))


def _assert_lr_close(pm, jm, ref):
    coef, icpt, cond = ref
    tol = max(1e-4, cond * 2.0 ** -23) * max(float(np.abs(coef).max()), 1.0)
    for got, want, exact in ((pm.coefficients.numpy(), np.asarray(jm.coefficients), coef),
                             (float(pm.intercept), float(jm.intercept), icpt)):
        np.testing.assert_allclose(got, exact, rtol=0, atol=tol)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * tol)


@pytest.mark.parametrize("kw", [dict(), dict(fit_intercept=False), dict(reg_param=0.3),
                                dict(reg_param=0.3, standardize=False)])
@pytest.mark.parametrize("offset", [0.0, 30.0])
def test_linear_regression_outofcore_matches_jax(kw, offset, mesh8, block_count):
    x, y = _lr_data(offset=offset)
    w = np.random.default_rng(1).uniform(0.5, 2.0, size=len(y)).astype(np.float32)
    ph, jh = _both(x, y, w, mdr=1024)
    jm = J.LinearRegression(**kw).fit(jh, mesh=mesh8)
    pm = P.LinearRegression(**kw).fit(ph, device="cpu")
    _assert_lr_close(pm, jm, _lr_float64(x, y, w, **kw))
    assert block_count["passes"] == 1 and block_count["blocks"] == ph.block_shape()[0]


def test_linear_regression_outofcore_edge_cases(mesh8):
    x, y = _lr_data(n=64, d=3)
    ph, jh = _both(x, y, np.zeros(64, np.float32), mdr=32)
    pm = P.LinearRegression().fit(ph, device="cpu")
    jm = J.LinearRegression().fit(jh, mesh=mesh8)
    assert np.isfinite(pm.coefficients.numpy()).all() and np.isfinite(float(pm.intercept))
    _assert_lr_close(pm, jm, (np.zeros(3), 0.0, 1.0))
    with pytest.raises(ValueError, match="labels"):
        P.LinearRegression().fit(P.HostDataset(x=x), device="cpu")
    with pytest.raises(ValueError, match="empty"):
        P.LinearRegression().fit(P.HostDataset(x=x[:0], y=y[:0]), device="cpu")
    # the elastic net out of core (slice 3e) on all-zero weights: finite
    # zero coefficients, as the reference's
    en = P.LinearRegression(reg_param=0.1, elastic_net_param=0.5).fit(ph, device="cpu")
    jen = J.LinearRegression(reg_param=0.1, elastic_net_param=0.5).fit(jh, mesh=mesh8)
    _assert_lr_close(en, jen, (np.zeros(3), 0.0, 1.0))
    # no training summary out of core (it would pin the rows on the
    # device), the reference's RuntimeError
    with pytest.raises(RuntimeError, match="summary"):
        pm.summary


# ---------------------------------------------------------- GaussianMixture
def _gmm_blobs(n=4000, k=4, d=3, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 5, (k, d))
    return (c[rng.integers(0, k, n)] + rng.normal(size=(n, d)) + 50.0).astype(np.float32)


def _assert_gmm_close(pm, jm):
    assert pm.n_iter == jm.n_iter
    np.testing.assert_allclose(pm.log_likelihood, jm.log_likelihood, rtol=1e-5)
    np.testing.assert_allclose(pm.means, np.asarray(jm.means), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(pm.covariances, np.asarray(jm.covariances), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(pm.weights, np.asarray(jm.weights), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_gmm_outofcore_matches_jax(weighted, mesh8, block_count):
    x = _gmm_blobs()
    w = (np.random.default_rng(2).integers(0, 3, size=len(x)).astype(np.float32)
         if weighted else None)
    ph, jh = _both(x, w=w, mdr=1024)
    jm = J.GaussianMixture(k=4, max_iter=5, seed=0).fit(jh, mesh=mesh8)
    pm = P.GaussianMixture(k=4, max_iter=5, seed=0).fit(ph, device="cpu")
    _assert_gmm_close(pm, jm)
    assert block_count["passes"] == pm.n_iter
    assert block_count["blocks"] == pm.n_iter * ph.block_shape()[0]


def test_gmm_warm_start_and_weight_col_match_jax(mesh8):
    x = _gmm_blobs(n=2000) - 50.0
    jm0 = J.GaussianMixture(k=4, max_iter=3, seed=0).fit(x, mesh=mesh8)
    warm = (np.asarray(jm0.weights), np.asarray(jm0.means), np.asarray(jm0.covariances))
    ph, jh = _both(x, mdr=512)
    for pdata, jdata in ((ph, jh), (x, x)):
        jm = J.GaussianMixture(k=4, max_iter=3, warm_start_params=warm).fit(jdata, mesh=mesh8)
        pm = P.GaussianMixture(k=4, max_iter=3, warm_start_params=warm).fit(pdata,
                                                                            device="cpu")
        _assert_gmm_close(pm, jm)
    w = np.random.default_rng(3).integers(0, 3, size=len(x)).astype(np.float32)
    cols = {f"f{j}": x[:, j] for j in range(3)}
    jt = J.VectorAssembler(list(cols)).transform(J.Table.from_dict({**cols, "w": w}))
    pt = P.VectorAssembler(list(cols)).transform(P.Table.from_dict({**cols, "w": w}))
    _assert_gmm_close(
        P.GaussianMixture(k=4, max_iter=3, weight_col="w").fit(pt, device="cpu"),
        J.GaussianMixture(k=4, max_iter=3, weight_col="w").fit(jt, mesh=mesh8))
    with pytest.raises(ValueError, match="warm_start_params"):
        P.GaussianMixture(k=3, warm_start_params=warm).fit(x, device="cpu")


def test_gmm_outofcore_on_iteration_and_empty(mesh8):
    x = _gmm_blobs(n=1200)
    ph, jh = _both(x, mdr=256)
    js, ps = [], []
    J.GaussianMixture(k=4, max_iter=4, tol=0.0).fit(jh, mesh=mesh8,
                                                    on_iteration=lambda *a: js.append(a))
    P.GaussianMixture(k=4, max_iter=4, tol=0.0).fit(ph, device="cpu",
                                                    on_iteration=lambda *a: ps.append(a))
    assert [a[0] for a in ps] == [a[0] for a in js] == [1, 2, 3, 4]
    np.testing.assert_allclose([a[1] for a in ps], [a[1] for a in js], rtol=1e-5)
    with pytest.raises(ValueError, match="empty"):
        P.GaussianMixture(k=2).fit(P.HostDataset(x=x, w=np.zeros(len(x))), device="cpu")


# -------------------------------------------------------------------- trees
def _int_reg(n=4096, d=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 24, size=(n, d)).astype(np.float32)
    y = (x @ rng.integers(1, 4, size=d)).astype(np.float32) % 23
    return x, y


def _assert_same_forest(pf, jf):
    for a in ("split_feat", "split_bin", "threshold"):
        np.testing.assert_array_equal(getattr(pf, a), np.asarray(getattr(jf, a)))
    np.testing.assert_allclose(pf.value, np.asarray(jf.value), rtol=1e-6)
    np.testing.assert_allclose(pf.importances, np.asarray(jf.importances), rtol=1e-6,
                               atol=1e-12)


@pytest.mark.parametrize("task, subset, mdr", [("regression", None, 640),
                                               ("regression", 2, 512),
                                               ("classification", None, 1024)])
def test_forest_outofcore_identical_to_jax_without_bootstrap(task, subset, mdr, mesh8,
                                                             block_count):
    x, y = _int_reg(seed=2)
    if task == "classification":
        y = (y > np.median(y)).astype(np.float32)
    ph, jh = _both(x, y, mdr=mdr)
    kw = dict(task=task, num_trees=3, max_depth=3, bootstrap=False, seed=5,
              feature_subset_size=subset)
    jf = jeng.grow_forest_outofcore(jh, mesh=mesh8, **kw)
    pf = peng.grow_forest_outofcore(ph, device="cpu", **kw)
    _assert_same_forest(pf, jf)
    # one pass a level, each block once
    assert block_count["passes"] == 4
    assert block_count["blocks"] == 4 * ph.block_shape()[0]


def test_forest_bootstrap_draws_are_jaxs_per_block_draws(mesh8):
    x, y = _int_reg(n=3000, d=4, seed=3)
    ph, jh = _both(x, y, mdr=800)
    n_blocks, b = ph.block_shape()
    assert (n_blocks, b) == jh.block_shape(mesh8) == (4, 800)
    for i in range(n_blocks):
        want = jax.random.poisson(jax.random.fold_in(jax.random.key(11), i), 0.8, (3, b))
        got = peng.block_bootstrap(11, i, 0.8, 3, b, "cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.float32))
    kw = dict(task="regression", num_trees=3, max_depth=3, bootstrap=True,
              subsampling_rate=0.8, seed=11)
    _assert_same_forest(peng.grow_forest_outofcore(ph, device="cpu", **kw),
                        jeng.grow_forest_outofcore(jh, mesh=mesh8, **kw))


@pytest.mark.parametrize("est", ["dt_reg", "dt_cls", "rf_reg", "rf_cls"])
def test_tree_estimators_take_the_streamed_path(est, mesh8, block_count):
    x, y = _int_reg(n=2048, d=4, seed=4)
    if est.endswith("cls"):
        y = (y > np.median(y)).astype(np.float32)
    cls = {"dt_reg": "DecisionTreeRegressor", "dt_cls": "DecisionTreeClassifier",
           "rf_reg": "RandomForestRegressor", "rf_cls": "RandomForestClassifier"}[est]
    kw = dict(max_depth=3, seed=1)
    if est.startswith("rf"):
        kw.update(num_trees=3)
    ph, jh = _both(x, y, mdr=512)
    jm = getattr(J, cls)(**kw).fit(jh, mesh=mesh8)
    pm = getattr(P, cls)(**kw).fit(ph, device="cpu")
    np.testing.assert_array_equal(pm.split_feat, np.asarray(jm.split_feat))
    np.testing.assert_array_equal(pm.threshold, np.asarray(jm.threshold))
    np.testing.assert_allclose(pm.feature_importances, np.asarray(jm.feature_importances),
                               rtol=1e-6)
    assert block_count["blocks"] == 4 * ph.block_shape()[0]


def test_forest_categorical_splits_match_jax(mesh8):
    rng = np.random.default_rng(4)
    n = 3000
    cat = rng.integers(0, 6, size=n).astype(np.float32)
    x = np.stack([cat, rng.integers(0, 10, size=n).astype(np.float32)], axis=1)
    y = np.where(np.isin(cat, [1.0, 4.0]), 10.0, 0.0).astype(np.float32)
    ph, jh = _both(x, y, mdr=512)
    jm = J.DecisionTreeRegressor(max_depth=2, seed=0, categorical_features={0: 6}).fit(
        jh, mesh=mesh8)
    pm = P.DecisionTreeRegressor(max_depth=2, seed=0, categorical_features={0: 6}).fit(
        ph, device="cpu")
    np.testing.assert_array_equal(pm.split_feat, np.asarray(jm.split_feat))
    np.testing.assert_array_equal(pm.split_catmask, np.asarray(jm.split_catmask))
    np.testing.assert_allclose(pm.predict_numpy(x, device="cpu"), y, atol=1e-5)


def test_forest_bin_thresholds_and_bad_inputs_raise():
    x, y = _int_reg(n=64, d=2)
    hd = P.HostDataset(x=x, y=y, max_device_rows=32)
    thr = peng.quantile_thresholds(x.astype(np.float64), 8)
    f = peng.grow_forest_outofcore(hd, task="regression", max_bins=8, max_depth=2,
                                   bin_thresholds=thr, device="cpu")
    np.testing.assert_array_equal(f.bin_thresholds, thr)
    with pytest.raises(ValueError, match="bin_thresholds shape"):
        peng.grow_forest_outofcore(hd, task="regression", max_bins=8, bin_thresholds=thr[:1],
                                   device="cpu")
    with pytest.raises(ValueError, match="labels"):
        P.DecisionTreeRegressor().fit(P.HostDataset(x=x), device="cpu")
    with pytest.raises(ValueError, match="empty"):
        P.DecisionTreeRegressor().fit(P.HostDataset(x=x, y=y, w=np.zeros(64)), device="cpu")
    with pytest.raises(ValueError, match="empty"):
        peng.grow_forest_outofcore(P.HostDataset(x=x, y=y, w=np.zeros(64)),
                                   task="regression", bin_thresholds=thr, max_bins=8,
                                   device="cpu")
    with pytest.raises(ValueError, match="arity"):
        P.DecisionTreeRegressor(categorical_features={0: 64}).fit(hd, device="cpu")


def _hospital_rows(n_per_hospital=80_000, seed=7):
    """The example generator's law (``examples/run_hospital_pipeline.py``):
    4 features, occupancy up to 400, LOS linear in them plus noise."""
    rng = np.random.default_rng(seed)
    n = 5 * n_per_hospital
    x = np.stack([rng.integers(0, 50, n), rng.integers(20, 400, n), rng.integers(0, 30, n),
                  rng.uniform(0.5, 1.5, n)], axis=1).astype(np.float64)
    y = x @ np.array([0.05, 0.008, 0.12, 2.0]) + rng.normal(0.0, 0.4, n)
    return x, y


def test_linear_regression_recentred_stats_hold_at_scale(mesh8):
    """On 400,000 hospital rows (occupancy up to 400) the resident float32
    normal equations (unshifted, as the reference's ``_wls_fit``) summed
    in one float32 pass over the rows sat 1.7e-3 of the largest
    coefficient off the float64 solution with one thread, the reference's
    (summed per device, then psum'd) 6.3e-6; the port now sums its Gram
    per 4,096-row chunk.  The out-of-core solve recentres on a sample mean
    and holds 1e-5 in both packages."""
    x, y = _hospital_rows()
    exact = np.linalg.lstsq(np.c_[x, np.ones(len(y))], y, rcond=None)[0]
    s = float(np.abs(exact).max())

    def err(m):
        c = np.r_[np.asarray(m.coefficients, np.float64), float(m.intercept)]
        return float(np.abs(c - exact).max())

    ph, jh = _both(x, y, mdr=1 << 16)
    assert err(P.LinearRegression().fit(ph, device="cpu")) <= 1e-5 * s
    assert err(J.LinearRegression().fit(jh, mesh=mesh8)) <= 1e-5 * s
    ref = err(J.LinearRegression().fit((x, y), mesh=mesh8))
    assert ref <= 1e-4 * s
    # the port's resident solve, chunked: within 3x the reference's distance
    assert err(P.LinearRegression().fit((x, y), device="cpu")) <= 3.0 * ref
