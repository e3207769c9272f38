"""Out of core over a mesh: the port's ``HostDataset.blocks(mesh)`` and its
out-of-core fits over a (data, model) mesh against the JAX package's
``HostDataset`` fits on the same mesh shape and against the port's
one-device out-of-core fits, on the CPU.

The port's meshes are over ``[torch.device("cpu")] * 8`` (each shard of a
block runs the kernels' plain versions); the JAX side runs on
``tests/conftest.py``'s 8 virtual CPU devices.

Tolerances, and why:
- a (1, 1) mesh is the one-device out-of-core fit: ``==`` everywhere;
- the blocks: ``==`` to the JAX package's, rows, weights and labels (the
  same numpy casts, the same mesh-rounded block rows);
- integer-valued rows: KMeans' Lloyd statistics, the trees' histograms and
  BisectingKMeans' sums are exact in float32 (float64 for bisecting) in
  any order, so a fit over any mesh ``==`` the one-device fit, and the
  forest ``==`` the JAX forest (its split bins and thresholds; leaf values
  rtol 1e-6);
- float rows, against the JAX fit on the same mesh shape (float32 sums in
  another order: per shard here, psum'd there): KMeans centers rtol 1e-5 /
  atol 1e-5 and ``training_cost`` rtol 1e-5 (``tests/test_torch_outofcore.py``'s
  limits); LinearRegression within max(1e-4, κ·2⁻²³) of the largest
  coefficient from the float64 solution, 2x that from the JAX fit;
  GaussianMixture log-likelihood rtol 1e-5, means and covariances atol
  1e-4, weights atol 1e-6 (``test_torch_outofcore.py``); LogisticRegression
  coefficients atol 2e-3, intercepts 5e-3 and probabilities 1e-3
  (``tests/test_torch_sharded_models.py``'s limits, the multinomial
  intercepts class-centred); BisectingKMeans centers rtol 1e-5 / atol 1e-4
  (``test_torch_sharded_clustering.py``);
- GBT on integer labels: the first round's residuals are integers, the
  later ones are not, so the splits ``==`` and the leaf values within
  1e-4 (``test_torch_sharded_models.py``'s GBT limit);
- the forest's per-block Poisson bootstrap: bit-equal to the JAX draw on
  the same mesh shape (one threefry stream over the block's mesh-rounded
  rows, cut by columns into the shards).
"""

import jax
import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.config import (
    MeshConfig as JMeshConfig,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.models.tree import (
    engine as jeng,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.parallel.outofcore import (
    HostDataset as JHostDataset,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.parallel.outofcore import (
    streamed_standardization as jstd,
)
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models.tree import (
    engine as peng,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.parallel import (
    outofcore as pooc,
)

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
SHAPES = [(8, 1), (4, 2)]


def _mesh(shape):
    return P.build_mesh(port.MeshConfig(data=shape[0], model=shape[1]), CPU8)


def _jmesh(shape):
    return J.parallel.build_mesh(JMeshConfig(data=shape[0], model=shape[1]))


def _both(x, y=None, w=None, mdr=512):
    return (port.HostDataset(x=x, y=y, w=w, max_device_rows=mdr),
            JHostDataset(x=x, y=y, w=w, max_device_rows=mdr))


def _int_blobs(n=3000, d=4, k=6, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.integers(-40, 40, size=(k, d))
    return (c[rng.integers(0, k, n)] + rng.integers(-3, 4, size=(n, d))).astype(np.float32)


def _float_blobs(n=3000, d=4, k=6, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 6, size=(k, d))
    return (c[rng.integers(0, k, n)] + rng.normal(size=(n, d))).astype(np.float32)


# ------------------------------------------------------------ HostDataset
@pytest.mark.parametrize("shape", SHAPES + [(2, 4)])
@pytest.mark.parametrize("n, mdr", [(1000, 250), (37, 13), (4096, 512), (5, 64)])
def test_blocks_over_a_mesh_are_the_jax_packages_blocks(shape, n, mdr):
    """``block_shape(mesh)`` rounds the block to the data axis as the JAX
    package does (n and ``max_device_rows`` not multiples of 8 included),
    and every block's rows, weights and labels, gathered over the shards,
    ``==`` the JAX block; shard i holds rows [i·b/D, (i+1)·b/D)."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 3))
    y = rng.integers(0, 5, size=n)
    w = rng.uniform(0.5, 2.0, size=n)
    ph, jh = _both(x, y, w, mdr)
    pm, jm = _mesh(shape), _jmesh(shape)
    assert ph.block_shape(pm) == jh.block_shape(jm)
    n_blocks, b = ph.block_shape(pm)
    pbs, jbs = list(ph.blocks(pm)), list(jh.blocks(jm))
    assert len(pbs) == len(jbs) == n_blocks
    per = b // shape[0]
    for pb, jb in zip(pbs, jbs):
        assert isinstance(pb, P.ShardedDataset) and pb.mesh == pm
        for name in ("x", "y", "w"):
            np.testing.assert_array_equal(getattr(pb, name).numpy(), np.asarray(getattr(jb, name)))
        for i in range(shape[0]):
            # a model entry of a shard holds the same rows (here: the same view)
            assert all(pb.shard(i, j) is pb.shard(i, 0) for j in range(shape[1]))
            np.testing.assert_array_equal(pb.shard(i).x.numpy(),
                                          np.asarray(jb.x)[i * per:(i + 1) * per])


def test_a_one_entry_mesh_streams_the_device_blocks():
    """A (1, 1) mesh is its device: DeviceDatasets ``==`` ``blocks(device=)``;
    a mesh and a device together are refused."""
    x = np.arange(60, dtype=np.float32).reshape(20, 3)
    hd = port.HostDataset(x=x, y=np.ones(20), max_device_rows=7)
    one = list(hd.blocks(device="cpu"))
    got = list(hd.blocks(_mesh((1, 1))))
    assert hd.block_shape(_mesh((1, 1))) == hd.block_shape() == (3, 7)
    for a, b in zip(one, got):
        assert isinstance(b, P.DeviceDataset)
        for name in ("x", "y", "w"):
            assert torch.equal(getattr(a, name), getattr(b, name))
    with pytest.raises(ValueError, match="not both"):
        list(hd.blocks(_mesh((1, 1)), device="cpu"))


@pytest.mark.parametrize("shape", [(1, 1)] + SHAPES)
@pytest.mark.parametrize("extra", ["none", "ysum", "ymax"])
def test_streamed_standardization_over_shards(shape, extra):
    """The moments pre-pass over a mesh: each block's shards summed in shard
    order, then the blocks (the max for "ymax", over shards too).  Against
    the JAX pass on the same mesh: n rtol 1e-6, mean rtol 1e-5 / atol 1e-6,
    std rtol 1e-4 (``test_torch_logistic_regression.py``'s limits); the
    (1, 1) mesh ``==`` the device pass.  No column is near-constant here:
    such a column's one-pass float32 variance is rounding, which the sum
    order moves across the 1e-12 degenerate-variance cut in both packages
    (the rule itself is held on one device in that file)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1000, 3)).astype(np.float32) * [1.0, 0.5, 3.0] + [0.0, 7.0, 2.0]
    y = rng.integers(0, 4, 1000).astype(np.float32)
    w = rng.uniform(0.0, 2.0, 1000).astype(np.float32)
    ph, jh = _both(x, y, w, 250)
    got = pooc.streamed_standardization(ph, _mesh(shape), extra=extra)
    want = jstd(jh, _jmesh(shape), extra=extra)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4)
    if extra != "none":
        np.testing.assert_allclose(got[3], want[3], rtol=1e-6)
    if shape == (1, 1):
        one = pooc.streamed_standardization(ph, device="cpu", extra=extra)
        for a, b in zip(got, one):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ KMeans
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kw", [dict(), dict(distance_measure="cosine"),
                                dict(matmul_precision="bf16"),
                                dict(matmul_precision="bf16", fused_stats=True)])
def test_kmeans_over_a_mesh_matches_jax_and_one_device(shape, kw):
    """Integer rows: the mesh fit ``==`` the one-device out-of-core fit and
    the JAX fit (exact Lloyd sums; bf16's rounding of integer rows below
    256 is exact too).  Cosine rows are unit rows, not integers: centers
    atol 1e-5 against both."""
    x = _int_blobs()
    ph, jh = _both(x, mdr=512)
    est = dict(k=6, seed=0, max_iter=10, **kw)
    got = port.KMeans(**est).fit(ph, mesh=_mesh(shape))
    one = port.KMeans(**est).fit(ph, device="cpu")
    jm = J.KMeans(**est).fit(jh, mesh=_jmesh(shape))
    for ref in (one, jm):
        assert got.n_iter == ref.n_iter
        if kw.get("distance_measure") == "cosine":
            np.testing.assert_allclose(got.cluster_centers, np.asarray(ref.cluster_centers),
                                       atol=1e-5)
        else:
            np.testing.assert_array_equal(got.cluster_centers, np.asarray(ref.cluster_centers))
            np.testing.assert_array_equal(got.cluster_sizes, np.asarray(ref.cluster_sizes))
        np.testing.assert_allclose(got.training_cost, ref.training_cost, rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_kmeans_float_rows_and_weights_over_a_mesh(shape):
    """Float rows with fractional weights: float32 sums in another order;
    centers rtol 1e-5 / atol 1e-5 and cost rtol 1e-5 against the JAX fit on
    the same mesh and against the one-device out-of-core fit."""
    x = _float_blobs()
    w = np.random.default_rng(1).uniform(0.2, 2.0, len(x)).astype(np.float32)
    ph, jh = _both(x, w=w, mdr=600)
    est = dict(k=6, seed=0, max_iter=10)
    got = port.KMeans(**est).fit(ph, mesh=_mesh(shape))
    for ref in (port.KMeans(**est).fit(ph, device="cpu"),
                J.KMeans(**est).fit(jh, mesh=_jmesh(shape))):
        assert got.n_iter == ref.n_iter
        np.testing.assert_allclose(got.cluster_centers, np.asarray(ref.cluster_centers),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.training_cost, ref.training_cost, rtol=1e-5)


def test_kmeans_one_entry_mesh_is_the_device_fit():
    x = _float_blobs(seed=3)
    ph = port.HostDataset(x=x, max_device_rows=700)
    est = dict(k=5, seed=1, max_iter=6)
    one = port.KMeans(**est).fit(ph, device="cpu")
    got = port.KMeans(**est).fit(ph, mesh=_mesh((1, 1)))
    np.testing.assert_array_equal(got.cluster_centers, one.cluster_centers)
    np.testing.assert_array_equal(got.cluster_sizes, one.cluster_sizes)
    assert got.training_cost == one.training_cost and got.n_iter == one.n_iter


@pytest.mark.parametrize("shape", [(4, 1), (4, 2)])
def test_kmeans_checkpoint_kill_and_resume_over_a_mesh(shape, tmp_path):
    """A kill after step 3 over a mesh, resumed, ``==`` the uninterrupted
    fit (the commit is the float32 centers; the signature's ``k_pad`` is
    the mesh's, the reference's).  ``on_iteration`` sees every step."""
    x = _float_blobs(n=4000, seed=4)
    ph = port.HostDataset(x=x, max_device_rows=512)
    mesh = _mesh(shape)
    kw = dict(k=7, seed=0, max_iter=9, tol=0.0, checkpoint_every=1)
    full = port.KMeans(**kw).fit(ph, mesh=mesh)

    class Kill(Exception):
        pass

    def bomb(it, cost, move):
        if it == 3:
            raise Kill

    ck = str(tmp_path / "km")
    with pytest.raises(Kill):
        port.KMeans(checkpoint_dir=ck, **kw).fit(ph, mesh=mesh, on_iteration=bomb)
    seen = []
    resumed = port.KMeans(checkpoint_dir=ck, **kw).fit(
        ph, mesh=mesh, on_iteration=lambda it, c, m: seen.append(it))
    assert seen == list(range(4, 10))
    np.testing.assert_array_equal(resumed.cluster_centers, full.cluster_centers)
    assert resumed.training_cost == full.training_cost and resumed.n_iter == full.n_iter


# -------------------------------------------------------- LinearRegression
def _lr_data(n=4000, d=5, seed=0, offset=0.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) + offset).astype(np.float32)
    y = (x @ rng.normal(size=d) + 2.5 + rng.normal(0, 0.1, size=n)).astype(np.float32)
    return x, y


def _lr_tol(x, y, w, reg_param=0.0):
    x64, y64, w64 = (np.asarray(a, np.float64) for a in (x, y, w))
    n = w64.sum()
    mean = (x64 * w64[:, None]).sum(0) / n
    xc = x64 - mean
    std = np.sqrt((xc * xc * w64[:, None]).sum(0) / n)
    g = (xc * w64[:, None]).T @ xc / n / np.outer(std, std) + reg_param * np.eye(len(mean))
    c = (xc * w64[:, None]).T @ (y64 - (y64 * w64).sum() / n) / n / std
    coef = np.linalg.solve(g, c) / std
    return max(1e-4, np.linalg.cond(g) * 2.0 ** -23) * max(float(np.abs(coef).max()), 1.0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kw", [dict(), dict(reg_param=0.3),
                                dict(reg_param=0.1, elastic_net_param=0.5)])
def test_linear_regression_over_a_mesh(shape, kw):
    x, y = _lr_data(offset=20.0)
    w = np.random.default_rng(1).uniform(0.5, 2.0, size=len(y)).astype(np.float32)
    ph, jh = _both(x, y, w, mdr=1000)
    got = port.LinearRegression(**kw).fit(ph, mesh=_mesh(shape))
    one = port.LinearRegression(**kw).fit(ph, device="cpu")
    jm = J.LinearRegression(**kw).fit(jh, mesh=_jmesh(shape))
    tol = _lr_tol(x, y, w, kw.get("reg_param", 0.0))
    for ref, lim in ((one, tol), (jm, 2 * tol)):
        np.testing.assert_allclose(got.coefficients.numpy(), np.asarray(ref.coefficients),
                                   rtol=0, atol=lim)
        np.testing.assert_allclose(float(got.intercept), float(ref.intercept), rtol=0,
                                   atol=lim)
    one11 = port.LinearRegression(**kw).fit(ph, mesh=_mesh((1, 1)))
    assert torch.equal(one11.coefficients, one.coefficients)
    assert torch.equal(one11.intercept, one.intercept)
    with pytest.raises(RuntimeError, match="summary"):
        got.summary


# ---------------------------------------------------------- GaussianMixture
def _gmm_blobs(n=3000, k=4, d=3, seed=0):
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


@pytest.mark.parametrize("shape", SHAPES)
def test_gmm_over_a_mesh(shape):
    x = _gmm_blobs()
    ph, jh = _both(x, mdr=800)
    kw = dict(k=4, max_iter=5, seed=0)
    got = port.GaussianMixture(**kw).fit(ph, mesh=_mesh(shape))
    _assert_gmm_close(got, J.GaussianMixture(**kw).fit(jh, mesh=_jmesh(shape)))
    _assert_gmm_close(got, port.GaussianMixture(**kw).fit(ph, device="cpu"))
    one = port.GaussianMixture(**kw).fit(ph, device="cpu")
    one11 = port.GaussianMixture(**kw).fit(ph, mesh=_mesh((1, 1)))
    np.testing.assert_array_equal(one11.means, one.means)
    np.testing.assert_array_equal(one11.covariances, one.covariances)


def test_gmm_checkpoint_resume_and_warm_start_over_a_mesh(tmp_path):
    """A kill after iteration 2 over (4, 1), resumed from the float64
    unshifted means, ``==`` the uninterrupted fit; a warm start (unshifted)
    holds the JAX warm fit on the same mesh."""
    x = _gmm_blobs(n=2400, seed=2)
    ph, jh = _both(x, mdr=512)
    mesh = _mesh((4, 1))
    kw = dict(k=4, max_iter=6, tol=0.0, seed=1, checkpoint_every=1)
    full = port.GaussianMixture(**kw).fit(ph, mesh=mesh)

    class Kill(Exception):
        pass

    def bomb(it, ll):
        if it == 2:
            raise Kill

    ck = str(tmp_path / "gmm")
    with pytest.raises(Kill):
        port.GaussianMixture(checkpoint_dir=ck, **kw).fit(ph, mesh=mesh, on_iteration=bomb)
    resumed = port.GaussianMixture(checkpoint_dir=ck, **kw).fit(ph, mesh=mesh)
    np.testing.assert_array_equal(resumed.means, full.means)
    np.testing.assert_array_equal(resumed.covariances, full.covariances)
    assert resumed.log_likelihood == full.log_likelihood
    xs = x - 50.0
    ph0, jh0 = _both(xs, mdr=512)
    warm = (full.weights, full.means - 50.0, full.covariances)
    wk = dict(k=4, max_iter=3, warm_start_params=warm)
    _assert_gmm_close(port.GaussianMixture(**wk).fit(ph0, mesh=mesh),
                      J.GaussianMixture(**wk).fit(jh0, mesh=_jmesh((4, 1))))


# ------------------------------------------------------- LogisticRegression
def _logit_data(n=3000, d=4, classes=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    logits = x @ rng.normal(size=(d, classes))
    y = np.argmax(logits + rng.gumbel(size=(n, classes)), axis=1).astype(np.float32)
    return x, y


def _centred(a):
    a = np.asarray(a, np.float64)
    return a - a.mean()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("classes", [2, 3])
def test_logistic_over_a_mesh(shape, classes):
    x, y = _logit_data(classes=classes)
    w = np.random.default_rng(2).uniform(0.5, 2.0, len(y)).astype(np.float32)
    ph, jh = _both(x, y, w, mdr=700)
    kw = dict(reg_param=0.01)
    got = port.LogisticRegression(**kw).fit(ph, mesh=_mesh(shape))
    one = port.LogisticRegression(**kw).fit(ph, device="cpu")
    jm = J.LogisticRegression(**kw).fit(jh, mesh=_jmesh(shape))
    probs = got.predict_proba(torch.from_numpy(x)).numpy()
    for ref in (one, jm):
        assert got.n_iter == ref.n_iter
        if classes == 2:
            np.testing.assert_allclose(got.coefficients.numpy(), np.asarray(ref.coefficients),
                                       atol=2e-3)
            np.testing.assert_allclose(float(got.intercept), float(ref.intercept), atol=5e-3)
        else:
            np.testing.assert_allclose(got.coefficient_matrix.numpy(),
                                       np.asarray(ref.coefficient_matrix), atol=2e-3)
            np.testing.assert_allclose(_centred(got.intercept_vector.numpy()),
                                       _centred(ref.intercept_vector), atol=5e-3)
    np.testing.assert_allclose(probs, one.predict_proba(torch.from_numpy(x)).numpy(),
                               atol=1e-3)


# --------------------------------------------------------- BisectingKMeans
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kw", [dict(k=5, seed=1, n_restarts=1),
                                dict(k=4, seed=2, n_restarts=2, strategy="sequential")])
def test_bisecting_over_a_mesh(shape, kw):
    """Integer rows: the mesh fit ``==`` the one-device out-of-core fit
    (float64 child sums); against the JAX out-of-core fit on the same mesh
    the same sizes, centers rtol 1e-5 / atol 1e-4."""
    x = _int_blobs(n=2048, d=3, k=6, seed=5)
    ph, jh = _both(x, mdr=512)
    got = port.BisectingKMeans(**kw).fit(ph, mesh=_mesh(shape))
    one = port.BisectingKMeans(**kw).fit(ph, device="cpu")
    jm = J.BisectingKMeans(**kw).fit(jh, mesh=_jmesh(shape))
    np.testing.assert_array_equal(got.cluster_centers, one.cluster_centers)
    np.testing.assert_array_equal(got.cluster_sizes, one.cluster_sizes)
    assert got.fit_info["splits"] == one.fit_info["splits"]
    order = np.lexsort(got.cluster_centers.T)
    jorder = np.lexsort(np.asarray(jm.cluster_centers).T)
    np.testing.assert_array_equal(got.cluster_sizes[order], np.asarray(jm.cluster_sizes)[jorder])
    np.testing.assert_allclose(got.cluster_centers[order],
                               np.asarray(jm.cluster_centers)[jorder], rtol=1e-5, atol=1e-4)


def test_bisecting_float_rows_weights_and_one_entry_mesh():
    """Float rows with fractional weights over (4, 2): the same splits and
    sizes rtol 1e-6, centers atol 1e-4 against the one-device fit; the (1,
    1) mesh ``==`` the device fit."""
    x = _float_blobs(n=2000, d=3, k=5, seed=6)
    w = np.random.default_rng(7).uniform(0.2, 2.0, len(x)).astype(np.float32)
    ph = port.HostDataset(x=x, w=w, max_device_rows=400)
    kw = dict(k=4, seed=0, n_restarts=1)
    one = port.BisectingKMeans(**kw).fit(ph, device="cpu")
    got = port.BisectingKMeans(**kw).fit(ph, mesh=_mesh((4, 2)))
    assert got.fit_info["splits"] == one.fit_info["splits"]
    np.testing.assert_allclose(got.cluster_sizes, one.cluster_sizes, rtol=1e-6)
    np.testing.assert_allclose(got.cluster_centers, one.cluster_centers, atol=1e-4)
    one11 = port.BisectingKMeans(**kw).fit(ph, mesh=_mesh((1, 1)))
    np.testing.assert_array_equal(one11.cluster_centers, one.cluster_centers)


# -------------------------------------------------------------------- trees
def _int_reg(n=4096, d=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 24, size=(n, d)).astype(np.float32)
    y = (x @ rng.integers(1, 4, size=d)).astype(np.float32) % 23
    return x, y


def _assert_same_forest(pf, jf):
    for a in ("split_feat", "split_bin", "threshold"):
        np.testing.assert_array_equal(getattr(pf, a), np.asarray(getattr(jf, a)))
    np.testing.assert_allclose(pf.value, np.asarray(jf.value), rtol=1e-6)


@pytest.fixture
def k3_calls(monkeypatch):
    """Counts the engine's K3 calls (on the CPU the kernel's launch counter
    does not move: its plain version runs)."""
    seen = {"n": 0}
    orig = peng.fused_level_hist

    def counting(*a, **k):
        seen["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(peng, "fused_level_hist", counting)
    return seen


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("task", ["regression", "classification"])
def test_forest_over_a_mesh_without_bootstrap(shape, task, k3_calls):
    """Integer labels: the mesh forest ``==`` the one-device forest and the
    JAX forest on the same mesh; K3 runs once a data shard a block a
    level."""
    x, y = _int_reg(seed=2)
    if task == "classification":
        y = (y > np.median(y)).astype(np.float32)
    ph, jh = _both(x, y, mdr=640)
    kw = dict(task=task, num_trees=3, max_depth=3, bootstrap=False, seed=5,
              feature_subset_size=2)
    got = peng.grow_forest_outofcore(ph, mesh=_mesh(shape), **kw)
    n_blocks = ph.block_shape(_mesh(shape))[0]
    assert k3_calls["n"] == shape[0] * n_blocks * 4
    _assert_same_forest(got, jeng.grow_forest_outofcore(jh, mesh=_jmesh(shape), **kw))
    _assert_same_forest(got, peng.grow_forest_outofcore(ph, device="cpu", **kw))


@pytest.mark.parametrize("shape", SHAPES)
def test_forest_bootstrap_over_a_mesh_is_the_jax_draw(shape):
    """The per-block bootstrap over the mesh-rounded block: bit-equal to the
    JAX draw on the same mesh shape, so the forests ``==`` (where D divides
    ``max_device_rows`` the block, and the forest, are one device's too)."""
    x, y = _int_reg(n=3000, d=4, seed=3)
    ph, jh = _both(x, y, mdr=797)
    pm, jm = _mesh(shape), _jmesh(shape)
    n_blocks, b = ph.block_shape(pm)
    assert (n_blocks, b) == jh.block_shape(jm) and b % shape[0] == 0
    for i in range(n_blocks):
        want = jax.random.poisson(jax.random.fold_in(jax.random.key(11), i), 0.8, (3, b))
        np.testing.assert_array_equal(peng.block_bootstrap(11, i, 0.8, 3, b, "cpu").numpy(),
                                      np.asarray(want).astype(np.float32))
    kw = dict(task="regression", num_trees=3, max_depth=3, bootstrap=True,
              subsampling_rate=0.8, seed=11)
    _assert_same_forest(peng.grow_forest_outofcore(ph, mesh=pm, **kw),
                        jeng.grow_forest_outofcore(jh, mesh=jm, **kw))
    ph8 = port.HostDataset(x=x, y=y, max_device_rows=800)
    _assert_same_forest(peng.grow_forest_outofcore(ph8, mesh=pm, **kw),
                        peng.grow_forest_outofcore(ph8, device="cpu", **kw))


@pytest.mark.parametrize("est", ["DecisionTreeRegressor", "DecisionTreeClassifier",
                                 "RandomForestRegressor", "RandomForestClassifier"])
def test_tree_estimators_fit_a_host_dataset_over_a_mesh(est):
    x, y = _int_reg(n=2048, d=4, seed=4)
    if est.endswith("Classifier"):
        y = (y > np.median(y)).astype(np.float32)
    kw = dict(max_depth=3, seed=1)
    if est.startswith("Random"):
        kw.update(num_trees=3)
    ph, jh = _both(x, y, mdr=512)
    got = getattr(port, est)(**kw).fit(ph, mesh=_mesh((4, 2)))
    jm = getattr(J, est)(**kw).fit(jh, mesh=_jmesh((4, 2)))
    one = getattr(port, est)(**kw).fit(ph, device="cpu")
    for ref in (jm, one):
        np.testing.assert_array_equal(got.split_feat, np.asarray(ref.split_feat))
        np.testing.assert_array_equal(got.threshold, np.asarray(ref.threshold))


def test_forest_checkpoint_does_not_record_the_block_rows(tmp_path):
    """The forest's out-of-core signature (both packages') has no block
    rows: a fit checkpointed on (4, 1) with 797-row blocks (rounded to 800)
    resumes on (8, 1) (rounded to 800 too) without complaint.  Where the
    rounding differs, a resume would draw other bootstraps unnoticed
    (ROADMAP queue 3, shared with the reference)."""
    x, y = _int_reg(n=2000, d=3, seed=8)
    kw = dict(task="regression", num_trees=2, max_depth=3, bootstrap=True,
              subsampling_rate=0.8, seed=3)
    ck = str(tmp_path / "f")
    ph = port.HostDataset(x=x, y=y, max_device_rows=797)
    assert ph.block_shape(_mesh((4, 1))) == ph.block_shape(_mesh((8, 1))) == (3, 800)

    class Kill(Exception):
        pass

    def bomb(depth):
        if depth == 1:
            raise Kill

    with pytest.raises(Kill):
        peng.grow_forest_outofcore(ph, mesh=_mesh((4, 1)), checkpoint_dir=ck, on_level=bomb,
                                   **kw)
    resumed = peng.grow_forest_outofcore(ph, mesh=_mesh((8, 1)), checkpoint_dir=ck, **kw)
    _assert_same_forest(resumed, peng.grow_forest_outofcore(ph, mesh=_mesh((8, 1)), **kw))
    jck = str(tmp_path / "jf")
    jh = JHostDataset(x=x, y=y, max_device_rows=797)
    with pytest.raises(Kill):
        jeng.grow_forest_outofcore(jh, mesh=_jmesh((4, 1)), checkpoint_dir=jck, on_level=bomb,
                                   **kw)
    jeng.grow_forest_outofcore(jh, mesh=_jmesh((8, 1)), checkpoint_dir=jck, **kw)


@pytest.mark.parametrize("shape", [(4, 1), (4, 2)])
@pytest.mark.parametrize("cls", ["GBTRegressor", "GBTClassifier"])
def test_gbt_over_a_mesh(shape, cls):
    """Integer labels: the mesh boost's splits ``==`` the one-device boost's
    and the JAX boost's on the same mesh, leaf values within 1e-4 (the
    residuals stop being integers after the first round)."""
    x, y = _int_reg(n=2048, d=4, seed=9)
    if cls == "GBTClassifier":
        y = (y > np.median(y)).astype(np.float32)
    ph, jh = _both(x, y, mdr=512)
    kw = dict(max_iter=4, max_depth=3, seed=0)
    got = getattr(port, cls)(**kw).fit(ph, mesh=_mesh(shape))
    for ref in (getattr(port, cls)(**kw).fit(ph, device="cpu"),
                getattr(J, cls)(**kw).fit(jh, mesh=_jmesh(shape))):
        np.testing.assert_array_equal(got.split_feat, np.asarray(ref.split_feat))
        np.testing.assert_allclose(got.value, np.asarray(ref.value), atol=1e-4)
