"""LDA, PowerIterationClustering, ALS's sharded buckets and the fused SQL
route over a (data, model) mesh: the port's fits against its own
single-device fits and against the JAX package's fits on the same mesh
shape, on the CPU, on the same seeded inputs (mirroring the reference's
own mesh tests, ``tests/test_lda_pic.py``, ``tests/test_als.py`` and
``tests/test_sql_device.py``).

The port's meshes are over ``[torch.device("cpu")] * 8`` at (1, 1),
(8, 1) and (4, 2); the JAX side runs on ``tests/conftest.py``'s 8 virtual
CPU devices (``mesh8``, or ``build_mesh`` of the same shape).

Tolerances, and why:
- a (1, 1) mesh is the single-device path: ``==`` everywhere;
- LDA sums each shard's sufficient statistics (a float32 product) and then
  the shards in ascending order, where one device takes one product over
  every row: λ within LAM = 5e-5 of the largest λ of one device and of
  the JAX fit on the same mesh shape (``tests/test_torch_lda_pic.py``'s
  JAX-parity limit), the top terms ``==``; out of core the blocks are
  rounded to the data axis as the reference rounds them, so the (8, 1) fit
  draws the JAX mesh8 fit's blocks;
- PIC's embedding is the one-device power iteration (``==``); its 1-D
  KMeans sums a shard at a time, so the partitions are equal to one
  device's and to the JAX package's up to a relabelling;
- ALS solves every row's own normal equations, so a sharded fit is ``==``
  the one-device fit (the reference's ``mesh == solo`` claim), explicit,
  implicit and NNLS, and within FIT = 1e-5 of the JAX predictions on the
  same mesh shape (``tests/test_torch_als.py``'s limit);
- the fused SQL rows are moved, not computed, over the mesh: ``==`` the
  one-device rows and ``==`` ``to_device(mesh=)`` of the host route's
  rows; a LinearRegression on them within LR_TOL = 1e-4 of the largest
  coefficient (``tests/test_torch_sql_device.py``'s limit) and a depth-3
  tree on an integer label ``==``.
"""

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.config import (
    MeshConfig as JMeshConfig,
)
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import sql as psql

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
SHAPES = [(1, 1), (8, 1), (4, 2)]
LAM = 5e-5
FIT = 1e-5
LR_TOL = 1e-4


def _mesh(shape):
    return P.build_mesh(port.MeshConfig(data=shape[0], model=shape[1]), CPU8)


def _jmesh(shape):
    return J.parallel.build_mesh(JMeshConfig(data=shape[0], model=shape[1]))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


# ----------------------------------------------------------------------- LDA
def _topic_docs(seed=0, v=30, k=3, n=301, doc_len=60):
    rng = np.random.default_rng(seed)
    topics = np.zeros((k, v))
    span = v // k
    for j in range(k):
        topics[j, j * span: (j + 1) * span] = 1.0 / span
    docs = np.zeros((n, v), np.float32)
    for i, z in enumerate(rng.integers(0, k, n)):
        np.add.at(docs[i], rng.choice(v, size=doc_len, p=topics[z]), 1.0)
    return docs


def _top_terms(m, n=5):
    return [list(idx[:n]) for idx, _ in m.describe_topics(n)]


@pytest.mark.parametrize("shape", SHAPES)
def test_lda_resident_over_the_mesh(shape):
    """The E-step once a shard, the statistics summed in shard order, λ
    updated once on the home device."""
    x = _topic_docs()
    mesh = _mesh(shape)
    got = port.LDA(k=3, max_iter=8, seed=0).fit(x, mesh=mesh)
    one = port.LDA(k=3, max_iter=8, seed=0).fit(x, device="cpu")
    ref = J.LDA(k=3, max_iter=8, seed=0).fit(x, mesh=_jmesh(shape))
    for m in (one, ref):
        assert _rel(got.lam, m.lam) <= LAM
        assert _top_terms(got) == _top_terms(m)
        assert got.n_docs_trained == m.n_docs_trained
    if shape == (1, 1):
        np.testing.assert_array_equal(got.lam, one.lam)
    sds = port.parallel.device_dataset(x, mesh=mesh)
    np.testing.assert_array_equal(port.LDA(k=3, max_iter=8, seed=0).fit(sds).lam, got.lam)
    mix = got.transform(x[:40], mesh)
    np.testing.assert_array_equal(mix, got.transform(x[:40], device="cpu"))


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
@pytest.mark.parametrize("block", [64, 300])
def test_lda_out_of_core_over_the_mesh(shape, block):
    """Each streamed block over the mesh's shards; the block size rounded
    to the data axis (the reference's ``block_shape(mesh)``), so the fit
    takes the JAX fit's blocks in the JAX fit's order."""
    x = _topic_docs(4)
    got = port.LDA(k=3, max_iter=7, seed=0).fit(port.HostDataset(x=x, max_device_rows=block),
                                                mesh=_mesh(shape))
    ref = J.LDA(k=3, max_iter=7, seed=0).fit(J.HostDataset(x=x, max_device_rows=block),
                                             mesh=_jmesh(shape))
    assert _rel(got.lam, ref.lam) <= LAM
    assert _top_terms(got) == _top_terms(ref)
    assert got.n_docs_trained == ref.n_docs_trained
    one = port.LDA(k=3, max_iter=7, seed=0).fit(port.HostDataset(x=x, max_device_rows=block),
                                                mesh=_mesh((1, 1)))
    np.testing.assert_array_equal(
        one.lam, port.LDA(k=3, max_iter=7, seed=0).fit(
            port.HostDataset(x=x, max_device_rows=block), device="cpu").lam)


def test_lda_refuses_a_negative_count_on_any_shard():
    x = _topic_docs(n=64)
    x[63, 2] = -1.0
    with pytest.raises(ValueError, match="non-negative"):
        port.LDA(k=2).fit(x, mesh=_mesh((8, 1)))
    with pytest.raises(ValueError, match="not both"):
        port.LDA(k=2).fit(np.abs(x), mesh=_mesh((8, 1)), device="cpu")


# ----------------------------------------------------------------------- PIC
def _knn_graph(n=401, k=8, seed=0, c=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 4, (c, 3))[rng.integers(0, c, n)] + rng.normal(size=(n, 3))
    d2 = ((x[:, None] - x[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    src = np.repeat(np.arange(n), k)
    dst = np.argsort(d2, 1)[:, :k].ravel()
    dist = np.sqrt(d2[src, dst])
    return src, dst, np.exp(-dist ** 2 / (2 * np.median(dist) ** 2))


def _same_partition(a, b) -> bool:
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("init_mode", ["random", "degree"])
def test_pic_over_the_mesh(shape, init_mode):
    """The power iteration on the mesh's first device; the KMeans on the
    (n, 1) embedding fits and predicts over the mesh (K1 and K2 once a
    shard on the card)."""
    src, dst, w = _knn_graph()
    est = {"k": 4, "max_iter": 20, "init_mode": init_mode, "seed": 0}
    got = port.PowerIterationClustering(**est).assign_clusters(src, dst, w, _mesh(shape))
    one = port.PowerIterationClustering(**est).assign_clusters(src, dst, w, device="cpu")
    ref = J.PowerIterationClustering(**est).assign_clusters(src, dst, w, mesh=_jmesh(shape))
    assert got.dtype == np.int64 and got.shape == one.shape
    assert _same_partition(got, one)
    assert _same_partition(got, np.asarray(ref))
    if shape == (1, 1):
        np.testing.assert_array_equal(got, one)
    with pytest.raises(ValueError, match="not both"):
        port.PowerIterationClustering(**est).assign_clusters(src, dst, w, _mesh(shape),
                                                             device="cpu")


# ----------------------------------------------------------------------- ALS
def _synth(seed=0, n_u=61, n_i=43, f=4, frac=0.35):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n_u, f))
    v = rng.normal(size=(n_i, f))
    mask = rng.uniform(size=(n_u, n_i)) < frac
    uu, ii = np.nonzero(mask)
    rr = ((u @ v.T)[uu, ii] + 0.05 * rng.normal(size=len(uu))).astype(np.float32)
    return uu, ii, rr


def _skewed(seed=1, n_u=300, n_i=50, nnz=4000):
    """Zipf-popular items and heavy users: buckets of fewer rows than data
    shards (solved once on the home device) beside split ones."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_i + 1) ** 1.1
    ii = rng.choice(n_i, nnz, p=p / p.sum())
    uu = np.minimum(rng.zipf(1.5, nnz) - 1, n_u - 1)
    pairs = np.unique(uu * n_i + ii)
    uu, ii = pairs // n_i, pairs % n_i
    return uu, ii, rng.normal(3.0, 1.0, len(uu)).astype(np.float32)


def _heavy(seed=3, f=2):
    """The reference's skewed end-to-end shape: one user with 110 ratings
    beside 200 users with 3 each, so the widest buckets hold fewer rows
    than data shards."""
    gen = np.random.default_rng(seed)
    u = gen.normal(size=(201, f))
    v = gen.normal(size=(120, f))
    uu = np.concatenate([np.zeros(110, np.int64), np.repeat(np.arange(1, 201), 3)])
    ii = np.concatenate([gen.choice(120, 110, replace=False), gen.integers(0, 120, size=600)])
    pairs = np.unique(uu * 120 + ii)
    uu, ii = pairs // 120, pairs % 120
    return uu, ii, ((u @ v.T)[uu, ii] + 0.05 * gen.normal(size=len(uu))).astype(np.float32)


ALS_CASES = {"explicit": {}, "implicit": {"implicit_prefs": True},
             "nnls": {"nonnegative": True}}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", sorted(ALS_CASES))
@pytest.mark.parametrize("data", [_synth, _skewed, _heavy])
def test_als_sharded_buckets_equal_one_device(data, case, shape):
    uu, ii, rr = data()
    kw = {"rank": 4, "max_iter": 4, "seed": 1, **ALS_CASES[case]}
    if kw.get("implicit_prefs") or kw.get("nonnegative"):
        rr = np.abs(rr)
    got = port.ALS(**kw).fit((uu, ii, rr), mesh=_mesh(shape))
    one = port.ALS(**kw).fit((uu, ii, rr), device="cpu")
    np.testing.assert_array_equal(got.user_factors, one.user_factors)
    np.testing.assert_array_equal(got.item_factors, one.item_factors)
    ref = J.ALS(**kw).fit((uu, ii, rr), mesh=_jmesh(shape))
    want = ref.predict(uu, ii)
    assert float(np.abs(got.predict(uu, ii) - want).max()) <= FIT * float(np.abs(want).max())


def test_als_buckets_split_over_the_data_axis():
    """A bucket of at least D rows is zero-padded to the data axis and
    split, one contiguous part a shard; a smaller one stays whole on the
    home device."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models import als

    uu, ii, rr = _heavy()
    buckets = als._group_ratings_bucketed(uu, ii, rr, int(uu.max()) + 1)
    staged = als._stage_buckets(buckets, torch.device("cpu"), _mesh((8, 1)))
    assert len(staged) == len(buckets)
    for (rows, *_), (r, parts) in zip(buckets, staged):
        assert torch.equal(r, torch.from_numpy(rows.astype(np.int64)))
        if rows.size < 8:
            assert list(parts) == [None]
        else:
            assert sorted(parts) == list(range(8))
            per = -(-rows.size // 8)
            assert {p[0].shape[0] for p in parts.values()} == {per}
    assert any(r.numel() < 8 for r, _ in staged) and any(r.numel() >= 8 for r, _ in staged)


# ------------------------------------------------------------- fused SQL route
QUERY = (
    "SELECT admission_count, current_occupancy, emergency_visits, seasonality_index,"
    " (emergency_visits / (admission_count + 1)) AS er_ratio, length_of_stay, los_days"
    " FROM events WHERE event_time BETWEEN"
    " '2025-03-31 22:00:00' AND '2025-03-31 23:55:00'"
)
FEATS = ("admission_count", "current_occupancy", "emergency_visits", "seasonality_index",
         "er_ratio")


def _columns(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    los = rng.gamma(3.0, 1.5, n)
    cols = {
        "hospital_id": np.array([f"H{i % 8:02d}" for i in range(n)], object),
        "event_time": (np.datetime64("2025-03-31T22:00:00")
                       + rng.integers(0, 7200, n).astype("timedelta64[s]")
                       ).astype("datetime64[ns]"),
        "admission_count": rng.integers(0, 50, n),
        "current_occupancy": rng.integers(10, 500, n),
        "emergency_visits": rng.integers(0, 30, n),
        "seasonality_index": rng.random(n),
        "length_of_stay": los,
        "los_days": np.floor(los),
    }
    cols["seasonality_index"][rng.random(n) < 0.03] = np.nan
    return cols


@pytest.fixture
def sessions():
    one = port.Session(device="cpu")
    mesh = port.Session(mesh=_mesh((8, 1)))
    for s in (one, mesh):
        s.register_table("events", port.Table.from_dict(_columns()))
    yield one, mesh
    for s in (mesh, one):         # last in, first out: each restores what it displaced
        s.stop()


def _rows_of(ds, n=None):
    if isinstance(ds, P.sharding.ShardedDataset):
        n = n or ds.n_padded
        return P.unpad(ds.x, n), P.unpad(ds.y, n), P.unpad(ds.w, n)
    n = n or ds.n_padded
    return ds.x[:n].numpy(), ds.y[:n].numpy(), ds.w[:n].numpy()


def test_fused_route_lays_its_rows_over_the_session_mesh(sessions):
    one, on_mesh = sessions
    a = one.sql_to_device(QUERY, feature_cols=FEATS, label_col="length_of_stay")
    b = on_mesh.sql_to_device(QUERY, feature_cols=FEATS, label_col="length_of_stay")
    assert psql.last_dispatch().route == "compiled"
    assert isinstance(b, P.sharding.ShardedDataset) and b.mesh.shape["data"] == 8
    assert b.n_padded == a.n_padded == 4000
    for u, v in zip(_rows_of(a), _rows_of(b)):
        np.testing.assert_array_equal(u, v)
    c = one.sql_to_device(QUERY, feature_cols=FEATS, label_col="length_of_stay",
                          mesh=_mesh((4, 2)))
    for u, v in zip(_rows_of(a), _rows_of(c)):
        np.testing.assert_array_equal(u, v)
    d = one.sql_to_device(QUERY, feature_cols=FEATS, label_col="length_of_stay",
                          mesh=_mesh((1, 1)))
    assert isinstance(d, port.DeviceDataset)
    for u, v in zip(_rows_of(a), _rows_of(d)):
        np.testing.assert_array_equal(u, v)


def test_compact_rows_over_the_mesh_equal_the_host_route(sessions):
    """``compact=True`` keeps exactly the valid rows, padded with weight-0
    rows to a multiple of the data axis (the port's ShardedDataset rule;
    the reference leaves such a dataset unsharded): ``==``
    ``to_device(mesh=)`` of the host route's rows, and so are the fits on
    them."""
    one, on_mesh = sessions
    mesh = on_mesh.mesh
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.sql_compile import (
        compile_rowlevel,
    )

    view = compile_rowlevel(QUERY, on_mesh.table, device=on_mesh.device)
    fused = port.VectorAssembler(FEATS).transform_device(view, label_col="los_days", mesh=mesh,
                                                         compact=True)
    host = on_mesh.sql_to_device(QUERY, feature_cols=FEATS, label_col="los_days",
                                 mode="interpret")
    assert isinstance(fused, P.sharding.ShardedDataset)
    assert isinstance(host, P.sharding.ShardedDataset)
    n = int(fused.count())
    assert n == int(host.count()) and fused.n_padded == host.n_padded
    assert fused.n_padded % 8 == 0 and fused.n_padded - n < 8
    for u, v in zip(_rows_of(fused), _rows_of(host)):
        np.testing.assert_array_equal(u, v)
    tree = dict(max_depth=3, seed=0)
    t1 = port.DecisionTreeRegressor(**tree).fit(fused)
    t2 = port.DecisionTreeRegressor(**tree).fit(host)
    np.testing.assert_array_equal(t1.predict_numpy(_rows_of(host)[0], device="cpu"),
                                  t2.predict_numpy(_rows_of(host)[0], device="cpu"))
    lr, lrh = port.LinearRegression().fit(fused), port.LinearRegression().fit(host)
    np.testing.assert_array_equal(lr.coefficients.numpy(), lrh.coefficients.numpy())
    assert float(lr.intercept) == float(lrh.intercept)
    # against the one-device fit on the uncompacted rows: the fitted values
    # (the coefficients of an unrelated label are near 0 and ill-conditioned)
    lr1 = port.LinearRegression().fit(one.sql_to_device(QUERY, feature_cols=FEATS,
                                                        label_col="los_days"))
    x, _, w = _rows_of(host)
    x = x[w > 0]
    fit, fit1 = (x @ m.coefficients.numpy() + float(m.intercept) for m in (lr, lr1))
    assert float(np.abs(fit - fit1).max()) <= LR_TOL * float(np.abs(fit1).max())
