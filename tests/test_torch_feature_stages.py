"""Slice 5c's feature stages in the port against the JAX package's, on the
CPU, on the same seeded numpy inputs.

Tolerances, and why:
- the table stages (Bucketizer, QuantileDiscretizer, StringIndexer,
  OneHotEncoder, Imputer, IndexToString, SQLTransformer) are equal: the
  same host numpy (or the same float64 SQL) in both packages;
- every matrix stage on an ndarray is equal: both compute it in numpy,
  and the port's fits on a float64 matrix take exact min / max /
  quantiles of the same values; PCA on a matrix sits within 1e-12 of
  the JAX package's components (torch's float64 sums and Gram against
  numpy's, in another order);
- the fits on a DeviceDataset: min / max, the NaN-aware max |x| and the
  sampled quantiles are equal (no arithmetic, the same rows drawn);
  PCA's moments are float32 sums of the raw rows in another order (the
  port sums Σw·x in float64): float32 order noise of about √n·ε ≈ 2e-6
  relative in E[x²] (800 rows), which the covariance E[x²] − mean²
  amplifies by E[x²]/var (about 5 on the occupancy column) and an axis by
  λ/gap, so variances agree within 5e-5 relative and components within
  5e-5 (measured: 1.04e-5 and 2.5e-5);
- transforms of tensors / device arrays: within 2 float32 ulp relative
  (rtol 2.4e-7; XLA on the CPU fuses ``a*b + c`` into one rounding, torch
  rounds twice), and for PolynomialExpansion's and Normalizer's powers
  within 1e-6 relative (``pow`` of XLA against libm's);
- PCA's axes are compared as the reference's sign rule fixes them, and
  where two eigenvalues nearly tie, as the subspace they span (the
  projector C·Cᵀ of the tied pair), which rounding cannot rotate.
"""

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.parallel import (
    sharding as jsharding,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import data as pdata

torch.set_num_threads(1)

ULP2 = 2.4e-7
POW_RTOL = 1e-6
PCA_F32 = 5e-5


def _rows(n=600, seed=0):
    rng = np.random.default_rng(seed)
    return np.c_[rng.integers(0, 50, n), rng.integers(20, 400, n), rng.integers(0, 30, n),
                 rng.uniform(0.5, 1.5, n), rng.normal(size=n)].astype(np.float32)


def _tables(cols: dict):
    return J.Table.from_dict(cols), P.Table.from_dict(cols)


def _events(n=500, seed=3):
    rng = np.random.default_rng(seed)
    hosp = np.array([f"H{i:02d}" for i in rng.choice(5, n, p=[0.3, 0.3, 0.2, 0.1, 0.1])],
                    dtype=object)
    sea = rng.uniform(0.5, 1.5, n)
    occ = rng.integers(20, 400, n).astype(np.float64)
    sea[rng.random(n) < 0.05] = np.nan
    occ[rng.random(n) < 0.05] = np.nan
    return {"hospital_id": hosp, "admission_count": rng.integers(0, 50, n),
            "current_occupancy": occ, "seasonality_index": sea,
            "length_of_stay": rng.gamma(3.0, 1.5, n)}


def _same_table(a, b):
    assert list(a.columns) == list(b.columns)
    assert len(a) == len(b)
    for c in a.columns:
        x, y = np.asarray(a.column(c)), np.asarray(b.column(c))
        assert x.dtype == y.dtype, c
        if x.dtype.kind == "f":
            np.testing.assert_array_equal(x, y, err_msg=c)
        else:
            assert list(x) == list(y), c


def _datasets(x, w=None):
    """The same rows as a JAX DeviceDataset (8-device CPU mesh) and a port
    one on the CPU."""
    return (J.device_dataset(x, weights=w),
            P.device_dataset(x, device="cpu", weights=w))


def _valid(port_ds, jax_ds, n):
    return port_ds.x[:n].numpy(), np.asarray(jax_ds.x)[:n]


# ---------------------------------------------------------------- table stages

@pytest.mark.parametrize("mode", ["keep", "skip"])
def test_bucketizer_matches_jax(mode):
    v = np.r_[np.linspace(-5, 5, 41), np.nan, 5.0, -5.0]
    jt, pt = _tables({"v": v, "k": np.arange(len(v))})
    splits = (-5.0, -1.0, 0.0, 2.5, 5.0)
    jb = J.Bucketizer(splits, "v", "b", mode)
    pb = P.Bucketizer(splits, "v", "b", mode)
    _same_table(pb.transform(pt), jb.transform(jt))
    assert pb.num_buckets == jb.num_buckets == 4


def test_bucketizer_refuses_what_jax_refuses():
    jt, pt = _tables({"v": np.array([0.5, np.nan]), "o": np.array([9.0, 0.5])})
    for B, t in ((J.Bucketizer, jt), (P.Bucketizer, pt)):
        with pytest.raises(ValueError, match="NaN"):
            B((0.0, 0.5, 1.0), "v", "b").transform(t)
        with pytest.raises(ValueError, match="outside the split range"):
            B((0.0, 0.5, 1.0), "o", "b", "keep").transform(t)
        with pytest.raises(ValueError, match="strictly increasing"):
            B((0.0, 0.0, 1.0))
        with pytest.raises(ValueError, match=">=3 boundaries"):
            B((0.0, 1.0))
        with pytest.raises(ValueError, match="handle_invalid"):
            B((0.0, 0.5, 1.0), handle_invalid="drop")


@pytest.mark.parametrize("column", ["uniform", "skewed", "integers"])
def test_quantile_discretizer_matches_jax(column):
    rng = np.random.default_rng(5)
    v = {"uniform": rng.uniform(0, 10, 400),
         "skewed": np.where(rng.random(400) < 0.8, 0.0, rng.uniform(1, 2, 400)),
         "integers": rng.integers(0, 4, 400).astype(np.float64)}[column]
    v[::37] = np.nan
    jt, pt = _tables({"v": v})
    jm = J.QuantileDiscretizer(5, "v", "q", "keep").fit(jt)
    pm = P.QuantileDiscretizer(5, "v", "q", "keep").fit(pt)
    assert isinstance(pm, P.Bucketizer)
    assert tuple(pm.splits) == tuple(jm.splits)
    _same_table(pm.transform(pt), jm.transform(jt))


@pytest.mark.parametrize("mode", ["keep", "skip"])
def test_string_indexer_matches_jax(mode):
    # ties in frequency (H02 / H03, H04 / H05) break lexicographically
    train = np.array(["H01"] * 5 + ["H03"] * 3 + ["H02"] * 3 + ["H05"] + ["H04"], dtype=object)
    test = np.array(["H02", "H09", "H01", "H04"], dtype=object)
    jm = J.StringIndexer("h", "code", mode).fit(J.Table.from_dict({"h": train}))
    pm = P.StringIndexer("h", "code", mode).fit(P.Table.from_dict({"h": train}))
    assert pm.labels == jm.labels == ("H01", "H02", "H03", "H04", "H05")
    jt, pt = _tables({"h": test, "i": np.arange(4)})
    _same_table(pm.transform(pt), jm.transform(jt))
    with pytest.raises(ValueError, match="unseen label"):
        P.StringIndexerModel("h", "c", pm.labels).transform(pt)


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("mode", ["error", "keep"])
def test_one_hot_encoder_matches_jax(drop_last, mode):
    rng = np.random.default_rng(6)
    train = {"a": rng.integers(0, 4, 50), "b": rng.integers(0, 3, 50)}
    jm = J.OneHotEncoder(["a", "b"], drop_last=drop_last, handle_invalid=mode).fit(
        J.Table.from_dict(train))
    pm = P.OneHotEncoder(["a", "b"], drop_last=drop_last, handle_invalid=mode).fit(
        P.Table.from_dict(train))
    assert (pm.output_cols, pm.category_sizes) == (jm.output_cols, jm.category_sizes)
    test = {"a": np.r_[rng.integers(0, 4, 20), 7] if mode == "keep" else rng.integers(0, 4, 21),
            "b": rng.integers(0, 3, 21)}
    jt, pt = _tables(test)
    _same_table(pm.transform(pt), jm.transform(jt))
    with pytest.raises(ValueError, match="no 'skip'"):
        P.OneHotEncoder(["a"], handle_invalid="skip")


@pytest.mark.parametrize("strategy", ["mean", "median", "mode"])
@pytest.mark.parametrize("sentinel", [False, True])
def test_imputer_matches_jax(strategy, sentinel):
    cols = _events()
    mv = float("nan")
    if sentinel:
        cols["admission_count"] = cols["admission_count"].astype(np.float64)
        cols["admission_count"][::9] = -1.0
        mv = -1.0
    jt, pt = _tables(cols)
    ins = ["admission_count", "current_occupancy", "seasonality_index"]
    outs = [f"{c}_f" for c in ins]
    jm = J.Imputer(ins, outs, strategy, mv).fit(jt)
    pm = P.Imputer(ins, outs, strategy, mv).fit(pt)
    assert pm.surrogates == jm.surrogates
    _same_table(pm.transform(pt), jm.transform(jt))


def test_index_to_string_matches_jax():
    labels = ("H01", "H02", "H00")
    jt, pt = _tables({"code": np.array([2, 0, 1, 1])})
    _same_table(P.IndexToString("code", "h", labels).transform(pt),
                J.IndexToString("code", "h", labels).transform(jt))
    with pytest.raises(ValueError, match="has no label"):
        P.IndexToString("code", "h", labels[:2]).transform(pt)


@pytest.mark.parametrize("statement", [
    "SELECT *, (admission_count + current_occupancy) AS total FROM __THIS__",
    "SELECT hospital_id, seasonality_index * 2 AS s2 FROM __THIS__ WHERE admission_count > 20",
    "SELECT hospital_id, COUNT(*) AS n, AVG(length_of_stay) AS los FROM __THIS__ "
    "GROUP BY hospital_id",
])
def test_sql_transformer_matches_jax(statement):
    jt, pt = _tables(_events())
    want = J.SQLTransformer(statement).transform(jt)
    got = P.SQLTransformer(statement).transform(pt, device="cpu")
    # the aggregate's float64 sums add in another order on the compiled route
    if "GROUP BY" in statement:
        assert list(got.columns) == list(want.columns)
        for c in want.columns:
            x, y = got.column(c), want.column(c)
            if x.dtype.kind == "f":
                np.testing.assert_allclose(x, y, rtol=1e-12)
            else:
                assert list(x) == list(y)
    else:
        _same_table(got, want)
    assert P.SQLTransformer(statement).explain(pt)["route"] == \
        J.SQLTransformer(statement).explain(jt)["route"]


# --------------------------------------------------------------- matrix stages

def test_sample_valid_rows_draws_the_jax_rows():
    x = _rows(3000)
    w = np.ones(len(x), np.float32)
    w[::7] = 0.0
    jds, pds = _datasets(x, w)
    for size in (50, 2000, 5000):
        want = jsharding.sample_valid_rows(jds, size, seed=0)
        got = pdata.sample_valid_rows(pds, size, seed=0)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("on", ["ndarray", "dataset"])
def test_min_max_scaler_matches_jax(on):
    x = _rows()
    x[:, 4] = 3.0                          # a constant column → the midpoint
    jds, pds = _datasets(x)
    jdata, pdata_ = (x, x) if on == "ndarray" else (jds, pds)
    jm = J.MinMaxScaler(-1.0, 2.0).fit(jdata)
    pm = P.MinMaxScaler(-1.0, 2.0).fit(pdata_, device="cpu")
    for a in ("data_min", "data_max"):
        assert np.asarray(getattr(pm, a)).dtype == np.asarray(getattr(jm, a)).dtype
        np.testing.assert_array_equal(getattr(pm, a), getattr(jm, a))
    np.testing.assert_array_equal(pm.transform(x), jm.transform(x))
    got, want = _valid(pm.transform(pds), jm.transform(jds), len(x))
    np.testing.assert_allclose(got, want, rtol=ULP2, atol=1e-7)
    assert np.all(got[:, 4] == 0.5)


@pytest.mark.parametrize("on", ["ndarray", "dataset"])
def test_max_abs_scaler_matches_jax_with_nan(on):
    x = _rows()
    x[:, 4] *= -3.0
    x[5, 1] = np.nan
    x[:, 2] = 0.0                          # an all-zero column stays zero
    jds, pds = _datasets(x)
    jdata, pdata_ = (x, x) if on == "ndarray" else (jds, pds)
    jm = J.MaxAbsScaler().fit(jdata)
    pm = P.MaxAbsScaler().fit(pdata_, device="cpu")
    np.testing.assert_array_equal(pm.max_abs, jm.max_abs)
    np.testing.assert_array_equal(pm.transform(x), jm.transform(x))
    with pytest.raises(ValueError, match="empty"):
        P.MaxAbsScaler().fit(np.zeros((0, 3)), device="cpu")


@pytest.mark.parametrize("on", ["ndarray", "dataset"])
@pytest.mark.parametrize("centering", [False, True])
def test_robust_scaler_matches_jax(on, centering):
    x = _rows(900)
    x[::31, 3] = np.nan
    w = np.ones(len(x), np.float32)
    w[::5] = 0.0
    jds, pds = _datasets(x, w)
    jdata, pdata_ = (x, x) if on == "ndarray" else (jds, pds)
    kw = {"lower": 0.1, "upper": 0.8, "with_centering": centering, "sample_size": 256}
    jm = J.RobustScaler(**kw).fit(jdata)
    pm = P.RobustScaler(**kw).fit(pdata_, device="cpu")
    np.testing.assert_array_equal(pm.median, jm.median)
    np.testing.assert_array_equal(pm.iqr, jm.iqr)
    np.testing.assert_array_equal(pm.transform(x), jm.transform(x))
    got, want = _valid(pm.transform(pds), jm.transform(jds), len(x))
    np.testing.assert_allclose(got, want, rtol=ULP2, atol=1e-7, equal_nan=True)


def _same_axes(pc, jc, evals, tol):
    """Components equal under the sign rule, but a nearly tied pair (within
    1e-3 relative) compared as the subspace it spans."""
    k, i = pc.shape[1], 0
    while i < k:
        j = i + 1
        while j < k and abs(evals[j] - evals[j - 1]) <= 1e-3 * abs(evals[i]):
            j += 1
        if j - i == 1:
            np.testing.assert_allclose(pc[:, i], jc[:, i], atol=tol)
        else:
            np.testing.assert_allclose(pc[:, i:j] @ pc[:, i:j].T, jc[:, i:j] @ jc[:, i:j].T,
                                       atol=tol)
        i = j


@pytest.mark.parametrize("on", ["ndarray", "dataset"])
@pytest.mark.parametrize("tied", [False, True])
def test_pca_matches_jax(on, tied):
    rng = np.random.default_rng(8)
    if tied:
        # two directions of exactly equal sample spread: the axes inside
        # their plane are rounding's choice, the plane is not
        z = rng.normal(size=(800, 4))
        q = np.linalg.qr(z - z.mean(axis=0))[0] * np.sqrt(799.0)
        z = q * np.array([3.0, 2.0, 2.0, 0.5])
        x = (z @ np.linalg.qr(rng.normal(size=(4, 4)))[0]).astype(np.float32) + 10.0
    else:
        x = _rows(800)
    jds, pds = _datasets(x)
    jdata, pdata_ = (x, x) if on == "ndarray" else (jds, pds)
    jm = J.PCA(3).fit(jdata)
    pm = P.PCA(3).fit(pdata_, device="cpu")
    tol = 1e-12 if on == "ndarray" else PCA_F32
    np.testing.assert_allclose(pm.mean, jm.mean, rtol=tol)
    np.testing.assert_allclose(pm.explained_variance, jm.explained_variance, rtol=tol)
    _same_axes(pm.components, jm.components, jm.explained_variance, tol)
    # the sign rule: each axis's largest |loading| is positive
    c = pm.components
    assert np.all(c[np.argmax(np.abs(c), axis=0), np.arange(3)] > 0)
    if not tied:
        got, want = _valid(pm.transform(pds), jm.transform(jds), len(x))
        np.testing.assert_allclose(got, want, rtol=PCA_F32, atol=PCA_F32 * np.abs(want).max())
        assert torch.all(pm.transform(pds).x[len(x):] == 0)
    with pytest.raises(ValueError, match="k must be"):
        P.PCA(9).fit(x, device="cpu")


@pytest.mark.parametrize("p", [1.0, 2.0, 3.0, float("inf")])
def test_normalizer_matches_jax(p):
    x = _rows()
    x[3] = 0.0                               # a zero row stays zero
    jds, pds = _datasets(x)
    np.testing.assert_array_equal(P.Normalizer(p).transform(x), J.Normalizer(p).transform(x))
    got, want = _valid(P.Normalizer(p).transform(pds), J.Normalizer(p).transform(jds), len(x))
    np.testing.assert_allclose(got, want, rtol=POW_RTOL if p == 3.0 else ULP2, atol=1e-8)


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_polynomial_expansion_matches_jax(degree):
    x = _rows()[:, :3]
    jds, pds = _datasets(x)
    pe, je = P.PolynomialExpansion(degree), J.PolynomialExpansion(degree)
    got = pe.transform(x)
    assert got.shape[1] == pe.num_outputs(3) == je.num_outputs(3)
    np.testing.assert_array_equal(got, je.transform(x))
    got, want = _valid(pe.transform(pds), je.transform(jds), len(x))
    np.testing.assert_allclose(got, want, rtol=POW_RTOL)


@pytest.mark.parametrize("stage", ["slicer", "product", "interaction"])
def test_vector_ops_match_jax(stage):
    x = _rows()
    make = {"slicer": lambda m: m.VectorSlicer((4, 0, 2)),
            "product": lambda m: m.ElementwiseProduct((1.0, 0.5, -2.0, 3.0, 0.25)),
            "interaction": lambda m: m.Interaction((0, 1), (2, 3, 4))}[stage]
    ps, js = make(P), make(J)
    np.testing.assert_array_equal(ps.transform(x), js.transform(x))
    jds, pds = _datasets(x)
    got, want = _valid(ps.transform(pds), js.transform(jds), len(x))
    np.testing.assert_allclose(got, want, rtol=ULP2)
    names = [f"c{j}" for j in range(5)]
    cols = {n: x[:, j] for j, n in enumerate(names)}
    pa = ps.transform(P.VectorAssembler(names).transform(P.Table.from_dict(cols)))
    ja = js.transform(J.VectorAssembler(names).transform(J.Table.from_dict(cols)))
    assert pa.feature_cols == ja.feature_cols
    np.testing.assert_array_equal(pa.features, ja.features)


def test_matrix_stages_keep_their_container():
    x = _rows(40)
    names = [f"c{j}" for j in range(5)]
    asm = P.VectorAssembler(names).transform(P.Table.from_dict({n: x[:, j] for j, n in
                                                                enumerate(names)}))
    ds = P.device_dataset(x, device="cpu")
    for est in (P.MinMaxScaler(), P.MaxAbsScaler(), P.RobustScaler(), P.PCA(2)):
        assert isinstance(est.fit_transform(asm, device="cpu"), P.AssembledTable)
        out = est.fit_transform(ds)
        assert isinstance(out, P.DeviceDataset) and out.x.device.type == "cpu"
        assert isinstance(est.fit(x, device="cpu").transform(torch.from_numpy(x)), torch.Tensor)
        assert isinstance(est.fit(x, device="cpu").transform(x), np.ndarray)
    for st in (P.Normalizer(), P.PolynomialExpansion(2), P.VectorSlicer((0,)),
               P.ElementwiseProduct((1.0,) * 5), P.Interaction((0,), (1,))):
        assert isinstance(st.transform(asm), P.AssembledTable)
        assert isinstance(st.transform(ds), P.DeviceDataset)


def test_stage_errors_match_jax():
    x = _rows(10)
    for m in (J, P):
        with pytest.raises(ValueError, match="out of range"):
            m.VectorSlicer((7,)).transform(x)
        with pytest.raises(ValueError, match="scaling_vec has"):
            m.ElementwiseProduct((1.0, 2.0)).transform(x)
        with pytest.raises(ValueError, match="negative index"):
            m.Interaction((-1,), (0,))
        with pytest.raises(ValueError, match="degree"):
            m.PolynomialExpansion(5)
        with pytest.raises(ValueError, match="p must be"):
            m.Normalizer(0.5)
        with pytest.raises(ValueError, match="lower < upper"):
            m.RobustScaler(lower=0.9, upper=0.1)


def test_device_dataset_count_matches_jax():
    x = _rows(37)
    w = np.linspace(0, 2, 37).astype(np.float32)
    jds, pds = _datasets(x, w)
    assert float(pds.count()) == pytest.approx(float(np.asarray(jds.count())), rel=1e-7)
    assert pds.count().shape == ()
