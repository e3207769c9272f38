"""The device-data feature stages, ``stat/``, the selectors and the
one-device placements over a (data, model) mesh: the port's sharded
moments (``ops/reductions.py``), PCA, MinMaxScaler, MaxAbsScaler,
RobustScaler, VarianceThresholdSelector, the five ``stat/`` device entry
points, UnivariateFeatureSelector / ChiSqSelector, the silhouette's
fixed-order first pass and the farm / SQL column placements, against the
port's own single-device results and against the JAX package on
``tests/conftest.py``'s ``mesh8``, on the CPU, on the same seeded rows.

The port's meshes are over ``[torch.device("cpu")] * 8`` at (1, 1),
(8, 1) and (4, 2).

Tolerances, and why:
- a (1, 1) mesh is the single-device path: ``==`` everywhere;
- count, min, max and nnz are exact reductions (a count of 0/1 weights is
  an integer sum below 2**24), so they are ``==`` on every mesh shape, and
  so are MinMax's and MaxAbs's extremes, Robust's sample (the one-device
  draw over the valid rows' global indices, then the same host
  quantiles), the selectors' chosen indices and the KS statistic (one
  sort of the gathered values);
- the float sums (n, s1, s2, xtx, l1) add their shards' float32 (s1:
  float64) sums in ascending shard order, where one device sums per chunk
  of rows: within REL = 1e-6 relative of one device and of the JAX
  package on mesh8, the tolerance of ``tests/test_torch_stat.py``;
- PCA's mean and spectrum within PCA_F32 = 5e-5 (``test_torch_feature_
  stages.py``'s float32-moment tolerance), its axes compared as there;
- ANOVA and FValue F-values within F_RTOL = 1e-5 relative (the centred
  float32 sums of ``test_torch_stat.py``), their p-values within the
  selector tests' P_RTOL / P_ATOL, and Correlation within CORR_TOL =
  1e-5 on well-scaled columns;
- the silhouette within SIL = 1e-5 of the JAX package (PERF.md §2's limit
  for the metric); its one-hot first pass adds chunks in a fixed order, so
  one device and a (1, 1) mesh are ``==``.
"""

import inspect

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.ops import reductions as jred
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.evaluation import (
    classification as pcls,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.evaluation import (
    clustering as pclu,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import reductions as pred

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
SHAPES = [(1, 1), (8, 1), (4, 2)]
REL = 1e-6
PCA_F32 = 5e-5
F_RTOL = 1e-5
CORR_TOL = 1e-5
P_RTOL, P_ATOL = 1e-4, 1e-12
SIL = 1e-5


def _mesh(shape):
    return P.build_mesh(port.MeshConfig(data=shape[0], model=shape[1]), CPU8)


def _rows(n=1003, seed=0):
    """Integer, bounded, float and near-constant columns, 10 % zeros in the
    first; n is not a multiple of 8, so the shards carry weight-0 pad rows."""
    rng = np.random.default_rng(seed)
    x = np.c_[rng.normal(size=n), rng.poisson(3.0, n), rng.uniform(50, 400, n),
              rng.integers(0, 30, n), rng.normal(size=n) * 0.5 + 2.0].astype(np.float32)
    x[rng.random(n) < 0.1, 0] = 0.0
    return x


def _weights(n, seed=1):
    w = np.ones(n, np.float32)
    w[np.random.default_rng(seed).random(n) < 0.1] = 0.0
    return w


def _one(x, w=None):
    return port.device_dataset(x, device="cpu", weights=w)


def _on(x, shape, w=None):
    return port.parallel.device_dataset(x, mesh=_mesh(shape), weights=w)


# ------------------------------------------------------------------ moments
@pytest.mark.parametrize("shape", SHAPES)
def test_moments_over_the_shards(shape):
    x, w = _rows(), _weights(1003)
    one = _one(x, w)
    ds = _on(x, shape, w)
    got = pred.host_moments(ds.x, ds.w)
    want = pred.host_moments(one.x, one.w)
    ref = jred.host_moments(J.device_dataset(x, weights=w).x, J.device_dataset(x, weights=w).w)
    assert set(got) == set(want) == set(ref)
    for k in ("min", "max", "count", "nnz"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in ("n", "s1", "s2", "xtx", "l1"):
        np.testing.assert_allclose(got[k], want[k], rtol=REL, err_msg=k)
        np.testing.assert_allclose(got[k], ref[k], rtol=REL, err_msg=k)
    if shape == (1, 1):
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ----------------------------------------------------------- feature stages
def _assembled(x):
    cols = {f"c{j}": x[:, j] for j in range(x.shape[1])}
    names = list(cols)
    return (J.VectorAssembler(names).transform(J.Table.from_dict(cols)),
            port.VectorAssembler(names).transform(port.Table.from_dict(cols)))


def _sharded_rows(out, n) -> np.ndarray:
    assert isinstance(out, (port.DeviceDataset, P.sharding.ShardedDataset))
    return P.unpad(out.x, n) if isinstance(out, P.sharding.ShardedDataset) else out.x[:n].numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("stage", ["minmax", "maxabs", "robust"])
def test_scalers_fit_over_the_mesh_equal_one_device(stage, shape):
    """Exact reductions and the one-device sample: ``==`` one device and
    the JAX package's fit on mesh8; the transform maps each shard where it
    lies (pad rows stay zero)."""
    x, w = _rows(), _weights(1003)
    x[5, 2] = np.nan
    make = {"minmax": lambda pkg: pkg.MinMaxScaler(-1.0, 2.0),
            "maxabs": lambda pkg: pkg.MaxAbsScaler(),
            "robust": lambda pkg: pkg.RobustScaler(lower=0.1, upper=0.8, sample_size=256)}[stage]
    attrs = {"minmax": ("data_min", "data_max"), "maxabs": ("max_abs",),
             "robust": ("median", "iqr")}[stage]
    if stage == "minmax":
        x[5, 2] = 7.0          # a NaN poisons the masked extremes in both packages
    ds = _on(x, shape, w)
    got = make(port).fit(ds)
    one = make(port).fit(_one(x, w), device="cpu")
    ref = make(J).fit(J.device_dataset(x, weights=w))
    for a in attrs:
        np.testing.assert_array_equal(getattr(got, a), getattr(one, a), err_msg=a)
        np.testing.assert_array_equal(getattr(got, a), np.asarray(getattr(ref, a)), err_msg=a)
    out = got.transform(ds)
    assert type(out) is type(ds)
    valid = w > 0
    np.testing.assert_array_equal(_sharded_rows(out, len(x))[valid],
                                  got.transform(_one(x, w)).x[: len(x)].numpy()[valid])


@pytest.mark.parametrize("shape", SHAPES)
def test_pca_over_the_mesh(shape):
    x = _rows()
    jt, pt = _assembled(x)
    got = port.PCA(3).fit(pt, mesh=_mesh(shape))
    one = port.PCA(3).fit(pt, device="cpu")
    ref = J.PCA(3).fit(J.device_dataset(x))
    for m in (one, ref):
        np.testing.assert_allclose(got.mean, np.asarray(m.mean), rtol=PCA_F32)
        np.testing.assert_allclose(got.explained_variance, np.asarray(m.explained_variance),
                                   rtol=PCA_F32)
        np.testing.assert_allclose(np.abs(got.components.T @ np.asarray(m.components)),
                                   np.eye(3), atol=PCA_F32)
    if shape == (1, 1):
        assert np.array_equal(got.components, one.components)
        assert np.array_equal(got.mean, one.mean)
    ds = _on(x, shape)
    np.testing.assert_allclose(_sharded_rows(got.transform(ds), len(x)),
                               got.transform(x.astype(np.float64)), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_variance_threshold_over_the_mesh(shape):
    x = _rows()
    x[:, 4] = 3.0
    jt, pt = _assembled(x)
    for thr in (0.0, 1.0):
        got = port.VarianceThresholdSelector(thr).fit(pt, mesh=_mesh(shape))
        one = port.VarianceThresholdSelector(thr).fit(pt, device="cpu")
        ref = J.VarianceThresholdSelector(thr).fit(jt)
        assert got.selected == one.selected == ref.selected
    ds = _on(x, shape)
    out = got.transform(ds)
    assert out.n_features == len(got.selected)
    np.testing.assert_array_equal(_sharded_rows(out, len(x)), x[:, list(got.selected)])


@pytest.mark.parametrize("stage", ["pca", "minmax", "maxabs", "robust", "standard"])
def test_device_stages_run_inside_a_pipeline_over_the_mesh(stage):
    """A device-data stage behind an assembler fits over the pipeline's
    mesh and transforms shard by shard; the (8, 1) fit equals the
    one-device fit where its statistic is exact, else within PCA_F32."""
    x = _rows(400)
    _, pt = _assembled(x)
    names = pt.feature_cols
    make = {"pca": lambda: port.PCA(k=2), "minmax": port.MinMaxScaler,
            "maxabs": port.MaxAbsScaler, "robust": port.RobustScaler,
            "standard": port.StandardScaler}[stage]
    table = port.Table.from_dict({n: x[:, j] for j, n in enumerate(names)})
    stages = [port.VectorAssembler(list(names)), make()]
    pm = port.Pipeline(stages).fit(table, mesh=_mesh((8, 1)))
    one = port.Pipeline(stages).fit(table, device="cpu")
    art, art1 = pm.stages[1]._artifacts(), one.stages[1]._artifacts()
    assert art[0] == art1[0]
    for k, v in art[2].items():
        if stage in ("pca", "standard"):
            np.testing.assert_allclose(np.asarray(v), np.asarray(art1[2][k]), rtol=PCA_F32,
                                       atol=PCA_F32, err_msg=k)
        else:
            np.testing.assert_array_equal(np.asarray(v), np.asarray(art1[2][k]), err_msg=k)


def test_host_input_stage_runs_on_the_meshs_first_device(monkeypatch):
    """A stage that takes only ``device=`` (Word2Vec's host tokens) runs
    on the mesh's first device inside a pipeline, where the reference runs
    it unsharded, even over a mesh of more than one shard."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.pipeline import (
        ml_pipeline,
    )

    seen = []

    def fit(data, device=None):
        seen.append(device)
        return data

    ml_pipeline._call_stage(fit, None, None, _mesh((8, 1)))
    assert seen == [torch.device("cpu")]


# ---------------------------------------------------------------------- stat
def _labelled(n=1003, seed=2):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, size=n).astype(np.float32)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    x[:, 1] += y
    x[:, 3] += 0.2 * y + 5.0
    t = (x @ np.array([1.0, -0.5, 0.3, 0.1]) + rng.normal(size=n)).astype(np.float32)
    return x, y, t


@pytest.mark.parametrize("shape", SHAPES)
def test_summarizer_and_correlation_over_the_mesh(shape):
    x, w = _rows(), _weights(1003)
    mesh = _mesh(shape)
    ds = _on(x, shape, w)
    got = port.stat.Summarizer.summary(ds, mesh)
    via = port.stat.Summarizer.summary((x, np.zeros(len(x), np.float32), w), mesh)
    one = port.stat.Summarizer.summary(_one(x, w), device="cpu")
    ref = J.stat.Summarizer.summary((x, np.zeros(len(x)), w))
    for f in ("min", "max", "count", "num_non_zeros", "weight_sum"):
        np.testing.assert_array_equal(getattr(got, f), getattr(one, f), err_msg=f)
        np.testing.assert_array_equal(getattr(got, f), getattr(via, f), err_msg=f)
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(ref, f)), err_msg=f)
    # a variance is formed as s2/n − mean²: held within REL of mean² + variance
    scale = {"variance": REL * (one.mean ** 2 + one.variance)}
    for f in ("mean", "variance", "norm_l1", "norm_l2"):
        for m in (one, ref):
            gap = np.abs(getattr(got, f) - np.asarray(getattr(m, f), np.float64))
            assert np.all(gap <= scale.get(f, REL * np.abs(getattr(one, f)))), f
    xs, _, _ = _labelled()
    c = port.stat.Correlation.corr(xs, "pearson", mesh)
    np.testing.assert_allclose(c, port.stat.Correlation.corr(xs, device="cpu"), atol=CORR_TOL)
    np.testing.assert_allclose(c, J.stat.Correlation.corr(xs, "pearson"), atol=CORR_TOL)
    s = port.stat.Correlation.corr(xs, "spearman", mesh)
    np.testing.assert_array_equal(s, port.stat.Correlation.corr(xs, "spearman", device="cpu"))
    if shape == (1, 1):
        for f in ("mean", "variance", "norm_l1", "norm_l2"):
            np.testing.assert_array_equal(getattr(got, f), getattr(one, f), err_msg=f)


@pytest.mark.parametrize("shape", SHAPES)
def test_ks_gathers_the_valid_values_for_one_sort(shape):
    v = np.random.default_rng(3).normal(0.2, 1.1, 1003).astype(np.float32)
    w = _weights(1003, seed=4)
    got = port.stat.KolmogorovSmirnovTest.test((v[:, None], np.zeros(1003), w), "norm", 0.0,
                                               1.0, _mesh(shape))
    one = port.stat.KolmogorovSmirnovTest.test(_one(v[:, None], w), "norm", 0.0, 1.0,
                                               device="cpu")
    assert got.statistic == one.statistic and got.p_value == one.p_value
    ref = J.stat.KolmogorovSmirnovTest.test(J.device_dataset(v[:, None], weights=w), "norm",
                                            0.0, 1.0)
    np.testing.assert_allclose(got.statistic, ref.statistic, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("test", ["anova", "fvalue"])
def test_f_tests_over_the_mesh(test, shape):
    """ANOVA's one-hot sums and FValue's centred sums a shard, about the
    global means summed in shard order (never each shard's own)."""
    x, y, t = _labelled()
    lab = y if test == "anova" else t
    name = {"anova": "ANOVATest", "fvalue": "FValueTest"}[test]
    got = getattr(port.stat, name).test(x, lab, _mesh(shape))
    one = getattr(port.stat, name).test(x, lab, device="cpu")
    ref = getattr(J.stat, name).test(x, lab)
    for m in (one, ref):
        np.testing.assert_allclose(got.f_values, np.asarray(m.f_values), rtol=F_RTOL)
        np.testing.assert_allclose(got.p_values, np.asarray(m.p_values), rtol=P_RTOL,
                                   atol=P_ATOL)
        np.testing.assert_array_equal(got.degrees_of_freedom, np.asarray(m.degrees_of_freedom))
    if shape == (1, 1):
        np.testing.assert_array_equal(got.f_values, one.f_values)
    with pytest.raises(ValueError, match="labels"):
        getattr(port.stat, name).test(x, lab[:500], _mesh(shape))


def test_chi_square_stays_on_the_host():
    x, y, _ = _labelled()
    cat = np.floor(np.abs(x)).astype(np.float32)
    ds = _on(cat, (8, 1))
    yp = np.r_[y, np.zeros(ds.n_padded - len(y), np.float32)]
    got = port.stat.ChiSquareTest.test(ds, yp, device="cpu")
    one = port.stat.ChiSquareTest.test(cat, y, device="cpu")
    np.testing.assert_array_equal(got.statistics, one.statistics)
    np.testing.assert_array_equal(got.p_values, one.p_values)


# ----------------------------------------------------------------- selectors
def _selector_tables(seed=2):
    rng = np.random.default_rng(seed)
    n = 1000
    y = rng.integers(0, 3, size=n).astype(np.float64)
    x = rng.normal(size=(n, 6))
    x[:, 1] += y
    x[:, 4] += 2 * y
    x[:, 5] += 0.3 * y
    noisy = np.where(rng.random(n) < 0.3, rng.integers(0, 3, n), y).astype(np.float64)
    cols = {**{f"f{j}": x[:, j] for j in range(6)}, "cls": y, "c0": y.copy(), "c1": noisy,
            "c2": rng.integers(0, 5, n).astype(np.float64),
            "target": x @ np.arange(6) + rng.normal(size=n)}
    cont = [f"f{j}" for j in range(6)]
    cat = ["c0", "c1", "c2"]
    out = {}
    for name, fc in (("cont", cont), ("cat", cat)):
        out[name] = (J.VectorAssembler(fc).transform(J.Table.from_dict(cols)),
                     port.VectorAssembler(fc).transform(port.Table.from_dict(cols)))
    return out


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("test,mode,threshold", [
    ("anova", "numTopFeatures", 3), ("anova", "fpr", 0.05), ("fvalue", "percentile", 0.5),
    ("fvalue", "numTopFeatures", 2), ("chi2", "numTopFeatures", 2)])
def test_selectors_over_the_mesh_choose_what_one_device_chooses(test, mode, threshold, shape):
    tables = _selector_tables()
    ft, lt, label, which = {"anova": ("continuous", "categorical", "cls", "cont"),
                            "fvalue": ("continuous", "continuous", "target", "cont"),
                            "chi2": ("categorical", "categorical", "cls", "cat")}[test]
    ja, pa = tables[which]
    kw = dict(feature_type=ft, label_type=lt, selection_mode=mode,
              selection_threshold=threshold, label_col=label)
    got = port.UnivariateFeatureSelector(**kw).fit(pa, mesh=_mesh(shape))
    one = port.UnivariateFeatureSelector(**kw).fit(pa, device="cpu")
    ref = J.UnivariateFeatureSelector(**kw).fit(ja)
    assert got.selected == one.selected == ref.selected
    if test == "chi2":
        chi = port.ChiSqSelector(num_top_features=2, label_col=label).fit(pa, mesh=_mesh(shape))
        assert chi.selected == got.selected


def test_host_draw_stages_take_the_mesh():
    """VectorIndexer and the LSH families accept ``mesh`` and do their host
    work: the same models as without it."""
    x = _rows(200)
    _, pt = _assembled(np.round(x))
    mesh = _mesh((8, 1))
    a = port.VectorIndexer(max_categories=8).fit(pt, mesh=mesh)
    assert a._artifacts() == port.VectorIndexer(max_categories=8).fit(pt)._artifacts()
    for make in (lambda: port.BucketedRandomProjectionLSH(bucket_length=2.0, seed=3),
                 lambda: port.MinHashLSH(num_hash_tables=2, seed=3)):
        m, m1 = make().fit(x, mesh=mesh), make().fit(x)
        for k, v in m._artifacts()[2].items():
            np.testing.assert_array_equal(v, m1._artifacts()[2][k])


# --------------------------------------------------------- fixed-order sums
def test_silhouette_first_pass_has_a_fixed_order():
    """The first pass is one-hot products a chunk, added in chunk order: no
    ``index_add_`` (float atomics on the card), within SIL of the JAX
    package, one device ``==`` a (1, 1) mesh, (8, 1) within SIL of both."""
    assert "index_add_" not in inspect.getsource(pclu._cluster_stats)
    rng = np.random.default_rng(5)
    centers = rng.normal(0, 4, size=(5, 3))
    lab = rng.integers(0, 5, 2003)
    x = (centers[lab] + rng.normal(size=(2003, 3))).astype(np.float32)
    ev = port.ClusteringEvaluator()
    one = ev.evaluate(x, lab, k=5, device="cpu")
    mesh1 = ev.evaluate(x, lab, k=5, mesh=_mesh((1, 1)))
    mesh8 = ev.evaluate(x, lab, k=5, mesh=_mesh((8, 1)))
    ref = J.ClusteringEvaluator().evaluate(x, lab, k=5)
    assert one == mesh1
    assert abs(one - ref) <= SIL and abs(mesh8 - ref) <= SIL and abs(mesh8 - one) <= SIL


@pytest.mark.parametrize("chunk", [7, 1 << 16])
def test_silhouette_chunks_sum_what_a_scatter_sums(monkeypatch, chunk):
    """On integer rows and weights every chunking gives the scatter's exact
    sums (float32 sums of integers below 2**24)."""
    monkeypatch.setattr(pclu, "_SIL_CHUNK", chunk)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.integers(-9, 10, size=(301, 3)).astype(np.float32))
    a = torch.from_numpy(rng.integers(-1, 6, size=301).astype(np.int32))
    w = torch.from_numpy(rng.integers(0, 3, size=301).astype(np.float32))
    idx, wm, sq, packed = pclu._cluster_stats(x, a, w, 5)
    counts = torch.zeros(5).index_add_(0, idx, wm)
    ys = torch.zeros(5, 3).index_add_(0, idx, x * wm[:, None])
    psi = torch.zeros(5).index_add_(0, idx, sq * wm)
    assert torch.equal(packed, torch.cat([counts, ys.reshape(-1), psi]))


def test_confusion_has_one_path():
    """The one-device confusion matrix is the one-hot product a chunk, as
    the sharded one is: the scatter's counts on integer weights."""
    rng = np.random.default_rng(7)
    p = torch.from_numpy(rng.integers(-1, 5, 500))
    t = torch.from_numpy(rng.integers(0, 4, 500))
    w = torch.from_numpy(rng.integers(0, 3, 500).astype(np.float32))
    assert "index_add_" not in inspect.getsource(pcls.confusion)
    got = pcls.confusion(p, t, w, 4)
    want = torch.zeros(16).index_add_(0, t.clamp(0, 3) * 4 + p.clamp(0, 3), w)
    np.testing.assert_array_equal(got, want.reshape(4, 4).numpy())


# ------------------------------------------------------ one-device placements
def test_farm_and_sql_columns_place_through_the_partitioner():
    """``_place_stack`` and the SQL device column place through the
    partitioner's ``"farm"`` / ``"sql"`` families on the one-entry mesh of
    their device: the bits of a plain move."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.farm import farm

    arr = np.random.default_rng(8).normal(size=(3, 5, 2))
    got = farm._place_stack(arr, torch.device("cpu"))
    assert got.dtype == torch.float32 and torch.equal(got, torch.from_numpy(arr.astype(np.float32)))
    src = inspect.getsource(farm._place_stack)
    assert 'family("farm")' in src
    t = port.Table.from_dict({"a": np.arange(6, dtype=np.float64), "b": np.arange(6) * 2})
    col = t.device_column("a", torch.device("cpu"))
    assert torch.equal(col, torch.arange(6, dtype=torch.float64))
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import table

    assert 'family("sql")' in inspect.getsource(table)
