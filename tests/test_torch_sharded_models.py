"""The model stage's estimators over a (data, model) mesh: the port's
sharded LinearRegression, trees, GBT, GaussianMixture and
LogisticRegression against its own single-device fits and against the JAX
package's fits on the same mesh shape, on the CPU.

The port's meshes are over ``[torch.device("cpu")] * 8`` (each shard runs
K3's plain version); the JAX side runs on ``tests/conftest.py``'s 8
virtual CPU devices through ``build_mesh(MeshConfig(data=D, model=M))``.

Tolerances, and why:
- a (1, 1) mesh is the single-device path: ``==`` everywhere;
- integer-valued rows and labels: LinearRegression's sums and the trees'
  histograms are exact in float32 in any order, so the sharded fit
  ``==`` the single-device fit (the forest's bootstrap too: both draw
  over the same padded rows, a multiple of every data axis here); GBT's
  rounds past the first fit non-integer residuals, so its splits are
  ``==`` and its leaf values within 1e-4;
- against the JAX fit on the same mesh shape, the JAX package's own
  cross-process tolerances (``tests/test_distributed.py``): trees
  ``split_feat`` ``==``, thresholds 1e-6, values 1e-4; GMM means 1e-3,
  weights 1e-4, log-likelihood rtol 1e-4; the logistic coefficients 2e-3
  and intercepts 5e-3 (class-centred for the multinomial fit, whose
  intercepts drift along the softmax's null direction in both packages);
  LinearRegression within 1e-4 of the largest coefficient — float32 sums
  in another order;
- the forest's Poisson bootstrap: bit-equal to the JAX package's draw on
  the same mesh shape (one threefry stream over the global padded rows);
- a sharded ``transform`` of one model: class predictions ``==`` the
  single-device ones; real-valued predictions (GBT margins, logistic
  probabilities) within rtol 1e-6, because the CPU's matrix-vector
  products and reductions block by the row count and move the last bit;
  the evaluators' metrics at rtol 1e-5 (float32 sums of a few thousand
  rows in shard order), accuracy ``==`` (integer counts);
- the elastic net's ``n_iter`` is compared on the (1, 1) mesh only: its
  stop compares the step with tol 1e-6, which the shard-order sums move
  by one iteration on these rows.
"""

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.config import (
    MeshConfig as JMeshConfig,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.models.tree import engine as jeng
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models.tree import (
    engine as peng,
)

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
SHAPES = [(1, 1), (8, 1), (4, 2), (2, 4)]
N, D = 2400, 5


def _mesh(shape):
    return P.build_mesh(port.MeshConfig(data=shape[0], model=shape[1]), CPU8)


def _jmesh(shape):
    return J.parallel.build_mesh(JMeshConfig(data=shape[0], model=shape[1]))


def _ints(seed=0, n=N):
    """Integer-valued rows, an integer LOS label, a 0/1 and a 0..2 label."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-6, 7, size=(n, D)).astype(np.float32)
    y = np.clip(np.round(4 + 0.6 * x[:, 0] - 0.4 * x[:, 1] + rng.normal(size=n)), 0, 12)
    yb = (x[:, 0] + 0.5 * x[:, 2] + rng.normal(size=n) > 0).astype(np.float32)
    y3 = np.digitize(x[:, 0] + 0.7 * x[:, 3], [-2.0, 2.0]).astype(np.float32)
    return x, y.astype(np.float32), yb, y3


def _floats(seed=1, n=N):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D)).astype(np.float32) * np.float32(3.0)
    y = (x @ np.array([1.0, -2.0, 0.5, 0.0, 3.0]) + 0.25 + rng.normal(0, 0.3, n))
    return x, y.astype(np.float32)


def _blobs(seed=2, n=N):
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 5, size=(3, D))
    a = rng.integers(0, 3, n)
    return (c[a] + rng.normal(size=(n, D))).astype(np.float32), a.astype(np.float32)


# ------------------------------------------------------- LinearRegression
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("elastic", [False, True])
def test_linear_regression_over_the_mesh(shape, elastic):
    kw = dict(reg_param=0.1, elastic_net_param=0.5) if elastic else {}
    x, y = _floats()
    one = port.LinearRegression(**kw).fit((x, y), device="cpu")
    got = port.LinearRegression(**kw).fit((x, y), mesh=_mesh(shape))
    ref = J.LinearRegression(**kw).fit((x, y), mesh=_jmesh(shape))
    coef = np.asarray(ref.coefficients)
    scale = np.abs(coef).max()
    np.testing.assert_allclose(got.coefficients.numpy(), coef, atol=1e-4 * scale)
    assert abs(float(got.intercept) - float(ref.intercept)) <= 1e-4 * scale
    if shape == (1, 1):
        assert torch.equal(got.coefficients, one.coefficients)
        assert torch.equal(got.intercept, one.intercept)
    if elastic:
        if shape == (1, 1):
            assert got.fit_info == one.fit_info
    else:
        xi, yi, _, _ = _ints()
        a = port.LinearRegression().fit((xi, yi), device="cpu")
        b = port.LinearRegression().fit((xi, yi), mesh=_mesh(shape))
        assert torch.equal(a.coefficients, b.coefficients) and torch.equal(a.intercept,
                                                                           b.intercept)


@pytest.mark.parametrize("shape", SHAPES[1:])
def test_linear_summary_and_partials_over_the_mesh(shape):
    x, y = _floats()
    one = port.LinearRegression().fit((x, y), device="cpu")
    got = port.LinearRegression().fit((x, y), mesh=_mesh(shape))
    a, b = one.summary, got.summary
    assert b.num_instances == a.num_instances == N
    assert b.weight_sum == a.weight_sum
    np.testing.assert_allclose(b.r2, a.r2, rtol=1e-6)
    np.testing.assert_allclose(b.root_mean_squared_error, a.root_mean_squared_error, rtol=1e-5)
    np.testing.assert_allclose(b.coefficient_standard_errors, a.coefficient_standard_errors,
                               rtol=1e-4)
    np.testing.assert_allclose(b.t_values, a.t_values, rtol=1e-4)
    assert b.residuals.shape == (N,)
    xi, yi, _, _ = _ints()
    pa = port.LinearRegression().partial_fit_stats((xi, yi), device="cpu")
    pb = port.LinearRegression().partial_fit_stats((xi, yi), mesh=_mesh(shape))
    for key in ("sw", "sx", "sxx", "gram", "mom"):
        np.testing.assert_array_equal(pb.stats[key], pa.stats[key])


# ----------------------------------------------------------------- trees
TREES = {
    "DecisionTreeRegressor": ("y", dict(max_depth=4)),
    "DecisionTreeClassifier": ("yb", dict(max_depth=4)),
    "RandomForestRegressor": ("y", dict(num_trees=4, max_depth=4, seed=3)),
    "RandomForestClassifier": ("y3", dict(num_trees=4, max_depth=3, seed=5, num_classes=3)),
}


def _labels(name):
    x, y, yb, y3 = _ints()
    return x, {"y": y, "yb": yb, "y3": y3}[TREES[name][0]]


def _same_trees(a, b, value_atol: float):
    np.testing.assert_array_equal(a.split_feat, b.split_feat)
    np.testing.assert_allclose(a.threshold, b.threshold, atol=1e-6)
    np.testing.assert_allclose(a.value, b.value, atol=value_atol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", list(TREES))
def test_trees_over_the_mesh(shape, name):
    x, y = _labels(name)
    kw = TREES[name][1]
    one = getattr(port, name)(**kw).fit((x, y), device="cpu")
    got = getattr(port, name)(**kw).fit((x, y), mesh=_mesh(shape))
    # integer labels: every histogram sum is exact, so the shards' order
    # changes nothing
    for key in ("split_feat", "threshold", "value", "feature_importances"):
        np.testing.assert_array_equal(getattr(got, key), getattr(one, key), err_msg=key)
    ref = getattr(J, name)(**kw).fit((x, y), mesh=_jmesh(shape))
    _same_trees(got, ref, 1e-4)


@pytest.mark.parametrize("shape", SHAPES[1:])
@pytest.mark.parametrize("name", ["RandomForestRegressor", "DecisionTreeClassifier"])
def test_tree_transform_and_evaluators_over_the_mesh(shape, name):
    x, y = _labels(name)
    m = getattr(port, name)(**TREES[name][1]).fit((x, y), device="cpu")
    one = m.transform((x[:2001], y[:2001]), device="cpu")
    got = m.transform((x[:2001], y[:2001]), mesh=_mesh(shape))
    assert isinstance(got.prediction, P.MeshArray)
    np.testing.assert_array_equal(got.to_numpy()[0], one.to_numpy()[0])
    np.testing.assert_array_equal(got.to_numpy(2001)[1], one.to_numpy(2001)[1])
    if name.endswith("Classifier"):
        for metric in ("accuracy", "f1", "weightedPrecision"):
            ev = port.MulticlassClassificationEvaluator(metric)
            assert ev.evaluate(got) == ev.evaluate(one)
    else:
        for metric in ("rmse", "mse", "mae", "r2", "var"):
            ev = port.RegressionEvaluator(metric)
            np.testing.assert_allclose(ev.evaluate(got), ev.evaluate(one), rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_forest_bootstrap_is_the_jax_draw_on_the_same_mesh(shape, monkeypatch):
    n, T, rate, seed = 2403, 3, 0.8, 11          # padded rows on every data axis but 1
    rng = np.random.default_rng(4)
    x = rng.integers(0, 9, size=(n, D)).astype(np.float32)
    y = rng.integers(0, 4, n).astype(np.float32)
    seen = {}
    real = peng._level_loop

    def spy(sh, binned, base, w_tree, *a, **k):
        seen.update(w_tree)
        return real(sh, binned, base, w_tree, *a, **k)

    monkeypatch.setattr(peng, "_level_loop", spy)
    mesh = _mesh(shape)
    ds = P.device_dataset(x, y, mesh=mesh)
    kw = dict(task="regression", num_trees=T, max_depth=2, bootstrap=True,
              subsampling_rate=rate, seed=seed)
    peng.grow_forest(ds, **kw)
    jmesh = _jmesh(shape)
    jds = J.parallel.device_dataset(x, y, mesh=jmesh)
    want = np.asarray(jeng._make_bootstrap(jmesh, T, jds.n_padded, rate)(seed))
    want = want * np.asarray(jds.w)[None, :]
    got = torch.cat([seen[i] for i in range(shape[0])], dim=1)
    assert got.shape[1] == jds.n_padded
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cls", ["GBTRegressor", "GBTClassifier"])
def test_gbt_over_the_mesh(shape, cls):
    x, y, yb, _ = _ints()
    lab = y if cls == "GBTRegressor" else yb
    kw = dict(max_iter=5, max_depth=3, step_size=0.5, seed=0)
    one = getattr(port, cls)(**kw).fit((x, lab), device="cpu")
    got = getattr(port, cls)(**kw).fit((x, lab), mesh=_mesh(shape))
    if shape == (1, 1):
        _same_trees(got, one, 0.0)
    else:
        _same_trees(got, one, 1e-4)
    ref = getattr(J, cls)(**kw).fit((x, lab), mesh=_jmesh(shape))
    _same_trees(got, ref, 1e-4)
    np.testing.assert_allclose(got.init, ref.init, rtol=1e-6)
    a = got.transform((x, lab), mesh=_mesh(shape)).to_numpy()[0]
    np.testing.assert_allclose(a, got.predict_numpy(x, device="cpu"), rtol=1e-6)


@pytest.mark.parametrize("shape", [(1, 1), (8, 1), (2, 4)])
@pytest.mark.parametrize("cls", ["GBTRegressor", "GBTClassifier"])
def test_gbt_validation_over_the_mesh(shape, cls):
    rng = np.random.default_rng(3)
    n = 800
    x = np.round(rng.uniform(-2, 2, size=(n, 3)) * 4)
    y = np.round(np.sin(x[:, 0] / 2) * 8 + x[:, 1] + 6 * rng.normal(size=n))
    if cls == "GBTClassifier":
        y = (y > np.median(y)).astype(np.float64)
    is_val = rng.random(n) < 0.25
    cols = {f"f{j}": x[:, j] for j in range(3)}
    cols.update(label=y, is_val=is_val)
    names = ["f0", "f1", "f2"]
    kw = dict(max_iter=30, max_depth=4, step_size=0.5, label_col="label", seed=0,
              validation_indicator_col="is_val", validation_tol=1e-3)
    pt_ = port.VectorAssembler(names).transform(port.Table.from_dict(cols))
    one = getattr(port, cls)(**kw).fit(pt_, device="cpu")
    got = getattr(port, cls)(**kw).fit(pt_, mesh=_mesh(shape))
    jt = J.VectorAssembler(names).transform(J.Table.from_dict(cols))
    ref = getattr(J, cls)(**kw).fit(jt, mesh=_jmesh(shape))
    assert got.num_trees == one.num_trees == ref.num_trees < 30
    _same_trees(got, one, 0.0 if shape == (1, 1) else 1e-4)
    _same_trees(got, ref, 1e-4)


# -------------------------------------------------------- GaussianMixture
@pytest.mark.parametrize("shape", SHAPES)
def test_gaussian_mixture_over_the_mesh(shape):
    x, _ = _blobs()
    kw = dict(k=3, max_iter=10, seed=0)
    one = port.GaussianMixture(**kw).fit(x, device="cpu")
    got = port.GaussianMixture(**kw).fit(x, mesh=_mesh(shape))
    ref = J.GaussianMixture(**kw).fit(x, mesh=_jmesh(shape))
    if shape == (1, 1):
        np.testing.assert_array_equal(got.means, one.means)
        np.testing.assert_array_equal(got.covariances, one.covariances)
        assert got.log_likelihood == one.log_likelihood
    for want in (one, ref):
        assert got.n_iter == want.n_iter
        np.testing.assert_allclose(got.means, np.asarray(want.means), atol=1e-3)
        np.testing.assert_allclose(got.weights, np.asarray(want.weights), atol=1e-4)
        np.testing.assert_allclose(got.log_likelihood, want.log_likelihood, rtol=1e-4)
    mesh = _mesh(shape)
    np.testing.assert_allclose(got.score(x, mesh=mesh), got.score(x, device="cpu"), rtol=1e-6)
    ds = P.device_dataset(x, mesh=mesh)
    pred, prob = got.predict_assigned(ds.x)
    one_pred, one_prob = got.predict_assigned(torch.from_numpy(x))
    np.testing.assert_array_equal(P.unpad(pred, N), one_pred.numpy())
    np.testing.assert_array_equal(P.unpad(prob, N), one_prob.numpy())


@pytest.mark.parametrize("shape", [(8, 1), (2, 4)])
def test_gaussian_mixture_partials_honour_the_mesh(shape):
    x = np.random.default_rng(5).integers(-4, 5, size=(512, D)).astype(np.float32)
    gm = port.GaussianMixture(k=2, seed=0, chunk_rows=64)
    init = gm.local_init_stats(x, device="cpu").stats["candidates"]
    np.testing.assert_array_equal(gm.local_init_stats(x, mesh=_mesh(shape)).stats["candidates"],
                                  init)
    state = gm.init_state_from_merged(gm.local_init_stats(x, device="cpu"))
    a = gm.partial_fit_stats(x, state=state, device="cpu")
    b = gm.partial_fit_stats(x, state=state, mesh=_mesh(shape))
    assert a.n_rows == b.n_rows == 512
    for key in ("nk", "sums", "outer"):
        np.testing.assert_allclose(b.stats[key], a.stats[key], rtol=1e-5, atol=1e-3)


# ----------------------------------------------------- LogisticRegression
def _centred(m):
    th = np.concatenate([m.coefficient_matrix.numpy(), m.intercept_vector.numpy()[:, None]], 1)
    return th - th.mean(axis=0, keepdims=True)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("family", ["binomial", "multinomial"])
def test_logistic_regression_over_the_mesh(shape, family):
    x, a = _blobs()
    y = (a > 0).astype(np.float32) if family == "binomial" else a
    kw = dict(family=family, reg_param=0.01, max_iter=30, tol=1e-6)
    one = port.LogisticRegression(**kw).fit((x, y), device="cpu")
    got = port.LogisticRegression(**kw).fit((x, y), mesh=_mesh(shape))
    ref = J.LogisticRegression(**kw).fit((x, y), mesh=_jmesh(shape))
    if family == "binomial":
        if shape == (1, 1):
            assert torch.equal(got.coefficients, one.coefficients)
        np.testing.assert_allclose(got.coefficients.numpy(), np.asarray(ref.coefficients),
                                   atol=2e-3)
        assert abs(float(got.intercept) - float(ref.intercept)) <= 5e-3
    else:
        if shape == (1, 1):
            assert torch.equal(got.coefficient_matrix, one.coefficient_matrix)
        jc = np.concatenate([np.asarray(ref.coefficient_matrix),
                             np.asarray(ref.intercept_vector)[:, None]], 1)
        jc = jc - jc.mean(axis=0, keepdims=True)
        np.testing.assert_allclose(_centred(got)[:, :-1], jc[:, :-1], atol=2e-3)
        np.testing.assert_allclose(_centred(got)[:, -1], jc[:, -1], atol=5e-3)
    # the summary over shards: the sharded transform of the same model
    mesh = _mesh(shape)
    s = got.summary
    assert s.accuracy == port.MulticlassClassificationEvaluator(
        num_classes=max(int(a.max()) + 1, 2) if family == "multinomial" else 2
    ).evaluate(got.transform((x, y), device="cpu"))
    if family == "binomial":
        want = port.BinaryClassificationEvaluator().evaluate(
            got.transform_proba((x, y), device="cpu"))
        np.testing.assert_allclose(s.area_under_roc, want, rtol=1e-6)
        pr = got.transform_proba((x, y), mesh=mesh)
        np.testing.assert_allclose(pr.to_numpy()[0],
                                   got.transform_proba((x, y), device="cpu").to_numpy()[0],
                                   rtol=1e-6)


def test_mesh_fitted_forest_loads_in_the_jax_package(tmp_path):
    x, y = _labels("RandomForestRegressor")
    m = port.RandomForestRegressor(**TREES["RandomForestRegressor"][1]).fit(
        (x, y), mesh=_mesh((8, 1)))
    path = str(tmp_path / "rf")
    m.save(path)
    jm = J.load_model(path)
    np.testing.assert_array_equal(np.asarray(jm.predict_numpy(x)),
                                  m.predict_numpy(x, device="cpu"))
    back = port.load_model(path)
    np.testing.assert_array_equal(back.split_feat, m.split_feat)
    jm.save(str(tmp_path / "rf_jax"))
    np.testing.assert_array_equal(port.load_model(str(tmp_path / "rf_jax")).value, m.value)
