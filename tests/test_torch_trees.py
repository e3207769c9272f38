"""The port's tree engine and tree estimators against the JAX package's,
on the CPU.

The same numpy-seeded data go through the JAX package's resident
``grow_forest`` (XLA level histograms, one-device mesh) and the port's
``grow_forest(..., device="cpu")``, whose levels run K3's plain version.

Tolerances, and why:
- with integer-valued labels (regression labels in {0..3}, 0/1 or 0..2
  classes) and Poisson weights every float32 histogram sum is exact, so
  ``split_feat``, ``split_bin``, ``threshold`` and ``split_catmask`` are
  compared exactly;
- leaf ``value`` and importances at rtol 1e-6: both are computed from
  those exact sums on the host in float64, but the gains that feed the
  importances are float32 on each side;
- binning exactly: the same numpy quantiles, the same float32 compare;
- per-tree predictions exactly; a forest's regression prediction (the
  float32 mean over trees, summed in another order) at rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.models.tree import binning as jbin
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.models.tree import engine as jeng
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.parallel.sharding import (
    device_dataset as jax_device_dataset,
)
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.data import (
    device_dataset as port_device_dataset,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models.tree import binning as pbin
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models.tree import engine as peng

# the suite runs several worker processes on a few cores: one intra-op
# thread per worker keeps torch from oversubscribing them
torch.set_num_threads(1)

STRUCT = ("split_feat", "split_bin", "threshold")


def _data(n=1200, d=5, task="regression", classes=2, seed=0, cat=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if cat:
        for f, arity in cat.items():
            x[:, f] = rng.integers(0, arity, n)
    if task == "regression":
        y = np.clip(np.round(1.5 + x[:, 0] + 0.5 * x[:, 1] + 0.3 * rng.normal(size=n)), 0, 3)
    else:
        y = np.digitize(x[:, 0] + 0.7 * x[:, 2], np.linspace(-1, 1, classes - 1))
    if cat:
        y = np.clip(y + (x[:, min(cat)] % 2), 0, 3 if task == "regression" else classes - 1)
    return x, y.astype(np.float32)


def _grow_both(x, y, mesh, **kw):
    a = jeng.grow_forest(jax_device_dataset(x, y, mesh=mesh), mesh=mesh, **kw)
    b = peng.grow_forest(port_device_dataset(x, y, device="cpu"), **kw)
    return a, b


def _assert_same_forest(a, b):
    for k in STRUCT:
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k), err_msg=k)
    if a.split_catmask is None:
        assert b.split_catmask is None
    else:
        np.testing.assert_array_equal(b.split_catmask, a.split_catmask)
        np.testing.assert_array_equal(b.cat_arities, a.cat_arities)
    np.testing.assert_allclose(b.value, a.value, rtol=1e-6)
    np.testing.assert_allclose(b.importances, a.importances, rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(b.bin_thresholds, a.bin_thresholds)


# ----------------------------------------------------------------- binning
def test_quantile_thresholds_and_bins_equal():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3000, 4)).astype(np.float32)
    x[:, 3] = rng.integers(0, 5, 3000)        # low cardinality: +inf padding
    thr_j = jbin.quantile_thresholds(x.astype(np.float64), 32)
    thr_p = pbin.quantile_thresholds(x.astype(np.float64), 32)
    np.testing.assert_array_equal(thr_p, thr_j)
    assert np.isinf(thr_p[3]).any()
    bins_j = np.asarray(jbin.digitize(jnp.asarray(x), jnp.asarray(thr_j, jnp.float32)))
    bins_p = pbin.digitize(torch.from_numpy(x), thr_p).numpy()
    np.testing.assert_array_equal(bins_p, bins_j)


def test_bin_feature_matrix_with_a_categorical_feature():
    x, _ = _data(cat={2: 6})
    x[:5, 2] += 0.4                            # rounds back to the category
    thr = pbin.quantile_thresholds(x.astype(np.float64), 16)
    got = peng.bin_feature_matrix(torch.from_numpy(x), thr, {2: 6}).numpy()
    ref = np.asarray(jeng.bin_feature_matrix(jnp.asarray(x), thr, {2: 6}))
    assert got.shape == (x.shape[1], x.shape[0])
    np.testing.assert_array_equal(got, ref)


def test_categorical_value_out_of_range_raises_unless_weight_zero():
    x, _ = _data(cat={1: 4})
    x[7, 1] = 4.0
    thr = pbin.quantile_thresholds(x.astype(np.float64), 8)
    with pytest.raises(ValueError, match="categorical feature 1"):
        peng.bin_feature_matrix(torch.from_numpy(x), thr, {1: 4})
    w = torch.ones(x.shape[0])
    w[7] = 0.0
    peng.bin_feature_matrix(torch.from_numpy(x), thr, {1: 4}, w=w)


# ----------------------------------------------------------- grow_forest
GROW_CASES = {
    "dt regression": dict(task="regression", num_trees=1, max_depth=4, max_bins=16),
    "rf regression, bootstrap + subsets": dict(
        task="regression", num_trees=4, max_depth=4, max_bins=16, bootstrap=True,
        feature_subset_size=2, seed=3),
    "dt classification, 3 classes": dict(
        task="classification", num_classes=3, num_trees=1, max_depth=3, max_bins=32),
    "rf classification, bootstrap + subsets": dict(
        task="classification", num_classes=2, num_trees=5, max_depth=5, max_bins=32,
        bootstrap=True, subsampling_rate=0.7, feature_subset_size=3, seed=11),
}


@pytest.mark.parametrize("case", list(GROW_CASES))
def test_grow_forest_matches_jax(case, mesh1):
    kw = GROW_CASES[case]
    x, y = _data(task=kw["task"], classes=kw.get("num_classes", 2))
    _assert_same_forest(*_grow_both(x, y, mesh1, **kw))


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_grow_forest_categorical_set_splits_match_jax(task, mesh1):
    cat = {3: 7, 1: 4}
    x, y = _data(n=1500, task=task, cat=cat, seed=4)
    a, b = _grow_both(x, y, mesh1, task=task, num_trees=3, max_depth=4, max_bins=16,
                      bootstrap=True, feature_subset_size=3, seed=5,
                      categorical_features=cat)
    assert (a.split_catmask > 0).any()         # set splits were chosen
    _assert_same_forest(a, b)


@pytest.mark.parametrize("min_inst,min_gain", [(25, 0.0), (1, 2.0), (200, 0.5)])
def test_min_instances_and_min_info_gain(min_inst, min_gain, mesh1):
    x, y = _data(seed=6)
    a, b = _grow_both(x, y, mesh1, task="regression", num_trees=2, max_depth=5,
                      bootstrap=True, seed=1, min_instances_per_node=min_inst,
                      min_info_gain=min_gain)
    _assert_same_forest(a, b)


def test_constant_labels_grow_no_split(mesh1):
    x, _ = _data()
    y = np.full(x.shape[0], 2.0, np.float32)
    a, b = _grow_both(x, y, mesh1, task="regression", num_trees=1, max_depth=3)
    _assert_same_forest(a, b)
    assert (b.split_feat == -1).all() and np.allclose(b.value, 2.0)


def test_weighted_rows_match_jax(mesh1):
    x, y = _data(seed=8)
    w = np.random.default_rng(8).integers(0, 3, x.shape[0]).astype(np.float32)
    kw = dict(task="regression", num_trees=1, max_depth=4, max_bins=16)
    a = jeng.grow_forest(jax_device_dataset(x, y, mesh=mesh1, weights=w), mesh=mesh1, **kw)
    b = peng.grow_forest(port_device_dataset(x, y, device="cpu", weights=w), **kw)
    _assert_same_forest(a, b)


def test_empty_dataset_raises():
    ds = port_device_dataset(np.zeros((0, 3), np.float32), np.zeros(0), device="cpu")
    with pytest.raises(ValueError, match="empty dataset"):
        peng.grow_forest(ds, task="regression")


# ------------------------------------------------------------------- ties
def _select_both(hist, task, S, cat_arities=None, k_mask=None):
    T, LN, d, B, _ = hist.shape
    mask = np.ones((T, LN, d), np.float32) if k_mask is None else k_mask
    jfn = jeng._make_select_fn(LN, d, B, S, T, task, cat_arities)
    ref = [np.asarray(v) for v in jfn(jnp.asarray(hist), jnp.asarray(mask),
                                      jnp.float32(1.0), jnp.float32(0.0))]
    is_cat = None
    if cat_arities is not None:
        is_cat = torch.tensor([a > 0 for a in cat_arities])
    got = [v.numpy() for v in peng.select_splits(torch.from_numpy(hist), torch.from_numpy(mask),
                                                 1.0, 0.0, task, is_cat)]
    return got, ref


def test_argmax_tie_takes_the_first_feature_and_bin():
    """Features 1 and 3 carry the same histogram, so their best gains tie
    exactly; both packages pick feature 1 (the first maximum)."""
    rng = np.random.default_rng(0)
    y = rng.integers(0, 4, 64).astype(np.float32)
    bins = rng.integers(0, 8, 64)
    hist = np.zeros((1, 1, 4, 8, 3), np.float32)
    for f in range(4):
        fb = bins if f in (1, 3) else np.zeros_like(bins)     # 0 and 2: one bin, no split
        for b, v in zip(fb, y):
            hist[0, 0, f, b] += (1.0, v, v * v)
    got, ref = _select_both(hist, "regression", 3)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert got[2][0, 0] == 1


def test_stable_sort_tie_in_the_categorical_order():
    """Categories 0, 2 and 5 have the same label mean: the stable sort keeps
    them in index order on both sides, so the set masks agree."""
    hist = np.zeros((1, 1, 2, 8, 3), np.float32)
    means = [1.0, 3.0, 1.0, 2.0, 0.0, 1.0, 3.0, 2.0]
    for b, m in enumerate(means):
        for v in (m - 1, m + 1):
            hist[0, 0, 1, b] += (1.0, v, v * v)
    hist[0, 0, 0, 0] = hist[0, 0, 1].sum(0)                 # feature 0: no split
    got, ref = _select_both(hist, "regression", 3, cat_arities=(0, 8))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.astype(np.float64), r.astype(np.float64))
    assert got[4][0, 0] and got[5][0, 0] > 0


# ------------------------------------------------------- estimators, models
def _pair(x, y, mesh, jcls, pcls, **kw):
    jm = jcls(**kw).fit((x, y), mesh=mesh)
    pm = pcls(**kw).fit((x, y), device="cpu")
    return jm, pm


@pytest.mark.parametrize("names,task", [
    (("DecisionTreeRegressor", {}), "regression"),
    (("RandomForestRegressor", {"num_trees": 4}), "regression"),
    (("DecisionTreeClassifier", {}), "classification"),
    (("RandomForestClassifier", {"num_trees": 4}), "classification"),
])
def test_estimators_fit_and_predict_like_jax(names, task, mesh1):
    name, extra = names
    x, y = _data(task=task)
    jm, pm = _pair(x, y, mesh1, getattr(J, name), getattr(P, name), max_depth=4, seed=2,
                   **extra)
    for k in ("split_feat", "threshold"):
        np.testing.assert_array_equal(getattr(pm, k), getattr(jm, k))
    np.testing.assert_allclose(pm.value, jm.value, rtol=1e-6)
    np.testing.assert_allclose(pm.feature_importances, jm.feature_importances, rtol=1e-6)
    assert pm.total_num_nodes == jm.total_num_nodes
    xt = torch.from_numpy(x[:300])
    np.testing.assert_allclose(pm.predict(xt).numpy(), np.asarray(jm.predict(jnp.asarray(x[:300]))),
                               rtol=1e-6)
    if task == "classification":
        np.testing.assert_allclose(pm.predict_proba(xt).numpy(),
                                   np.asarray(jm.predict_proba(jnp.asarray(x[:300]))), rtol=1e-6)


def test_wrong_feature_width_raises():
    x, y = _data()
    m = P.DecisionTreeRegressor(max_depth=2).fit((x, y), device="cpu")
    with pytest.raises(ValueError, match="trained on 5 features but the input has 3"):
        m.predict(torch.zeros((4, 3)))


@pytest.mark.parametrize("task,cat", [("regression", None), ("classification", {4: 5})])
def test_jax_model_carried_across_predicts_equal(task, cat, mesh1):
    x, y = _data(task=task, cat=cat, seed=9)
    jcls = J.RandomForestRegressor if task == "regression" else J.RandomForestClassifier
    jm = jcls(num_trees=3, max_depth=4, seed=1, categorical_features=cat).fit((x, y), mesh=mesh1)
    name, params, arrays = jm._artifacts()
    pm = P.tree_model_from_jax_arrays(**arrays, **params, name=name)
    assert type(pm).__name__ == name == "RandomForestModel"
    # every tree's output is equal; the forest's float32 mean over trees
    # is summed in another order (rtol 1e-6 for regression values)
    np.testing.assert_array_equal(pm._tree_outputs(torch.from_numpy(x)).numpy(),
                                  np.asarray(jm._tree_outputs(jnp.asarray(x))))
    got = pm.predict(torch.from_numpy(x)).numpy()
    ref = np.asarray(jm.predict(jnp.asarray(x)))
    if task == "regression":
        np.testing.assert_allclose(got, ref, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, ref)
    assert pm.num_features == x.shape[1]
