"""Slice 5d's VectorIndexer and feature selectors in the port against the
JAX package's, on the CPU, on the same seeded numpy inputs.

Tolerances, and why:
- VectorIndexer is equal: the same host numpy in both packages;
- the selected indices are equal in every mode, ties included: both
  rank by a stable argsort of the p-values, and the planted ties are
  exact in both (identical columns through the same per-column host
  loop for chi2);
- the p-values: chi2 is the same host numpy (equal); ANOVA's and the
  F-value test's statistics are float32 sums over the rows in another
  order (the port centres in float64-accumulated means), so F sits within
  about √n·ε ≈ 4e-6 relative and the p-values, whose relative change is
  F·pdf/sf times that, within 1e-3 relative on the informative features
  (p down to 1e-30) and 1e-5 absolute elsewhere;
- VarianceThreshold on an ndarray is equal (numpy float64 in both); on a
  table or a dataset both read s2/n − mean² from float32 moments, so the
  variances agree to float32 cancellation, and the planted columns sit
  far (100x) from the threshold.
"""

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.parallel import (
    sharding as jsharding,
)

torch.set_num_threads(1)

P_RTOL = 1e-3
P_ATOL = 1e-5


def _tables(cols: dict, feature_cols):
    return (J.VectorAssembler(feature_cols).transform(J.Table.from_dict(cols)),
            P.VectorAssembler(feature_cols).transform(P.Table.from_dict(cols)))


def _mixed(n=800, seed=0):
    rng = np.random.default_rng(seed)
    ward = rng.integers(0, 4, size=n).astype(np.float64) * 2  # values {0,2,4,6}
    sev = rng.normal(size=n)
    beds = rng.integers(0, 12, size=n).astype(np.float64)     # 12 values
    los = np.array([0.0, 8.0, 1.0, 9.0])[(ward / 2).astype(int)] + sev
    return {"ward_raw": ward, "severity": sev, "beds": beds, "los": los}


@pytest.mark.parametrize("max_categories", [4, 12, 20])
@pytest.mark.parametrize("handle_invalid", ["error", "keep", "skip"])
def test_vector_indexer_equals_the_reference(max_categories, handle_invalid):
    cols = _mixed()
    ja, pa = _tables(cols, ["ward_raw", "severity", "beds"])
    jm = J.VectorIndexer(max_categories, handle_invalid).fit(ja)
    pm = P.VectorIndexer(max_categories, handle_invalid).fit(pa)
    assert pm._artifacts() == jm._artifacts()
    assert pm.categorical_features == jm.categorical_features
    got, want = pm.transform(pa), jm.transform(ja)
    assert got.feature_cols == want.feature_cols
    np.testing.assert_array_equal(got.features, want.features)
    # unseen values in each mode: 3 is not a ward, 13 is not a bed count
    probe = np.array([[3.0, 0.5, 1.0], [2.0, 0.1, 13.0], [4.0, 0.0, 2.0]])
    if handle_invalid == "error" and jm.category_maps:
        for m in (jm, pm):
            with pytest.raises(ValueError, match="unseen"):
                m.transform(probe)
    else:
        np.testing.assert_array_equal(pm.transform(probe), jm.transform(probe))


def test_vector_indexer_skip_drops_rows_of_the_table():
    cols = _mixed(300, seed=1)
    ja, pa = _tables(cols, ["ward_raw", "severity"])
    jm = J.VectorIndexer(10, "skip").fit(ja)
    pm = P.VectorIndexer(10, "skip").fit(pa)
    cols["ward_raw"][::7] = 3.0
    ja2, pa2 = _tables(cols, ["ward_raw", "severity"])
    got, want = pm.transform(pa2), jm.transform(ja2)
    assert len(got.table) == len(want.table) < 300
    np.testing.assert_array_equal(got.features, want.features)
    np.testing.assert_array_equal(got.table.column("los"), want.table.column("los"))


def _anova_rows(n=1000, d=6, seed=2):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, size=n).astype(np.float64)
    x = rng.normal(size=(n, d))
    x[:, 1] += y
    x[:, 4] += 2 * y
    x[:, 5] += 0.3 * y
    cols = {**{f"f{j}": x[:, j] for j in range(d)}, "cls": y, "target": x @ np.arange(d)
            + rng.normal(size=n)}
    return cols, [f"f{j}" for j in range(d)]


def _chi2_rows(n=900, seed=3):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, size=n).astype(np.float64)
    noisy = np.where(rng.random(n) < 0.3, rng.integers(0, 3, n), y)
    cols = {"f0": y.copy(), "f1": rng.integers(0, 3, n).astype(np.float64),
            "f2": noisy.astype(np.float64), "f3": noisy.astype(np.float64),   # a tie
            "f4": rng.integers(0, 5, n).astype(np.float64), "lbl": y}
    return cols, ["f0", "f1", "f2", "f3", "f4"]


_TESTS = {
    "anova": ("continuous", "categorical", "cls", _anova_rows),
    "fvalue": ("continuous", "continuous", "target", _anova_rows),
    "chi2": ("categorical", "categorical", "lbl", _chi2_rows),
}
_MODES = [("numTopFeatures", 2), ("numTopFeatures", 3), ("percentile", 0.5),
          ("fpr", 0.05), ("fpr", 1e-6)]


@pytest.mark.parametrize("mode,threshold", _MODES)
@pytest.mark.parametrize("test", sorted(_TESTS))
def test_selector_selects_what_the_reference_selects(test, mode, threshold):
    ft, lt, label, rows = _TESTS[test]
    cols, fcols = rows()
    ja, pa = _tables(cols, fcols)
    kw = dict(feature_type=ft, label_type=lt, selection_mode=mode,
              selection_threshold=threshold, label_col=label)
    jm = J.UnivariateFeatureSelector(**kw).fit(ja)
    pm = P.UnivariateFeatureSelector(**kw).fit(pa, device="cpu")
    assert pm.selected == jm.selected
    got, want = pm.transform(pa), jm.transform(ja)
    assert got.feature_cols == want.feature_cols
    np.testing.assert_array_equal(got.features, want.features)
    y = pa.label(label)
    pp = P.UnivariateFeatureSelector(**kw)._p_values(pa.features, y, "cpu")
    jp = np.asarray(J.UnivariateFeatureSelector(**kw)._p_values(ja.features, y, None))
    if test == "chi2":
        np.testing.assert_array_equal(pp, jp)
    else:
        np.testing.assert_allclose(pp, jp, rtol=P_RTOL, atol=P_ATOL)


def test_selector_ties_go_to_the_lower_index():
    """f2 and f3 are one column twice: numTopFeatures 2 keeps f0 and f2,
    never f3, in both packages (a stable argsort)."""
    cols, fcols = _chi2_rows()
    ja, pa = _tables(cols, fcols)
    for pkg, at, kw in ((J, ja, {}), (P, pa, {"device": "cpu"})):
        m = pkg.ChiSqSelector(num_top_features=2, label_col="lbl").fit(at, **kw)
        assert m.selected == (0, 2)


def test_selector_refuses_what_the_reference_refuses():
    cols, fcols = _anova_rows()
    ja, pa = _tables(cols, fcols)
    kw = dict(feature_type="categorical", label_type="continuous", label_col="target")
    for pkg, at, on in ((J, ja, {}), (P, pa, {"device": "cpu"})):
        with pytest.raises(ValueError, match="no Spark test"):
            pkg.UnivariateFeatureSelector(**kw).fit(at, **on)
        with pytest.raises(ValueError, match="AssembledTable"):
            pkg.UnivariateFeatureSelector().fit(at.features, **on)
        with pytest.raises(ValueError, match="selection_mode"):
            pkg.UnivariateFeatureSelector(selection_mode="bogus", label_col="cls").fit(at, **on)


def _variance_rows(n=500, seed=4):
    rng = np.random.default_rng(seed)
    return np.c_[np.full(n, 3.0), rng.normal(0, 1.0, n), rng.normal(0, 0.01, n),
                 rng.integers(0, 50, n), rng.uniform(0.5, 1.5, n)].astype(np.float32)


@pytest.mark.parametrize("threshold", [0.0, 1e-2, 0.5])
@pytest.mark.parametrize("kind", ["table", "dataset", "ndarray", "tensor"])
def test_variance_threshold_on_each_input_kind(kind, threshold):
    x = _variance_rows()
    cols = {f"c{j}": x[:, j] for j in range(x.shape[1])}
    ja, pa = _tables(cols, list(cols))
    jin, pin = {
        "table": (ja, pa),
        "dataset": (jsharding.device_dataset(x, None), P.device_dataset(x, device="cpu")),
        "ndarray": (x.astype(np.float64), x.astype(np.float64)),
        # the JAX package reads a device array as a host ndarray; the port
        # keeps a tensor where it lies (float32 moments there)
        "tensor": (x.astype(np.float64), torch.from_numpy(x)),
    }[kind]
    jm = J.VarianceThresholdSelector(threshold).fit(jin)
    pm = P.VarianceThresholdSelector(threshold).fit(pin, device="cpu")
    assert pm.selected == jm.selected
    want = np.flatnonzero(x.astype(np.float64).var(axis=0, ddof=1) > threshold)
    assert pm.selected == tuple(want)
    if kind == "dataset":
        out = pm.transform(pin)
        assert isinstance(out, P.DeviceDataset)
        # the JAX dataset pads to its 8 shards: compare the real rows
        np.testing.assert_array_equal(out.x.numpy(), np.asarray(jm.transform(jin).x)[:len(x)])
    elif kind == "table":
        got, want_t = pm.transform(pa), jm.transform(ja)
        assert got.feature_cols == want_t.feature_cols
        np.testing.assert_array_equal(got.features, want_t.features)


def test_selectors_feed_a_categorical_tree_like_the_reference():
    """StringIndexer-style codes → VectorIndexer → a categorical tree: the
    same ``categorical_features`` and the same tree in both packages."""
    cols = _mixed(600, seed=5)
    cols["los"] = np.round(cols["los"])     # integer labels: exact tree sums
    ja, pa = _tables(cols, ["ward_raw", "severity", "beds"])
    jm = J.VectorIndexer(max_categories=12).fit(ja)
    pm = P.VectorIndexer(max_categories=12).fit(pa)
    jt = J.DecisionTreeRegressor(max_depth=3, label_col="los",
                                 categorical_features=jm.categorical_features).fit(
        jm.transform(ja))
    pt = P.DecisionTreeRegressor(max_depth=3, label_col="los",
                                 categorical_features=pm.categorical_features).fit(
        pm.transform(pa), device="cpu")
    x = pm.transform(pa).features.astype(np.float32)
    np.testing.assert_array_equal(pt.predict_numpy(x, device="cpu"),
                                  np.asarray(jt.predict_numpy(x)))
