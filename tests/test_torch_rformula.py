"""RFormula and VectorSizeHint in the port against the JAX package's, on
the CPU.  Both are host numpy over a Table in both packages, so every
result is held equal: the resolved terms, the factor levels, the feature
names, the feature matrix and the label column."""

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.features import rformula as jrf
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.features import (
    rformula as prf,
)

torch.set_num_threads(1)


def _cols(n=300, seed=4):
    rng = np.random.default_rng(seed)
    return {
        "hospital_id": np.array([f"H{i:02d}" for i in rng.choice(4, n, p=[.4, .3, .2, .1])],
                                dtype=object),
        "ward": np.array([("icu", "er", "gen")[i] for i in rng.integers(0, 3, n)], dtype=object),
        "admission_count": rng.integers(0, 50, n),
        "current_occupancy": rng.integers(20, 400, n),
        "seasonality_index": rng.uniform(0.5, 1.5, n),
        "length_of_stay": rng.gamma(3.0, 1.5, n),
        "tier": np.array([("low", "mid", "high")[i] for i in rng.integers(0, 3, n)],
                         dtype=object),
    }


FORMULAS = [
    "length_of_stay ~ hospital_id + admission_count + current_occupancy + seasonality_index",
    "length_of_stay ~ .",
    "length_of_stay ~ . - ward - tier",
    "length_of_stay ~ admission_count + seasonality_index + admission_count:seasonality_index",
    "length_of_stay ~ hospital_id:ward + current_occupancy",
    "length_of_stay ~ hospital_id:admission_count - hospital_id:admission_count + ward",
    "tier ~ admission_count + hospital_id",
]


@pytest.mark.parametrize("formula", FORMULAS)
def test_rformula_matches_jax(formula):
    cols = _cols()
    jt, pt = J.Table.from_dict(cols), P.Table.from_dict(cols)
    jm = J.RFormula(formula).fit(jt)
    pm = P.RFormula(formula).fit(pt)
    assert pm._artifacts() == jm._artifacts()
    test = _cols(80, seed=5)
    ja = jm.transform(J.Table.from_dict(test))
    pa = pm.transform(P.Table.from_dict(test))
    assert pa.feature_cols == ja.feature_cols == pm.feature_names
    assert pa.features.dtype == ja.features.dtype == np.float32
    np.testing.assert_array_equal(pa.features, ja.features)
    label = formula.split("~")[0].strip()
    np.testing.assert_array_equal(pa.table.column(label), ja.table.column(label))
    assert list(pa.table.columns) == list(ja.table.columns)


@pytest.mark.parametrize("formula", ["no tilde", " ~ a", "y ~ ", "y ~ a + :b"])
def test_parse_errors_match_jax(formula):
    with pytest.raises(ValueError) as want:
        jrf._parse_formula(formula)
    with pytest.raises(ValueError) as got:
        prf._parse_formula(formula)
    assert str(got.value) == str(want.value)


def test_parse_formula_matches_jax():
    for f in FORMULAS:
        assert prf._parse_formula(f) == jrf._parse_formula(f)


def test_fit_and_transform_errors_match_jax():
    cols = _cols(40)
    for m in (J, P):
        t = m.Table.from_dict(cols)
        with pytest.raises(KeyError, match="label"):
            m.RFormula("nope ~ admission_count").fit(t)
        with pytest.raises(KeyError, match="not in the table"):
            m.RFormula("length_of_stay ~ nope").fit(t)
        with pytest.raises(TypeError, match="fits a Table"):
            m.RFormula("length_of_stay ~ .").fit(np.zeros((3, 2)))
        model = m.RFormula("length_of_stay ~ hospital_id").fit(t)
        bad = dict(cols, hospital_id=np.array(["H77"] * 40, dtype=object))
        with pytest.raises(ValueError, match="unseen level"):
            model.transform(m.Table.from_dict(bad))


def test_the_hospital_formula_feeds_a_fit_like_jax():
    # the chip smoke's formula, hospital_id as a factor, every column named
    # (``.`` would also take event_time)
    cols = _cols(500, seed=9)
    f = ("length_of_stay ~ hospital_id + admission_count + current_occupancy + "
         "seasonality_index")
    pa = P.RFormula(f).fit_transform(P.Table.from_dict(cols))
    ja = J.RFormula(f).fit_transform(J.Table.from_dict(cols))
    np.testing.assert_array_equal(pa.features, ja.features)
    pm = P.LinearRegression().fit(pa, label_col="length_of_stay", device="cpu")
    jm = J.LinearRegression().fit(ja, label_col="length_of_stay")
    pt = np.r_[pm.coefficients.numpy(), float(pm.intercept)]
    jt = np.r_[np.asarray(jm.coefficients), float(jm.intercept)]
    # the float32 normal equations of raw hospital features (ROADMAP queue 3)
    assert np.abs(pt - jt).max() <= 1e-4 * np.abs(jt).max()


@pytest.mark.parametrize("kind", ["ndarray", "tensor", "assembled", "dataset"])
def test_vector_size_hint(kind):
    x = np.zeros((5, 3), np.float32)
    data = {"ndarray": x, "tensor": torch.from_numpy(x),
            "assembled": P.VectorAssembler(["a", "b", "c"]).transform(
                P.Table.from_dict({c: x[:, 0] for c in "abc"})),
            "dataset": P.device_dataset(x, device="cpu")}[kind]
    assert P.VectorSizeHint(3).transform(data) is data
    with pytest.raises(ValueError, match="saw 3 features"):
        P.VectorSizeHint(4).transform(data)
    with pytest.raises(ValueError, match="handle_invalid"):
        P.VectorSizeHint(3, "skip")
    assert J.VectorSizeHint(3).transform(x) is x
