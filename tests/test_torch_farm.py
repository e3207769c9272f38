"""The port's model farm (``farm/``, ``lifecycle/farm.py``) against the JAX
package's, and against its own looped baseline, on the CPU.

Host work (packing, the tenant sketches, PSI and the drifted set) is
float64 numpy copied from the reference, so it must be ``==``.  The fits
are float32 sums in another order than XLA's, so the parameters are held
within stated bounds.  Within the port, the farm must equal a loop of
one-tenant fits bit for bit: every statistic is summed in an order that
does not depend on the tenant count (``farm/farm.py``).

Tolerances, each with its reason:

* ``THETA_TOL`` = 2e-5 of the largest |θ|: the linear fits are float32
  normal equations summed in another order; on these fleets every
  tenant's system has a condition number κ ≤ 17, the largest gap measured
  over 24 configurations (3 fleets x ridge x pooling x intercept) was
  1.96e-6 of the largest |θ| (about 3), and the reference's own
  batched-vs-looped gap is 9.5e-7 at |θ| ≈ 3 — the bound is about 10x.
* ``_kappa_bound``: a system that is ill conditioned by construction — a
  one-row tenant with neither ridge nor pooling (κ ≈ 2.4e6: its θ rests on
  the 1e-6 floor), a refit tenant shifted by +4 (κ ≈ 1.3e4) — is held
  within 4·κ·2^-24 of its own |θ|, the textbook bound of a float32 solve
  (measured 2.1e-3 and 4.2e-5 of |θ|); the one-row tenant's fitted value
  is also held within ``THETA_TOL`` of the float64 solution.
* ``CENTER_TOL`` = 2e-6: the Lloyd sums in another order, on a tie-free
  fleet (no assignment can flip); 2.4e-7 measured at |x| ≈ 3.
* the KMeans costs: within 2^-20·Σ w·|x|² a tenant: the reference takes
  d² in the cross-term form |x|² − 2x·c + |c|², which rounds at about
  2^-24·|x|² a row (the port takes direct differences); measured up to
  8.7e-5 on tenants whose Σ|x|² is about 2,000 (bound 1.9e-3).
* ``PRED_TOL`` = 2e-5 of the largest |prediction|: a prediction is a
  dot product with θ (within ``THETA_TOL``) of unit-scale rows.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu.farm as JF
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
from clustermachinelearningforhospitalnetworks_apache_spark_tpu import lifecycle as JL
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.io import model_io as jax_io
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import farm as PF
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import lifecycle as PL
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.farm import farm as pf
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve import (
    InferenceServer,
    NotRoutableError,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults

# the suite runs several worker processes on a few cores: one intra-op
# thread per worker keeps torch from oversubscribing them
torch.set_num_threads(1)

CPU = "cpu"
D = 4
THETA = np.array([1.0, -2.0, 0.5, 3.0])
THETA_TOL = 2e-5
CENTER_TOL = 2e-6
PRED_TOL = 2e-5


def _fleet(n_tenants: int = 24, seed: int = 0, min_rows: int = 2,
           max_rows: int = 40) -> dict:
    """Ragged per-hospital regression datasets with a shared signal and
    per-tenant perturbations (the reference tests' generator)."""
    rng = np.random.default_rng(seed)
    data = {}
    for t in range(n_tenants):
        n = int(rng.integers(min_rows, max_rows))
        x = rng.normal(size=(n, D))
        theta_t = THETA + 0.2 * rng.normal(size=D)
        y = x @ theta_t + 0.7 + 0.01 * rng.normal(size=n)
        data[f"H{t:03d}"] = (x, y)
    return data


def _edge_fleet(seed: int) -> dict:
    """A fleet with an empty, a one-row and an all-NaN tenant, and NaN
    rows inside a normal tenant."""
    data = _fleet(seed=seed)
    data["empty"] = (np.empty((0, D)), np.empty((0,)))
    data["one"] = (np.array([[1.0, 0.5, -0.3, 0.2]]), np.array([2.0]))
    data["allnan"] = (np.full((7, D), np.nan), np.full((7,), np.nan))
    x, y = data["H001"]
    x = x.copy()
    x[0, 1] = np.nan
    x[1, 3] = np.inf
    data["H001"] = (x, y)
    return data


def _blob_fleet(n_tenants: int = 16, seed: int = 5) -> dict:
    """A tie-free KMeans fleet: each tenant's rows are 3 tight, far-apart
    blobs, so no row sits near a tie between two centers."""
    rng = np.random.default_rng(seed)
    data = {}
    for t in range(n_tenants):
        centers = rng.normal(scale=4.0, size=(3, D)) + np.array([[0, 0, 0, 0], [9, 0, 0, 0],
                                                                  [0, 9, 0, 0]])
        n = int(rng.integers(12, 40))
        data[f"K{t:03d}"] = centers[rng.integers(0, 3, n)] + rng.normal(scale=0.2,
                                                                         size=(n, D))
    return data


def _theta(m) -> np.ndarray:
    return np.concatenate([m.arrays["coefficients"], m.arrays["intercepts"][:, None]], 1)


def _kappa_bound(x, theta, reg=0.0, pool=0.0) -> float:
    """4·κ·2^-24·|θ|∞ for one tenant's float64 system (intercept fitted)."""
    xa = np.concatenate([x, np.ones((len(x), 1))], 1)
    a = xa.T @ xa + reg * len(x) * np.diag([1.0] * D + [0.0]) + (pool + 1e-6) * np.eye(D + 1)
    return 4 * np.linalg.cond(a) * 2.0 ** -24 * np.abs(theta).max()


@pytest.fixture(scope="module")
def fleet():
    return _fleet()


@pytest.fixture(scope="module")
def linear_pair(fleet):
    return (PF.FarmLinearRegression(reg_param=0.1).fit(fleet, device=CPU),
            JF.FarmLinearRegression(reg_param=0.1).fit(fleet))


@pytest.fixture(scope="module")
def kmeans_pair():
    data = _blob_fleet()
    return (data, PF.FarmKMeans(k=3, max_iter=12, seed=1).fit(data, device=CPU),
            JF.FarmKMeans(k=3, max_iter=12, seed=1).fit(data))


# ============================================================= host: == JAX
@pytest.mark.parametrize("case", ["plain", "edges", "pad_to", "weights"])
def test_pack_tenants_equals_the_reference(case):
    data = _edge_fleet(3) if case == "edges" else _fleet(9, seed=4)
    kw = {"pad_to": 64} if case == "pad_to" else {}
    if case == "weights":
        rng = np.random.default_rng(8)
        data = {t: (v[0], v[1], rng.uniform(0, 2, len(v[1]))) for t, v in data.items()}
    got, want = PF.pack_tenants(data, **kw), JF.pack_tenants(data, **kw)
    assert got.tenant_ids == want.tenant_ids
    for name in ("x", "y", "w", "n_rows", "masked_rows"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_pack_validation():
    with pytest.raises(ValueError, match="at least one tenant"):
        PF.pack_tenants({})
    with pytest.raises(ValueError, match="rows"):
        PF.pack_tenants({"a": (np.zeros((3, D)), np.zeros(2))})
    with pytest.raises(ValueError, match="features"):
        PF.pack_tenants({"a": np.zeros((3, D)), "b": np.zeros((3, D + 1))})
    with pytest.raises(ValueError, match=">= 0"):
        PF.pack_tenants({"a": (np.zeros((2, D)), np.zeros(2), np.array([1.0, -1.0]))})
    with pytest.raises(ValueError, match="collide"):
        PF.pack_tenants({1: np.zeros((2, D)), "1": np.zeros((2, D))})


@pytest.mark.parametrize("r_floor", [2, 8, 32])
def test_r_floor_knob_sets_the_padded_rows(tmp_path, r_floor):
    """``farm.pack.r_floor`` is the floor of the power-of-two R."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import tune

    data = {"a": np.zeros((3, D)), "b": np.zeros((5, D))}
    store = tune.TrialStore(str(tmp_path / "trials.json"))
    store.add([tune.make_trial(knob="farm.pack.r_floor", value=v, score=s)
               for v, s in ((r_floor, 2.0), (4, 1.0))])   # a selector ranks two values
    with tune.active(tune.Selector(store)):
        assert tune.knob("farm.pack.r_floor") == r_floor
        assert PF.pack_tenants(data).pad_rows == max(r_floor, 8)
        assert pf._next_pow2(1) == r_floor
    assert PF.pack_tenants(data).pad_rows == 8            # the default floor, 8
    assert PF.pack_tenants({"a": np.zeros((9, D))}).pad_rows == 16


def test_profiles_equal_the_reference(linear_pair, fleet):
    """The stacked sketches (float64 host numpy) are ``==``, and each
    tenant's profile round-trips into the same DataProfile."""
    pm, jm = linear_pair
    for name in ("profile_edges", "profile_counts", "profile_stats", "tenant_rows",
                 "masked_rows"):
        assert np.array_equal(pm.arrays[name], jm.arrays[name]), name
    for tid in ("H000", "H007"):
        assert pm.tenant_profile(tid).to_dict() == jm.tenant_profile(tid).to_dict()
    assert pm.live_profile().to_dict() == jm.live_profile().to_dict()


def test_psi_and_drifted_tenants_equal_the_reference(linear_pair, fleet):
    pm, jm = linear_pair
    live = {t: np.asarray(v[0]) + (6.0 if t in ("H003", "H011") else 0.0)
            for t, v in fleet.items()}
    live["nope"] = np.zeros((50, D))
    for tid in ("H003", "H008"):
        assert PF.tenant_psi(pm, tid, live[tid]) == JF.tenant_psi(jm, tid, live[tid])
    got = PF.drifted_tenants(pm, live, min_rows=1)
    assert got == JF.drifted_tenants(jm, live, min_rows=1)
    assert set(got) == {"H003", "H011"}


# ==================================================== linear fits vs JAX
@pytest.mark.parametrize("reg,pool", [(0.1, 0.0), (0.0, 10.0), (0.1, 10.0)])
@pytest.mark.parametrize("fit_intercept", [True, False])
def test_linear_farm_within_bound_of_the_reference(reg, pool, fit_intercept):
    """With ridge or pooling every system is well posed: every tenant
    (empty, one-row, all-NaN and NaN rows included) within THETA_TOL of
    the largest |θ|; the host arrays ``==``."""
    data = _edge_fleet(1)
    kw = dict(reg_param=reg, pool=pool, fit_intercept=fit_intercept)
    pm = PF.FarmLinearRegression(**kw).fit(data, device=CPU)
    jm = JF.FarmLinearRegression(**kw).fit(data)
    tp, tj = _theta(pm), _theta(jm)
    assert np.all(np.isfinite(tp))
    assert np.abs(tp - tj).max() <= THETA_TOL * np.abs(tj).max()
    for name in ("tenant_rows", "masked_rows", "profile_counts", "profile_stats"):
        assert np.array_equal(pm.arrays[name], jm.arrays[name]), name
    assert pm.config == jm.config
    assert int(pm.arrays["masked_rows"][pm.tenant_index("allnan")]) == 7
    assert int(pm.arrays["masked_rows"][pm.tenant_index("H001")]) == 2


@pytest.mark.parametrize("fit_intercept", [True, False])
def test_linear_farm_unregularized_within_bound_of_the_reference(fit_intercept):
    """No ridge, no pooling: tenants with at least 12 rows within
    THETA_TOL; the empty and all-NaN tenants exactly 0 in both; the
    one-row tenant (underdetermined) held by its fitted value."""
    data = _fleet(seed=2, min_rows=12)
    data["empty"] = (np.empty((0, D)), np.empty((0,)))
    data["one"] = (np.array([[1.0, 0.5, -0.3, 0.2]]), np.array([2.0]))
    data["allnan"] = (np.full((7, D), np.nan), np.full((7,), np.nan))
    pm = PF.FarmLinearRegression(fit_intercept=fit_intercept).fit(data, device=CPU)
    jm = JF.FarmLinearRegression(fit_intercept=fit_intercept).fit(data)
    tp, tj = _theta(pm), _theta(jm)
    one = pm.tenant_index("one")
    rows = [i for i in range(len(tp)) if i != one]
    assert np.abs(tp[rows] - tj[rows]).max() <= THETA_TOL * np.abs(tj[rows]).max()
    for t in ("empty", "allnan"):
        assert not tp[pm.tenant_index(t)].any() and not tj[jm.tenant_index(t)].any()
    x1, y1 = data["one"]
    if fit_intercept:
        assert np.abs(tp[one] - tj[one]).max() <= _kappa_bound(x1, tj[one])
    xa = np.concatenate([x1, np.ones((1, 1))], 1) if fit_intercept else x1
    theta64 = np.linalg.solve(xa.T @ xa + 1e-6 * np.eye(xa.shape[1]), xa[0] * y1[0])
    got = pm.predict_tenant("one", x1, device=CPU)
    assert abs(float(got[0]) - float(xa[0] @ theta64)) <= THETA_TOL * abs(y1[0])


def test_empty_and_all_nan_tenants_land_on_the_global_model_with_pooling():
    data = _edge_fleet(0)
    m = PF.FarmLinearRegression(pool=10.0).fit(data, device=CPU)
    g = m.global_index
    for t in ("empty", "allnan"):
        np.testing.assert_allclose(m.arrays["coefficients"][m.tenant_index(t)],
                                   m.arrays["coefficients"][g], atol=1e-3)
        assert int(m.arrays["tenant_rows"][m.tenant_index(t)]) == 0
    clean = {t: v for t, v in data.items() if t != "allnan"}
    m2 = PF.FarmLinearRegression(pool=10.0).fit(clean, device=CPU)
    # the NaN tenant never reaches the global fit
    np.testing.assert_allclose(m.arrays["coefficients"][g],
                               m2.arrays["coefficients"][m2.global_index], atol=1e-5)


def test_one_row_tenant_is_pooled_toward_the_global_model():
    data = _fleet(6)
    data["tiny"] = (np.array([[1.0, 0.0, 0.0, 0.0]]), np.array([5.0]))
    m = PF.FarmLinearRegression(pool=50.0).fit(data, device=CPU)
    coef = m.arrays["coefficients"][m.tenant_index("tiny")]
    g = m.arrays["coefficients"][m.global_index]
    assert np.all(np.isfinite(coef))
    assert np.linalg.norm(coef - g) < 0.5 * np.linalg.norm(g)


# ==================================================== kmeans fits vs JAX
def test_kmeans_farm_within_bound_of_the_reference(kmeans_pair):
    """Tie-free fleet: centers within CENTER_TOL, and the center
    validity, sizes, n_iter and every prediction equal."""
    data, pm, jm = kmeans_pair
    assert np.abs(pm.arrays["centers"] - jm.arrays["centers"]).max() <= CENTER_TOL
    for name in ("center_valid", "sizes", "n_iter", "tenant_rows", "profile_counts"):
        assert np.array_equal(pm.arrays[name], jm.arrays[name]), name
    b = PF.pack_tenants(data)
    sq = (b.w[..., None] * b.x.astype(np.float64) ** 2).sum(axis=(1, 2))
    assert np.all(np.abs(pm.arrays["costs"][:-1] - jm.arrays["costs"][:-1]) <= 2.0 ** -20 * sq)
    for tid in list(data)[:6] + ["unknown"]:
        x = data.get(tid, data["K000"])
        assert np.array_equal(pm.predict_tenant(tid, x, device=CPU),
                              np.asarray(jm.predict_tenant(tid, x)))


def test_kmeans_empty_tenant_has_no_slice_but_predicts():
    data = {"a": np.random.default_rng(0).normal(size=(30, D)), "empty": np.empty((0, D))}
    m = PF.FarmKMeans(k=3, seed=0).fit(data, device=CPU)
    with pytest.raises(ValueError, match="no valid centers"):
        m.tenant_model("empty")
    assert m.predict_tenant("empty", np.zeros((2, D)), device=CPU).tolist() == [0.0, 0.0]


def test_tenant_slices_are_the_ordinary_models(linear_pair, kmeans_pair, fleet):
    pm, _ = linear_pair
    x = np.asarray(fleet["H005"][0], dtype=np.float32)
    sliced = pm.tenant_model("H005").predict_numpy(x, device=CPU)
    np.testing.assert_allclose(pm.predict_tenant("H005", x, device=CPU), sliced, atol=1e-5)
    assert isinstance(pm.global_model(), port.LinearRegressionModel)
    data, km, _ = kmeans_pair
    xk = np.asarray(data["K002"], dtype=np.float32)
    assert np.array_equal(km.predict_tenant("K002", xk, device=CPU).astype(np.int32),
                          km.tenant_model("K002").predict_numpy(xk, device=CPU))


# ================================================= predictions and routing
def test_predictions_within_bound_of_the_reference(linear_pair, fleet):
    pm, jm = linear_pair
    for tid in ("H002", "H013", "NOT_A_HOSPITAL"):
        x = np.asarray(fleet["H002"][0])
        got = pm.predict_tenant(tid, x, device=CPU)
        want = np.asarray(jm.predict_tenant(tid, x))
        assert np.abs(got - want).max() <= PRED_TOL * np.abs(want).max()
    routed = pm.route_request("H004", fleet["H004"][0])
    assert np.array_equal(routed, jm.route_request("H004", fleet["H004"][0]))


@pytest.mark.parametrize("bad", [-1.0, -5.0, -np.inf, np.nan, np.inf, 1e12, 3e38,
                                 "past_end"])
def test_malformed_tenant_index_routes_to_the_global_slot(linear_pair, bad):
    """A corrupted in-band index (negative, ±inf, NaN, huge, past the end)
    answers with the GLOBAL slot, never another hospital's slice — the
    same answer as the reference's."""
    pm, jm = linear_pair
    g = pm.global_index
    bad = float(g + 7) if bad == "past_end" else bad
    x = np.random.default_rng(1).normal(size=(1, D)).astype(np.float32)
    fn = pm.serving_predict_fn()

    def answer(v):
        row = np.concatenate([[[v]], x], axis=1).astype(np.float32)
        return float(fn(torch.from_numpy(row))[0])

    assert answer(bad) == answer(float(g))
    assert answer(0.0) != answer(float(g))
    row = np.concatenate([[[bad]], x], axis=1).astype(np.float32)
    assert answer(bad) == pytest.approx(float(np.asarray(jm.predict(row))[0]), rel=PRED_TOL)


def test_predict_needs_the_card_unless_asked(linear_pair, monkeypatch):
    pm, _ = linear_pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = pm.route_request("H001", np.zeros((2, D)))
    for call in (lambda: pm.predict(x), lambda: pm.predict_tenant("H001", x[:, 1:]),
                 lambda: pm.refit({"H001": (np.zeros((3, D)), np.zeros(3))}),
                 lambda: PF.FarmLinearRegression().fit({"a": np.zeros((3, D))}),
                 lambda: PF.FarmKMeans().fit({"a": np.zeros((3, D))})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert pm.predict(x, device=CPU).shape == (2,)
    assert pm.predict(torch.from_numpy(x.astype(np.float32))).device.type == "cpu"


# ======================================================= refit and drift
def test_refit_touches_only_the_subset_and_matches_the_reference(linear_pair, fleet):
    pm, jm = linear_pair
    shifted = {
        "H002": (np.asarray(fleet["H002"][0]) + 4.0, np.asarray(fleet["H002"][1])),
        "H009": (np.asarray(fleet["H009"][0]) * 2.0, np.asarray(fleet["H009"][1])),
    }
    p2, j2 = pm.refit(shifted, device=CPU), jm.refit(shifted)
    for tid in pm.tenant_ids:
        i = pm.tenant_index(tid)
        same = np.array_equal(p2.arrays["coefficients"][i], pm.arrays["coefficients"][i])
        assert same != (tid in shifted), tid
    g = pm.global_index
    untouched = [i for i, t in enumerate(pm.tenant_ids) if t not in shifted]
    for name, v in pm.arrays.items():
        if name == "profile_edges":
            assert p2.arrays[name].tobytes() == v.tobytes()
            continue
        keep = untouched + ([g] if v.shape[0] == g + 1 else [])
        assert p2.arrays[name][keep].tobytes() == v[keep].tobytes(), name
    tp, tj = _theta(p2), _theta(j2)
    for tid, (x, _) in shifted.items():
        i = pm.tenant_index(tid)
        assert np.abs(tp[i] - tj[i]).max() <= _kappa_bound(x, tj[i], reg=0.1), tid
    for name in ("profile_counts", "profile_stats", "tenant_rows"):
        assert np.array_equal(p2.arrays[name], j2.arrays[name]), name


def test_kmeans_refit_on_unchanged_data_reproduces_the_fit(kmeans_pair):
    data, pm, jm = kmeans_pair
    p2 = pm.refit({"K006": data["K006"]}, device=CPU)
    assert np.array_equal(p2.arrays["centers"], pm.arrays["centers"])
    j2 = jm.refit({"K004": data["K004"] + 1.0})
    p3 = pm.refit({"K004": data["K004"] + 1.0}, device=CPU)
    assert np.abs(p3.arrays["centers"] - j2.arrays["centers"]).max() <= CENTER_TOL
    assert np.array_equal(p3.arrays["n_iter"], j2.arrays["n_iter"])


def test_retrain_drifted_refits_the_reference_set(tmp_path, fleet):
    """The same drifted set as the JAX package's, every other tenant
    byte-identical, the successor saved and hot-swapped."""
    p0 = PF.FarmLinearRegression(reg_param=0.1, pool=1.0).fit(fleet, device=CPU)
    j0 = JF.FarmLinearRegression(reg_param=0.1, pool=1.0).fit(fleet)
    new = dict(fleet)
    for t in ("H001", "H017"):
        x1 = np.asarray(fleet[t][0]) + 5.0
        new[t] = (x1, x1 @ (THETA + 1.0))
    path = str(tmp_path / "farm_v2")
    with InferenceServer(device=CPU) as srv:
        srv.add_model("farm", p0)
        p1, rep = PL.retrain_drifted(p0, new, threshold=0.25, min_rows=1, save_path=path,
                                     server=srv, serving_name="farm", device=CPU)
        x = new["H001"][0][:4]
        res = srv.predict_tenant("farm", "H001", x)
        assert res.ok and np.array_equal(res.value, p1.predict_tenant("H001", x, device=CPU))
    j1, jrep = JL.retrain_drifted(j0, new, threshold=0.25, min_rows=1)
    assert rep["drifted"] == jrep["drifted"] and sorted(rep["drifted"]) == ["H001", "H017"]
    assert rep["swapped"] == "farm" and rep["saved"] == path
    idx = [p0.tenant_index(t) for t in p0.tenant_ids if t not in ("H001", "H017")]
    assert p1.arrays["coefficients"][idx].tobytes() == p0.arrays["coefficients"][idx].tobytes()
    assert np.abs(_theta(p1)[idx] - _theta(j1)[idx]).max() <= (
        THETA_TOL * np.abs(_theta(j1)).max())
    for t in ("H001", "H017"):          # shifted by +5: κ in the thousands
        i = p0.tenant_index(t)
        assert np.abs(_theta(p1)[i] - _theta(j1)[i]).max() <= _kappa_bound(
            new[t][0], _theta(j1)[i], reg=0.1, pool=1.0)
    assert port.load_model(path).tenant_ids == p0.tenant_ids
    p2, rep2 = PL.retrain_drifted(p0, fleet, threshold=0.25, min_rows=1, device=CPU)
    assert p2 is p0 and rep2["drifted"] == {}


def test_non_string_tenant_ids_share_one_id_space():
    rng = np.random.default_rng(4)
    data = {t: (x, x @ THETA) for t, x in ((t, rng.normal(size=(30, D))) for t in range(6))}
    m = PF.FarmLinearRegression(pool=1.0).fit(data, device=CPU)
    assert m.tenant_ids == tuple(str(t) for t in range(6))
    x = np.asarray(data[3][0][:2])
    assert np.array_equal(m.predict_tenant(3, x, device=CPU),
                          m.predict_tenant("3", x, device=CPU))
    shifted = dict(data)
    shifted[1] = (np.asarray(data[1][0]) + 6.0, np.asarray(data[1][1]))
    m3, report = PL.retrain_drifted(m, shifted, threshold=0.25, min_rows=1, device=CPU)
    assert list(report["drifted"]) == ["1"] and m3 is not m


# ================================================ farm == looped, bit for bit
@pytest.mark.parametrize("pool", [0.0, 3.0])
def test_linear_farm_equals_the_looped_baseline_bit_for_bit(pool):
    data = _edge_fleet(0)
    m = PF.FarmLinearRegression(reg_param=0.1, pool=pool).fit(data, device=CPU)
    b = PF.pack_tenants(data)
    theta_g = torch.from_numpy(_theta(m)[m.global_index].astype(np.float32))
    for i in range(b.n_tenants):
        looped, _ = pf._tenant_solve(
            torch.from_numpy(b.x[i:i + 1]), torch.from_numpy(b.y[i:i + 1]),
            torch.from_numpy(b.w[i:i + 1]), pf._scalar(0.1, CPU), pf._scalar(pool, CPU),
            theta_g, True)
        looped = looped.numpy()[0]
        assert looped.tobytes() == _theta(m)[i].tobytes(), b.tenant_ids[i]


def test_kmeans_farm_equals_the_looped_baseline_bit_for_bit(kmeans_pair):
    data, m, _ = kmeans_pair
    b = PF.pack_tenants(data)
    for i in range(b.n_tenants):
        c0, cv = pf._init_farm_centers(b.x[i:i + 1], b.w[i:i + 1], 3, 1, base_index=i)
        cen, counts, cost, n_iter, _ = pf._farm_kmeans_loop(
            torch.from_numpy(b.x[i:i + 1]), torch.from_numpy(b.w[i:i + 1]),
            torch.from_numpy(c0), torch.from_numpy(cv), 12, 1e-4)
        assert cen.numpy()[0].tobytes() == m.arrays["centers"][i].tobytes()
        assert counts.numpy()[0].tobytes() == m.arrays["sizes"][i].tobytes()
        assert cost.numpy()[0].tobytes() == m.arrays["costs"][i].tobytes()
        assert int(n_iter[0]) == int(m.arrays["n_iter"][i])


@pytest.mark.parametrize("family", ["linear", "kmeans"])
def test_one_mixed_batch_equals_per_tenant_batches_bit_for_bit(linear_pair, kmeans_pair,
                                                                fleet, family):
    """The serving predict is row-local: one mixed-tenant batch equals each
    tenant's rows alone, bit for bit."""
    if family == "linear":
        m, data = linear_pair[0], {t: v[0] for t, v in fleet.items()}
    else:
        m, data = kmeans_pair[1], kmeans_pair[0]
    ids = list(data)[:8]
    big = np.concatenate([m.route_request(t, data[t]) for t in ids]).astype(np.float32)
    out = m.predict(big, device=CPU).numpy()
    ofs = 0
    for t in ids:
        n = len(data[t])
        assert out[ofs:ofs + n].tobytes() == m.predict_tenant(t, data[t], device=CPU).tobytes()
        ofs += n


@pytest.mark.parametrize("sync_every", [1, 3, 4, 50])
def test_the_loop_sync_cadence_changes_nothing(kmeans_pair, monkeypatch, sync_every):
    """``done`` read every step or every few: the same bits, ``n_iter``
    counting applied steps only, and never more than ``max_iter`` steps."""
    data, ref, _ = kmeans_pair
    monkeypatch.setattr(pf, "SYNC_EVERY", sync_every)
    m = PF.FarmKMeans(k=3, max_iter=12, seed=1).fit(data, device=CPU)
    for name in ("centers", "sizes", "costs", "n_iter"):
        assert m.arrays[name].tobytes() == ref.arrays[name].tobytes(), name
    assert m.fit_info["done_reads"] <= 11 // sync_every
    steps = []
    real = pf._farm_kmeans_step

    def counting(*a):
        steps.append(1)
        return real(*a)

    monkeypatch.setattr(pf, "_farm_kmeans_step", counting)
    m5 = PF.FarmKMeans(k=3, max_iter=5, tol=0.0, seed=1).fit(data, device=CPU)
    # the fleet and the global slot: max_iter steps each at most, and
    # exactly that many when no read can stop the loop early
    assert len(steps) <= 2 * 5 and (sync_every < 5 or len(steps) == 2 * 5)
    assert int(m5.arrays["n_iter"].max()) <= 5


# ============================================================ kill / resume
def test_checkpointed_farm_fit_killed_and_resumed_is_bit_identical(tmp_path):
    data = {t: v[0] for t, v in _fleet(12, seed=5, min_rows=8).items()}

    def est(ckpt_dir):
        return PF.FarmKMeans(k=3, max_iter=8, tol=0.0, seed=2,
                             checkpoint_dir=str(ckpt_dir), checkpoint_every=1)

    ref = est(tmp_path / "ref").fit(data, device=CPU)
    plan = faults.FaultPlan().crash("fit_ckpt.save.commit", after=2)
    with faults.active(plan):
        with pytest.raises(faults.InjectedCrash):
            est(tmp_path / "crashed").fit(data, device=CPU)
    assert plan.fired("fit_ckpt.save.commit") == 1
    resumed = est(tmp_path / "crashed").fit(data, device=CPU)
    for name in ("centers", "n_iter", "sizes", "costs"):
        assert resumed.arrays[name].tobytes() == ref.arrays[name].tobytes(), name
    plain = PF.FarmKMeans(k=3, max_iter=8, tol=0.0, seed=2).fit(data, device=CPU)
    assert plain.arrays["centers"].tobytes() == ref.arrays["centers"].tobytes()


# ============================================================== artifacts
@pytest.mark.parametrize("family", ["linear", "kmeans"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_farm_artifacts_cross_the_packages(tmp_path, linear_pair, kmeans_pair, family,
                                           writer):
    pm, jm = linear_pair if family == "linear" else kmeans_pair[1:]
    path = str(tmp_path / "farm")
    src = pm if writer == "port" else jm
    src.save(path)
    assert sorted(os.listdir(path)) == ["arrays.npz", "metadata.json"]
    loaded = (jax_io.load_model if writer == "port" else port.load_model)(path)
    assert type(loaded).__name__ == "ModelFarmModel"
    assert loaded.tenant_ids == src.tenant_ids and loaded.config == src.config
    assert sorted(loaded.arrays) == sorted(src.arrays)
    for k, v in src.arrays.items():
        assert np.array_equal(np.asarray(loaded.arrays[k]), v), k


# ================================================================ serving
def test_server_routes_tenants_with_zero_recompiles(linear_pair, fleet):
    pm, jm = linear_pair
    with InferenceServer(device=CPU) as srv:
        srv.add_model("farm", pm, buckets=(1, 16, 64))
        rng = np.random.default_rng(0)
        ids = list(fleet)
        for size in (1, 7, 32, 3, 64, 17):
            tid = ids[int(rng.integers(len(ids)))]
            x = rng.normal(size=(size, D))
            res = srv.predict_tenant("farm", tid, x)
            assert res.ok and np.array_equal(res.value, pm.predict_tenant(tid, x, device=CPU))
        x = np.asarray(fleet["H004"][0][:5])
        res_u = srv.predict_tenant("farm", "NOT_A_HOSPITAL", x)
        assert res_u.ok
        np.testing.assert_allclose(res_u.value, pm.global_model().predict_numpy(
            x.astype(np.float32), device=CPU), atol=1e-5)
        assert srv.stats()["recompiles"] == 0


def test_not_routable_answers_invalid_input(fleet):
    x, y = (np.asarray(v) for v in fleet["H004"])
    with InferenceServer(device=CPU) as srv:
        srv.add_model("plain", port.LinearRegression().fit((x, y), device=CPU))
        res = srv.predict_tenant("plain", "H004", x)
        assert res.status == "invalid_input" and "plain" in res.detail
        assert srv.metrics.registry.counters["serve.not_routable"] == 1
        with pytest.raises(NotRoutableError, match="not tenant-routable") as e:
            srv.route_tenant("plain", "H004", x)
        assert isinstance(e.value, TypeError) and e.value.model_name == "plain"
        assert e.value.family == "LinearRegressionModel"


def test_farm_metrics_use_bounded_cohorts(linear_pair, fleet):
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.obs.registry import (
        global_registry,
    )

    pm, _ = linear_pair

    def requests():
        return {k: v for k, v in global_registry().counters.items()
                if k.startswith("farm.requests{")}

    before = sum(requests().values())
    unknown = global_registry().counters.get("farm.requests_unknown_tenant", 0.0)
    pm.predict_tenant("H001", np.asarray(fleet["H001"][0][:2]), device=CPU)
    pm.route_request("nobody", np.zeros((1, D)))
    assert sum(requests().values()) == before + 2
    assert all("cohort=" in k and "tenant" not in k for k in requests())
    assert global_registry().counters["farm.requests_unknown_tenant"] == unknown + 1
