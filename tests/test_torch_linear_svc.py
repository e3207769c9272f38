"""The port's LinearSVC (squared-hinge Newton, resident and out of core)
against the JAX package's ``models/linear_svc.py``, on the CPU.

Tolerances, and why: coefficients and intercept within 2e-5 of the
largest coefficient (float32 active-set sums per device and psum'd in the
JAX package, per 128-row chunk in the port); ``n_iter`` equal on these
inputs, where no row sits on the margin within rounding (a row whose
margin rounds to the other side of 1 changes the active set: a float-order
fault that would go to ROADMAP queue 3); predictions equal.
"""

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.models import linear_svc as jsvc
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models import (
    linear_svc as psvc,
)

torch.set_num_threads(1)
COEF_TOL = 2e-5


def _data(n=2000, seed=0, weighted=False):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 4)) * [1.0, 2.0, 0.5, 1.0] + [0.0, 3.0, -1.0, 5.0]).astype(np.float32)
    s = x @ np.array([1.0, -0.5, 0.8, 0.3]) - 0.5 + rng.normal(0, 0.8, n)
    y = (s > np.median(s)).astype(np.float32)
    w = rng.uniform(0.2, 2.0, n).astype(np.float32) if weighted else None
    return x, y, w


def _theta(m) -> np.ndarray:
    return np.r_[np.asarray(m.coefficients, np.float64), float(m.intercept)]


def _close(got, want, tol=COEF_TOL):
    np.testing.assert_allclose(got, want, atol=tol * max(float(np.abs(want).max()), 1e-6))


CASES = [dict(), dict(reg_param=0.05), dict(reg_param=0.01, standardize=False),
         dict(fit_intercept=False), dict(max_iter=2), dict(tol=1e-3)]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kw", CASES)
def test_fit_matches_reference(kw, weighted):
    x, y, w = _data(weighted=weighted)
    inp = (x, y) if w is None else (x, y, w)
    jm = J.LinearSVC(**kw).fit(inp)
    pm = P.LinearSVC(**kw).fit(inp, device="cpu")
    assert pm.n_iter == jm.n_iter
    _close(_theta(pm), _theta(jm))
    assert isinstance(pm.coefficients, np.ndarray) and isinstance(pm.intercept, float)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(pm.predict(xt).numpy(), np.asarray(jm.predict(x)))
    jr = np.asarray(jm.predict_raw(x))
    np.testing.assert_allclose(pm.predict_raw(xt).numpy(), jr, atol=1e-4 * np.abs(jr).max())


def test_svc_fit_and_block_stats_match_reference():
    x, y, w = _data(n=900, seed=1, weighted=True)
    jc, ji, jn = jsvc._svc_fit(x, y, w, np.float32(0.02), np.float32(1e-6), True, True, 100)
    pc, pi, pn, syncs = psvc._svc_fit(torch.from_numpy(x), torch.from_numpy(y),
                                      torch.from_numpy(w), 0.02, 1e-6, True, True, 100)
    assert pn == int(jn)
    _close(np.r_[pc.numpy(), float(pi)], np.r_[np.asarray(jc), float(ji)])
    theta = np.array([0.2, -0.1, 0.3, 0.05, -0.2], np.float32)
    jg, jh = jsvc._svc_block_stats(x, y, w, theta, True)
    pg, ph = psvc._svc_block_stats(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w),
                                   torch.from_numpy(theta), True)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), atol=1e-5 * np.abs(jg).max())
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), rtol=1e-5)


@pytest.mark.parametrize("kw", [dict(), dict(reg_param=0.05), dict(fit_intercept=False)])
def test_outofcore_matches_reference_and_resident(kw):
    x, y, w = _data(n=2048, seed=2, weighted=True)
    jm = J.LinearSVC(**kw).fit(J.HostDataset(x=x, y=y, w=w, max_device_rows=512))
    pm = P.LinearSVC(**kw).fit(P.HostDataset(x=x, y=y, w=w, max_device_rows=512), device="cpu")
    rm = P.LinearSVC(**kw).fit((x, y, w), device="cpu")
    assert pm.n_iter == jm.n_iter == rm.n_iter
    _close(_theta(pm), _theta(jm))
    _close(_theta(pm), _theta(rm))


def test_label_checks_like_reference():
    x, y, _ = _data(n=200, seed=3)
    y3 = y.copy()
    y3[0] = 2.0
    for fit in (lambda d: J.LinearSVC().fit(d),
                lambda d: P.LinearSVC().fit(d, device="cpu"),
                lambda d: P.LinearSVC().fit(P.HostDataset(x=d[0], y=d[1], w=d[2] if len(d) > 2
                                                          else None), device="cpu")):
        with pytest.raises(ValueError, match="binary"):
            fit((x, y3))
        with pytest.raises(ValueError, match="empty dataset"):
            fit((x, y, np.zeros(len(y), np.float32)))
    with pytest.raises(ValueError, match="needs labels"):
        P.LinearSVC().fit(P.HostDataset(x=x), device="cpu")


def test_artifacts_cross_both_ways(tmp_path):
    x, y, _ = _data(n=400, seed=4)
    pm = P.LinearSVC(reg_param=0.01).fit((x, y), device="cpu")
    jm = J.LinearSVC(reg_param=0.01).fit((x, y))
    pm.save(str(tmp_path / "p"))
    jm.save(str(tmp_path / "j"))
    jl = J.load_model(str(tmp_path / "p"))
    pl = P.load_model(str(tmp_path / "j"))
    assert type(pl) is P.LinearSVCModel and pl.n_iter == jm.n_iter
    np.testing.assert_array_equal(np.asarray(jl.predict(x)), pm.predict_numpy(x, device="cpu"))
    np.testing.assert_array_equal(pl.predict_numpy(x, device="cpu"), np.asarray(jm.predict(x)))
    _, params, arrays = jm._artifacts()
    cm = P.linear_svc_model_from_jax_arrays(**arrays, **params)
    np.testing.assert_array_equal(cm.predict_numpy(x, device="cpu"), np.asarray(jm.predict(x)))
