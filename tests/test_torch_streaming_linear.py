"""The port's StreamingLinearRegression / StreamingLogisticRegression
against the JAX package's, on the CPU.

The same micro-batches (numpy, from a seed) go through both streams.

Tolerances, and why:
- the linear state is a float32 sum of batch Grams: the port sums each
  batch per 4,096-row chunk (``chunked_gram``), the JAX package per
  device and ``psum``; on these rows (a feature at mean 10, std 3) each
  package's model sits up to 2.7e-5 (port) and 9.8e-6 (JAX) of the
  largest coefficient from the float64 solution of the same decayed
  normal equations, 2.6e-5 from each other: within 1e-4, and the
  decay-1.0 model within 1e-4 of the largest of the normal-equation fit
  of all rows in float64 (the state's float32 sums, solved with the
  reference's 1e-6 ridge);
- the first batch is exact: the state after it is ``==`` that batch's
  statistics (a·0 + g = g);
- the logistic θ after each batch within 2e-5 of the largest: each
  Newton step's gradient and Hessian are float32 sums in another order
  (the port per 128-row chunk) and the steps carry the rounding.
"""

import types

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models import (
    streaming_linear as psl,
)

torch.set_num_threads(1)

LIN_TOL = 1e-4
WLS_TOL = 1e-4
LOGIT_TOL = 2e-5


def _batches(k=6, n=400, seed=0, drift=0.0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(k):
        x = (rng.normal(size=(n, 3)) * [1.0, 3.0, 0.5] + [0.0, 10.0, 1.0]).astype(np.float32)
        beta = np.array([0.5, -0.2, 1.0]) + drift * i
        y = (x @ beta + 2.0 + rng.normal(size=n) * 0.3).astype(np.float32)
        yb = (rng.random(n) < 1 / (1 + np.exp(-(x @ [0.8, -0.1, 0.5] + 0.3)))).astype(np.float32)
        out.append((x, y, yb))
    return out


def _theta(m):
    coef = m.coefficients.numpy() if hasattr(m.coefficients, "numpy") else m.coefficients
    return np.r_[np.asarray(coef, np.float64), float(m.intercept)]


def _close(a, b, tol):
    ta, tb = _theta(a), _theta(b)
    assert np.abs(ta - tb).max() <= tol * np.abs(tb).max()


@pytest.mark.parametrize("decay,reg", [(1.0, 0.0), (0.7, 0.0), (1.0, 0.01), (0.0, 0.0)])
def test_linear_stream_matches_jax(decay, reg):
    js = J.StreamingLinearRegression(decay_factor=decay, reg_param=reg)
    ps = P.StreamingLinearRegression(decay_factor=decay, reg_param=reg)
    for x, y, _ in _batches(drift=0.1):
        js.update((x, y))
        ps.update((x, y), device="cpu")
        _close(ps.latest_model, js.latest_model, LIN_TOL)
    assert ps.n_batches == js.n_batches == 6


def test_linear_decay_one_is_the_fit_of_all_rows():
    batches = _batches(k=5)
    ps = P.StreamingLinearRegression()
    for x, y, _ in batches:
        ps.update((x, y), device="cpu")
    x = np.concatenate([b[0] for b in batches]).astype(np.float64)
    y = np.concatenate([b[1] for b in batches]).astype(np.float64)
    xa = np.c_[x, np.ones(len(x))]
    want = np.linalg.solve(xa.T @ xa, xa.T @ y)
    got = _theta(ps.latest_model)
    assert np.abs(got - want).max() <= WLS_TOL * np.abs(want).max()


def test_first_batch_is_exact_and_updates_make_no_host_read():
    (x, y, _), = _batches(k=1)
    ps = P.StreamingLinearRegression(decay_factor=0.5).update((x, y), device="cpu")
    g, m, w = psl.lin_batch_stats(torch.from_numpy(x), torch.from_numpy(y), torch.ones(len(y)))
    assert torch.equal(ps._gram, g) and torch.equal(ps._mom, m) and torch.equal(ps._wsum, w)


def test_absorb_partials_takes_a_stand_in_object():
    batches = _batches(k=2)
    direct = P.StreamingLinearRegression(decay_factor=0.9)
    for x, y, _ in batches:
        direct.update((x, y), device="cpu")
    folded = P.StreamingLinearRegression(decay_factor=0.9)
    for x, y, _ in batches:
        g, m, w = psl.lin_batch_stats(torch.from_numpy(x), torch.from_numpy(y),
                                      torch.ones(len(y)))
        merged = types.SimpleNamespace(family="linear", stats={
            "gram": g.numpy(), "mom": m.numpy(), "sw": np.float32(w)})
        folded.absorb_partials(merged)
    assert torch.equal(folded._gram, direct._gram) and folded.n_batches == 2
    # the JAX stream folds the same stand-in the same way
    js = J.StreamingLinearRegression(decay_factor=0.9)
    js.absorb_partials(merged)
    with pytest.raises(ValueError, match="'linear' partials"):
        folded.absorb_partials(types.SimpleNamespace(family="logistic", stats={}))
    with pytest.raises(ValueError, match="shapes disagree"):
        folded.absorb_partials(types.SimpleNamespace(
            family="linear", stats={"gram": np.eye(4), "mom": np.ones(3), "sw": 1.0}))


@pytest.mark.parametrize("steps,decay,reg", [(1, 1.0, 0.0), (2, 1.0, 0.0), (1, 0.8, 0.0),
                                             (3, 0.9, 0.01)])
def test_logistic_stream_matches_jax(steps, decay, reg):
    js = J.StreamingLogisticRegression(decay_factor=decay, reg_param=reg,
                                       newton_steps_per_batch=steps, threshold=0.4)
    ps = P.StreamingLogisticRegression(decay_factor=decay, reg_param=reg,
                                       newton_steps_per_batch=steps, threshold=0.4)
    for x, _, yb in _batches(seed=3):
        js.update((x, yb))
        ps.update((x, yb), device="cpu")
        _close(ps.latest_model, js.latest_model, LOGIT_TOL)
    m = ps.latest_model
    assert m.n_iter == 6 and m.threshold == 0.4
    assert abs(ps._wsum - js._wsum) == 0.0


def test_checks():
    with pytest.raises(ValueError, match="decay_factor"):
        P.StreamingLinearRegression(decay_factor=1.5)
    with pytest.raises(ValueError, match="decay_factor"):
        P.StreamingLogisticRegression(decay_factor=-0.1)
    with pytest.raises(ValueError, match="newton_steps_per_batch"):
        P.StreamingLogisticRegression(newton_steps_per_batch=0)
    for s in (P.StreamingLinearRegression(), P.StreamingLogisticRegression()):
        with pytest.raises(RuntimeError, match="no batches seen"):
            s.latest_model


def test_state_carried_across_from_jax_continues_the_same_stream():
    batches = _batches(seed=5)
    jl = J.StreamingLinearRegression(decay_factor=0.9)
    jg = J.StreamingLogisticRegression(decay_factor=0.9, newton_steps_per_batch=2)
    for x, y, yb in batches[:3]:
        jl.update((x, y))
        jg.update((x, yb))
    pl = P.streaming_linear_regression_from_jax_arrays(
        np.asarray(jl._gram), np.asarray(jl._mom), np.asarray(jl._wsum),
        n_batches=jl.n_batches, decay_factor=0.9)
    pg = P.streaming_logistic_regression_from_jax_arrays(
        np.asarray(jg._theta), np.asarray(jg._grad_hist), np.asarray(jg._hess_hist),
        wsum=jg._wsum, n_batches=jg.n_batches, decay_factor=0.9, newton_steps_per_batch=2)
    _close(pl.latest_model, jl.latest_model, LIN_TOL)
    for x, y, yb in batches[3:]:
        jl.update((x, y))
        jg.update((x, yb))
        pl.update((x, y), device="cpu")
        pg.update((x, yb), device="cpu")
    _close(pl.latest_model, jl.latest_model, LIN_TOL)
    _close(pg.latest_model, jg.latest_model, LOGIT_TOL)
    assert pl.n_batches == pg.n_batches == 6
