"""The port's MultilayerPerceptronClassifier, AFTSurvivalRegression and
FMRegressor / FMClassifier against the JAX package's, on the CPU.

The same numpy rows (made from a seed) go through the JAX estimator on its
8-device CPU mesh and the port's (``device="cpu"``).  The L-BFGS fits run
on the port's ``optax.lbfgs`` (``models/_opt.py``; its steps are held to
optax in ``tests/test_torch_lbfgs.py``), the FMs and the out-of-core fits
on its ``optax.adam``.

Tolerances, and why:
- AFT (convex): ``n_iter`` equal at its tol 1e-6 (the stop is the
  algorithm's here: the last loss change is 1e-4 of the loss), β, b and
  log σ within 1e-5 of the largest parameter (1e-7 measured);
- MLP after 1, 2 and 5 iterations: weights within 1e-5 of the largest
  (7.7e-7 measured after 5); the whole 150-iteration fit of a non-convex
  loss amplifies the float32 rounding of the gradients (the weights part
  by O(1) after 80 iterations), so it is held by its outcome: the final
  loss within 0.1 relative (3.4e-2 measured) and the predictions on at
  most 5 % of the rows apart (14 of 300 measured).  The reference is no
  steadier: its own fit on the rows moved by one float32 ulp lands 0.23
  relative away in loss, with 18 rows predicted otherwise (the control
  in the test);
- FM after 100 Adam steps: parameters within 1e-4 of the largest (4.2e-6
  measured) and predictions at rtol 1e-4: Adam divides by √v, so a
  coordinate whose gradient nears 0 carries the last-bit differences of
  the gradients;
- out-of-core minibatch Adam (a few epochs) within the FM limits against
  the JAX package's out-of-core fit over the same block order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.models import aft as jaft
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.models import mlp as jmlp
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.models.base import (
    as_device_dataset as j_as_device_dataset,
)
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P

torch.set_num_threads(1)

PARAM_TOL = 1e-5
FM_TOL = 1e-4
MLP_LOSS_RTOL = 0.1
MLP_ROWS = 0.05


def _aft_data(n=500, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    t = np.exp(x @ [0.3, -0.2, 0.1] + 1.0 + 0.5 * np.log(rng.exponential(size=n)))
    cen = (rng.random(n) < 0.7).astype(np.float32)
    return x, t.astype(np.float32), cen


def _aft_theta(m):
    return np.r_[np.asarray(m.coefficients, np.float64), m.intercept, np.log(m.scale)]


def _jax_aft_n_iter(x, t, cen, max_iter, fit_intercept=True):
    ds = j_as_device_dataset((x, t))
    cp = np.zeros(ds.n_padded, np.float32)
    cp[: cen.shape[0]] = cen
    _, _, it = jaft._fit_aft(ds.x, jnp.log(jnp.maximum(ds.y, 1e-12)), jnp.asarray(cp), ds.w,
                             max_iter, fit_intercept)
    return int(it)


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("max_iter", [3, 100])
def test_aft_matches_jax(fit_intercept, max_iter):
    x, t, cen = _aft_data()
    est = dict(max_iter=max_iter, fit_intercept=fit_intercept)
    jm = J.AFTSurvivalRegression(**est).fit((x, t), censor=cen)
    pm = P.AFTSurvivalRegression(**est).fit((x, t), censor=cen, device="cpu")
    assert pm.fit_info["n_iter"] == _jax_aft_n_iter(x, t, cen, max_iter, fit_intercept)
    assert pm.coefficients.dtype == np.float64 == np.asarray(jm.coefficients).dtype
    tj = _aft_theta(jm)
    assert np.abs(_aft_theta(pm) - tj).max() <= PARAM_TOL * np.abs(tj).max()
    xs = torch.from_numpy(x[:50])
    np.testing.assert_allclose(pm.predict(xs).numpy(), np.asarray(jm.predict(x[:50])),
                               rtol=1e-5)
    q = pm.predict_quantiles(xs).numpy()
    assert q.shape == (50, 9) and np.all(np.diff(q, axis=1) > 0)
    np.testing.assert_allclose(q, np.asarray(jm.predict_quantiles(x[:50])), rtol=1e-5)


def test_aft_censor_column_and_checks():
    x, t, cen = _aft_data(n=80)
    cols = {"a": x[:, 0], "b": x[:, 1], "c": x[:, 2], "length_of_stay": t, "censor": cen}
    pt = P.VectorAssembler(["a", "b", "c"]).transform(P.Table.from_dict(cols))
    jt = J.VectorAssembler(["a", "b", "c"]).transform(J.Table.from_dict(cols))
    pm = P.AFTSurvivalRegression(max_iter=20).fit(pt, device="cpu")
    jm = J.AFTSurvivalRegression(max_iter=20).fit(jt)
    tj = _aft_theta(jm)
    assert np.abs(_aft_theta(pm) - tj).max() <= PARAM_TOL * np.abs(tj).max()
    est = P.AFTSurvivalRegression()
    with pytest.raises(ValueError, match="needs a table input"):
        est.fit((x, t), device="cpu")
    with pytest.raises(KeyError, match="not a column"):
        P.AFTSurvivalRegression(censor_col="nope").fit(pt, device="cpu")
    with pytest.raises(ValueError, match="0.0 \\(censored\\) or 1.0"):
        est.fit((x, t), censor=cen * 2, device="cpu")
    with pytest.raises(ValueError, match="entries but the data has"):
        est.fit((x, t), censor=cen[:-1], device="cpu")
    with pytest.raises(ValueError, match="must be positive"):
        est.fit((x, -t), censor=cen, device="cpu")
    with pytest.raises(ValueError, match="need censor="):
        est.fit(P.HostDataset(x, t), device="cpu")


def test_aft_out_of_core_matches_jax():
    x, t, cen = _aft_data()
    est = dict(max_iter=3)
    pm = P.AFTSurvivalRegression(**est).fit(P.HostDataset(x, t, max_device_rows=128),
                                            censor=cen, device="cpu")
    jm = J.AFTSurvivalRegression(**est).fit(J.HostDataset(x, t, max_device_rows=128),
                                            censor=cen)
    tj = _aft_theta(jm)
    assert np.abs(_aft_theta(pm) - tj).max() <= FM_TOL * np.abs(tj).max()
    with pytest.raises(ValueError, match="entries but the data has"):
        P.AFTSurvivalRegression().fit(P.HostDataset(x, t), censor=cen[:10], device="cpu")


def _mlp_data(n=300, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] ** 2 - x[:, 2] * x[:, 3] + rng.normal(size=n) * 0.5 > 0.3)
    return x, y.astype(np.float32)


def _jax_mlp(x, y, layers, max_iter, tol=1e-6, seed=0):
    ds = j_as_device_dataset((x, y))
    params, loss, it = jmlp._fit_lbfgs(jmlp._init_params(layers, seed), ds.x, ds.y, ds.w,
                                       max_iter, jnp.float32(tol))
    return [np.asarray(a) for wb in params for a in wb], float(loss), int(it)


@pytest.mark.parametrize("max_iter", [1, 2, 5])
def test_mlp_first_iterations_match_jax(max_iter):
    x, y = _mlp_data()
    jw, jloss, jit_ = _jax_mlp(x, y, (4, 8, 2), max_iter)
    pm = P.MultilayerPerceptronClassifier(layers=(4, 8, 2), max_iter=max_iter).fit(
        (x, y), device="cpu")
    assert pm.fit_info["n_iter"] == jit_ == max_iter
    pw = [t.numpy() for wb in pm.weights for t in wb]
    scale = max(np.abs(a).max() for a in jw)
    assert max(np.abs(a - b).max() for a, b in zip(jw, pw)) <= PARAM_TOL * scale
    assert abs(pm.fit_info["loss"] - jloss) <= PARAM_TOL * jloss


def test_mlp_whole_fit_matches_jax_in_loss_and_predictions():
    x, y = _mlp_data()
    layers = (4, 8, 2)
    _, jloss, _ = _jax_mlp(x, y, layers, 150)
    jm = J.MultilayerPerceptronClassifier(layers=layers, max_iter=150).fit((x, y))
    pm = P.MultilayerPerceptronClassifier(layers=layers, max_iter=150).fit((x, y), device="cpu")
    assert abs(pm.fit_info["loss"] - jloss) <= MLP_LOSS_RTOL * jloss
    xs = torch.from_numpy(x)
    rows = int((pm.predict(xs).numpy() != np.asarray(jm.predict(x))).sum())
    assert rows <= MLP_ROWS * len(y)
    # the control: the reference itself, on the rows moved by one float32
    # ulp, lands farther from its own fit than the port does
    _, jloss_ulp, _ = _jax_mlp(np.nextafter(x, np.float32(np.inf)), y, layers, 150)
    assert abs(jloss_ulp - jloss) > abs(pm.fit_info["loss"] - jloss)
    proba = pm.predict_proba(xs).numpy()
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, rtol=1e-6)
    assert pm.predict_raw(xs).shape == (300, 2) and pm.num_classes == 2
    # a fit spends one host read an evaluation and one a step
    info = pm.fit_info
    assert info["host_reads"] == info["evaluations"] + info["n_iter"]


def test_mlp_three_classes_and_weights():
    x, y = _mlp_data(seed=4)
    y3 = (y + (x[:, 0] > 1.0)).astype(np.float32)
    w = np.random.default_rng(4).uniform(0.5, 1.5, len(y)).astype(np.float32)
    jw, _, jit_ = None, None, None
    pm = P.MultilayerPerceptronClassifier(layers=(4, 6, 3), max_iter=3, seed=2).fit(
        (x, y3, w), device="cpu")
    jm = J.MultilayerPerceptronClassifier(layers=(4, 6, 3), max_iter=3, seed=2).fit((x, y3, w))
    jw = [np.asarray(a) for wb in jm.weights for a in wb]
    pw = [t.numpy() for wb in pm.weights for t in wb]
    scale = max(np.abs(a).max() for a in jw)
    assert max(np.abs(a - b).max() for a, b in zip(jw, pw)) <= PARAM_TOL * scale


def test_mlp_checks():
    x, y = _mlp_data(n=40)
    for bad, match in ((dict(layers=(4, 2), solver="gd"), "solver must be"),
                       (dict(layers=(4,)), "layers must name"),
                       (dict(layers=(3, 2)), "layers\\[0\\]=3")):
        with pytest.raises(ValueError, match=match):
            P.MultilayerPerceptronClassifier(**bad).fit((x, y), device="cpu")
    with pytest.raises(ValueError, match="labels must be integers"):
        P.MultilayerPerceptronClassifier(layers=(4, 2)).fit((x, y * 2), device="cpu")
    with pytest.raises(ValueError, match="labels must be integers"):
        P.MultilayerPerceptronClassifier(layers=(4, 2)).fit((x, y + 0.5), device="cpu")
    with pytest.raises(ValueError, match="labels must be integers"):
        P.MultilayerPerceptronClassifier(layers=(4, 2)).fit(P.HostDataset(x, y * 3),
                                                            device="cpu")
    with pytest.raises(ValueError, match="empty dataset"):
        P.MultilayerPerceptronClassifier(layers=(4, 2)).fit(
            P.HostDataset(x, y, np.zeros(40, np.float32)), device="cpu")


def test_mlp_initial_weights_are_bit_equal_to_the_reference():
    jp = jmlp._init_params((4, 16, 2), 7)
    pp = P.models.mlp.init_params((4, 16, 2), 7, "cpu")
    for a, b in zip([np.asarray(t) for wb in jp for t in wb], pp):
        np.testing.assert_array_equal(a, b.numpy())


def test_mlp_out_of_core_matches_jax():
    x, y = _mlp_data()
    est = dict(layers=(4, 8, 2), max_iter=4, seed=3)
    pm = P.MultilayerPerceptronClassifier(**est).fit(P.HostDataset(x, y, max_device_rows=64),
                                                     device="cpu")
    jm = J.MultilayerPerceptronClassifier(**est).fit(J.HostDataset(x, y, max_device_rows=64))
    jw = [np.asarray(a) for wb in jm.weights for a in wb]
    pw = [t.numpy() for wb in pm.weights for t in wb]
    scale = max(np.abs(a).max() for a in jw)
    assert max(np.abs(a - b).max() for a, b in zip(jw, pw)) <= FM_TOL * scale
    assert pm.fit_info["n_iter"] == 4


def test_mlp_out_of_core_plateau_stop():
    x, y = _mlp_data()
    pm = P.MultilayerPerceptronClassifier(layers=(4, 2), max_iter=50, tol=1.0).fit(
        P.HostDataset(x, y, max_device_rows=64), device="cpu")
    assert pm.fit_info["n_iter"] == 2     # the second epoch's loss moves by < 1


def _fm_data(n=400, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = (x @ [1.0, 2.0, 0.5, 0.3] + 0.7 * x[:, 0] * x[:, 1] + rng.normal(size=n) * 0.1)
    return x, y.astype(np.float32), (y > 0.5).astype(np.float32)


def _fm_params(m):
    return [np.asarray(m.intercept, np.float64).reshape(1),
            np.asarray(m.linear if isinstance(m.linear, np.ndarray) else m.linear.numpy()),
            np.asarray(m.factors if isinstance(m.factors, np.ndarray) else m.factors.numpy())]


def _fm_close(pm, jm, tol=FM_TOL):
    pp, jp = _fm_params(pm), _fm_params(jm)
    scale = max(np.abs(a).max() for a in jp)
    assert max(np.abs(a - b).max() for a, b in zip(jp, pp)) <= tol * scale


@pytest.mark.parametrize("cls,label", [("FMRegressor", 1), ("FMClassifier", 2)])
@pytest.mark.parametrize("options", [{}, {"reg_param": 0.01, "factor_size": 3, "seed": 5}])
def test_fm_matches_jax(cls, label, options):
    data = _fm_data()
    x, y = data[0], data[label]
    jm = getattr(J, cls)(max_iter=100, **options).fit((x, y))
    pm = getattr(P, cls)(max_iter=100, **options).fit((x, y), device="cpu")
    _fm_close(pm, jm)
    assert pm.task == jm.task and pm.factor_size == jm.factor_size
    xs = torch.from_numpy(x)
    np.testing.assert_allclose(pm.predict_raw(xs).numpy(), np.asarray(jm.predict_raw(x)),
                               rtol=FM_TOL, atol=FM_TOL)
    if cls == "FMClassifier":
        proba = pm.predict_proba(xs).numpy()
        assert ((proba > 0.5) == (pm.predict(xs).numpy() > 0)).all()
    else:
        with pytest.raises(ValueError, match="classification-only"):
            pm.predict_proba(xs)


def test_fm_logistic_loss_is_logaddexp_not_the_thresholded_softplus():
    # jax.nn.softplus is logaddexp(x, 0); torch's softplus returns x itself
    # above its threshold 20 (here in float64, where the two differ)
    f64 = torch.float64
    loss = P.models.fm.fm_loss(torch.zeros((1, 1), dtype=f64), torch.zeros(1, dtype=f64),
                               torch.ones(1, dtype=f64), 0.0, "logistic")
    margin = 25.0           # label 0: the loss is softplus(+raw)
    got = loss([torch.tensor(margin, dtype=f64), torch.zeros(1, dtype=f64),
                torch.zeros((1, 1), dtype=f64)])
    assert float(got) == float(np.logaddexp(margin, 0.0)) != margin
    assert float(torch.nn.functional.softplus(torch.tensor(margin, dtype=f64))) == margin


def test_fm_checks_and_out_of_core():
    x, y, yb = _fm_data()
    with pytest.raises(ValueError, match="binary"):
        P.FMClassifier().fit((x, y), device="cpu")
    with pytest.raises(ValueError, match="binary"):
        P.FMClassifier().fit(P.HostDataset(x, y), device="cpu")
    with pytest.raises(ValueError, match="factor_size"):
        P.FMRegressor(factor_size=0).fit((x, y), device="cpu")
    with pytest.raises(ValueError, match="empty dataset"):
        P.FMRegressor().fit(P.HostDataset(x, y, np.zeros(len(y), np.float32)), device="cpu")
    for cls, lab in (("FMRegressor", y), ("FMClassifier", yb)):
        jm = getattr(J, cls)(max_iter=3).fit(J.HostDataset(x, lab, max_device_rows=128))
        pm = getattr(P, cls)(max_iter=3).fit(P.HostDataset(x, lab, max_device_rows=128),
                                             device="cpu")
        _fm_close(pm, jm)


@pytest.mark.parametrize("kind", ["mlp", "aft", "fm"])
def test_artifacts_cross_both_ways_through_convert(kind, tmp_path):
    if kind == "mlp":
        x, y = _mlp_data(n=120)
        jm = J.MultilayerPerceptronClassifier(layers=(4, 5, 2), max_iter=5).fit((x, y))
        conv = P.mlp_model_from_jax_arrays
    elif kind == "aft":
        x, t, cen = _aft_data(n=120)
        jm = J.AFTSurvivalRegression(max_iter=10).fit((x, t), censor=cen)
        conv = P.aft_model_from_jax_arrays
    else:
        x, _, yb = _fm_data(n=120)
        jm = J.FMClassifier(max_iter=10).fit((x, yb))
        conv = P.fm_model_from_jax_arrays
    _, params, arrays = jm._artifacts()
    cm = conv(**arrays, **params)
    jm.save(str(tmp_path / "j"))
    pl = P.load_model(str(tmp_path / "j"))
    for m in (cm, pl):
        # the same parameters; AFT's exp and the MLP's sigmoid differ in the
        # last bit between the backends, the class predictions not at all
        np.testing.assert_allclose(m.predict_numpy(x, device="cpu"),
                                   np.asarray(jm.predict(x)), rtol=1e-6)
    pl.save(str(tmp_path / "p"))
    assert (tmp_path / "p" / "arrays.npz").read_bytes() == \
        (tmp_path / "j" / "arrays.npz").read_bytes()
    jl = J.load_model(str(tmp_path / "p"))
    np.testing.assert_array_equal(np.asarray(jl.predict(x)), np.asarray(jm.predict(x)))
