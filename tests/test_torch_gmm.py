"""The port's GaussianMixture against the JAX package's, on the CPU.

Well-separated blobs (n=4,000, d=3, k=4, offset by +50 so the recentering
shift matters) go through the JAX ``GaussianMixture`` on its 8-device CPU
mesh and the port's (``device="cpu"``).

Tolerances, and why:
- the init (k-means++, ten host Lloyd steps, diagonal covariances) is
  bit-equal: the same numpy code on the same sample;
- ``n_iter`` equal, the log-likelihood at rtol 1e-5, means at atol 1e-4,
  covariances at atol 1e-4 and weights at atol 1e-6 (rtol 1e-5 each):
  every EM statistic is a float32 sum over rows, which the JAX package
  reduces per device and psums and the port sums in one order; the
  triangular solves and ``logsumexp`` round differently too;
- predictions equal: the blobs leave no posterior near a tie;
- ``predict_proba`` at atol 1e-5 and ``score`` at rtol 1e-5: float32
  evaluation of the same densities.
"""

import numpy as np
import pytest
import torch

from clustermachinelearningforhospitalnetworks_apache_spark_tpu import (
    GaussianMixture as JaxGMM,
    load_model as jax_load_model,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.models.gmm import (
    _init_params as jax_init_params,
)
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models.gmm import (
    _init_params,
)

torch.set_num_threads(1)

K, D = 4, 3


def _blobs(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 5, (K, D))
    return (c[rng.integers(0, K, n)] + rng.normal(size=(n, D)) + 50.0).astype(np.float32)


@pytest.fixture(scope="module")
def fitted():
    x = _blobs()
    jm = JaxGMM(k=K, max_iter=5, seed=0).fit(x)
    pm = port.GaussianMixture(k=K, max_iter=5, seed=0).fit(x, device="cpu")
    return x, jm, pm


def _assert_params_match(pm, jm):
    assert pm.n_iter == jm.n_iter
    np.testing.assert_allclose(pm.log_likelihood, jm.log_likelihood, rtol=1e-5)
    np.testing.assert_allclose(pm.means, np.asarray(jm.means), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(pm.covariances, np.asarray(jm.covariances),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(pm.weights, np.asarray(jm.weights), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 3])
def test_init_is_bit_equal(seed):
    rng = np.random.default_rng(seed)
    valid = rng.normal(size=(500, D)) * 3.0
    for a, b in zip(_init_params(valid, K, D, seed, 1e-6),
                    jax_init_params(valid, K, D, seed, 1e-6)):
        np.testing.assert_array_equal(a, b)


def test_fit_matches_jax(fitted):
    _, jm, pm = fitted
    _assert_params_match(pm, jm)
    assert pm.summary.log_likelihood == pm.log_likelihood
    assert pm.summary.num_iter == pm.n_iter == 5


def test_predict_proba_and_score_match_jax(fitted):
    x, jm, pm = fitted
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(pm.predict_numpy(x, device="cpu"),
                                  np.asarray(jm.predict_numpy(x)))
    np.testing.assert_allclose(pm.predict_proba(xt).numpy(),
                               np.asarray(jm.predict_proba(x)), atol=1e-5)
    pred, prob = pm.predict_assigned(xt, chunk=999)
    jpred, jprob = jm.predict_assigned(x)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), atol=1e-5)
    np.testing.assert_allclose(pm.score(x, device="cpu"), jm.score(x), rtol=1e-5)


def test_on_iteration_path_equals_fast_path():
    x = _blobs(seed=1)
    fast = port.GaussianMixture(k=K, max_iter=4, tol=0.0, seed=2).fit(x, device="cpu")
    seen = []
    hooked = port.GaussianMixture(k=K, max_iter=4, tol=0.0, seed=2).fit(
        x, device="cpu", on_iteration=lambda it, ll: seen.append((it, ll)))
    assert [it for it, _ in seen] == [1, 2, 3, 4]
    lls = [ll for _, ll in seen]
    assert all(b >= a for a, b in zip(lls, lls[1:]))
    assert hooked.n_iter == fast.n_iter == 4 and hooked.log_likelihood == fast.log_likelihood
    for a in ("means", "covariances", "weights"):
        np.testing.assert_array_equal(getattr(hooked, a), getattr(fast, a))
    # and the JAX package's hook path on the same rows
    jseen = []
    jm = JaxGMM(k=K, max_iter=4, tol=0.0, seed=2).fit(
        x, on_iteration=lambda it, ll: jseen.append((it, ll)))
    assert [it for it, _ in jseen] == [1, 2, 3, 4]
    np.testing.assert_allclose(lls, [ll for _, ll in jseen], rtol=1e-5)
    _assert_params_match(hooked, jm)


def test_convergence_stops_like_jax():
    x = _blobs(seed=2)
    jm = JaxGMM(k=K, max_iter=50, tol=0.5, seed=0).fit(x)
    pm = port.GaussianMixture(k=K, max_iter=50, tol=0.5, seed=0).fit(x, device="cpu")
    assert pm.n_iter < 50
    _assert_params_match(pm, jm)


def test_cross_package_load(fitted, tmp_path):
    x, jm, pm = fitted
    jm.save(str(tmp_path / "jax"))
    pm.save(str(tmp_path / "port"))
    from_jax = port.load_model(str(tmp_path / "jax"))
    from_port = jax_load_model(str(tmp_path / "port"))
    assert type(from_jax).__name__ == type(from_port).__name__ == "GaussianMixtureModel"
    np.testing.assert_array_equal(from_jax.predict_numpy(x, device="cpu"),
                                  np.asarray(jm.predict_numpy(x)))
    np.testing.assert_array_equal(np.asarray(from_port.predict_numpy(x)),
                                  pm.predict_numpy(x, device="cpu"))
    carried = port.gaussian_mixture_model_from_jax_arrays(
        **jm._artifacts()[2], **jm._artifacts()[1])
    np.testing.assert_array_equal(carried.means, np.asarray(jm.means))
    np.testing.assert_allclose(carried.score(x, device="cpu"), jm.score(x), rtol=1e-5)


def test_transform_adds_prediction_and_probability(fitted):
    x, jm, pm = fitted
    cols = {f"f{j}": x[:, j] for j in range(D)}
    pt = pm.transform(port.VectorAssembler(list(cols)).transform(port.Table.from_dict(cols)),
                      device="cpu")
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu import (
        Table as JaxTable, VectorAssembler as JaxAssembler,
    )
    jt = jm.transform(JaxAssembler(list(cols)).transform(JaxTable.from_dict(cols)))
    np.testing.assert_array_equal(pt["prediction"], jt["prediction"])
    np.testing.assert_allclose(pt["probability"], jt["probability"], atol=1e-5)


@pytest.mark.parametrize("option", [
    dict(matmul_precision="bf16"), dict(matmul_precision="high"),
    dict(matmul_precision="default"), dict(matmul_precision="bf16", checkpoint_dir="ck"),
])
def test_unported_options_raise(option, tmp_path):
    # the factor-form E-step came with slice 4c (tests/test_torch_precision.py
    # holds it to the JAX package) and the partials protocol with slice 7c
    # (tests/test_torch_federated.py); what still raises is an unknown
    # precision, and partials asked for without the broadcast state, as in
    # the JAX package
    option = dict(option)
    if "checkpoint_dir" in option:
        option["checkpoint_dir"] = str(tmp_path / "ck")
    m = port.GaussianMixture(k=2, max_iter=3, **option).fit(_blobs(40), device="cpu")
    assert np.isfinite(m.log_likelihood) and m.n_iter >= 1
    with pytest.raises(ValueError, match="matmul_precision"):
        port.GaussianMixture(k=2, matmul_precision="fp8").fit(_blobs(40), device="cpu")
    assert port.GaussianMixture(k=2, **option).supports_partials()
    with pytest.raises(ValueError, match="broadcast FitState"):
        port.GaussianMixture(k=2, **option).partial_fit_stats(_blobs(40), device="cpu")


def test_empty_fit_raises():
    with pytest.raises(ValueError, match="empty"):
        port.GaussianMixture(k=2).fit((_blobs(8), np.zeros(8), np.zeros(8)), device="cpu")
