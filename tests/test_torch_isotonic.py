"""The port's IsotonicRegression against the JAX package's, on the CPU.

The fit is host numpy in both packages (the same sort, pooling and PAVA on
the same float64 values), so the boundary tables are equal, ``==``.
Prediction is the port's ``interp`` (``searchsorted`` and a lerp in
float32) against ``jnp.interp`` on boundaries, ties, midpoints, clamps
and a one-point table: within one float32 ulp (rtol 1.2e-7, and 1e-37
absolute), because XLA on the CPU fuses the lerp's multiply-add into one
rounding and flushes subnormal results to zero, where torch rounds twice;
and against ``np.interp`` within 1e-6 relative (numpy interpolates in
float64).
"""

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models import (
    isotonic as piso,
)

torch.set_num_threads(1)

ULP = dict(rtol=1.2e-7, atol=1e-37)


def _data(n=400, seed=0, ties=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    if ties:
        x[:, 1] = np.round(x[:, 1] * 4) / 4          # many duplicate x
    y = (np.sin(x[:, 1]) + 0.3 * rng.normal(size=n)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("isotonic", [True, False])
@pytest.mark.parametrize("ties", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_boundaries_equal_and_predictions_equal_to_jax(isotonic, ties, weighted):
    x, y = _data(ties=ties)
    est = dict(isotonic=isotonic, feature_index=1)
    data = (x, y) if not weighted else (
        x, y, np.random.default_rng(3).uniform(0.0, 2.0, len(y)).astype(np.float32))
    jm = J.IsotonicRegression(**est).fit(data)
    pm = P.IsotonicRegression(**est).fit(data, device="cpu")
    np.testing.assert_array_equal(pm.boundaries, jm.boundaries)
    np.testing.assert_array_equal(pm.predictions, jm.predictions)
    probe = np.r_[x[:, 1], jm.boundaries, np.float32([-10.0, 10.0]),
                  (jm.boundaries[:-1] + jm.boundaries[1:]) / 2].astype(np.float32)
    rows = np.zeros((probe.size, 3), np.float32)
    rows[:, 1] = probe
    got = pm.predict(torch.from_numpy(rows)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.predict(rows)), **ULP)
    np.testing.assert_allclose(got, np.interp(probe, jm.boundaries, jm.predictions), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("xp,fp", [
    ([1.0], [3.0]),                              # one point: constant
    ([0.0, 1.0], [0.0, 2.0]),
    ([0.0, 1.0, 1.0 + 2 ** -23, 5.0], [0.0, 1.0, 1.5, 2.0]),   # a near-duplicate step
    ([-2.0, -1.0, 3.0], [5.0, 5.0, 7.0]),
])
def test_interp_edges_match_jnp_and_numpy(xp, fp):
    import jax.numpy as jnp

    xp32, fp32 = np.float32(xp), np.float32(fp)
    x = np.r_[xp32, xp32 - 0.5, xp32 + 0.5, np.nextafter(xp32, np.float32(np.inf)),
              np.float32([-1e30, 1e30])].astype(np.float32)
    got = piso.interp(torch.from_numpy(x), torch.from_numpy(xp32), torch.from_numpy(fp32))
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp.interp(x, xp32, fp32)), **ULP)
    np.testing.assert_allclose(got.numpy(), np.interp(x, xp32, fp32), rtol=1e-6, atol=1e-6)


def test_out_of_core_slices_the_host_column():
    x, y = _data(seed=2)
    w = np.random.default_rng(2).uniform(0.5, 1.5, len(y)).astype(np.float32)
    jm = J.IsotonicRegression(feature_index=1).fit(J.HostDataset(x, y, w))
    pm = P.IsotonicRegression(feature_index=1).fit(P.HostDataset(x, y, w), device="cpu")
    resident = P.IsotonicRegression(feature_index=1).fit((x, y, w), device="cpu")
    for m in (jm, resident):
        np.testing.assert_array_equal(pm.boundaries, m.boundaries)
        np.testing.assert_array_equal(pm.predictions, m.predictions)


def test_checks():
    x, y = _data(n=20)
    with pytest.raises(ValueError, match="out of range"):
        P.IsotonicRegression(feature_index=3).fit((x, y), device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        P.IsotonicRegression(feature_index=-1).fit(P.HostDataset(x, y), device="cpu")
    with pytest.raises(ValueError, match="needs labels"):
        P.IsotonicRegression().fit(P.HostDataset(x), device="cpu")
    with pytest.raises(ValueError, match="empty dataset"):
        P.IsotonicRegression().fit((x, y, np.zeros(20, np.float32)), device="cpu")


def test_pava_is_the_reference_pava():
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu.models import isotonic as jiso

    rng = np.random.default_rng(9)
    for _ in range(20):
        y, w = rng.normal(size=50), rng.uniform(0.1, 2.0, 50)
        got = piso.pava(y, w)
        np.testing.assert_array_equal(got, jiso._pava(y, w))
        assert np.all(np.diff(got) >= 0)


def test_artifacts_cross_both_ways(tmp_path):
    x, y = _data()
    jm = J.IsotonicRegression(isotonic=False, feature_index=1).fit((x, y))
    _, params, arrays = jm._artifacts()
    cm = P.isotonic_model_from_jax_arrays(**arrays, **params)
    jm.save(str(tmp_path / "j"))
    pl = P.load_model(str(tmp_path / "j"))
    for m in (cm, pl):
        np.testing.assert_allclose(m.predict_numpy(x, device="cpu"), np.asarray(jm.predict(x)),
                                   **ULP)
    pl.save(str(tmp_path / "p"))
    assert (tmp_path / "p" / "arrays.npz").read_bytes() == \
        (tmp_path / "j" / "arrays.npz").read_bytes()
    jl = J.load_model(str(tmp_path / "p"))
    assert jl.isotonic is False and jl.feature_index == 1
