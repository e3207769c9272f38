"""The port's cross-silo federation (``federated/`` and the partials
protocol of LinearRegression, KMeans and GaussianMixture) against the JAX
package's, and against the port's own pooled fits, on the CPU.

The same numpy-seeded silos go through both coordinators: the JAX one on
a one-device mesh, the port's with ``device="cpu"`` (silos and
coordinator).  The cases of ``tests/test_federated.py`` that apply to one
device are here; its mesh8 case belongs to the multi-device slice.

Tolerances, and why:
- host pieces are ``==`` the JAX package's: merges, noise draws, journal
  payloads and lines (but the rounds' wall-clock timings), quorum, the
  init round's candidate pool and start state, and every ``RoundReport``'s
  contributed and dropped silos — the same numpy code on the same bytes;
- LinearRegression within 1e-4 of the largest coefficient (intercept
  too), the bound of ``tests/test_torch_linear_regression.py``: the merged
  Gram is the same exact integer sums on integer rows, but the JAX
  package solves with XLA's LU and the port with LAPACK's, and on float
  rows each package sums a silo's Gram in its own order;
- KMeans: ``n_iter`` and cluster sizes equal (tie-free blobs); centers at
  rtol 1e-5 with atol 1e-5 x the data's scale and the training cost at
  rtol 1e-5, the bounds of ``tests/test_torch_kmeans.py``: each silo's
  Lloyd sums run through XLA in one package and through K1's plain
  version (``index_add_``) in the other, in other orders;
- GaussianMixture: ``n_iter`` equal, the log-likelihood at rtol 1e-5,
  means and covariances at atol 1e-4 and weights at atol 1e-6 (rtol 1e-5
  each), the bounds of ``tests/test_torch_gmm.py``: the E-step sums,
  triangular solves and ``logsumexp`` round differently in XLA and torch.

Against the port's own pooled fit:
- GaussianMixture, warm-started, each silo one ``chunk_rows`` chunk:
  ``==`` (``_em_pass`` folds zero-initialized chunks in order, which is
  exactly the merge's ascending fold);
- LinearRegression and KMeans on integer-valued rows: coefficients,
  centers, sizes and ``n_iter`` ``==`` (every float32 sum of the
  statistics is exact); the KMeans training cost at rtol 1e-6, because it
  sums non-integer squared distances, per silo and then across silos,
  against one pooled sum;
- KMeans on float rows: centers within 1e-5 x the data's scale and the
  cost at rtol 1e-5 (K1's plain version sums a silo's rows in row order
  from zero, the pooled fit all rows; ROADMAP "Decided").
"""

import json
import os

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
from clustermachinelearningforhospitalnetworks_apache_spark_tpu import federated as JF
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.utils import faults as jfaults
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.utils.retry import (
    RetryPolicy as JRetry,
)
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import federated as PF
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.federated import (
    FED_BROADCAST_SITE,
    FED_COLLECT_SITE,
    FED_FIT_SITE,
    FED_MERGE_SITE,
    FederatedConfig,
    FederatedCoordinator,
    FederatedQuorumError,
    NoiseConfig,
    Partials,
    Silo,
    apply_clipped_noise,
    merge_partials,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models.base import (
    Estimator,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.streaming.wal import (
    read_lines,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults

torch.set_num_threads(1)

N_SILOS, ROWS, D = 4, 512, 4
FED_SITES = [FED_COLLECT_SITE, FED_MERGE_SITE, FED_FIT_SITE, FED_BROADCAST_SITE]
LR_TOL = 1e-4                   # x the largest coefficient
KM_RTOL = 1e-5                  # centers (atol x scale) and cost
GMM_TOL = {"ll": 1e-5, "means": 1e-4, "covariances": 1e-4, "weights": 1e-6}


@pytest.fixture(autouse=True)
def _flight_dumps_under_tmp(tmp_path, monkeypatch):
    """Injected crashes write postmortems; keep them in the test's tree."""
    monkeypatch.setenv("CMLHN_FLIGHT_DIR", str(tmp_path / "flight"))


# ------------------------------------------------------------------ data
def _int_xy(n_rows: int, d: int = D, seed: int = 0):
    """Integer-valued f32 rows: every partial sum is exact in f32."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-8, 8, size=(n_rows, d)).astype(np.float32)
    y = (x @ np.arange(1, d + 1).astype(np.float32) + 1.0).astype(np.float32)
    return x, y


def _blobs(n_rows: int, d: int = D, seed: int = 1):
    rng = np.random.default_rng(seed)
    x = np.concatenate(
        [rng.normal(c, 1.0, size=(n_rows // 3 + 1, d)) for c in (0.0, 6.0, -6.0)]
    )[:n_rows].astype(np.float32)
    rng.shuffle(x)
    return x


def _int_blobs(n_rows: int, d: int = D, seed: int = 3):
    """Integer-valued blobs: exact Lloyd sums, and assignments well clear
    of ties."""
    rng = np.random.default_rng(seed)
    x = np.concatenate(
        [rng.integers(-3, 4, size=(n_rows // 3 + 1, d)) + c for c in (0, 20, -20)]
    )[:n_rows].astype(np.float32)
    rng.shuffle(x)
    return x


def _silos(x, y=None, n=N_SILOS, rows=ROWS, jax=False):
    out = []
    for i in range(n):
        sl = slice(i * rows, (i + 1) * rows)
        data = x[sl] if y is None else (x[sl], y[sl])
        out.append(JF.Silo(f"s{i}", data) if jax else Silo(f"s{i}", data, device="cpu"))
    return out


def _fast_cfg(jax=False, **kw):
    policy = JRetry if jax else P.utils.RetryPolicy
    kw.setdefault("retry", policy(max_attempts=3, base_delay_s=0.0, max_delay_s=0.0))
    kw.setdefault("breaker_recovery_s", 0.0)
    return (JF.FederatedConfig if jax else FederatedConfig)(**kw)


def _coord(est, silos, cfg=None):
    return FederatedCoordinator(est, silos, cfg or _fast_cfg(), device="cpu")


def _jcoord(est, silos, cfg=None):
    return JF.FederatedCoordinator(est, silos, cfg or _fast_cfg(jax=True))


def _km_kw(x, **kw):
    kw.setdefault("k", 3)
    kw.setdefault("max_iter", 15)
    kw.setdefault("warm_start_centers", x[: kw["k"]].copy())
    kw.setdefault("chunk_rows", ROWS)
    return kw


def _gm_kw(x, **kw):
    k = kw.setdefault("k", 3)
    kw.setdefault("max_iter", 8)
    kw.setdefault("tol", 1e-3)
    kw.setdefault("chunk_rows", ROWS)
    kw.setdefault("warm_start_params", (
        np.full((k,), 1.0 / k, np.float32),
        x[:k].astype(np.float32),
        np.stack([np.eye(D, dtype=np.float32) * 4.0] * k),
    ))
    return kw


def _km(**kw):
    x = _blobs(N_SILOS * ROWS)
    return P.KMeans(**_km_kw(x, **kw)), x


def _gm(**kw):
    x = _blobs(N_SILOS * ROWS, seed=2)
    return P.GaussianMixture(**_gm_kw(x, **kw)), x


def _assert_kmeans_equal(a, b, exact_cost=True):
    assert np.array_equal(np.asarray(a.cluster_centers), np.asarray(b.cluster_centers))
    if exact_cost:
        assert float(a.training_cost) == float(b.training_cost)
    else:
        np.testing.assert_allclose(float(a.training_cost), float(b.training_cost), rtol=1e-6)
    assert a.n_iter == b.n_iter
    assert np.array_equal(np.asarray(a.cluster_sizes), np.asarray(b.cluster_sizes))


def _assert_gmm_equal(a, b):
    # federated GMM runs unshifted; −0.0 vs +0.0 may differ from the pooled
    # path's shift arithmetic — array_equal treats them as equal
    assert np.array_equal(np.asarray(a.weights), np.asarray(b.weights))
    assert np.array_equal(np.asarray(a.means), np.asarray(b.means))
    assert np.array_equal(np.asarray(a.covariances), np.asarray(b.covariances))
    assert float(a.log_likelihood) == float(b.log_likelihood)
    assert a.n_iter == b.n_iter


def _coef(m):
    c = m.coefficients
    return c.numpy() if isinstance(c, torch.Tensor) else np.asarray(c)


def _assert_lr_close(jm, pm):
    scale = float(np.abs(np.asarray(jm.coefficients)).max())
    np.testing.assert_allclose(_coef(pm), np.asarray(jm.coefficients), rtol=0,
                               atol=LR_TOL * scale)
    assert abs(float(pm.intercept) - float(jm.intercept)) <= LR_TOL * scale


def _assert_km_close(jm, pm, scale):
    assert pm.n_iter == jm.n_iter
    np.testing.assert_array_equal(pm.cluster_sizes, np.asarray(jm.cluster_sizes))
    np.testing.assert_allclose(pm.cluster_centers, np.asarray(jm.cluster_centers),
                               rtol=KM_RTOL, atol=KM_RTOL * scale)
    np.testing.assert_allclose(pm.training_cost, jm.training_cost, rtol=KM_RTOL)


def _assert_gmm_close(jm, pm):
    assert pm.n_iter == jm.n_iter
    np.testing.assert_allclose(pm.log_likelihood, jm.log_likelihood, rtol=GMM_TOL["ll"])
    for name in ("means", "covariances", "weights"):
        np.testing.assert_allclose(getattr(pm, name), np.asarray(getattr(jm, name)),
                                   rtol=1e-5, atol=GMM_TOL[name])


def _rounds(res):
    return [(r.round_id, r.contributed, r.dropped, r.done) for r in res.rounds]


# ------------------------------------------------- per-family bit parity
def test_linear_federated_matches_pooled_bitwise():
    x, y = _int_xy(N_SILOS * ROWS)
    est = P.LinearRegression(reg_param=0.1)
    pooled = est.fit((x, y), device="cpu")
    silos = _silos(x, y)
    res = _coord(est, silos).fit()
    assert np.array_equal(_coef(pooled), _coef(res.model))
    assert float(pooled.intercept) == float(res.model.intercept)
    (r,) = res.rounds
    assert r.contributed == ("s0", "s1", "s2", "s3") and r.done
    assert all(len(s.received_models) == 1 for s in silos)


def test_kmeans_federated_matches_pooled_bitwise_on_integer_rows():
    x = _int_blobs(N_SILOS * ROWS)
    km = P.KMeans(**_km_kw(x, max_iter=10))
    pooled = km.fit(x, device="cpu")
    res = _coord(km, _silos(x)).fit()
    _assert_kmeans_equal(pooled, res.model, exact_cost=False)
    assert res.rounds[-1].done
    assert res.state.version == pooled.n_iter


def test_kmeans_federated_against_pooled_on_float_rows():
    km, x = _km()
    pooled = km.fit(x, device="cpu")
    res = _coord(km, _silos(x)).fit()
    m = res.model
    assert m.n_iter == pooled.n_iter
    np.testing.assert_array_equal(m.cluster_sizes, pooled.cluster_sizes)
    scale = float(np.abs(x).max())
    np.testing.assert_allclose(m.cluster_centers, pooled.cluster_centers, rtol=0,
                               atol=KM_RTOL * scale)
    np.testing.assert_allclose(m.training_cost, pooled.training_cost, rtol=KM_RTOL)


def test_gmm_federated_matches_pooled_bitwise():
    gm, x = _gm()
    pooled = gm.fit(x, device="cpu")
    res = _coord(gm, _silos(x)).fit()
    _assert_gmm_equal(pooled, res.model)


def test_federated_result_independent_of_silo_registration_order():
    km, x = _km()
    a = _coord(km, _silos(x)).fit()
    b = _coord(km, list(reversed(_silos(x)))).fit()
    _assert_kmeans_equal(a.model, b.model)


# ------------------------------------------- against the JAX package
@pytest.mark.parametrize("family", ["linear", "kmeans", "gmm", "kmeans_init", "gmm_init"])
def test_federated_fits_hold_to_the_jax_package(family):
    """The same silos through both coordinators: the models within the
    module's limits, every round's contributed / dropped silos ``==``,
    and the data-dependent init round's start state ``==``."""
    if family == "linear":
        rng = np.random.default_rng(0)
        x = rng.normal(size=(N_SILOS * ROWS, D)).astype(np.float32)
        y = (x @ np.arange(1, D + 1) + rng.normal(size=len(x))).astype(np.float32)
        kw = {"reg_param": 0.1}
        jr = _jcoord(J.LinearRegression(**kw), _silos(x, y, jax=True)).fit()
        pr = _coord(P.LinearRegression(**kw), _silos(x, y)).fit()
        _assert_lr_close(jr.model, pr.model)
    elif family.startswith("kmeans"):
        x = _blobs(N_SILOS * ROWS, seed=6)
        kw = (_km_kw(x) if family == "kmeans"
              else dict(k=3, max_iter=10, chunk_rows=ROWS, init_sample_size=ROWS))
        jr = _jcoord(J.KMeans(**kw), _silos(x, jax=True)).fit()
        pr = _coord(P.KMeans(**kw), _silos(x)).fit()
        _assert_km_close(jr.model, pr.model, float(np.abs(x).max()))
    else:
        x = _blobs(N_SILOS * ROWS, seed=8)
        kw = (_gm_kw(x) if family == "gmm"
              else dict(k=2, max_iter=4, tol=1e-3, chunk_rows=ROWS, init_sample_size=ROWS))
        jr = _jcoord(J.GaussianMixture(**kw), _silos(x, jax=True)).fit()
        pr = _coord(P.GaussianMixture(**kw), _silos(x)).fit()
        _assert_gmm_close(jr.model, pr.model)
    assert _rounds(pr) == _rounds(jr)
    if family.endswith("_init"):
        # the candidate round is host numpy on the same rows: bit-equal
        est = (P.KMeans if family == "kmeans_init" else P.GaussianMixture)(**kw)
        jest = (J.KMeans if family == "kmeans_init" else J.GaussianMixture)(**kw)
        ps = _coord(est, _silos(x))._federated_init({})
        js = _jcoord(jest, _silos(x, jax=True))._federated_init({})
        assert ps.to_payload() == js.to_payload()


# ------------------------------------------------ dropout / straggler
def test_transient_silo_failure_recovers_bit_tight():
    """Two collect faults on one silo are absorbed by the in-round retry
    ladder — the fit is IDENTICAL to the clean one."""
    km, x = _km()
    clean = _coord(km, _silos(x)).fit()
    silos = _silos(x)
    plan = faults.FaultPlan().fail(
        FED_COLLECT_SITE, times=2, when=lambda ctx: ctx.get("silo") == "s2"
    )
    with faults.active(plan):
        res = _coord(km, silos).fit()
    assert plan.fired(FED_COLLECT_SITE) == 2
    _assert_kmeans_equal(clean.model, res.model)
    s2 = next(s for s in silos if s.silo_id == "s2")
    s0 = next(s for s in silos if s.silo_id == "s0")
    assert s2.compute_calls == s0.compute_calls


def test_linear_late_partial_folds_exactly():
    """A silo that misses round 0 entirely lands in a later attempt round;
    the zero-init ascending merge folds its late partial into the SAME
    bits as an on-time run, and the round reports are the JAX package's."""
    x, y = _int_xy(N_SILOS * ROWS, seed=4)
    est = P.LinearRegression(reg_param=0.1)
    pooled = est.fit((x, y), device="cpu")
    plan = faults.FaultPlan().fail(
        FED_COLLECT_SITE, times=3, when=lambda ctx: ctx.get("silo") == "s1"
    )
    with faults.active(plan):
        res = _coord(est, _silos(x, y)).fit()
    assert plan.fired(FED_COLLECT_SITE) == 3
    assert len(res.rounds) == 2
    assert res.rounds[0].dropped == ("s1",) and not res.rounds[0].done
    assert res.rounds[1].contributed == ("s0", "s1", "s2", "s3")
    assert np.array_equal(_coef(pooled), _coef(res.model))
    jplan = jfaults.FaultPlan().fail(
        FED_COLLECT_SITE, times=3, when=lambda ctx: ctx.get("silo") == "s1"
    )
    with jfaults.active(jplan):
        jres = _jcoord(J.LinearRegression(reg_param=0.1), _silos(x, y, jax=True)).fit()
    assert _rounds(res) == _rounds(jres)


def test_hard_dropout_completes_round_with_quorum():
    km, x = _km(max_iter=5)
    silos = _silos(x)

    def s3_down(ctx):
        return ctx.get("silo") == "s3"

    plan = faults.FaultPlan().fail(FED_COLLECT_SITE, times=None, when=s3_down)
    with faults.active(plan):
        res = _coord(km, silos, _fast_cfg(quorum=0.5)).fit()
    assert all("s3" not in r.contributed for r in res.rounds)
    assert res.model.n_iter >= 1
    # the broadcast still reaches the dropped silo so it can rejoin
    s3 = next(s for s in silos if s.silo_id == "s3")
    assert len(s3.received_versions) == len(res.rounds)
    jplan = jfaults.FaultPlan().fail(FED_COLLECT_SITE, times=None, when=s3_down)
    with jfaults.active(jplan):
        jres = _jcoord(J.KMeans(**_km_kw(x, max_iter=5)), _silos(x, jax=True),
                       _fast_cfg(jax=True, quorum=0.5)).fit()
    assert _rounds(res) == _rounds(jres)


def test_quorum_failure_raises():
    km, x = _km(max_iter=3)
    plan = faults.FaultPlan().fail(
        FED_COLLECT_SITE, times=None,
        when=lambda ctx: ctx.get("silo") in ("s1", "s2", "s3"),
    )
    with faults.active(plan):
        with pytest.raises(FederatedQuorumError, match="only 1/4 silos contributed"):
            _coord(km, _silos(x), _fast_cfg(quorum=0.75)).fit()


# ------------------------------------------------------- merge contract
def _rand_parts(family="linear", n=5, seed=7):
    rng = np.random.default_rng(seed)
    return [
        dict(family=family, stats={"g": rng.normal(size=(3, 3)).astype(np.float32)},
             n_rows=10.0 + i, silo_id=f"s{i}")
        for i in range(n)
    ]


def test_merge_is_arrival_order_independent():
    parts = [Partials(**p) for p in _rand_parts()]
    ref = merge_partials(parts)
    out = merge_partials([parts[i] for i in (3, 0, 4, 2, 1)])
    assert np.array_equal(ref.stats["g"], out.stats["g"])
    assert ref.sources == out.sources == ("s0", "s1", "s2", "s3", "s4")


@pytest.mark.parametrize("weights", [None, {"s0": 3.0, "s2": 0.5}])
def test_merge_equals_the_jax_package(weights):
    """The fold and the weighting are the reference's numpy on the same
    bytes: the merged payloads ``==``."""
    raw = _rand_parts()
    mine = merge_partials([Partials(**p) for p in raw], weights)
    ref = JF.merge_partials([JF.Partials(**p) for p in raw], weights)
    assert mine.to_payload() == ref.to_payload()


def test_merge_rejects_mixed_versions_and_families():
    a = Partials(family="linear", stats={"g": np.ones(2, np.float32)},
                 silo_id="a", state_version=0)
    b = Partials(family="linear", stats={"g": np.ones(2, np.float32)},
                 silo_id="b", state_version=1)
    with pytest.raises(ValueError, match="state version"):
        merge_partials([a, b])
    c = Partials(family="kmeans", stats={"g": np.ones(2, np.float32)},
                 silo_id="c", state_version=0)
    with pytest.raises(ValueError, match="family"):
        merge_partials([a, c])


def test_partials_journal_payload_roundtrip_is_exact():
    rng = np.random.default_rng(11)
    p = Partials(
        family="gmm",
        stats={
            "nk": rng.normal(size=(3,)).astype(np.float32),
            "outer": rng.normal(size=(3, 4, 4)).astype(np.float32),
        },
        n_rows=123.0, silo_id="s1", round_id=4, state_version=4,
    )
    q = Partials.from_payload(p.to_payload())
    for k in p.stats:
        assert np.array_equal(p.stats[k], q.stats[k])
        assert p.stats[k].dtype == q.stats[k].dtype
    assert (q.silo_id, q.round_id, q.state_version) == ("s1", 4, 4)
    # the payloads cross between the packages byte for byte
    j = JF.Partials.from_payload(json.loads(json.dumps(p.to_payload())))
    assert json.dumps(j.to_payload()) == json.dumps(p.to_payload())
    st = PF.FitState(family="kmeans", version=3,
                     params={"centers": rng.normal(size=(2, 4)).astype(np.float32)},
                     meta={"cost": 1.5})
    assert JF.FitState.from_payload(st.to_payload()).to_payload() == st.to_payload()


def test_weighting_scales_contribution_and_row_mass():
    a = Partials(family="linear", stats={"g": np.full(2, 2.0, np.float32)},
                 n_rows=10.0, silo_id="a")
    b = Partials(family="linear", stats={"g": np.full(2, 4.0, np.float32)},
                 n_rows=10.0, silo_id="b")
    merged = merge_partials([a, b], weights={"a": 3.0, "b": 1.0})
    assert np.array_equal(merged.stats["g"], np.full(2, 10.0, np.float32))
    assert merged.n_rows == 40.0
    # the unweighted fold skips the multiply entirely (bit-parity path)
    plain = merge_partials([a, b])
    assert np.array_equal(plain.stats["g"], np.full(2, 6.0, np.float32))


# ------------------------------------------------------------- noise knob
def test_clipped_noise_is_deterministic_and_flagged():
    raw = dict(family="linear", stats={"g": np.full((4,), 100.0, np.float32)},
               n_rows=5.0, silo_id="s0", round_id=2)
    p = Partials(**raw)
    cfg = NoiseConfig(clip_norm=1.0, noise_multiplier=0.5, seed=9)
    a, b = apply_clipped_noise(p, cfg), apply_clipped_noise(p, cfg)
    assert a.noised and np.array_equal(a.stats["g"], b.stats["g"])
    assert not np.array_equal(a.stats["g"], p.stats["g"])
    # the same default_rng([seed, round, crc32(silo)]) draws as the reference
    j = JF.apply_clipped_noise(JF.Partials(**raw), JF.NoiseConfig(clip_norm=1.0,
                                                                  noise_multiplier=0.5,
                                                                  seed=9))
    assert a.to_payload() == j.to_payload()
    # a no-op config ships the partial untouched (bit-parity preserved)
    clean = apply_clipped_noise(p, NoiseConfig(clip_norm=1e9, noise_multiplier=0.0))
    assert clean is p and not clean.noised


def test_noise_knob_end_to_end_close_but_marked():
    x, y = _int_xy(N_SILOS * ROWS, seed=5)
    est = P.LinearRegression(reg_param=0.1)
    pooled = est.fit((x, y), device="cpu")
    noise = NoiseConfig(clip_norm=1e9, noise_multiplier=1e-9, seed=3)
    res = _coord(est, _silos(x, y), _fast_cfg(noise=noise)).fit()
    np.testing.assert_allclose(_coef(pooled), _coef(res.model), rtol=1e-3, atol=1e-3)
    res2 = _coord(est, _silos(x, y), _fast_cfg(noise=noise)).fit()
    assert np.array_equal(_coef(res.model), _coef(res2.model))


# -------------------------------------------------------- federated init
def test_kmeans_federated_init_without_warm_start():
    x = _blobs(N_SILOS * ROWS, seed=6)
    km = P.KMeans(k=3, max_iter=10, chunk_rows=ROWS, init_sample_size=ROWS)
    silos = _silos(x)
    res = _coord(km, silos).fit()
    assert res.model.cluster_centers.shape == (3, D)
    assert float(res.model.training_cost) > 0.0
    # candidate init counts as one extra collect per silo
    assert silos[0].compute_calls == res.state.version + 2


def test_gmm_federated_init_without_warm_start():
    x = _blobs(N_SILOS * ROWS, seed=8)
    gm = P.GaussianMixture(k=2, max_iter=4, tol=1e-3, chunk_rows=ROWS, init_sample_size=ROWS)
    res = _coord(gm, _silos(x)).fit()
    assert res.model.means.shape == (2, D)
    assert np.isfinite(res.model.log_likelihood)
    assert abs(float(np.sum(res.model.weights)) - 1.0) < 1e-5


# -------------------------------------------------------- estimator API
def test_partials_protocol_surface():
    assert P.LinearRegression().supports_partials()
    # the elastic-net path centers on the pooled mean — not decomposable
    assert not P.LinearRegression(reg_param=0.1, elastic_net_param=0.5).supports_partials()
    assert P.KMeans().supports_partials() and P.KMeans().partials_final_collect()
    assert P.KMeans(max_iter=7).partials_max_rounds() == 7
    assert P.GaussianMixture().supports_partials()
    assert not P.GaussianMixture().partials_final_collect()
    assert P.LinearRegression().partials_max_rounds() == 1
    with pytest.raises(ValueError, match="FitState"):
        P.KMeans().partial_fit_stats(np.zeros((4, 2), np.float32), device="cpu")
    with pytest.raises(ValueError, match="FitState"):
        P.GaussianMixture().fit_from_partials(None)

    class Plain(Estimator):
        def fit(self, data, label_col=None, device=None):  # pragma: no cover
            return None

    p = Plain()
    assert not p.supports_partials()
    for call in (lambda: p.partial_fit_stats(None), lambda: p.fit_from_partials(None),
                 lambda: p.apply_partials(None, None), lambda: p.init_partials_state(2),
                 lambda: p.local_init_stats(None), lambda: p.init_state_from_merged(None)):
        with pytest.raises(NotImplementedError, match="mergeable-partials"):
            call()
    with pytest.raises(ValueError, match="does not support"):
        _coord(Plain(), _silos(np.zeros((8, 2), np.float32), n=1, rows=8))


def test_streaming_linear_absorbs_federated_round():
    """The streaming estimator folds a merged federated round as one
    micro-batch, bit-matching its own update on the pooled rows (decay
    1.0, integer-exact sums)."""
    x, y = _int_xy(2 * ROWS, seed=9)
    est = P.LinearRegression(reg_param=0.0)
    silos = _silos(x, y, n=2, rows=ROWS)
    merged = merge_partials([s.compute_partials(est, state=None, round_id=0) for s in silos])
    fed = P.StreamingLinearRegression()
    fed.absorb_partials(merged)
    direct = P.StreamingLinearRegression()
    direct.update((x, y), device="cpu")
    a, b = fed.latest_model, direct.latest_model
    assert np.array_equal(_coef(a), _coef(b))
    assert float(a.intercept) == float(b.intercept)
    with pytest.raises(ValueError, match="linear"):
        fed.absorb_partials(Partials(family="kmeans", stats={}, silo_id="x"))


# ------------------------------------------------------------- profiles
def test_merged_profile_matches_pooled_moments():
    x = _blobs(N_SILOS * ROWS, seed=10)
    y = np.zeros(len(x), np.float32)
    names = [f"f{j}" for j in range(D)]
    prof = _coord(P.LinearRegression(), _silos(x, y)).merged_profile(names=names)
    for j in range(D):
        sk = prof.sketches[f"f{j}"]
        assert sk.count == float(len(x))
        np.testing.assert_allclose(sk.mean, float(x[:, j].astype(np.float64).mean()),
                                   rtol=1e-7)
        assert sk.min == float(x[:, j].min()) and sk.max == float(x[:, j].max())
    ref = _jcoord(J.LinearRegression(), _silos(x, y, jax=True)).merged_profile(names=names)
    assert prof.to_dict() == ref.to_dict()


# ------------------------------------------------------- silo ingestion
def test_silo_from_csv_runs_local_stack(tmp_path):
    rows = 64
    rng = np.random.default_rng(12)
    f0 = rng.integers(0, 10, size=rows)
    f1 = rng.integers(0, 10, size=rows)
    los = f0 * 2 + f1 + 1
    csv = tmp_path / "hospital_a.csv"
    csv.write_text("\n".join(["f0,f1,length_of_stay"]
                             + [f"{a},{b},{c}" for a, b, c in zip(f0, f1, los)]) + "\n")
    schema = P.Schema([("f0", "float"), ("f1", "float"), ("length_of_stay", "float")])
    silo = Silo.from_csv("hosp_a", str(csv), schema, feature_cols=["f0", "f1"],
                         label_col="length_of_stay", table_dir=str(tmp_path / "tbl"),
                         device="cpu")
    assert silo.n_rows == rows and silo.n_features == 2
    p = silo.compute_partials(P.LinearRegression(), state=None, round_id=0)
    assert p.silo_id == "hosp_a" and p.n_rows == float(rows)
    model = P.LinearRegression().fit_from_partials(merge_partials([p]), device="cpu")
    pred = model.predict_numpy(silo.feature_matrix().astype(np.float32), device="cpu")
    np.testing.assert_allclose(pred, los.astype(np.float32), atol=1e-2)
    # the JAX package's silo on the same drop ships the same statistics
    jsilo = JF.Silo.from_csv("hosp_a", str(csv), J.Schema(
        [("f0", "float"), ("f1", "float"), ("length_of_stay", "float")]),
        feature_cols=["f0", "f1"], label_col="length_of_stay",
        table_dir=str(tmp_path / "jtbl"))
    jp = jsilo.compute_partials(J.LinearRegression(), state=None, round_id=0)
    assert jp.to_payload() == p.to_payload()


def test_a_device_dataset_silo_stays_where_it_lies():
    x = _blobs(N_SILOS * ROWS)
    ds = [P.device_dataset(x[i * ROWS:(i + 1) * ROWS], device="cpu") for i in range(N_SILOS)]
    km = P.KMeans(**_km_kw(x))
    a = _coord(km, [Silo(f"s{i}", d, device="cpu") for i, d in enumerate(ds)]).fit()
    b = _coord(km, _silos(x)).fit()
    _assert_kmeans_equal(a.model, b.model)
    s = Silo("s0", ds[0], device="cpu")
    assert s.n_rows == ROWS and s.n_features == D
    np.testing.assert_array_equal(s.feature_matrix(), x[:ROWS])


# --------------------------------------------------------- round journal
@pytest.mark.parametrize("site", FED_SITES)
def test_coordinator_killed_mid_round_resumes_bit_equal(tmp_path, site):
    """Kill the coordinator at each round phase; a fresh coordinator over
    the same journal finishes the fit bit-identical to an unkilled run —
    and no silo recomputes a partial the journal already holds."""
    km, x = _km(max_iter=6)
    baseline_silos = _silos(x)
    baseline = _coord(km, baseline_silos).fit()
    per_silo_calls = baseline_silos[0].compute_calls

    silos = _silos(x)
    cfg = _fast_cfg(journal_dir=str(tmp_path / "journal"))
    plan = faults.FaultPlan().crash(site)
    with faults.active(plan):
        with pytest.raises(faults.InjectedCrash):
            _coord(km, silos, cfg).fit()
    assert plan.fired(site) == 1
    res = _coord(km, silos, cfg).fit()
    _assert_kmeans_equal(baseline.model, res.model)
    for s in silos:
        assert s.compute_calls == per_silo_calls, s.silo_id


def test_coordinator_killed_after_terminal_commit_rebroadcasts_only(tmp_path):
    x, y = _int_xy(N_SILOS * ROWS, seed=13)
    est = P.LinearRegression(reg_param=0.1)
    silos = _silos(x, y)
    cfg = _fast_cfg(journal_dir=str(tmp_path / "j2"))
    plan = faults.FaultPlan().crash(FED_BROADCAST_SITE)
    with faults.active(plan):
        with pytest.raises(faults.InjectedCrash):
            _coord(est, silos, cfg).fit()
    calls = [s.compute_calls for s in silos]
    res = _coord(est, silos, cfg).fit()
    assert res.resumed_from_round is not None
    assert [s.compute_calls for s in silos] == calls
    assert all(len(s.received_models) == 1 for s in silos)
    pooled = est.fit((x, y), device="cpu")
    assert np.array_equal(_coef(pooled), _coef(res.model))


def test_journal_signature_mismatch_refuses_resume(tmp_path):
    x, y = _int_xy(N_SILOS * ROWS, seed=14)
    est = P.LinearRegression()
    jdir = str(tmp_path / "j3")
    _coord(est, _silos(x, y), _fast_cfg(journal_dir=jdir)).fit()
    with pytest.raises(ValueError, match="signature mismatch"):
        _coord(est, _silos(x, y, n=2), _fast_cfg(journal_dir=jdir)).fit()


def _journal(path):
    """The journal's lines, less the rounds' wall-clock timings."""
    out = []
    for e in read_lines(os.path.join(path, "fed_round.journal")):
        if "report" in e:
            e = dict(e, report={k: v for k, v in e["report"].items()
                                if not k.startswith("t_")})
        out.append(e)
    return out


@pytest.mark.parametrize("family", ["linear", "kmeans"])
def test_journal_lines_equal_the_jax_package(tmp_path, family):
    """Integer-valued rows make every statistic exact in both packages:
    the journals agree line for line, kinds, keys and values (the
    rounds' timings aside); on KMeans the costs are non-integer sums, so
    the lines match but for each partial's and merge's ``cost``."""
    if family == "linear":
        x, y = _int_xy(N_SILOS * ROWS, seed=15)
        pe, je, data = P.LinearRegression(reg_param=0.1), J.LinearRegression(reg_param=0.1), (x, y)
    else:
        x = _int_blobs(N_SILOS * ROWS)
        pe, je, data = P.KMeans(**_km_kw(x, max_iter=4)), J.KMeans(**_km_kw(x, max_iter=4)), (x,)
    _coord(pe, _silos(*data), _fast_cfg(journal_dir=str(tmp_path / "p"))).fit()
    _jcoord(je, _silos(*data, jax=True), _fast_cfg(jax=True, journal_dir=str(tmp_path / "j"))
            ).fit()
    mine, ref = _journal(str(tmp_path / "p")), _journal(str(tmp_path / "j"))
    assert [e["kind"] for e in mine] == [e["kind"] for e in ref]
    if family == "kmeans":
        for lines in (mine, ref):
            for e in lines:
                for key in ("part", "merged"):
                    if key in e:
                        cost = e[key]["stats"].pop("cost")
                        assert cost["shape"] == [] and cost["dtype"] == "float32"
                if "state" in e:
                    e["state"]["meta"].pop("cost", None)
    assert mine == ref


def test_port_resumes_a_journal_the_jax_package_wrote(tmp_path):
    """A JAX coordinator killed at ``fed.round.merge``; the port's
    coordinator resumes its journal, folds the banked round-0 partials
    without asking any silo for them again, and finishes within the
    module's limits of the JAX package's unkilled fit."""
    km_kw = _km_kw(_blobs(N_SILOS * ROWS), max_iter=6)
    x = _blobs(N_SILOS * ROWS)
    jdir = str(tmp_path / "journal")
    jbase = _jcoord(J.KMeans(**km_kw), _silos(x, jax=True)).fit()
    plan = jfaults.FaultPlan().crash(FED_MERGE_SITE)
    with jfaults.active(plan):
        with pytest.raises(jfaults.InjectedCrash):
            _jcoord(J.KMeans(**km_kw), _silos(x, jax=True),
                    _fast_cfg(jax=True, journal_dir=jdir)).fit()
    assert plan.fired(FED_MERGE_SITE) == 1
    banked = [e for e in read_lines(os.path.join(jdir, "fed_round.journal"))
              if e["kind"] == "partial"]
    assert sorted(e["silo"] for e in banked) == ["s0", "s1", "s2", "s3"]
    silos = _silos(x)
    res = _coord(P.KMeans(**km_kw), silos, _fast_cfg(journal_dir=jdir)).fit()
    _assert_km_close(jbase.model, res.model, float(np.abs(x).max()))
    # round 0 came from the journal: one collect fewer per silo than the
    # rounds and the final collect of the fit
    assert all(s.compute_calls == res.state.version for s in silos)


def test_multi_round_run_with_transient_dropouts():
    """Two silos flap across a deeper k-means run; every failure is
    absorbed in-round, so the fit stays bit-identical to the clean run."""
    n, rows = 8, 256
    x = _blobs(n * rows, seed=15)
    km = P.KMeans(k=4, max_iter=40, tol=1e-6, warm_start_centers=x[:4].copy(), chunk_rows=rows)
    clean = _coord(km, _silos(x, n=n, rows=rows)).fit()
    plan = (
        faults.FaultPlan()
        .fail(FED_COLLECT_SITE, times=2, when=lambda ctx: ctx.get("silo") == "s2")
        .fail(FED_COLLECT_SITE, times=2, after=4, when=lambda ctx: ctx.get("silo") == "s5")
    )
    with faults.active(plan):
        flappy = _coord(km, _silos(x, n=n, rows=rows)).fit()
    assert plan.fired(FED_COLLECT_SITE) == 4
    _assert_kmeans_equal(clean.model, flappy.model)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _blobs(64)
    for call in (lambda: Silo("s0", x), lambda: FederatedCoordinator(
            P.KMeans(k=2), [Silo("s0", x, device="cpu")]),
            lambda: P.LinearRegression().fit_from_partials(
                merge_partials([Silo("s0", (x, x[:, 0]), device="cpu").compute_partials(
                    P.LinearRegression(), None, 0)]))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
