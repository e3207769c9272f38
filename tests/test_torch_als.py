"""Slice 5e's ALS in the port against the JAX package's, on the CPU, on the
same seeded inputs.

Tolerances, and why:
- the count buckets and the oracle layout are equal: the same host numpy;
- one half-step (explicit, implicit, and each through the NNLS
  coordinate descent) from the same factors on ``_group_ratings``' oracle
  layout: float32 Gram sums and a batched LU solve in another order
  (torch's against XLA's), within HALF_STEP = 2e-6 of the largest factor
  (measured 2.3e-7);
- the whole fit (10 half-step pairs, Spark's defaults) carries that
  difference forward: predictions within FIT = 1e-5 of the largest
  |prediction| (measured 1.3e-6, implicit with NNLS on the skewed
  ratings); at reg_param 0.01 a user with one rating solves a rank-1
  Gram plus 0.01·I, about 10x worse conditioned, so FIT_WEAK = 1e-4
  (measured 1.0e-5 on the skewed ratings);
- ``recommend_*`` on integer-valued factors, whose scores are exact
  integers in any order: ids ``==`` with ``lax.top_k``'s, ties included
  (they go to the lower index), and scores ``==``;
- ``predict`` and the cold-start strategies are the same host numpy (==).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.models import als as jals
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models import als as pals

torch.set_num_threads(1)

HALF_STEP = 2e-6
FIT = 1e-5
FIT_WEAK = 1e-4


def _synth(seed=0, n_u=60, n_i=40, f=4, frac=0.35):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n_u, f))
    v = rng.normal(size=(n_i, f))
    mask = rng.uniform(size=(n_u, n_i)) < frac
    uu, ii = np.nonzero(mask)
    rr = ((u @ v.T)[uu, ii] + 0.05 * rng.normal(size=len(uu))).astype(np.float32)
    return uu, ii, rr


def _skewed(seed=1, n_u=300, n_i=50, nnz=4000):
    """Zipf-popular items and heavy users: the buckets span several caps."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_i + 1) ** 1.1
    ii = rng.choice(n_i, nnz, p=p / p.sum())
    uu = np.minimum(rng.zipf(1.5, nnz) - 1, n_u - 1)
    pairs = np.unique(uu * n_i + ii)
    uu, ii = pairs // n_i, pairs % n_i
    return uu, ii, rng.normal(3.0, 1.0, len(uu)).astype(np.float32)


@pytest.mark.parametrize("data", [_synth, _skewed])
def test_buckets_equal(data):
    uu, ii, rr = data()
    for ids, other, n in ((uu, ii, uu.max() + 1), (ii, uu, ii.max() + 1)):
        got = pals._group_ratings_bucketed(ids, other, rr, n)
        want = jals._group_ratings_bucketed(ids, other, rr, n)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
        for a, b in zip(pals._group_ratings(ids, other, rr, n),
                        jals._group_ratings(ids, other, rr, n)):
            np.testing.assert_array_equal(a, b)
    assert pals._bucket_caps(1000) == jals._bucket_caps(1000)
    assert len(pals._group_ratings_bucketed(ii, uu, rr, ii.max() + 1)) >= 2 or data is _synth


def _half_step_inputs(implicit: bool, seed=2):
    uu, ii, rr = _synth(seed)
    if implicit:
        rr = np.abs(rr)
    idx, val, msk, cnt = jals._group_ratings(uu, ii, rr, uu.max() + 1)
    y = np.random.default_rng(seed).normal(size=(ii.max() + 1, 4)).astype(np.float32)
    return y, idx, val, msk, cnt


@pytest.mark.parametrize("nonnegative", [False, True])
@pytest.mark.parametrize("implicit", [False, True])
def test_one_half_step_within_ulps(implicit, nonnegative):
    y, idx, val, msk, cnt = _half_step_inputs(implicit)
    t = {k: torch.from_numpy(v) for k, v in (("y", y), ("val", val), ("msk", msk),
                                             ("cnt", cnt))}
    tidx = torch.from_numpy(idx.astype(np.int64))
    reg = np.float32(0.1)
    if implicit:
        yty = y.T @ y
        want = jals._solve_implicit(jnp.asarray(y), jnp.asarray(yty), jnp.asarray(idx),
                                    jnp.asarray(val), jnp.asarray(msk), jnp.float32(reg),
                                    jnp.float32(1.0), 4, nonnegative)
        got = pals._solve_implicit(t["y"], torch.from_numpy(yty), tidx, t["val"], t["msk"],
                                   float(reg), 1.0, 4, nonnegative)
    else:
        want = jals._solve_explicit(jnp.asarray(y), jnp.asarray(idx), jnp.asarray(val),
                                    jnp.asarray(msk), jnp.asarray(cnt), jnp.float32(reg), 4,
                                    nonnegative)
        got = pals._solve_explicit(t["y"], tidx, t["val"], t["msk"], t["cnt"], float(reg), 4,
                                   nonnegative)
    want = np.asarray(want)
    assert got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) <= HALF_STEP * float(np.abs(want).max())
    if nonnegative:
        assert float(got.min()) >= 0.0


@pytest.mark.parametrize("kw", [{}, {"implicit_prefs": True}, {"nonnegative": True},
                                {"implicit_prefs": True, "nonnegative": True},
                                {"reg_param": 0.01, "rank": 3, "max_iter": 5, "seed": 4}])
@pytest.mark.parametrize("data", [_synth, _skewed])
def test_whole_fit_predicts_what_the_reference_predicts(kw, data):
    uu, ii, rr = data()
    if kw.get("implicit_prefs"):
        rr = np.abs(rr)
    kw = {"rank": 4, **kw}
    jm = J.ALS(**kw).fit((uu, ii, rr))
    pm = P.ALS(**kw).fit((uu, ii, rr), device="cpu")
    assert pm.user_factors.shape == jm.user_factors.shape
    assert pm.user_factors.dtype == np.float32
    want = jm.predict(uu, ii)
    got = pm.predict(uu, ii)
    limit = FIT if kw.get("reg_param", 0.1) == 0.1 else FIT_WEAK
    assert float(np.abs(got - want).max()) <= limit * float(np.abs(want).max())
    # rows with no ratings stay zero in both
    seen = np.bincount(uu, minlength=pm.user_factors.shape[0]) > 0
    assert not pm.user_factors[~seen].any() and not jm.user_factors[~seen].any()


def test_table_and_matrix_inputs_fit_the_same():
    uu, ii, rr = _synth(5)
    t = {"user": uu, "item": ii, "rating": rr.astype(np.float64)}
    a = P.ALS(rank=3, max_iter=3).fit(P.Table.from_dict(t), device="cpu")
    b = P.ALS(rank=3, max_iter=3).fit(np.c_[uu, ii, rr], device="cpu")
    c = J.ALS(rank=3, max_iter=3).fit(J.Table.from_dict(t))
    np.testing.assert_array_equal(a.user_factors, b.user_factors)
    np.testing.assert_allclose(a.user_factors, c.user_factors, atol=FIT)
    for pkg, kw in ((J, {}), (P, {"device": "cpu"})):
        with pytest.raises(ValueError, match="user/item/rating"):
            pkg.ALS().fit(pkg.Table.from_dict({"user": uu, "item": ii}), **kw)
        with pytest.raises(ValueError, match="non-negative"):
            pkg.ALS(implicit_prefs=True).fit((uu, ii, -rr), **kw)
        with pytest.raises(ValueError, match="cold_start_strategy"):
            pkg.ALS(cold_start_strategy="zero").fit((uu, ii, rr), **kw)


def _tied_models(seed=6, n_u=40, n_i=30, f=3):
    """The same integer-valued factors in both packages: every score is an
    exact integer (ties everywhere), whatever the summation order."""
    rng = np.random.default_rng(seed)
    uf = rng.integers(-2, 3, size=(n_u, f)).astype(np.float32)
    vf = rng.integers(-2, 3, size=(n_i, f)).astype(np.float32)
    vf[7] = vf[3]
    uf[0] = 0.0                                  # every score ties
    jm = J.models.als.ALSModel(user_factors=uf, item_factors=vf)
    pm = P.als_model_from_jax_arrays(uf, vf)
    return jm, pm


@pytest.mark.parametrize("k", [1, 5, 30, 50])
def test_recommendations_keep_top_k_tie_order(k):
    jm, pm = _tied_models()
    for name, args in (("recommend_for_all_users", (k,)), ("recommend_for_all_items", (k,)),
                       ("recommend_for_user_subset", ([3, 0, 9, 3], k)),
                       ("recommend_for_item_subset", ([7, 3, 29], k))):
        gi, gs = getattr(pm, name)(*args, device="cpu")
        wi, ws = getattr(jm, name)(*args)
        assert gi.dtype == np.int32 and gs.dtype == np.float32
        np.testing.assert_array_equal(gi, np.asarray(wi))
        np.testing.assert_array_equal(gs, np.asarray(ws))
    ids, _ = pm.recommend_for_all_users(5, device="cpu")
    np.testing.assert_array_equal(ids[0], np.arange(5))       # all tied: lowest ids first


def test_recommendations_in_chunks_equal_one_pass(monkeypatch):
    jm, pm = _tied_models(seed=8, n_u=50)
    want = pm.recommend_for_all_users(6, device="cpu")
    monkeypatch.setattr(pals, "_RECS_CHUNK_ELEMS", 64)        # 2 rows a chunk
    got = pm.recommend_for_all_users(6, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("strategy", ["nan", "drop"])
def test_cold_start_strategies_equal(strategy):
    uu, ii, rr = _synth(7)
    jm = J.ALS(rank=3, max_iter=2, cold_start_strategy=strategy).fit((uu, ii, rr))
    pm = P.als_model_from_jax_arrays(jm.user_factors, jm.item_factors,
                                     cold_start_strategy=strategy)
    u = np.array([0, 5, 999, -1, 2])
    i = np.array([1, 500, 3, 4, 39])
    np.testing.assert_array_equal(pm.predict(u, i), jm.predict(u, i))
    for m in (jm, pm):
        with pytest.raises(ValueError, match="unknown user"):
            m.recommend_for_user_subset([0, 10_000], 3)
        with pytest.raises(ValueError, match="shapes differ"):
            m.predict([0, 1], [0])
