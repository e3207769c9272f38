"""The port's threefry draws (``prng.py``) against ``jax.random``.

Every draw must be bit-equal: the split permutation, the trees' feature
subsets and their Poisson bootstrap come from these, and tree structure
is compared exactly elsewhere.  The bit layout is fixed by
``jax_threefry_partitionable=True`` (the default of the installed jax);
the first test asserts it, so a change in jax shows up here.

Normal is the exception, with a stated bound: ``prng.normal`` follows
XLA's ``ErfInv32`` polynomial, but XLA's CPU ``log1p`` is an
approximation of its own that torch does not reproduce.  Measured over
10**6 draws under each of two keys: about 0.94 % of the values differ, by
at most 3 float32 ulp (4.8e-7).  The test holds that bound.

Poisson: Knuth's loop sums float32 ``log u``; torch and XLA on the CPU
agree bit for bit at these shapes (a flip would need a running sum
within one ulp of −rate), so the counts are compared exactly.
"""

import jax
import numpy as np
import pytest
import torch

from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import prng

# the suite runs several worker processes on a few cores: one intra-op
# thread per worker keeps torch from oversubscribing them
torch.set_num_threads(1)


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_partitionable_threefry_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, -1, 2**32 + 5])
def test_key(seed):
    np.testing.assert_array_equal(prng.key(seed).numpy(), _kd(jax.random.key(seed)))


def test_threefry2x32_matches_the_jax_primitive():
    from jax._src.prng import threefry_2x32

    rng = np.random.default_rng(0)
    k = rng.integers(0, 2**32, size=2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2**32, size=64, dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(threefry_2x32((k[0], k[1]), x)).astype(np.int64)
    xt = torch.as_tensor(x.astype(np.int64))
    h1, h2 = prng.threefry2x32(int(k[0]), int(k[1]), xt[:32], xt[32:])
    np.testing.assert_array_equal(torch.cat([h1, h2]).numpy(), ref)


@pytest.mark.parametrize("data", [0, 3, 17, 2**31 + 7])
def test_fold_in(data):
    k = jax.random.key(42)
    np.testing.assert_array_equal(prng.fold_in(prng.key(42), data).numpy(),
                                  _kd(jax.random.fold_in(k, data)))


@pytest.mark.parametrize("num", [2, 3, 7])
def test_split(num):
    np.testing.assert_array_equal(prng.split(prng.key(9), num).numpy(),
                                  _kd(jax.random.split(jax.random.key(9), num)))


@pytest.mark.parametrize("shape", [(5,), (3, 4, 7), (1,), (0, 3)])
def test_random_bits(shape):
    ref = np.asarray(jax.random.bits(jax.random.key(3), shape)).astype(np.int64)
    np.testing.assert_array_equal(prng.random_bits(prng.key(3), shape).numpy(), ref)


@pytest.mark.parametrize("T,LN,d", [(1, 1, 4), (3, 8, 5), (20, 32, 8)])
def test_uniform_over_tree_node_feature(T, LN, d):
    """The shape of the per-node feature-subset draw, at its fold-in key."""
    k = jax.random.fold_in(jax.random.key(5), 4)
    ref = np.asarray(jax.random.uniform(k, (T, LN, d)))
    got = prng.uniform(prng.fold_in(prng.key(5), 4), (T, LN, d)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", [0, 1, 2, 10, 1000, 1626, 5000])
def test_permutation(n):
    """n = 1626 is the first size that takes two sort rounds."""
    ref = np.asarray(jax.random.permutation(jax.random.key(42), n))
    np.testing.assert_array_equal(prng.permutation(prng.key(42), n).numpy(), ref)


@pytest.mark.parametrize("rate", [0.5, 1.0])
def test_poisson(rate):
    ref = np.asarray(jax.random.poisson(jax.random.key(7), rate, shape=(3, 2000)))
    got = prng.poisson(prng.key(7), rate, (3, 2000)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_poisson_zero_rate_and_rejection_branch():
    assert not prng.poisson(prng.key(0), 0.0, (4, 5)).any()
    with pytest.raises(NotImplementedError, match="rejection branch"):
        prng.poisson(prng.key(0), 10.0, (4,))


@pytest.mark.parametrize("seed", [3, 0])
def test_normal_within_three_ulp_of_jax(seed):
    """The measured bound over 10**6 draws (see the module docstring)."""
    n = 1_000_000
    want = np.asarray(jax.random.normal(jax.random.key(seed), (n,), np.float32))
    got = prng.normal(prng.key(seed), (n,)).numpy()
    ulp = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulp.max() <= 3
    assert np.count_nonzero(ulp) < 0.011 * n
    # the uniforms underneath are bit-equal, so no draw is far off
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)


@pytest.mark.parametrize("shape", [(4, 8), (3,), (2, 3, 5)])
def test_normal_shapes_and_each(shape):
    keys = prng.split(prng.key(11), 5)
    each = prng.normal_each(keys, shape)
    assert each.shape == (5, *shape) and each.dtype == torch.float32
    for i in range(5):
        assert torch.equal(each[i], prng.normal(keys[i], shape))
        kj = jax.random.wrap_key_data(np.asarray(keys[i].numpy(), np.uint32))
        np.testing.assert_allclose(each[i].numpy(),
                                   np.asarray(jax.random.normal(kj, shape)), atol=5e-7)


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999], dtype=torch.float32)
    got = prng.erf_inv(x)
    assert got[0] == -torch.finfo(torch.float32).max and got[1] == torch.finfo(torch.float32).max
    assert got[2] == 0.0
    want = np.asarray(jax.lax.erf_inv(x.numpy()))
    np.testing.assert_allclose(got[2:].numpy(), want[2:], rtol=2e-6)
