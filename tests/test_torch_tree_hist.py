"""Port K3 (``ops/tree_hist.py``) against the JAX package's level
histograms, on the CPU.

The same numpy-seeded inputs go through the JAX package's Pallas
``fused_level_hist`` (interpret mode, as ``tests/test_pallas.py`` runs
it), its XLA scan ``engine._make_level_hist`` on a one-device mesh, and
the port's wrapper on CPU tensors — which runs the port's plain PyTorch
version.  The CUDA kernel itself is held to that plain version on the
card by ``chip_smoke.py``.

Tolerances, and why:
- integer-valued stats (0/1/2 weights, labels in {0..3}, one-hots) are
  exactly equal: every float32 sum stays far below 2**24, where any
  summation order is exact;
- fractional weights at rtol 1e-6 (atol 1e-6 × the largest bin): float32
  sums of a few hundred terms in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clustermachinelearningforhospitalnetworks_apache_spark_tpu.models.tree.engine import (
    _make_level_hist,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.ops.pallas_kernels import (
    fused_level_hist as jax_fused_level_hist,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import tree_hist

# the suite runs several worker processes on a few cores: one intra-op
# thread per worker keeps torch from oversubscribing them
torch.set_num_threads(1)


def _inputs(n, d, S, T, LN, B, seed=0, frac=False, regression=True):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, B, (d, n)).astype(np.int32)
    pos = rng.integers(-1, LN, (T, n)).astype(np.int32)          # −1: off the frontier
    w = rng.integers(0, 3, (T, n)).astype(np.float32)            # includes w = 0 rows
    if frac:
        w = (rng.random((T, n)) * (w > 0)).astype(np.float32)
    if regression:
        assert S == 3
        y = rng.integers(0, 4, n).astype(np.float32)
        base = np.stack([np.ones_like(y), y, y * y])
    else:
        base = (rng.integers(0, S, n)[None, :] == np.arange(S)[:, None]).astype(np.float32)
    return binned, base, w, pos


def _port(binned, base, w, pos, LN, B):
    before = tree_hist.launch_counts()["fused_level_hist"]
    out = tree_hist.fused_level_hist(torch.from_numpy(binned), torch.from_numpy(base),
                                     torch.from_numpy(w), torch.from_numpy(pos), LN, B)
    assert tree_hist.launch_counts()["fused_level_hist"] == before  # CPU: plain version
    return out.numpy()


def _jax_pallas(binned, base, w, pos, LN, B):
    return np.asarray(jax_fused_level_hist(jnp.asarray(binned), jnp.asarray(base),
                                           jnp.asarray(w), jnp.asarray(pos), LN, B,
                                           interpret=True))


def _jax_scan(mesh, binned, base, w, pos, LN, B):
    d, S, T = binned.shape[0], base.shape[0], w.shape[0]
    fn = _make_level_hist(mesh, LN, d, B, S, T)
    return np.asarray(fn(jnp.asarray(binned), jnp.asarray(base), jnp.asarray(w),
                         jnp.asarray(pos)))


CASES = [  # (n, d, S, T, LN, B, regression)
    (1000, 4, 3, 2, 1, 16, True),
    (777, 5, 3, 3, 8, 32, True),
    (600, 4, 2, 3, 8, 16, False),
    (513, 3, 3, 2, 1, 8, False),
]


@pytest.mark.parametrize("n,d,S,T,LN,B,regression", CASES)
def test_plain_equals_jax_pallas_and_xla_scan(n, d, S, T, LN, B, regression, mesh1):
    ins = _inputs(n, d, S, T, LN, B, regression=regression)
    got = _port(*ins, LN, B)
    assert got.shape == (T, LN, d, B, S) and got.dtype == np.float32
    np.testing.assert_array_equal(got, _jax_pallas(*ins, LN, B))
    np.testing.assert_array_equal(got, _jax_scan(mesh1, *ins, LN, B))


@pytest.mark.parametrize("LN", [1, 8])
def test_fractional_weights(LN, mesh1):
    ins = _inputs(900, 4, 3, 2, LN, 16, seed=3, frac=True)
    got = _port(*ins, LN, 16)
    for ref in (_jax_pallas(*ins, LN, 16), _jax_scan(mesh1, *ins, LN, 16)):
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_rows_off_the_frontier_and_zero_weights_add_nothing():
    binned, base, w, pos = _inputs(400, 3, 3, 2, 4, 8, seed=5)
    full = _port(binned, base, w, pos, 4, 8)
    keep = (pos >= 0) & (w > 0)
    # dropping the masked rows entirely changes nothing
    np.testing.assert_array_equal(
        full, _port(binned, base, w * keep, np.where(keep, pos, -1).astype(np.int32), 4, 8))
    assert not _port(binned, base, w, np.full_like(pos, -1), 4, 8).any()
    assert not _port(binned, base, np.zeros_like(w), pos, 4, 8).any()


def test_empty_input(mesh1):
    binned, base, w, pos = _inputs(0, 4, 3, 2, 2, 8)
    got = _port(binned, base, w, pos, 2, 8)
    assert got.shape == (2, 2, 4, 8, 3) and not got.any()
    np.testing.assert_array_equal(got, _jax_pallas(binned, base, w, pos, 2, 8))


def test_wrapper_validates_its_inputs():
    b, s, w, p = (torch.from_numpy(a) for a in _inputs(50, 2, 3, 2, 2, 4))
    with pytest.raises(TypeError, match="binned_t must be torch.int32"):
        tree_hist.fused_level_hist(b.long(), s, w, p, 2, 4)
    with pytest.raises(TypeError, match="base_t must be torch.float32"):
        tree_hist.fused_level_hist(b, s.double(), w, p, 2, 4)
    with pytest.raises(ValueError, match="row counts disagree"):
        tree_hist.fused_level_hist(b, s[:, :10], w, p, 2, 4)
    with pytest.raises(ValueError, match=">= 1"):
        tree_hist.fused_level_hist(b, s, w, p, 0, 4)


@pytest.mark.parametrize("n,d,S,T,LN,B", [
    (2_000_000, 8, 3, 20, 1, 32),       # rf20's root
    (2_000_000, 8, 3, 20, 32, 32),      # rf20's last level: 96 KB tile
    (1_400_000, 4, 2, 20, 16, 32),      # the pipeline's classifier forest
    (200_000, 8, 3, 2, 1024, 32),       # depth 10: node tiles
    (20_003, 100, 3, 3, 2, 32),
    (1, 1, 1, 1, 1, 2),
    (1000, 4000, 5, 1, 1, 64),          # one node does not fit: feature tiles
])
def test_hist_plan_fits_and_covers(n, d, S, T, LN, B):
    plan = tree_hist.hist_plan(n, d, S, B, LN, T, sms=132)
    assert plan["smem"] <= tree_hist.SMEM_BUDGET
    assert plan["smem"] == (plan["LNt"] * plan["dt"] * B * S
                            + plan["warps"] * tree_hist.UNROLL * 32 * S) * 4
    assert plan["n_ptiles"] * plan["LNt"] >= LN > (plan["n_ptiles"] - 1) * plan["LNt"]
    assert plan["n_ftiles"] * plan["dt"] >= d > (plan["n_ftiles"] - 1) * plan["dt"]
    assert 1 <= plan["warps"] <= min(8, plan["dt"])
    assert plan["rows_per_block"] % 32 == 0
    assert plan["blocks_x"] * plan["rows_per_block"] >= n
    assert (plan["blocks_x"] - 1) * plan["rows_per_block"] < max(n, 1)
    assert T * plan["blocks_x"] * LN * d * B * S * 4 <= max(
        tree_hist.MAX_PARTIAL_BYTES, T * LN * d * B * S * 4)
    if LN * d * B * S * 4 + min(8, d) * tree_hist.UNROLL * 32 * S * 4 <= tree_hist.SMEM_BUDGET:
        assert plan["n_ptiles"] == plan["n_ftiles"] == 1


def test_bound_at_rf20():
    """About 0.12 ms a launch at rf20's shape, bound by bytes."""
    ms, by = tree_hist.bound_ms(2_000_000, 8, 3, 20, 1, 32)
    assert by == "bytes" and 0.11 < ms < 0.13
