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


@pytest.mark.parametrize("n,d,S,T,LN,B,per_sm", [
    (2_000_000, 8, 3, 20, 1, 32, None),       # rf20's root
    (2_000_000, 8, 3, 20, 32, 32, None),      # rf20's last level: 96 KB tile
    (1_400_000, 4, 2, 20, 16, 32, None),      # the pipeline's classifier forest
    (200_000, 8, 3, 2, 1024, 32, None),       # depth 10: node tiles
    (20_003, 100, 3, 3, 2, 32, None),
    (1, 1, 1, 1, 1, 2, None),
    (1000, 4000, 5, 1, 1, 64, None),          # one node does not fit: feature tiles
    (30_001, 8, 3, 3, 4, 32, None),           # T=3 over groups of TB=2
    (60_001, 8, 3, 7, 2, 32, None),           # T=7 over groups of TB=4
    (2_000_000, 8, 3, 20, 1, 32, 1),          # one resident block an SM
])
def test_hist_plan_fits_and_covers(n, d, S, T, LN, B, per_sm):
    sms = 132
    plan = tree_hist.hist_plan(n, d, S, B, LN, T, sms, per_sm)
    TB, G = plan["TB"], plan["n_tgroups"]
    # TB tiles plus the staging ring fit the budget, and one more group's
    # worth of trees a block would not
    assert plan["smem"] == tree_hist.smem_bytes(plan["dt"], S, B, plan["LNt"], TB)
    pad = 4 if S == 3 else S     # one vector load reads a row's stats
    ring = tree_hist.RING
    assert plan["smem"] == 4 * (tree_hist.ROW_TILE * (ring * (plan["dt"] + S + 2 * TB)
                                                      + (ring - 1) * TB * pad)
                                + TB * plan["LNt"] * plan["dt"] * B * S)
    assert plan["smem"] <= tree_hist.SMEM_BUDGET
    if G > 1:
        more = -(-T // (G - 1))
        assert (tree_hist.smem_bytes(plan["dt"], S, B, plan["LNt"], more) > tree_hist.SMEM_BUDGET
                or 4 * more * plan["LNt"] * plan["dt"] * B * S > tree_hist.TREE_TILES_BUDGET)
    if TB > 1:
        assert 4 * TB * plan["LNt"] * plan["dt"] * B * S <= tree_hist.TREE_TILES_BUDGET
    # TB trees a block cover T, spread evenly over the groups
    assert 1 <= TB <= T and G * TB >= T > (G - 1) * TB
    assert plan["n_ptiles"] * plan["LNt"] >= LN > (plan["n_ptiles"] - 1) * plan["LNt"]
    assert plan["n_ftiles"] * plan["dt"] >= d > (plan["n_ftiles"] - 1) * plan["dt"]
    assert 1 <= plan["warps"] <= min(tree_hist.MAX_WARPS, TB * plan["dt"])
    # n is covered, every block has rows
    assert plan["rows_per_block"] % 32 == 0
    assert plan["blocks_x"] * plan["rows_per_block"] >= n
    assert (plan["blocks_x"] - 1) * plan["rows_per_block"] < max(n, 1)
    # the partial cap holds
    cap = max(tree_hist.MAX_PARTIAL_BYTES // (T * LN * d * B * S * 4), 1)
    assert plan["blocks_x"] <= cap
    # the grid is whole waves: never past `waves` waves of resident
    # blocks, and the fewest waves that keep each block's rows under
    # MAX_ROWS_PER_BLOCK (or the partial cap)
    wave = sms * plan["per_sm"]
    cols = G * plan["n_ptiles"] * plan["n_ftiles"]
    total = plan["blocks_x"] * cols
    assert plan["waves"] >= 1 and (plan["waves"] - 1) * wave < total <= plan["waves"] * wave
    if plan["blocks_x"] < cap:
        assert plan["rows_per_block"] <= max(tree_hist.MAX_ROWS_PER_BLOCK, 32)
    if plan["waves"] > 1:
        assert (plan["waves"] - 1) * wave // cols * tree_hist.MAX_ROWS_PER_BLOCK < n
    # as many row blocks as fill the waves, up to the rows' 32-row rounding
    b0 = min(plan["waves"] * wave // cols, cap, -(-max(n, 1) // 32))
    assert b0 * (plan["rows_per_block"] - 32) < max(n, 1) + b0
    if LN * d * B * S * 4 + tree_hist.smem_bytes(d, S, B, 0, 1) <= tree_hist.SMEM_BUDGET:
        assert plan["n_ptiles"] == plan["n_ftiles"] == 1
    if per_sm is not None:
        assert plan["per_sm"] == per_sm


@pytest.mark.parametrize("n,d,S,T,LN,B,blocks_x,rows_per_block", [
    # the one-tree-a-block kernel's partition at the four main shapes and
    # two edge shapes (its hist_plan on 132 SMs)
    (2_000_000, 8, 3, 20, 1, 32, 53, 37_760),
    (2_000_000, 8, 3, 20, 32, 32, 53, 37_760),
    (1_400_000, 4, 3, 20, 32, 32, 53, 26_432),
    (2_000_000, 4, 2, 20, 16, 32, 53, 37_760),
    (300_007, 8, 3, 4, 8, 32, 261, 1152),
    (20_003, 100, 3, 3, 2, 32, 313, 64),
])
def test_hist_plan_forced_partition(n, d, S, T, LN, B, blocks_x, rows_per_block):
    own = tree_hist.hist_plan(n, d, S, B, LN, T, sms=132)
    plan = tree_hist.hist_plan(n, d, S, B, LN, T, 132, None, rows_per_block)
    assert (plan["blocks_x"], plan["rows_per_block"]) == (blocks_x, rows_per_block)
    # the partition alone is forced: tiles, trees a block and warps stay
    for key in ("LNt", "dt", "TB", "n_tgroups", "n_ptiles", "n_ftiles", "warps", "smem"):
        assert plan[key] == own[key]
    with pytest.raises(ValueError, match="multiple of 32"):
        tree_hist.hist_plan(n, d, S, B, LN, T, 132, None, rows_per_block + 1)


def test_planned_launch_takes_cuda_tensors_only():
    b, s, w, p = (torch.from_numpy(a) for a in _inputs(50, 2, 3, 2, 2, 4))
    plan = tree_hist.hist_plan(50, 2, 3, 4, 2, 2, 132)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tree_hist.fused_level_hist_planned(b, s, w, p, 2, 4, plan)


def test_bound_at_rf20():
    """About 0.12 ms a launch at rf20's shape, bound by bytes."""
    ms, by = tree_hist.bound_ms(2_000_000, 8, 3, 20, 1, 32)
    assert by == "bytes" and 0.11 < ms < 0.13
