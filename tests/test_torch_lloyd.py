"""Port K1/K2 (``ops/lloyd.py``) against the JAX package's Pallas kernels.

The same numpy-seeded inputs go through the JAX package's
``fused_lloyd_stats`` / ``fused_assign`` (interpret mode, as
``tests/test_pallas.py`` runs them on the CPU), its XLA
``assign_clusters``, and the port's wrappers on CPU tensors — which run
the port's plain PyTorch versions.  The CUDA kernels themselves are held
to those plain versions on the card by ``chip_smoke.py``.

Tolerances, and why:
- assignments equal wherever the reference's two smallest d² differ by
  more than 1e-5 relative (a nearer tie may round either way);
- min d² at rtol 1e-5 / atol 1e-4: the x² − 2x·c + c² form cancels, and
  the two frameworks round its float32 products in another order;
- sums at rtol 1e-5 with atol 1e-5 × the largest |x|·n: float32 sums in
  another order; counts exact (0/1 weights sum exactly in float32);
- cost at rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clustermachinelearningforhospitalnetworks_apache_spark_tpu.ops.distance import (
    assign_clusters,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.ops.pallas_kernels import (
    fused_assign as jax_fused_assign,
    fused_lloyd_stats as jax_fused_lloyd_stats,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import KMeansModel
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import lloyd
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops.distance import (
    assign_clusters as port_assign_clusters,
)

# the suite runs several worker processes on a few cores: one intra-op
# thread per worker keeps torch from oversubscribing them
torch.set_num_threads(1)

K_CASES = [(3, 0), (8, 0), (16, 5)]  # (k, trailing invalid slots)


def _inputs(n, d, k, n_invalid, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 3, size=(k, d)).astype(np.float32)
    x = (centers[rng.integers(0, k, n)] + rng.normal(size=(n, d))).astype(np.float32)
    w = (rng.random(n) > 0.1).astype(np.float32)
    c_valid = np.ones(k, np.float32)
    if n_invalid:
        c_valid[-n_invalid:] = 0.0
    return x, w, centers, c_valid


def _assert_assign_equal(got, ref_assign, x, centers, c_valid):
    """Equal except where the reference's best two d² are a near tie."""
    bad = np.flatnonzero(got != ref_assign)
    if bad.size == 0:
        return
    d2 = np.asarray(
        jnp.maximum(
            jnp.sum(x * x, 1)[:, None] - 2.0 * (x @ centers.T)
            + jnp.sum(centers * centers, 1)[None, :], 0.0
        )
    )
    d2[:, c_valid == 0] = np.inf
    two = np.sort(d2[bad], axis=1)[:, :2]
    gap = (two[:, 1] - two[:, 0]) / np.maximum(np.abs(two[:, 1]), 1e-30)
    assert np.all(gap <= 1e-5), f"assignments differ at rows {bad[gap > 1e-5]}"


@pytest.mark.parametrize("n", [0, 1, 100, 1003])
@pytest.mark.parametrize("k,n_invalid", K_CASES)
@pytest.mark.parametrize("d", [2, 8])
def test_port_lloyd_matches_pallas_reference(n, k, n_invalid, d):
    x, w, centers, c_valid = _inputs(n, d, k, n_invalid)
    args_t = [torch.from_numpy(a) for a in (x, w, centers, c_valid)]

    sums, counts, cost = lloyd.fused_lloyd_stats(*args_t)
    r_sums, r_counts, r_cost = jax_fused_lloyd_stats(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(centers),
        jnp.asarray(c_valid), interpret=True,
    )
    scale = max(float(np.abs(x).max(initial=0.0)) * max(n, 1), 1.0)
    np.testing.assert_allclose(sums.numpy(), np.asarray(r_sums), rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(r_counts))
    np.testing.assert_allclose(float(cost), float(r_cost), rtol=1e-5, atol=1e-6)
    assert sums.shape == (k, d) and counts.shape == (k,) and cost.shape == ()

    assign, mind2 = lloyd.fused_assign(args_t[0], args_t[2], args_t[3])
    r_assign, r_mind2 = jax_fused_assign(
        jnp.asarray(x), jnp.asarray(centers), jnp.asarray(c_valid),
        interpret=True,
    )
    assert assign.dtype == torch.int32 and assign.shape == (n,)
    _assert_assign_equal(assign.numpy(), np.asarray(r_assign), x, centers, c_valid)
    np.testing.assert_allclose(mind2.numpy(), np.asarray(r_mind2), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("n,d,k", [(1003, 8, 16), (100, 2, 3), (1, 8, 8), (70_000, 2, 3)])
def test_port_assign_matches_xla_assign_clusters(n, d, k):
    x, _, centers, c_valid = _inputs(n, d, k, 0, seed=3)
    r_assign, r_mind2 = assign_clusters(jnp.asarray(x), jnp.asarray(centers))
    assign, mind2 = lloyd.fused_assign(
        torch.from_numpy(x), torch.from_numpy(centers), torch.from_numpy(c_valid)
    )
    _assert_assign_equal(assign.numpy(), np.asarray(r_assign), x, centers, c_valid)
    np.testing.assert_allclose(mind2.numpy(), np.asarray(r_mind2), rtol=1e-5,
                               atol=1e-4)
    # the model's predict is the same assignment, past one ASSIGN_CHUNK too
    predicted = KMeansModel(centers).predict(torch.from_numpy(x))
    np.testing.assert_array_equal(predicted.numpy(), assign.numpy())
    p_assign, p_mind2 = port_assign_clusters(torch.from_numpy(x),
                                             torch.from_numpy(centers))
    np.testing.assert_array_equal(p_assign.numpy(), assign.numpy())
    np.testing.assert_allclose(p_mind2.numpy(), mind2.numpy(), rtol=1e-6)


def test_cpu_wrappers_use_plain_versions_and_count_no_launch():
    """On CPU tensors the wrappers run the plain versions — no kernel is
    launched, so the launch counters do not move."""
    x, w, centers, c_valid = (torch.from_numpy(a) for a in _inputs(50, 4, 8, 2))
    before = lloyd.launch_counts()
    got = lloyd.fused_lloyd_stats(x, w, centers, c_valid)
    want = lloyd.fused_lloyd_stats_plain(x, w, centers, c_valid)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(lloyd.fused_assign(x, centers, c_valid)[0],
                       lloyd.fused_assign_plain(x, centers, c_valid)[0])
    assert lloyd.launch_counts() == before


def test_wrappers_validate_inputs():
    x, w, centers, c_valid = (torch.from_numpy(a) for a in _inputs(10, 4, 8, 0))
    with pytest.raises(TypeError, match="float32"):
        lloyd.fused_assign(x.double(), centers, c_valid)
    with pytest.raises(ValueError, match="shape"):
        lloyd.fused_lloyd_stats(x, w[:5], centers, c_valid)
    with pytest.raises(ValueError, match="shape"):
        lloyd.fused_assign(x, centers[:, :3], c_valid)


def test_exact_ties_go_to_the_first_index():
    """Center 1 duplicates center 0: like jnp.argmin, every tie between
    them resolves to index 0."""
    x, w, centers, c_valid = _inputs(300, 4, 8, 0, seed=7)
    centers[1] = centers[0]
    r_assign, _ = jax_fused_assign(jnp.asarray(x), jnp.asarray(centers),
                                   jnp.asarray(c_valid), interpret=True)
    assign, _ = lloyd.fused_assign(torch.from_numpy(x), torch.from_numpy(centers),
                                   torch.from_numpy(c_valid))
    assert int((assign == 1).sum()) == 0 and int((assign == 0).sum()) > 0
    np.testing.assert_array_equal(assign.numpy(), np.asarray(r_assign))


# ------------------------------------------------------------- K1's plan
SMS = 132  # an H100 SXM


@pytest.mark.parametrize("n", [0, 1, 257, 10**7])
@pytest.mark.parametrize("k", [1, 16, 256, 1024, 4096])
@pytest.mark.parametrize("d", [1, 8, 64, 128])
def test_lloyd_plan_fits_the_card_and_covers_the_shape(n, d, k):
    """K1's launch plan (``lloyd_plan``): shared bytes within the opt-in
    limit, the center tile within the 48 KB budget and covering k, the
    accumulators in shared memory exactly when k·(d+1) floats fit beside
    the distance loop's buffers, and a grid that covers n within one wave
    and the partial-buffer cap."""
    plan = lloyd.lloyd_plan(n, d, k, SMS)
    dp, kt = plan["dp"], plan["kt"]
    assert dp in (4, 8, 16, 32, 64, 128) and d <= dp and (dp == 4 or d > dp // 2)
    # the center tile: all k centers, or tiles of a multiple of 32
    assert 1 <= kt <= k and (kt == k or kt % 32 == 0)
    assert plan["n_ctiles"] * kt >= k > (plan["n_ctiles"] - 1) * kt
    distance = kt * (dp + 2) * 4 + lloyd.STATS_BYTES
    assert distance <= lloyd.SMEM_BUDGET
    acc = k * (d + 1) * 4
    assert plan["acc_smem"] == (acc <= lloyd.SMEM_OPTIN - distance)
    assert plan["smem"] == distance + (acc if plan["acc_smem"] else 0)
    assert plan["smem"] <= lloyd.SMEM_OPTIN
    # the grid: at least one block, none without a row tile, at most one
    # wave of resident blocks, and every row tile taken by a block's stride
    tiles = -(-n // lloyd.THREADS)
    blocks = plan["blocks"]
    per_sm = min(2048 // lloyd.THREADS, lloyd.SM_SMEM // (plan["smem"] + 1024))
    assert 1 <= blocks <= max(tiles, 1) and blocks <= SMS * per_sm
    assert blocks * -(-tiles // blocks) * lloyd.THREADS >= n
    P = k * d + k + 1
    assert plan["partial_floats"] == blocks * P
    assert plan["partial_floats"] * 4 <= lloyd.MAX_PARTIAL_BYTES


def test_lloyd_plan_takes_the_occupancy_it_is_given():
    """The wrapper hands the plan the CUDA occupancy API's blocks per SM;
    the grid is one wave of them, cut to the row tiles."""
    assert lloyd.lloyd_plan(10**7, 8, 256, SMS, per_sm=3)["blocks"] == 3 * SMS
    assert lloyd.lloyd_plan(257, 8, 256, SMS, per_sm=3)["blocks"] == 2
    assert lloyd.lloyd_plan(10**7, 64, 1024, SMS, per_sm=0)["blocks"] == SMS


def test_lloyd_plan_rejects_shapes_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="features"):
        lloyd.lloyd_plan(10, 129, 8, SMS)
    with pytest.raises(ValueError, match="features"):
        lloyd.lloyd_plan(10, 0, 8, SMS)
    with pytest.raises(ValueError, match="centers"):
        lloyd.lloyd_plan(10, 8, 0, SMS)
    with pytest.raises(ValueError, match="centers"):
        lloyd.lloyd_plan(10, 8, lloyd.MAX_CENTERS + 1, SMS)
