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


# ------------------------------------------------------------- K2's plan
def _r_max(d):
    dp = next(p for p in (4, 8, 16, 32, 64, 128) if d <= p)
    return {4: 4, 8: 4, 16: 4, 32: 2, 64: 1, 128: 1}[dp], dp


_ASSIGN_NS = sorted({1, 200, 256, 262_144, 10**7}
                    | {(SMS - 1) * 256 * r + e for r in (2, 4) for e in (0, 1)})


@pytest.mark.parametrize("n", _ASSIGN_NS)
@pytest.mark.parametrize("k", [1, 16, 256, 1024, 4096])
@pytest.mark.parametrize("d", [1, 3, 8, 16, 32, 64, 100, 128])
def test_assign_plan_fits_the_card_and_covers_the_shape(n, d, k):
    """K2's launch plan (``assign_plan``): rows a thread the kernel takes
    at this width, the largest of them that still gives every SM a tile
    (else 1), the center tile and shared bytes of the kernel's 48 KB
    layout, and a grid that covers n within one wave of resident blocks."""
    per_sm = 3
    plan = lloyd.assign_plan(n, d, k, SMS, per_sm)
    r_max, dp = _r_max(d)
    R = plan["rows_per_thread"]
    assert plan["dp"] == dp
    assert R in (1, 2, 4) and R <= r_max
    assert lloyd.ASSIGN_ROWS_MAX[dp] == r_max
    # the largest allowed R whose tiles still cover every SM, else 1
    fits = [r for r in (1, 2, 4) if r <= r_max and -(-n // (256 * r)) >= SMS]
    assert R == (max(fits) if fits else 1)
    if n <= (SMS - 1) * 512:
        assert R == 1
    if d == 8 and n == 10**7:
        assert R == 4
    # the center tile: all k centers in 48 KB, or tiles of a multiple of 32
    per_center = (dp + 2) * 4
    kt = plan["kt"]
    assert kt == (k if k * per_center <= 48 * 1024 else 48 * 1024 // per_center // 32 * 32)
    assert 1 <= kt <= k and (kt == k or kt % 32 == 0)
    assert plan["n_ctiles"] * kt >= k > (plan["n_ctiles"] - 1) * kt
    assert plan["smem"] == kt * per_center <= lloyd.SMEM_BUDGET
    # the grid: at least one block; it covers n unless one wave caps it
    blocks = plan["blocks"]
    assert 1 <= blocks <= SMS * per_sm
    assert blocks * 256 * R >= n or blocks == SMS * per_sm
    assert blocks <= max(-(-n // (256 * R)), 1)


@pytest.mark.parametrize("d", [1, 8, 16])
def test_assign_plan_keeps_small_requests_on_one_row_a_thread(d):
    """Every served batch (1..256 rows) and anything up to (sms − 1)·512
    rows launches today's one-row-a-thread loop; one row above each
    boundary takes the next R."""
    for n in (1, 2, 7, 32, 200, 256, (SMS - 1) * 512):
        assert lloyd.assign_plan(n, d, 256, SMS, 4)["rows_per_thread"] == 1
    assert lloyd.assign_plan((SMS - 1) * 512 + 1, d, 256, SMS, 4)["rows_per_thread"] == 2
    assert lloyd.assign_plan((SMS - 1) * 1024, d, 256, SMS, 4)["rows_per_thread"] == 2
    assert lloyd.assign_plan((SMS - 1) * 1024 + 1, d, 256, SMS, 4)["rows_per_thread"] == 4
    assert lloyd.assign_plan(262_144, d, 256, SMS, 4)["rows_per_thread"] == 4


def test_assign_plan_takes_the_occupancy_and_rows_it_is_given():
    assert lloyd.assign_plan(10**7, 8, 256, SMS, per_sm=3)["blocks"] == 3 * SMS
    assert lloyd.assign_plan(10**7, 8, 256, SMS, per_sm=0)["blocks"] == SMS
    assert lloyd.assign_plan(262_144, 8, 256, SMS, per_sm=8)["blocks"] == 256
    assert lloyd.assign_plan(200, 8, 256, SMS, per_sm=8)["blocks"] == 1
    forced = lloyd.assign_plan(10**7, 8, 256, SMS, per_sm=5, rows_per_thread=1)
    assert forced["rows_per_thread"] == 1 and forced["blocks"] == 5 * SMS
    assert lloyd.assign_plan(10**7, 32, 256, SMS, 2, rows_per_thread=2)["rows_per_thread"] == 2
    for d, R in ((32, 4), (64, 2), (128, 2), (8, 3), (8, 0)):
        with pytest.raises(ValueError, match="rows a thread"):
            lloyd.assign_plan(10**7, d, 256, SMS, 2, rows_per_thread=R)


def test_assign_plan_rejects_shapes_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="features"):
        lloyd.assign_plan(10, 129, 8, SMS)
    with pytest.raises(ValueError, match="features"):
        lloyd.assign_plan(10, 0, 8, SMS)
    with pytest.raises(ValueError, match="center"):
        lloyd.assign_plan(10, 8, 0, SMS)


@pytest.mark.parametrize("rows_per_thread", [1, 4])
def test_cpu_planned_assign_runs_the_plain_version(rows_per_thread):
    """``fused_assign_planned`` on CPU tensors runs the plain version
    whatever the plan, and launches nothing."""
    x, _, centers, c_valid = (torch.from_numpy(a) for a in _inputs(300, 8, 16, 3, seed=5))
    plan = lloyd.assign_plan(300, 8, 16, SMS, 4, rows_per_thread=rows_per_thread)
    before = lloyd.launch_counts()
    got = lloyd.fused_assign_planned(x, centers, c_valid, plan)
    want = lloyd.fused_assign_plain(x, centers, c_valid)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert lloyd.launch_counts() == before


def test_own_assign_plan_asks_the_occupancy_once_per_width_and_rows(monkeypatch):
    """``fused_assign``'s plan comes from a cache: the CUDA occupancy
    query runs once per (card, width, rows a thread, shared bytes), not
    on every launch.  A stand-in library counts the queries."""
    import contextlib

    asked = []

    class FakeLib:
        def lloyd_assign_occupancy(self, d, rows, smem, per_sm):
            asked.append((d, rows, smem))
            per_sm._obj.value = 3
            return 0

    monkeypatch.setattr(lloyd, "_lib", lambda: FakeLib())
    monkeypatch.setattr(lloyd, "_sm_count", lambda dev: SMS)
    monkeypatch.setattr(lloyd.torch.cuda, "device", lambda idx: contextlib.nullcontext())
    monkeypatch.setattr(lloyd, "_ASSIGN_OCCUPANCY", {})
    lloyd._own_assign_plan.cache_clear()
    try:
        for _ in range(3):
            for n in (1, 7, 200, 262_144, 10**7, 100_003):
                plan = lloyd._own_assign_plan(0, n, 8, 256)
                assert plan == lloyd.assign_plan(n, 8, 256, SMS, 3)
        # R = 1 (n <= 67,072), 4 (262,144 and 10**7) and 2 (100,003)
        assert sorted(r for _, r, _ in asked) == [1, 2, 4]
    finally:
        lloyd._own_assign_plan.cache_clear()
