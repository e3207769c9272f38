"""The port's multi-process runtime (``parallel/distributed.py``) and a real
two-process KMeans fit over it, on the CPU.

The cluster is two processes started by ``torch.multiprocessing``'s
**spawn** (a fork would copy the parent's torch state), joined through the
gloo backend and a ``file://`` store under ``tmp_path``, so parallel test
workers never race for a TCP port.  Each rank passes the same host rows and
owns its data shards of a (2, 1) mesh, then of a (2, 2) mesh (two local
entries a rank, the model axis inside the rank).  Every join has a 120 s
timeout, so a hang fails the test instead of the suite's limit.

The ranks also fit a Poisson GLM and an MLP (slice 8c-3), and run the
JAX package's cross-process phases (``tests/test_distributed.py``) on
the port: 1, the WLS fit; 3, a depth-3
histogram tree on the shared thresholds; 4, five EM steps of a
3-component GMM from the shared init; 5, the multinomial logistic fit.

Tolerances: none between the ranks and the in-process fit.  The
statistics are summed in ascending shard order on every rank after an
``all_gather`` (``collectives.py``), so both ranks' results are bit-equal
to each other and to the in-process fit on the same mesh shape.  Against
the JAX package's in-process reference (its own fits on its virtual
mesh), the JAX package's cross-process tolerances: the tree's
``split_feat`` equal, thresholds 1e-6, values 1e-4; GMM means 1e-3,
weights 1e-4, log-likelihood rtol 1e-4; multinomial coefficients 2e-3,
intercepts 5e-3 class-centred (both packages' intercepts drift by one
common shift along the softmax's null direction: 0.046 here); the WLS within 1e-4 of the largest coefficient (and 1e-3
of the true β, the reference's own check) — float32 sums in another order.
"""

import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.parallel import (
    distributed,
)

torch.set_num_threads(1)

N, D, K = 2048, 8, 16
JOIN_S = 120
#: rows a block of the out-of-core fit (3 blocks of 700 over (2, M))
OOC_ROWS = 700


def _rows() -> np.ndarray:
    rng = np.random.default_rng(11)
    centers = rng.normal(0, 3, size=(K, D))
    return (centers[rng.integers(0, K, N)] + rng.normal(scale=0.5, size=(N, D))).astype(
        np.float32)


def _phases(mesh) -> dict:
    """The JAX package's cross-process phases 1, 3, 4 and 5 on the port,
    over ``mesh``, on ``tests/test_distributed.py``'s problem set."""
    from test_distributed import _problem_data

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models.base import (
        Shards,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models.gmm import (
        _init_params,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models.tree import (
        binning,
        engine,
    )

    x, y, _, xk, yk, _ = _problem_data()
    n, d = xk.shape
    out = {}
    lr = port.LinearRegression().fit((x, y), mesh=mesh)          # phase 1
    out["coef"], out["intercept"] = lr.coefficients.numpy(), lr.intercept.numpy()
    thr = binning.quantile_thresholds(xk.astype(np.float64), 16)  # phase 3
    grown = engine.grow_forest(P.device_dataset(xk, yk, mesh=mesh), task="regression",
                               num_trees=1, max_depth=3, max_bins=16, seed=0,
                               bin_thresholds=thr)
    out["split_feat"], out["threshold"] = grown.split_feat, grown.threshold
    out["value"] = grown.value[..., 0]
    shift = xk.mean(axis=0).astype(np.float32)                      # phase 4
    m0, c0, w0 = _init_params((xk - shift).astype(np.float64), 3, d, 0, 1e-6)
    gm = port.GaussianMixture(k=3, max_iter=5, tol=1e-6, reg_covar=1e-6)
    sh = Shards(P.device_dataset(xk, mesh=mesh))
    rows = {i: s.x for i, s in sh.data.items()}
    ws = {i: s.w for i, s in sh.data.items()}
    step = gm._em_step(sh, rows, ws, sh.put(torch.from_numpy(shift)), "highest")
    params = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(sh.home) for a in (m0, c0, w0))
    (means, _, weights), ll, _ = gm._em(step, params, shift, 1, -np.inf, None, None)
    out["gmm_means"], out["gmm_weights"] = means.numpy(), weights.numpy()
    out["gmm_ll"] = np.float64(ll)
    y3 = np.clip((xk[:, 0] > 5).astype(np.int32) + 2 * (xk[:, 1] > 5).astype(np.int32),
                 0, 2).astype(np.float32)                        # phase 5
    mlr = port.LogisticRegression(family="multinomial", reg_param=0.01, tol=1e-6,
                                  max_iter=30).fit((xk, y3), mesh=mesh)
    out["mlr_coef"] = mlr.coefficient_matrix.numpy()
    out["mlr_intercept"] = mlr.intercept_vector.numpy()
    return out


def _glm_mlp(mesh) -> dict:
    """Slice 8c-3's two solver families over ``mesh``: a Poisson GLM
    (IRLS; its summary's AIC and standard errors) and an MLP (L-BFGS,
    whose line search decides from the summed values on every rank), on
    an odd row count: the last shard holds a pad row."""
    x = _rows()[:N - 1, :4]
    rng = np.random.default_rng(5)
    counts = rng.poisson(np.exp(0.1 * x[:, 0] - 0.05 * x[:, 1] + 0.5)).astype(np.float32)
    y3 = np.digitize(x[:, 0] + 0.3 * x[:, 2], [-2.0, 2.0]).astype(np.float32)
    g = port.GeneralizedLinearRegression(family="poisson", tol=1e-4).fit((x, counts), mesh=mesh)
    m = port.MultilayerPerceptronClassifier(layers=(4, 5, 3), max_iter=8, seed=0).fit(
        (x, y3), mesh=mesh)
    return {"glm_coef": g.coefficients.numpy(), "glm_head": np.array(
                [g.intercept, g.deviance, g.n_iter, g.summary.aic]),
            "glm_se": g.summary.coefficient_standard_errors,
            "mlp_w": np.concatenate([t.numpy().ravel() for wb in m.weights for t in wb]),
            "mlp_info": np.array([m.fit_info["n_iter"], m.fit_info["loss"],
                                  m.fit_info["evaluations"]])}


def _rank_main(rank: int, store: str, model: int, out_dir: str) -> None:
    """One rank: join the group, fit KMeans on its shards and run the
    cross-process phases, write what it got."""
    torch.set_num_threads(1)
    ctx = distributed.initialize(f"file://{store}", 2, rank, backend="gloo",
                                 device=["cpu"] * model)
    try:
        mesh = distributed.cluster_mesh() if model == 1 else P.build_hybrid_mesh(2, model)
        x = _rows()
        m = port.KMeans(k=K, seed=0, max_iter=15).fit(x, mesh=mesh)
        ds = P.device_dataset(x, mesh=mesh)
        pred = P.unpad(m.predict(ds.x), N)
        phases = {f"phase_{k}": v for k, v in _phases(mesh).items()}
        ooc = port.KMeans(k=K, seed=0, max_iter=15).fit(
            port.HostDataset(x=x, max_device_rows=OOC_ROWS), mesh=mesh)
        phases.update(ooc_centers=ooc.cluster_centers, ooc_sizes=ooc.cluster_sizes,
                      ooc_cost=np.float64(ooc.training_cost), ooc_n_iter=np.int64(ooc.n_iter))
        phases.update(_glm_mlp(mesh))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), centers=m.cluster_centers,
                 sizes=m.cluster_sizes, cost=np.float64(m.training_cost),
                 n_iter=np.int64(m.n_iter), pred=pred, shape=np.array(list(mesh.shape.values())),
                 owned=np.array(mesh.local_data_shards()), world=np.int64(ctx.num_processes),
                 **phases)
    finally:
        distributed.shutdown()


def _run_cluster(tmp_path, model: int) -> list:
    store = str(tmp_path / f"store{model}")
    procs = [mp.get_context("spawn").Process(target=_rank_main,
                                             args=(r, store, model, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0, 0], "a rank failed or hung"
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]


def test_initialize_in_one_process_records_the_context():
    distributed.shutdown()
    try:
        ctx = distributed.initialize()
        assert (ctx.process_id, ctx.num_processes) == (0, 1)
        assert ctx.is_coordinator and ctx.backend is None
        assert not torch.distributed.is_initialized()
        assert distributed.initialize() is ctx and distributed.context() is ctx
        assert distributed.is_coordinator() and not distributed.group_active()
        assert distributed.cluster_mesh() is None
        assert distributed.transport_device() == torch.device("cpu")
    finally:
        distributed.shutdown()
    assert distributed.current() is None
    ctx = distributed.initialize(device=["cpu", "cpu"])
    try:
        assert ctx.local_devices == ctx.global_devices == 2
    finally:
        distributed.shutdown()


def test_initialize_refuses_what_it_cannot_run():
    distributed.shutdown()
    with pytest.raises(ValueError, match="coordinator_address"):
        distributed.initialize(num_processes=2, process_id=0, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        distributed.initialize("file:///nowhere", 1, 0, backend="mpi", device="cpu")
    assert distributed.current() is None
    assert distributed._init_method("host:1234") == "tcp://host:1234"
    assert distributed._init_method("file:///s") == "file:///s"


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """Each mesh shape's two ranks, started once for the module."""
    got = {}

    def run(model: int) -> list:
        if model not in got:
            got[model] = _run_cluster(tmp_path_factory.mktemp(f"cluster{model}"), model)
        return got[model]

    return run


@pytest.mark.parametrize("model", [1, 2])
def test_two_process_fit_is_bit_equal_across_ranks_and_to_one_process(clusters, model):
    ranks = clusters(model)
    assert [r["world"] for r in ranks] == [2, 2]
    assert [r["owned"].tolist() for r in ranks] == [[0], [1]]
    assert ranks[0]["shape"].tolist() == ranks[1]["shape"].tolist() == [2, model]
    for key in ("centers", "sizes", "cost", "n_iter", "pred"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
    mesh = P.build_mesh(port.MeshConfig(data=2, model=model), [torch.device("cpu")] * 2 * model)
    x = _rows()
    ref = port.KMeans(k=K, seed=0, max_iter=15).fit(x, mesh=mesh)
    np.testing.assert_array_equal(ranks[0]["centers"], ref.cluster_centers)
    np.testing.assert_array_equal(ranks[0]["sizes"], ref.cluster_sizes)
    assert float(ranks[0]["cost"]) == ref.training_cost
    assert int(ranks[0]["n_iter"]) == ref.n_iter
    np.testing.assert_array_equal(ranks[0]["pred"], ref.predict_numpy(x, device="cpu"))


@pytest.mark.parametrize("model", [1, 2])
def test_two_process_outofcore_kmeans_is_the_in_process_fit(clusters, model):
    """KMeans out of core over (2, M) across two ranks (each fills and copies
    only its own shard of every block; one gather a block): ``==`` on
    every rank to the in-process out-of-core fit on the same mesh shape.
    The gather cadence is a block's, so the sums fold per block over the
    shards and then over the blocks, the in-process order."""
    ranks = clusters(model)
    mesh = P.build_mesh(port.MeshConfig(data=2, model=model), [torch.device("cpu")] * 2 * model)
    ref = port.KMeans(k=K, seed=0, max_iter=15).fit(
        port.HostDataset(x=_rows(), max_device_rows=OOC_ROWS), mesh=mesh)
    for r in ranks:
        np.testing.assert_array_equal(r["ooc_centers"], ref.cluster_centers)
        np.testing.assert_array_equal(r["ooc_sizes"], ref.cluster_sizes)
        assert float(r["ooc_cost"]) == ref.training_cost
        assert int(r["ooc_n_iter"]) == ref.n_iter


@pytest.mark.parametrize("model", [1, 2])
def test_two_process_glm_and_mlp_are_the_in_process_fit(clusters, model):
    """The Poisson GLM (with its summary) and the MLP over (2, M) across two
    ranks: ``==`` on both ranks to the in-process fit on the same mesh
    shape (the IRLS sums and the L-BFGS values, slopes and gradients are
    gathered and folded in shard order on every rank)."""
    ranks = clusters(model)
    mesh = P.build_mesh(port.MeshConfig(data=2, model=model), [torch.device("cpu")] * 2 * model)
    here = _glm_mlp(mesh)
    for key, want in here.items():
        for r in ranks:
            np.testing.assert_array_equal(r[key], want, err_msg=key)


@pytest.mark.parametrize("model", [1, 2])
def test_two_process_phases_are_bit_equal_and_hold_to_the_jax_reference(clusters, model):
    """Phases 1, 3, 4 and 5 on the two ranks: ``==`` each other and the
    in-process fit on the same mesh shape, and within the JAX package's
    cross-process tolerances of its in-process reference."""
    from test_distributed import _in_process_reference, _problem_data

    import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu.config import (
        MeshConfig as JMeshConfig,
    )

    ranks = clusters(model)
    keys = [k for k in ranks[0] if k.startswith("phase_")]
    assert len(keys) == 10
    mesh = P.build_mesh(port.MeshConfig(data=2, model=model), [torch.device("cpu")] * 2 * model)
    here = _phases(mesh)
    for key in keys:
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key], err_msg=key)
        np.testing.assert_array_equal(ranks[0][key], here[key[len("phase_"):]], err_msg=key)
    got = {k[len("phase_"):]: ranks[0][k] for k in keys}
    x, y, beta, _, _, _ = _problem_data()
    np.testing.assert_allclose(got["coef"], beta, atol=1e-3)
    np.testing.assert_allclose(got["intercept"], 0.25, atol=1e-3)
    jlr = J.LinearRegression().fit((x, y), mesh=J.parallel.build_mesh(JMeshConfig(data=4)))
    jcoef = np.asarray(jlr.coefficients)
    np.testing.assert_allclose(got["coef"], jcoef, atol=1e-4 * np.abs(jcoef).max())
    ref = _in_process_reference()
    np.testing.assert_array_equal(got["split_feat"], ref["split_feat"])
    np.testing.assert_allclose(got["threshold"], ref["threshold"], atol=1e-6)
    np.testing.assert_allclose(got["value"], ref["value"], atol=1e-4)
    np.testing.assert_allclose(got["gmm_means"], ref["gmm_means"], atol=1e-3)
    np.testing.assert_allclose(got["gmm_weights"], ref["gmm_weights"], atol=1e-4)
    np.testing.assert_allclose(got["gmm_ll"], ref["gmm_ll"], rtol=1e-4)
    np.testing.assert_allclose(got["mlr_coef"], ref["mlr_coef"], atol=2e-3)
    # the intercepts drift along the softmax's null direction (one shift
    # for every class) in both packages: compare them class-centred
    np.testing.assert_allclose(got["mlr_intercept"] - got["mlr_intercept"].mean(),
                               ref["mlr_intercept"] - ref["mlr_intercept"].mean(), atol=5e-3)
