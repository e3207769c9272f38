"""The port's multi-process runtime (``parallel/distributed.py``) and a real
two-process KMeans fit over it, on the CPU.

The cluster is two processes started by ``torch.multiprocessing``'s
**spawn** (a fork would copy the parent's torch state), joined through the
gloo backend and a ``file://`` store under ``tmp_path``, so parallel test
workers never race for a TCP port.  Each rank passes the same host rows and
owns its data shards of a (2, 1) mesh, then of a (2, 2) mesh (two local
entries a rank, the model axis inside the rank).  Every join has a 120 s
timeout, so a hang fails the test instead of the suite's limit.

Tolerances: none.  The statistics are summed in ascending shard order on
every rank after an ``all_gather`` (``collectives.py``), so both ranks'
centers are bit-equal to each other and to the in-process fit on the same
mesh shape.
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


def _rows() -> np.ndarray:
    rng = np.random.default_rng(11)
    centers = rng.normal(0, 3, size=(K, D))
    return (centers[rng.integers(0, K, N)] + rng.normal(scale=0.5, size=(N, D))).astype(
        np.float32)


def _rank_main(rank: int, store: str, model: int, out_dir: str) -> None:
    """One rank: join the group, fit KMeans on its shards, write the model."""
    torch.set_num_threads(1)
    ctx = distributed.initialize(f"file://{store}", 2, rank, backend="gloo",
                                 device=["cpu"] * model)
    try:
        mesh = distributed.cluster_mesh() if model == 1 else P.build_hybrid_mesh(2, model)
        x = _rows()
        m = port.KMeans(k=K, seed=0, max_iter=15).fit(x, mesh=mesh)
        ds = P.device_dataset(x, mesh=mesh)
        pred = P.unpad(m.predict(ds.x), N)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), centers=m.cluster_centers,
                 sizes=m.cluster_sizes, cost=np.float64(m.training_cost),
                 n_iter=np.int64(m.n_iter), pred=pred, shape=np.array(list(mesh.shape.values())),
                 owned=np.array(mesh.local_data_shards()), world=np.int64(ctx.num_processes))
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


@pytest.mark.parametrize("model", [1, 2])
def test_two_process_fit_is_bit_equal_across_ranks_and_to_one_process(tmp_path, model):
    ranks = _run_cluster(tmp_path, model)
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
