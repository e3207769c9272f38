"""The port's mesh layer (``parallel/``: mesh, partitioner, sharding,
collectives) and ``MeshConfig`` against the JAX package's, on the CPU.

The JAX side runs on ``tests/conftest.py``'s 8 virtual CPU devices; the
port builds its meshes over device objects of its own: ``cuda:0`` ..
``cuda:7`` where only the order matters (a ``torch.device`` is a name and
needs no card), ``[torch.device("cpu")] * 8`` where tensors are placed (a
port mesh may repeat a device).

Tolerances, and why:
- mesh shapes, orders and errors, partition specs, ``partition_devices``,
  ``pad_rows`` and ``chunk_layout``: equal (host logic);
- ``tree_aggregate`` / ``global_sum`` against a float64 host sum: rtol
  1e-6 on float rows (float32 sums, ordered by shard), equal on integer
  rows (every float32 sum below 2**24 is exact).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.config import (
    MeshConfig as JMeshConfig,
    PipelineConfig as JConfig,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.parallel import (
    partitioner as jpart,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.parallel import (
    sharding as jshard,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.config import MeshConfig
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.parallel import (
    collectives,
    partitioner,
    sharding,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.parallel.mesh import (
    data_axis_size,
    model_axis_size,
)

torch.set_num_threads(1)

NAMED = [torch.device("cuda", i) for i in range(8)]   # order only, never touched
CPU8 = [torch.device("cpu")] * 8
FAMILIES = ("rows", "kmeans", "gmm", "trees", "streaming_kmeans", "bisecting", "distance",
            "clustering_eval", "farm", "sql", "fleet")


def _order(mesh) -> list:
    """A port mesh's entries as their device indices, row-major."""
    return [e.device.index for e in mesh.devices.flat]


# ----------------------------------------------------------------- config
def test_mesh_config_equals_the_reference():
    assert dataclasses.asdict(MeshConfig()) == dataclasses.asdict(JMeshConfig())
    assert MeshConfig(data=4, model=2).axis_names() == JMeshConfig(4, 2).axis_names()
    assert [f.name for f in dataclasses.fields(MeshConfig)] == [
        f.name for f in dataclasses.fields(JMeshConfig)]


def test_jax_config_with_a_mesh_round_trips(tmp_path):
    path = str(tmp_path / "cfg.json")
    JConfig(input_path="/in", mesh=JMeshConfig(data=4, model=2, dcn_hosts=2)).save_json(path)
    cfg = port.PipelineConfig.from_json(path)
    assert cfg.mesh == MeshConfig(data=4, model=2, dcn_hosts=2)
    assert cfg.to_dict() == JConfig.from_json(path).to_dict()
    argv = ["--config", path, "--mesh-data", "8", "--mesh-model", "1"]
    assert port.PipelineConfig.from_flags(argv).to_dict() == JConfig.from_flags(argv).to_dict()
    out = str(tmp_path / "back.json")
    port.PipelineConfig.from_flags(argv).save_json(out)
    assert JConfig.from_json(out).mesh == JMeshConfig(data=8, model=1)
    assert json.load(open(out))["mesh"] == {"data": 8, "model": 1, "dcn_hosts": 1}


# ------------------------------------------------------------------- mesh
@pytest.mark.parametrize("model", [1, 2, 4])
@pytest.mark.parametrize("data", [-1, 1, 2, 4, 8])
def test_build_mesh_matches_the_reference(data, model):
    try:
        jm = J.parallel.build_mesh(JMeshConfig(data=data, model=model))
    except ValueError:
        with pytest.raises(ValueError):
            P.build_mesh(MeshConfig(data=data, model=model), NAMED)
        return
    pm = P.build_mesh(MeshConfig(data=data, model=model), NAMED)
    assert pm.shape == dict(jm.shape)
    assert pm.size == jm.size
    assert _order(pm) == [d.id for d in jm.devices.flat]
    assert (data_axis_size(pm), model_axis_size(pm)) == (jm.shape["data"], jm.shape["model"])


@pytest.mark.parametrize("hosts,model", [(2, 1), (2, 2), (4, 2), (8, 1), (3, 1), (2, 8)])
def test_build_hybrid_mesh_single_process_order(hosts, model):
    try:
        jm = J.parallel.build_hybrid_mesh(hosts, model)
    except ValueError:
        with pytest.raises(ValueError):
            P.build_hybrid_mesh(hosts, model, devices=NAMED)
        return
    pm = P.build_hybrid_mesh(hosts, model, devices=NAMED)
    assert pm.shape == dict(jm.shape)
    assert _order(pm) == [d.id for d in jm.devices.flat]


def test_mesh_entries_name_process_and_device():
    m = P.build_mesh(MeshConfig(data=4, model=2), CPU8)
    assert m.shape == {"data": 4, "model": 2} and m.size == 8
    assert all(e.process_index == 0 and e.device == torch.device("cpu")
               for e in m.devices.flat)
    assert m == P.build_mesh(MeshConfig(data=4, model=2), CPU8)
    assert hash(m) == hash(P.build_mesh(MeshConfig(data=4, model=2), CPU8))
    assert m != P.build_mesh(MeshConfig(data=8), CPU8)
    assert m.local_data_shards() == [0, 1, 2, 3]
    one = P.single_device_mesh("cpu")
    assert one.shape == {"data": 1, "model": 1} and one.device(0, 0) == torch.device("cpu")


def test_use_mesh_and_set_default_mesh_nest():
    a = P.build_mesh(MeshConfig(data=8), CPU8)
    b = P.build_mesh(MeshConfig(data=4, model=2), CPU8)
    P.set_default_mesh(a)
    try:
        assert P.default_mesh() is a
        with P.use_mesh(b) as got:
            assert got is b and P.default_mesh() is b
            with P.use_mesh(a):
                assert P.default_mesh() is a
            assert P.default_mesh() is b
        assert P.default_mesh() is a
    finally:
        P.set_default_mesh(None)


def test_default_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    P.set_default_mesh(None)
    for call in (P.default_mesh, P.build_mesh, lambda: P.build_hybrid_mesh(2),
                 P.single_device_mesh, lambda: port.default_mesh()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ------------------------------------------------------------ partitioner
def _rule_paths(fam) -> list:
    paths = [r.pattern.replace("*", "x") for r in fam.rules]
    return paths + ["no/such/path", "scalar/cost"]


@pytest.mark.parametrize("name", FAMILIES)
def test_partition_specs_equal_the_reference(name):
    jf, pf = jpart.family(name), partitioner.family(name)
    assert pf.describe() == jf.describe()
    for path in _rule_paths(jf):
        assert pf.spec(path) == tuple(jf.spec(path))
        for ndim in range(4):
            try:
                want = tuple(jf.spec(path, ndim))
            except ValueError:
                with pytest.raises(ValueError):
                    pf.spec(path, ndim)
                continue
            assert pf.spec(path, ndim) == want, (name, path, ndim)


def test_partitioner_rule_errors_and_registry():
    for mod in (jpart, partitioner):
        with pytest.raises(ValueError, match="unknown logical axis"):
            mod.Rule("a/*", ("bogus",))
        with pytest.raises(KeyError, match="no partitioner family"):
            mod.family("no-such-family")
    toy = partitioner.register_family("toy_mesh_test", [("a/*", ("data",))])
    assert partitioner.family("toy_mesh_test") is toy and toy.spec("a/b", 2) == ("data", None)
    mesh = P.build_mesh(MeshConfig(data=4, model=2), CPU8)
    jmesh = J.parallel.build_mesh(JMeshConfig(data=4, model=2))
    for name in FAMILIES:
        for n in (0, 1, 7, 8, 9):
            assert partitioner.family(name).round_rows(n, mesh) == \
                jpart.family(name).round_rows(n, jmesh)
    assert partitioner.family("kmeans").sharding("state/centers", mesh, 2).spec == \
        ("model", None)


@pytest.mark.parametrize("n_dev,n_rep", [(1, 1), (1, 4), (3, 2), (8, 3), (8, 8), (4, 7)])
def test_partition_devices_equals_the_reference(n_dev, n_rep):
    devs = [f"d{i}" for i in range(n_dev)]
    assert partitioner.partition_devices(devs, n_rep) == jpart.partition_devices(devs, n_rep)
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve.fleet import (
        placement,
    )
    assert placement.partition_devices is partitioner.partition_devices


def test_put_splits_along_the_resolved_axes():
    mesh = P.build_mesh(MeshConfig(data=4, model=2), CPU8)
    cen = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    placed = partitioner.family("kmeans").put("state/centers", cen, mesh)
    for i, j in np.ndindex(4, 2):
        np.testing.assert_array_equal(placed.block(i, j).numpy(), cen[j * 8:(j + 1) * 8])
    rows = partitioner.family("kmeans").put("batch/x", cen, mesh)
    for i, j in np.ndindex(4, 2):
        np.testing.assert_array_equal(rows.block(i, j).numpy(), cen[i * 4:(i + 1) * 4])
    assert rows.block(1, 0) is rows.block(1, 1)            # a repeated device holds it once
    np.testing.assert_array_equal(rows.numpy(), cen)
    np.testing.assert_array_equal(placed.numpy(), cen)
    rep = partitioner.family("kmeans").put("scalar/cost", np.float32(3.0).reshape(()), mesh)
    assert float(rep.block(3, 1)) == 3.0
    tree = partitioner.family("rows").shard_tree({"batch": {"x": cen}}, mesh)
    np.testing.assert_array_equal(tree["batch"]["x"].block(2).numpy(), cen[8:12])
    with pytest.raises(ValueError, match="does not split"):
        partitioner.family("kmeans").put("batch/x", cen[:6], mesh)


# --------------------------------------------------------------- sharding
@pytest.mark.parametrize("n,m", [(0, 1), (0, 8), (1, 8), (7, 8), (8, 8), (9, 8), (4096, 3)])
def test_pad_rows_equals_the_reference(n, m):
    assert sharding.pad_rows(n, m) == jshard.pad_rows(n, m)


@pytest.mark.parametrize("n_loc,target", [(0, 8), (1, 8), (8, 8), (9, 8), (100, 32), (5, 0)])
def test_chunk_layout_equals_the_reference(n_loc, target):
    assert sharding.chunk_layout(n_loc, target) == jshard.chunk_layout(n_loc, target)
    nc, c = sharding.chunk_layout(n_loc, target)
    x = torch.arange(n_loc * 2, dtype=torch.float32).reshape(n_loc, 2)
    xc, wc = sharding.chunked_pad(x, torch.ones(n_loc), nc, c)
    assert xc.shape == (nc, c, 2) and float(wc.sum()) == n_loc


def test_device_dataset_lays_rows_out_as_p_data(mesh8):
    x = np.random.default_rng(1).normal(size=(37, 3)).astype(np.float32)
    y = np.arange(37, dtype=np.float32)
    pm = P.build_mesh(MeshConfig(data=8), CPU8)
    ps = P.device_dataset(x, y, mesh=pm)
    js = J.parallel.device_dataset(x, y, mesh=mesh8)
    assert ps.n_padded == js.n_padded == 40 and ps.n_features == 3
    for name in ("x", "y", "w"):
        np.testing.assert_array_equal(getattr(ps, name).numpy(),
                                      np.asarray(getattr(js, name)))
    assert [s.n_padded for s in ps.shards] == [5] * 8
    assert float(ps.count()) == 37.0
    np.testing.assert_array_equal(P.unpad(ps.y, 37), y)
    one = P.device_dataset(x, y, mesh=P.single_device_mesh("cpu"))
    assert isinstance(one, port.DeviceDataset) and one.n_padded == 37


@pytest.mark.parametrize("shape", [(1, 1), (8, 1), (4, 2), (2, 4)])
def test_sample_valid_rows_is_the_same_on_every_mesh(shape):
    x = np.random.default_rng(2).normal(size=(1003, 4)).astype(np.float32)
    single = sharding.sample_valid_rows(port.device_dataset(x, device="cpu"), 100, 7)
    mesh = P.build_mesh(MeshConfig(data=shape[0], model=shape[1]), CPU8)
    got = sharding.sample_valid_rows(P.device_dataset(x, mesh=mesh), 100, 7)
    np.testing.assert_array_equal(got, single)


# ------------------------------------------------------------- collectives
@pytest.mark.parametrize("integer", [False, True])
def test_tree_aggregate_and_global_sum_against_float64(integer):
    rng = np.random.default_rng(3)
    x = (rng.integers(-50, 50, size=(803, 5)) if integer
         else rng.normal(size=(803, 5))).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=803).astype(np.float32)
    if integer:
        w = np.round(w)
    mesh = P.build_mesh(MeshConfig(data=8), CPU8)
    ds = P.device_dataset(x, weights=w, mesh=mesh)
    got = P.tree_aggregate(lambda s: {"sx": (s.x * s.w[:, None]).sum(0), "n": s.w.sum()}, ds)
    want_sx = (x.astype(np.float64) * w[:, None]).sum(0)
    cmp = np.testing.assert_array_equal if integer else (
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6))
    cmp(got["sx"].numpy(), want_sx.astype(np.float32) if integer else want_sx)
    cmp(float(got["n"]), float(w.astype(np.float64).sum()))
    col = P.shard_rows(np.pad(x[:, 0], (0, 5)), mesh)
    wp = P.shard_rows(np.pad(w, (0, 5)), mesh)
    cmp(float(P.global_sum(col, wp)), float((x[:, 0].astype(np.float64) * w).sum()))
    cmp(float(P.global_sum(torch.from_numpy(x[:, 0]))), float(x[:, 0].astype(np.float64).sum()))
    parts = [torch.tensor([float(i), 1.0]) for i in range(8)]
    assert collectives.ordered_sum(parts, mesh).tolist() == [28.0, 8.0]
    assert collectives.pmean_data(parts, mesh).tolist() == [3.5, 1.0]


def test_ordered_sum_folds_in_shard_order():
    """((p0 + p1) + p2) + ...: the float32 result of the ascending fold, not
    of any other association."""
    mesh = P.build_mesh(MeshConfig(data=3), CPU8[:3])
    parts = [torch.tensor([v], dtype=torch.float32) for v in (1e8, -1e8, 1.0)]
    assert collectives.ordered_sum(parts, mesh).item() == 1.0      # (1e8 - 1e8) + 1
    assert collectives.ordered_sum(parts[::-1], mesh).item() == 0.0  # (1 - 1e8) + 1e8
    with pytest.raises(ValueError, match="no part"):
        collectives.ordered_sum([parts[0], None, parts[2]], mesh)
