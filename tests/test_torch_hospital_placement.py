"""Per-hospital placement (``parallel/federation.py``): the port's
``place_hospitals`` and ``federated_dataset`` against the JAX package's, on
the CPU, and fits on the federated layout against the ingest-order layout.

The JAX side runs on ``tests/conftest.py``'s 8-device mesh; the port's
(8, 1) mesh is over ``[torch.device("cpu")] * 8``.

Tolerances, and why:
- placement, ``hospital_to_shard``, ``row_order`` and the padded rows:
  equal (host logic, float32 copies);
- KMeans on the federated layout against the ingest-order layout, both
  warm-started from the same centers: centers within atol 1e-4 (the JAX
  package's bound for this comparison, ``tests/test_federation.py``), the
  same ``n_iter`` and sizes: a row's weight does not depend on its slot;
- silhouette within 1e-5 of the ingest-order layout's (the JAX package's
  bound).
"""

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.parallel import (
    federated_dataset as jax_federated_dataset,
    place_hospitals as jax_place_hospitals,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel as P

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8


def _mesh(data=8):
    return P.build_mesh(port.MeshConfig(data=data), CPU8[:data])


def _hospital_rows(seed=0, n=1200, n_hosp=11):
    rng = np.random.default_rng(seed)
    ids = np.array([f"H{rng.integers(0, n_hosp):02d}" for _ in range(n)], dtype=object)
    centers = np.array([[0.0, 0.0, 0.0, 0.0], [6.0, 6.0, 0.0, 0.0], [0.0, 6.0, 6.0, 0.0],
                        [6.0, 0.0, 0.0, 6.0]])
    x = (centers[rng.integers(0, 4, n)] + rng.normal(scale=0.5, size=(n, 4))).astype(np.float32)
    y = (x @ np.array([1.0, -0.5, 2.0, 0.0]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    return x, y, ids


@pytest.mark.parametrize("n_shards", [1, 3, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_place_hospitals_equals_the_reference(seed, n_shards):
    _, _, ids = _hospital_rows(seed)
    assert P.place_hospitals(ids, n_shards) == jax_place_hospitals(ids, n_shards)
    ints = np.random.default_rng(seed).integers(0, 40, 500)
    assert P.place_hospitals(ints, n_shards) == jax_place_hospitals(ints, n_shards)


def _same_layout(pf, jf):
    assert pf.hospital_to_shard == jf.hospital_to_shard
    np.testing.assert_array_equal(pf.row_order, jf.row_order)
    assert pf.n_rows == jf.n_rows and pf.n_padded == jf.n_padded
    for name in ("x", "y", "w"):
        np.testing.assert_array_equal(getattr(pf, name).numpy(), np.asarray(getattr(jf, name)))


def test_federated_dataset_from_arrays_equals_the_reference(mesh8):
    x, y, ids = _hospital_rows()
    pf = P.federated_dataset(x, ids, y, mesh=_mesh())
    _same_layout(pf, jax_federated_dataset(x, ids, y, mesh=mesh8))
    shard_len = pf.n_padded // 8
    for slot, row in enumerate(pf.row_order):
        if row >= 0:
            assert slot // shard_len == pf.hospital_to_shard[ids[row]]
    assert sorted(r for r in pf.row_order if r >= 0) == list(range(len(x)))
    with pytest.raises(ValueError, match="hospital_ids length"):
        P.federated_dataset(x, ids[:-1], mesh=_mesh())


def test_federated_dataset_from_an_assembled_table_equals_the_reference(mesh8):
    x, y, ids = _hospital_rows(3, n=400)
    cols = {"hospital_id": ids.astype(str), "length_of_stay": y.astype(np.float64)}
    for j in range(4):
        cols[f"f{j}"] = x[:, j].astype(np.float64)
    feats = [f"f{j}" for j in range(4)]
    pasm = port.VectorAssembler(feats).transform(port.Table.from_dict(cols))
    jasm = J.VectorAssembler(feats).transform(J.Table.from_dict(cols))
    pf = port.federated_dataset(pasm, mesh=_mesh())
    _same_layout(pf, jax_federated_dataset(jasm, mesh=mesh8))
    assert set(pf.hospital_to_shard) == set(ids.astype(str))


def test_kmeans_on_the_federated_layout_fits_as_the_plain_layout():
    x, y, ids = _hospital_rows()
    warm = x[:4].copy()
    fd = port.federated_dataset(x, ids, mesh=_mesh())
    plain = P.device_dataset(x, mesh=_mesh())
    fed = port.KMeans(k=4, warm_start_centers=warm).fit(fd)
    ref = port.KMeans(k=4, warm_start_centers=warm).fit(plain)
    assert fed.n_iter == ref.n_iter
    np.testing.assert_array_equal(fed.cluster_sizes, ref.cluster_sizes)
    np.testing.assert_allclose(fed.cluster_centers, ref.cluster_centers, atol=1e-4)
    pred = ref.predict_numpy(x, device="cpu")
    s_fed = port.ClusteringEvaluator().evaluate(fd, pred, k=4)
    s_plain = port.ClusteringEvaluator().evaluate(x, pred, k=4, device="cpu")
    assert abs(s_fed - s_plain) < 1e-5


def test_federated_dataset_on_one_entry_is_a_device_dataset():
    x, y, ids = _hospital_rows()
    fd = port.federated_dataset(x, ids, y, mesh=P.single_device_mesh("cpu"))
    assert isinstance(fd.data, port.DeviceDataset) and fd.n_padded == len(x)
    np.testing.assert_array_equal(fd.x.numpy()[fd.row_order >= 0], x[fd.row_order])
