"""The streaming linear and logistic models and the pipelined stream's
consumer over a mesh, against the port's one-device stream and the JAX
package's stream on the same mesh shape, on the CPU.

The cases are those of JAX ``tests/test_streaming_supervised.py``, run
with ``mesh=`` (the port's ``[torch.device("cpu")] * 8``, the JAX
package's 8 virtual CPU devices).  At the default threshold (65,536 rows
a device, ``parallel.sharding.microbatch_mesh``) a 1,000-row micro-batch
runs on the mesh's first device, as the reference's does; the
``CMLHN_STREAM_SHARD_MIN_ROWS`` env var, which both packages read, set to
1 spreads it over the 8 data shards.

Tolerances, and why:
- a (1, 1) mesh, and a small batch on the 8-mesh at the default
  threshold, are the one-device stream bit for bit;
- the sharded linear stream against one device and against the JAX
  sharded stream: coefficients within 1e-4 of the largest (the Gram's
  float32 sums in another order, ``tests/test_torch_streaming_linear.py``'s
  LIN_TOL), and the reference's own checks against the batch fit
  (rtol / atol 1e-4, the intercept at rtol 1e-3);
- the sharded logistic stream: θ within 2e-5 of the largest after each
  batch (``tests/test_torch_streaming_linear.py``'s LOGIT_TOL: each Newton
  step's statistics are float32 sums in another order), and the
  reference's atol 0.05 against the batch Newton fit;
- the consumer over a mesh: ``==`` the direct update sequence on the same
  mesh (the same updates in the same order).
"""

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.config import (
    MeshConfig as JMeshConfig,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import streaming as PS
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models import (
    streaming_linear as psl,
)

torch.set_num_threads(1)

LIN_TOL = 1e-4
LOGIT_TOL = 2e-5


def _mesh(data=8, model=1):
    return P.build_mesh(port.MeshConfig(data=data, model=model),
                        [torch.device("cpu")] * (data * model))


def _jmesh(data=8, model=1):
    return J.parallel.build_mesh(JMeshConfig(data=data, model=model))


def _reg_data(seed=0, n=8000, d=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    beta = np.array([1.0, -2.0, 0.5, 0.3], np.float32)[:d]
    y = (x @ beta + 0.7 + 0.1 * rng.normal(size=n)).astype(np.float32)
    return x, y, beta, rng


def _theta(m):
    coef = m.coefficients.numpy() if hasattr(m.coefficients, "numpy") else m.coefficients
    return np.r_[np.asarray(coef, np.float64), float(m.intercept)]


def _gap(a, b) -> float:
    ta, tb = _theta(a), _theta(b)
    return float(np.abs(ta - tb).max() / np.abs(tb).max())


@pytest.fixture
def sharded(monkeypatch):
    """Every micro-batch spread over the data shards (both packages)."""
    monkeypatch.setenv("CMLHN_STREAM_SHARD_MIN_ROWS", "1")


def _count_stats(monkeypatch, name: str) -> list:
    calls = []
    real = getattr(psl, name)

    def counted(x, *a):
        calls.append(x.shape[0])
        return real(x, *a)

    monkeypatch.setattr(psl, name, counted)
    return calls


# ------------------------------------------ the reference's cases, with mesh=
@pytest.mark.parametrize("spread", [False, True], ids=["default", "sharded"])
def test_decay_one_equals_batch_wls(spread, monkeypatch):
    if spread:
        monkeypatch.setenv("CMLHN_STREAM_SHARD_MIN_ROWS", "1")
    calls = _count_stats(monkeypatch, "lin_batch_stats")
    x, y, _, _ = _reg_data()
    sl = port.StreamingLinearRegression()
    js = J.StreamingLinearRegression()
    for s in range(0, len(x), 1000):
        sl.update((x[s:s + 1000], y[s:s + 1000]), mesh=_mesh())
        js.update((x[s:s + 1000], y[s:s + 1000]), mesh=_jmesh())
    assert sl.n_batches == 8
    assert calls == ([125] * 64 if spread else [1000] * 8)
    m = sl.latest_model
    batch = port.LinearRegression().fit((x, y), mesh=_mesh())
    np.testing.assert_allclose(m.coefficients.numpy(), batch.coefficients.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(m.intercept), float(batch.intercept), rtol=1e-3)
    assert _gap(m, js.latest_model) <= LIN_TOL


def test_forgetting_tracks_drift(sharded):
    x, y, beta, _ = _reg_data()
    y2 = (x @ (-beta) + 0.7).astype(np.float32)   # regime flip
    tracker = port.StreamingLinearRegression(decay_factor=0.3)
    averager = port.StreamingLinearRegression(decay_factor=1.0)
    for yy in (y, y2):
        for s in range(0, len(x), 1000):
            tracker.update((x[s:s + 1000], yy[s:s + 1000]), mesh=_mesh())
            averager.update((x[s:s + 1000], yy[s:s + 1000]), mesh=_mesh())
    tc = tracker.latest_model.coefficients.numpy()
    ac = averager.latest_model.coefficients.numpy()
    assert np.abs(tc + beta).max() < 0.05      # locked onto the new regime
    assert np.abs(ac + beta).max() > 0.5       # still dragged by history


@pytest.mark.parametrize("spread", [False, True], ids=["default", "sharded"])
def test_logistic_converges_to_batch_newton(spread, monkeypatch):
    if spread:
        monkeypatch.setenv("CMLHN_STREAM_SHARD_MIN_ROWS", "1")
    x, _, beta, rng = _reg_data()
    p = 1 / (1 + np.exp(-(x @ beta + 0.3)))
    yb = (rng.uniform(size=len(x)) < p).astype(np.float32)
    sl = port.StreamingLogisticRegression(newton_steps_per_batch=2)
    js = J.StreamingLogisticRegression(newton_steps_per_batch=2)
    for s in range(0, len(x), 1000):
        sl.update((x[s:s + 1000], yb[s:s + 1000]), mesh=_mesh())
        js.update((x[s:s + 1000], yb[s:s + 1000]), mesh=_jmesh())
        assert _gap(sl.latest_model, js.latest_model) <= LOGIT_TOL
    sm = sl.latest_model
    bm = port.LogisticRegression(max_iter=50).fit((x, yb), mesh=_mesh())
    np.testing.assert_allclose(sm.coefficients.numpy(), bm.coefficients.numpy(), atol=0.05)
    acc_s = np.mean(sm.predict_numpy(x, device="cpu") == yb)
    acc_b = np.mean(bm.predict_numpy(x, device="cpu") == yb)
    assert acc_s > acc_b - 0.01
    assert sl._wsum == js._wsum


# ------------------------------------------------- against one device
@pytest.mark.parametrize("shape", [(1, 1), (8, 1), (4, 2)])
def test_linear_and_logistic_over_a_mesh_against_one_device(shape, sharded):
    x, y, beta, rng = _reg_data(seed=3, n=3000)
    yb = (rng.uniform(size=len(x)) < 1 / (1 + np.exp(-(x @ beta)))).astype(np.float32)
    kw_lin, kw_log = dict(decay_factor=0.8, reg_param=0.01), dict(newton_steps_per_batch=2)
    pairs = [(port.StreamingLinearRegression(**kw_lin), port.StreamingLinearRegression(**kw_lin),
              y, LIN_TOL),
             (port.StreamingLogisticRegression(**kw_log),
              port.StreamingLogisticRegression(**kw_log), yb, LOGIT_TOL)]
    for one, got, lab, tol in pairs:
        for s in range(0, len(x), 500):
            one.update((x[s:s + 500], lab[s:s + 500]), device="cpu")
            got.update((x[s:s + 500], lab[s:s + 500]), mesh=_mesh(*shape))
        if shape == (1, 1):
            np.testing.assert_array_equal(_theta(got.latest_model), _theta(one.latest_model))
        else:
            assert _gap(got.latest_model, one.latest_model) <= tol


def test_small_batches_stay_on_one_device_bit_for_bit(monkeypatch):
    calls = _count_stats(monkeypatch, "logit_batch_stats")
    x, _, beta, rng = _reg_data(seed=4, n=2000)
    yb = (x[:, 0] > 0).astype(np.float32)
    one = port.StreamingLogisticRegression()
    got = port.StreamingLogisticRegression()
    for s in range(0, len(x), 1000):
        one.update((x[s:s + 1000], yb[s:s + 1000]), device="cpu")
        got.update((x[s:s + 1000], yb[s:s + 1000]), mesh=_mesh())
    assert calls == [1000] * 8          # 2 batches x 2 updates x (1 step + the history)
    np.testing.assert_array_equal(_theta(got.latest_model), _theta(one.latest_model))
    with pytest.raises(ValueError, match="mesh or a device"):
        got.update((x[:10], yb[:10]), mesh=_mesh(), device="cpu")


# ---------------------------------------------------------- the consumer
def test_consumer_hands_its_mesh_to_every_update_and_drain():
    seen = []

    class Recorder:
        def update(self, b, **kw):
            seen.append(("update", kw))

        def update_many(self, bs, **kw):
            seen.append(("update_many", kw))

    mesh = _mesh(4)
    cons = PS.ModelUpdateConsumer(Recorder(), mesh=mesh)
    cons._buf = [np.zeros((4, 2), np.float32)] * 3
    cons.flush()
    assert seen == [("update_many", {"mesh": mesh}), ("update", {"mesh": mesh})]
    assert cons.device is None
    with pytest.raises(ValueError, match="mesh or a device"):
        PS.ModelUpdateConsumer(Recorder(), mesh=mesh, device="cpu")


def test_consumer_over_a_mesh_equals_the_direct_updates():
    rng = np.random.default_rng(7)
    centers = rng.normal(0, 4, size=(3, 2))
    batches = [(centers[rng.integers(0, 3, 400)] + rng.normal(scale=0.3, size=(400, 2))
                ).astype(np.float32) for _ in range(10)]
    kw = dict(k=3, seed=0, half_life=4.0, shard_min_rows_per_device=50)
    direct, fed = port.StreamingKMeans(**kw), port.StreamingKMeans(**kw)
    for b in batches:
        direct.update(b, mesh=_mesh(4))
    cons = PS.ModelUpdateConsumer(fed, mesh=_mesh(4))
    cons(batches[0], 0)                   # one update
    cons._buf = list(batches[1:])         # a backlog: drained as 8 + 1
    cons.flush()
    assert cons.batches_drained == 8 and cons.updates == 2
    assert torch.equal(fed._centers, direct._centers)
    assert torch.equal(fed._weights, direct._weights)
    assert torch.equal(fed._weights_lo, direct._weights_lo)


def test_foreach_batch_incremental_supervised_over_a_mesh(tmp_path):
    """The reference's C6 intent end to end (JAX
    ``test_foreach_batch_incremental_supervised``): micro-batches through
    the file-source stream, the logistic model trained over the mesh in
    the foreachBatch hook, against the JAX package's stream on the same
    files."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu.io.csv import (
        write_csv as jax_write_csv,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu import streaming as JS

    rng = np.random.default_rng(0)

    def event_csv(path, start_minute, n):
        base = np.datetime64("2025-03-31T22:00:00") + np.timedelta64(int(start_minute), "m")
        adm = rng.integers(0, 50, n)
        t = J.Table.from_dict(
            {
                "hospital_id": np.array(["H01"] * n, dtype=object),
                "event_time": base + np.arange(n).astype("timedelta64[s]"),
                "admission_count": adm,
                "current_occupancy": rng.integers(20, 200, n),
                "emergency_visits": rng.integers(0, 30, n),
                "seasonality_index": rng.uniform(0.5, 1.5, n),
                "length_of_stay": 2.0 + 0.2 * adm + rng.normal(0, 0.1, n),
            },
            J.hospital_event_schema(),
        )
        jax_write_csv(t, path)

    incoming = tmp_path / "incoming"
    incoming.mkdir()
    learners = {"port": port.StreamingLogisticRegression(newton_steps_per_batch=3),
                "jax": J.StreamingLogisticRegression(newton_steps_per_batch=3)}
    meshes = {"port": _mesh(), "jax": _jmesh()}

    def hook(pkg):
        top = port if pkg == "port" else J

        def run(batch, batch_id):
            if batch.num_rows:
                xb = batch.numeric_matrix(list(top.FEATURE_COLS)).astype(np.float32)
                yb = (np.asarray(batch.column("length_of_stay")) > 5.0).astype(np.float32)
                learners[pkg].update((xb, yb), mesh=meshes[pkg])

        return run

    execs = {}
    for pkg, (top, st) in {"port": (port, PS), "jax": (J, JS)}.items():
        kw = {"device": "cpu"} if pkg == "port" else {}
        execs[pkg] = st.StreamExecution(
            source=st.FileStreamSource(str(incoming), top.hospital_event_schema()),
            sink=st.UnboundedTable(str(tmp_path / f"table_{pkg}"), top.hospital_event_schema()),
            checkpoint=st.StreamCheckpoint(str(tmp_path / f"ckpt_{pkg}")),
            watermark=st.WatermarkTracker("event_time", 10.0),
            foreach_batch=hook(pkg), **kw)
    for i in range(4):
        event_csv(str(incoming / f"{i}.csv"), i, 400)
        for ex in execs.values():
            ex.run_once()
    assert learners["port"].n_batches == learners["jax"].n_batches >= 1
    assert _gap(learners["port"].latest_model, learners["jax"].latest_model) <= LOGIT_TOL
