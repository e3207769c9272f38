"""The port's multi-process fleet (``serve/fleet/proc.py``) on the CPU,
following the contracts ``tests/test_fleet_proc.py`` pins for the
reference:

1. framing — torn header/payload, bad magic, oversize length and an
   undecodable pickle each raise ``FrameError``; clean EOF at a frame
   boundary is ``None``; an oversize send is refused before any byte is
   written;
2. the transport ladder — an RPC timeout counts against the parent-side
   breaker; transport death answers every in-flight request
   ``unavailable`` and turns the next submit into the fleet's reroute
   signal (``KeyError``);
3. the fleet over real worker processes — answers ``==`` the in-process
   model's and, for a model fitted by the JAX package, ``==`` its
   assignments, distinct OS processes that report their device and pid, the
   atomic swap, SIGKILL mid-load with none unanswered and a revive, an
   external SIGKILL reaped, the ``fleet.proc.rpc`` corruption as
   transport death, a ``fleet.proc.spawn`` fault riding the retry
   ladder, ``attach_lifecycle`` refused;
4. the worker process imports no jax.

Framing and transport run on plain socketpairs; the process-backed tests
share ONE module-scoped 2-replica fleet on ``"cpu"``.  Every worker runs
with ``OMP_NUM_THREADS=1``: the suite runs several test processes at once
and each worker would otherwise start a thread per core.

Tolerances: none — every answer is compared ``==``: the same port code
answers in the worker and in the parent, and the JAX-fitted model's
answers are its assignments of tie-free rows (each row's nearest center
nearer than the second by more than 1e-3, where the port's and the
reference's float32 distances differ by ulps).
"""

import itertools
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.obs.flight_recorder import (
    read_dump,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve.breaker import (
    CircuitBreaker,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve.fleet import (
    proc as FP,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults

pytestmark = [pytest.mark.fleet]

torch.set_num_threads(1)

D = 4
WORKER_ENV = {"OMP_NUM_THREADS": "1"}
REPO = Path(port.__file__).resolve().parents[1]
JAX_PKG = "clustermachinelearningforhospitalnetworks_apache_spark_tpu"


def predict_np(model, x) -> np.ndarray:
    return model.predict(torch.from_numpy(np.ascontiguousarray(x, np.float32))).numpy()


# --------------------------------------------------------------- framing
class TestFraming:
    def test_round_trip(self):
        a, b = socket.socketpair()
        with a, b:
            FP.send_frame(a, {"op": "ping", "x": np.arange(3)})
            msg = FP.recv_frame(b)
        assert msg["op"] == "ping"
        np.testing.assert_array_equal(msg["x"], np.arange(3))

    def test_clean_eof_is_none(self):
        a, b = socket.socketpair()
        with b:
            a.close()
            assert FP.recv_frame(b) is None

    def test_torn_header(self):
        a, b = socket.socketpair()
        with b:
            a.sendall(b"CM")
            a.close()
            with pytest.raises(FP.FrameError, match="mid-frame"):
                FP.recv_frame(b)

    def test_torn_payload(self):
        a, b = socket.socketpair()
        with b:
            a.sendall(struct.pack(">4sI", b"CMP1", 100) + b"x" * 10)
            a.close()
            with pytest.raises(FP.FrameError, match="mid-frame"):
                FP.recv_frame(b)

    def test_bad_magic(self):
        a, b = socket.socketpair()
        with a, b:
            a.sendall(struct.pack(">4sI", b"XXXX", 4) + b"abcd")
            with pytest.raises(FP.FrameError, match="magic"):
                FP.recv_frame(b)

    def test_oversize_frame_refused_without_buffering(self):
        a, b = socket.socketpair()
        with a, b:
            a.sendall(struct.pack(">4sI", b"CMP1", FP.MAX_FRAME_BYTES + 1))
            with pytest.raises(FP.FrameError, match="oversize"):
                FP.recv_frame(b)

    def test_undecodable_payload(self):
        a, b = socket.socketpair()
        with a, b:
            a.sendall(struct.pack(">4sI", b"CMP1", 4) + b"\xff\xfe\xfd\xfc")
            with pytest.raises(FP.FrameError, match="undecodable"):
                FP.recv_frame(b)

    def test_oversize_send_refused_before_write(self):
        a, b = socket.socketpair()
        with a, b:
            with pytest.raises(FP.FrameError, match="exceeds"):
                FP.send_frame(a, {"blob": b"x" * 64}, max_bytes=32)
            b.setblocking(False)
            with pytest.raises(BlockingIOError):
                b.recv(1)


# --------------------------------------------------------------- transport
class _FakeProc:
    pid = -1

    def __init__(self):
        self._rc = None

    def poll(self):
        return self._rc


def _loopback_client(rpc_timeout_s=0.2):
    """A ProcServerClient wired to a test-controlled peer socket instead
    of a spawned worker — the transport ladder in isolation."""
    parent, peer = socket.socketpair()
    c = FP.ProcServerClient.__new__(FP.ProcServerClient)
    c.replica_id = 0
    c._server_kw = {"device": "cpu"}
    c.max_queue_rows = 64
    c.breaker = CircuitBreaker(failure_threshold=2, recovery_timeout_s=60.0)
    c._worker_threads = 1
    c._spawn_timeout_s = 1.0
    c._rpc_timeout_s = rpc_timeout_s
    c._max_frame = FP.MAX_FRAME_BYTES
    c._env_extra = {}
    c.registry = FP._ClientRegistry()
    c._send_lock = threading.Lock()
    c._state_lock = threading.Lock()
    c._pending = {}
    c._ids = itertools.count(1)
    c._inflight_rows = 0
    c._dead = threading.Event()
    c._closing = False
    c._sock = parent
    c._proc = _FakeProc()
    c.pid = -1
    c.counters = {
        "serve.requests": 0.0, "fleet.proc.rpc_sent": 0.0,
        "fleet.proc.short_circuited": 0.0,
        "fleet.proc.transport_down": 0.0, "fleet.proc.killed": 0.0,
    }
    c.last_postmortem = None
    threading.Thread(target=c._recv_loop, daemon=True).start()
    return c, peer


class TestTransportLadder:
    def test_rpc_timeout_counts_against_breaker(self):
        c, peer = _loopback_client(rpc_timeout_s=0.05)
        with peer:
            with pytest.raises(FP.RPCError, match="timed out"):
                c._call("ping")
            assert c.breaker._consecutive_failures == 1
            assert FP.recv_frame(peer)["op"] == "ping"

    def test_transport_death_answers_all_inflight(self):
        c, peer = _loopback_client()
        c.registry._entries["m"] = FP._RegistryEntry(object())
        reqs = [c.submit("m", np.zeros((2, D), np.float32)) for _ in range(5)]
        assert c.inflight_rows() == 10
        peer.close()
        results = [r.wait(5.0) for r in reqs]
        assert all(r.status == "unavailable" for r in results)
        assert c.inflight_rows() == 0 and not c.alive()
        assert c.counters["fleet.proc.transport_down"] == 1
        with pytest.raises(KeyError):
            c.submit("m", np.zeros((1, D), np.float32))

    def test_torn_frame_from_peer_is_transport_death(self):
        c, peer = _loopback_client()
        c.registry._entries["m"] = FP._RegistryEntry(object())
        req = c.submit("m", np.zeros((1, D), np.float32))
        with peer:
            peer.sendall(b"garbage!")
            assert req.wait(5.0).status == "unavailable"

    def test_unknown_model_is_keyerror_before_any_rpc(self):
        c, peer = _loopback_client()
        with peer:
            with pytest.raises(KeyError):
                c.submit("nope", np.zeros((1, D), np.float32))
            assert c.counters["fleet.proc.rpc_sent"] == 0

    def test_open_breaker_short_circuits_submit(self):
        c, peer = _loopback_client()
        c.registry._entries["m"] = FP._RegistryEntry(object())
        with peer:
            c.breaker.record_failure()
            c.breaker.record_failure()
            with pytest.raises(KeyError, match="breaker"):
                c.submit("m", np.zeros((1, D), np.float32))
            assert c.counters["fleet.proc.short_circuited"] == 1


# --------------------------------------------------------------- processes
@pytest.fixture(scope="module")
def jax_km():
    """A JAX KMeans(k=3) on 4-d blobs carried to the port with
    ``convert.py``, and tie-free probe rows: (JAX model, port model,
    rows)."""
    rng = np.random.default_rng(3)
    centers = rng.normal(scale=4.0, size=(3, D))
    x = (centers[rng.integers(0, 3, 300)] + rng.normal(size=(300, D))).astype(np.float32)
    jm = J.models.kmeans.KMeans(k=3, seed=0, max_iter=20).fit(x)
    _, params, arrays = jm._artifacts()
    pm = port.kmeans_model_from_jax_arrays(**arrays, **params)
    d2 = ((x.astype(np.float64)[:, None, :] - pm.cluster_centers[None]) ** 2).sum(-1)
    d2.sort(axis=1)
    return jm, pm, x[d2[:, 1] - d2[:, 0] > 1e-3]


@pytest.fixture(scope="module")
def proc_fleet(tmp_path_factory, jax_km):
    """One 2-worker fleet serving "km" (a port fit, swapped by the tests)
    and "jkm" (the JAX-carried model, never swapped)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(192, D)).astype(np.float32)
    model = port.KMeans(k=3, max_iter=5, seed=0).fit(x, device="cpu")
    predict_np(model, x[:4])        # served once: its device cache is filled
    flight = str(tmp_path_factory.mktemp("flight"))
    old = os.environ.get("CMLHN_FLIGHT_DIR")
    os.environ["CMLHN_FLIGHT_DIR"] = flight
    fs = FP.ProcReplicaSet(n_replicas=2, devices=("cpu", "cpu"), max_wait_s=0.005,
                           proc_env=WORKER_ENV)
    try:
        fs.add_model("km", model, n_features=D)
        fs.add_model("jkm", jax_km[1], n_features=D)
        fs.start()
        yield fs, model, x
    finally:
        fs.stop()
        if old is None:
            os.environ.pop("CMLHN_FLIGHT_DIR", None)
        else:
            os.environ["CMLHN_FLIGHT_DIR"] = old


class TestProcFleet:
    def test_predict_equals_the_in_process_model(self, proc_fleet):
        fs, _, x = proc_fleet
        current = fs.registry.get("km").model
        r = fs.predict("km", x[:16], tenant_id="h1")
        assert r.status == "ok"
        np.testing.assert_array_equal(np.asarray(r.value), predict_np(current, x[:16]))

    def test_the_jax_carried_model_answers_its_assignments_on_every_worker(
            self, proc_fleet, jax_km):
        """The JAX-fitted model, carried to the port and pickled to each
        worker, answers ``==`` the JAX model's own assignments of the
        tie-free rows, through the fleet and from every worker."""
        fs, _, _ = proc_fleet
        jm, _, rows = jax_km
        want = np.asarray(jm.predict(rows[:64]))
        r = fs.predict("jkm", rows[:64], tenant_id="h1")
        assert r.status == "ok"
        np.testing.assert_array_equal(np.asarray(r.value), want)
        for rep in fs.replicas:
            res = rep.server.predict("jkm", rows[:64])
            assert res.status == "ok"
            np.testing.assert_array_equal(np.asarray(res.value), want)

    def test_each_replica_is_a_distinct_os_process_on_its_device(self, proc_fleet):
        fs, _, _ = proc_fleet
        pids = [r.server.pid for r in fs.replicas]
        assert len(set(pids)) == 2 and os.getpid() not in pids
        for r in fs.replicas:
            os.kill(r.server.pid, 0)
            ping = r.server.ping()
            assert ping["pid"] == r.server.pid
            assert ping["device"] == "cpu" == str(r.slice.primary)
            assert set(ping["launches"]) == {"fused_lloyd_stats", "fused_assign",
                                             "fused_level_hist"}

    def test_atomic_swap_across_processes(self, proc_fleet):
        fs, _, x = proc_fleet
        m2 = port.KMeans(k=3, max_iter=9, seed=5).fit(x, device="cpu")
        fs.swap_model("km", m2, n_features=D)
        for r in fs.replicas:
            res = r.server.predict("km", x[:16])
            assert res.status == "ok"
            np.testing.assert_array_equal(np.asarray(res.value), predict_np(m2, x[:16]))
        assert fs.registry.get("km").model is m2

    def test_a_failed_prepare_flips_no_worker(self, proc_fleet):
        fs, _, x = proc_fleet
        before = fs.registry.get("km").model
        m3 = port.KMeans(k=3, max_iter=3, seed=9).fit(x, device="cpu")
        plan = faults.FaultPlan().fail(
            "fleet.swap.prepare", when=lambda ctx: ctx.get("replica") == 1,
            error=lambda: RuntimeError("injected prepare failure"))
        with faults.active(plan):
            with pytest.raises(RuntimeError, match="injected"):
                fs.swap_model("km", m3, n_features=D)
        for r in fs.replicas:
            np.testing.assert_array_equal(np.asarray(r.server.predict("km", x[:16]).value),
                                          predict_np(before, x[:16]))

    def test_lifecycle_attachment_is_loudly_unsupported(self, proc_fleet):
        fs, _, _ = proc_fleet
        with pytest.raises(NotImplementedError):
            fs.attach_lifecycle(object())

    @pytest.mark.chaos
    def test_sigkill_mid_load_unanswered_zero_then_revive(self, proc_fleet):
        fs, _, x = proc_fleet
        reqs = [fs.submit("km", x[i % 64: i % 64 + 4], tenant_id=f"t{i}") for i in range(24)]
        fs.kill_replica(0)
        results = [r.wait(15.0) for r in reqs]
        assert {r.status for r in results} <= {"ok", "unavailable", "rejected"}
        assert sum(r.status == "ok" for r in results) > 0
        assert all(r.detail != "client wait timed out" for r in results)
        post = read_dump(fs.replicas[0].server.last_postmortem)
        assert post["site"] == "fleet.proc.kill" and post["trigger"]["replica"] == 0
        assert fs.predict("km", x[:4], tenant_id="h1").status == "ok"
        fs.revive_replica(0)
        assert fs.replicas[0].healthy()
        assert fs.replicas[0].server.pid not in (None, os.getpid())
        assert fs.replicas[0].server.ping()["device"] == "cpu"
        assert fs.predict("km", x[:4], tenant_id="h1").status == "ok"
        assert fs.health()["status"] == "ok"

    @pytest.mark.chaos
    def test_external_sigkill_reaped_and_rerouted(self, proc_fleet):
        fs, _, x = proc_fleet
        victim = fs.replicas[1]
        os.kill(victim.server.pid, signal.SIGKILL)
        deadline = time.monotonic() + 10.0
        while victim.server.alive() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not victim.healthy()
        assert fs.predict("km", x[:4], tenant_id="h1").status == "ok"
        assert fs.reap() == [1]
        fs.revive_replica(1)
        assert fs.predict("km", x[:4], tenant_id="h1").status == "ok"

    @pytest.mark.chaos
    def test_rpc_corruption_site_is_transport_death(self, proc_fleet):
        fs, _, x = proc_fleet
        target = fs.router.route(tenant_id="h1", model="km").index
        plan = faults.FaultPlan().corrupt(
            "fleet.proc.rpc", at_byte=1, times=1,
            when=lambda ctx: ctx.get("replica") == target)
        with faults.active(plan):
            res = fs.submit("km", x[:4], tenant_id="h1").wait(10.0)
        assert res.status in ("ok", "unavailable")
        assert plan.fired("fleet.proc.rpc") == 1
        victim = fs.replicas[target]
        deadline = time.monotonic() + 10.0
        while victim.server.alive() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not victim.healthy()
        assert fs.reap() == [target]
        fs.revive_replica(target)
        assert fs.predict("km", x[:4], tenant_id="h1").status == "ok"


@pytest.mark.chaos
def test_spawn_fault_rides_retry_ladder():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(96, D)).astype(np.float32)
    model = port.KMeans(k=2, max_iter=3, seed=0).fit(x, device="cpu")
    plan = faults.FaultPlan().fail(
        "fleet.proc.spawn", times=1, error=lambda: OSError("injected spawn failure"))
    with faults.active(plan):
        fs = FP.ProcReplicaSet(n_replicas=1, devices=("cpu",), max_wait_s=0.005,
                               proc_env=WORKER_ENV)
    assert plan.fired("fleet.proc.spawn") == 1
    try:
        fs.add_model("km", model, n_features=D)
        with fs:
            assert fs.predict("km", x[:4], tenant_id="h1").status == "ok"
    except BaseException:
        fs.stop()
        raise


_CHILD = f"""
import sys
from {port.__name__}.serve.fleet.proc import worker_main
rc = worker_main(int(sys.argv[1]))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "{JAX_PKG}.")) or m == "{JAX_PKG}")
print("JAX_MODULES", bad, flush=True)
sys.exit(rc)
"""


def test_the_worker_process_imports_no_jax():
    """The test's own child runs ``worker_main`` through init, add_model,
    start, predict and ping, then reports its ``sys.modules``: nothing of
    jax or of the JAX package."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64, D)).astype(np.float32)
    model = port.KMeans(k=2, max_iter=3, seed=0).fit(x, device="cpu")
    a, b = socket.socketpair()
    env = dict(os.environ, PYTHONPATH=str(REPO), **WORKER_ENV)
    proc = subprocess.Popen([sys.executable, "-c", _CHILD, str(b.fileno())],
                            pass_fds=(b.fileno(),), env=env, stdout=subprocess.PIPE,
                            text=True)
    b.close()
    try:
        a.settimeout(120)

        def call(i, **msg):
            FP.send_frame(a, {"id": i, **msg})
            reply = FP.recv_frame(a)
            assert reply["id"] == i and reply["ok"], reply
            return reply

        call(1, op="init", server_kw={"device": "cpu", "max_wait_s": 0.005},
             worker_threads=1, replica=0)
        call(2, op="add_model", name="km", model=model, n_features=D, buckets=(8,),
             fallback=None, data_profile=None, guard_kw={})
        call(3, op="start")
        got = call(4, op="predict", name="km", x=x[:8], deadline_s=None, wait_timeout_s=30.0)
        assert got["result"]["status"] == "ok"
        np.testing.assert_array_equal(got["result"]["value"], predict_np(model, x[:8]))
        assert call(5, op="ping")["value"]["device"] == "cpu"
        FP.send_frame(a, {"op": "exit", "id": 0})
        out, _ = proc.communicate(timeout=60)
    finally:
        a.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0
    assert "JAX_MODULES []" in out, out
