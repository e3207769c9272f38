"""Multi-process fleet: each replica is a real OS process.

The in-process :class:`~.replica_set.ReplicaSet` multiplies servers
inside ONE Python interpreter — replicas share the GIL and one CUDA
context.  This module runs each replica as its own process with its own
CUDA context, so fleet goodput can scale with N where the host has the
cores: ``ProcReplicaSet`` overrides the seams the base class exposes
(``_build_server`` / ``_make_replica`` / ``_make_replicas``: its workers
spawn side by side) and everything else —
router, admission, atomic swap, kill/revive, metrics pull — is the
in-process code path, unchanged.

Transport
---------
One ``socketpair`` per replica, passed to the spawned worker by fd.
Frames are ``magic + u32 big-endian length + pickle``: a torn header,
bad magic, oversize length, or undecodable payload each raise
:class:`FrameError` — the stream has no resync point, so a framing
error is transport death, answered by the same ladder as a process
death.  Parent→child requests carry a monotone ``id``; the parent's
receive thread resolves replies against a pending map, so any number of
requests overlap on one socket.  Model objects cross the wire pickled
(their parameters are host numpy arrays; a model's per-device tensor
cache is dropped by its ``__getstate__``, so a model already served on
the card pickles no CUDA tensor); fallbacks must be picklable or
``None``.

Failure ladder (reused, not reinvented)
---------------------------------------
* spawn: :func:`...utils.retry.call_with_retry` around the whole
  spawn+handshake (the ``fleet.proc.spawn`` fault site fires inside it,
  so an injected transient spawn failure is retried like any IO fault);
* data plane: a parent-side :class:`~..breaker.CircuitBreaker` guards
  the transport — timeouts and framing errors count as failures, and an
  open breaker makes ``submit``/``predict`` raise ``KeyError``, which is
  precisely the signal the fleet's bounded reroute loop already treats
  as "replica lost mid-dispatch";
* death: EOF on the socket completes EVERY in-flight request with a
  ``ServeResult(status=unavailable)`` — answered, never stranded — and
  flips the client dead so ``ProcReplica.healthy()`` excludes it from
  routing.

Swap atomicity
--------------
``prepare_swap`` builds + warms the successor INSIDE the worker and
parks it behind an integer handle; ``commit_swap`` flips it.  The
fleet's ``swap_model`` therefore keeps its every-replica-or-none shape:
phase 1 RPCs can fail with zero replicas flipped; phase 2 commits are
in-memory flips in each worker.

Worker device and environment
-----------------------------
Each worker is told its device: the slice primary's, as a string
(``"cuda:0"``, ``"cpu"``) in the ``init`` frame's ``server_kw``; its
``ping`` reply reports that device beside its pid, and its kernel launch
counts.  On one card every worker opens its own CUDA context there, and
the driver time-slices them.  The child inherits the parent's env with
the repo root put on ``PYTHONPATH``; workers are started by
``subprocess.Popen`` (fork then exec: safe under a parent that already
holds a CUDA context), never by ``multiprocessing``'s fork.  When the
fleet's device is the card, the parent loads the kernel libraries before
it spawns, so N workers find them built instead of running ``nvcc`` N
times; a worker whose library fails to load fails its spawn (the retry
ladder), it never serves the plain version.
"""

from __future__ import annotations

import itertools
import os
import pathlib
import pickle
import queue as _queue
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np

from ...device import resolve_device
from ...obs import flight_recorder as _flight
from ...obs import trace as _trace
from ...obs.registry import replica_label
from ...tune import knob
from ...utils.faults import fault_point, mangle_bytes
from ...utils.logging import get_logger
from ...utils.retry import RetryPolicy, call_with_retry
from ..breaker import STATE_OPEN, CircuitBreaker
from ..bucketing import DEFAULT_BUCKETS
from ..queue import Request, ServeResult, STATUS_UNAVAILABLE
from .replica_set import (
    _BREAKER_CODE,
    _STATE_CODE,
    REPLICA_DEAD,
    REPLICA_LIVE,
    Replica,
    ReplicaSet,
    default_devices,
)

log = get_logger("serve")

#: fully-qualified module the worker is spawned as (``python -m ...``);
#: a dedicated entry module, so runpy never re-executes a module the
#: package ``__init__`` already imported
_WORKER_MODULE = (
    "clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch"
    ".serve.fleet._proc_worker"
)
_REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]

# ----------------------------------------------------------------- framing

_MAGIC = b"CMP1"

#: the one chaos-injectable wire site: every parent→worker frame passes
#: through :func:`mangle_bytes` under this name (a once-assigned literal
#: so ``tools/check_obs.py`` can tie it to ``SITE_COVERAGE``).
RPC_SITE = "fleet.proc.rpc"
_HEADER = struct.Struct(">4sI")
#: 64 MiB — generous for a pickled model + profile, small enough that a
#: corrupted length field can't ask the receiver to buffer gigabytes
MAX_FRAME_BYTES = 64 << 20


class RPCError(RuntimeError):
    """Control-plane RPC failure (timeout, transport death, remote
    error) — loud, because control calls (add/swap/start) have no
    reroute fallback."""


class FrameError(RPCError):
    """Unrecoverable wire-format violation: torn header/payload, bad
    magic, oversize length, undecodable pickle.  The stream has no
    resync point, so the connection is dead."""


def send_frame(
    sock: socket.socket,
    obj: Any,
    *,
    lock: threading.Lock | None = None,
    mangle: bool = False,
    max_bytes: int = MAX_FRAME_BYTES,
    **ctx,
) -> None:
    """Pickle ``obj`` and write one length-prefixed frame.  ``mangle``
    routes the encoded payload through :func:`mangle_bytes` at
    :data:`RPC_SITE` so chaos tests can corrupt RPC bytes in flight."""
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    if mangle:
        payload = mangle_bytes(RPC_SITE, payload, **ctx)
    if len(payload) > max_bytes:
        raise FrameError(
            f"frame of {len(payload)} bytes exceeds the "
            f"{max_bytes}-byte cap"
        )
    buf = _HEADER.pack(_MAGIC, len(payload)) + payload
    if lock is not None:
        with lock:
            sock.sendall(buf)
    else:
        sock.sendall(buf)


def _recv_exact(
    sock: socket.socket, n: int, *, eof_ok: bool = False
) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if eof_ok and not buf:
                return None
            raise FrameError(
                f"connection closed mid-frame ({len(buf)}/{n} bytes)"
            )
        buf += chunk
    return bytes(buf)


def recv_frame(
    sock: socket.socket, *, max_bytes: int = MAX_FRAME_BYTES
) -> Any | None:
    """Read one frame; ``None`` on clean EOF at a frame boundary,
    :class:`FrameError` on any wire-format violation."""
    head = _recv_exact(sock, _HEADER.size, eof_ok=True)
    if head is None:
        return None
    magic, length = _HEADER.unpack(head)
    if magic != _MAGIC:
        raise FrameError(f"bad frame magic {magic!r}")
    if length > max_bytes:
        raise FrameError(f"oversize frame: {length} > {max_bytes} bytes")
    payload = _recv_exact(sock, length)
    try:
        return pickle.loads(payload)
    except Exception as e:  # noqa: BLE001 — any decode failure is torn wire
        raise FrameError(f"undecodable frame payload: {e!r}") from None


# ----------------------------------------------------------------- client

#: spawn + handshake retry: a transient spawn failure (including one
#: injected at ``fleet.proc.spawn``) rides the standard IO ladder
_SPAWN_RETRY = RetryPolicy(
    max_attempts=3, base_delay_s=0.05, max_delay_s=1.0,
    retryable=(OSError, FrameError),
)


class _RegistryEntry:
    """Parent-side registry row: just enough surface for
    ``_FleetModelView.get`` / ``predict_tenant``'s affinity lookup."""

    __slots__ = ("model",)

    def __init__(self, model):
        self.model = model


class _ClientRegistry:
    def __init__(self):
        self._entries: dict[str, _RegistryEntry] = {}

    def names(self) -> list[str]:
        return sorted(self._entries)

    def get(self, name: str) -> _RegistryEntry:
        return self._entries[name]


@dataclass
class ProcPreparedSwap:
    """Parent handle to a successor prepared INSIDE a worker."""

    name: str
    handle: int
    model: Any


class ProcServerClient:
    """The parent-side facade over one replica worker process — the same
    surface :class:`~..server.InferenceServer` exposes to the fleet
    (``add_model``/``prepare_swap``/``commit_swap``/``start``/``stop``/
    ``submit``/``predict``/``predict_tenant``/``registry``), answered
    over the frame RPC."""

    def __init__(
        self,
        replica_id: int,
        server_kw: dict,
        *,
        worker_threads: int = 2,
        spawn_timeout_s: float = 180.0,
        rpc_timeout_s: float = 30.0,
        max_frame_bytes: int = MAX_FRAME_BYTES,
        env: dict | None = None,
    ):
        self.replica_id = replica_id
        self._server_kw = dict(server_kw)
        # the registry owns the bound: this fallback used to be a fifth
        # hand-copied 4096 that could (and did) diverge from the other
        # four — now every path resolves serve.queue.max_rows
        mq = self._server_kw.get("max_queue_rows")
        self.max_queue_rows = int(
            knob("serve.queue.max_rows") if mq is None else mq
        )
        self.breaker = CircuitBreaker(
            failure_threshold=int(
                self._server_kw.get("breaker_failure_threshold", 5)
            ),
            recovery_timeout_s=float(
                self._server_kw.get("breaker_recovery_s", 5.0)
            ),
        )
        self._worker_threads = max(int(worker_threads), 1)
        self._spawn_timeout_s = spawn_timeout_s
        self._rpc_timeout_s = rpc_timeout_s
        self._max_frame = max_frame_bytes
        self._env_extra = dict(env or {})
        self.registry = _ClientRegistry()
        self._send_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._pending: dict[int, dict] = {}
        self._ids = itertools.count(1)
        self._inflight_rows = 0
        self._dead = threading.Event()
        self._closing = False
        self._sock: socket.socket | None = None
        self._proc: subprocess.Popen | None = None
        self.pid: int | None = None
        self.counters: dict[str, float] = {
            "serve.requests": 0.0,
            "fleet.proc.rpc_sent": 0.0,
            "fleet.proc.short_circuited": 0.0,
            "fleet.proc.transport_down": 0.0,
            "fleet.proc.killed": 0.0,
        }
        #: flight-recorder artifact path from the last ``kill()``
        self.last_postmortem: str | None = None
        call_with_retry(self._spawn, policy=_SPAWN_RETRY)

    # ------------------------------------------------------------ spawn
    def _worker_env(self) -> dict:
        env = dict(os.environ)
        pp = env.get("PYTHONPATH")
        root = str(_REPO_ROOT)
        env["PYTHONPATH"] = root + (os.pathsep + pp if pp else "")
        env.update(self._env_extra)
        return env

    def _spawn(self) -> None:
        fault_point("fleet.proc.spawn", replica=self.replica_id)
        self._teardown_transport()
        with _trace.span(
            "fleet.proc",
            {"event": "spawn", "replica": replica_label(self.replica_id)},
        ):
            parent, child = socket.socketpair()
            try:
                proc = subprocess.Popen(
                    [
                        sys.executable, "-m", _WORKER_MODULE,
                        "--fd", str(child.fileno()),
                    ],
                    pass_fds=(child.fileno(),),
                    env=self._worker_env(),
                    close_fds=True,
                )
            except Exception:
                parent.close()
                raise
            finally:
                child.close()
            self._sock, self._proc = parent, proc
            try:
                rid = next(self._ids)
                send_frame(parent, {
                    "op": "init", "id": rid,
                    "server_kw": self._server_kw,
                    "worker_threads": self._worker_threads,
                    "replica": self.replica_id,
                }, max_bytes=self._max_frame)
                parent.settimeout(self._spawn_timeout_s)
                reply = recv_frame(parent, max_bytes=self._max_frame)
                parent.settimeout(None)
            except (OSError, FrameError):
                self._teardown_transport()
                raise
            if reply is None or not reply.get("ok"):
                self._teardown_transport()
                raise OSError(
                    f"replica {self.replica_id} worker failed to "
                    f"initialize: {reply and reply.get('error')}"
                )
        self.pid = proc.pid
        self._dead = threading.Event()
        self._closing = False
        t = threading.Thread(
            target=self._recv_loop,
            name=f"proc-replica-{self.replica_id}-recv", daemon=True,
        )
        t.start()
        log.info(
            "replica worker spawned",
            replica=self.replica_id, pid=proc.pid,
        )

    def _teardown_transport(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        proc, self._proc = self._proc, None
        if proc is not None and proc.poll() is None:
            proc.kill()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass

    # ------------------------------------------------------------ receive
    def _recv_loop(self) -> None:
        sock = self._sock
        while True:
            try:
                msg = recv_frame(sock, max_bytes=self._max_frame)
            except (FrameError, OSError) as e:
                self._on_transport_down(str(e))
                return
            if msg is None:
                self._on_transport_down("connection closed by worker")
                return
            self._dispatch(msg)

    def _dispatch(self, msg: dict) -> None:
        with self._state_lock:
            entry = self._pending.pop(msg.get("id"), None)
            if entry is not None and entry["kind"] == "request":
                self._inflight_rows -= entry["rows"]
        if entry is None:
            return  # late reply for a request nobody waits on anymore
        if entry["kind"] == "request":
            if msg.get("ok"):
                r = msg["result"]
                res = ServeResult(
                    r["value"], r["status"],
                    degraded=r["degraded"], detail=r["detail"],
                )
                self.counters["serve.requests"] += 1
            else:
                res = ServeResult(
                    None, STATUS_UNAVAILABLE,
                    detail=f"worker error: {msg.get('error', '')}",
                )
            # a reply arrived at all: the TRANSPORT is healthy, whatever
            # the model answered
            self.breaker.record_success()
            entry["req"].complete(res)
        else:
            entry["reply"] = msg
            entry["event"].set()

    def _on_transport_down(self, detail: str) -> None:
        with self._state_lock:
            if self._dead.is_set():
                return
            self._dead.set()
            closing = self._closing
            pending = list(self._pending.values())
            self._pending.clear()
            self._inflight_rows = 0
        if not closing:
            # an EXPECTED close (our own stop()) is not a failure signal
            self.breaker.record_failure()
            self.counters["fleet.proc.transport_down"] += 1
        for entry in pending:
            if entry["kind"] == "request":
                entry["req"].complete(ServeResult(
                    None, STATUS_UNAVAILABLE,
                    detail=f"replica process died: {detail}",
                ))
            else:
                entry["error"] = RPCError(
                    f"replica {self.replica_id} transport down: {detail}"
                )
                entry["event"].set()
        if not closing:
            log.warning(
                "replica transport down",
                replica=self.replica_id, detail=detail,
                answered_inflight=len(pending),
            )

    # ------------------------------------------------------------ send
    def _send(self, msg: dict) -> None:
        fault_point(
            RPC_SITE, replica=self.replica_id, op=msg.get("op")
        )
        sock = self._sock
        if sock is None or self._dead.is_set():
            raise OSError(f"replica {self.replica_id} transport is down")
        send_frame(
            sock, msg, lock=self._send_lock, mangle=True,
            max_bytes=self._max_frame,
            replica=self.replica_id, op=msg.get("op"),
        )

    # ------------------------------------------------------------ control
    def alive(self) -> bool:
        return (
            not self._dead.is_set()
            and self._proc is not None
            and self._proc.poll() is None
        )

    def inflight_rows(self) -> int:
        with self._state_lock:
            return self._inflight_rows

    def _call(self, op: str, *, timeout: float | None = None, **fields):
        if not self.alive():
            raise RPCError(f"replica {self.replica_id} process is dead")
        rid = next(self._ids)
        entry = {
            "kind": "call", "event": threading.Event(),
            "reply": None, "error": None,
        }
        with self._state_lock:
            self._pending[rid] = entry
        try:
            self._send({"op": op, "id": rid, **fields})
        except (OSError, FrameError) as e:
            with self._state_lock:
                self._pending.pop(rid, None)
            self.breaker.record_failure()
            raise RPCError(
                f"{op} rpc to replica {self.replica_id} failed: {e}"
            ) from e
        if not entry["event"].wait(timeout or self._rpc_timeout_s):
            with self._state_lock:
                self._pending.pop(rid, None)
            self.breaker.record_failure()
            raise RPCError(
                f"{op} rpc to replica {self.replica_id} timed out after "
                f"{timeout or self._rpc_timeout_s:g}s"
            )
        if entry["error"] is not None:
            raise entry["error"]
        reply = entry["reply"]
        if not reply.get("ok"):
            if reply.get("error_type") == "KeyError":
                raise KeyError(reply.get("error"))
            raise RPCError(
                f"{op} failed on replica {self.replica_id}: "
                f"{reply.get('error')}"
            )
        return reply.get("value")

    def ping(self) -> dict:
        return call_with_retry(
            lambda: self._call("ping"), policy=_SPAWN_RETRY
        )

    # ------------------------------------------------------------ setup
    def add_model(
        self,
        name: str,
        model,
        n_features: int | None = None,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        fallback=None,
        data_profile: dict | None = None,
        **guard_kw,
    ) -> None:
        self._call(
            "add_model", timeout=max(self._rpc_timeout_s, 120.0),
            name=name, model=model, n_features=n_features,
            buckets=tuple(buckets), fallback=fallback,
            data_profile=data_profile, guard_kw=dict(guard_kw),
        )
        self.registry._entries[name] = _RegistryEntry(model)

    def prepare_swap(
        self,
        name: str,
        model,
        n_features: int | None = None,
        buckets: Sequence[int] | None = None,
        data_profile: dict | None = None,
    ) -> ProcPreparedSwap:
        handle = self._call(
            "prepare_swap", timeout=max(self._rpc_timeout_s, 120.0),
            name=name, model=model, n_features=n_features,
            buckets=tuple(buckets) if buckets is not None else None,
            data_profile=data_profile,
        )
        return ProcPreparedSwap(name=name, handle=int(handle), model=model)

    def commit_swap(
        self, prepared: ProcPreparedSwap, fire_fault_point: bool = True
    ) -> str:
        self._call(
            "commit_swap", handle=prepared.handle, name=prepared.name
        )
        self.registry._entries[prepared.name] = _RegistryEntry(
            prepared.model
        )
        return prepared.name

    def attach_lifecycle(self, controller) -> None:
        raise NotImplementedError(
            "lifecycle controllers are in-process objects; a multi-"
            "process fleet cannot share one across workers — run the "
            "controller against an in-process ReplicaSet"
        )

    def start(self) -> "ProcServerClient":
        # warmup compiles per-bucket executables in the worker — give it
        # the spawn budget, not the per-RPC one
        self._call("start", timeout=max(
            self._rpc_timeout_s, self._spawn_timeout_s
        ))
        return self

    def stop(self) -> None:
        self._closing = True
        if self.alive():
            try:
                self._call("stop", timeout=self._rpc_timeout_s)
                self._send({"op": "exit", "id": 0})
            except (RPCError, OSError):
                pass
        proc = self._proc
        if proc is not None:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
        self._dead.set()
        sock = self._sock
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def kill(self) -> None:
        """SIGKILL the worker — the chaos surface.  The receive thread
        sees EOF and answers every in-flight request ``unavailable``;
        a flight-recorder postmortem records the kill."""
        fault_point("fleet.proc.kill", replica=self.replica_id)
        pid = self.pid
        with _trace.span(
            "fleet.proc",
            {"event": "kill", "replica": replica_label(self.replica_id)},
        ):
            proc = self._proc
            if proc is not None and proc.poll() is None:
                os.kill(proc.pid, signal.SIGKILL)
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass
        self.counters["fleet.proc.killed"] += 1
        self.last_postmortem = _flight.notify(
            "replica_proc_killed", "fleet.proc.kill",
            replica=self.replica_id, pid=pid or -1,
        )

    # ------------------------------------------------------------ serving
    def _submit_op(
        self, op: str, name: str, x: np.ndarray,
        deadline_s: float | None, extra: dict,
    ) -> Request:
        if name not in self.registry._entries:
            raise KeyError(
                f"model {name!r} is not registered on replica "
                f"{self.replica_id}"
            )
        if not self.alive():
            raise KeyError(f"replica {self.replica_id} process is dead")
        if not self.breaker.allow():
            self.counters["fleet.proc.short_circuited"] += 1
            raise KeyError(
                f"replica {self.replica_id} transport breaker open"
            )
        x2 = np.asarray(x, dtype=np.float32)
        if x2.ndim == 1:
            x2 = x2[None, :]
        now = time.monotonic()
        req = Request(
            x=x2, enqueued_at=now,
            deadline=(now + deadline_s) if deadline_s is not None else None,
        )
        rid = next(self._ids)
        entry = {"kind": "request", "req": req, "rows": int(x2.shape[0])}
        with self._state_lock:
            self._pending[rid] = entry
            self._inflight_rows += entry["rows"]
        try:
            self._send({
                "op": op, "id": rid, "name": name, "x": x2,
                "deadline_s": deadline_s, **extra,
            })
        except (OSError, FrameError) as e:
            with self._state_lock:
                if self._pending.pop(rid, None) is not None:
                    self._inflight_rows -= entry["rows"]
            self.breaker.record_failure()
            raise KeyError(
                f"replica {self.replica_id} rpc send failed: {e}"
            ) from e
        self.counters["fleet.proc.rpc_sent"] += 1
        return req

    def submit(
        self, name: str, x: np.ndarray, deadline_s: float | None = None
    ) -> Request:
        return self._submit_op(
            "predict", name, x, deadline_s,
            {"wait_timeout_s": 30.0},
        )

    def predict(
        self, name: str, x: np.ndarray, deadline_s: float | None = None,
        wait_timeout_s: float | None = 30.0,
    ) -> ServeResult:
        req = self._submit_op(
            "predict", name, x, deadline_s,
            {"wait_timeout_s": wait_timeout_s},
        )
        # small margin past the worker's own wait so its deadline answer
        # (not our blunter client-timeout one) normally wins the race
        return req.wait(
            None if wait_timeout_s is None else wait_timeout_s + 2.0
        )

    def predict_tenant(
        self, name: str, tenant_id, x: np.ndarray,
        deadline_s: float | None = None,
        wait_timeout_s: float | None = 30.0,
    ) -> ServeResult:
        req = self._submit_op(
            "predict_tenant", name, x, deadline_s,
            {"tenant_id": tenant_id, "wait_timeout_s": wait_timeout_s},
        )
        return req.wait(
            None if wait_timeout_s is None else wait_timeout_s + 2.0
        )

    def stats(self) -> dict:
        """The worker server's own counters (best-effort snapshot)."""
        return self._call("stats")


# ----------------------------------------------------------------- fleet


class ProcReplica(Replica):
    """A replica whose server is a :class:`ProcServerClient`: health and
    load reads are PARENT-side (no RPC on the routing hot path)."""

    def healthy(self) -> bool:
        return self.state == REPLICA_LIVE and self.server.alive()

    def load_rows(self) -> int:
        return self.server.inflight_rows()

    def capacity_rows(self) -> int:
        return self.server.max_queue_rows

    def breaker_open(self, model: str) -> bool:
        # one transport breaker guards every model on the replica
        return self.server.breaker.state == STATE_OPEN

    def obs_fragment(self) -> dict:
        idx = replica_label(self.index)
        snap = self.server.breaker.snapshot()
        gauges = {
            f'fleet.replica_state{{replica="{idx}"}}':
                _STATE_CODE[self.state],
            f'fleet.replica_queue_rows{{replica="{idx}"}}':
                float(self.load_rows()),
            f'fleet.breaker_state{{model="transport",replica="{idx}"}}':
                _BREAKER_CODE.get(snap["state"], -1.0),
        }
        return {
            "counters": dict(self.server.counters),
            "gauges": gauges,
            "histograms": {},
        }


class ProcReplicaSet(ReplicaSet):
    """A :class:`ReplicaSet` whose replicas are OS processes.

    Everything above the server seam — router, admission, atomic
    ``swap_model``, ``kill_replica``/``revive_replica``, health — is the
    in-process code path; only ``_build_server``/``_make_replica`` (and
    the kill path, which SIGKILLs instead of stopping) differ, and the
    workers of a new fleet spawn side by side.

    ``devices`` places the workers as it places in-process replicas
    (default every card, raising without one); each worker serves on its
    slice's primary, named to it as a string."""

    def __init__(
        self,
        n_replicas: int = 2,
        *,
        worker_threads: int = 2,
        spawn_timeout_s: float = 180.0,
        rpc_timeout_s: float = 30.0,
        max_frame_bytes: int = MAX_FRAME_BYTES,
        proc_env: dict | None = None,
        **kw,
    ):
        self._proc_kw = dict(
            worker_threads=worker_threads,
            spawn_timeout_s=spawn_timeout_s,
            rpc_timeout_s=rpc_timeout_s,
            max_frame_bytes=max_frame_bytes,
            env=dict(proc_env or {}),
        )
        devices = kw.get("devices")
        kw["devices"] = default_devices() if devices is None else devices
        if any(resolve_device(d).type == "cuda" for d in kw["devices"]):
            # build and load the kernels ONCE here: N workers then load
            # the built libraries instead of each running nvcc
            from ...ops import _build

            for name in _build.SOURCES:
                _build.load(name)
        super().__init__(n_replicas=n_replicas, **kw)

    # ------------------------------------------------------------ seams
    def _build_server(self, slice_):
        return ProcServerClient(
            slice_.replica_id,
            dict(self._server_kw, device=str(resolve_device(slice_.primary))),
            **self._proc_kw,
        )

    def _make_replica(self, slice_):
        return ProcReplica(
            slice_.replica_id, slice_, self._build_server(slice_)
        )

    def _make_replicas(self, slices):
        """Spawn the workers side by side: a spawn is a process start and
        a package import (seconds), independent of the others.  A spawn
        that fails past its retries stops the workers already up and
        raises."""
        with ThreadPoolExecutor(max_workers=max(len(slices), 1)) as pool:
            futures = [pool.submit(self._make_replica, s) for s in slices]
        built, first_error = [], None
        for f in futures:
            try:
                built.append(f.result())
            except BaseException as e:  # noqa: BLE001 — re-raised below
                first_error = first_error or e
        if first_error is not None:
            for r in built:
                r.server.stop()
            raise first_error
        return built

    # ------------------------------------------------------------ chaos
    def kill_replica(self, index: int) -> None:
        """Abrupt replica-process death: the router stops picking it
        FIRST (state flip), then SIGKILL — in-flight requests are
        answered ``unavailable`` by the transport-down ladder, never
        stranded."""
        r = self._replicas[index]
        r.state = REPLICA_DEAD
        r.server.kill()
        self.metrics.inc("fleet.replicas_killed")
        log.warning("replica process killed", replica=index)

    def reap(self) -> list[int]:
        """Notice worker processes that died OUTSIDE the fleet API (an
        external SIGKILL, an OOM kill): flip them DEAD so
        ``revive_replica`` accepts them.  Routing already excludes them
        — ``ProcReplica.healthy()`` checks the process, not just the
        state flag."""
        reaped = []
        for r in self._replicas:
            if r.state == REPLICA_LIVE and not r.server.alive():
                r.state = REPLICA_DEAD
                self.metrics.inc("fleet.replicas_killed")
                reaped.append(r.index)
                log.warning("replica process reaped", replica=r.index)
        return reaped

    def attach_lifecycle(self, controller) -> None:
        raise NotImplementedError(
            "lifecycle controllers are in-process objects; attach one "
            "to an in-process ReplicaSet instead"
        )


# ----------------------------------------------------------------- worker


def _result_payload(res: ServeResult) -> dict:
    return {
        "value": None if res.value is None else np.asarray(res.value),
        "status": res.status,
        "degraded": res.degraded,
        "detail": res.detail,
    }


def worker_main(fd: int) -> int:
    """The replica worker: owns ONE :class:`InferenceServer` on the device
    its ``init`` frame names (on the card: this process's own CUDA
    context, its kernel libraries loaded before it reports ready) and
    answers frame RPCs until EOF/exit.  The main thread only reads
    frames; a small pool executes ops so long predicts overlap (ids, not
    ordering, match replies)."""
    sock = socket.socket(fileno=fd)
    send_lock = threading.Lock()
    init = recv_frame(sock)
    if init is None or init.get("op") != "init":
        return 2
    try:
        from ...ops import _build, launch_counts
        from ..server import InferenceServer

        server = InferenceServer(**init.get("server_kw", {}))
        if server.device.type == "cuda":
            # a library that fails to load fails the spawn: no worker on
            # the card ever answers through the plain version
            for name in _build.SOURCES:
                _build.load(name)
    except Exception as e:  # noqa: BLE001 — report, don't die silently
        try:
            send_frame(
                sock, {"id": init.get("id"), "ok": False, "error": repr(e)},
                lock=send_lock,
            )
        except OSError:
            pass
        return 3
    send_frame(
        sock,
        {"id": init.get("id"), "ok": True, "value": {"pid": os.getpid()}},
        lock=send_lock,
    )

    work: _queue.Queue = _queue.Queue()
    prepared: dict[int, Any] = {}
    handle_ids = itertools.count(1)

    def answer(rid, **out) -> None:
        try:
            send_frame(sock, {"id": rid, **out}, lock=send_lock)
        except OSError:
            pass  # parent gone; the drain below will notice EOF too

    def run_op(m: dict) -> None:
        rid, op = m.get("id"), m.get("op")
        try:
            if op == "predict":
                res = server.predict(
                    m["name"], m["x"], deadline_s=m.get("deadline_s"),
                    wait_timeout_s=m.get("wait_timeout_s", 30.0),
                )
                answer(rid, ok=True, result=_result_payload(res))
            elif op == "predict_tenant":
                res = server.predict_tenant(
                    m["name"], m["tenant_id"], m["x"],
                    deadline_s=m.get("deadline_s"),
                    wait_timeout_s=m.get("wait_timeout_s", 30.0),
                )
                answer(rid, ok=True, result=_result_payload(res))
            elif op == "add_model":
                server.add_model(
                    m["name"], m["model"],
                    n_features=m.get("n_features"),
                    buckets=m.get("buckets") or DEFAULT_BUCKETS,
                    fallback=m.get("fallback"),
                    data_profile=m.get("data_profile"),
                    **(m.get("guard_kw") or {}),
                )
                answer(rid, ok=True, value=True)
            elif op == "prepare_swap":
                p = server.prepare_swap(
                    m["name"], m["model"],
                    n_features=m.get("n_features"),
                    buckets=m.get("buckets"),
                    data_profile=m.get("data_profile"),
                )
                h = next(handle_ids)
                prepared[h] = p
                answer(rid, ok=True, value=h)
            elif op == "commit_swap":
                p = prepared.pop(m["handle"])
                server.commit_swap(p, fire_fault_point=False)
                answer(rid, ok=True, value=True)
            elif op == "start":
                server.start()
                answer(rid, ok=True, value=True)
            elif op == "stop":
                server.stop()
                answer(rid, ok=True, value=True)
            elif op == "ping":
                answer(rid, ok=True, value={
                    "pid": os.getpid(), "device": str(server.device),
                    "launches": launch_counts(),
                })
            elif op == "stats":
                answer(rid, ok=True, value={
                    "counters": dict(server.metrics.registry.counters),
                })
            else:
                answer(
                    rid, ok=False, error=f"unknown op {op!r}",
                    error_type="RPCError",
                )
        except KeyError as e:
            answer(rid, ok=False, error=str(e), error_type="KeyError")
        except Exception as e:  # noqa: BLE001 — answered, not fatal
            answer(
                rid, ok=False, error=repr(e),
                error_type=type(e).__name__,
            )

    def worker_loop() -> None:
        while True:
            m = work.get()
            if m is None:
                return
            run_op(m)

    n_threads = max(int(init.get("worker_threads", 2)), 1)
    threads = [
        threading.Thread(target=worker_loop, name=f"op-{i}", daemon=True)
        for i in range(n_threads)
    ]
    for t in threads:
        t.start()

    rc = 0
    while True:
        try:
            m = recv_frame(sock)
        except FrameError:
            # torn/garbage frame: no resync point — die loudly, the
            # parent's breaker/reroute ladder owns recovery
            rc = 4
            break
        except OSError:
            break
        if m is None or m.get("op") == "exit":
            break
        work.put(m)

    for _ in threads:
        work.put(None)
    # the op threads finish before the process exits: torch's at-exit
    # teardown under a live daemon thread aborts the interpreter
    for t in threads:
        t.join(timeout=10.0)
    try:
        server.stop()
    except Exception:  # noqa: BLE001 — already exiting
        pass
    return rc


def _main(argv: Sequence[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="fleet replica worker")
    ap.add_argument("--fd", type=int, required=True,
                    help="inherited socketpair fd")
    ns = ap.parse_args(argv)
    return worker_main(ns.fd)


if __name__ == "__main__":
    sys.exit(_main())
