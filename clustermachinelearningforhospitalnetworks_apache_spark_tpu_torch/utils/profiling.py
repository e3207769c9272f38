"""Profiling hooks over ``torch.profiler`` (the JAX package's
``utils/profiling.py``, which wraps ``jax.profiler``).

Every pipeline stage can be wrapped in a named annotation that shows in
the device trace, a whole run can be captured to a Chrome trace
(``chrome://tracing`` or Perfetto), stage wall times are accumulated by
:class:`StageClock`, and :func:`host_sync_census` counts the blocking
device→host syncs of a scope.
"""

from __future__ import annotations

import os
import threading
import time
import warnings
from contextlib import contextmanager
from typing import Iterator

import numpy as np
import torch

from ..obs import trace as _trace


class StageClock:
    """Wall-clock accumulator per named pipeline stage.

    The streaming pipeline runs its stages on different threads (parse +
    firewall on the prefetch worker, transfer/update/durability on the
    commit thread), so the per-stage seconds are what proves the overlap:
    when stages overlap, ``sum(seconds.values())`` exceeds the elapsed
    wall time.  Thread-safe; ~two ``perf_counter`` calls of overhead per
    stage entry.

    The clock is also a **span sink**: with a tracer installed
    (``obs/trace.py``), every stage exit emits span ``stage.<name>`` under
    whatever unit of work is in flight on the calling thread.
    Uninstalled, the extra cost is one module-global load and an ``is
    None`` test."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.seconds: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.seconds[name] = self.seconds.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1
            if _trace.enabled():
                _trace.record_span("stage." + name, dt)

    def shares(self) -> dict[str, float]:
        """Fraction of the summed stage time each stage took (NOT of the
        wall clock — overlapped stages sum past it by design)."""
        with self._lock:
            total = sum(self.seconds.values())
            if total <= 0:
                return {}
            return {k: v / total for k, v in sorted(self.seconds.items())}


def _put_counter(counter: dict):
    """A dispatch mode that adds one to ``counter["device_put"]`` for each
    aten copy of a non-empty CPU tensor into a CUDA tensor: ``_to_copy``
    (behind ``.to()``, ``.cuda()``, ``torch.tensor(..., device=)``) and
    ``copy_``.  The mode sees every op dispatched on this thread, so the
    count is exact for the scope (a 0-dim CPU tensor that a CUDA op reads
    as a scalar is not a copy and is not counted)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten

    class _Puts(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is aten._to_copy.default:
                src, dst = args[0], out
            elif func is aten.copy_.default:
                dst, src = args[0], args[1]
            else:
                return out
            if (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
                    and src.device.type == "cpu" and dst.device.type == "cuda"
                    and src.numel()):
                counter["device_put"] += 1
            return out

    return _Puts()


@contextmanager
def host_sync_census(count_puts: bool = False) -> Iterator[dict]:
    """Count the blocking host↔device syncs of the enclosed scope (the
    reference's ``jax.device_get`` census, with its dict keys).

    ``device_get``: every CUDA call that makes the host wait for the card
    (``.item()``, ``.cpu()`` of a card tensor, ``float(t)``, a nonzero,
    and a blocking host→device copy, which waits for the card's stream
    too) — counted through ``torch.cuda.set_sync_debug_mode``, which warns
    once per such call; the scope's warnings are recorded and counted,
    not shown.  On the CPU nothing syncs and the count stays 0.

    ``device_put`` (with ``count_puts=True``): the host→device copies of
    the scope, counted by a ``TorchDispatchMode`` at the aten op that
    makes each one (:func:`_put_counter`: ``_to_copy`` and ``copy_`` from
    a CPU tensor into a CUDA tensor), so a ``torch.tensor(...,
    device="cuda")``, a ``.to("cuda")`` and a ``copy_`` each count once,
    whatever called them.  Without a card it stays 0.  The mode runs
    Python at every op of the scope: time nothing inside a counting scope.

    Not thread-safe — meant for single-threaded measurement scopes, not
    production serving.  Yields the dict; its counts are final when the
    scope exits."""
    counter = {"device_get": 0, "device_put": 0}
    cuda = torch.cuda.is_available()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mode = _put_counter(counter) if count_puts else None
        if mode is not None:
            mode.__enter__()
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield counter
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
            if mode is not None:
                mode.__exit__(None, None, None)
            counter["device_get"] += sum(
                "synchroniz" in str(w.message) for w in caught)


@contextmanager
def trace_annotation(name: str) -> Iterator[None]:
    """Named region visible in the device trace (``record_function``: a
    CPU range that the trace ties to the kernels launched inside it)."""
    with torch.profiler.record_function(name):
        yield


@contextmanager
def capture_trace(log_dir: str) -> Iterator[object]:
    """Capture a host (+ device, when a card is present) trace of the
    scope into ``log_dir`` as a Chrome trace (``trace.json``; open with
    ``chrome://tracing`` or Perfetto).  Yields the profiler, whose
    ``events()`` and ``key_averages()`` the caller may read after the
    scope."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_fence(*objs) -> None:
    """Hard execution fence: walk ``objs`` (tensors, containers, model
    objects — ``__dict__`` and ``__slots__`` scanned a few levels, as the
    reference walks them) for torch tensors, and synchronize every CUDA
    device they lie on.  Host arrays and CPU tensors are already
    materialized; a fence over non-empty inputs that finds neither a
    tensor nor a host array warns, since it fenced nothing."""
    devices: set = set()
    seen = [False]  # a tensor or host array was found

    def visit(o, depth: int) -> None:
        if isinstance(o, torch.Tensor):
            seen[0] = True
            if o.is_cuda:
                devices.add(o.device)
        elif isinstance(o, np.ndarray):
            seen[0] = True
        elif depth <= 0 or o is None or isinstance(o, (str, bytes, int, float, bool)):
            return
        elif isinstance(o, (list, tuple, set)):
            for v in o:
                visit(v, depth - 1)
        elif isinstance(o, dict):
            for v in o.values():
                visit(v, depth - 1)
        elif hasattr(o, "__dict__"):
            for v in vars(o).values():
                visit(v, depth - 1)
        elif hasattr(type(o), "__slots__"):
            # walk the MRO: __slots__ may be a bare string, and each class
            # in the hierarchy declares only its own slots
            for klass in type(o).__mro__:
                s = klass.__dict__.get("__slots__", ())
                for name in (s,) if isinstance(s, str) else s:
                    visit(getattr(o, name, None), depth - 1)

    for o in objs:
        visit(o, 6)
    for dev in sorted(devices, key=str):
        torch.cuda.synchronize(dev)
    if not seen[0] and any(o is not None for o in objs):
        warnings.warn(
            "device_fence: no tensors found in "
            f"{[type(o).__name__ for o in objs]}; nothing was fenced",
            RuntimeWarning,
            stacklevel=2,
        )


def block_until_ready(tree):
    """Barrier helper so stage timings measure device work, not the
    launch: :func:`device_fence` on ``tree``, which is returned."""
    device_fence(tree)
    return tree


__all__ = [
    "StageClock", "block_until_ready", "capture_trace", "device_fence", "host_sync_census",
    "trace_annotation",
]
