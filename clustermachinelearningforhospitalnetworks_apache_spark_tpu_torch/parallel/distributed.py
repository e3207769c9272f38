"""Multi-process runtime bootstrap (the JAX package's
``parallel/distributed.py``).

The reference's control plane is Spark's driver-executor RPC, stood up by
pointing the session at a cluster master; the JAX package's is
``jax.distributed.initialize``.  The port's is a ``torch.distributed``
process group: every process runs the same program (SPMD), owns the mesh
entries of its own devices, and takes part in every collective of a fit
(``collectives.py``).

:func:`initialize` is idempotent.  With no coordinator and at most one
process it only records the context, as the reference does.  Otherwise it
calls ``torch.distributed.init_process_group`` against the coordinator:
``tcp://`` from ``COORDINATOR_ADDRESS`` or the argument, or a ``file://``
store when the caller passes one.  The backend defaults to ``"nccl"`` when
the process's device is a card and ``"gloo"`` on the CPU; the caller may
name either.  No backend is switched silently: NCCL refuses two ranks on
one card ("Duplicate GPU detected"), and that error surfaces here, so
ranks that share a card name ``backend="gloo"``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any

import torch

from ..device import resolve_device


@dataclass(frozen=True)
class DistributedContext:
    process_id: int
    num_processes: int
    local_devices: int
    global_devices: int
    #: the process group's backend, or None when no group was made
    backend: str | None = None
    #: every process's devices as mesh entries, process-major
    devices: tuple = field(default=(), repr=False)

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


_CTX: DistributedContext | None = None
_CLUSTER_MESH = None


def _local_devices(device: Any, multi: bool, process_id: int) -> list[torch.device]:
    """This process's devices: ``device`` (one, or a sequence that may
    repeat a device), else one card a process in a group (``cuda:rank %
    cards``, raising without one), else every local card or the CPU."""
    if device is not None:
        devs = list(device) if isinstance(device, (list, tuple)) else [device]
        return [resolve_device(d) for d in devs]
    if multi:
        resolve_device("cuda")
        return [torch.device("cuda", process_id % torch.cuda.device_count())]
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _init_method(address: str) -> str:
    return address if address.startswith(("tcp://", "file://", "env://")) else f"tcp://{address}"


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device: Any = None,
) -> DistributedContext:
    """Initialize the multi-process runtime (idempotent).  ``device`` is
    this process's device or devices (its mesh entries)."""
    global _CTX
    if _CTX is not None:
        return _CTX
    from .mesh import MeshDevice

    explicit = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    multi = explicit is not None or (num_processes or 0) > 1
    if not multi:
        devs = _local_devices(device, False, 0)
        _CTX = DistributedContext(
            process_id=0, num_processes=1, local_devices=len(devs),
            global_devices=len(devs), devices=tuple(MeshDevice(d, 0) for d in devs),
        )
        return _CTX
    if explicit is None:
        raise ValueError("num_processes > 1 needs a coordinator_address")
    world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    devs = _local_devices(device, True, rank)
    backend = backend or ("nccl" if devs[0].type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if devs[0].type == "cuda":
        torch.cuda.set_device(devs[0])
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=_init_method(explicit),
                            world_size=world, rank=rank)
    lists: list = [None] * world
    dist.all_gather_object(lists, [str(d) for d in devs])
    everyone = tuple(MeshDevice(torch.device(s), p) for p, lst in enumerate(lists) for s in lst)
    _CTX = DistributedContext(
        process_id=rank, num_processes=world, local_devices=len(devs),
        global_devices=len(everyone), backend=backend, devices=everyone,
    )
    return _CTX


def current() -> DistributedContext | None:
    """The context :func:`initialize` recorded, or None before it ran."""
    return _CTX


def context() -> DistributedContext:
    return _CTX or initialize()


def is_coordinator() -> bool:
    return context().is_coordinator


def group_active() -> bool:
    """True once :func:`initialize` has made a process group: every
    collective of a fit then goes through it (SPMD, every rank calls)."""
    return _CTX is not None and _CTX.backend is not None


def transport_device() -> torch.device:
    """Where a collective's tensors must lie: the CPU under gloo, the
    process's card under NCCL."""
    if _CTX is not None and _CTX.backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shutdown() -> None:
    """Destroy the process group (if any) and forget the context, so a
    process may initialize again."""
    global _CTX, _CLUSTER_MESH
    if group_active():
        import torch.distributed as dist

        dist.destroy_process_group()
    _CTX = None
    _CLUSTER_MESH = None


def cluster_mesh():
    """The host-major mesh over every process's devices once a
    multi-process runtime is initialized, or ``None`` in one process — the
    mesh the partitioner's ``active_mesh()`` resolves against.  Cached:
    mesh identity keys the partitioner's resolution cache."""
    global _CLUSTER_MESH
    if _CTX is None or _CTX.num_processes <= 1:
        return None
    if _CLUSTER_MESH is None:
        from .mesh import build_hybrid_mesh

        _CLUSTER_MESH = build_hybrid_mesh(_CTX.num_processes, devices=_CTX.devices)
    return _CLUSTER_MESH
