"""Device meshes: a named (data, model) grid of devices.

The JAX package's ``parallel/mesh.py`` builds a ``jax.sharding.Mesh``; the
port's :class:`Mesh` is its own, with no JAX mesh behind it.  It holds a
(data, model) object array of :class:`MeshDevice` entries, each naming the
process that owns the shard and the local ``torch.device`` it lives on.
Rows lay out over ``data`` (Spark's executor data parallelism) and KMeans'
centers over ``model``; where XLA would emit a ``psum`` the port sums the
shards' statistics in ascending data-shard order (``collectives.py``).

One deviation from the reference (ROADMAP "Decided"): a port mesh may
repeat a device.  torch has one CPU device and a machine may hold one
card, so a CPU test mesh is ``[torch.device("cpu")] * 8`` and an on-card
virtual mesh ``[cuda:0] * 4``; each entry is still a shard of its own, with
its own rows and its own kernel launches.

``build_mesh()`` / ``default_mesh()`` with no devices span every CUDA
device (every process's, once ``distributed.initialize`` has run) and raise
without a card; the CPU is used only when the caller passes CPU devices.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Iterator, Sequence

import numpy as np
import torch

from ..config import MeshConfig
from ..device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class MeshDevice:
    """One mesh entry: the local ``device`` of the process
    ``process_index`` that owns the shard."""

    device: torch.device
    process_index: int = 0

    def __str__(self) -> str:
        return f"{self.device}@{self.process_index}"


def _this_process() -> int:
    from . import distributed

    ctx = distributed.current()
    return ctx.process_id if ctx is not None else 0


def _entry(d: Any, process: int) -> MeshDevice:
    if isinstance(d, MeshDevice):
        return d
    return MeshDevice(torch.device(d), process)


class Mesh:
    """A (data, model) array of :class:`MeshDevice` entries.

    ``shape`` is a dict keyed by axis name (as JAX's ``Mesh.shape``),
    ``size`` the number of entries and ``devices`` the object array.
    Two meshes are equal when their entries and axis names are."""

    def __init__(self, devices: Any, axis_names: tuple[str, str] = (DATA_AXIS, MODEL_AXIS)):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != 2:
            raise ValueError(f"a mesh is a 2-D (data, model) array; got shape {arr.shape}")
        me = _this_process()
        out = np.empty(arr.shape, dtype=object)
        for ij in np.ndindex(arr.shape):
            out[ij] = _entry(arr[ij], me)
        self.devices = out
        self.axis_names = tuple(axis_names)
        self._key = (tuple(out.flat), out.shape, self.axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, i: int, j: int = 0) -> torch.device:
        """The local device of entry (i, j)."""
        return self.devices[i, j].device

    def process(self, i: int, j: int = 0) -> int:
        """The process that owns entry (i, j)."""
        return self.devices[i, j].process_index

    def is_local(self, i: int, j: int = 0) -> bool:
        return self.devices[i, j].process_index == _this_process()

    def local_data_shards(self) -> list[int]:
        """The data-shard indices this process owns, ascending (its model
        entries live in the same process: see :func:`check_model_local`)."""
        return [i for i in range(self.devices.shape[0]) if self.is_local(i, 0)]

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(e) for e in self.devices.flat]})"


def check_model_local(mesh: Mesh) -> None:
    """Every data shard's model entries must live in one process (the
    hybrid mesh lays the model axis out inside a host): the owner of a row
    is resolved across the model axis without a collective."""
    for i in range(mesh.devices.shape[0]):
        if len({mesh.process(i, j) for j in range(mesh.devices.shape[1])}) != 1:
            raise ValueError(
                f"data shard {i} of {mesh} spreads its model axis over processes; "
                "lay the model axis out inside a process (build_hybrid_mesh does)"
            )


@dataclass(frozen=True)
class NamedSharding:
    """A placement descriptor: ``spec`` (one mesh-axis name or ``None`` a
    dimension, as a JAX ``PartitionSpec`` reads) over ``mesh``."""

    mesh: Mesh
    spec: tuple


def _all_devices() -> list:
    """Every device of the job: each process's, process-major, once
    ``distributed.initialize`` has made a process group; else every local
    CUDA device (raises without a card)."""
    from . import distributed

    ctx = distributed.current()
    if ctx is not None and ctx.backend is not None:
        return list(ctx.devices)
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def build_mesh(cfg: MeshConfig | None = None, devices: Sequence[Any] | None = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (default every CUDA device;
    entries may repeat a device).  ``data=-1`` takes every device the model
    axis leaves; a device count the model axis does not divide raises."""
    cfg = cfg or MeshConfig()
    devs = list(devices if devices is not None else _all_devices())
    model = max(1, cfg.model)
    if len(devs) % model != 0:
        raise ValueError(f"{len(devs)} devices not divisible by model={model}")
    data = cfg.data if cfg.data > 0 else len(devs) // model
    if data * model > len(devs):
        raise ValueError(
            f"a (data={data}, model={model}) mesh needs {data * model} devices; "
            f"got {len(devs)}"
        )
    arr = np.empty((data, model), dtype=object)
    for ij, d in zip(np.ndindex(data, model), devs[: data * model]):
        arr[ij] = d
    return Mesh(arr)


def build_hybrid_mesh(dcn_hosts: int, model: int = 1,
                      devices: Sequence[Any] | None = None) -> Mesh:
    """A mesh whose data axis is host-major: each host's (process's)
    devices are contiguous on the data axis and its model axis stays
    inside the host, so only the ordered gather of the statistics crosses
    hosts.  ``devices`` defaults to every device of the job
    (:func:`build_mesh`'s); with fewer processes than ``dcn_hosts`` the
    host-major order is emulated by grouping the flat device list, as the
    reference does."""
    from . import distributed

    devs = list(devices if devices is not None else _all_devices())
    entries = [_entry(d, _this_process()) for d in devs]
    # process-major (stable): a gathered device list already is
    entries.sort(key=lambda e: e.process_index)
    n = len(entries)
    per_host = n // dcn_hosts if dcn_hosts > 0 else 0
    if per_host < 1 or per_host % model != 0:
        raise ValueError(f"{n} devices cannot split into {dcn_hosts} hosts × model={model}")
    ctx = distributed.current()
    n_proc = ctx.num_processes if ctx is not None else 1
    if 1 < n_proc != dcn_hosts:
        import warnings

        warnings.warn(
            f"build_hybrid_mesh(dcn_hosts={dcn_hosts}) does not match "
            f"num_processes={n_proc}; laying the devices out in flat order",
            stacklevel=2,
        )
    rows = dcn_hosts * (per_host // model)
    arr = np.empty((rows, model), dtype=object)
    for ij, e in zip(np.ndindex(rows, model), entries[: dcn_hosts * per_host]):
        arr[ij] = e
    return Mesh(arr)


def single_device_mesh(device=None) -> Mesh:
    """A (1, 1) mesh over ``device`` (default the card; raises without one)."""
    if not isinstance(device, MeshDevice):
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    arr = np.empty((1, 1), dtype=object)
    arr[0, 0] = device
    return Mesh(arr)


_DEFAULT_MESH: Mesh | None = None


def default_mesh() -> Mesh:
    """The process-wide default mesh, built over every device at first use
    (raises without a card)."""
    global _DEFAULT_MESH
    if _DEFAULT_MESH is None:
        _DEFAULT_MESH = build_mesh()
    return _DEFAULT_MESH


def set_default_mesh(mesh: Mesh | None) -> None:
    global _DEFAULT_MESH
    _DEFAULT_MESH = mesh


@contextmanager
def use_mesh(mesh: Mesh) -> Iterator[Mesh]:
    """``mesh`` as the default inside the block, the previous one after."""
    global _DEFAULT_MESH
    prev = _DEFAULT_MESH
    _DEFAULT_MESH = mesh
    try:
        yield mesh
    finally:
        _DEFAULT_MESH = prev


def data_axis_size(mesh: Mesh) -> int:
    return mesh.shape[DATA_AXIS]


def model_axis_size(mesh: Mesh) -> int:
    return mesh.shape[MODEL_AXIS]
