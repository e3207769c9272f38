"""Replica placement: an explicit replica→devices assignment object.

The fleet's analogue of RecML's ``Partitioner``: instead of every replica
implicitly landing wherever the default device points, placement is a
FIRST-CLASS object — ``assign(n_replicas, devices)`` returns one
:class:`ReplicaSlice` per replica, each naming exactly the devices that
replica serves on.  The :class:`~.replica_set.ReplicaSet` threads each
slice's primary device through ``InferenceServer(device=...)`` →
``ServingModel``, so the pinning is real (each replica's tensors and
kernel launches live on its primary), not advisory metadata.

Two built-in strategies:

* :class:`EvenPlacement` — contiguous even split of the device list;
  with fewer devices than replicas it round-robins single-device slices
  (oversubscription — one H100 behind four replicas, or the CPU test
  topology) and says so.
* :class:`PinnedPlacement` — an explicit ``{replica: (device_idx, ...)}``
  map for operators who need a replica on a specific slice (e.g. keeping
  a canary replica off the interactive-serving cards).

Pure host-side logic over an abstract device list — unit-testable with
any sequence, no device needed.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

from ...parallel.partitioner import partition_devices
from ...utils.logging import get_logger

log = get_logger("serve")


@dataclass(frozen=True)
class ReplicaSlice:
    """One replica's share of the devices: the devices it may use and the
    primary its serving model is built on."""

    replica_id: int
    devices: tuple

    @property
    def primary(self):
        return self.devices[0]

    def describe(self) -> dict:
        return {
            "replica_id": self.replica_id,
            "devices": [str(d) for d in self.devices],
        }


class Placement(abc.ABC):
    """Abstract replica→devices assignment (the RecML Partitioner shape:
    placement decided once, up front, as data — not scattered through
    the serving code)."""

    @abc.abstractmethod
    def assign(
        self, n_replicas: int, devices: Sequence[Any]
    ) -> tuple[ReplicaSlice, ...]:
        """Return one slice per replica over ``devices`` (ordered)."""

    def describe(self, n_replicas: int, devices: Sequence[Any]) -> list[dict]:
        return [s.describe() for s in self.assign(n_replicas, devices)]


class EvenPlacement(Placement):
    """Contiguous even split: ``len(devices) // n_replicas`` devices per
    replica (remainder spread over the first replicas).  More replicas
    than devices round-robins single-device slices — legitimate for four
    replicas on one card or on the CPU, logged so a production config
    cannot silently oversubscribe a device."""

    def assign(
        self, n_replicas: int, devices: Sequence[Any]
    ) -> tuple[ReplicaSlice, ...]:
        devs = tuple(devices)
        if devs and n_replicas > len(devs):
            log.warning(
                "replica oversubscription: round-robining devices",
                n_replicas=n_replicas, n_devices=len(devs),
            )
        return tuple(
            ReplicaSlice(i, slice_devs)
            for i, slice_devs in enumerate(
                partition_devices(devs, n_replicas)
            )
        )


class PinnedPlacement(Placement):
    """Explicit assignment: ``{replica_id: (device_index, ...)}``.
    Validates full coverage of the replica range and no device shared
    between replicas — a replica slice is a capacity claim, and two
    replicas claiming one device is a silent 2x oversubscription."""

    def __init__(self, assignment: Mapping[int, Sequence[int]]):
        self.assignment = {
            int(k): tuple(int(i) for i in v) for k, v in assignment.items()
        }

    def assign(
        self, n_replicas: int, devices: Sequence[Any]
    ) -> tuple[ReplicaSlice, ...]:
        devs = tuple(devices)
        missing = [i for i in range(n_replicas) if i not in self.assignment]
        if missing:
            raise ValueError(f"pinned placement missing replicas {missing}")
        seen: dict[int, int] = {}
        out = []
        for rid in range(n_replicas):
            idxs = self.assignment[rid]
            if not idxs:
                raise ValueError(f"replica {rid} pinned to zero devices")
            for di in idxs:
                if not 0 <= di < len(devs):
                    raise ValueError(
                        f"replica {rid}: device index {di} outside the "
                        f"{len(devs)}-device list"
                    )
                if di in seen:
                    raise ValueError(
                        f"device {di} pinned to both replica {seen[di]} "
                        f"and replica {rid}"
                    )
                seen[di] = rid
            out.append(ReplicaSlice(rid, tuple(devs[di] for di in idxs)))
        return tuple(out)
