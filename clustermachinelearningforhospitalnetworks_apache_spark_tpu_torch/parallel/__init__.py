"""Data placement over devices: the (data, model) mesh (``mesh.py``), the
multi-process runtime (``distributed.py``), the declarative partitioner
(``partitioner.py``), padded, weighted datasets on one device or sharded
over a mesh (``sharding.py``; the single-device ``DeviceDataset`` is kept
in ``data.py``), the ordered collectives (``collectives.py``), the
per-hospital placement (``federation.py``) and out-of-core row streaming
(``outofcore.py``)."""

from . import distributed
from .collectives import global_sum, tree_aggregate
from .federation import FederatedDataset, federated_dataset, place_hospitals
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshDevice,
    build_hybrid_mesh,
    build_mesh,
    default_mesh,
    set_default_mesh,
    single_device_mesh,
    use_mesh,
)
from .outofcore import HostDataset, add_stats, block_moments
from .sharding import (
    DeviceDataset,
    MeshArray,
    ShardedDataset,
    device_dataset,
    pad_rows,
    replicate,
    row_sharding,
    shard_rows,
    unpad,
)

__all__ = [
    "DATA_AXIS", "DeviceDataset", "FederatedDataset", "HostDataset", "MODEL_AXIS", "Mesh",
    "MeshArray", "MeshDevice", "ShardedDataset", "add_stats", "block_moments",
    "build_hybrid_mesh", "build_mesh", "default_mesh", "device_dataset", "distributed",
    "federated_dataset", "global_sum", "pad_rows", "place_hospitals", "replicate",
    "row_sharding", "set_default_mesh", "shard_rows", "single_device_mesh", "tree_aggregate",
    "unpad", "use_mesh",
]
