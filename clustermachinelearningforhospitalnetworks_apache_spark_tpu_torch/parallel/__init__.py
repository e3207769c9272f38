"""Data placement for the port's single device: the padded, weighted
``DeviceDataset`` (kept in ``data.py``, where the JAX package has
``parallel/sharding.py``) and out-of-core row streaming
(``outofcore.py``)."""

from ..data import DeviceDataset, device_dataset, unpad
from .outofcore import HostDataset, add_stats, block_moments

__all__ = ["DeviceDataset", "HostDataset", "add_stats", "block_moments", "device_dataset",
           "unpad"]
