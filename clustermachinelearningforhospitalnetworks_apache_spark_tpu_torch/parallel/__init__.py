"""Data placement for the port's single device: out-of-core row streaming
(``outofcore.py``)."""

from .outofcore import HostDataset, add_stats, block_moments

__all__ = ["HostDataset", "add_stats", "block_moments"]
