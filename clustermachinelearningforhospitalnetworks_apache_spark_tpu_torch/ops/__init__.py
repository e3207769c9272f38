"""Hand-written CUDA kernels of the port and their plain PyTorch versions,
and the distance helpers (``distance.py``)."""

from . import lloyd, tree_hist
from .distance import assign_clusters, normalize_rows, pairwise_sqdist, sq_norms

__all__ = ["assign_clusters", "launch_counts", "lloyd", "normalize_rows", "pairwise_sqdist",
           "reset_launch_counts", "sq_norms", "tree_hist"]


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel: K1, K2 (``lloyd``) and K3
    (``tree_hist``)."""
    return {**lloyd.launch_counts(), **tree_hist.launch_counts()}


def reset_launch_counts() -> None:
    lloyd.reset_launch_counts()
    tree_hist.reset_launch_counts()
