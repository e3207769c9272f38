"""Quantile binning for histogram trees (the JAX package's
``models/tree/binning.py``).

Thresholds come from a host sample in numpy float64 (copied unchanged, so
both packages bin alike); rows are digitized once, on the device, and
every tree level then reads only the int32 bin matrix.
"""

from __future__ import annotations

import numpy as np
import torch


def quantile_thresholds(sample: np.ndarray, max_bins: int) -> np.ndarray:
    """(d, max_bins-1) split thresholds per feature.

    Bin b holds values in (thr[b-1], thr[b]]; going right means
    ``value > thr[split_bin]``.  Duplicate quantiles (low-cardinality
    features) are padded with +inf so the extra bins are never populated.
    """
    n, d = sample.shape
    out = np.full((d, max_bins - 1), np.inf, dtype=np.float64)
    qs = np.linspace(0, 1, max_bins + 1)[1:-1]
    for f in range(d):
        t = np.unique(np.quantile(sample[:, f], qs))
        out[f, : t.size] = t
    return out


def digitize(x: torch.Tensor, thresholds) -> torch.Tensor:
    """(n, d) features → (n, d) int32 bin ids in [0, max_bins): the count
    of float32 thresholds strictly below each float32 value (ties go
    left).  The thresholds are cast to float32 first, as the JAX package
    does.  One threshold at a time, so no (n, d, B-1) temporary is made;
    the count is exact in any order."""
    x = x.to(torch.float32)
    thr = torch.as_tensor(np.asarray(thresholds, dtype=np.float32), device=x.device)
    out = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for j in range(thr.shape[1]):
        out += (x > thr[:, j]).to(torch.int32)
    return out
