"""Device choice and float32 precision for the port.

Every entry point takes ``device=`` and defaults to ``"cuda"``: the port
runs on the card, and a machine without one raises instead of quietly
running on the CPU.  The CPU is used only when the caller names it (the
tests do).

The JAX package runs every product at ``Precision.HIGHEST``
(``ops/distance.py``, ``ops/pallas_kernels.py``), so TF32 stays off here:
it keeps about three decimal digits and flips near-tied argmins.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``device`` (None → ``"cuda"``) as a ``torch.device``; raises when
    it names CUDA and no card is present."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
