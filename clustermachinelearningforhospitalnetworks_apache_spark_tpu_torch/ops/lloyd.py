"""K1 and K2: the Lloyd-step kernels, their wrappers and plain versions.

``fused_lloyd_stats`` (K1) is one pass of Lloyd sufficient statistics —
per-center weighted sums and counts plus the total weighted cost — and
``fused_assign`` (K2) is distance + argmin per row.  They replace the JAX
package's Pallas kernels of the same names (``ops/pallas_kernels.py``);
the CUDA source is ``csrc/lloyd.cu``.

A wrapper given tensors on the CPU runs the plain PyTorch version; given
CUDA tensors it launches the kernel or raises.  Each kernel launch adds
one to its module-level counter, so a run can show that its path went
through the kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ._build import load
from .distance import ASSIGN_CHUNK, pairwise_sqdist

#: matches the JAX package: invalid (padding) centers score this
BIG = 1e30

#: widest feature axis the kernels take (csrc/lloyd.cu padded_width)
MAX_FEATURES = 128

fused_lloyd_stats_launches = 0
fused_assign_launches = 0
_COUNT_LOCK = threading.Lock()  # serving threads launch K2 concurrently

_LIB = None


def launch_counts() -> dict[str, int]:
    return {
        "fused_lloyd_stats": fused_lloyd_stats_launches,
        "fused_assign": fused_assign_launches,
    }


def reset_launch_counts() -> None:
    global fused_lloyd_stats_launches, fused_assign_launches
    with _COUNT_LOCK:
        fused_lloyd_stats_launches = 0
        fused_assign_launches = 0


def _lib():
    global _LIB
    if _LIB is None:
        lib = load("lloyd")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.lloyd_num_blocks.argtypes = [ll, i, i, i, ctypes.POINTER(i)]
        lib.lloyd_num_blocks.restype = i
        lib.lloyd_stats_launch.argtypes = [p, p, p, p, ll, i, i, i, p, p, p]
        lib.lloyd_stats_launch.restype = i
        lib.lloyd_assign_launch.argtypes = [p, p, p, ll, i, i, i, p, p, p]
        lib.lloyd_assign_launch.restype = i
        lib.lloyd_error_string.argtypes = [i]
        lib.lloyd_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().lloyd_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _validate(x, centers, c_valid, w=None):
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError("x must be a 2-D torch.Tensor (n, d)")
    n, d = x.shape
    if not isinstance(centers, torch.Tensor) or centers.dim() != 2:
        raise ValueError("centers must be a 2-D torch.Tensor (k, d)")
    k = centers.shape[0]
    dev = x.device
    _check("x", x, (n, d), dev)
    _check("centers", centers, (k, d), dev)
    _check("c_valid", c_valid, (k,), dev)
    if w is not None:
        _check("w", w, (n,), dev)
    if k < 1:
        raise ValueError("need at least one center")
    if dev.type == "cuda" and not 1 <= d <= MAX_FEATURES:
        raise ValueError(
            f"the Lloyd kernels take 1..{MAX_FEATURES} features, got d={d}"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return n, d, k


# ------------------------------------------------------------------ plain
def fused_assign_plain(x, centers, c_valid):
    """Distance + argmin in torch ops, ``ASSIGN_CHUNK`` rows at a time:
    → (assign (n,) int32, min d² (n,))."""
    n = x.shape[0]
    assign = torch.empty((n,), dtype=torch.int32, device=x.device)
    mind2 = torch.empty((n,), dtype=torch.float32, device=x.device)
    c_sq = (centers * centers).sum(dim=1)
    valid = c_valid > 0
    for s in range(0, n, ASSIGN_CHUNK):
        d2 = pairwise_sqdist(x[s : s + ASSIGN_CHUNK], centers, c_sq=c_sq)
        d2 = torch.where(valid[None, :], d2, torch.full_like(d2, BIG))
        m, a = d2.min(dim=1)
        mind2[s : s + ASSIGN_CHUNK] = m
        assign[s : s + ASSIGN_CHUNK] = a.to(torch.int32)
    return assign, mind2


def fused_lloyd_stats_plain(x, w, centers, c_valid):
    """One Lloyd pass in torch ops: → (sums (k, d), counts (k,), cost ())."""
    n, d = x.shape
    k = centers.shape[0]
    sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    counts = torch.zeros((k,), dtype=torch.float32, device=x.device)
    if n == 0:
        return sums, counts, torch.zeros((), dtype=torch.float32, device=x.device)
    assign, mind2 = fused_assign_plain(x, centers, c_valid)
    idx = assign.to(torch.int64)
    sums.index_add_(0, idx, x * w[:, None])
    counts.index_add_(0, idx, w)
    return sums, counts, (mind2 * w).sum()


# ---------------------------------------------------------------- kernels
def fused_lloyd_stats(x, w, centers, c_valid):
    """K1: one fused Lloyd pass → (sums (k, d), counts (k,), cost ()).

    ``x`` (n, d) float32 rows with weights ``w`` (n,) (0 marks padding),
    ``centers`` (k, d), ``c_valid`` (k,) 1.0 for live centers; invalid
    centers score 1e30 and attract no row.  n == 0 returns zeros."""
    global fused_lloyd_stats_launches
    n, d, k = _validate(x, centers, c_valid, w)
    if x.device.type == "cpu":
        return fused_lloyd_stats_plain(x, w, centers, c_valid)
    if n == 0:
        z = torch.zeros((k * d + k + 1,), dtype=torch.float32, device=x.device)
        return z[: k * d].view(k, d), z[k * d : k * d + k], z[-1]
    lib = _lib()
    with torch.cuda.device(x.device):
        blocks = ctypes.c_int(0)
        _raise_on(lib.lloyd_num_blocks(n, d, k, 1, ctypes.byref(blocks)),
                  "fused_lloyd_stats grid query")
        P = k * d + k + 1
        partials = torch.empty((blocks.value * P,), dtype=torch.float32,
                               device=x.device)
        out = torch.empty((P,), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with _COUNT_LOCK:
            fused_lloyd_stats_launches += 1
        _raise_on(
            lib.lloyd_stats_launch(
                x.data_ptr(), w.data_ptr(), centers.data_ptr(),
                c_valid.data_ptr(), n, d, k, blocks.value,
                partials.data_ptr(), out.data_ptr(), stream,
            ),
            "fused_lloyd_stats launch",
        )
    return out[: k * d].view(k, d), out[k * d : k * d + k], out[-1]


def fused_assign(x, centers, c_valid):
    """K2: fused distance + argmin → (assign (n,) int32, min d² (n,))."""
    global fused_assign_launches
    n, d, k = _validate(x, centers, c_valid)
    if x.device.type == "cpu":
        return fused_assign_plain(x, centers, c_valid)
    assign = torch.empty((n,), dtype=torch.int32, device=x.device)
    mind2 = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return assign, mind2
    lib = _lib()
    with torch.cuda.device(x.device):
        blocks = ctypes.c_int(0)
        _raise_on(lib.lloyd_num_blocks(n, d, k, 0, ctypes.byref(blocks)),
                  "fused_assign grid query")
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with _COUNT_LOCK:
            fused_assign_launches += 1
        _raise_on(
            lib.lloyd_assign_launch(
                x.data_ptr(), centers.data_ptr(), c_valid.data_ptr(), n, d, k,
                blocks.value, assign.data_ptr(), mind2.data_ptr(), stream,
            ),
            "fused_assign launch",
        )
    return assign, mind2
