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
import functools
import threading

import torch

from ._build import load
from .distance import ASSIGN_CHUNK, pairwise_sqdist
from .tree_hist import _sm_count

#: matches the JAX package: invalid (padding) centers score this
BIG = 1e30

#: widest feature axis the kernels take (csrc/lloyd.cu padded_width)
MAX_FEATURES = 128

#: rows per tile == threads per block (``kThreads`` in csrc/lloyd.cu)
THREADS = 256

#: K1's center tile stays within this many bytes, as K2's does
SMEM_BUDGET = 48 * 1024

#: dynamic shared memory one block may opt into on an H100 (227 KB)
SMEM_OPTIN = 232_448

#: shared memory of one SM; each resident block also reserves 1 KB
SM_SMEM = 233_472

#: K1's words beside the centers (``kStatsWords``): sorted keys, weights,
#: the cost reduce, segment heads and per-warp counts
STATS_BYTES = 4 * (4 * THREADS + 1 + 2 * (THREADS // 32))

#: K1 sorts keys (cluster << 8 | row) in 32 bits (``kMaxCenters``)
MAX_CENTERS = (1 << 24) - 1

#: cap on K1's partial buffer (blocks · (k·d + k + 1) floats)
MAX_PARTIAL_BYTES = 256 << 20

#: K2's rows a thread (R) that the kernel takes at each padded width, up to
#: the most that ptxas keeps in registers without spills at two blocks an SM
#: (``assign_rows_max`` in csrc/lloyd.cu)
ASSIGN_ROWS_MAX = {4: 4, 8: 4, 16: 4, 32: 2, 64: 1, 128: 1}

fused_lloyd_stats_launches = 0
fused_assign_launches = 0
_COUNT_LOCK = threading.Lock()  # serving threads launch K2 concurrently

_LIB = None
_OCCUPANCY: dict[tuple[int, int, int], int] = {}
_ASSIGN_OCCUPANCY: dict[tuple[int, int, int, int], int] = {}


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
        lib.lloyd_assign_occupancy.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.lloyd_assign_occupancy.restype = i
        lib.lloyd_stats_occupancy.argtypes = [i, i, ctypes.POINTER(i)]
        lib.lloyd_stats_occupancy.restype = i
        lib.lloyd_stats_launch.argtypes = [p, p, p, p, ll, i, i, i, i, i, i, p, p, p]
        lib.lloyd_stats_launch.restype = i
        lib.lloyd_assign_launch.argtypes = [p, p, p, ll, i, i, i, i, i, p, p, p]
        lib.lloyd_assign_launch.restype = i
        lib.lloyd_error_string.argtypes = [i]
        lib.lloyd_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().lloyd_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def _padded_width(d: int) -> int:
    """The kernels' padded feature width: the next of 4, 8, 16, 32, 64, 128."""
    if not 1 <= d <= MAX_FEATURES:
        raise ValueError(f"the Lloyd kernels take 1..{MAX_FEATURES} features, got d={d}")
    return next(dp for dp in (4, 8, 16, 32, 64, 128) if d <= dp)


def _stats_geometry(d: int, k: int) -> dict:
    """K1's shared-memory layout for one (d, k): padded width, center tile,
    the accumulators' home and the shared bytes."""
    if not 1 <= k <= MAX_CENTERS:
        raise ValueError(f"fused_lloyd_stats takes 1..{MAX_CENTERS} centers, got k={k}")
    dp = _padded_width(d)
    per_center = (dp + 2) * 4
    avail = SMEM_BUDGET - STATS_BYTES
    kt = k if k * per_center <= avail else avail // per_center // 32 * 32
    distance = kt * per_center + STATS_BYTES
    acc = (k * d + k) * 4
    acc_smem = distance + acc <= SMEM_OPTIN
    return {"dp": dp, "kt": kt, "n_ctiles": -(-k // kt), "acc_smem": acc_smem,
            "smem": distance + (acc if acc_smem else 0)}


def lloyd_plan(n: int, d: int, k: int, sms: int, per_sm: int | None = None) -> dict:
    """Launch plan for one K1 call — a pure function of the shapes, the
    card's SM count and ``per_sm``, the K1 blocks resident on one SM at
    the plan's shared bytes (the wrapper asks the CUDA occupancy API; by
    default it is estimated from shared memory and threads alone).

    The distance loop keeps its center tile (all k centers, or tiles of a
    multiple of 32) within ``SMEM_BUDGET``, as K2 does.  The per-cluster
    accumulators, k·(d+1) floats, go to shared memory exactly when they
    fit beside it under ``SMEM_OPTIN``; else each block keeps them in its
    own partial.  The grid is one wave of resident blocks, no more blocks
    than row tiles, with the partial buffer under ``MAX_PARTIAL_BYTES``.
    → dp, kt, n_ctiles, acc_smem, smem, blocks, partial_floats."""
    plan = _stats_geometry(d, k)
    if per_sm is None:
        per_sm = min(2048 // THREADS, SM_SMEM // (plan["smem"] + 1024))
    P = k * d + k + 1
    tiles = -(-n // THREADS)
    blocks = max(1, min(tiles, sms * max(per_sm, 1), MAX_PARTIAL_BYTES // (4 * P)))
    plan.update(blocks=blocks, partial_floats=blocks * P)
    return plan


def _assign_geometry(d: int, k: int) -> dict:
    """K2's shared-memory layout for one (d, k) (``plan`` in csrc/lloyd.cu):
    padded width, and all k centers or tiles of a multiple of 32 of them in
    ``SMEM_BUDGET``, each with its |c|² and validity."""
    if k < 1:
        raise ValueError(f"fused_assign takes at least one center, got k={k}")
    dp = _padded_width(d)
    per_center = (dp + 2) * 4
    kt = k if k * per_center <= SMEM_BUDGET else SMEM_BUDGET // per_center // 32 * 32
    return {"dp": dp, "kt": kt, "n_ctiles": -(-k // kt), "smem": kt * per_center}


def assign_rows_per_thread(n: int, d: int, sms: int) -> int:
    """K2's rows a thread for n rows: the largest R the kernel takes at this
    width (``ASSIGN_ROWS_MAX``) for which the launch still has a tile of
    ``THREADS`` · R rows for every SM, else 1 — so a small request keeps
    the one-row-a-thread loop and its latency."""
    top = ASSIGN_ROWS_MAX[_padded_width(d)]
    return next((r for r in (4, 2) if r <= top and -(-n // (THREADS * r)) >= sms), 1)


def assign_plan(n: int, d: int, k: int, sms: int, per_sm: int | None = None,
                rows_per_thread: int | None = None) -> dict:
    """Launch plan for one K2 call — a pure function of the shapes, the
    card's SM count and ``per_sm``, the K2 blocks resident on one SM at
    the plan's rows a thread and shared bytes (the wrapper asks the CUDA
    occupancy API once per device, width, R and shared bytes; by default
    it is estimated from shared memory and threads alone).

    The center tile is ``_assign_geometry``'s.  R is
    ``assign_rows_per_thread``'s unless ``rows_per_thread`` forces it (it
    must be one the kernel takes at this width); the grid is one wave of
    resident blocks, no more blocks than tiles of ``THREADS`` · R rows.
    K2's output does not depend on the plan.
    → dp, kt, n_ctiles, rows_per_thread, blocks, smem."""
    plan = _assign_geometry(d, k)
    R = assign_rows_per_thread(n, d, sms) if rows_per_thread is None else rows_per_thread
    if R not in (1, 2, 4) or R > ASSIGN_ROWS_MAX[plan["dp"]]:
        raise ValueError(f"fused_assign takes 1..{ASSIGN_ROWS_MAX[plan['dp']]} rows a "
                         f"thread (1, 2 or 4) at d={d}, got {R}")
    if per_sm is None:
        per_sm = min(2048 // THREADS, SM_SMEM // (plan["smem"] + 1024))
    tiles = -(-n // (THREADS * R))
    plan.update(rows_per_thread=R, blocks=max(1, min(tiles, sms * max(per_sm, 1))))
    return plan


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
    with torch.cuda.device(x.device):
        plan = lloyd_plan(n, d, k, _sm_count(x.device), _stats_occupancy(x.device, d, k))
        P = k * d + k + 1
        partials = torch.empty((plan["partial_floats"],), dtype=torch.float32,
                               device=x.device)
        out = torch.empty((P,), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with _COUNT_LOCK:
            fused_lloyd_stats_launches += 1
        _raise_on(
            _lib().lloyd_stats_launch(
                x.data_ptr(), w.data_ptr(), centers.data_ptr(),
                c_valid.data_ptr(), n, d, k, plan["kt"], int(plan["acc_smem"]),
                plan["smem"], plan["blocks"], partials.data_ptr(), out.data_ptr(),
                stream,
            ),
            "fused_lloyd_stats launch",
        )
    return out[: k * d].view(k, d), out[k * d : k * d + k], out[-1]


def _stats_occupancy(dev: torch.device, d: int, k: int) -> int:
    """K1 blocks resident on one SM at the plan's shared bytes (CUDA
    occupancy API, cached per device and layout)."""
    geo = _stats_geometry(d, k)
    key = (dev.index if dev.index is not None else torch.cuda.current_device(),
           geo["dp"], geo["smem"])
    if key not in _OCCUPANCY:
        per_sm = ctypes.c_int(0)
        _raise_on(_lib().lloyd_stats_occupancy(d, geo["smem"], ctypes.byref(per_sm)),
                  "fused_lloyd_stats occupancy query")
        _OCCUPANCY[key] = per_sm.value
    return _OCCUPANCY[key]


def _assign_occupancy(idx: int, d: int, k: int, rows: int) -> int:
    """K2 blocks resident on one SM of card ``idx`` at ``rows`` a thread
    and the layout's shared bytes (CUDA occupancy API, cached per card,
    width, rows and shared bytes)."""
    geo = _assign_geometry(d, k)
    key = (idx, geo["dp"], rows, geo["smem"])
    if key not in _ASSIGN_OCCUPANCY:
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(idx):
            _raise_on(_lib().lloyd_assign_occupancy(d, rows, geo["smem"],
                                                    ctypes.byref(per_sm)),
                      "fused_assign occupancy query")
        _ASSIGN_OCCUPANCY[key] = per_sm.value
    return _ASSIGN_OCCUPANCY[key]


@functools.lru_cache(maxsize=4096)
def _own_assign_plan(idx: int, n: int, d: int, k: int) -> dict:
    """``fused_assign``'s plan on card ``idx``, made once per shape: a
    served batch or a scoring chunk repeats its shape, and K2's host path
    is most of a small launch's time."""
    sms = _sm_count(torch.device("cuda", idx))
    R = assign_rows_per_thread(n, d, sms)
    return assign_plan(n, d, k, sms, _assign_occupancy(idx, d, k, R), R)


def fused_assign(x, centers, c_valid):
    """K2: fused distance + argmin → (assign (n,) int32, min d² (n,))."""
    n, d, k = _validate(x, centers, c_valid)
    if x.device.type == "cpu":
        return fused_assign_plain(x, centers, c_valid)
    return _launch_assign(x, centers, c_valid, n, d, k,
                          _own_assign_plan(x.device.index, n, d, k))


def fused_assign_planned(x, centers, c_valid, plan: dict):
    """K2 with a given ``assign_plan`` (a caller may force its rows a
    thread, as ``chip_smoke.py`` does to hold the plans to each other).
    On CPU tensors it runs the plain version; on CUDA tensors it launches
    the kernel or raises, and counts the launch."""
    n, d, k = _validate(x, centers, c_valid)
    if x.device.type == "cpu":
        return fused_assign_plain(x, centers, c_valid)
    return _launch_assign(x, centers, c_valid, n, d, k, plan)


def _launch_assign(x, centers, c_valid, n: int, d: int, k: int, plan: dict):
    global fused_assign_launches
    assign = torch.empty((n,), dtype=torch.int32, device=x.device)
    mind2 = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return assign, mind2
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with _COUNT_LOCK:
            fused_assign_launches += 1
        _raise_on(
            _lib().lloyd_assign_launch(
                x.data_ptr(), centers.data_ptr(), c_valid.data_ptr(), n, d, k,
                plan["rows_per_thread"], plan["smem"], plan["blocks"],
                assign.data_ptr(), mind2.data_ptr(), stream,
            ),
            "fused_assign launch",
        )
    return assign, mind2
