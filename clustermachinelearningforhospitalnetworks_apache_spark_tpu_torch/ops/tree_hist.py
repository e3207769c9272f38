"""K3: the level-histogram kernel, its wrapper and plain version.

``fused_level_hist`` computes, for every tree t, frontier node p, feature
f, bin b and stat s, ``hist[t,p,f,b,s] = Σ_rows [pos_t=p]·w_t·base_s·
[binned_f=b]`` — the per-level split histograms of the tree engine.  It
replaces the JAX package's Pallas kernel of the same name
(``ops/pallas_kernels.py``) and the XLA scan in
``models/tree/engine.py::_make_level_hist``; the CUDA source is
``csrc/tree_hist.cu``.

A wrapper given tensors on the CPU runs the plain PyTorch version; given
CUDA tensors it launches the kernel or raises.  Each call that launches
the kernel adds one to the module-level counter.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ._build import load

#: rows per chunk of the plain version's one-hot contraction (the JAX
#: scan's ``_HIST_CHUNK``)
HIST_CHUNK = 8192

#: dynamic shared memory a K3 block may take: two blocks fit one SM's
#: 228 KB (each block also reserves 1 KB)
SMEM_BUDGET = 112 * 1024

#: a block takes more trees only while their output tiles fit this many
#: bytes: several small tiles share one staged row tile cheaply, but large
#: ones cost resident blocks and gain little (on an H100, PERF.md: at the
#: classifier's 16 KB tiles one tree a block ran fastest, at rf20's 3 KB
#: root tiles ten)
TREE_TILES_BUDGET = SMEM_BUDGET // 4

#: shared memory of one SM, for the default resident-block estimate
SM_SMEM = 228 * 1024

#: a row block of more rows than this accumulates too many float32 adds
#: into one bin; the grid grows so that each block takes at most this many
MAX_ROWS_PER_BLOCK = 65536

#: cap on the partial buffer (T · row blocks · LN·d·B·S floats)
MAX_PARTIAL_BYTES = 256 << 20

#: warps of a block (``kMaxThreads`` / 32 in csrc/tree_hist.cu)
MAX_WARPS = 16

#: rows a block stages in shared memory at once (``kTile`` in
#: csrc/tree_hist.cu): four 32-row steps of the grouping
ROW_TILE = 128

#: row tiles a block keeps in shared memory: one being grouped while the
#: next one lands
RING = 2

fused_level_hist_launches = 0
_COUNT_LOCK = threading.Lock()

_LIB = None
_SMS: dict[int, int] = {}
_OCCUPANCY: dict[tuple[int, int, int, int], int] = {}


def launch_counts() -> dict[str, int]:
    return {"fused_level_hist": fused_level_hist_launches}


def reset_launch_counts() -> None:
    global fused_level_hist_launches
    with _COUNT_LOCK:
        fused_level_hist_launches = 0


def _lib():
    global _LIB
    if _LIB is None:
        lib = load("tree_hist")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.tree_hist_launch.argtypes = [
            p, p, p, p, ll, i, i, i, i, i, i, i, i, i, i, i, i, ll, i, p, p, p,
        ]
        lib.tree_hist_launch.restype = i
        lib.tree_hist_occupancy.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.tree_hist_occupancy.restype = i
        lib.tree_hist_error_string.argtypes = [i]
        lib.tree_hist_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def stat_pad(S: int) -> int:
    """Floats a row's w·base values take in shared memory, so that one
    vector load reads them (``stat_pad`` in csrc/tree_hist.cu)."""
    return 4 if S == 3 else S


def smem_bytes(dt: int, S: int, B: int, LNt: int, TB: int) -> int:
    """Shared bytes of a K3 block: ``RING`` staged tiles of ``ROW_TILE``
    rows (dt bins, S base rows, pos and w of TB trees), ``RING`` − 1 tiles
    of the w·base products of TB trees, and TB output tiles of LNt·dt·B·S
    floats (``stage_words`` in csrc/tree_hist.cu)."""
    return 4 * (ROW_TILE * (RING * (dt + S + 2 * TB) + (RING - 1) * TB * stat_pad(S))
                + TB * LNt * dt * B * S)


def _geometry(d: int, S: int, B: int, LN: int, T: int) -> dict:
    """Tiles, trees a block and warps for one K3 shape: all LN nodes of a
    tree when they fit ``SMEM_BUDGET`` beside one tree's staging, else
    node tiles, else one node and feature tiles; then as many trees a
    block (TB) as fit beside them with their tiles within
    ``TREE_TILES_BUDGET``, spread evenly over ceil(T / TB) groups."""
    dt = d
    LNt = min(LN, (SMEM_BUDGET - smem_bytes(d, S, B, 0, 1)) // (4 * d * B * S))
    if LNt < 1:
        LNt = 1
        dt = (SMEM_BUDGET - smem_bytes(0, S, B, 0, 1)) // (4 * (B * S + RING * ROW_TILE))
        if dt < 1:
            raise ValueError(
                f"fused_level_hist: one bin row of B={B} bins x S={S} stats "
                f"does not fit {SMEM_BUDGET} bytes of shared memory"
            )
    TB = 1
    while (TB < T and smem_bytes(dt, S, B, LNt, TB + 1) <= SMEM_BUDGET
           and 4 * (TB + 1) * LNt * dt * B * S <= TREE_TILES_BUDGET):
        TB += 1
    n_tgroups = -(-T // TB)
    TB = -(-T // n_tgroups)
    # the fewest warps that take the TB·dt (tree, feature) pairs in the
    # fewest rounds, so no warp waits at a tile's barrier for a round more
    rounds = -(-TB * dt // MAX_WARPS)
    return {"LNt": LNt, "dt": dt, "TB": TB, "n_tgroups": n_tgroups,
            "n_ptiles": -(-LN // LNt), "n_ftiles": -(-d // dt),
            "warps": -(-TB * dt // rounds), "smem": smem_bytes(dt, S, B, LNt, TB)}


def hist_plan(n: int, d: int, S: int, B: int, LN: int, T: int, sms: int,
              per_sm: int | None = None, rows_per_block: int | None = None) -> dict:
    """Launch geometry for one K3 call — a pure function of the shapes,
    the card's SM count and ``per_sm``, the K3 blocks resident on one SM
    at the plan's warps and shared bytes (the wrapper asks the CUDA
    occupancy API; by default it is estimated from threads, registers
    and shared memory), so two calls on one card launch alike.

    Tiles and trees a block come from ``_geometry``.  The grid is tree
    groups × row blocks × tiles; the row blocks per tree fill the fewest
    whole waves of ``sms · per_sm`` resident blocks that give no block
    more than ``MAX_ROWS_PER_BLOCK`` rows, never spilling into another
    wave, and keep the partial buffer under ``MAX_PARTIAL_BYTES``.
    ``rows_per_block`` (a multiple of 32) forces the row partition
    instead.  → LNt, dt, TB, n_tgroups, n_ptiles, n_ftiles, warps,
    blocks_x, rows_per_block, smem, per_sm, waves."""
    plan = _geometry(d, S, B, LN, T)
    if per_sm is None:
        threads = plan["warps"] * 32
        per_sm = min(2048 // threads, 65536 // (64 * threads),
                     SM_SMEM // (plan["smem"] + 1024))
    wave = sms * max(per_sm, 1)
    cols = plan["n_tgroups"] * plan["n_ptiles"] * plan["n_ftiles"]
    n1 = max(n, 1)
    if rows_per_block is None:
        need = -(-n1 // MAX_ROWS_PER_BLOCK)
        waves = max(1, -(-need * cols // wave))
        blocks_x = max(1, waves * wave // cols)
        per_tree = LN * d * B * S * 4
        blocks_x = min(blocks_x, max(MAX_PARTIAL_BYTES // (T * per_tree), 1),
                       -(-n1 // 32))
        rows_per_block = -(-(-(-n1 // blocks_x)) // 32) * 32
    elif rows_per_block < 32 or rows_per_block % 32:
        raise ValueError(f"rows_per_block must be a positive multiple of 32, got {rows_per_block}")
    blocks_x = -(-n1 // rows_per_block)
    plan.update(blocks_x=blocks_x, rows_per_block=rows_per_block, per_sm=per_sm,
                waves=-(-blocks_x * cols // wave))
    return plan


def _validate(binned_t, base_t, w_tree, pos, level_nodes, B):
    for name, t, dt in (("binned_t", binned_t, torch.int32),
                        ("base_t", base_t, torch.float32),
                        ("w_tree", w_tree, torch.float32),
                        ("pos", pos, torch.int32)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != binned_t.device:
            raise ValueError(f"{name} is on {t.device}, binned_t on {binned_t.device}")
        if t.device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    d, n = binned_t.shape
    S, T = base_t.shape[0], w_tree.shape[0]
    if base_t.shape[1] != n or w_tree.shape[1] != n or tuple(pos.shape) != (T, n):
        raise ValueError(
            f"row counts disagree: binned_t {tuple(binned_t.shape)}, base_t "
            f"{tuple(base_t.shape)}, w_tree {tuple(w_tree.shape)}, pos {tuple(pos.shape)}"
        )
    if level_nodes < 1 or B < 1 or S < 1 or T < 1 or d < 1:
        raise ValueError(f"need level_nodes, B, S, T, d >= 1; got {level_nodes}, {B}, {S}, {T}, {d}")
    if binned_t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {binned_t.device}")
    return d, n, S, T


# ------------------------------------------------------------------ plain
def fused_level_hist_plain(binned_t, base_t, w_tree, pos, level_nodes: int,
                           B: int, chunk: int = HIST_CHUNK):
    """The XLA scan of ``_make_level_hist`` in torch ops: per chunk of
    rows, masked stats (T·LN·S, C) contracted with the bins' one-hots
    (d, C, B), accumulated in ``base_t``'s dtype.  Pass float64 ``base_t``
    and ``w_tree`` for a float64 reference.  → (T, LN, d, B, S)."""
    d, n = binned_t.shape
    S, T = base_t.shape[0], w_tree.shape[0]
    LN = level_nodes
    dtype, dev = base_t.dtype, base_t.device
    acc = torch.zeros((T * LN * S, d, B), dtype=dtype, device=dev)
    nodes = torch.arange(LN, dtype=pos.dtype, device=dev)
    bins = torch.arange(B, dtype=binned_t.dtype, device=dev)
    for s0 in range(0, n, chunk):
        sl = slice(s0, s0 + chunk)
        node_oh = (pos[:, None, sl] == nodes[None, :, None]).to(dtype) * w_tree[:, None, sl]
        stats = (node_oh[:, :, None, :] * base_t[None, None, :, sl]).reshape(T * LN * S, -1)
        binoh = (binned_t[:, sl, None] == bins[None, None, :]).to(dtype)
        acc += torch.einsum("mc,fcb->mfb", stats, binoh)
    return acc.reshape(T, LN, S, d, B).permute(0, 1, 3, 4, 2).contiguous()


# ----------------------------------------------------------------- kernel
def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().tree_hist_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def occupancy(dev: torch.device, d: int, S: int, B: int, LN: int, T: int) -> int:
    """K3 blocks resident on one SM at the warps and shared bytes of this
    shape's plan (CUDA occupancy API, cached per device, kernel
    instantiation, warps and shared bytes)."""
    geo = _geometry(d, S, B, LN, T)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (idx, S if S in (2, 3) else 0, geo["warps"], geo["smem"])
    if key not in _OCCUPANCY:
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(idx):
            _raise_on(_lib().tree_hist_occupancy(S, geo["warps"], geo["smem"],
                                                 ctypes.byref(per_sm)),
                      "fused_level_hist occupancy query")
        _OCCUPANCY[key] = per_sm.value
    return _OCCUPANCY[key]


def fused_level_hist(binned_t, base_t, w_tree, pos, level_nodes: int, B: int):
    """K3: per-(tree, frontier node, feature, bin) stat histograms.

    ``binned_t`` (d, n) int32 bins shared by the trees, ``base_t`` (S, n)
    float32 per-row stats, ``w_tree`` (T, n) float32 per-tree weights,
    ``pos`` (T, n) int32 frontier positions (−1 off the frontier) →
    (T, level_nodes, d, B, S) float32.  Rows with ``pos`` outside
    [0, level_nodes), ``w = 0`` or a bin outside [0, B) add nothing, so
    no padding is needed.  Launches on the current stream and makes no
    host sync."""
    d, n, S, T = _validate(binned_t, base_t, w_tree, pos, level_nodes, B)
    dev = binned_t.device
    if dev.type == "cpu":
        return fused_level_hist_plain(binned_t, base_t, w_tree, pos, level_nodes, B)
    plan = hist_plan(n, d, S, B, level_nodes, T, _sm_count(dev),
                     occupancy(dev, d, S, B, level_nodes, T))
    return fused_level_hist_planned(binned_t, base_t, w_tree, pos, level_nodes, B, plan)


def fused_level_hist_planned(binned_t, base_t, w_tree, pos, level_nodes: int, B: int,
                             plan: dict):
    """K3 on CUDA tensors with a given ``hist_plan`` — the float32 sums
    depend on its row partition (``rows_per_block``), so a caller can
    hold two kernels to one partition.  Counts as a launch."""
    global fused_level_hist_launches
    d, n, S, T = _validate(binned_t, base_t, w_tree, pos, level_nodes, B)
    dev = binned_t.device
    if dev.type != "cuda":
        raise ValueError(f"fused_level_hist_planned takes CUDA tensors, got {dev}")
    out = torch.empty((T, level_nodes, d, B, S), dtype=torch.float32, device=dev)
    if n == 0:
        return out.zero_()
    lib = _lib()
    with torch.cuda.device(dev):
        partial = (
            torch.empty((T * plan["blocks_x"] * out[0].numel(),), dtype=torch.float32,
                        device=dev)
            if plan["blocks_x"] > 1 else out
        )
        stream = torch.cuda.current_stream(dev).cuda_stream
        with _COUNT_LOCK:
            fused_level_hist_launches += 1
        rc = lib.tree_hist_launch(
            binned_t.data_ptr(), base_t.data_ptr(), w_tree.data_ptr(), pos.data_ptr(),
            n, d, S, B, level_nodes, T, plan["LNt"], plan["dt"], plan["TB"],
            plan["n_ptiles"], plan["n_ftiles"], plan["warps"], plan["blocks_x"],
            plan["rows_per_block"], plan["smem"], partial.data_ptr(), out.data_ptr(),
            stream,
        )
    _raise_on(rc, "fused_level_hist launch")
    return out


def bound_ms(n: int, d: int, S: int, T: int, LN: int, B: int,
             hbm_bytes_per_s: float = 3.35e12, f32_ops_per_s: float = 67e12):
    """The least time an H100 could take for one K3 call: bytes (each input
    read once, the output written once) over HBM rate against T·n·d·S
    adds over the f32 rate.  → (ms, "bytes" | "operations")."""
    nbytes = 4 * n * (d + S + 2 * T) + 4 * T * LN * d * B * S
    t_bytes = nbytes / hbm_bytes_per_s * 1e3
    t_ops = T * n * d * S / f32_ops_per_s * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


__all__ = [
    "HIST_CHUNK", "bound_ms", "fused_level_hist", "fused_level_hist_plain",
    "fused_level_hist_planned",
    "hist_plan", "launch_counts", "occupancy", "reset_launch_counts", "smem_bytes",
]
