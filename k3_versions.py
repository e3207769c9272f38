#!/usr/bin/env python3
"""K3 (``fused_level_hist``) against an earlier build of its own CUDA
source, on one NVIDIA H100.

    python3 k3_versions.py --old OLD_tree_hist.cu

``OLD_tree_hist.cu`` is an earlier ``csrc/tree_hist.cu`` (for instance
``git show <commit>:<package>/csrc/tree_hist.cu``) whose kernel has one
tree a block and the C interface of that version.  The script builds it
beside the current source, with a small occupancy query appended, then:

* prints each build's ``ptxas`` registers and spills, and at the four
  main shapes the old kernel's plan, resident blocks an SM and waves;
* holds the current kernel with the old kernel's row partition forced
  (``rows_per_block`` of the old plan) to the old kernel: their outputs
  must be ``torch.equal`` at every main and edge shape;
* times, in turns on one card (old, forced, own plan, own plan,
  forced, old), the old kernel, the current kernel with the old
  partition, and the current kernel with its own plan, at the four main
  shapes, and prints one JSON line of the times.

Exits non-zero on any disagreement.  Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

OCCUPANCY_SHIM = r"""
extern "C" int old_tree_hist_occupancy(int S, int nwarps, int smem, int* per_sm) {
  auto kernel = S == 2 ? level_hist_kernel<2> : S == 3 ? level_hist_kernel<3>
                                                       : level_hist_kernel<0>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, nwarps * 32, smem);
  return (int)e;
}
"""

MAIN = [  # (tag, n, d, S, T, LN) as chip_smoke.k3_phase
    ("rf20 root", cs.TREE_N, 8, 3, 20, 1),
    ("rf20 depth 5", cs.TREE_N, 8, 3, 20, 32),
    ("pipeline RF regressor depth 5", 1_400_000, 4, 3, 20, 32),
    ("classification", cs.TREE_N, 4, 2, 20, 16),
]
EDGES = [  # (tag, n, d, S, T, LN, B)
    ("n=1", 1, 8, 3, 2, 1, 32),
    ("d=1", 40_001, 1, 3, 5, 8, 32),
    ("d=100 (feature tiles)", 20_003, 100, 3, 3, 2, 32),
    ("B=2", 30_001, 8, 3, 4, 8, 2),
    ("S=5", 30_001, 8, 5, 4, 8, 32),
    ("T=7 (TB=4)", 60_001, 8, 3, 7, 2, 32),
    ("LN=1024 (node tiles)", 200_000, 8, 3, 2, 1024, 32),
    ("LN=1024, d=1, B=2, S=1, T=6 (TB=3)", 100_003, 1, 1, 6, 1024, 2),
    ("n=300,007 (ragged last tile)", 300_007, 8, 3, 4, 8, 32),
]


def old_plan(n: int, d: int, S: int, B: int, LN: int, T: int, sms: int) -> dict:
    """The launch geometry of the one-tree-a-block kernel (its
    ``hist_plan``): 8 warps at most, a per-warp scratch of 4·32·S floats
    beside the tile, about 8 blocks an SM of row blocks per tree."""
    budget, max_warps, unroll, blocks_per_sm = 112 * 1024, 8, 4, 8
    bs = B * S * 4
    warps = min(max_warps, d)
    scratch = warps * unroll * 32 * S * 4
    LNt = min(LN, (budget - scratch) // (d * bs)) if budget > scratch else 0
    dt = d
    if LNt < 1:
        LNt = 1
        dt = (budget - max_warps * unroll * 32 * S * 4) // bs
        warps = min(max_warps, dt)
        scratch = warps * unroll * 32 * S * 4
    n_ptiles, n_ftiles = -(-LN // LNt), -(-d // dt)
    tiles = n_ptiles * n_ftiles
    blocks_x = max(-(-blocks_per_sm * sms // (T * tiles)), -(-n // H.MAX_ROWS_PER_BLOCK), 1)
    per_tree = LN * d * B * S * 4
    blocks_x = min(blocks_x, max(H.MAX_PARTIAL_BYTES // (T * per_tree), 1),
                   max(-(-n // 32), 1))
    rows_per_block = -(-(-(-max(n, 1) // blocks_x)) // 32) * 32
    blocks_x = -(-max(n, 1) // rows_per_block)
    return {"LNt": LNt, "dt": dt, "n_ptiles": n_ptiles, "n_ftiles": n_ftiles,
            "warps": warps, "blocks_x": blocks_x, "rows_per_block": rows_per_block,
            "smem": LNt * dt * bs + scratch}


def build_old(src: Path) -> tuple[ctypes.CDLL, str]:
    """The old source plus the occupancy query, built as ``_build`` builds
    the package's sources.  → (library, ptxas log)."""
    out = _build.build_dir() / "k3_old"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "tree_hist_old.cu"
    cu.write_text(src.read_text() + OCCUPANCY_SHIM)
    lib = out / "libtree_hist_old.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        cs.fail(f"nvcc failed on the old source:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    L = ctypes.CDLL(str(lib))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    L.tree_hist_launch.argtypes = [p, p, p, p, ll, i, i, i, i, i, i, i, i, i, i, i, ll,
                                   i, p, p, p]
    L.tree_hist_launch.restype = i
    L.old_tree_hist_occupancy.argtypes = [i, i, i, ctypes.POINTER(i)]
    L.old_tree_hist_occupancy.restype = i
    return L, proc.stdout + proc.stderr


def old_launch(L, plan, binned, base, w, pos, LN: int, B: int):
    import torch

    d, n = binned.shape
    S, T = base.shape[0], w.shape[0]
    out = torch.empty((T, LN, d, B, S), dtype=torch.float32, device="cuda")
    partial = (torch.empty((T * plan["blocks_x"] * out[0].numel(),), device="cuda")
               if plan["blocks_x"] > 1 else out)
    rc = L.tree_hist_launch(
        binned.data_ptr(), base.data_ptr(), w.data_ptr(), pos.data_ptr(), n, d, S, B, LN,
        T, plan["LNt"], plan["dt"], plan["n_ptiles"], plan["n_ftiles"], plan["warps"],
        plan["blocks_x"], plan["rows_per_block"], plan["smem"], partial.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    cs.check(rc == 0, f"old K3 launch failed: CUDA error {rc}")
    return out


def forced_plan(n, d, S, B, LN, T, sms, rows_per_block):
    import torch

    dev = torch.device("cuda")
    return H.hist_plan(n, d, S, B, LN, T, sms, H.occupancy(dev, d, S, B, LN, T),
                       rows_per_block)


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, type=Path, help="an earlier csrc/tree_hist.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    cs.say(smi.stdout.strip())
    new_lib = _build.build(["tree_hist"])["tree_hist"]
    Lold, old_log = build_old(args.old)
    for tag, log in (("old", old_log), ("new", new_lib.with_suffix(".log").read_text())):
        for fn, usage in cs.ptxas_usage(log):
            cs.say(f"  ptxas[{tag}] {fn}: {usage}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    B = 32

    def equal_to_old(tag, n, d, S, T, LN, b, seed, integer=True):
        ins = cs.k3_inputs(n, d, S, T, LN, b, seed=seed, integer=integer)
        op = old_plan(n, d, S, b, LN, T, sms)
        fp = forced_plan(n, d, S, b, LN, T, sms, op["rows_per_block"])
        ref = old_launch(Lold, op, *ins, LN, b)
        got = H.fused_level_hist_planned(*ins, LN, b, fp)
        torch.cuda.synchronize()
        diff = int((got != ref).sum())
        cs.check(torch.equal(got, ref), f"{tag}: the new kernel with the old partition differs from the "
                            f"old kernel in {diff} of {ref.numel()} floats")
        return ins, op, fp

    results = []
    for i, (tag, n, d, S, T, LN) in enumerate(MAIN):
        ins, op, fp = equal_to_old(tag, n, d, S, T, LN, B, seed=10 + i)
        per = ctypes.c_int(0)
        cs.check(Lold.old_tree_hist_occupancy(S, op["warps"], op["smem"], ctypes.byref(per))
                 == 0, "old occupancy query failed")
        tiles = op["n_ptiles"] * op["n_ftiles"]
        old_total = op["blocks_x"] * T * tiles
        own = H.hist_plan(n, d, S, B, LN, T, sms, H.occupancy(torch.device("cuda"), d, S,
                                                              B, LN, T))
        cs.say(f"{tag}: old plan {op['warps']} warps, {op['smem']} shared bytes, "
               f"{op['blocks_x']} x {T} x {tiles} = {old_total} blocks, {per.value} "
               f"resident an SM, {old_total / (per.value * sms):.3f} waves | own plan TB "
               f"{own['TB']}, {own['warps']} warps, {own['smem']} shared bytes, blocks_x "
               f"{own['blocks_x']}, {own['per_sm']} resident an SM, {own['waves']} waves; "
               f"forced partition == old kernel")
        cs.k3_check(H, *ins, LN, B, f"{tag}, own plan")
        t = {"old": [], "forced": [], "own": []}
        runs = {
            "old": lambda: old_launch(Lold, op, *ins, LN, B),
            "forced": lambda: H.fused_level_hist_planned(*ins, LN, B, fp),
            "own": lambda: H.fused_level_hist(*ins, LN, B),
        }
        for name in ("old", "forced", "own", "own", "forced", "old"):
            t[name].append(cs.gpu_ms(runs[name], 10))
        ms = {k: sum(v) / len(v) for k, v in t.items()}
        bound, by = H.bound_ms(n, d, S, T, LN, B)
        cs.say(f"{tag} (n={n} d={d} S={S} T={T} LN={LN}): old {t['old']} ms, forced "
               f"{t['forced']}, own {t['own']}; bound {bound:.4f} by {by}; old/own "
               f"{ms['old'] / ms['own']:.3f}x")
        results.append({"shape": tag, "bound_ms": bound, **{f"{k}_ms": v for k, v in ms.items()},
                        "old_per_sm": per.value, "old_blocks": old_total,
                        "own_TB": own["TB"], "own_blocks_x": own["blocks_x"],
                        "own_per_sm": own["per_sm"], "own_waves": own["waves"]})
        del ins
        torch.cuda.empty_cache()

    for i, (tag, n, d, S, T, LN, b) in enumerate(EDGES):
        for integer in (True, False):
            equal_to_old(tag, n, d, S, T, LN, b, seed=30 + i, integer=integer)
    cs.say(f"edge shapes {[e[0] for e in EDGES]}: forced partition == old kernel "
           f"(integer and fractional stats)")
    cs.say(json.dumps({"k3_versions": results, "card": smi.stdout.strip()}))


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import _build
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import (
        tree_hist as H,
    )

    main()
