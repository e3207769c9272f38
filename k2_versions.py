#!/usr/bin/env python3
"""K2 (``fused_assign``) and K1 (``fused_lloyd_stats``) against an earlier
build of their own CUDA source, on one NVIDIA H100.

    python3 k2_versions.py --old OLD_lloyd.cu

``OLD_lloyd.cu`` is an earlier ``csrc/lloyd.cu`` (for instance
``git show <commit>:<package>/csrc/lloyd.cu``) whose K2 scores one row a
thread, with that version's C interface (``lloyd_assign_blocks`` and a
``lloyd_assign_launch`` without rows a thread).  The script builds it
beside the current source, then:

* prints each build's ``ptxas`` registers and spills;
* holds the current K2, with its own plan and forced to one row a
  thread, to the old K2: assignments ``torch.equal`` and min d² equal as
  int32 bit patterns, at the main shapes, at ``chip_smoke.py``'s edge
  shapes, on rows of +inf and NaN, and with the k=16 duplicate-center tie;
* holds the current K1 to the old K1 (``torch.equal`` sums, counts and
  cost) at K1's three shapes;
* times them in turns on one card (old, one row, own plan, own plan, one
  row, old for K2; old, new, new, old for K1) and prints one JSON line of
  the times.

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

K2_MAIN = [  # (tag, n, d, k, invalid centers, reps)
    ("predict, n=10M", 10_000_000, 8, 256, 0, 20),
    ("bulk_score chunk", 262_144, 8, 256, 0, 50),
    ("k=16", 1_000_003, 8, 16, 3, 50),
    ("wide", 1_000_000, 64, 1024, 0, 5),
    ("served batch", 200, 8, 256, 0, 200),
    ("one row", 1, 8, 256, 0, 200),
]
K1_MAIN = [  # (tag, n, d, k, invalid centers, reps)
    ("n=10M", 10_000_000, 8, 256, 0, 20),
    ("k=16", 1_000_003, 8, 16, 3, 20),
    ("wide", 1_000_000, 64, 1024, 0, 5),
]
EDGES = [  # (n, d, k, invalid centers): chip_smoke.edge_cases' shapes
    (0, 8, 4, 0), (1, 1, 1, 0), (257, 3, 5, 1), (4097, 16, 37, 4), (3001, 32, 200, 0),
    (2049, 100, 61, 3), (5000, 128, 300, 7), (100_003, 8, 16, 0), (16_384, 128, 4096, 0),
    (5000, 8, 37, 0), (10_000, 5, 1, 0), (1_000_001, 8, 256, 0),
    (300_007, 8, 37, 0), (300_007, 16, 1000, 0), (200_003, 32, 1000, 0),
]


def build_old(src: Path) -> tuple[ctypes.CDLL, str]:
    """The old source, built as ``_build`` builds the package's sources.
    → (library, ptxas log)."""
    out = _build.build_dir() / "k2_old"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "lloyd_old.cu"
    cu.write_text(src.read_text())
    lib = out / "liblloyd_old.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        cs.fail(f"nvcc failed on the old source:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    L = ctypes.CDLL(str(lib))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    L.lloyd_assign_blocks.argtypes = [ll, i, i, ctypes.POINTER(i)]
    L.lloyd_assign_blocks.restype = i
    L.lloyd_assign_launch.argtypes = [p, p, p, ll, i, i, i, p, p, p]
    L.lloyd_assign_launch.restype = i
    L.lloyd_stats_occupancy.argtypes = [i, i, ctypes.POINTER(i)]
    L.lloyd_stats_occupancy.restype = i
    L.lloyd_stats_launch.argtypes = [p, p, p, p, ll, i, i, i, i, i, i, p, p, p]
    L.lloyd_stats_launch.restype = i
    return L, proc.stdout + proc.stderr


def old_assign(Lold, x, centers, c_valid):
    """The old wrapper's host path around the old K2, statement for
    statement (its checks, its grid query on every launch, the launch), so
    that small launches compare whole calls."""
    import torch

    n, d, k = L._validate(x, centers, c_valid)
    assign = torch.empty((n,), dtype=torch.int32, device=x.device)
    mind2 = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return assign, mind2
    with torch.cuda.device(x.device):
        blocks = ctypes.c_int(0)
        cs.check(Lold.lloyd_assign_blocks(n, d, k, ctypes.byref(blocks)) == 0,
                 "old K2 grid query failed")
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with L._COUNT_LOCK:  # where the old wrapper counted the launch
            pass
        rc = Lold.lloyd_assign_launch(x.data_ptr(), centers.data_ptr(), c_valid.data_ptr(),
                                      n, d, k, blocks.value, assign.data_ptr(),
                                      mind2.data_ptr(), stream)
    cs.check(rc == 0, f"old K2 launch failed: CUDA error {rc}")
    return assign, mind2


def old_stats(Lold, x, w, centers, c_valid):
    """The old K1 with the plan the current wrapper gives (K1's plan and
    interface are unchanged)."""
    import torch

    n, d = x.shape
    k = centers.shape[0]
    per_sm = ctypes.c_int(0)
    geo = L._stats_geometry(d, k)
    cs.check(Lold.lloyd_stats_occupancy(d, geo["smem"], ctypes.byref(per_sm)) == 0,
             "old K1 occupancy query failed")
    plan = L.lloyd_plan(n, d, k, torch.cuda.get_device_properties(0).multi_processor_count,
                        per_sm.value)
    P = k * d + k + 1
    partials = torch.empty((plan["partial_floats"],), dtype=torch.float32, device="cuda")
    out = torch.empty((P,), dtype=torch.float32, device="cuda")
    rc = Lold.lloyd_stats_launch(x.data_ptr(), w.data_ptr(), centers.data_ptr(),
                                 c_valid.data_ptr(), n, d, k, plan["kt"],
                                 int(plan["acc_smem"]), plan["smem"], plan["blocks"],
                                 partials.data_ptr(), out.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
    cs.check(rc == 0, f"old K1 launch failed: CUDA error {rc}")
    return out[: k * d].view(k, d), out[k * d : k * d + k], out[-1]


def inputs(n: int, d: int, k: int, n_invalid: int, seed: int, dup: bool = False):
    """``chip_smoke.kernel_case``'s inputs: rows near random centers."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    centers = torch.randn(k, d, device="cuda", generator=g) * 3.0
    if dup:
        centers[1] = centers[0]
    x = (centers[torch.randint(0, k, (n,), device="cuda", generator=g)]
         + torch.randn(n, d, device="cuda", generator=g)).contiguous()
    w = (torch.rand(n, device="cuda", generator=g) > 0.1).float()
    c_valid = torch.ones(k, device="cuda")
    if n_invalid:
        c_valid[-n_invalid:] = 0.0
    return x, w, centers, c_valid


def k2_equal(Lold, x, centers, c_valid, tag: str) -> dict:
    """The current K2 (own plan and one row a thread) against the old K2,
    bit for bit.  → the own plan."""
    import torch

    own, one = cs.k2_plans(L, x.shape[0], x.shape[1], centers.shape[0])
    ref_a, ref_m = old_assign(Lold, x, centers, c_valid)
    for name, plan in (("own plan", own), ("one row a thread", one)):
        a, m = L.fused_assign_planned(x, centers, c_valid, plan)
        torch.cuda.synchronize()
        cs.check(torch.equal(a, ref_a) and torch.equal(m.view(torch.int32),
                                                       ref_m.view(torch.int32)),
                 f"K2 {tag}, {name} (R={plan['rows_per_thread']}): differs from the old K2 "
                 f"at {int((a != ref_a).sum())} assignments and "
                 f"{int((m.view(torch.int32) != ref_m.view(torch.int32)).sum())} min d2 bits")
    return own


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, type=Path, help="an earlier csrc/lloyd.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    cs.say(smi.stdout.strip())
    new_lib = _build.build(["lloyd"])["lloyd"]
    Lold, old_log = build_old(args.old)
    for tag, log in (("old", old_log), ("new", new_lib.with_suffix(".log").read_text())):
        for fn, usage in cs.ptxas_usage(log):
            cs.say(f"  ptxas[{tag}] {fn}: {usage}")

    k2 = []
    for i, (tag, n, d, k, n_invalid, reps) in enumerate(K2_MAIN):
        x, _, centers, c_valid = inputs(n, d, k, n_invalid, seed=40 + i)
        own = k2_equal(Lold, x, centers, c_valid, tag)
        _, one = cs.k2_plans(L, n, d, k)
        runs = {
            "old": lambda: old_assign(Lold, x, centers, c_valid),
            "one_row": lambda: L.fused_assign_planned(x, centers, c_valid, one),
            "own": lambda: L.fused_assign(x, centers, c_valid),
        }
        t = {name: [] for name in runs}
        for name in ("old", "one_row", "own", "own", "one_row", "old"):
            t[name].append(cs.gpu_ms(runs[name], reps))
        ms = {name: sum(v) / len(v) for name, v in t.items()}
        bound, by = cs.bound_ms(n, d, k, stats=False)
        cs.say(f"K2 {tag} (n={n} d={d} k={k}): old {t['old']} ms, one row {t['one_row']}, "
               f"own {t['own']} (R {own['rows_per_thread']}, {own['blocks']} blocks); bound "
               f"{bound:.4f} by {by}; old/own {ms['old'] / ms['own']:.3f}x; "
               f"== old K2 bit for bit")
        k2.append({"shape": tag, "n": n, "d": d, "k": k, "bound_ms": bound,
                   "rows_per_thread": own["rows_per_thread"], "blocks": own["blocks"],
                   **{f"{name}_ms": v for name, v in ms.items()},
                   "turns_ms": t})
        del x
        torch.cuda.empty_cache()

    x, _, centers, c_valid = inputs(1_000_003, 8, 16, 3, seed=61, dup=True)
    k2_equal(Lold, x, centers, c_valid, "k=16 duplicate-center tie")
    a, _ = L.fused_assign(x, centers, c_valid)
    cs.check(int((a == 1).sum()) == 0 and int((a == 0).sum()) > 0,
             "K2: an exact tie did not go to the first index")
    g = torch.Generator(device="cuda").manual_seed(62)
    for n, d, k, n_invalid in EDGES:
        x = torch.randn(n, d, device="cuda", generator=g) * 2.0
        if n > 10:
            x[3], x[5], x[n - 1, 0] = float("inf"), float("nan"), float("nan")
        centers = torch.randn(k, d, device="cuda", generator=g) * 2.0
        for c_valid in (torch.ones(k, device="cuda"), torch.zeros(k, device="cuda")):
            if n_invalid:
                c_valid[-n_invalid:] = 0.0
            k2_equal(Lold, x, centers, c_valid, f"edge n={n} d={d} k={k}")
    cs.say(f"K2 edge shapes {[e[:3] for e in EDGES]} (rows of inf and NaN; live and no "
           f"valid centers) and the k=16 duplicate tie: == old K2 bit for bit")

    k1 = []
    for i, (tag, n, d, k, n_invalid, reps) in enumerate(K1_MAIN):
        x, w, centers, c_valid = inputs(n, d, k, n_invalid, seed=70 + i)
        ref = old_stats(Lold, x, w, centers, c_valid)
        got = L.fused_lloyd_stats(x, w, centers, c_valid)
        torch.cuda.synchronize()
        cs.check(all(torch.equal(a, b) for a, b in zip(got, ref)),
                 f"K1 {tag}: differs from the old K1")
        runs = {"old": lambda: old_stats(Lold, x, w, centers, c_valid),
                "new": lambda: L.fused_lloyd_stats(x, w, centers, c_valid)}
        t = {name: [] for name in runs}
        for name in ("old", "new", "new", "old"):
            t[name].append(cs.gpu_ms(runs[name], reps))
        ms = {name: sum(v) / len(v) for name, v in t.items()}
        cs.say(f"K1 {tag} (n={n} d={d} k={k}): old {t['old']} ms, new {t['new']}; "
               f"new/old {ms['new'] / ms['old']:.4f}; == old K1 bit for bit")
        k1.append({"shape": tag, "n": n, "d": d, "k": k,
                   **{f"{name}_ms": v for name, v in ms.items()}, "turns_ms": t})
        del x, w
        torch.cuda.empty_cache()
    cs.say(json.dumps({"k2_versions": k2, "k1_versions": k1, "card": smi.stdout.strip()}))


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import _build
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import lloyd as L

    main()
