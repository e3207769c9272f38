#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (one NVIDIA H100).

    python3 chip_smoke.py

Builds the port's kernels from ``csrc/``, holds each against its plain
PyTorch version on the card (and K2, at every shape, with its own plan
against itself at one row a thread, bit for bit, on rows of ±inf and NaN
too), then drives the port's two main paths at
full width and shows through the launch counters that each ran on its
kernels:

* the KMeans k=256 path — 10M standardized 8-feature rows: Table →
  VectorAssembler → StandardScaler → KMeans fit → predict → silhouette →
  an InferenceServer answering requests → bulk scoring (K1, K2);
* the hospital pipeline's model stage — the bundled CSV on the card and
  on the CPU, then 2M rows of the example generator's law: Binarizer →
  seed-42 split → VectorAssembler → LinearRegression, decision-tree and
  random-forest regressors and classifiers → RMSE / accuracy /
  importances (K3, each launch timed with CUDA events), and the rf20
  forest (2M x 8 rows, 20 trees) with its fit breakdown and a check that
  its level loop makes no host sync;
* the SQL training window — 10M rows of the example generator's law
  spread over the whole day: the reference's window query compiled to
  torch ops on the card (route ``compiled``, no fallback reasons), equal
  to the interpreter on every column, with its first-run transfer, rerun,
  on-card and ``to_table`` times; a per-hospital GROUP BY and a
  whole-partition window against the interpreter; and the window feeding
  the model stage below (``extract_training_window``);
* model artifacts — the 2M-row stage's five models saved (``save_models``)
  and loaded back, the KMeans k=256 model and its scaler saved and loaded,
  the loaded model predicting the 10M rows, serving the same requests from
  its directory and transforming a 1M-row Table (K2), a save killed at each
  of the three save sites, and a flipped and a truncated payload.

Any failed check exits non-zero before the last line; without a CUDA
device, or without the port's package beside it, the script prints no
result and exits 1.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the per-kernel record (launches, error, kernel / plain / library
times and the card's bound for the same work).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch"
JAX_KERNELS = "clustermachinelearningforhospitalnetworks_apache_spark_tpu/ops/pallas_kernels.py"

N, D, K = 10_000_000, 8, 256
TREE_N = 2_000_000          # rf20 and the model stage at scale
CSV = ROOT / "data" / "hospital_patients.csv"
WHOLE_DAY = ("2025-03-31 00:00:00", "2025-03-31 23:59:59")
SEED = 0
MAX_ITER = 20
BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
REQUEST_SIZES = (1, 7, 32, 200)
TRANSFORM_N = 1_000_000     # rows of the KMeans table through transform
SQL_N = 10_000_000          # rows of the SQL window phase, over the whole day
# the JAX package's SQL fuzz tolerance (core/sql_fuzz.py compare_tables)
SQL_RTOL, SQL_ATOL = 1e-9, 1e-12
SAVE_SITES = ("model_io.save.arrays", "model_io.save.meta", "model_io.save.swap")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 CUDA-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def gpu_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs after one warmup."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_name(mangled: str) -> str:
    """``name<template args>`` of an Itanium-mangled kernel name."""
    i, parts = (3 if mangled.startswith("_ZN") else 2), []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        parts.append(mangled[j : j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    args = re.match(r"I((?:Li-?\d+E)+)E", mangled[i:])
    name = parts[-1] if parts else mangled
    return name + ("<" + ",".join(re.findall(r"Li(-?\d+)E", args.group(1))) + ">"
                   if args else "")


def ptxas_usage(log: str) -> list[tuple[str, str]]:
    """(kernel, "registers, spills") per entry function of an ``nvcc
    -Xptxas -v`` log."""
    out, fn, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )(_Z\w+)", line)
        if m:
            fn = kernel_name(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line:
            used = re.search(r"Used (\d+) registers", line)
            out.append((fn, f"{used.group(1) if used else '?'} registers, {spill}"))
            spill = ""
    return out


def bound_ms(n: int, d: int, k: int, stats: bool) -> tuple[float, str]:
    """Least time for the work on an H100: bytes moved (inputs once,
    outputs once) over HBM rate vs k(2d+3) f32 operations per row over
    the f32 rate."""
    if stats:
        nbytes = 4 * (n * d + n + k * d + k) + 4 * (k * d + k + 1)
    else:
        nbytes = 4 * (n * d + k * d + k) + 8 * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n * k * (2 * d + 3) / F32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def library_assign(x, centers, x_sq, c_sq):
    """K2's library yardstick: ``addmm`` of the cross term with |c|², plus
    |x|², then ``min`` over the centers."""
    import torch

    return torch.addmm(c_sq[None, :], x, centers.T, alpha=-2.0).add_(x_sq[:, None]).min(dim=1)


def k2_plans(L, n: int, d: int, k: int) -> tuple[dict, dict]:
    """K2's own plan on this card, and the same shape forced to one row a
    thread (the loop of earlier builds)."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    R = L.assign_rows_per_thread(n, d, sms)
    own = L.assign_plan(n, d, k, sms, L._assign_occupancy(0, d, k, R), R)
    one = L.assign_plan(n, d, k, sms, L._assign_occupancy(0, d, k, 1), 1)
    return own, one


def k2_equal_to_one_row(L, x, centers, c_valid, tag: str) -> str:
    """K2 with its own plan against K2 forced to one row a thread: the
    assignments ``torch.equal``, min d² equal as int32 bit patterns (so
    NaN compares too).  → the plan, for the log."""
    import torch

    n, d = x.shape
    own, one = k2_plans(L, n, d, centers.shape[0])
    a, m = L.fused_assign_planned(x, centers, c_valid, own)
    a1, m1 = L.fused_assign_planned(x, centers, c_valid, one)
    torch.cuda.synchronize()
    check(torch.equal(a, a1) and torch.equal(m.view(torch.int32), m1.view(torch.int32)),
          f"K2 {tag}: R={own['rows_per_thread']} differs from one row a thread at "
          f"{int((a != a1).sum())} assignments, "
          f"{int((m.view(torch.int32) != m1.view(torch.int32)).sum())} min d2 bit patterns")
    return (f"R {own['rows_per_thread']}, {own['blocks']} blocks, "
            f"{L._assign_occupancy(0, d, centers.shape[0], own['rows_per_thread'])} "
            f"resident an SM, kt {own['kt']} ({own['n_ctiles']} tile(s))")


def compare_k2(L, x, centers, c_valid, tag: str):
    """K2 against its plain version: assignments may differ only at near
    ties (best two d² within 1e-5 relative), min d² at rtol 1e-4 / atol
    1e-3; and K2's own plan bit-equal to one row a thread.  → (max abs
    err, indices of the flipped rows)."""
    import torch

    a, m = L.fused_assign(x, centers, c_valid)
    ap, mp = L.fused_assign_plain(x, centers, c_valid)
    torch.cuda.synchronize()
    bad = torch.nonzero(a != ap).flatten()
    hard = 0
    if bad.numel():
        xb = x[bad]
        d2 = torch.clamp((xb * xb).sum(1)[:, None] - 2 * xb @ centers.T
                         + (centers * centers).sum(1)[None, :], min=0)
        d2 = torch.where(c_valid[None, :] > 0, d2, torch.full_like(d2, L.BIG))
        two = d2.topk(2, dim=1, largest=False).values
        gap = (two[:, 1] - two[:, 0]) / two[:, 1].abs().clamp(min=1e-30)
        hard = int((gap > 1e-5).sum())
    check(hard == 0, f"K2 {tag}: {hard} assignments differ outside near ties")
    check(torch.allclose(m, mp, rtol=1e-4, atol=1e-3), f"K2 {tag}: min d2 disagrees")
    k2_err = float((m - mp).abs().max()) if m.numel() else 0.0
    say(f"  K2 plan {tag}: {k2_equal_to_one_row(L, x, centers, c_valid, tag)}; "
        f"== one row a thread bit for bit")
    return k2_err, bad


def compare(L, x, w, centers, c_valid, tag: str):
    """K2 (``compare_k2``) and K1 against their plain versions on one
    input.  A row that K2 flipped at a near tie moves between clusters in
    K1 too (both share the argmin), so the sums/counts tolerance widens by
    that much.  Sums at rtol 1e-4 (atol 1e-4 x the largest); counts exact
    under 0/1 weights, else as the sums; cost at rtol 1e-6 (read 2.25e-7
    at the main shape); two K1 launches must agree bit for bit.  → (K1
    max abs err, K2 max abs err, K1 cost rel err, near-tie flips)."""
    import torch

    k2_err, bad = compare_k2(L, x, centers, c_valid, tag)
    s, c, cost = L.fused_lloyd_stats(x, w, centers, c_valid)
    sp, cp, costp = L.fused_lloyd_stats_plain(x, w, centers, c_valid)
    torch.cuda.synchronize()
    flips = int(bad.numel())
    xmax = float(x.abs().max()) if x.numel() else 0.0
    wmax = float(w.max()) if w.numel() else 0.0
    scale = float(sp.abs().max().clamp(min=1.0))
    check(torch.allclose(s, sp, rtol=1e-4, atol=1e-4 * scale + flips * wmax * xmax),
          f"K1 {tag}: sums disagree")
    if bool(((w == 0) | (w == 1)).all()):
        # 0/1 weights: both count exactly, so a flipped row moves one count
        # out of one cluster into another and nothing else differs
        check(float((c - cp).abs().sum()) <= 2 * flips, f"K1 {tag}: counts disagree")
    else:
        check(torch.allclose(c, cp, rtol=1e-4, atol=1e-4 * max(float(cp.max()), 1.0)
                             + flips * wmax), f"K1 {tag}: counts disagree")
    cost_rel = abs(float(cost) - float(costp)) / max(abs(float(costp)), 1e-30)
    check(cost_rel <= 1e-6 or abs(float(cost) - float(costp)) <= 1e-6,
          f"K1 {tag}: cost {float(cost)} vs {float(costp)} (rel err {cost_rel:.3g})")
    k1_err = max(float((s - sp).abs().max()), float((c - cp).abs().max()))
    s2, c2, cost2 = L.fused_lloyd_stats(x, w, centers, c_valid)
    check(torch.equal(s, s2) and torch.equal(c, c2) and torch.equal(cost, cost2),
          f"K1 {tag}: two launches differ")
    return k1_err, k2_err, cost_rel, flips


def kernel_case(L, n: int, d: int, k: int, n_invalid: int, seed: int, reps: int,
                dup: bool = False):
    """K1 and K2 against their plain versions (and the library yardstick)
    on one shape; returns the two kernel records.  ``dup`` makes center 1
    a copy of center 0: every tie between them must go to index 0."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    centers = torch.randn(k, d, device="cuda", generator=g) * 3.0
    if dup:
        centers[1] = centers[0]
    idx = torch.randint(0, k, (n,), device="cuda", generator=g)
    x = (centers[idx] + torch.randn(n, d, device="cuda", generator=g)).contiguous()
    del idx
    w = (torch.rand(n, device="cuda", generator=g) > 0.1).float()
    c_valid = torch.ones(k, device="cuda")
    if n_invalid:
        c_valid[-n_invalid:] = 0.0

    tag = f"n={n} d={d} k={k}"
    k1_err, k2_err, cost_rel, flips = compare(L, x, w, centers, c_valid, tag)
    if dup:
        a, _ = L.fused_assign(x, centers, c_valid)
        check(int((a == 1).sum()) == 0 and int((a == 0).sum()) > 0,
              f"K2 {tag}: an exact tie did not go to the first index")
        del a

    # --- times: kernel, plain version, and one library composition
    c_sq = (centers * centers).sum(1)
    x_sq = (x * x).sum(1)

    def lib_stats():
        mn, arg = library_assign(x, centers, x_sq, c_sq)
        arg = arg.to(torch.int64)
        sums = torch.zeros(k, d, device="cuda").index_add_(0, arg, x * w[:, None])
        cnts = torch.zeros(k, device="cuda").index_add_(0, arg, w)
        return sums, cnts, (mn * w).sum()

    plain_reps = max(2, reps // 5)
    one = k2_plans(L, n, d, k)[1]
    t = {
        "k2": gpu_ms(lambda: L.fused_assign(x, centers, c_valid), reps),
        # K2 at one row a thread runs K1's distance loop: K1 minus it is
        # K1's accumulation
        "k2_one": gpu_ms(lambda: L.fused_assign_planned(x, centers, c_valid, one), reps),
        "k2_plain": gpu_ms(lambda: L.fused_assign_plain(x, centers, c_valid), plain_reps),
        "k2_lib": gpu_ms(lambda: library_assign(x, centers, x_sq, c_sq), plain_reps),
        "k1": gpu_ms(lambda: L.fused_lloyd_stats(x, w, centers, c_valid), reps),
        "k1_plain": gpu_ms(lambda: L.fused_lloyd_stats_plain(x, w, centers, c_valid), plain_reps),
        "k1_lib": gpu_ms(lib_stats, plain_reps),
    }
    b1, b1_by = bound_ms(n, d, k, stats=True)
    b2, b2_by = bound_ms(n, d, k, stats=False)
    plan = L.lloyd_plan(n, d, k, torch.cuda.get_device_properties(0).multi_processor_count,
                        L._stats_occupancy(x.device, d, k))
    say(f"kernel vs plain n={n} d={d} k={k} ({k - n_invalid} valid"
        f"{', centers 0 and 1 equal' if dup else ''}): "
        f"K1 {t['k1']:.4f} ms (plain {t['k1_plain']:.4f}, library {t['k1_lib']:.4f}, "
        f"bound {b1:.4f} by {b1_by}; max_abs_err {k1_err:.3g}, cost rel err {cost_rel:.3g}) | "
        f"K2 {t['k2']:.4f} ms (plain {t['k2_plain']:.4f}, library {t['k2_lib']:.4f}, "
        f"bound {b2:.4f} by {b2_by}; max_abs_err {k2_err:.3g}, "
        f"{flips} near-tie flips) | K2 at one row a thread {t['k2_one']:.4f} ms, K1 minus "
        f"it (K1's accumulation) {t['k1'] - t['k2_one']:.4f} ms; "
        f"K1 plan: {plan['blocks']} blocks, {plan['n_ctiles']} center tile(s) of "
        f"{plan['kt']}, accumulators in {'shared' if plan['acc_smem'] else 'global'} "
        f"memory, {plan['smem']} shared bytes — ok")
    del x, w, x_sq
    torch.cuda.empty_cache()
    src = f"{PKG}/csrc/lloyd.cu"
    return [
        {"name": "fused_lloyd_stats", "route": "cuda", "source": src,
         "replaces": f"{JAX_KERNELS}:155", "launches": 0, "max_abs_err": k1_err,
         "ms": t["k1"], "plain_ms": t["k1_plain"], "bound_ms": b1,
         "bound_by": b1_by, "library_ms": t["k1_lib"]},
        {"name": "fused_assign", "route": "cuda", "source": src,
         "replaces": f"{JAX_KERNELS}:241", "launches": 0, "max_abs_err": k2_err,
         "ms": t["k2"], "plain_ms": t["k2_plain"], "bound_ms": b2,
         "bound_by": b2_by, "library_ms": t["k2_lib"]},
    ]


def k2_case(L, n: int, d: int, k: int, seed: int, reps: int) -> dict:
    """K2 alone against its plain version at one more shape of its main
    path (a ``bulk_score`` chunk, a served batch), with its times.  → the
    shape's record."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    centers = torch.randn(k, d, device="cuda", generator=g) * 3.0
    x = (centers[torch.randint(0, k, (n,), device="cuda", generator=g)]
         + torch.randn(n, d, device="cuda", generator=g)).contiguous()
    c_valid = torch.ones(k, device="cuda")
    tag = f"n={n} d={d} k={k}"
    err, bad = compare_k2(L, x, centers, c_valid, tag)
    c_sq, x_sq = (centers * centers).sum(1), (x * x).sum(1)
    t = {
        "ms": gpu_ms(lambda: L.fused_assign(x, centers, c_valid), reps),
        "plain_ms": gpu_ms(lambda: L.fused_assign_plain(x, centers, c_valid), reps),
        "library_ms": gpu_ms(lambda: library_assign(x, centers, x_sq, c_sq), reps),
    }
    b, by = bound_ms(n, d, k, stats=False)
    say(f"K2 vs plain {tag}: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, library "
        f"{t['library_ms']:.4f}, bound {b:.4f} by {by}; max_abs_err {err:.3g}, "
        f"{bad.numel()} near-tie flips) — ok")
    return {"n": n, "d": d, "k": k, "max_abs_err": err, **t, "bound_ms": b, "bound_by": by}


def k2_non_finite(L) -> None:
    """K2 on rows of +inf and NaN, with live centers and with every center
    invalid, at R = 4 with center tiles, R = 2 with center tiles and R = 4
    at d=8: bit-equal to one row a thread.  With every center invalid each
    row scores 1e30 everywhere, so each goes to center 0 at 1e30."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(11)
    shapes = [(300_007, 8, 37), (300_007, 16, 1000), (200_003, 32, 1000)]
    for n, d, k in shapes:
        x = torch.randn(n, d, device="cuda", generator=g) * 2.0
        x[3] = float("inf")
        x[5] = float("nan")
        x[n - 2] = -float("inf")
        x[n - 1, 0] = float("nan")
        centers = torch.randn(k, d, device="cuda", generator=g) * 2.0
        for valid in (True, False):
            c_valid = torch.full((k,), 1.0 if valid else 0.0, device="cuda")
            tag = f"n={n} d={d} k={k}, inf and NaN rows, {'live' if valid else 'no valid'} centers"
            plan = k2_equal_to_one_row(L, x, centers, c_valid, tag)
            if not valid:
                a, m = L.fused_assign(x, centers, c_valid)
                check(not bool(a.any()) and bool((m == L.BIG).all()),
                      f"K2 {tag}: expected every row at center 0, d2 1e30")
            say(f"  K2 {tag}: {plan}; == one row a thread bit for bit")


def edge_cases(L) -> None:
    """Small odd shapes, fractional weights: every feature-width template
    (d = 1 … 128), one center, centers tiled with a remainder tile, rows
    that end mid-tile, and n = 0.  Then the shapes of K1's accumulation:
    every row in one cluster (segments of a whole tile), every row near
    its own center at k=4096, d=128 (segments of one row, accumulators in
    global memory), all weights zero, k=1, and a ragged last tile at
    n = 10^6 + 1."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(7)
    shapes = [(0, 8, 4, 0), (1, 1, 1, 0), (257, 3, 5, 1), (4097, 16, 37, 4),
              (3001, 32, 200, 0), (2049, 100, 61, 3), (5000, 128, 300, 7)]
    worst_cost_rel = 0.0
    for n, d, k, n_invalid in shapes:
        x = torch.randn(n, d, device="cuda", generator=g) * 2.0
        w = torch.rand(n, device="cuda", generator=g)
        centers = torch.randn(k, d, device="cuda", generator=g) * 2.0
        c_valid = torch.ones(k, device="cuda")
        if n_invalid:
            c_valid[-n_invalid:] = 0.0
        cost_rel = compare(L, x, w, centers, c_valid, f"edge n={n} d={d} k={k}")[2]
        worst_cost_rel = max(worst_cost_rel, cost_rel)
    say(f"kernel vs plain, edge shapes {[sh[:3] for sh in shapes]}: ok "
        f"(largest K1 cost rel err {worst_cost_rel:.3g})")

    accumulation = [  # (tag, n, d, k, kind)
        ("every row in one cluster", 100_003, 8, 16, "one"),
        ("every row near its own center", 16_384, 128, 4096, "own"),
        ("all weights zero", 5000, 8, 37, "w0"),
        ("k=1", 10_000, 5, 1, "rand"),
        ("n=10^6+1, ragged last tile", 1_000_001, 8, 256, "rand"),
    ]
    for tag, n, d, k, kind in accumulation:
        # noise 0.5 keeps d2 well above the x^2 - 2x.c + c^2 form's
        # cancellation error, so the costs of kernel and plain agree
        centers = torch.randn(k, d, device="cuda", generator=g) * (10.0 if kind == "one" else 3.0)
        if kind == "one":
            x = centers[5] + 0.5 * torch.randn(n, d, device="cuda", generator=g)
        elif kind == "own":
            own = torch.arange(n, device="cuda") % k
            x = centers[own] + 0.5 * torch.randn(n, d, device="cuda", generator=g)
        else:
            x = torch.randn(n, d, device="cuda", generator=g) * 3.0
        w = torch.rand(n, device="cuda", generator=g)
        if kind == "w0":
            w.zero_()
        x = x.contiguous()
        c_valid = torch.ones(k, device="cuda")
        compare(L, x, w, centers, c_valid, f"edge {tag} (n={n} d={d} k={k})")
        a, _ = L.fused_assign(x, centers, c_valid)
        if kind == "one":
            check(bool((a == 5).all()), f"K2 edge {tag}: a row left cluster 5")
        if kind == "own":
            check(torch.equal(a.long(), own), f"K2 edge {tag}: a row left its own center")
        if kind == "w0":
            s, c, cost = L.fused_lloyd_stats(x, w, centers, c_valid)
            check(not bool(s.any()) and not bool(c.any()) and float(cost) == 0.0,
                  f"K1 edge {tag}: expected all-zero statistics")
    say(f"kernel vs plain, accumulation edge shapes {[e[0] for e in accumulation]}: ok "
        f"(two K1 launches bit-identical at each)")
    k2_non_finite(L)


def make_table_columns(n: int, d: int, k: int, seed: int):
    """The generator of bench.py (``_make_data``, before its own
    standardization — StandardScaler does that here, on the card)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 4.0, size=(k, d))
    assign = rng.integers(0, k, size=n)
    x = centers[assign] + rng.normal(0.0, 1.0, size=(n, d))
    return {f"f{j}": x[:, j] for j in range(d)}


# ------------------------------------------------------------------- K3
#: the device of the model-stage phases; a CPU rehearsal of this script's
#: control flow (plain versions, small sizes) may set it to "cpu"
DEV = "cuda"


def sync() -> None:
    import torch

    if DEV == "cuda":
        torch.cuda.synchronize()
def k3_inputs(n: int, d: int, S: int, T: int, LN: int, B: int, seed: int,
              integer: bool = True, off: float = 0.1):
    """Random K3 inputs on the card: bins in [0, B), ``off`` of the rows
    off the frontier (pos = -1), the rest spread over LN nodes.  Integer
    stats (labels in {0..3} and Poisson-like weights 0..2) keep every
    float32 sum exact below 2**24; else weights and stats in (0, 1]."""
    import torch

    g = torch.Generator(device=DEV).manual_seed(seed)
    binned = torch.randint(0, B, (d, n), device=DEV, generator=g, dtype=torch.int32)
    pos = torch.randint(0, LN, (T, n), device=DEV, generator=g, dtype=torch.int32)
    pos[torch.rand((T, n), device=DEV, generator=g) < off] = -1
    if integer:
        y = torch.randint(0, 4, (n,), device=DEV, generator=g).float()
        base = torch.stack([torch.ones_like(y), y, y * y])[:S] if S <= 3 else \
            torch.randint(0, 4, (S, n), device=DEV, generator=g).float()
        w = torch.randint(0, 3, (T, n), device=DEV, generator=g).float()
    else:
        base = 1.0 - torch.rand((S, n), device=DEV, generator=g)
        w = 1.0 - torch.rand((T, n), device=DEV, generator=g)
    return binned, base.contiguous(), w.contiguous(), pos


def k3_check(H, binned, base, w, pos, LN: int, B: int, tag: str) -> tuple[float, float]:
    """K3 against its plain version evaluated in float64: integer-valued
    stats exactly equal, float stats each bin within rtol 1e-5; two
    launches bit-identical.  → (max abs err, max rel err)."""
    import torch

    h = H.fused_level_hist(binned, base, w, pos, LN, B)
    h2 = H.fused_level_hist(binned, base, w, pos, LN, B)
    ref = H.fused_level_hist_plain(binned, base.double(), w.double(), pos, LN, B)
    sync()
    check(tuple(h.shape) == tuple(ref.shape), f"K3 {tag}: shape {tuple(h.shape)}")
    check(torch.equal(h, h2), f"K3 {tag}: two launches differ")
    diff = (h.double() - ref).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    rel = float((diff / ref.abs().clamp(min=1e-300)).max()) if diff.numel() else 0.0
    integer = bool((base == base.round()).all() and (w == w.round()).all())
    if integer:
        check(err == 0.0, f"K3 {tag}: integer stats differ from the plain version by {err}")
    else:
        check(bool((diff <= 1e-5 * ref.abs()).all()),
              f"K3 {tag}: a bin is off the float64 plain version by rel {rel:.3g} > 1e-5")
    return err, rel


def k3_time(H, binned, base, w, pos, LN: int, B: int, reps: int) -> dict:
    """K3, its plain version (float32) and one library composition:
    ``index_add_`` of w*base into the flat histogram keyed by
    ((t*LN + p)*d + f)*B + b, rows off the frontier into a spare slot."""
    import torch

    d, n = binned.shape
    S, T = base.shape[0], w.shape[0]
    keys = None

    def library():
        nonlocal keys
        if keys is None:
            tp = (torch.arange(T, device=DEV)[:, None] * LN + pos.long())  # (T, n)
            k = (tp[:, None, :] * d + torch.arange(d, device=DEV)[None, :, None]) * B \
                + binned.long()[None, :, :]
            keys = torch.where((pos >= 0)[:, None, :], k, T * LN * d * B).reshape(-1)
        out = torch.zeros((T * LN * d * B + 1, S), device=DEV)
        for s in range(S):
            vals = (w * base[s][None, :])[:, None, :].expand(T, d, n).reshape(-1)
            out[:, s].index_add_(0, keys, vals)
        return out

    t = {
        "ms": gpu_ms(lambda: H.fused_level_hist(binned, base, w, pos, LN, B), reps),
        "plain_ms": gpu_ms(lambda: H.fused_level_hist_plain(binned, base, w, pos, LN, B),
                           max(1, reps // 5)),
        "library_ms": gpu_ms(library, max(1, reps // 5)),
    }
    t["bound_ms"], t["bound_by"] = H.bound_ms(n, d, S, T, LN, B)
    del keys
    return t


def k3_phase(H) -> dict:
    """K3 against its plain version at the main shapes and the edge
    shapes; times at rf20's and the pipeline's shapes.  → the kernel
    record at the pipeline forest's deepest level."""
    import torch

    B = 32
    main = [  # (tag, n, d, S, T, LN)
        ("rf20 root", TREE_N, 8, 3, 20, 1),
        ("rf20 depth 5", TREE_N, 8, 3, 20, 32),
        ("pipeline RF regressor depth 5", 1_400_000, 4, 3, 20, 32),
        ("classification", TREE_N, 4, 2, 20, 16),
    ]
    times = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count if DEV == "cuda" else 132
    for i, (tag, n, d, S, T, LN) in enumerate(main):
        ins = k3_inputs(n, d, S, T, LN, B, seed=10 + i)
        err, _ = k3_check(H, *ins, LN, B, tag)
        t = k3_time(H, *ins, LN, B, reps=10)
        times[tag] = (t, err)
        per_sm = H.occupancy(torch.device(DEV), d, S, B, LN, T) if DEV == "cuda" else None
        plan = H.hist_plan(n, d, S, B, LN, T, sms, per_sm)
        say(f"K3 {tag} (n={n} d={d} S={S} T={T} LN={LN} B={B}): {t['ms']:.4f} ms "
            f"(plain {t['plain_ms']:.4f}, library {t['library_ms']:.4f}, bound "
            f"{t['bound_ms']:.4f} by {t['bound_by']}); plan: TB {plan['TB']}, blocks_x "
            f"{plan['blocks_x']} x {plan['n_tgroups']} tree groups x "
            f"{plan['n_ptiles'] * plan['n_ftiles']} tiles, {plan['warps']} warps, "
            f"{plan['smem']} shared bytes, {plan['per_sm']} resident an SM, "
            f"{plan['waves']} wave(s); integer stats exact, two launches bit-identical — ok")
        del ins

    # fractional weights and stats at rf20's root and in the edge shapes
    worst = 0.0
    _, rel = k3_check(H, *k3_inputs(TREE_N, 8, 3, 20, 1, B, seed=20, integer=False), 1, B,
                      "rf20 root, fractional")
    worst = max(worst, rel)
    edges = [  # (tag, n, d, S, T, LN, B, kind)
        ("n=0", 0, 8, 3, 2, 4, 32, "int"),
        ("n=1", 1, 8, 3, 2, 1, 32, "int"),
        ("all rows off the frontier", 5000, 8, 3, 3, 4, 32, "off"),
        ("all w=0", 5000, 8, 3, 3, 4, 32, "w0"),
        ("d=1", 40_001, 1, 3, 5, 8, 32, "frac"),
        ("d=100", 20_003, 100, 3, 3, 2, 32, "frac"),
        ("B=2", 30_001, 8, 3, 4, 8, 2, "int"),
        ("S=5", 30_001, 8, 5, 4, 8, 32, "int"),
        ("LN=1024 (node tiles)", 200_000, 8, 3, 2, 1024, 32, "int"),
        ("LN=1024, d=1, B=2, S=1, T=6 (TB=3)", 100_003, 1, 1, 6, 1024, 2, "frac"),
        ("T=7 (TB=4, a last group of 3 trees)", 60_001, 8, 3, 7, 2, 32, "frac"),
        ("n=300,007 (ragged last tile), fractional", 300_007, 8, 3, 4, 8, 32, "frac"),
    ]
    for i, (tag, n, d, S, T, LN, b, kind) in enumerate(edges):
        binned, base, w, pos = k3_inputs(max(n, 0), d, S, T, LN, b, seed=30 + i,
                                         integer=kind != "frac")
        if kind == "off":
            pos = torch.full_like(pos, -1)
        if kind == "w0":
            w = torch.zeros_like(w)
        _, rel = k3_check(H, binned, base, w, pos, LN, b, tag)
        if kind == "frac":
            worst = max(worst, rel)
        if kind in ("off", "w0") or n == 0:
            check(not bool(H.fused_level_hist(binned, base, w, pos, LN, b).any()),
                  f"K3 {tag}: expected an all-zero histogram")
    say(f"K3 edge shapes {[e[0] for e in edges]}: ok; largest relative error of a "
        f"fractional bin against the float64 plain version {worst:.3g} (limit 1e-5)")

    t, err = times["pipeline RF regressor depth 5"]
    return {"name": "fused_level_hist", "route": "cuda",
            "source": f"{PKG}/csrc/tree_hist.cu", "replaces": f"{JAX_KERNELS}:335",
            "launches": 0, "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]}


# ------------------------------------------------------------ SQL window
def compiled_route(tag: str) -> None:
    """The last SQL dispatch ran on the compiled route, with no reasons:
    a runtime fall back to the interpreter cannot pass."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import sql

    d = sql.last_dispatch()
    check(d is not None and d.route == "compiled" and d.reasons == (),
          f"{tag}: the query did not run compiled ({d})")


def table_mismatch(got, want, exact: bool) -> str | None:
    """None when two Tables agree: names, rows, dtypes, null masks, and
    values — floats exactly, or within the JAX fuzz harness's rtol 1e-9,
    atol 1e-12 when ``exact`` is false."""
    import numpy as np

    if list(got.columns) != list(want.columns):
        return f"columns {list(got.columns)} != {list(want.columns)}"
    if len(got) != len(want):
        return f"{len(got)} rows != {len(want)}"
    for c in want.columns:
        x, y = got[c], want[c]
        if x.dtype != y.dtype:
            return f"{c}: dtype {x.dtype} != {y.dtype}"
        if x.dtype.kind == "f":
            if not np.array_equal(np.isnan(x), np.isnan(y)):
                return f"{c}: null masks differ"
            same = (np.array_equal(x, y, equal_nan=True) if exact else
                    np.allclose(x, y, rtol=SQL_RTOL, atol=SQL_ATOL, equal_nan=True))
        elif x.dtype.kind == "M":
            same = np.array_equal(x.view(np.int64), y.view(np.int64))
        else:
            same = np.array_equal(x, y)
        if not same:
            return f"{c}: values differ"
    return None


class StageEvents:
    """A clock for the compiled SQL runners: CUDA events around each stage
    they open (``transfer``, ``sql``); ``ms()`` → device ms per stage."""

    def __init__(self):
        self.events = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        import torch

        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        try:
            yield
        finally:
            e.record()
            self.events[name] = (s, e)

    def ms(self) -> dict:
        sync()
        return {k: s.elapsed_time(e) for k, (s, e) in self.events.items()}


def host_ms(fn):
    """(result, host ms) of ``fn()``, ending with the card idle."""
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def sql_window(port, card: str) -> None:
    """The reference's window query (``SELECT * … WHERE event_time
    BETWEEN …``) over 10M rows spread over the whole day, compiled on the
    card: once with mode="compile" (the device column cache misses), once
    in auto mode (it hits and transfers nothing), equal to the port's
    interpreter on every column; its transfer, on-card and ``to_table``
    times on a cold copy of the table.  Then a per-hospital GROUP BY and a
    whole-partition window, compiled against the interpreter at the JAX
    fuzz harness's tolerance."""
    import numpy as np

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import (
        sql,
        sql_compile,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.sql_parse import parse
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.sql_plan import (
        plan_query,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.obs.registry import (
        global_registry,
    )

    t0 = time.perf_counter()
    table = port.Table.from_dict(hospital_events(SQL_N // 5, seed=11, whole_day=True),
                                 port.hospital_event_schema())
    cfg = port.PipelineConfig()
    name = cfg.output_table

    def resolve(_name):
        return table

    q = (f"SELECT * FROM {name} WHERE event_time BETWEEN "
         f"'{cfg.training_window_start}' AND '{cfg.training_window_end}'")
    say(f"sql_window data: {SQL_N} rows of the example generator's law over the whole day "
        f"in {time.perf_counter() - t0:.2f} s")

    def cache_counts():
        c = global_registry().collect()["counters"]
        return c.get("sql.cache.device.miss", 0), c.get("sql.cache.device.hit", 0)

    miss0, hit0 = cache_counts()
    compiled, first_ms = host_ms(lambda: sql.execute(q, resolve, mode="compile", device=DEV))
    compiled_route("window query, mode=compile")
    miss1, hit1 = cache_counts()
    check((miss1 - miss0, hit1 - hit0) == (1, 0),
          f"first run: {miss1 - miss0} cache misses, {hit1 - hit0} hits (expected 1, 0)")
    again, rerun_ms = host_ms(lambda: sql.execute(q, resolve, device=DEV))
    compiled_route("window query, auto mode")
    miss2, hit2 = cache_counts()
    check((miss2 - miss1, hit2 - hit1) == (0, 1),
          f"rerun: {miss2 - miss1} cache misses, {hit2 - hit1} hits (expected 0, 1)")
    interp, interp_ms = host_ms(lambda: sql.execute(q, resolve, mode="interpret"))
    for out, tag in ((compiled, "mode=compile"), (again, "auto mode")):
        bad = table_mismatch(out, interp, exact=True)
        check(bad is None, f"window query {tag} vs the interpreter: {bad}")
    share = len(compiled) / SQL_N
    check(abs(share - 3601 / 86_400) < 0.02 * 3601 / 86_400,
          f"the window kept {share:.5f} of the rows, not about 1/24")

    # the breakdown, on a cold copy of the table (same columns, empty cache)
    plan = plan_query(parse(q), resolve)
    cold = port.Table(table.schema, dict(table.columns))
    clock = StageEvents()
    view = sql_compile.run_rowlevel(plan, cold, clock, device=DEV)
    cold_ms = clock.ms()
    host, to_table_ms = host_ms(view.to_table)
    check(table_mismatch(host, interp, exact=True) is None, "to_table differs from the interpreter")
    clock = StageEvents()
    sql_compile.run_rowlevel(plan, cold, clock, device=DEV)
    warm_ms = clock.ms()
    ops_ms = gpu_ms(lambda: sql_compile.run_rowlevel(plan, cold, device=DEV), reps=20)
    # the filter's least time: read the int64 column once, write the mask once
    bound = (8 + 1) * SQL_N / HBM_BYTES_PER_S * 1e3
    record = {
        "rows": SQL_N, "window_rows": len(compiled),
        "compile_first_ms": first_ms, "auto_rerun_ms": rerun_ms, "interpreter_ms": interp_ms,
        "transfer_miss_ms": cold_ms["transfer"], "transfer_hit_ms": warm_ms["transfer"],
        "torch_ops_ms": cold_ms["sql"], "torch_ops_mean_ms": ops_ms, "to_table_ms": to_table_ms,
        "filter_bound_ms": bound,
    }
    say(f"sql_window: the window query over {SQL_N} rows compiled on the card (route compiled, "
        f"no reasons; rerun hit the device column cache) == interpreter on every column, "
        f"{len(compiled)} rows kept")
    say(f"sql_window times on {card} (ms; CUDA events for transfer and torch ops, host clock "
        f"otherwise): {json.dumps(record)}")

    agg_q = (f"SELECT hospital_id, COUNT(*) AS n, SUM(length_of_stay) AS los_sum, "
             f"AVG(length_of_stay) AS los_avg, MIN(current_occupancy) AS occ_min, "
             f"MAX(current_occupancy) AS occ_max FROM {name} GROUP BY hospital_id")
    win_q = (f"SELECT length_of_stay, AVG(length_of_stay) OVER (PARTITION BY emergency_visits) "
             f"AS los_by_er FROM {name}")
    for tag, qq, rows in (("per-hospital aggregate", agg_q, 5), ("whole-partition window", win_q, SQL_N)):
        got, c_ms = host_ms(lambda: sql.execute(qq, resolve, mode="compile", device=DEV))
        compiled_route(tag)
        want, i_ms = host_ms(lambda: sql.execute(qq, resolve, mode="interpret"))
        bad = table_mismatch(got, want, exact=False)
        check(bad is None, f"{tag}, compiled vs interpreter: {bad}")
        check(len(got) == rows, f"{tag}: {len(got)} rows, expected {rows}")
        rel = max((float(np.max(np.abs(got[c] - want[c]) / np.maximum(np.abs(want[c]), 1e-300)))
                   for c in want.columns if want[c].dtype.kind == "f"), default=0.0)
        clock = StageEvents()
        sql_compile.run_plan(plan_query(parse(qq), resolve), table, clock, device=DEV)
        say(f"sql_window {tag} on {card}: compiled {c_ms:.1f} ms (rerun stages, CUDA events: "
            f"{json.dumps(clock.ms())}), interpreter {i_ms:.1f} ms; largest relative "
            f"difference {rel:.3g}")
    ts_q = (f"SELECT hospital_id, MIN(event_time) AS first, MAX(event_time) AS last "
            f"FROM {name} GROUP BY hospital_id")
    ex = sql.explain(ts_q, resolve)
    check(ex["route"] == "interpreter", "MIN/MAX over a timestamp planned as compiled")
    say(f"sql_window: MIN/MAX(event_time) per hospital stays on the interpreter, as in the "
        f"JAX planner: {ex['fallback']}")


def stage_on_bundled_csv(port) -> None:
    """The model stage on the bundled 20,000-row CSV (the whole day) on the
    card and on the CPU: classifier trees equal; LR coefficients within
    1e-4 of the largest coefficient (float32 normal equations with a
    condition number near 1e7 move the smallest coefficient by ~1e-3 of
    itself in any two summation orders); regressor RMSE within rtol 1e-4.
    Then with LOS rounded to integers, where every float32 sum is exact:
    every tree equal."""
    import numpy as np

    cfg = port.PipelineConfig(training_window_start=WHOLE_DAY[0],
                              training_window_end=WHOLE_DAY[1])
    table = port.extract_training_window(
        port.read_csv(str(CSV), port.hospital_event_schema()), cfg, device=DEV)
    compiled_route("bundled CSV window")
    check(table.num_rows == 20_000, f"bundled CSV window holds {table.num_rows} rows")
    trees = ("DecisionTreeRegressor", "RandomForestRegressor",
             "DecisionTreeClassifier", "RandomForestClassifier")

    def same_tree(a, b):
        return (np.array_equal(a.split_feat, b.split_feat)
                and np.array_equal(a.threshold, b.threshold)
                and np.array_equal(a.value, b.value))

    for rounded in (False, True):
        t = table
        if rounded:
            t = t.with_column("length_of_stay", np.round(t["length_of_stay"]), dtype="float")
        card = port.run_model_stage(t, cfg, device=DEV)
        cpu = port.run_model_stage(t, cfg, device="cpu")
        tag = "integer LOS" if rounded else "bundled CSV"
        for name in (trees if rounded else trees[2:]):
            check(same_tree(card.models[name], cpu.models[name]),
                  f"{tag}: {name} grown on the card differs from the CPU's")
        cc = card.models["LinearRegression"]
        pc = cpu.models["LinearRegression"]
        a = np.r_[cc.coefficients.cpu().numpy(), float(cc.intercept)]
        b = np.r_[pc.coefficients.numpy(), float(pc.intercept)]
        check(np.abs(a - b).max() <= 1e-4 * np.abs(b).max(),
              f"{tag}: LR coefficients {a} vs CPU {b}")
        for name, v in card.regression_rmse.items():
            check(abs(v - cpu.regression_rmse[name]) <= 1e-4 * cpu.regression_rmse[name],
                  f"{tag}: {name} RMSE {v} vs CPU {cpu.regression_rmse[name]}")
        # equal trees give equal per-tree outputs; the forest's float32 mean
        # over 20 trees is summed in another order on the card, which may
        # flip a row whose two class means tie to the last bit
        n_test = table.num_rows - round(0.7 * table.num_rows)
        for name, v in card.classification_accuracy.items():
            slack = 0.0 if name.startswith("DecisionTree") else 2.0 / n_test
            check(abs(v - cpu.classification_accuracy[name]) <= slack + 1e-12,
                  f"{tag}: {name} accuracy {v} vs CPU {cpu.classification_accuracy[name]}")
        say(f"model stage, {tag} ({card.training_rows} rows, card == CPU): RMSE "
            f"{json.dumps(card.regression_rmse)}; accuracy "
            f"{json.dumps(card.classification_accuracy)}")
        if not rounded:
            say(f"  feature importances {json.dumps(card.feature_importances)}")


def hospital_events(n_per_hospital: int, seed: int = 7, whole_day: bool = False):
    """The example generator's law (``examples/run_hospital_pipeline.py``
    ``generate_events``): 5 hospitals, events in 22:00–23:00 (or over the
    whole day), LOS linear in the 4 features plus noise — built in
    memory."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = np.datetime64("2025-03-31T00:00:00" if whole_day else "2025-03-31T22:00:00")
    span_s = 86_400 if whole_day else 3600
    cols = {k: [] for k in ("hospital_id", "event_time", "admission_count",
                            "current_occupancy", "emergency_visits",
                            "seasonality_index", "length_of_stay")}
    for h in range(5):
        n = n_per_hospital
        adm = rng.integers(0, 50, n)
        occ = rng.integers(20, 400, n)
        emg = rng.integers(0, 30, n)
        sea = rng.uniform(0.5, 1.5, n)
        los = 0.05 * adm + 0.008 * occ + 0.12 * emg + 2.0 * sea + rng.normal(0.0, 0.4, n)
        cols["hospital_id"].append(np.array([f"H{h:02d}"] * n, dtype=object))
        cols["event_time"].append(base + rng.integers(0, span_s, n).astype("timedelta64[s]"))
        for k, v in (("admission_count", adm), ("current_occupancy", occ),
                     ("emergency_visits", emg), ("seasonality_index", sea),
                     ("length_of_stay", los)):
            cols[k].append(v)
    return {k: np.concatenate(v) for k, v in cols.items()}


class K3Events:
    """CUDA events around every K3 launch the tree engine makes while the
    context is open (``engine.fused_level_hist`` wrapped).  ``ms()`` →
    each launch's device time, after a sync."""

    def __enter__(self):
        import torch

        from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models.tree import (
            engine,
        )

        self.engine, self.hist, self.events = engine, engine.fused_level_hist, []

        def timed_hist(*a, **k):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = self.hist(*a, **k)
            e.record()
            self.events.append((s, e))
            return out

        engine.fused_level_hist = timed_hist
        return self

    def __exit__(self, *exc):
        self.engine.fused_level_hist = self.hist

    def ms(self) -> list[float]:
        sync()
        return [s.elapsed_time(e) for s, e in self.events]


def stage_at_scale(port, H, save_dir: str):
    """The model stage on 2M rows of the example generator's law, on the
    card: 6 K3 launches per depth-5 tree fit, 24 in the stage; its models
    saved under ``save_dir`` (§11).  → (the K3 launches of this run, the
    stage's result, its test rows on the card)."""
    import numpy as np

    t0 = time.perf_counter()
    cfg = port.PipelineConfig()
    table = port.extract_training_window(
        port.Table.from_dict(hospital_events(TREE_N // 5), port.hospital_event_schema()),
        cfg, device=DEV)
    compiled_route("stage window")
    check(table.num_rows == TREE_N, f"generator gave {table.num_rows} rows in the window")
    say(f"stage data: {TREE_N} rows of the example generator's law in "
        f"{time.perf_counter() - t0:.2f} s")
    H.reset_launch_counts()
    t0 = time.perf_counter()
    with K3Events() as k3:
        res = port.run_model_stage(table, cfg.replace(model_save_path=save_dir),
                                   device=DEV, save_models=True)
    # the stage's own window, as before §11's saves: they are timed apart
    save_s = sum(v for k, v in res.seconds.items() if k.startswith("save:"))
    stage_s = time.perf_counter() - t0 - save_s
    launches = H.launch_counts()["fused_level_hist"]
    check(launches == 24, f"K3 launched {launches} times in the stage (expected 6 x 4 = 24)")
    k3_ms = k3.ms()
    check(len(k3_ms) == launches, f"{len(k3_ms)} K3 launches timed of {launches}")
    for v in (*res.regression_rmse.values(), *res.classification_accuracy.values()):
        check(np.isfinite(v) and v > 0, f"stage metric {v} not finite")
    check(res.regression_rmse["LinearRegression"] < 0.45,
          f"LR RMSE {res.regression_rmse['LinearRegression']} far above the noise (0.4)")
    for name, imp in res.feature_importances.items():
        check(abs(sum(imp.values()) - 1.0) < 1e-5, f"{name} importances do not sum to 1")
    secs = ", ".join(f"{k} {v:.3f} s" for k, v in res.seconds.items())
    say(f"model stage at scale ({res.training_rows} rows, {stage_s:.2f} s, then its "
        f"saves {save_s:.3f} s, K3 launches {launches}): {secs}")
    say(f"  RMSE {json.dumps(res.regression_rmse)}; accuracy "
        f"{json.dumps(res.classification_accuracy)}")
    say(f"  K3 on the stage's data, {launches} launches (CUDA events; per tree fit, levels "
        f"0-5): {[round(t, 4) for t in k3_ms]} ms = {sum(k3_ms):.3f} ms")
    # the stage's own test rows: its Binarizer, seed-42 split and assembler
    binarized = port.Binarizer(port.LABEL_COL, "LOS_binary", cfg.los_threshold).transform(table)
    _, test_t = port.train_test_split(binarized, cfg.train_fraction, cfg.split_seed)
    test_x = port.VectorAssembler(port.FEATURE_COLS).transform(test_t).to_device(device=DEV).x
    return launches, res, test_x


def serve_requests(srv, name: str, x_host, pred_h) -> dict:
    """16 requests of ``REQUEST_SIZES`` rows from 4 client threads to a
    started server; each answer must be ok and equal to ``pred_h`` on its
    rows.  → the server's stats."""
    import numpy as np

    jobs, s = [], 0
    for i in range(16):
        m = REQUEST_SIZES[i % len(REQUEST_SIZES)]
        jobs.append((s, m))
        s += m
    answers = {}

    def client(ids):
        for j in ids:
            st, m = jobs[j]
            answers[j] = srv.predict(name, x_host[st : st + m])

    threads = [threading.Thread(target=client, args=(range(t, 16, 4),)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    check(not any(th.is_alive() for th in threads), "serving clients did not finish")
    for j, (st, m) in enumerate(jobs):
        r = answers.get(j)
        check(r is not None and r.status == "ok", f"request {j} answered {r and r.status}")
        check(np.array_equal(r.value, pred_h[st : st + m]), f"request {j} disagrees with predict")
    return srv.stats()


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def artifacts(port, L, tmp: str, stage, model, scaler, ds, pred, head: dict, card: str) -> int:
    """Model artifacts on the card, written under ``tmp``: the stage's
    saved models loaded back and predicting ``torch.equal`` to the fitted
    ones on the stage's test rows; the KMeans k=256 model and its scaler
    saved and loaded, predicting the 10M rows, serving from the saved
    directory and transforming a Table (K2); a save killed at each site
    leaving the previous artifact; a flipped and a truncated payload
    refused.  → K2's launches in this phase."""
    import numpy as np
    import torch

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.io.model_io import (
        save_model,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults

    _, res, test_x = stage
    L.reset_launch_counts()
    record = {}
    for name, path in res.model_paths.items():
        t0 = time.perf_counter()
        loaded = port.load_model(path)
        load_s = time.perf_counter() - t0
        want, got = res.models[name].predict(test_x), loaded.predict(test_x)
        sync()
        check(got.device == test_x.device and torch.equal(got, want),
              f"loaded {name} predicts otherwise than the fitted model on the test rows")
        record[name] = {"save_s": res.seconds[f"save:{name}"], "load_s": load_s,
                        "bytes": dir_bytes(path)}
    say(f"artifacts: the stage's {len(record)} models saved and loaded back, each "
        f"predicting torch.equal to the fitted model on {test_x.shape[0]} test rows")

    km_dir, sc_dir = os.path.join(tmp, "kmeans256"), os.path.join(tmp, "scaler")
    t0 = time.perf_counter()
    model.write().overwrite().save(km_dir)
    km_save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_model(sc_dir, *scaler._artifacts())
    sc_save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    km = port.load_model(km_dir)
    km_load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sc = port.load_model(sc_dir)
    sc_load_s = time.perf_counter() - t0
    record[f"KMeansModel k={model.k}"] = {"save_s": km_save_s, "load_s": km_load_s,
                                   "bytes": dir_bytes(km_dir)}
    record["StandardScalerModel"] = {"save_s": sc_save_s, "load_s": sc_load_s,
                                     "bytes": dir_bytes(sc_dir)}
    check(np.array_equal(km.cluster_centers, model.cluster_centers)
          and np.array_equal(km.cluster_sizes, model.cluster_sizes)
          and (km.n_iter, km.training_cost) == (model.n_iter, model.training_cost),
          "loaded KMeans model differs from the fitted one")
    check(np.array_equal(sc.mean, scaler.mean) and np.array_equal(sc.std, scaler.std),
          "loaded scaler differs from the fitted one")
    t0 = time.perf_counter()
    before = L.launch_counts()["fused_assign"]
    again = km.predict(ds.x)
    sync()
    predict_s = time.perf_counter() - t0
    check(L.launch_counts()["fused_assign"] > before, "the loaded model's predict did not launch K2")
    check(torch.equal(again, pred), "the loaded model's predict differs from the fitted model's")
    x_host, pred_h = ds.x[:1024].cpu().numpy(), pred[:1024].cpu().numpy()
    before = L.launch_counts()["fused_assign"]
    srv = port.serve.InferenceServer(device=DEV)
    srv.add_model("kmeans256", km_dir, buckets=BUCKETS)   # ModelRegistry.load
    with srv:
        stats = serve_requests(srv, "kmeans256", x_host, pred_h)
    check(L.launch_counts()["fused_assign"] > before, "serving the loaded model did not launch K2")
    check(stats["recompiles"] == 0, "serving met a shape outside the warmed buckets")
    say(f"artifacts: KMeans k={model.k} and its scaler saved and loaded; predict on "
        f"{ds.x.shape[0]} rows {predict_s * 1e3:.2f} ms, torch.equal to the fitted model's; "
        f"served from its directory: 16 requests equal to predict")

    t0 = time.perf_counter()
    table = port.Table.from_dict(head)
    scaled = sc.transform(port.VectorAssembler(list(head)).transform(table))
    before = L.launch_counts()["fused_assign"]
    out = km.transform(scaled, device=DEV)
    transform_s = time.perf_counter() - t0
    check(L.launch_counts()["fused_assign"] > before, "transform did not launch K2")
    check(isinstance(out, port.Table) and out.schema.names == [*table.schema.names, "prediction"]
          and out.schema.field("prediction").dtype == "int",
          f"transform gave {type(out).__name__} {getattr(out, 'schema', None)}")
    rows = torch.from_numpy(scaled.features.astype(np.float32)).to(ds.x.device)
    want = km.predict(rows).cpu().numpy()
    check(np.array_equal(out["prediction"], want), "transform's prediction column differs from predict")
    same = float((out["prediction"] == pred[: len(want)].cpu().numpy()).mean())
    say(f"artifacts: Table of {table.num_rows} rows -> VectorAssembler -> loaded scaler -> "
        f"loaded KMeansModel.transform: a Table with an int prediction column equal to "
        f"predict, in {transform_s:.2f} s (host scaling; {same:.6f} of rows as the card-scaled "
        f"predict)")

    changed = port.KMeansModel(model.cluster_centers + np.float32(1.0), n_iter=model.n_iter)
    sub = ds.x[:TRANSFORM_N]
    for site in SAVE_SITES:
        plan = faults.FaultPlan().crash(site)
        crashed = None
        with faults.active(plan):
            try:
                changed.write().overwrite().save(km_dir)
            except faults.InjectedCrash as e:
                crashed = e.site
        check(crashed == site and plan.fired(site) == 1, f"the save did not die at {site}")
        back = port.load_model(km_dir)
        check(np.array_equal(back.cluster_centers, model.cluster_centers),
              f"a save killed at {site} lost the previous artifact")
        check(torch.equal(back.predict(sub), pred[:TRANSFORM_N]),
              f"the artifact left by a save killed at {site} predicts otherwise")
    say(f"artifacts: a save killed at each of {list(SAVE_SITES)} left the previous "
        f"artifact, predicting as before on {sub.shape[0]} rows")

    for kind, expect in (("bit flip", "crc32c mismatch"), ("truncation", "size mismatch")):
        d = os.path.join(tmp, kind.replace(" ", "_"))
        model.save(d)
        f = os.path.join(d, "arrays.npz")
        data = bytearray(Path(f).read_bytes())
        if kind == "bit flip":
            data[len(data) // 2] ^= 0xFF
        else:
            del data[len(data) // 2 :]
        Path(f).write_bytes(bytes(data))
        err = ""
        try:
            port.load_model(d)
        except port.CorruptArtifactError as e:
            err = str(e)
        check(expect in err, f"a {kind} of arrays.npz was not refused ({err!r})")
    say("artifacts: a bit flip and a truncation of arrays.npz each raise CorruptArtifactError")

    launches = L.launch_counts()["fused_assign"]
    say(f"artifacts on {card} (host seconds; K2 launches {launches}): {json.dumps(record)}")
    return launches


def rf20(port) -> None:
    """rf20: RandomForestRegressor(num_trees=20, max_depth=5, all features,
    seed 0) on bench.py's 2M x 8 generator: fit time and rows/s, the fit's
    breakdown, predict time and RMSE, the level loop under
    ``set_sync_debug_mode("error")``, and the card-vs-CPU Poisson draw."""
    import numpy as np
    import torch

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import prng
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models.tree import (
        engine,
    )

    d = 8
    rng = np.random.default_rng(0)
    x = make_table_columns(TREE_N, d, 16, 0)
    x = np.stack([x[f"f{j}"] for j in range(d)], axis=1)
    x = ((x - x.mean(axis=0)) / x.std(axis=0)).astype(np.float32)
    y = (x @ rng.normal(size=(d,)) + rng.normal(0.0, 0.3, size=TREE_N)).astype(np.float32)
    ds = port.device_dataset(x, y, device=DEV)
    est = port.RandomForestRegressor(num_trees=20, max_depth=5,
                                     feature_subset_strategy="all", seed=0)
    est.fit(ds)                                    # warm-up
    sync()
    t0 = time.perf_counter()
    model = est.fit(ds)
    fit_s = time.perf_counter() - t0
    # the breakdown: each step of a timed fit ends with a sync, and CUDA
    # events around every K3 launch give K3's share of the level loop
    timings: dict = {}
    with K3Events() as k3:
        engine.grow_forest(ds, task="regression", num_trees=20, max_depth=5, bootstrap=True,
                           seed=0, timings=timings)
    k3_ms = k3.ms()
    total_ms = sum(timings.values()) * 1e3
    parts = ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in timings.items())
    parts += (f"; K3 {len(k3_ms)} launches {[round(t, 3) for t in k3_ms]} ms = "
              f"{sum(k3_ms):.1f} ms ({100 * sum(k3_ms) / total_ms:.1f}% of the timed fit's "
              f"{total_ms:.1f} ms)")
    t0 = time.perf_counter()
    pred = model.predict(ds.x)
    sync()
    pred_ms = (time.perf_counter() - t0) * 1e3
    rmse = port.RegressionEvaluator().evaluate(
        port.PredictionResult(prediction=pred, label=ds.y, weight=ds.w))
    check(np.isfinite(rmse) and rmse < float(y.std()), f"rf20 RMSE {rmse} not below std(y)")
    say(f"rf20 fit: {fit_s:.3f} s, {TREE_N / fit_s:.4g} rows/s; breakdown (timed run): {parts}")
    say(f"rf20 predict: {pred_ms:.2f} ms over {TREE_N} rows, RMSE {rmse:.6f}")

    # the level loop makes no host sync
    loop = engine._level_loop

    def guarded(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return loop(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    engine._level_loop = guarded
    try:
        again = est.fit(ds)
        # and the per-node feature-subset draw the pipeline's forests make
        port.RandomForestRegressor(num_trees=20, max_depth=5, seed=0).fit(ds)
    finally:
        engine._level_loop = loop
    check(np.array_equal(again.split_feat, model.split_feat)
          and np.array_equal(again.threshold, model.threshold),
          "rf20 refit under the sync check grew another forest")
    say("rf20 level loop (all features, and onethird subsets) under "
        "torch.cuda.set_sync_debug_mode('error'): no host sync")

    a = prng.poisson(prng.key(0), 1.0, (20, 100_000), DEV).cpu()
    b = prng.poisson(prng.key(0), 1.0, (20, 100_000), "cpu")
    say(f"Poisson(1) draw (20, 100000), card vs CPU: {int((a != b).sum())} entries differ")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the card")
    if not (ROOT / PKG / "csrc" / "lloyd.cu").is_file():
        fail(f"the port package {PKG}/ is not beside this script")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import ops
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import _build
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import lloyd as L
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import tree_hist as H

    check(not any(m.split(".")[0] in (JAX_KERNELS.split("/")[0], "jax") for m in sys.modules),
          "the port pulled in jax or the JAX package")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"torch {torch.__version__} CUDA {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    libs = _build.build()
    say(f"kernel build: {time.perf_counter() - t0:.1f} s into {_build.build_dir()} "
        f"({', '.join(p.name for p in libs.values())})")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        if log.exists():
            for fn, usage in ptxas_usage(log.read_text()):
                say(f"  ptxas[{name}] {fn}: {usage}")

    # ------------------------------------------------- kernel vs plain
    records = kernel_case(L, N, D, K, 0, seed=1, reps=20)
    # K2's other shapes on the main path: a bulk_score chunk, a served batch
    records[1]["shapes"] = [k2_case(L, 262_144, D, K, seed=4, reps=20),
                            k2_case(L, 200, D, K, seed=5, reps=200)]
    kernel_case(L, 1_000_003, D, 16, 3, seed=2, reps=10, dup=True)
    kernel_case(L, 1_000_000, 64, 1024, 0, seed=3, reps=5)
    edge_cases(L)
    records.append(k3_phase(H))

    # ----------------------------------------------------------- main path
    t0 = time.perf_counter()
    cols = make_table_columns(N, D, K, SEED)
    table = port.Table.from_dict(cols)
    head = {k: v[:TRANSFORM_N].copy() for k, v in cols.items()}   # the artifacts phase
    del cols
    assembled = port.VectorAssembler([f"f{j}" for j in range(D)]).transform(table)
    on_card = assembled.to_device(device="cuda")
    scaler = port.StandardScaler().fit(on_card)
    ds = scaler.transform(on_card)
    del on_card
    torch.cuda.synchronize()
    check(ds.x.is_cuda and tuple(ds.x.shape) == (N, D) and ds.x.dtype == torch.float32,
          "scaled features are not an (n, 8) float32 tensor on the card")
    col_mean = ds.x.mean(0).abs().max().item()
    col_std_err = (ds.x.std(0) - 1).abs().max().item()
    check(col_mean < 1e-3 and col_std_err < 1e-3, "StandardScaler output is not standardized")
    say(f"data: {N} x {D} rows from seed {SEED} -> Table -> VectorAssembler -> "
        f"StandardScaler on the card ({ds.x.numel() * 4 / 1e6:.0f} MB) in "
        f"{time.perf_counter() - t0:.1f} s")
    del table, assembled

    L.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = port.KMeans(k=K, seed=SEED, max_iter=MAX_ITER).fit(ds)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    after_fit = L.launch_counts()
    check(after_fit["fused_lloyd_stats"] == model.n_iter + 1,
          f"K1 launched {after_fit['fused_lloyd_stats']} times over a fit of "
          f"{model.n_iter} steps (expected n_iter + 1)")
    check(np.isfinite(model.training_cost) and model.training_cost > 0, "training cost not finite")
    check(model.cluster_centers.shape == (K, D) and np.isfinite(model.cluster_centers).all(),
          "centers not finite (256, 8)")
    check(float(model.cluster_sizes.sum()) == N, "cluster sizes do not sum to n")
    say(f"fit: KMeans(k={K}, max_iter={MAX_ITER}) {fit_s:.3f} s, n_iter={model.n_iter}, "
        f"{N * model.n_iter / fit_s:.4g} Lloyd records/s, training_cost={model.training_cost:.8g}")
    # where the fit's time goes: the host k-means++ init, re-run alone
    # (deterministic, launches nothing)
    t0 = time.perf_counter()
    port.KMeans(k=K, seed=SEED, max_iter=MAX_ITER)._init_centers(ds)
    init_s = time.perf_counter() - t0
    k1_s = after_fit["fused_lloyd_stats"] * records[0]["ms"] / 1e3
    say(f"fit breakdown: host sample + k-means++ init, timed alone, {init_s:.3f} s; "
        f"K1 on the card {after_fit['fused_lloyd_stats']} x {records[0]['ms']:.3f} ms "
        f"= {k1_s:.3f} s ({100 * k1_s / fit_s:.1f}% of the fit)")

    t0 = time.perf_counter()
    pred = model.predict(ds.x)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    after_predict = L.launch_counts()
    check(after_predict["fused_assign"] > after_fit["fused_assign"], "predict did not launch K2")
    pred_h = pred.cpu().numpy()
    check(pred_h.shape == (N,) and pred_h.min() >= 0 and pred_h.max() < K, "predictions out of range")
    check(np.array_equal(np.bincount(pred_h, minlength=K), model.cluster_sizes.astype(np.int64)),
          "predict disagrees with the fit's final assignment")
    t0 = time.perf_counter()
    sil = port.ClusteringEvaluator().evaluate(ds, pred, k=K)
    sil_s = time.perf_counter() - t0
    check(np.isfinite(sil) and 0.0 < sil <= 1.0, f"silhouette {sil} not in (0, 1]")
    say(f"predict: {predict_s * 1e3:.2f} ms; silhouette {sil:.6f} in {sil_s:.2f} s")

    # -------------------------------------------------------------- serving
    x_host = ds.x.cpu().numpy()
    srv = port.serve.InferenceServer(device="cuda")
    srv.add_model("kmeans256", model, buckets=BUCKETS)
    with srv:
        before_serve = L.launch_counts()["fused_assign"]
        stats = serve_requests(srv, "kmeans256", x_host, pred_h)
    check(L.launch_counts()["fused_assign"] > before_serve, "serving did not launch K2")
    check(stats["recompiles"] == 0, "serving met a shape outside the warmed buckets")
    say(f"serving: 16 requests of {REQUEST_SIZES} rows from 4 clients, all ok and "
        f"equal to predict; p50 {stats['latency_p50_ms']} ms, p99 {stats['latency_p99_ms']} ms "
        f"(of 16 requests: a smoke reading, no tail), "
        f"batch fill {stats['batch_fill_ratio']}")

    t0 = time.perf_counter()
    scored = port.serve.bulk_score(model, x_host, device="cuda")
    bulk_s = time.perf_counter() - t0
    check(np.array_equal(scored, pred_h), "bulk_score disagrees with predict")
    counts = ops.launch_counts()          # K3's entry is set by its own path below
    say(f"bulk_score: {N} rows in {bulk_s:.2f} s, equal to predict")

    # ---------------------------- the fit against the plain path, small input
    sub = x_host[:20_000]
    on_card = port.KMeans(k=16, seed=SEED, max_iter=10).fit(sub, device="cuda")
    on_cpu = port.KMeans(k=16, seed=SEED, max_iter=10).fit(sub, device="cpu")
    check(on_card.n_iter == on_cpu.n_iter and np.array_equal(on_card.cluster_sizes, on_cpu.cluster_sizes),
          "kernel fit and plain fit disagree on a 20k-row input")
    check(np.allclose(on_card.cluster_centers, on_cpu.cluster_centers, rtol=1e-5, atol=1e-5),
          "kernel fit centers disagree with the plain fit")
    say(f"small-input reference: card fit == CPU plain fit (n_iter {on_card.n_iter})")

    # ------------------------------------- the SQL window on the card
    sql_window(port, card)

    # ---------------------------------------------- the model stage (K3)
    stage_on_bundled_csv(port)
    with tempfile.TemporaryDirectory() as tmp:
        stage = stage_at_scale(port, H, os.path.join(tmp, "hospital"))
        counts["fused_level_hist"] = stage[0]
        # ------------------------------------------ model artifacts (K2)
        # the injected crashes leave their postmortems in the temporary tree
        os.environ["CMLHN_FLIGHT_DIR"] = os.path.join(tmp, "flight")
        counts["fused_assign"] += artifacts(port, L, tmp, stage, model, scaler, ds, pred,
                                            head, card)
        os.environ.pop("CMLHN_FLIGHT_DIR")
        del stage
    rf20(port)

    check(all(v > 0 for v in counts.values()), "a kernel was never launched")
    say(f"kernels launched on the main paths: {json.dumps(counts)}")
    for rec in records:
        rec["launches"] = counts[rec["name"]]
    say(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
