#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (one NVIDIA H100).

    python3 chip_smoke.py

Builds the port's kernels from ``csrc/``, holds each against its plain
PyTorch version on the card, then drives the port's KMeans k=256 path at
full width — 10M standardized 8-feature rows: Table → VectorAssembler →
StandardScaler → KMeans fit → predict → silhouette → an InferenceServer
answering requests → bulk scoring — and shows through the launch
counters that this path ran on the kernels.  Any failed check exits
non-zero before the last line; without a CUDA device, or without the
port's package beside it, the script prints no result and exits 1.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the per-kernel record (launches, error, kernel / plain / library
times and the card's bound for the same work).
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch"
JAX_KERNELS = "clustermachinelearningforhospitalnetworks_apache_spark_tpu/ops/pallas_kernels.py"

N, D, K = 10_000_000, 8, 256
SEED = 0
MAX_ITER = 20
BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
REQUEST_SIZES = (1, 7, 32, 200)

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


def compare(L, x, w, centers, c_valid, tag: str):
    """K2 and K1 against their plain versions on one input.  Assignments
    may differ only at near ties (best two d² within 1e-5 relative); a
    row flipped there moves between clusters in K1 too (both share the
    argmin), so the sums/counts tolerance widens by that much.  Sums at
    rtol 1e-4 (atol 1e-4 x the largest); counts exact under 0/1 weights,
    else as the sums; cost at rtol 1e-6 (read 2.25e-7 at the main shape);
    two K1 launches must agree bit for bit.  → (K1 max abs err, K2 max
    abs err, K1 cost rel err, near-tie flips)."""
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

    def lib_assign():
        return torch.addmm(c_sq[None, :], x, centers.T, alpha=-2.0).add_(x_sq[:, None]).min(dim=1)

    def lib_stats():
        mn, arg = lib_assign()
        arg = arg.to(torch.int64)
        sums = torch.zeros(k, d, device="cuda").index_add_(0, arg, x * w[:, None])
        cnts = torch.zeros(k, device="cuda").index_add_(0, arg, w)
        return sums, cnts, (mn * w).sum()

    plain_reps = max(2, reps // 5)
    t = {
        "k2": gpu_ms(lambda: L.fused_assign(x, centers, c_valid), reps),
        "k2_plain": gpu_ms(lambda: L.fused_assign_plain(x, centers, c_valid), plain_reps),
        "k2_lib": gpu_ms(lib_assign, plain_reps),
        "k1": gpu_ms(lambda: L.fused_lloyd_stats(x, w, centers, c_valid), reps),
        "k1_plain": gpu_ms(lambda: L.fused_lloyd_stats_plain(x, w, centers, c_valid), plain_reps),
        "k1_lib": gpu_ms(lib_stats, plain_reps),
    }
    b1, b1_by = bound_ms(n, d, k, stats=True)
    b2, b2_by = bound_ms(n, d, k, stats=False)
    say(f"kernel vs plain n={n} d={d} k={k} ({k - n_invalid} valid"
        f"{', centers 0 and 1 equal' if dup else ''}): "
        f"K1 {t['k1']:.4f} ms (plain {t['k1_plain']:.4f}, library {t['k1_lib']:.4f}, "
        f"bound {b1:.4f} by {b1_by}; max_abs_err {k1_err:.3g}, cost rel err {cost_rel:.3g}) | "
        f"K2 {t['k2']:.4f} ms (plain {t['k2_plain']:.4f}, library {t['k2_lib']:.4f}, "
        f"bound {b2:.4f} by {b2_by}; max_abs_err {k2_err:.3g}, "
        f"{flips} near-tie flips) — ok")
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


def edge_cases(L) -> None:
    """Small odd shapes, fractional weights: every feature-width template
    (d = 1 … 128), one center, centers tiled with a remainder tile, rows
    that end mid-tile, and n = 0."""
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


def make_table_columns(n: int, d: int, k: int, seed: int):
    """The generator of bench.py (``_make_data``, before its own
    standardization — StandardScaler does that here, on the card)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 4.0, size=(k, d))
    assign = rng.integers(0, k, size=n)
    x = centers[assign] + rng.normal(0.0, 1.0, size=(n, d))
    return {f"f{j}": x[:, j] for j in range(d)}


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
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import _build
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import lloyd as L

    check(not any(m.split(".")[0] == JAX_KERNELS.split("/")[0] for m in sys.modules),
          "the port pulled in the JAX package")
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
            for line in log.read_text().splitlines():
                if "Used" in line or "spill" in line:
                    say(f"  ptxas[{name}] {line.strip()}")

    # ------------------------------------------------- kernel vs plain
    records = kernel_case(L, N, D, K, 0, seed=1, reps=20)
    kernel_case(L, 1_000_003, D, 16, 3, seed=2, reps=10, dup=True)
    kernel_case(L, 1_000_000, 64, 1024, 0, seed=3, reps=5)
    edge_cases(L)

    # ----------------------------------------------------------- main path
    t0 = time.perf_counter()
    cols = make_table_columns(N, D, K, SEED)
    table = port.Table.from_dict(cols)
    del cols
    assembled = port.VectorAssembler([f"f{j}" for j in range(D)]).transform(table)
    ds = port.StandardScaler().fit_transform(assembled, device="cuda")
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
        jobs, s = [], 0
        for i in range(16):
            m = REQUEST_SIZES[i % len(REQUEST_SIZES)]
            jobs.append((s, m))
            s += m
        answers = {}

        def client(ids):
            for j in ids:
                st, m = jobs[j]
                answers[j] = srv.predict("kmeans256", x_host[st : st + m])

        threads = [threading.Thread(target=client, args=(range(t, 16, 4),)) for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        check(not any(th.is_alive() for th in threads), "serving clients did not finish")
        stats = srv.stats()
    for j, (st, m) in enumerate(jobs):
        r = answers.get(j)
        check(r is not None and r.status == "ok", f"request {j} answered {r and r.status}")
        check(np.array_equal(r.value, pred_h[st : st + m]), f"request {j} disagrees with predict")
    check(L.launch_counts()["fused_assign"] > before_serve, "serving did not launch K2")
    check(stats["recompiles"] == 0, "serving met a shape outside the warmed buckets")
    say(f"serving: {len(jobs)} requests of {REQUEST_SIZES} rows from 4 clients, all ok and "
        f"equal to predict; p50 {stats['latency_p50_ms']} ms, p99 {stats['latency_p99_ms']} ms "
        f"(of {len(jobs)} requests: a smoke reading, no tail), "
        f"batch fill {stats['batch_fill_ratio']}")

    t0 = time.perf_counter()
    scored = port.serve.bulk_score(model, x_host, device="cuda")
    bulk_s = time.perf_counter() - t0
    check(np.array_equal(scored, pred_h), "bulk_score disagrees with predict")
    counts = L.launch_counts()
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

    check(counts["fused_lloyd_stats"] > 0 and counts["fused_assign"] > 0, "a kernel was never launched")
    say(f"kernels launched on the main path: {json.dumps(counts)}")
    records[0]["launches"] = counts["fused_lloyd_stats"]
    records[1]["launches"] = counts["fused_assign"]
    say(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
