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
  whole-partition window against the interpreter on every 4th row; and the
  window feeding
  the model stage below (``extract_training_window``);
* model artifacts — the 2M-row stage's five models saved (``save_models``)
  and loaded back, the KMeans k=256 model and its scaler saved and loaded,
  the loaded model predicting the 10M rows, serving the same requests from
  its directory and transforming a 1M-row Table (K2), a save killed at each
  of the three save sites, and a flipped and a truncated payload;
* ``run_pipeline`` end to end — 5 CSV files of 400,000 rows of the example
  generator's law: killed at ``stream.after_sink`` and resumed exactly
  once through the streaming ingest, the checkpointed unbounded table, the
  compiled window and the model stage (K3), with the saves, the report and
  the plots (when matplotlib is installed); equal to ``run_model_stage``
  on the same rows; an idempotent rerun; a sixth file as batch 1, its late
  rows counted against numpy, and the window rerun hitting the snapshot
  memo and the device columns; before it, the three CSV engines (native,
  Arrow, numpy) on the same files, timed, native ``==`` numpy on every
  column, and the resumed run's ingest read by the native engine on every
  file (the per-engine file counts), with its ingest and window steps
  timed apart;
* BASELINE configs 5, 3 and 4 at bench.py's shapes — StreamingKMeans
  k=16 over 12 micro-batches of 100,000 x 8 rows (one K1 launch a batch,
  an update with no host sync, predict through K2), GaussianMixture k=32
  on 10M x 8 rows for 10 EM iterations (non-decreasing log-likelihood,
  peak device memory), BisectingKMeans k=8 on 2M x 8 rows (levels, host
  syncs, predict through K2), each against the CPU route on the same
  rows (a 200,000-row prefix for the last two) within limits that a
  control fails: the same run in TF32, or for BisectingKMeans (float64
  passes) the CPU route on TF32-rounded rows.
* the out-of-core fits (slice 4b) — KMeans k=256 over the 10M rows
  memory-mapped from disk and streamed as ``HostDataset`` blocks of 2**20
  (K1 a block a Lloyd step) against the resident fit, with the epoch
  beside the measured host-to-device rate, K1's share, the copy time the
  double buffer hides and the peak device memory against its bound;
  integer rows bit-equal out of core and resident, a fit preempted by
  ``on_iteration`` and resumed from its checkpoint bit-equal, and one
  64-block epoch equal to the resident K1 pass (the stream-reuse guard);
  cosine KMeans (K2 in predict), GaussianMixture k=32 and
  LinearRegression on 2M rows, and the rf20-shape forest in 8 blocks (K3
  a block a level: splits against the resident forest, per-block
  bootstrap draws against the CPU, a preempt at depth 2 resumed).
* slices 3e and 4c — GBTRegressor at bench.py's gbt20 shape (2M x 8, 20
  rounds, depth 3: K3 at T = 1, 80 launches, timed with CUDA events), its
  boost loop under ``set_sync_debug_mode("error")`` and the fit's host
  syncs, against the CPU route on 200,000 rows (integer labels: the same
  trees; float labels: predictions), GBTClassifier on the stage's
  binarized LOS, a validation fit stopping where the CPU's stops, the boost
  out of core in 8 blocks against resident and a preempted fit resumed;
  LinearRegression's elastic net (resident and out of core) and training
  summary against the CPU route, and its chunked Gram against float64;
  KMeans k=256 on the 10M rows in bf16 (with and without ``fused_stats``)
  and GaussianMixture k=32 in bf16 and "high" against "highest"; and
  BisectingKMeans' cosine and weighted fits and its out-of-core fit in
  blocks of 2^19 against resident and against the CPU (K2 in predict),
  each comparison holding the split tree.  Every card-vs-CPU limit of
  these slices must fail its control (TF32 products, or the route on
  TF32-rounded rows).
* slice 5a, the ``LOS_binary`` classifiers — on the stage's 2M hospital
  rows, binomial LogisticRegression on the pipeline's Binarizer label and
  multinomial on 3 triage tiers: resident (fit s, records/s, host syncs,
  the training summary's AUC / AUPR / max-F1 threshold) and out of core in
  8 blocks of 2^18, each against the CPU route on a 200,000-row cut and
  against resident; NaiveBayes at bench.py's shape (10M x 32 Poisson(3),
  k=8) beside its bytes bound and equal to the CPU on 1M rows, and its
  gaussian type on the hospital rows; LinearSVC resident and out of core;
  OneVsRest over three depth-5 decision trees (K3, 18 launches) growing
  the CPU's trees; a Pipeline saved, loaded and predicting ``==``; and a
  CrossValidator picking the CPU route's parameters.
* slice 5b, the L-BFGS, Adam and IRLS families — on the same 2M hospital
  rows: GeneralizedLinearRegression (poisson, gamma and tweedie on LOS in
  days, binomial on ``LOS_binary``, gaussian on LOS, each with its
  summary; poisson with an offset column and out of core in 8 blocks),
  MultilayerPerceptronClassifier (4, 16, 2) and AFTSurvivalRegression (the
  example's censored law) on the port's L-BFGS, FMRegressor /
  FMClassifier, IsotonicRegression (predict on the card), the streaming
  linear and logistic regressions over 20 micro-batches, and ``stat``
  (Summarizer, Correlation, KS, ANOVA, FValue, chi-square), each against
  the CPU route on the 200,000-row prefix (or all rows) within limits
  that a control fails, and against float64 numpy / scipy.  No kernel:
  the launch counts do not move.
* slice 5c, the feature stages and the fused SQL-to-device path — at
  bench.py's sql_device shape (4M rows, 8 hospitals over 2 h) the paper's
  window with its CASE / abs / ratio features compiled with no fallback
  node, ``Session.sql_to_device`` against the host route on the card
  (interpreter, ``na_drop``, VectorAssembler, ``device_dataset``): the
  valid rows ``==``, LinearRegression and a depth-5 tree (K3) on each
  within ROADMAP queue 3's bounds, ``compact=True`` keeping the rows, and
  each route's times; then on the stage's 2M hospital rows MinMax, MaxAbs
  and Robust scalers, PCA(3), Normalizer, PolynomialExpansion(2) and
  ElementwiseProduct, each on the card against the CPU route; PCA(3) →
  KMeans(k=16) (K1, K2); StringIndexer → OneHotEncoder and → a
  categorical tree (K3); an Imputer over NaN in 1 % of two columns; and
  RFormula → LinearRegression, the table stages ``==`` across the routes
  and the device statistics within limits that a control fails.
* slices 5d and 5e (``beyond_phase``) — on the stage's 2M hospital rows
  (and a seeded noise column) UnivariateFeatureSelector (ANOVA on
  ``LOS_binary``, F-value on LOS), ChiSqSelector on quantile bins against 3
  LOS tiers, VarianceThresholdSelector, and VectorIndexer(8) → a depth-5
  categorical tree (K3); 100,000 seeded clinical notes through Tokenizer,
  StopWordsRemover and CountVectorizer into LDA(k=10) on the card (resident
  and in 8 HostDataset blocks), HashingTF(2048) → IDF on the card tensor,
  Word2Vec on 10,000 notes twice (bit-equal), DCT on the 2M rows; ALS(rank
  10) on 10M synthetic ratings of 200,000 patients × 5,000 services with
  recommend_for_all_users(10) and the RankingEvaluator on a held-out 10 %,
  the implicit and NNLS fits on a 1M-rating cut; PowerIterationClustering
  (k=8) on the bundled CSV's 10-nearest-neighbour graph (K1 and K2 at
  d = 1); each fit's seconds, records/s, torch ops and host syncs, and card
  against CPU within limits that a control fails.
* slice 6 (``history_phase``) — 1M hospital rows in 40 drops streamed into
  two materialized views, a kill at view maintenance, the train_window
  view into the 20-tree forest (K3), 400 sealed hourly batches pruned and
  scrubbed, and the fuzz harness on the card.
* slice 7a (``front_door_phase``) — the k=256 model saved with its 10M-row
  profile and served behind a k=16 fallback: 1,000 requests from 16
  clients with 1 % planted bad rows to an impute and a reject name (every
  answer ``==`` predict on the imputed rows, K2 in every primary batch and
  a served batch held to its plain version), a 2-std drift opening the
  breaker at the request that closes the 3rd hot window (then fallback
  answers only, no primary K2 launch), a refit on 2M drifted rows (K1, held
  to its plain version at that shape) hot-swapped under 8 threads with no
  request refused, a failing primary through open / half open / closed
  against ``metrics_text()``, 500,000 hospital rows through a firewalled stream
  (0.1 % planted bad rows, a renamed header) killed and resumed, and
  ``serve.microbatch.max_wait_ms`` measured over its domain into a trial
  store that a ``Selector`` then resolves.
* slice 7b (``farm_lifecycle_phase``) — bench.py's farm: 4,096 hospitals of
  4-48 rows, d = 8, fitted by ``FarmLinearRegression`` (with and without
  pooling) and ``FarmKMeans(k=4)`` on the card, each ``==`` its looped
  baseline on 64 sampled hospitals and within limits of the CPU route
  (each failing a TF32-rounded control); 1,600 ``predict_tenant`` requests
  from 8 clients ``==`` ``ModelFarmModel.predict``, unknown hospitals on
  the GLOBAL slot, a KMeans name refused; 5 % of the hospitals shifted and
  refit by ``retrain_drifted``, swapped in under traffic with every other
  hospital byte-identical; a checkpointed farm fit killed and resumed
  bit-identical.  Then bench.py's lifecycle: the warm against the cold
  retrain at 400,000 x 8, k = 16 (K1); one full cycle over 400,000 drifted
  rows in 8 CSV drops (journal SERVING → … → PROMOTED → SERVING, every
  canary answer ``==`` the candidate's predict, health and
  ``metrics_text()`` against the journal; K2 in the served, shadow and
  canary batches); the retrain out of core in blocks of 131,072; and a kill
  at each of the five promotion-path sites resuming to the same artifact.
* slice 7c (``fleet_phase``) — bench.py's serving fleet: KMeans k=1024 on
  6,000 x 64 rows (K1) served by 4 replicas on the card behind the
  consistent-hash router and the SLO ladder, against one server with its
  default queue and with the fleet's total buffering, past saturation
  (1.7x the raw rate, 22 tenants of three classes): every ok answer
  ``==`` predict, none unanswered, in-SLO interactive goodput, p50 / p99
  and shed fractions; the degradation curve's class order at 0.35-2.6x; a
  routed trace; a prepare fault on replica 1 flipping no replica, a clean
  swap flipping all 4 under load, a replica killed mid-load and revived
  with its tenants home, all under a stall watchdog; the multi-process
  fleet (k=256 at d=32), a fresh fleet of 1, 2 and 4 worker processes on
  the card a leg, each worker reporting cuda:0, launching K2 in its leg
  and answering ``==`` the parent's predict, a SIGKILL mid-load and a
  corrupted RPC frame; the
  lifecycle over a 2-replica fleet, PROMOTED on both replicas and
  re-applied on both after a kill at ``fleet.swap.commit``; K1 / K2 at
  the fleet's shapes against their plain versions.
* slice 7d-2 (``soak_phase``) — the compressed production day on the card:
  ``SMOKE_CONFIG`` twice and ``full_config(1107)``, each report
  machine-checked clean (``check_report``), read back, refused with one
  flipped byte, every kill recovered, a bit-identical double kill and
  its schedule re-derived; the two smoke days equal in schedule, kills,
  offered rows, CSV files and quarantined rows; the day-zero farm fitted
  again on the CPU ``==`` the card's saved artifact; the CLI on seed 4242
  in two fresh processes; device bytes after each day; no kernel
  launched.
* slice 8a (``mesh_phase``) — KMeans k=256 on the main path's 10M rows
  over a (data, model) mesh, warm-started from its init centers: a (1, 1)
  mesh ``==`` the main path's model; a (4, 1) mesh over ``[cuda:0] * 4``
  (K1 a shard a step) against it within the out-of-core limits beside a
  bf16-rounded control that fails them, ``==`` on integer rows, with
  predict, compute_cost and the silhouette shard by shard; a (2, 2) mesh
  (K2 then the owner-masked K1 a shard) whose summed counts are the
  bincount of K2's global argmin; two spawned processes over gloo and one
  over NCCL at world size 1, each ``==`` its in-process fit, and NCCL's
  refusal of two ranks on one card; ``federated_dataset`` over 64 hospital
  ids; K1 and K2 at every shard shape against their plain versions.
* slice 8b-1 (``mesh_models_phase``) — the model stage over a mesh, on
  the 2M-row window of the stage at scale: a (1, 1) mesh ``==`` the stage;
  a (4, 1) mesh over ``[cuda:0] * 4`` (K3 once a shard a level, 350,000
  training rows a shard) against it — LR coefficients within 1e-4 of the
  largest (beside TF32 products, which must fail it), the regressors'
  RMSE at rtol 1e-4 (beside the stage on bf16-rounded LOS), the
  classifiers' accuracy and trees ``==``; integer LOS over (4, 1) and
  (2, 2), every tree ``==``; GBT over (4, 1) on gbt20's rows with no host
  sync in the boost loop, the same trees on integer labels and its
  predictions at rtol 1e-4 on float labels; GaussianMixture k=32 and the
  binomial and multinomial LogisticRegression on the stage's 2M hospital
  rows against their one-device fits, each limit beside a control that
  fails it; the JAX package's cross-process phases (WLS, a depth-3 tree,
  5 EM steps, the multinomial fit) on ``mesh_phase``'s two gloo ranks
  ``==`` each other and the in-process (2, 1) fits; K3 at the shard shape
  against its plain version.

Any failed check exits non-zero before the last line; without a CUDA
device, or without the port's package beside it, the script prints no
result and exits 1.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the per-kernel record (launches, error, kernel / plain / library
times and the card's bound for the same work).
"""

from __future__ import annotations

import contextlib
import dataclasses
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
SQL_CMP_EVERY = 4           # its GROUP BY and window against the interpreter: every 4th row
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


PHASE_S: dict[str, float] = {}       # host seconds of each phase, in order
_LAP = [time.perf_counter()]


def lap(name: str) -> None:
    """Charge the host seconds since the previous ``lap`` to phase ``name``."""
    now = time.perf_counter()
    PHASE_S[name] = PHASE_S.get(name, 0.0) + now - _LAP[0]
    _LAP[0] = now


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


def kernel_times(L, x, w, centers, c_valid, reps: int) -> dict:
    """K1's and K2's device times on one input: the kernel, its plain
    version and one library composition (``library_assign``, then
    ``index_add_`` for K1's sums and counts)."""
    import torch

    k, d = centers.shape
    c_sq = (centers * centers).sum(1)
    x_sq = (x * x).sum(1)

    def lib_stats():
        mn, arg = library_assign(x, centers, x_sq, c_sq)
        arg = arg.to(torch.int64)
        sums = torch.zeros(k, d, device="cuda").index_add_(0, arg, x * w[:, None])
        cnts = torch.zeros(k, device="cuda").index_add_(0, arg, w)
        return sums, cnts, (mn * w).sum()

    plain_reps = max(2, reps // 5)
    return {
        "k2": gpu_ms(lambda: L.fused_assign(x, centers, c_valid), reps),
        "k2_plain": gpu_ms(lambda: L.fused_assign_plain(x, centers, c_valid), plain_reps),
        "k2_lib": gpu_ms(lambda: library_assign(x, centers, x_sq, c_sq), plain_reps),
        "k1": gpu_ms(lambda: L.fused_lloyd_stats(x, w, centers, c_valid), reps),
        "k1_plain": gpu_ms(lambda: L.fused_lloyd_stats_plain(x, w, centers, c_valid), plain_reps),
        "k1_lib": gpu_ms(lib_stats, plain_reps),
    }


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

    t = kernel_times(L, x, w, centers, c_valid, reps)
    # K2 at one row a thread runs K1's distance loop: K1 minus it is
    # K1's accumulation
    one = k2_plans(L, n, d, k)[1]
    t["k2_one"] = gpu_ms(lambda: L.fused_assign_planned(x, centers, c_valid, one), reps)
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
    del x, w
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
    return k2_record(L, x, centers, f"n={n} d={d} k={k}", reps)


def k2_record(L, x, centers, tag: str, reps: int) -> dict:
    """K2 against its plain version on the inputs given (every center
    valid), with its times.  → the shape's record."""
    import torch

    n, d = x.shape
    k = centers.shape[0]
    c_valid = torch.ones(k, device=x.device)
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


def make_data(n: int, d: int, k: int, seed: int = SEED):
    """bench.py's ``_make_data``: the same law, standardized, float32."""
    import numpy as np

    cols = make_table_columns(n, d, k, seed)
    x = np.stack([cols[f"f{j}"] for j in range(d)], axis=1)
    del cols
    return ((x - x.mean(axis=0)) / x.std(axis=0)).astype(np.float32)


@contextlib.contextmanager
def timed_methods(spec: dict):
    """Wrap ``{name: (owner, attribute)}`` so that every call adds its
    seconds to ``totals[name]`` (calls nested inside one another count in
    both); the originals come back on exit."""
    totals = {name: 0.0 for name in spec}
    saved = []
    for name, (owner, attr) in spec.items():
        orig = getattr(owner, attr)

        def wrapper(*a, _orig=orig, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _orig(*a, **kw)
            finally:
                totals[_name] += time.perf_counter() - t0

        saved.append((owner, attr, orig))
        setattr(owner, attr, wrapper)
    try:
        yield totals
    finally:
        for owner, attr, orig in saved:
            setattr(owner, attr, orig)


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
        # slice 4b: one streamed block of the out-of-core rf20 forest
        ("rf20 block root", FOREST_BLOCK, 8, 3, 20, 1),
        ("rf20 block depth 5", FOREST_BLOCK, 8, 3, 20, 32),
        # slice 3e: one GBT round's tree at the gbt20 shape, root and depth 3
        ("gbt20 T=1 root", TREE_N, 8, 3, 1, 1),
        ("gbt20 T=1 depth 3", TREE_N, 8, 3, 1, 8),
        # slice 5a: one OneVsRest tree (a depth-5 binary classifier: 2
        # stats, 6 levels) on the 2M hospital rows, root and deepest level
        ("one-vs-rest T=1 root", TREE_N, 4, 2, 1, 1),
        ("one-vs-rest T=1 depth 5", TREE_N, 4, 2, 1, 32),
        # slice 5c: the depth-5 regression trees of features_phase, on the
        # fused sql_device rows (7 features) and on StringIndexer's code
        # beside the 4 hospital features, root and deepest level (the shape
        # of beyond_phase's VectorIndexer → tree too)
        ("fused sql_device tree T=1 root", FEAT_N, 7, 3, 1, 1),
        ("fused sql_device tree T=1 depth 5", FEAT_N, 7, 3, 1, 32),
        ("categorical tree T=1 root", TREE_N, 5, 3, 1, 1),
        ("categorical tree T=1 depth 5", TREE_N, 5, 3, 1, 32),
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
    for LN in (2, 4):     # the gbt20 levels between the two timed ones: plans only
        per_sm = H.occupancy(torch.device(DEV), 8, 3, B, LN, 1) if DEV == "cuda" else None
        plan = H.hist_plan(TREE_N, 8, 3, B, LN, 1, sms, per_sm)
        say(f"K3 gbt20 T=1 LN={LN} plan: TB {plan['TB']}, blocks_x {plan['blocks_x']}, "
            f"{plan['warps']} warps, {plan['smem']} shared bytes, {plan['per_sm']} resident an "
            f"SM, {plan['waves']} wave(s)")

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
    shapes = [{"n": n, "d": d, "S": S, "T": T, "LN": LN, "B": B,
               "max_abs_err": times[tag][1], **times[tag][0]}
              for tag, n, d, S, T, LN in main
              if tag.startswith(("rf20 block", "gbt20", "one-vs-rest", "fused sql_device",
                                 "categorical"))]
    return {"name": "fused_level_hist", "route": "cuda",
            "source": f"{PKG}/csrc/tree_hist.cu", "replaces": f"{JAX_KERNELS}:335",
            "launches": 0, "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shapes": shapes}


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
    whole-partition window on every 4th row, compiled against the
    interpreter at the JAX fuzz harness's tolerance."""
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
    # the GROUP BY and the whole-partition window run against the
    # interpreter on every 4th row (all five hospitals): its passes over all
    # 10M rows took about 35 s of the script's clock
    cmp_table = table.mask(np.arange(SQL_N) % SQL_CMP_EVERY == 0)

    def resolve_cmp(_name):
        return cmp_table

    for tag, qq, rows in (("per-hospital aggregate", agg_q, 5),
                          ("whole-partition window", win_q, len(cmp_table))):
        got, c_ms = host_ms(lambda: sql.execute(qq, resolve_cmp, mode="compile", device=DEV))
        compiled_route(tag)
        want, i_ms = host_ms(lambda: sql.execute(qq, resolve_cmp, mode="interpret"))
        bad = table_mismatch(got, want, exact=False)
        check(bad is None, f"{tag}, compiled vs interpreter: {bad}")
        check(len(got) == rows, f"{tag}: {len(got)} rows, expected {rows}")
        rel = max((float(np.max(np.abs(got[c] - want[c]) / np.maximum(np.abs(want[c]), 1e-300)))
                   for c in want.columns if want[c].dtype.kind == "f"), default=0.0)
        clock = StageEvents()
        sql_compile.run_plan(plan_query(parse(qq), resolve_cmp), cmp_table, clock, device=DEV)
        say(f"sql_window {tag} on {card}, {len(cmp_table)} rows: compiled {c_ms:.1f} ms "
            f"(rerun stages, CUDA events: "
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


def hospital_events(n_per_hospital: int, seed: int = 7, whole_day: bool = False,
                    hospitals: int = 5):
    """The example generator's law (``examples/run_hospital_pipeline.py``
    ``generate_events``): 5 hospitals (or more, the first 5 the same),
    events in 22:00–23:00 (or over the whole day), LOS linear in the 4
    features plus noise — built in memory."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = np.datetime64("2025-03-31T00:00:00" if whole_day else "2025-03-31T22:00:00")
    span_s = 86_400 if whole_day else 3600
    cols = {k: [] for k in ("hospital_id", "event_time", "admission_count",
                            "current_occupancy", "emergency_visits",
                            "seasonality_index", "length_of_stay")}
    for h in range(hospitals):
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
    STAGE_WINDOW.update(table=table, rmse=dict(res.regression_rmse),
                        accuracy=dict(res.classification_accuracy),
                        importances=dict(res.feature_importances))
    return launches, res, test_x


STAGE_WINDOW: dict = {}                   # the stage's window and metrics, for mesh_models_phase


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


EVENT_COLS = ("hospital_id", "event_time", "admission_count", "current_occupancy",
              "emergency_visits", "seasonality_index", "length_of_stay")


def write_events_csv(path: str, cols: dict, lo: int, hi: int) -> None:
    """Rows ``lo:hi`` of ``hospital_events`` columns as a header CSV, byte
    for byte what the port's ``write_csv`` writes for the same Table
    (``str()`` of each value; checked on a prefix by the caller), without
    its per-cell loop."""
    import numpy as np

    times = np.datetime_as_string(cols["event_time"][lo:hi].astype("datetime64[ns]"), unit="ns")
    fields = [
        cols["hospital_id"][lo:hi].tolist(),
        [t.replace("T", " ") for t in times.tolist()],
        *(cols[c][lo:hi].astype(str).tolist()
          for c in ("admission_count", "current_occupancy", "emergency_visits")),
        *(list(map(repr, cols[c][lo:hi].tolist()))
          for c in ("seasonality_index", "length_of_stay")),
    ]
    with open(path, "w") as f:
        f.write(",".join(EVENT_COLS) + "\n")
        f.write("".join(",".join(row) + "\n" for row in zip(*fields)))


def columns_differ(a, b) -> bool:
    """Two columns differ in dtype or in any value (NaN and NaT equal to
    themselves)."""
    import numpy as np

    if a.dtype != b.dtype or a.shape != b.shape:
        return True
    if a.dtype.kind == "M":
        return not np.array_equal(a.view(np.int64), b.view(np.int64))
    if a.dtype.kind == "f":
        return not np.array_equal(a, b, equal_nan=True)
    return not np.array_equal(a, b)


def csv_engines(port, files: list, schema, card: str) -> None:
    """Each CSV engine of the port on ``pipeline_phase``'s files: seconds
    and rows/s; native's C scan and string column timed apart (the
    vectorized column against the per-cell one, equal); native ``==``
    numpy on every column; Arrow against numpy after casting to the
    schema's dtypes, with the columns whose dtype differs named."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.schema import (
        STRING, TIMESTAMP,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.io import native

    check(native.native_available(), "the native CSV engine did not build on this machine")
    tables, secs = {}, {}
    for engine in ("native", "arrow", "numpy"):
        t0 = time.perf_counter()
        parts = [port.read_csv(f, schema, engine=engine) for f in files]
        secs[engine] = time.perf_counter() - t0
        tables[engine] = port.Table.concat(parts)
        del parts
    n = tables["numpy"].num_rows
    kinds = [2 if f.dtype == STRING else (1 if f.dtype == TIMESTAMP else 0) for f in schema]
    scan_s = vec_s = cell_s = 0.0
    for f in files:
        t0 = time.perf_counter()
        _num, _ts, buf, off, rows = native.native_scan(f, kinds)
        scan_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        vec = native.string_columns(buf, off, rows, 1)
        vec_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        cell = native.string_columns_per_cell(buf, off, rows, 1)
        cell_s += time.perf_counter() - t0
        check(vec[0].dtype == cell[0].dtype == object and list(vec[0]) == list(cell[0]),
              f"the vectorized string column differs from the per-cell one on {f}")
    bad = [c for c in schema.names
           if columns_differ(tables["native"][c], tables["numpy"][c])]
    check(bad == [], f"the native engine differs from numpy on {bad}")
    arrow_notes = []
    for c in schema.names:
        a, want = tables["arrow"][c], tables["numpy"][c]
        if a.dtype != want.dtype:
            arrow_notes.append(f"{c} ({a.dtype} against {want.dtype}: pyarrow infers "
                               "integer columns as int64, the JAX package's Arrow engine "
                               "keeps them so)")
        check(not columns_differ(a.astype(want.dtype), want),
              f"the Arrow engine differs from numpy on {c} after the cast")
    say(f"CSV engines on {card}, the 5 files of run_pipeline ({n} rows): "
        + "; ".join(f"{e} {secs[e]:.3f} s = {n / secs[e]:.4g} rows/s" for e in secs))
    say(f"  native split: C scan (csv_size + csv_parse_table) {scan_s:.3f} s, string column "
        f"{vec_s:.3f} s vectorized (per cell, as the JAX package decodes: {cell_s:.3f} s, "
        "equal); native == numpy on every column; Arrow == numpy after the cast; Arrow's "
        "dtypes differ on: " + ("; ".join(arrow_notes) or "none"))
    del tables


def pipeline_phase(port, H, tmp: str, card: str, n_per_hospital: int = TREE_N // 5) -> int:
    """``run_pipeline`` end to end on the card over 5 CSV files of the
    example generator's law (``n_per_hospital`` rows each, 2M in all):
    killed at ``stream.after_sink`` (batch 0 in the table, its checkpoint
    commit line not written), then resumed exactly once (route
    ``compiled``, 24 K3 launches, 5 artifacts, the report, the plots when
    matplotlib is installed); its results ``==`` to ``run_model_stage``
    over ``read_csv_dir`` of the same files; an idempotent rerun; a sixth
    file drained as batch 1, with its late rows counted against numpy, and
    the window rerun hitting the snapshot memo and the device columns.
    → K3's launches in the three ``run_pipeline`` runs."""
    import importlib.util

    import numpy as np

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import sql
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import (
        sql_compile,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.io import csv as pcsv
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.io import native
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.obs.registry import (
        global_registry,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.streaming import (
        checkpoint as ckpt_mod, source as source_mod, watermark as wm_mod,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.streaming import (
        unbounded_table,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.streaming.wal import (
        read_lines,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults

    n5 = 5 * n_per_hospital
    schema = port.hospital_event_schema()
    cols = hospital_events(n_per_hospital, hospitals=6)
    incoming = os.path.join(tmp, "incoming")
    os.makedirs(incoming)
    files = [os.path.join(incoming, f"hospital_{h:02d}.csv") for h in range(6)]
    t0 = time.perf_counter()
    for h in range(5):
        write_events_csv(files[h], cols, h * n_per_hospital, (h + 1) * n_per_hospital)
    write_s = time.perf_counter() - t0
    head = port.Table.from_dict({c: v[:2000] for c, v in cols.items()}, schema)
    port.write_csv(head, os.path.join(tmp, "head.csv"))
    with open(files[0]) as f, open(os.path.join(tmp, "head.csv")) as g:
        check([next(f) for _ in range(2001)] == g.readlines(),
              "the vectorized CSV writer differs from write_csv")
    csv_bytes = sum(os.path.getsize(f) for f in files[:5])
    say(f"run_pipeline input: 5 CSV files x {n_per_hospital} rows of the example generator's "
        f"law (seed 7), {csv_bytes} bytes, written in {write_s:.2f} s (equal to write_csv "
        "on a 2,000-row prefix)")
    csv_engines(port, files[:5], schema, card)

    cfg = port.PipelineConfig(input_path=incoming,
                              checkpoint_location=os.path.join(tmp, "checkpoint"),
                              model_save_path=os.path.join(tmp, "models"),
                              plot_dir=os.path.join(tmp, "plots"))
    sink_dir = cfg.checkpoint_location + "_table_" + cfg.output_table
    plots = importlib.util.find_spec("matplotlib") is not None
    if not plots:
        say("plots: not run (matplotlib is not installed on this machine)")

    # killed: the part is written, its commit line is not
    plan = faults.FaultPlan().crash("stream.after_sink")
    pcsv.reset_engine_counts()
    t0 = time.perf_counter()
    with faults.active(plan):
        try:
            port.run_pipeline(cfg, device=DEV, make_plots=plots)
            killed = False
        except faults.InjectedCrash:
            killed = True
    killed_s = time.perf_counter() - t0
    sink = port.UnboundedTable(sink_dir, schema)
    check(killed and plan.fired("stream.after_sink") == 1, "the run was not killed at stream.after_sink")
    check(pcsv.engine_counts() == {"native": 5, "arrow": 0, "numpy": 0},
          f"the killed run's ingest read {pcsv.engine_counts()} files by engine "
          "(expected all 5 native)")
    check(os.path.exists(os.path.join(sink_dir, "part-0000000000.parquet"))
          and sink.max_batch_id() == 0
          and read_lines(os.path.join(cfg.checkpoint_location, "commits.log")) == [],
          "the killed run did not leave batch 0 in the table without its checkpoint commit")

    # resumed: batch 0 replayed exactly once, its ingest and window timed
    # step by step
    sink_cls = unbounded_table.UnboundedTable
    steps = {
        "read_files": (source_mod.FileStreamSource, "read_files"),
        "native_scan": (native, "native_scan"),
        "string_column": (native, "string_columns"),
        "filter_late": (wm_mod.WatermarkTracker, "filter_late"),
        "append_batch": (sink_cls, "append_batch"),
        "write_parquet": (sink_cls, "_write_parquet"),
        "checkpoint": (ckpt_mod.StreamCheckpoint, "write_commit"),
        "attempt_log": (ckpt_mod.StreamCheckpoint, "record_attempt"),
        "recover": (ckpt_mod.StreamCheckpoint, "recover"),
        "snapshot_read": (sink_cls, "read"),
        "device_column": (port.Table, "device_column"),
        "to_table": (sql_compile.DeviceView, "to_table"),
        "na_drop": (port.Table, "na_drop"),
    }
    H.reset_launch_counts()
    pcsv.reset_engine_counts()
    t0 = time.perf_counter()
    with timed_methods(steps) as step_s, K3Events() as k3:
        res = port.run_pipeline(cfg, device=DEV, make_plots=plots)
    wall_s = time.perf_counter() - t0
    launches = H.launch_counts()["fused_level_hist"]
    engines = pcsv.engine_counts()
    check(engines == {"native": 5, "arrow": 0, "numpy": 0},
          f"run_pipeline's ingest read {engines} files by engine (expected all 5 native)")
    part_s = [step_s["write_parquet"]]
    compiled_route("run_pipeline window")
    check(launches == 24, f"K3 launched {launches} times in run_pipeline (expected 24)")
    k3_ms = k3.ms()
    sink = port.UnboundedTable(sink_dir, schema)
    check(res.training_rows == n5 and sink.read().num_rows == n5,
          f"{res.training_rows} training rows, {sink.read().num_rows} in the table (expected {n5})")
    check(sink.max_batch_id() == 0, f"max batch id {sink.max_batch_id()} after the resume")
    check(port.StreamCheckpoint(cfg.checkpoint_location).quarantine_count() == 0,
          "a batch was quarantined")
    check(sorted(os.listdir(cfg.model_save_path)) == ["dt", "dt_class", "lr", "rf", "rf_class"]
          and len(res.model_paths) == 5, "run_pipeline did not save the 5 models")
    check(res.report.startswith("=" * 64) and "OPERATIONAL INSIGHTS" in res.report,
          "the report is empty")
    if plots:
        check(all(os.path.getsize(p) > 0 for p in res.plot_paths.values())
              and len(res.plot_paths) == 2, "the plots were not written")
    for v in (*res.regression_rmse.values(), *res.classification_accuracy.values()):
        check(np.isfinite(v) and v > 0, f"run_pipeline metric {v} not finite")
    parquet_bytes = dir_bytes(sink_dir)
    t0 = time.perf_counter()
    port.UnboundedTable(sink_dir, schema).read()       # a cold snapshot: Parquet → Table
    snapshot_s = time.perf_counter() - t0

    # == run_model_stage on the same rows
    t0 = time.perf_counter()
    table = port.read_csv_dir(incoming, schema)
    parse_s = time.perf_counter() - t0
    stage = port.run_model_stage(port.extract_training_window(table, cfg, device=DEV), cfg,
                                 device=DEV)
    check(stage.training_rows == res.training_rows
          and stage.regression_rmse == res.regression_rmse
          and stage.classification_accuracy == res.classification_accuracy
          and stage.feature_importances == res.feature_importances,
          "run_pipeline's results differ from run_model_stage on the same rows: "
          f"{res.regression_rmse} {res.classification_accuracy} vs "
          f"{stage.regression_rmse} {stage.classification_accuracy}")
    del table, stage

    # idempotent rerun: no batch runs, the same results
    offsets = read_lines(os.path.join(cfg.checkpoint_location, "offsets.log"))
    H.reset_launch_counts()
    rerun = port.run_pipeline(cfg, device=DEV, make_plots=False)
    launches += H.launch_counts()["fused_level_hist"]
    check(read_lines(os.path.join(cfg.checkpoint_location, "offsets.log")) == offsets
          and port.UnboundedTable(sink_dir, schema).max_batch_id() == 0,
          "the rerun ran a batch")
    check((rerun.regression_rmse, rerun.classification_accuracy, rerun.feature_importances)
          == (res.regression_rmse, res.classification_accuracy, res.feature_importances),
          "the rerun's results differ")

    # a sixth file, drained as batch 1 through a session whose window reruns
    write_events_csv(files[5], cols, n5, n5 + n_per_hospital)
    g = global_registry()

    def caches():
        return {k: g.counters.get(f"sql.cache.{k}", 0.0)
                for k in ("snapshot.hit", "snapshot.miss", "device.hit", "device.miss")}

    spark = port.Session(cfg, device=DEV)
    try:
        c0 = caches()
        H.reset_launch_counts()
        sixth = port.run_pipeline(session=spark, make_plots=False)
        launches += H.launch_counts()["fused_level_hist"]
        c1 = caches()
        window = (f"SELECT * FROM {cfg.output_table} WHERE event_time BETWEEN "
                  f"'{cfg.training_window_start}' AND '{cfg.training_window_end}'")
        t0 = time.perf_counter()
        spark.sql(window)
        rerun_window_s = time.perf_counter() - t0
        compiled_route("window rerun")
        c2 = caches()
    finally:
        spark.stop()
    check(c1["snapshot.miss"] - c0["snapshot.miss"] == 1,
          f"the window after batch 1 counted {c1['snapshot.miss'] - c0['snapshot.miss']} "
          "snapshot misses (expected 1)")
    check(c2["snapshot.miss"] == c1["snapshot.miss"] and c2["snapshot.hit"] > c1["snapshot.hit"]
          and c2["device.miss"] == c1["device.miss"] and c2["device.hit"] > c1["device.hit"],
          f"the window rerun missed a cache: {c1} -> {c2}")
    sink = port.UnboundedTable(sink_dir, schema)
    entry = sink.committed_batches()[1]
    intent = read_lines(os.path.join(cfg.checkpoint_location, "offsets.log"))[-1]
    wm_state = intent["watermark"]["max_event_time"]
    times6 = cols["event_time"][n5:].astype("datetime64[ns]")
    late_np = 0 if wm_state is None else int(
        (times6 < np.datetime64(wm_state) - np.timedelta64(10, "m")).sum())
    late6 = n_per_hospital - entry["rows"]
    check(sink.max_batch_id() == 1 and late6 == late_np,
          f"batch 1: {late6} late rows, numpy counts {late_np} against the restored "
          f"watermark {wm_state}")
    check(sixth.training_rows == n5 + entry["rows"], "the window after batch 1 lost rows")

    # the late-row drop within one process: batch 0 advances the watermark
    src = port.FileStreamSource(incoming, schema, max_files_per_batch=5)
    one = port.StreamExecution(
        source=src, sink=port.UnboundedTable(os.path.join(tmp, "one_table"), schema),
        checkpoint=port.StreamCheckpoint(os.path.join(tmp, "one_ckpt")),
        watermark=port.WatermarkTracker("event_time", cfg.watermark_minutes), device=DEV)
    b0, b1 = one.run_once(), one.run_once()
    wm = cols["event_time"][:n5].astype("datetime64[ns]").max() - np.timedelta64(10, "m")
    late_in = int((times6 < wm).sum())
    check(b0.num_appended_rows == n5 and b1.num_late_rows == late_in
          and b1.num_appended_rows == n_per_hospital - late_in and one.run_once() is None,
          f"in one process, batch 1 dropped {b1.num_late_rows} late rows, numpy counts {late_in}")

    # what the run cost
    sec = res.seconds
    ingest_s, window_s = sec["ingest"], sec["window"]
    fits = {k: v for k, v in sec.items() if k.startswith("fit:")}
    evals = {k: v for k, v in sec.items() if k.startswith("eval:")}
    saves = {k: v for k, v in sec.items() if k.startswith("save:")}
    on_card = window_s + sum(fits.values()) + sum(evals.values())
    say(f"run_pipeline on {card}: killed at stream.after_sink after {killed_s:.2f} s; resumed "
        f"run {wall_s:.2f} s wall, {res.training_rows} training rows, route compiled, "
        f"K3 {len(k3_ms)} launches = {sum(k3_ms):.3f} ms (CUDA events)")
    say(f"  ingest {ingest_s:.3f} s = {n5 / ingest_s:.4g} rows/s (CSV parse alone, read_csv_dir: "
        f"{parse_s:.3f} s = {n5 / parse_s:.4g} rows/s; the Parquet part's write "
        f"{sum(part_s):.3f} s); Parquet on disk {parquet_bytes} bytes ({csv_bytes} bytes of CSV); "
        f"all 5 files read by the native engine")
    ingest_parts = {
        "read_files (native parse + concat)": step_s["read_files"],
        "  of it the C scan": step_s["native_scan"],
        "  of it the string column": step_s["string_column"],
        "watermark filter": step_s["filter_late"],
        "sink append_batch": step_s["append_batch"],
        "  of it the Parquet write": step_s["write_parquet"],
        "checkpoint commit and attempt log": step_s["checkpoint"] + step_s["attempt_log"],
        "checkpoint recover": step_s["recover"],
    }
    timed_ingest = (step_s["read_files"] + step_s["filter_late"] + step_s["append_batch"]
                    + step_s["checkpoint"] + step_s["attempt_log"] + step_s["recover"])
    say("  ingest steps: " + "; ".join(f"{k} {v:.3f} s" for k, v in ingest_parts.items())
        + f"; the rest (source listing, ingest_time column, session) "
          f"{ingest_s - timed_ingest:.3f} s")
    window_parts = {"snapshot read": step_s["snapshot_read"],
                    "device_column transfers": step_s["device_column"],
                    "to_table": step_s["to_table"], "na_drop": step_s["na_drop"]}
    say(f"  window {window_s * 1e3:.1f} ms first run (a cold snapshot read, Parquet -> Table, "
        f"alone: {snapshot_s * 1e3:.1f} ms), {rerun_window_s * 1e3:.1f} ms rerun "
        "(snapshot and device-column hits); first run: "
        + "; ".join(f"{k} {v * 1e3:.1f} ms" for k, v in window_parts.items())
        + f"; the rest (parse, plan, torch ops) "
          f"{(window_s - sum(window_parts.values())) * 1e3:.1f} ms")
    say("  stage: " + ", ".join(f"{k} {v:.3f} s" for k, v in {**fits, **evals}.items()))
    say(f"  saves {sum(saves.values()):.3f} s ({', '.join(f'{k} {v:.3f}' for k, v in saves.items())}); "
        f"plots {sorted(res.plot_paths) if plots else 'not run (no matplotlib)'}; report "
        f"{len(res.report.splitlines())} lines; the rest (the stage's host label, split and "
        "assembly, plots, report, session) "
        f"{wall_s - sum(sec.values()):.3f} s")
    say(f"  card idle at least {100 * (1 - on_card / wall_s):.1f}% of run_pipeline's wall "
        f"(host-only: ingest, the stage's host split and assembly, saves, plots, report; the "
        f"window, fits and evaluations "
        f"{on_card:.3f} s hold host work too); K3 busy {100 * sum(k3_ms) / 1e3 / wall_s:.3f}%")
    say(f"  == run_model_stage over read_csv_dir of the same files; idempotent rerun ran no "
        f"batch; RMSE {json.dumps(res.regression_rmse)}; accuracy "
        f"{json.dumps(res.classification_accuracy)}")
    say(f"  sixth file as batch 1 after a restart: {late6} late rows (numpy: {late_np}; the "
        f"restored watermark state {wm_state}, as the JAX package restores it); in one "
        f"process: {b1.num_late_rows} of {n_per_hospital} late (numpy: {late_in})")
    return launches


STREAM_K, STREAM_BATCH, STREAM_BATCHES = 16, 100_000, 12   # bench.py config 5
GMM_N, GMM_K, GMM_ITERS = 10_000_000, 32, 10                # bench.py config 3
BISECT_N, BISECT_K = 2_000_000, 8                           # bench.py config 4
PREFIX = 200_000                                            # card against CPU
# card-vs-CPU limits, each about 10x the float32 gap the card showed and
# at least 4x below the gap of the same run with TF32 products (the control
# each phase also runs; NVIDIA H100 80GB HBM3, 700 W: streaming centers
# 1.07e-6 against 4.79e-4, GMM weights 2.7e-8 / 4.79e-6, means 2.38e-6 /
# 1.54e-4, covariances 5.72e-6 / 2.00e-4, bisecting centers 4.53e-6 /
# 4.84e-3).  GMM's log-likelihood moves by 8.6e-8 relative under TF32,
# about one float32 ulp, so its limit (16 ulp) guards the sum, not TF32.
# BisectingKMeans ranks and sums in float64 since PR 13, where TF32 does
# not reach: its control is the CPU route on TF32-rounded rows.
STREAM_CENTER_TOL = 1e-5
GMM_TOL = {"ll_rel": 1e-6, "weights": 1e-6, "means": 3e-5, "covariances": 5e-5}
GMM_TF32_CAUGHT = ("weights", "means", "covariances")
BISECT_CENTER_TOL = 5e-5


def mantissa_round(a, bits: int):
    """float32 array → the same values rounded to ``bits`` explicit mantissa
    bits (to nearest, ties to even), as float32."""
    import numpy as np

    shift = np.uint32(23 - bits)
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    u = (u + np.uint32((1 << (23 - bits - 1)) - 1) + ((u >> shift) & np.uint32(1))) \
        & np.uint32(0xFFFFFFFF ^ ((1 << (23 - bits)) - 1))
    return u.view(np.float32)


def tf32_round(a):
    """TF32's 10-bit mantissa: what a TF32 product sees of its inputs."""
    return mantissa_round(a, 10)


def bf16_round(a):
    """bfloat16's 7-bit mantissa: the control where TF32 rounds the rows
    (integers up to 2048) exactly."""
    return mantissa_round(a, 7)


@contextlib.contextmanager
def tf32_matmuls():
    """The card's float32 matmuls in TF32 for the block (the port turns
    TF32 off): the control that each card-vs-CPU limit below must catch."""
    import torch

    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def streaming_phase(port, L, card: str) -> tuple[int, int]:
    """BASELINE config 5 (bench.py ``_bench_streaming``): StreamingKMeans
    k=16, half_life 5 batches, seed 0, on 12 micro-batches of 100,000 x 8
    rows; ``update`` for two batches, ``update_many`` for ten, each batch
    one K1 launch; the card's state against the CPU plain route on the same
    batches, and that route on TF32-rounded batches as the control; a 13th
    update under ``set_sync_debug_mode("error")`` (no host sync, one K1
    launch); predict through K2.  → (K1, K2) launches."""
    import numpy as np
    import torch

    x = make_data(STREAM_BATCH * STREAM_BATCHES, D, STREAM_K)
    batches = [x[i * STREAM_BATCH:(i + 1) * STREAM_BATCH] for i in range(STREAM_BATCHES)]
    L.reset_launch_counts()
    sk = port.StreamingKMeans(k=STREAM_K, half_life=5.0, seed=SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[:2]:
        sk.update(b)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sk.update_many(batches[2:])
    torch.cuda.synchronize()
    many_s = time.perf_counter() - t0
    k1 = L.launch_counts()["fused_lloyd_stats"]
    check(k1 == STREAM_BATCHES, f"K1 launched {k1} times over {STREAM_BATCHES} micro-batches")
    model = sk.latest_model
    check(np.isfinite(model.cluster_centers).all() and model.n_iter == STREAM_BATCHES
          and np.isfinite(model.cluster_weights).all(), "streaming state not finite")

    # the CPU plain route on the same batches (K1's plain version)
    cpu = port.StreamingKMeans(k=STREAM_K, half_life=5.0, seed=SEED)
    for b in batches:
        cpu.update(b, device="cpu")
    cm = cpu.latest_model
    c_err = float(np.abs(model.cluster_centers - cm.cluster_centers).max())
    w_rel = float(np.abs(model.cluster_weights / cm.cluster_weights - 1).max())
    # the control: the plain route on batches rounded to TF32, as a K1 with
    # TF32 products would see them; the centers' limit sits below its gap
    ctl = port.StreamingKMeans(k=STREAM_K, half_life=5.0, seed=SEED)
    for b in batches:
        ctl.update(tf32_round(b), device="cpu")
    c_ctl = float(np.abs(ctl.latest_model.cluster_centers - cm.cluster_centers).max())
    # float32 sums in another order over 12 merges: centers within
    # STREAM_CENTER_TOL, weights (sums of unit counts, decayed) within 1e-6
    # relative
    check(c_err <= STREAM_CENTER_TOL and w_rel <= 1e-6,
          f"card streaming state differs from the CPU route: centers {c_err:.3g}, "
          f"weights rel {w_rel:.3g}")
    check(c_ctl > STREAM_CENTER_TOL,
          f"the TF32 control's centers ({c_ctl:.3g}) pass the limit {STREAM_CENTER_TOL:g}")

    # a 13th update, from rows already on the card, may not sync the host
    ds = port.device_dataset(batches[0])
    torch.cuda.synchronize()
    before = L.launch_counts()["fused_lloyd_stats"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        sk.update(ds)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    k1_sync = L.launch_counts()["fused_lloyd_stats"] - before
    check(k1_sync == 1, f"the 13th update launched K1 {k1_sync} times (expected 1)")

    xd = torch.from_numpy(x).cuda()
    before = L.launch_counts()["fused_assign"]
    pred = model.predict(xd).cpu().numpy()
    k2 = L.launch_counts()["fused_assign"] - before
    check(k2 == 1, f"predict launched K2 {k2} times (expected 1)")
    ref = cm.predict_numpy(x, device="cpu")
    flips = int((pred != ref).sum())
    # the two models' centers differ by float32 rounding: a row may flip
    # only at a near tie
    check(flips <= 10, f"{flips} rows predicted differently by the card and CPU models")
    say(f"streaming k={STREAM_K} on {card}: {STREAM_BATCHES} batches of {STREAM_BATCH} x {D}; "
        f"update x2 {update_s:.3f} s ({2 * STREAM_BATCH / update_s:.4g} records/s, the lazy "
        f"init included), update_many x10 {many_s:.3f} s "
        f"({10 * STREAM_BATCH / many_s:.4g} records/s); K1 {k1} launches (one a batch); a "
        f"13th update from the card made no host sync (K1 1 launch); card vs CPU route: "
        f"centers max abs err {c_err:.3g} (limit {STREAM_CENTER_TOL:g}; the TF32 control "
        f"{c_ctl:.3g}), weights max rel err {w_rel:.3g}; predict of {len(x)} rows through "
        f"K2 ({flips} rows differ from the CPU model's)")
    return k1 + k1_sync, k2


def gmm_phase(port, card: str) -> None:
    """BASELINE config 3 (bench.py ``_bench_gmm``): GaussianMixture k=32 on
    10M x 8 rows, max_iter 10, tol 0, seed 0: the fit (EM records/s), the
    ``on_iteration`` path (log-likelihood finite and non-decreasing, equal
    to the fast path), peak device memory, and the card against the CPU on
    a 200,000-row prefix, with the same fit in TF32 as the control."""
    import numpy as np
    import torch

    x = make_data(GMM_N, D, GMM_K)
    xd = port.device_dataset(x)
    est = port.GaussianMixture(k=GMM_K, max_iter=GMM_ITERS, tol=0.0, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = est.fit(xd)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(model.n_iter == GMM_ITERS and np.isfinite(model.log_likelihood),
          f"GMM fit: n_iter {model.n_iter}, log-likelihood {model.log_likelihood}")
    lls = []
    t0 = time.perf_counter()
    hooked = est.fit(xd, on_iteration=lambda it, ll: lls.append(ll))
    hook_s = time.perf_counter() - t0
    check(len(lls) == GMM_ITERS and all(np.isfinite(lls))
          and all(b >= a for a, b in zip(lls, lls[1:])),
          f"the log-likelihood over the on_iteration path is not finite and non-decreasing: {lls}")
    check(hooked.log_likelihood == model.log_likelihood
          and np.array_equal(hooked.means, model.means),
          "the on_iteration path differs from the fast path")
    t0 = time.perf_counter()
    pred, prob = model.predict_assigned(xd.x)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    check(0 <= int(pred.min()) and int(pred.max()) < GMM_K
          and bool(torch.isfinite(prob).all()), "GMM predictions out of range")
    del xd, pred, prob

    sub = x[:PREFIX]
    on_card = port.GaussianMixture(k=GMM_K, max_iter=GMM_ITERS, tol=0.0, seed=SEED).fit(sub)
    t0 = time.perf_counter()
    on_cpu = port.GaussianMixture(k=GMM_K, max_iter=GMM_ITERS, tol=0.0, seed=SEED).fit(
        sub, device="cpu")
    cpu_s = time.perf_counter() - t0
    with tf32_matmuls():
        on_tf32 = port.GaussianMixture(k=GMM_K, max_iter=GMM_ITERS, tol=0.0, seed=SEED).fit(sub)

    def gaps(m):
        e = {a: float(np.abs(getattr(m, a) - getattr(on_cpu, a)).max())
             for a in ("weights", "means", "covariances")}
        e["ll_rel"] = abs(m.log_likelihood / on_cpu.log_likelihood - 1)
        return e

    errs, ctl = gaps(on_card), gaps(on_tf32)
    # float32 EM statistics summed in another order, over 10 iterations:
    # each within GMM_TOL; the same fit with TF32 matmuls fails each of
    # GMM_TF32_CAUGHT
    bad = {a: errs[a] for a, tol in GMM_TOL.items() if not errs[a] <= tol}
    check(not bad, f"GMM card vs CPU on {PREFIX} rows: {errs} (limits {GMM_TOL})")
    missed = {a: ctl[a] for a in GMM_TF32_CAUGHT if not ctl[a] > GMM_TOL[a]}
    check(not missed, f"the TF32 control passes the GMM limits {missed} (limits {GMM_TOL})")
    say(f"gmm k={GMM_K} on {card}: {GMM_N} x {D}, {GMM_ITERS} EM iterations, fit "
        f"{fit_s:.3f} s = {GMM_N * model.n_iter / fit_s:.4g} EM records/s (on_iteration path "
        f"{hook_s:.3f} s, equal); log-likelihood {model.log_likelihood:.8g}, non-decreasing "
        f"over the iterations; peak device memory {peak / 2**20:.1f} MiB; predict_assigned "
        f"{pred_s * 1e3:.1f} ms; card vs CPU on {PREFIX} rows (CPU fit {cpu_s:.2f} s): "
        + ", ".join(f"{a} {errs[a]:.3g} (limit {GMM_TOL[a]:g}; TF32 control {ctl[a]:.3g})"
                    for a in GMM_TOL))


def bisecting_phase(port, L, card: str) -> int:
    """BASELINE config 4 (bench.py ``_bench_bisecting``): BisectingKMeans
    k=8, n_restarts 1, seed 0 on 2M x 8 rows: fit seconds, records/s,
    levels and host syncs; predict through K2; the card against the CPU on
    a 200,000-row prefix, with the CPU fit on TF32-rounded rows as the
    control.  → K2 launches."""
    import numpy as np
    import torch

    x = make_data(BISECT_N, D, BISECT_K)
    xd = port.device_dataset(x)
    est = port.BisectingKMeans(k=BISECT_K, seed=SEED, n_restarts=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = est.fit(xd)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    info = model.fit_info
    check(model.cluster_centers.shape == (BISECT_K, D)
          and np.isfinite(model.cluster_centers).all()
          and float(model.cluster_sizes.sum()) == BISECT_N,
          f"bisecting model: {model.cluster_centers.shape}, sizes {model.cluster_sizes}")
    before = L.launch_counts()["fused_assign"]
    t0 = time.perf_counter()
    pred = model.predict(xd.x)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    k2 = L.launch_counts()["fused_assign"] - before
    check(k2 == 1, f"predict launched K2 {k2} times (expected 1)")
    sizes = np.bincount(pred.cpu().numpy(), minlength=BISECT_K)
    moved = int(np.abs(sizes - model.cluster_sizes).sum()) // 2
    del xd, pred

    sub = x[:PREFIX]
    on_card = port.BisectingKMeans(k=BISECT_K, seed=SEED, n_restarts=1).fit(sub)
    on_cpu = port.BisectingKMeans(k=BISECT_K, seed=SEED, n_restarts=1).fit(sub, device="cpu")
    on_ctl = port.BisectingKMeans(k=BISECT_K, seed=SEED, n_restarts=1).fit(tf32_round(sub),
                                                                          device="cpu")
    c_err = float(np.abs(on_card.cluster_centers - on_cpu.cluster_centers).max())
    c_ctl = float(np.abs(on_ctl.cluster_centers - on_cpu.cluster_centers).max())
    s_diff = int(np.abs(on_card.cluster_sizes - on_cpu.cluster_sizes).sum())
    # sums in another order: the same tree, centers within
    # BISECT_CENTER_TOL (the fit on TF32-rounded rows is not); a near-tie
    # row may take the other child (0.01 % of the rows)
    check(on_card.fit_info["splits"] == on_cpu.fit_info["splits"]
          and on_card.n_iter == on_cpu.n_iter and c_err <= BISECT_CENTER_TOL
          and s_diff <= PREFIX // 10_000,
          f"bisecting card vs CPU on {PREFIX} rows: centers {c_err:.3g}, sizes differ by "
          f"{s_diff}")
    check(c_ctl > BISECT_CENTER_TOL,
          f"the TF32-rounded control's centers ({c_ctl:.3g}) pass the limit "
          f"{BISECT_CENTER_TOL:g}")
    say(f"bisecting k={BISECT_K} on {card}: {BISECT_N} x {D}, fit {fit_s:.3f} s = "
        f"{BISECT_N / fit_s:.4g} records/s, {len(info['levels'])} levels, Lloyd iterations a "
        f"level {info['levels']}, {info['host_syncs']} host syncs (the JAX package: 1 a tree); "
        f"training cost {model.training_cost:.8g}; predict {pred_s * 1e3:.2f} ms through K2 "
        f"({moved} rows nearer another leaf than the fit's own split); card vs CPU on "
        f"{PREFIX} rows: same splits, centers max abs err {c_err:.3g} (limit "
        f"{BISECT_CENTER_TOL:g}; the control on TF32-rounded rows {c_ctl:.3g}), sizes differ "
        f"by {s_diff}")
    return k2


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


# ------------------------------------------------- slice 4b: out of core
OOC_BLOCK = 1 << 20          # the flagship's max_device_rows: 10 blocks of 10M rows
EXACT_N, EXACT_K, EXACT_BLOCK = 400_000, 16, 32_768   # examples/outofcore_categorical.py
REUSE_BLOCK = EXACT_N // 64                            # 64 blocks: the stream-reuse guard
GMM_OOC_N, GMM_OOC_BLOCK = 2_000_000, 1 << 19
LR_OOC_BLOCK = 1 << 18
FOREST_BLOCK = 1 << 18       # rf20's 2M rows as 8 blocks
# out of core against resident on the card, each about 10x the gap this
# phase measured on an NVIDIA H100 80GB HBM3 at 700 W: the
# blocks sum the float32 statistics in another order than one pass, and 20
# Lloyd steps carry that into the centers (k=256: 2.26e-4; cosine k=16 at
# tol 0: 5.96e-8); the cost, a float32 sum, read 0 (limit 16 ulp)
OOC_KMEANS_TOL = {"centers": 2e-3, "cost_rel": 1e-6}
OOC_COSINE_TOL = 6e-7


def ooc_rows(n: int, d: int, k: int, tmp: str, name: str):
    """``make_data`` rows written to an ``.npy`` under ``tmp`` and opened
    memory-mapped. → (the in-memory rows, the memmap)."""
    import numpy as np

    x = make_data(n, d, k)
    path = os.path.join(tmp, f"{name}.npy")
    np.save(path, x)
    return x, np.load(path, mmap_mode="r")


def link_and_fill(hd, b: int) -> tuple[float, float]:
    """The link and the host fill alone: one staged block pinned -> card
    (CUDA events), and one block from the memmap into pinned memory (host
    clock).  → (copy ms, fill ms)."""
    import torch

    width = hd._width(b)
    pinned = torch.empty((width,), dtype=torch.float32, pin_memory=True)
    on_dev = torch.empty((width,), dtype=torch.float32, device="cuda")
    copy_ms = gpu_ms(lambda: on_dev.copy_(pinned, non_blocking=True), 10)
    t0 = time.perf_counter()
    for i in range(3):
        hd._fill(pinned.numpy(), i * b, b)
    return copy_ms, (time.perf_counter() - t0) / 3 * 1e3


def outofcore_phase(port, L, H, card: str, k1_ms: float) -> dict:
    """Slice 4b, the out-of-core fits at full width: KMeans k=256 over the
    10M x 8 rows memory-mapped from disk in blocks of 2**20 (K1 a block),
    against the resident fit, with its epoch breakdown and peak device
    memory; exact integer rows bit-equal out of core and resident, a
    preempt at iteration 3 resumed bit-equal, and one 64-block epoch equal
    to the resident K1 pass (the stream-reuse guard); cosine KMeans and
    predict through K2; GMM k=32 (config 3's law, 2M x 8); LinearRegression
    on 2M hospital rows; the rf20 forest shape in 8 blocks (K3 a block a
    level).  ``k1_ms``: K1's time at the block shape (the kernel record).
    → the K1, K2, K3 launches of the phase."""
    import numpy as np
    import torch

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import prng
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models.tree import (
        engine,
    )

    t_phase = time.perf_counter()
    L.reset_launch_counts()
    H.reset_launch_counts()
    tmp = tempfile.mkdtemp(prefix="ooc-")
    try:
        # --------------------------------------------- flagship KMeans k=256
        x, xm = ooc_rows(N, D, K, tmp, "kmeans")
        hd = port.HostDataset(x=xm, max_device_rows=OOC_BLOCK)
        n_blocks, b = hd.block_shape()
        width = hd._width(b)
        copy_ms, fill_ms = link_and_fill(hd, b)
        h2d_gbs = width * 4 / copy_ms / 1e6
        plan = L.lloyd_plan(b, D, K, torch.cuda.get_device_properties(0).multi_processor_count,
                            L._stats_occupancy(torch.device(DEV), D, K))
        sync()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        stamps = []
        k1_before = L.launch_counts()["fused_lloyd_stats"]
        t_fit = time.perf_counter()
        ooc = port.KMeans(k=K, seed=SEED, max_iter=MAX_ITER).fit(
            hd, device=DEV, on_iteration=lambda it, c, m: stamps.append(time.perf_counter()))
        sync()
        t_end = time.perf_counter()
        fit_s = t_end - t_fit
        peak = torch.cuda.max_memory_allocated() - base
        k1_fit = L.launch_counts()["fused_lloyd_stats"] - k1_before
        check(k1_fit == (ooc.n_iter + 1) * n_blocks,
              f"out-of-core KMeans launched K1 {k1_fit} times (expected (n_iter + 1) x "
              f"{n_blocks} blocks = {(ooc.n_iter + 1) * n_blocks})")
        k_state = 8 * (K * (D + 1) + 1) * 4
        bound = 2 * width * 4 + k_state + plan["partial_floats"] * 4 + (1 << 20)
        check(peak <= bound,
              f"out-of-core KMeans peak device memory {peak} bytes above the bound {bound} = "
              f"2 blocks x {width * 4} + k-state {k_state} + K1 workspace "
              f"{plan['partial_floats'] * 4} + 1 MiB of small tensors and allocator rounding")
        epoch_s = float(np.median(np.diff(stamps))) if len(stamps) > 1 else fit_s
        ds = port.device_dataset(x, device=DEV)
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = port.KMeans(k=K, seed=SEED, max_iter=MAX_ITER).fit(ds)
        sync()
        res_s = time.perf_counter() - t0
        res_peak = torch.cuda.max_memory_allocated() - base + ds.x.numel() * 4 + ds.w.numel() * 4
        check(peak * 4 < res_peak, f"out-of-core peak {peak} not well under the resident "
                                   f"fit's {res_peak} bytes")
        c_gap = float(np.abs(ooc.cluster_centers - res.cluster_centers).max())
        cost_gap = abs(ooc.training_cost / res.training_cost - 1)
        check(ooc.n_iter == res.n_iter and c_gap <= OOC_KMEANS_TOL["centers"]
              and cost_gap <= OOC_KMEANS_TOL["cost_rel"],
              f"out-of-core KMeans vs resident: n_iter {ooc.n_iter} / {res.n_iter}, centers "
              f"{c_gap:.3g}, cost rel {cost_gap:.3g} (limits {OOC_KMEANS_TOL})")
        k2_before = L.launch_counts()["fused_assign"]
        pred = ooc.predict(ds.x)
        agree = float((pred == res.predict(ds.x)).float().mean())
        check(L.launch_counts()["fused_assign"] - k2_before == 2, "predict did not launch K2")
        check(agree >= 0.9999, f"out-of-core and resident models agree on {agree:.6f} of rows")
        del ds, pred
        serial = n_blocks * (fill_ms + copy_ms + k1_ms) / 1e3
        hidden = min(max((serial - epoch_s) / (n_blocks * copy_ms / 1e3), 0.0), 1.0)
        link_s = N * (D + 1) * 4 / (h2d_gbs * 1e9)
        say(f"outofcore kmeans k={K} on {card}: {N} x {D} memmapped rows in {n_blocks} blocks "
            f"of {b}; fit {fit_s:.3f} s (resident {res_s:.3f} s), n_iter {ooc.n_iter}, "
            f"{N * ooc.n_iter / fit_s:.4g} Lloyd records/s; K1 {k1_fit} launches; epoch "
            f"{epoch_s * 1e3:.1f} ms (median of {len(stamps) - 1}) beside n(d+1)4 = "
            f"{N * (D + 1) * 4 / 1e6:.0f} MB over the measured {h2d_gbs:.2f} GB/s = "
            f"{link_s * 1e3:.1f} ms; per block: host fill {fill_ms:.2f} ms, copy {copy_ms:.3f} "
            f"ms, K1 {k1_ms:.4f} ms; K1 {100 * n_blocks * k1_ms / 1e3 / epoch_s:.1f}% of an "
            f"epoch; the double buffer hides {100 * hidden:.0f}% of the copy time "
            f"((n_blocks (fill + copy + K1) - epoch) / (n_blocks copy), serial "
            f"{serial * 1e3:.1f} ms); before the first step {(stamps[0] - t_fit) * 1e3:.0f} ms "
            f"(host sample and k-means++ init, one epoch), after the last "
            f"{(t_end - stamps[-1]) * 1e3:.0f} ms (the final cost epoch); peak device memory "
            f"{peak / 2**20:.1f} MiB <= bound {bound / 2**20:.1f} MiB (2 blocks x {width * 4} B "
            f"+ k-state {k_state} B + K1 workspace {plan['partial_floats'] * 4} B + 1 MiB), "
            f"resident {res_peak / 2**20:.1f} MiB; vs resident: centers max abs {c_gap:.3g} (limit "
            f"{OOC_KMEANS_TOL['centers']:g}), cost rel {cost_gap:.3g} (limit "
            f"{OOC_KMEANS_TOL['cost_rel']:g}), predictions agree on {agree:.6f} of rows")
        del x, xm, hd, ooc, res

        # ------------------------------------- exact rows: bit-equal, resume
        rng = np.random.default_rng(0)
        cen = rng.integers(-30, 30, size=(EXACT_K, D))
        xe = (cen[rng.integers(0, EXACT_K, size=EXACT_N)]
              + rng.integers(-2, 3, size=(EXACT_N, D))).astype(np.float32)
        np.save(os.path.join(tmp, "exact.npy"), xe)
        xem = np.load(os.path.join(tmp, "exact.npy"), mmap_mode="r")
        hde = port.HostDataset(x=xem, max_device_rows=EXACT_BLOCK)
        est = dict(k=EXACT_K, seed=SEED)
        oe = port.KMeans(**est).fit(hde, device=DEV)
        re_ = port.KMeans(**est).fit(port.device_dataset(xe, device=DEV))
        check(np.array_equal(oe.cluster_centers, re_.cluster_centers)
              and np.array_equal(oe.cluster_sizes, re_.cluster_sizes) and oe.n_iter == re_.n_iter,
              "exact rows: out-of-core centers are not bit-equal to the resident fit's")

        class Preempt(RuntimeError):
            pass

        # the preempt lands at iteration 3, or at the last one if the fit
        # converges sooner (the resumed fit then runs one no-op step)
        kill_at = min(3, oe.n_iter)

        def bomb(it, cost, move):
            if it == kill_at:
                raise Preempt()

        ck = dict(checkpoint_dir=os.path.join(tmp, "ck"), checkpoint_every=1)
        try:
            port.KMeans(**est, **ck).fit(hde, device=DEV, on_iteration=bomb)
            fail("the preempting on_iteration did not stop the fit")
        except Preempt:
            pass
        seen = []
        resumed = port.KMeans(**est, **ck).fit(hde, device=DEV,
                                               on_iteration=lambda it, c, m: seen.append(it))
        check(seen[:1] == [kill_at + 1]
              and np.array_equal(resumed.cluster_centers, oe.cluster_centers)
              and np.array_equal(resumed.cluster_sizes, oe.cluster_sizes),
              f"the resumed fit (from iteration {seen[:1]}) is not bit-equal to the "
              "uninterrupted one")

        # the stream-reuse guard: 64 blocks, summed, == one resident K1 pass
        hd64 = port.HostDataset(x=xem, max_device_rows=REUSE_BLOCK)
        c0 = torch.from_numpy(oe.cluster_centers).to(DEV)
        cv = torch.ones(EXACT_K, device=DEV)
        tot = None
        for blk in hd64.blocks(device=DEV):
            st = L.fused_lloyd_stats(blk.x, blk.w, c0, cv)
            tot = st if tot is None else port.parallel.add_stats(tot, st)
        dse = port.device_dataset(xe, device=DEV)
        ref = L.fused_lloyd_stats(dse.x, dse.w, c0, cv)
        check(hd64.block_shape()[0] == 64 and torch.equal(tot[0], ref[0])
              and torch.equal(tot[1], ref[1]),
              "64 streamed blocks' K1 sums and counts differ from the resident pass")
        say(f"outofcore exact rows ({EXACT_N} x {D}, k={EXACT_K}, blocks of {EXACT_BLOCK}): "
            f"centers and sizes bit-equal to the resident fit (n_iter {oe.n_iter}); preempted "
            f"at iteration {kill_at} and resumed from the commit: bit-equal; 64 streamed "
            f"blocks' K1 "
            f"sums and counts == the resident pass (cost {float(tot[2]):.8g} vs "
            f"{float(ref[2]):.8g})")
        del dse, xe, xem, hde, hd64

        # ----------------------------------------- cosine KMeans, K2 predict
        x, xm = ooc_rows(GMM_OOC_N, D, 16, tmp, "cosine")
        est = dict(k=16, seed=SEED, max_iter=10, tol=0.0, distance_measure="cosine")
        oc = port.KMeans(**est).fit(port.HostDataset(x=xm, max_device_rows=GMM_OOC_BLOCK),
                                    device=DEV)
        ds = port.device_dataset(x, device=DEV)
        rc = port.KMeans(**est).fit(ds)
        cos_gap = float(np.abs(oc.cluster_centers - rc.cluster_centers).max())
        check(oc.n_iter == rc.n_iter and cos_gap <= OOC_COSINE_TOL,
              f"cosine out of core vs resident: centers {cos_gap:.3g} (limit {OOC_COSINE_TOL})")
        pc = oc.predict(ds.x)
        cos_agree = float((pc == rc.predict(ds.x)).float().mean())
        check(cos_agree >= 0.9999, f"cosine models agree on {cos_agree:.6f} of rows")
        say(f"outofcore cosine k=16 ({GMM_OOC_N} x {D}, blocks of {GMM_OOC_BLOCK}): centers "
            f"{cos_gap:.3g} from the resident fit (limit {OOC_COSINE_TOL:g}), unit norms, "
            f"predictions agree on {cos_agree:.6f} of rows through K2")
        del ds, pc, x, xm

        # -------------------------------------------------- GMM k=32 (config 3)
        x, xm = ooc_rows(GMM_OOC_N, D, GMM_K, tmp, "gmm")
        gest = port.GaussianMixture(k=GMM_K, max_iter=GMM_ITERS, tol=0.0, seed=SEED)
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        og = gest.fit(port.HostDataset(x=xm, max_device_rows=GMM_OOC_BLOCK), device=DEV)
        sync()
        g_s = time.perf_counter() - t0
        g_peak = torch.cuda.max_memory_allocated() - base
        rg = gest.fit(port.device_dataset(x, device=DEV))
        errs = {a: float(np.abs(getattr(og, a) - getattr(rg, a)).max())
                for a in ("weights", "means", "covariances")}
        errs["ll_rel"] = abs(og.log_likelihood / rg.log_likelihood - 1)
        bad = {a: errs[a] for a, tol in GMM_TOL.items() if not errs[a] <= tol}
        check(og.n_iter == rg.n_iter == GMM_ITERS and not bad,
              f"out-of-core GMM vs resident: {errs} (limits {GMM_TOL})")
        say(f"outofcore gmm k={GMM_K} ({GMM_OOC_N} x {D}, blocks of {GMM_OOC_BLOCK}): fit "
            f"{g_s:.3f} s = {GMM_OOC_N * og.n_iter / g_s:.4g} EM records/s, peak device memory "
            f"{g_peak / 2**20:.1f} MiB; vs resident: "
            + ", ".join(f"{a} {errs[a]:.3g} (limit {GMM_TOL[a]:g})" for a in GMM_TOL))
        del x, xm

        # ------------------------------------ LinearRegression, 2M hospital rows
        cols = hospital_events(TREE_N // 5)
        xl = np.stack([cols[c] for c in port.FEATURE_COLS], axis=1)
        yl = cols[port.LABEL_COL]
        del cols
        t0 = time.perf_counter()
        ol = port.LinearRegression().fit(
            port.HostDataset(x=xl, y=yl, max_device_rows=LR_OOC_BLOCK), device=DEV)
        sync()
        lr_s = time.perf_counter() - t0
        rl = port.LinearRegression().fit((xl, yl), device=DEV)
        # the float64 solution of the same least squares, on the host
        exact = np.linalg.lstsq(np.c_[xl, np.ones(len(yl))], yl, rcond=None)[0]
        scale = float(np.abs(exact).max())

        def gap(m):
            got = np.r_[m.coefficients.cpu().numpy(), float(m.intercept)]
            return float(np.abs(got - exact).max())

        lr_ooc, lr_res = gap(ol), gap(rl)
        lr_gap = max(float((ol.coefficients - rl.coefficients).abs().max()),
                     abs(float(ol.intercept) - float(rl.intercept)))
        # float32 normal equations: 1e-4 of the largest coefficient (ROADMAP
        # queue 3), against the resident fit and against the float64 solution
        check(lr_gap <= 1e-4 * scale and lr_ooc <= 1e-4 * scale,
              f"out-of-core LinearRegression: {lr_gap:.3g} from the resident fit, "
              f"{lr_ooc:.3g} from the float64 solution (limit 1e-4 x {scale:.3g})")
        say(f"outofcore linear regression ({len(yl)} hospital rows, blocks of {LR_OOC_BLOCK}): "
            f"{lr_s:.3f} s; coefficients and intercept within {lr_gap:.3g} of the resident fit "
            f"and {lr_ooc:.3g} of the float64 solution (the resident fit: {lr_res:.3g}; limit "
            f"1e-4 x {scale:.3g})")
        del xl, yl

        # ------------------------------------------- forest, rf20's shape
        rng = np.random.default_rng(0)
        cols = make_table_columns(TREE_N, D, 16, 0)
        xf = np.stack([cols[f"f{j}"] for j in range(D)], axis=1)
        del cols
        xf = ((xf - xf.mean(axis=0)) / xf.std(axis=0)).astype(np.float32)
        yf = (xf @ rng.normal(size=(D,)) + rng.normal(0.0, 0.3, size=TREE_N)).astype(np.float32)
        yc = (yf > np.median(yf)).astype(np.float32)
        np.save(os.path.join(tmp, "forest.npy"), xf)
        xfm = np.load(os.path.join(tmp, "forest.npy"), mmap_mode="r")
        hr = port.HostDataset(x=xfm, y=yf, max_device_rows=FOREST_BLOCK)
        hc = port.HostDataset(x=xfm, y=yc, max_device_rows=FOREST_BLOCK)
        fb, bf = hr.block_shape()
        kw = dict(num_trees=20, max_depth=5, seed=0)
        # the user's path: RandomForestRegressor on the HostDataset (bootstrap on)
        est = port.RandomForestRegressor(feature_subset_strategy="all", **kw)
        k3_before = H.launch_counts()["fused_level_hist"]
        sync()
        t0 = time.perf_counter()
        with K3Events() as k3:
            rf = est.fit(hr, device=DEV)
        sync()
        rf_s = time.perf_counter() - t0
        k3_ms = k3.ms()
        k3_fit = H.launch_counts()["fused_level_hist"] - k3_before
        check(k3_fit == (kw["max_depth"] + 1) * fb,
              f"out-of-core forest launched K3 {k3_fit} times (expected (max_depth + 1) x "
              f"{fb} blocks = {(kw['max_depth'] + 1) * fb})")
        dsf = port.device_dataset(xf, yf, device=DEV)
        rf_res = est.fit(dsf)
        ev = port.RegressionEvaluator()
        rmse_o = ev.evaluate(port.PredictionResult(prediction=rf.predict(dsf.x), label=dsf.y,
                                                   weight=dsf.w))
        rmse_r = ev.evaluate(port.PredictionResult(prediction=rf_res.predict(dsf.x),
                                                   label=dsf.y, weight=dsf.w))
        check(abs(rmse_o / rmse_r - 1) < 0.05,
              f"bootstrapped out-of-core forest RMSE {rmse_o} vs resident {rmse_r}")
        # each block's Poisson draw on the card == the CPU's: an entry's count
        # depends only on its key and flat index, so the CPU draws the first
        # two trees' rows, (2, b), of the card's (20, b)
        flips = 0
        for i in range(fb):
            on_card = engine.block_bootstrap(0, i, 1.0, 20, bf, DEV)[:2].cpu()
            flips += int((on_card != engine.block_bootstrap(0, i, 1.0, 2, bf, "cpu")).sum())
        check(flips == 0, f"{flips} per-block bootstrap counts differ between card and CPU")
        # bootstrap off: splits against the resident grow_forest
        dsc = port.device_dataset(xf, yc, device=DEV)
        cls_o = engine.grow_forest_outofcore(hc, task="classification", bootstrap=False,
                                             device=DEV, **kw)
        cls_r = engine.grow_forest(dsc, task="classification", bootstrap=False, **kw)
        check(all(np.array_equal(getattr(cls_o, a), getattr(cls_r, a))
                  for a in ("split_feat", "split_bin", "threshold")),
              "out-of-core classifier splits differ from the resident forest's")
        reg_o = engine.grow_forest_outofcore(hr, task="regression", bootstrap=False,
                                             device=DEV, **kw)
        reg_r = engine.grow_forest(dsf, task="regression", bootstrap=False, **kw)

        def rmse_of(grown):
            out = engine.predict_forest(dsf.x, grown.split_feat, grown.threshold, grown.value)
            return float(((out.mean(dim=0)[:, 0] - dsf.y) ** 2).mean().sqrt())

        r_o, r_r = rmse_of(reg_o), rmse_of(reg_r)
        same_reg = int((reg_o.split_feat != reg_r.split_feat).sum())
        check(abs(r_o / r_r - 1) <= 1e-4,
              f"out-of-core regressor RMSE {r_o} vs resident {r_r} (rtol 1e-4)")
        # preempt at depth 2, resume from the level commit
        ckf = os.path.join(tmp, "forest-ck")
        fkw = dict(task="regression", bootstrap=True, device=DEV, **kw)

        def stop(depth):
            if depth == 2:
                raise Preempt()

        try:
            engine.grow_forest_outofcore(hr, checkpoint_dir=ckf, on_level=stop, **fkw)
            fail("the preempting on_level did not stop the forest")
        except Preempt:
            pass
        levels = []
        resumed_f = engine.grow_forest_outofcore(hr, checkpoint_dir=ckf, on_level=levels.append,
                                                 **fkw)
        full_f = engine.grow_forest_outofcore(hr, **fkw)
        check(levels == [3, 4, 5] and all(
            np.array_equal(getattr(resumed_f, a), getattr(full_f, a))
            for a in ("split_feat", "split_bin", "threshold", "value")),
              f"the resumed forest (levels {levels}) differs from the uninterrupted one")
        check(all(np.array_equal(getattr(full_f, a), getattr(rf, a))
                  for a in ("split_feat", "threshold")),
              "the engine's bootstrapped forest differs from the estimator's")
        say(f"outofcore forest rf20 shape ({TREE_N} x {D}, {fb} blocks of {bf}, T=20, depth 5):"
            f" RandomForestRegressor.fit {rf_s:.3f} s = {TREE_N / rf_s:.4g} rows/s, K3 {k3_fit}"
            f" launches = {sum(k3_ms):.1f} ms ({100 * sum(k3_ms) / 1e3 / rf_s:.1f}% of the fit);"
            f" RMSE {rmse_o:.6f} (resident {rmse_r:.6f}); per-block draws == CPU; bootstrap "
            f"off: classifier splits == resident, regressor RMSE {r_o:.8g} vs {r_r:.8g} "
            f"({same_reg} split features differ); preempted at depth 2 and resumed: == "
            f"uninterrupted")
        del dsf, dsc, xf, xfm, hr, hc
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    counts = {**L.launch_counts(), **H.launch_counts()}
    say(f"outofcore phase: {time.perf_counter() - t_phase:.1f} s, launches {json.dumps(counts)}")
    return counts


# ------------------------------- slice 3e: GBT (K3 at T = 1), LR, summary
GBT_ROUNDS, GBT_DEPTH = 20, 3           # bench.py's gbt20 row
GBT_BLOCK = 1 << 18                     # the out-of-core boost: 8 blocks of 2M rows
GBT_VAL_N = 100_000                     # the validation fit, card against CPU
# limits of this slice's card-vs-CPU and reduced-precision checks, each
# about 10x the gap the first chip run showed (NVIDIA H100 80GB HBM3,
# 700.00 W); the measured gaps are printed beside them.  Each card-vs-CPU
# limit must also fail its control: the same fit with TF32 products, or
# the CPU (or out-of-core) route on TF32-rounded rows
GBT_VALUE_TOL = 1e-6                    # leaf values, integer labels (4.77e-7)
GBT_PRED_RTOL = 1e-4                    # predictions, float labels (4.81e-5)
GBT_VAL_VALUE_TOL = 5e-6                # the validation fit's leaf values (4.77e-7)
GBT_OOC_VALUE_TOL = 2.4e-6              # out of core against resident (2.38e-7)
# elastic net against the CPU, in units of the largest coefficient: card
# (1.04e-5; TF32 control 9.5e-5), out of core (6.3e-6; control 3.6e-5)
LR_COEF_TOL = {"card": 3e-5, "outofcore": 2e-5}
# the summary against the CPU: each standard error relative, each t-value
# relative where |t| >= 1 and absolute where |t| < 1 (the intercept's
# 0.893), r2, RMSE relative, and g64, the resident fit's distance from
# float64 over the largest coefficient (the Part A fix).  Gaps (TF32
# control): 2.55e-6 (1.76e-4), 6.91e-6 (6.11e-4), 0.0148 (1.47), 0
# (7.64e-8), 0 (6.84e-7), 1.05e-5 (1e-3).  TF32 moves r2 by about one
# float32 ulp of 0.944 (5.96e-8), so its limit (2 ulp) guards the sums,
# not TF32, as GMM's log-likelihood limit does
LR_SUMMARY_TOL = {"se_rel": 2.5e-5, "t_rel": 7e-5, "t_abs": 0.15, "r2": 1.2e-7,
                  "rmse_rel": 2e-7, "g64": 1e-4}
LR_TF32_CAUGHT = ("se_rel", "t_rel", "t_abs", "rmse_rel", "g64")
# the final cost against "highest" (2.36e-5, 9.54e-6)
BF16_COST_RTOL = {"bf16": 2.5e-4, "bf16+fused_stats": 1e-4}
# against "highest": bf16 (1.18e-4, 2.43e-3, 3.78e-4), high = TF32 on the
# card (6.41e-6, 1.06e-3, 1.98e-4)
GMM_PREC_TOL = {"bf16": {"ll_rel": 1e-3, "means": 2.5e-2, "covariances": 4e-3},
                "high": {"ll_rel": 6e-5, "means": 1e-2, "covariances": 2e-3}}
# bisecting card vs CPU on the 200,000-row prefix, the cosine resident fit
# and the out-of-core route (in 4 blocks): PR 11's centers limit, and at
# most 4 rows (sizes: the summed leaf-size gap; rows: rows whose
# predicted leaf differs)
BISECT_CARD_TOL = {"centers": BISECT_CENTER_TOL, "sizes": 4, "rows": 4}
# out of core against resident on the 2M rows
BISECT_OOC_TOL = {"centers": BISECT_CENTER_TOL, "sizes": 20, "rows": 40}
BISECT_PREFIX_BLOCK = 1 << 16
BISECT_OOC_BLOCK = 1 << 19


def gbt_data():
    """bench.py's gbt20 data: ``_make_data(2M, 8, 16)``, seed 0, and
    ``y = x·β + N(0, 0.3)`` with β ~ N(0, 1) from a second seed-0 stream."""
    import numpy as np

    x = make_data(TREE_N, 8, 16)
    rng = np.random.default_rng(0)
    y = (x @ rng.normal(size=(8,)) + rng.normal(0.0, 0.3, size=TREE_N)).astype(np.float32)
    return x, y


def count_syncs(fn):
    """``fn()`` under the package's ``host_sync_census`` (``set_sync_debug_mode
    ("warn")``, one warning a blocking sync): → (its result, the host syncs
    it made)."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils.profiling import (
        host_sync_census,
    )

    with host_sync_census() as census:
        out = fn()
    return out, census["device_get"]


def tree_gap(a, b) -> float:
    """Two GBT models' largest leaf-value gap over their common rounds;
    inf when their split features differ (a control that splits elsewhere
    fails every limit)."""
    import numpy as np

    t = min(a.num_trees, b.num_trees)
    if not np.array_equal(a.split_feat[:t], b.split_feat[:t]):
        return float("inf")
    return float(np.abs(a.value[:t] - b.value[:t]).max())


def same_trees(a, b, value_tol: float) -> float:
    """Two GBT models with the same split features and thresholds; →
    their largest leaf-value gap, checked against ``value_tol``."""
    import numpy as np

    check(np.array_equal(a.split_feat, b.split_feat)
          and np.array_equal(a.threshold, b.threshold),
          "the two GBT fits split differently")
    gap = float(np.abs(a.value - b.value).max())
    check(gap <= value_tol, f"GBT leaf values {gap:.3g} apart (limit {value_tol:g})")
    return gap


def gbt_phase(port, H, card: str, tmp: str) -> int:
    """Slice 3e: GBTRegressor at bench.py's gbt20 shape (2M x 8, 20 rounds,
    depth 3): the fit and predict, the boost loop under
    ``set_sync_debug_mode("error")`` (no host sync between F0 and the final
    fetch), the fit's host syncs, K3's launches (20 x 4) timed with CUDA
    events; against the CPU route on a 200,000-row cut (integer labels:
    the same trees; float labels: predictions); GBTClassifier on the
    hospital stage's binarized LOS (2M rows) and its accuracy on the cut
    against the CPU's; a validation fit stopping where the CPU's stops; the
    boost out of core in 8 blocks against resident, and a preempted
    out-of-core fit resumed.  → K3 launches."""
    import numpy as np
    import torch

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models.tree import gbt
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults

    x, y = gbt_data()
    ds = port.device_dataset(x, y, device=DEV)
    est = port.GBTRegressor(max_iter=GBT_ROUNDS, max_depth=GBT_DEPTH, seed=0)
    est.fit(ds)                                              # warm-up
    H.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    model = est.fit(ds)
    sync()
    fit_s = time.perf_counter() - t0
    launches = H.launch_counts()["fused_level_hist"]
    check(launches == GBT_ROUNDS * (GBT_DEPTH + 1),
          f"gbt20 launched K3 {launches} times (expected {GBT_ROUNDS} x {GBT_DEPTH + 1})")
    check(model.num_trees == GBT_ROUNDS and np.isfinite(model.value).all(),
          "gbt20 model not 20 finite trees")
    t0 = time.perf_counter()
    pred = model.predict(ds.x)
    sync()
    pred_ms = (time.perf_counter() - t0) * 1e3
    rmse = port.RegressionEvaluator().evaluate(
        port.PredictionResult(prediction=pred, label=ds.y, weight=ds.w))
    check(np.isfinite(rmse) and rmse < float(y.std()), f"gbt20 RMSE {rmse} not below std(y)")

    # the boost loop, F0 to the final fetch, makes no host sync
    rounds = gbt._GBTParams._device_rounds

    def guarded(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return rounds(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    gbt._GBTParams._device_rounds = guarded
    try:
        again = est.fit(ds)
    finally:
        gbt._GBTParams._device_rounds = rounds
    same_trees(again, model, 0.0)
    _, syncs = count_syncs(lambda: est.fit(ds))
    with K3Events() as k3:
        est.fit(ds)
    k3_ms = k3.ms()
    say(f"gbt20 on {card}: GBTRegressor(max_iter={GBT_ROUNDS}, max_depth={GBT_DEPTH}) on "
        f"{TREE_N} x 8, fit {fit_s:.3f} s = {TREE_N / fit_s:.4g} rows/s ("
        f"{TREE_N * GBT_ROUNDS / fit_s:.4g} row-rounds/s); predict {pred_ms:.2f} ms, RMSE "
        f"{rmse:.6f}; K3 {launches} launches, {sum(k3_ms):.2f} ms in all "
        f"({100 * sum(k3_ms) / 1e3 / fit_s:.1f}% of the fit; per level, first round "
        f"{[round(t, 4) for t in k3_ms[:GBT_DEPTH + 1]]} ms); the boost loop under "
        f"set_sync_debug_mode('error'): no host sync; host syncs of the whole fit {syncs}")

    # card against the CPU route on a 200,000-row cut
    xs, ys = x[:PREFIX], y[:PREFIX]
    yi = np.round(ys)
    kw = dict(max_iter=GBT_ROUNDS, max_depth=GBT_DEPTH, seed=0)
    c_int = port.GBTRegressor(**kw).fit((xs, yi), device=DEV)
    t0 = time.perf_counter()
    p_int = port.GBTRegressor(**kw).fit((xs, yi), device="cpu")
    cpu_s = time.perf_counter() - t0
    v_gap = same_trees(c_int, p_int, GBT_VALUE_TOL)
    c_flt = port.GBTRegressor(**kw).fit((xs, ys), device=DEV)
    p_flt = port.GBTRegressor(**kw).fit((xs, ys), device="cpu")
    b = p_flt.predict_numpy(xs, device="cpu")

    def pred_gap(m, device):
        a = m.predict_numpy(xs, device=device)
        return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-6)).max())

    p_gap = pred_gap(c_flt, DEV)
    check(p_gap <= GBT_PRED_RTOL,
          f"gbt card vs CPU on float labels: predictions rel {p_gap:.3g} (limit {GBT_PRED_RTOL:g})")
    flips = int((c_flt.split_feat != p_flt.split_feat).sum()
                + (c_flt.threshold != p_flt.threshold).sum())
    # the controls, the CPU route on TF32-rounded rows: the features for
    # the integer labels (exact in TF32), the labels for the float ones
    v_ctl = tree_gap(port.GBTRegressor(**kw).fit((tf32_round(xs), yi), device="cpu"), p_int)
    p_ctl = pred_gap(port.GBTRegressor(**kw).fit((xs, tf32_round(ys)), device="cpu"), "cpu")
    check(v_ctl > GBT_VALUE_TOL and p_ctl > GBT_PRED_RTOL,
          f"the TF32-rounded controls pass the gbt limits: leaf values {v_ctl:.3g} (limit "
          f"{GBT_VALUE_TOL:g}), predictions rel {p_ctl:.3g} (limit {GBT_PRED_RTOL:g})")
    say(f"gbt card vs CPU on {PREFIX} rows (CPU fit {cpu_s:.2f} s): integer labels, the same "
        f"trees, leaf values {v_gap:.3g} apart (limit {GBT_VALUE_TOL:g}; the control on "
        f"TF32-rounded features {v_ctl:.3g}); float labels, predictions rel {p_gap:.3g} apart "
        f"(limit {GBT_PRED_RTOL:g}; the control on TF32-rounded labels {p_ctl:.3g}), {flips} "
        f"split entries differ (near ties)")

    # GBTClassifier on the hospital stage's binarized LOS
    cfg = port.PipelineConfig()
    table = port.Table.from_dict(hospital_events(TREE_N // 5), port.hospital_event_schema())
    table = port.Binarizer(port.LABEL_COL, "LOS_binary", cfg.los_threshold).transform(table)
    assembled = port.VectorAssembler(port.FEATURE_COLS).transform(table)
    cds = assembled.to_device(label_col="LOS_binary", device=DEV)
    clf = port.GBTClassifier(**kw)
    clf.fit(cds)
    H.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    cm = clf.fit(cds)
    sync()
    clf_s = time.perf_counter() - t0
    launches += H.launch_counts()["fused_level_hist"]
    acc = port.MulticlassClassificationEvaluator().evaluate(cm.transform(cds))
    xc = assembled.features[:PREFIX]
    yc = assembled.label("LOS_binary")[:PREFIX]
    acc_c = float((port.GBTClassifier(**kw).fit((xc, yc), device=DEV)
                   .predict_numpy(xc, device=DEV) == yc).mean())
    acc_p = float((port.GBTClassifier(**kw).fit((xc, yc), device="cpu")
                   .predict_numpy(xc, device="cpu") == yc).mean())
    check(acc_c == acc_p, f"gbt classifier accuracy on {PREFIX} rows: card {acc_c}, CPU {acc_p}")
    say(f"gbt classifier on the stage's binarized LOS ({TREE_N} x 4): fit {clf_s:.3f} s = "
        f"{TREE_N / clf_s:.4g} rows/s, accuracy {acc:.6f}; on {PREFIX} rows card {acc_c:.6f} "
        f"== CPU {acc_p:.6f}")
    del cds, table, assembled

    # the validation early stop (integer LOS, 30 % held out), card and CPU
    cols = hospital_events(GBT_VAL_N // 5, seed=11)
    cols[port.LABEL_COL] = np.round(cols[port.LABEL_COL])
    cols["is_val"] = (np.arange(GBT_VAL_N) % 10 < 3).astype(np.int64)
    vt = port.VectorAssembler(port.FEATURE_COLS).transform(port.Table.from_dict(cols))
    vkw = dict(max_iter=40, max_depth=5, step_size=0.5, seed=0, validation_indicator_col="is_val")
    H.reset_launch_counts()
    vc = port.GBTRegressor(**vkw).fit(vt, device=DEV)
    launches += H.launch_counts()["fused_level_hist"]
    vp = port.GBTRegressor(**vkw).fit(vt, device="cpu")
    check(vc.num_trees == vp.num_trees < 40,
          f"validation fit: the card kept {vc.num_trees} rounds, the CPU {vp.num_trees}")
    val_gap = same_trees(vc, vp, GBT_VAL_VALUE_TOL)
    # the control: the CPU fit on TF32-rounded features
    vt_ctl = port.VectorAssembler(port.FEATURE_COLS).transform(port.Table.from_dict(
        {c: tf32_round(v) if c in port.FEATURE_COLS else v for c, v in cols.items()}))
    vp_ctl = port.GBTRegressor(**vkw).fit(vt_ctl, device="cpu")
    val_ctl = tree_gap(vp_ctl, vp)
    check(val_ctl > GBT_VAL_VALUE_TOL,
          f"the TF32-rounded control passes the validation fit's limit: {vp_ctl.num_trees} "
          f"rounds, leaf values {val_ctl:.3g} (limit {GBT_VAL_VALUE_TOL:g})")
    say(f"gbt validation early stop ({GBT_VAL_N} rows, 30 % held out, max_iter 40): "
        f"{vc.num_trees} rounds kept on the card, the same on the CPU, the same trees, leaf "
        f"values {val_gap:.3g} apart (limit {GBT_VAL_VALUE_TOL:g}; the control on TF32-rounded "
        f"features: {vp_ctl.num_trees} rounds, {val_ctl:.3g})")

    # out of core in 8 blocks of 2^18, against resident; a preempt resumed
    hd = port.HostDataset(x=x, y=y, max_device_rows=GBT_BLOCK)
    H.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    ooc = est.fit(hd, device=DEV)
    ooc_s = time.perf_counter() - t0
    ooc_launches = H.launch_counts()["fused_level_hist"]
    launches += ooc_launches
    check(ooc_launches == GBT_ROUNDS * (GBT_DEPTH + 1) * hd.block_shape()[0],
          f"out-of-core gbt launched K3 {ooc_launches} times")
    o_gap = same_trees(ooc, model, GBT_OOC_VALUE_TOL)
    # the control: out of core on TF32-rounded labels
    o_ctl = tree_gap(est.fit(port.HostDataset(x=x, y=tf32_round(y), max_device_rows=GBT_BLOCK),
                             device=DEV), model)
    check(o_ctl > GBT_OOC_VALUE_TOL,
          f"the TF32-rounded control passes the out-of-core gbt limit: leaf values {o_ctl:.3g} "
          f"(limit {GBT_OOC_VALUE_TOL:g})")
    # the preempt (`==` only) on the first half of the rows: the script's time
    hk = port.HostDataset(x=x[:TREE_N // 2], y=y[:TREE_N // 2], max_device_rows=GBT_BLOCK)
    ckpt_kw = dict(max_iter=5, max_depth=GBT_DEPTH, seed=0)
    plain = port.GBTRegressor(**ckpt_kw).fit(hk, device=DEV)
    ck = port.GBTRegressor(**ckpt_kw, checkpoint_dir=os.path.join(tmp, "gbt_ck"))
    plan = faults.FaultPlan().crash("fit_ckpt.save.commit", after=2)
    with faults.active(plan):
        try:
            ck.fit(hk, device=DEV)
            fail("the preempted out-of-core gbt fit was not stopped")
        except faults.InjectedCrash:
            pass
    resumed = ck.fit(hk, device=DEV)
    same_trees(resumed, plain, 0.0)
    say(f"gbt out of core ({hd.block_shape()[0]} blocks of {GBT_BLOCK}): fit {ooc_s:.3f} s = "
        f"{TREE_N / ooc_s:.4g} rows/s, K3 {ooc_launches} launches; against resident the same "
        f"trees, leaf values {o_gap:.3g} apart (limit {GBT_OOC_VALUE_TOL:g}; the control on "
        f"TF32-rounded labels {o_ctl:.3g}); a fit on the first {hk.n} rows preempted at "
        f"round 2's commit resumed to the same trees")
    return launches


def lr_phase(port, card: str) -> None:
    """Slice 3e: LinearRegression on the stage's 2M hospital rows — the
    elastic net (reg 0.1, mix 0.5) resident and out of core against the
    CPU route (n_iter equal, coefficients 1e-4 of the largest), the
    training summary against the CPU's (each standard error and each
    t-value on its own scale), and the resident fit's chunked Gram against
    float64; every limit also faces the same fit with TF32 products, which
    must fail it."""
    import numpy as np

    cols = hospital_events(TREE_N // 5)
    xl = np.stack([cols[c] for c in port.FEATURE_COLS], axis=1)
    yl = cols[port.LABEL_COL]
    del cols
    ds = port.device_dataset(xl, yl, device=DEV)
    en = port.LinearRegression(reg_param=0.1, elastic_net_param=0.5)
    en.fit(ds)
    sync()
    t0 = time.perf_counter()
    m = en.fit(ds)
    sync()
    en_s = time.perf_counter() - t0
    mc = en.fit((xl, yl), device="cpu")
    hl = port.HostDataset(x=xl, y=yl, max_device_rows=LR_OOC_BLOCK)
    mo = en.fit(hl, device=DEV)
    with tf32_matmuls():
        m_ctl, mo_ctl = en.fit(ds), en.fit(hl, device=DEV)

    def coefs(model):
        return np.r_[model.coefficients.cpu().numpy(), float(model.intercept)]

    scale = float(np.abs(coefs(mc)).max())
    g_cpu = float(np.abs(coefs(m) - coefs(mc)).max())
    g_ooc = float(np.abs(coefs(mo) - coefs(mc)).max())
    g_ctl = float(np.abs(coefs(m_ctl) - coefs(mc)).max())
    g_ooc_ctl = float(np.abs(coefs(mo_ctl) - coefs(mc)).max())
    # the gaps in units of the largest coefficient
    g_cpu, g_ooc, g_ctl, g_ooc_ctl = (g / scale for g in (g_cpu, g_ooc, g_ctl, g_ooc_ctl))
    lim_c, lim_o = LR_COEF_TOL["card"], LR_COEF_TOL["outofcore"]
    check(m.fit_info["n_iter"] == mc.fit_info["n_iter"] == mo.fit_info["n_iter"],
          f"elastic net n_iter: card {m.fit_info}, CPU {mc.fit_info}, out of core {mo.fit_info}")
    check(g_cpu <= lim_c and g_ooc <= lim_o,
          f"elastic net coefficients from the CPU route: card {g_cpu:.3g} (limit {lim_c:g}), "
          f"out of core {g_ooc:.3g} (limit {lim_o:g}) of the largest")
    check(g_ctl > lim_c and g_ooc_ctl > lim_o,
          f"the TF32 controls pass the elastic net limits: card {g_ctl:.3g} (limit {lim_c:g}), "
          f"out of core {g_ooc_ctl:.3g} (limit {lim_o:g})")
    say(f"linear regression elastic net (reg 0.1, mix 0.5) on {len(yl)} hospital rows: fit "
        f"{en_s * 1e3:.2f} ms, n_iter {m.fit_info['n_iter']} with {m.fit_info['host_syncs']} "
        f"host syncs (CPU and out of core the same n_iter); coefficients {coefs(m)}; from the "
        f"CPU route, in units of the largest ({scale:.3g}): card {g_cpu:.3g} (limit {lim_c:g}; "
        f"TF32 control {g_ctl:.3g}), out of core {g_ooc:.3g} (limit {lim_o:g}; TF32 control "
        f"{g_ooc_ctl:.3g})")

    plain = port.LinearRegression()
    t0 = time.perf_counter()
    r = plain.fit(ds)
    sync()
    r_s = time.perf_counter() - t0
    rc = plain.fit((xl, yl), device="cpu")
    sc = rc.summary

    def summary_gaps(s) -> dict:
        # each standard error relative to the CPU's; each t-value on its
        # own scale: relative where |t| >= 1, absolute where |t| < 1 (a
        # coefficient within a standard error of 0, the intercept here,
        # whose t is its coefficient's rounding over that error)
        dt = np.abs(s.t_values - sc.t_values)
        big = np.abs(sc.t_values) >= 1.0
        return {"se_rel": float((np.abs(s.coefficient_standard_errors
                                        - sc.coefficient_standard_errors)
                                 / sc.coefficient_standard_errors).max()),
                "t_rel": float((dt[big] / np.abs(sc.t_values[big])).max(initial=0.0)),
                "t_abs": float(dt[~big].max(initial=0.0)),
                "r2": abs(s.r2 - sc.r2),
                "rmse_rel": abs(s.root_mean_squared_error / sc.root_mean_squared_error - 1)}

    exact = np.linalg.lstsq(np.c_[xl.astype(np.float32).astype(np.float64), np.ones(len(yl))],
                            yl.astype(np.float32).astype(np.float64), rcond=None)[0]
    x_scale = float(np.abs(exact).max())
    s = r.summary
    gaps = summary_gaps(s)
    gaps["g64"] = float(np.abs(coefs(r) - exact).max()) / x_scale
    g64_cpu = float(np.abs(coefs(rc) - exact).max()) / x_scale
    with tf32_matmuls():      # the summary is lazy: every metric read in here
        r_ctl = plain.fit(ds)
        ctl = summary_gaps(r_ctl.summary)
    ctl["g64"] = float(np.abs(coefs(r_ctl) - exact).max()) / x_scale
    over = {a: gaps[a] for a in LR_SUMMARY_TOL if not gaps[a] <= LR_SUMMARY_TOL[a]}
    check(not over, f"summary card vs CPU over the limits: {over} (limits {LR_SUMMARY_TOL})")
    missed = {a: ctl[a] for a in LR_TF32_CAUGHT if not ctl[a] > LR_SUMMARY_TOL[a]}
    check(not missed, f"the TF32 control passes the summary limits {missed} "
                      f"(limits {LR_SUMMARY_TOL})")
    say(f"linear regression summary ({len(yl)} rows, fit {r_s * 1e3:.2f} ms): r2 {s.r2:.8f}, "
        f"RMSE {s.root_mean_squared_error:.8f}, t-values {np.round(s.t_values, 3).tolist()}; "
        f"card vs CPU: " + ", ".join(
            f"{a} {gaps[a]:.3g} (limit {LR_SUMMARY_TOL[a]:g}; TF32 control {ctl[a]:.3g})"
            for a in LR_SUMMARY_TOL)
        + f"; g64 is the chunked Gram sum's distance from float64 in units of the largest "
        f"coefficient ({g64_cpu:.3g} on the CPU)")


# ---------------------------------------------- slice 4c: precision modes
def precision_phase(port, ds, highest, card: str) -> None:
    """Slice 4c: KMeans k=256 on the flagship 10M x 8 rows with
    ``matmul_precision="bf16"``, with and without ``fused_stats``, against
    the main path's "highest" fit (fit s, Lloyd records/s, n_iter, final
    cost); GaussianMixture k=32 on config 3's law (2M rows) in "bf16" and
    "high" against "highest" (EM records/s, ll, means, covariances)."""
    import numpy as np
    import torch

    for tag, kw in (("bf16", dict(matmul_precision="bf16")),
                    ("bf16+fused_stats", dict(matmul_precision="bf16", fused_stats=True))):
        est = port.KMeans(k=K, seed=SEED, max_iter=MAX_ITER, **kw)
        sync()
        t0 = time.perf_counter()
        m = est.fit(ds)
        sync()
        fit_s = time.perf_counter() - t0
        rel = abs(m.training_cost / highest.training_cost - 1)
        check(np.isfinite(m.training_cost) and rel <= BF16_COST_RTOL[tag],
              f"KMeans {tag}: cost {m.training_cost} vs highest {highest.training_cost} "
              f"(rel {rel:.3g}, limit {BF16_COST_RTOL[tag]:g})")
        check(float(m.cluster_sizes.sum()) == N, f"KMeans {tag}: sizes do not sum to n")
        say(f"kmeans k={K} {tag} on {card}: fit {fit_s:.3f} s, n_iter {m.n_iter}, "
            f"{N * m.n_iter / fit_s:.4g} Lloyd records/s; final cost {m.training_cost:.8g} "
            f"vs highest {highest.training_cost:.8g} (n_iter {highest.n_iter}): rel "
            f"{rel:.3g} (limit {BF16_COST_RTOL[tag]:g})")

    x = make_data(TREE_N, D, GMM_K)
    xd = port.device_dataset(x, device=DEV)
    fits = {}
    for prec in ("highest", "bf16", "high"):
        est = port.GaussianMixture(k=GMM_K, max_iter=GMM_ITERS, tol=0.0, seed=SEED,
                                   matmul_precision=prec)
        sync()
        t0 = time.perf_counter()
        fits[prec] = (est.fit(xd), time.perf_counter() - t0)
    ref = fits["highest"][0]
    parts = [f"highest {TREE_N * ref.n_iter / fits['highest'][1]:.4g} EM records/s, ll "
             f"{ref.log_likelihood:.8g}"]
    for prec in ("bf16", "high"):
        m, s = fits[prec]
        gaps = {"ll_rel": abs(m.log_likelihood / ref.log_likelihood - 1),
                "means": float(np.abs(m.means - ref.means).max()),
                "covariances": float(np.abs(m.covariances - ref.covariances).max())}
        lim = GMM_PREC_TOL[prec]
        check(np.isfinite(m.log_likelihood) and all(gaps[a] <= lim[a] for a in lim),
              f"GMM {prec} against highest: {gaps} (limits {lim})")
        parts.append(f"{prec} {TREE_N * m.n_iter / s:.4g} EM records/s, ll "
                     f"{m.log_likelihood:.8g}, against highest "
                     + ", ".join(f"{a} {gaps[a]:.3g} (limit {lim[a]:g})" for a in lim))
    say(f"gmm k={GMM_K} precision modes on {card} ({TREE_N} x {D}, {GMM_ITERS} EM "
        f"iterations): " + "; ".join(parts))
    del xd
    torch.cuda.empty_cache()


def tree_gaps(a, b, x) -> dict:
    """Two BisectingKMeans models against each other: whether they made
    the same splits (``fit_info["splits"]``, [level, parent, new leaf],
    and n_iter), their largest center gap, the summed gap of their leaf
    sizes, and the rows of ``x`` whose predicted leaf (K2) differs.  With
    the same splits, a row predicted to the same leaf sits in the same
    leaf at every level: its ancestors are that leaf's."""
    import numpy as np

    same = a.fit_info["splits"] == b.fit_info["splits"] and a.n_iter == b.n_iter
    shaped = same and a.cluster_centers.shape == b.cluster_centers.shape
    inf = float("inf")
    return {
        "same_splits": same,
        "centers": float(np.abs(a.cluster_centers - b.cluster_centers).max()) if shaped else inf,
        "sizes": float(np.abs(a.cluster_sizes - b.cluster_sizes).sum()) if shaped else inf,
        "rows": int((a.predict_numpy(x, device=DEV) != b.predict_numpy(x, device=DEV)).sum())
        if shaped else len(x),
    }


def held(gaps: dict, tol: dict) -> bool:
    """The same splits and every gap within its limit."""
    return gaps["same_splits"] and all(gaps[a] <= tol[a] for a in tol)


def gaps_text(gaps: dict, tol: dict, ctl: dict) -> str:
    return ", ".join(f"{a} {gaps[a]:.3g} (limit {tol[a]:g}; control {ctl[a]:.3g})"
                     for a in tol)


def bisecting_more(port, L, card: str) -> int:
    """Slice 4c at config 4's shape (2M x 8, k=8): the cosine fit (card
    against the CPU on the 200,000-row prefix, the CPU fit on TF32-rounded
    rows as the control) and a weighted fit, each predicting through
    K2, and the out-of-core fit in blocks of 2^19 against resident (the
    control: out of core on TF32-rounded rows) and on the card against the
    CPU on the prefix (the control: the CPU on TF32-rounded rows).  Each comparison holds the
    split tree (``tree_gaps``); every limit must fail its control.
    → K2 launches."""
    import numpy as np

    x = make_data(BISECT_N, D, BISECT_K)
    kw = dict(k=BISECT_K, seed=SEED, n_restarts=1)
    k2 = 0
    est = port.BisectingKMeans(distance_measure="cosine", **kw)
    sync()
    t0 = time.perf_counter()
    cos = est.fit(x, device=DEV)
    cos_s = time.perf_counter() - t0
    check(np.allclose(np.linalg.norm(cos.cluster_centers, axis=1), 1.0, atol=1e-5)
          and float(cos.cluster_sizes.sum()) == BISECT_N, "cosine bisecting: centers not unit")
    before = L.launch_counts()["fused_assign"]
    cos.predict_numpy(x, device=DEV)
    k2 += L.launch_counts()["fused_assign"] - before
    sub = x[:PREFIX]
    c_cpu = est.fit(sub, device="cpu")
    c_gaps = tree_gaps(est.fit(sub, device=DEV), c_cpu, sub)
    c_ctl = tree_gaps(est.fit(tf32_round(sub), device="cpu"), c_cpu, sub)
    check(held(c_gaps, BISECT_CARD_TOL),
          f"cosine bisecting card vs CPU: {c_gaps} (limits {BISECT_CARD_TOL})")
    missed = [a for a in BISECT_CARD_TOL if not c_ctl[a] > BISECT_CARD_TOL[a]]
    check(not missed, f"the TF32-rounded control passes the cosine bisecting limits {missed}: "
                      f"{c_ctl}")
    w = np.random.default_rng(3).integers(0, 4, BISECT_N).astype(np.float32)
    t0 = time.perf_counter()
    wm = port.BisectingKMeans(**kw).fit(port.device_dataset(x, weights=w, device=DEV))
    w_s = time.perf_counter() - t0
    check(float(wm.cluster_sizes.sum()) == float(w.sum()), "weighted bisecting: sizes != sum w")
    say(f"bisecting k={BISECT_K} cosine on {card}: fit {cos_s:.3f} s = "
        f"{BISECT_N / cos_s:.4g} records/s, {len(cos.fit_info['levels'])} levels; card vs CPU "
        f"on {PREFIX} rows: the same splits {cos.fit_info['splits']}, "
        f"{gaps_text(c_gaps, BISECT_CARD_TOL, c_ctl)} (the control on TF32-rounded rows: splits "
        f"{'the same' if c_ctl['same_splits'] else 'differ'}); weighted (w in 0..3) fit "
        f"{w_s:.3f} s, sizes sum to sum(w)")

    res = port.BisectingKMeans(**kw).fit(x, device=DEV)
    hd = port.HostDataset(x=x, max_device_rows=BISECT_OOC_BLOCK)
    sync()
    t0 = time.perf_counter()
    ooc = port.BisectingKMeans(**kw).fit(hd, device=DEV)
    ooc_s = time.perf_counter() - t0
    before = L.launch_counts()["fused_assign"]
    ooc.predict_numpy(x, device=DEV)
    k2 += L.launch_counts()["fused_assign"] - before
    o_gaps = tree_gaps(ooc, res, x)
    o_ctl = tree_gaps(port.BisectingKMeans(**kw).fit(
        port.HostDataset(x=tf32_round(x), max_device_rows=BISECT_OOC_BLOCK), device=DEV), res, x)
    check(held(o_gaps, BISECT_OOC_TOL),
          f"out-of-core bisecting against resident: {o_gaps} (limits {BISECT_OOC_TOL})")
    missed = [a for a in BISECT_OOC_TOL if not o_ctl[a] > BISECT_OOC_TOL[a]]
    check(not missed, f"the TF32-rounded control passes the out-of-core bisecting limits "
                      f"{missed}: {o_ctl}")
    # the out-of-core route on the card against itself on the CPU (one
    # distance form): PR 11's card-vs-CPU limits; the control is the CPU
    # route on TF32-rounded rows (the route's one product, the one-hot
    # sums, barely moves under TF32)
    est = port.BisectingKMeans(**kw)

    def blocks(rows):
        return port.HostDataset(x=rows, max_device_rows=BISECT_PREFIX_BLOCK)

    s_cpu = est.fit(blocks(sub), device="cpu")
    s_gaps = tree_gaps(est.fit(blocks(sub), device=DEV), s_cpu, sub)
    s_ctl = tree_gaps(est.fit(blocks(tf32_round(sub)), device="cpu"), s_cpu, sub)
    check(held(s_gaps, BISECT_CARD_TOL),
          f"out-of-core bisecting card vs CPU: {s_gaps} (limits {BISECT_CARD_TOL})")
    missed = [a for a in BISECT_CARD_TOL if not s_ctl[a] > BISECT_CARD_TOL[a]]
    check(not missed, f"the TF32-rounded control passes the out-of-core card-vs-CPU limits "
                      f"{missed}: {s_ctl}")
    info = ooc.fit_info
    say(f"bisecting out of core ({hd.block_shape()[0]} blocks of {BISECT_OOC_BLOCK}): fit "
        f"{ooc_s:.3f} s = {BISECT_N / ooc_s:.4g} records/s, Lloyd iterations a level "
        f"{info['levels']}, {info['host_syncs']} host syncs; against resident the same splits "
        f"{info['splits']}, {gaps_text(o_gaps, BISECT_OOC_TOL, o_ctl)} (the control on "
        f"TF32-rounded rows: splits {'the same' if o_ctl['same_splits'] else 'differ'}); "
        f"card vs CPU out of core on {PREFIX} rows in blocks of {BISECT_PREFIX_BLOCK}: the same "
        f"splits, {gaps_text(s_gaps, BISECT_CARD_TOL, s_ctl)} (the control on TF32-rounded rows: splits "
        f"{'the same' if s_ctl['same_splits'] else 'differ'})")
    return k2


# ------------------------------ slice 5a: the LOS_binary classifiers (K3)
# The binomial fits and LinearSVC stop at tol 1e-3: on the raw hospital
# features (occupancy up to 400, with an intercept) the reference's Newton
# step shrinks only linearly under its trace-scaled jitter, and near the
# default tol (1e-6) the step is float32 rounding, so where a fit stops is
# decided by rounding in either package (ROADMAP queue 3); at 1e-3
# consecutive steps differ by a fifth, and the stop is the algorithm's.
# The multinomial fit stops at the cap of examples/model_diagnostics.py
# (max_iter 30), its step being the drift along its null direction; a small
# ridge (0.01) keeps its other directions off that drift's rounding kicks,
# which without it part the card's, the CPU's and the out-of-core
# parameters by up to 3e-5 of the largest.  The example's own fits
# (EXAMPLE_KW: the default tol, no ridge, 30 steps) run too, held where
# that drift cannot reach: probabilities, predictions, accuracy, AUC.
CLS_TOL = 1e-3
MULTI_KW = {"family": "multinomial", "max_iter": 30, "reg_param": 0.01}
EXAMPLE_KW = {"binomial_example": {"max_iter": 30},
              "multinomial_example": {"family": "multinomial", "max_iter": 30}}
CLS_BLOCK = 1 << 18                       # the out-of-core fits: 8 blocks of 2M rows
NB_N, NB_D, NB_K = 10_000_000, 32, 8      # bench.py _bench_naive_bayes
NB_PREFIX = 1_000_000                     # card against CPU
# card-vs-CPU and out-of-core-vs-resident limits: about 10x the gap of the
# first chip run (NVIDIA H100 80GB HBM3, 700 W), and one float32 ulp (1.2e-7
# relative) where that gap was 0 or below an ulp.  A control must fail each
# limit but the exact ones (CLS_EXACT: counts and integer sums held equal:
# n_iter, the gaussian priors, the rows predicted otherwise, whose controls
# are printed all the same).  The controls: the same route on TF32-rounded
# rows for the binomial and SVC fits (TF32 does not reach their small
# batched products), TF32 products for the multinomial fit and the gaussian
# NaiveBayes; for the areas, the ROC and PR passes over the card's scores
# rounded to bfloat16 (near scores tie or swap: a wrong score order); for
# the example's fits also the fit one Newton step short.  "proba" is the
# largest difference of a probability, "rows" the rows predicted otherwise.
CLS_LIMITS = {
    "binomial": {"n_iter": 0, "coef": 1.2e-7, "auc": 1.2e-7, "aupr": 1.2e-6, "accuracy": 1.2e-7,
                 "weighted_f": 1.2e-7},
    "binomial_ooc": {"n_iter": 0, "coef": 1.2e-7},
    "multinomial": {"n_iter": 0, "coef": 1.4e-6, "accuracy": 1.2e-7, "weighted_f": 1.2e-7},
    "multinomial_ooc": {"n_iter": 0, "coef": 1.4e-6},
    "binomial_example": {"n_iter": 0, "proba": 9.2e-6, "rows": 0, "accuracy": 1.2e-7,
                         "auc": 1.2e-7},
    "multinomial_example": {"n_iter": 0, "proba": 1.9e-5, "rows": 0, "accuracy": 1.2e-7},
    "gaussian_nb": {"pi": 0.0, "theta": 8.8e-6, "sigma": 3.3e-4},
    "svc": {"n_iter": 0, "coef": 1.2e-7},
    "svc_ooc": {"n_iter": 0, "coef": 6.6e-7},
}
CLS_EXACT = ("n_iter", "pi", "rows")


def gated(limits: dict, name: str, gaps: dict, ctl: dict, exact=(), no_control=None) -> str:
    """Every gap within its ``limits[name]`` limit, and the control over
    each limit but the ``exact`` ones and those in ``no_control`` ({(name,
    metric): why}); → the gaps as text, each beside its limit and its
    control."""
    tol, no_control = limits[name], no_control or {}
    over = {a: gaps[a] for a in tol if not gaps[a] <= tol[a]}
    check(not over, f"{name}: over the limits {over} (limits {tol})")
    missed = {a: ctl.get(a) for a in tol if a not in exact
              and (name, a) not in no_control and not ctl.get(a, 0.0) > tol[a]}
    check(not missed, f"{name}: the control passes the limits {missed} (limits {tol})")

    def control(a):
        if (name, a) in no_control:
            return f"no control: {no_control[(name, a)]}"
        if a in exact:
            return "exact" + (f"; control {ctl[a]:.3g}" if a in ctl else "")
        return f"control {ctl[a]:.3g}"

    return ", ".join(f"{a} {gaps[a]:.3g} (limit {tol[a]:g}; {control(a)})" for a in tol)


def cls_gated(name: str, gaps: dict, ctl: dict) -> str:
    return gated(CLS_LIMITS, name, gaps, ctl, exact=CLS_EXACT)


def worst(*ctls: dict) -> dict:
    """Several controls' gaps → each metric's largest."""
    return {a: max(c[a] for c in ctls if a in c) for c in ctls for a in c}


def as_text(gaps: dict) -> str:
    return ", ".join(f"{a} {v:.3g}" for a, v in gaps.items())


def area_control(port, m, x, y, want) -> dict:
    """The areas' control: the ROC and PR passes on the card over ``m``'s
    scores on ``x`` rounded to bfloat16, against ``want``'s areas."""
    import torch

    scores = m.predict_proba(torch.from_numpy(x).to(DEV)).bfloat16().float()
    labels = torch.from_numpy(y).to(DEV)
    return {a: abs(port.BinaryClassificationEvaluator(metric).evaluate(scores, labels) - ref)
            for a, metric, ref in (("auc", "areaUnderROC", want.area_under_roc),
                                   ("aupr", "areaUnderPR", want.area_under_pr))}


def lr_theta(m):
    """A fitted linear model's parameters as one float64 array: [coef |
    intercept], the softmax's class-centred (its null direction, a vector
    added to every class, is rounding in both packages)."""
    import numpy as np

    if hasattr(m, "coefficient_matrix"):
        t = np.c_[m.coefficient_matrix.cpu().numpy(), m.intercept_vector.cpu().numpy()]
        return (t - t.mean(axis=0)).astype(np.float64)
    coef = m.coefficients.cpu().numpy() if hasattr(m.coefficients, "cpu") else m.coefficients
    return np.r_[np.asarray(coef, np.float64), float(m.intercept)]


def fit_gaps(a, b) -> dict:
    """n_iter apart, and the parameters apart in units of ``b``'s largest."""
    import numpy as np

    ta, tb = lr_theta(a), lr_theta(b)
    return {"n_iter": abs(a.n_iter - b.n_iter),
            "coef": float(np.abs(ta - tb).max() / np.abs(tb).max())}


def summary_gaps(a, b) -> dict:
    """Two training summaries' metrics apart (the areas for the binary one)."""
    gaps = {"accuracy": abs(a.accuracy - b.accuracy),
            "weighted_f": abs(a.weighted_f_measure - b.weighted_f_measure)}
    if hasattr(a, "area_under_roc"):
        gaps["auc"] = abs(a.area_under_roc - b.area_under_roc)
        gaps["aupr"] = abs(a.area_under_pr - b.area_under_pr)
    return gaps


def timed_fit(est, data):
    """``est.fit(data)`` on the card after a warm-up → (model, seconds,
    host syncs of a third fit)."""
    est.fit(data, device=DEV)
    sync()
    t0 = time.perf_counter()
    model = est.fit(data, device=DEV)
    sync()
    fit_s = time.perf_counter() - t0
    _, syncs = count_syncs(lambda: est.fit(data, device=DEV))
    return model, fit_s, syncs


def logistic_part(port, name: str, est, x, y, card: str, tf32_products: bool) -> None:
    """One LogisticRegression family on the 2M hospital rows: resident fit
    (s, records/s, host syncs) and its summary; the card against the CPU
    route on the 200,000-row prefix (n_iter, parameters, summary metrics);
    out of core in blocks of 2^18 against resident.  The controls: the
    same fits with TF32 products (``tf32_products``) or on TF32-rounded
    rows."""
    import numpy as np

    n = len(y)
    ds = port.device_dataset(x, y, device=DEV)
    m, fit_s, syncs = timed_fit(est, ds)
    s = m.summary
    check(np.isfinite(lr_theta(m)).all() and 0.0 < s.accuracy <= 1.0,
          f"{name} LogisticRegression: parameters not finite or accuracy {s.accuracy}")
    xp, yp = x[:PREFIX], y[:PREFIX]
    mc = est.fit((xp, yp), device="cpu")
    md = est.fit((xp, yp), device=DEV)
    gaps = {**fit_gaps(md, mc), **summary_gaps(md.summary, mc.summary)}
    hd = port.HostDataset(x=x, y=y, max_device_rows=CLS_BLOCK)
    sync()
    t0 = time.perf_counter()
    mo = est.fit(hd, device=DEV)
    sync()
    ooc_s = time.perf_counter() - t0
    _, ooc_syncs = count_syncs(lambda: est.fit(hd, device=DEV))
    o_gaps = fit_gaps(mo, m)
    with tf32_matmuls() if tf32_products else contextlib.nullcontext():
        rows = xp if tf32_products else tf32_round(xp)
        mt = est.fit((rows, yp), device=DEV)
        # the summary is lazy: its metrics are read in here
        ctl = {**fit_gaps(mt, mc), **summary_gaps(mt.summary, mc.summary)}
    if name == "binomial":
        ctl = worst(ctl, area_control(port, md, xp, yp, mc.summary))
    with tf32_matmuls() if tf32_products else contextlib.nullcontext():
        rows = x if tf32_products else tf32_round(x)
        o_ctl = fit_gaps(est.fit(port.HostDataset(x=rows, y=y, max_device_rows=CLS_BLOCK),
                                 device=DEV), m)
    text = cls_gated(name, gaps, ctl)
    o_text = cls_gated(f"{name}_ooc", o_gaps, o_ctl)
    extra = (f"AUC {s.area_under_roc:.6f}, AUPR {s.area_under_pr:.6f}, max-F1 threshold "
             f"{s.max_f_measure_threshold:.4f}, " if name == "binomial" else "")
    say(f"{name} LogisticRegression(tol={est.tol:g}, max_iter={est.max_iter}, "
        f"reg_param={est.reg_param:g}) on {card}, "
        f"{n} hospital rows: fit "
        f"{fit_s:.3f} s = {n / fit_s:.4g} records/s ({n * m.n_iter / fit_s:.4g} row-steps/s), "
        f"n_iter {m.n_iter}, host syncs a fit {syncs}; summary {extra}accuracy "
        f"{s.accuracy:.6f}, weighted precision {s.weighted_precision:.6f} recall "
        f"{s.weighted_recall:.6f} F1 {s.weighted_f_measure:.6f}; card vs CPU on {PREFIX} rows: "
        f"{text}; out of core ({hd.block_shape()[0]} blocks of {CLS_BLOCK}) {ooc_s:.3f} s = "
        f"{n / ooc_s:.4g} records/s, {ooc_syncs} host syncs, against resident: {o_text}")


def example_part(port, x, yb, tiers, card: str) -> None:
    """``examples/model_diagnostics.py``'s own fits (``EXAMPLE_KW``: the
    default tol, no ridge, 30 Newton steps) on the 2M hospital rows,
    timed; the card against the CPU on the prefix where the parameters'
    rounding drift cannot reach: n_iter, probabilities, predictions,
    accuracy, and the binomial's AUC.  The controls: the fit on
    TF32-rounded rows (binomial) or with TF32 products (multinomial), the
    fit one Newton step short, and the AUC over bfloat16-rounded scores."""
    import dataclasses

    import numpy as np
    import torch

    def scored(m, rows, dev):
        xt = torch.from_numpy(rows).to(dev)
        return m.predict_proba(xt).cpu().numpy(), m.predict(xt).cpu().numpy()

    xp = x[:PREFIX]
    for name, y in (("binomial_example", yb), ("multinomial_example", tiers)):
        binomial = name == "binomial_example"
        est = port.LogisticRegression(**EXAMPLE_KW[name])
        m, fit_s, syncs = timed_fit(est, port.device_dataset(x, y, device=DEV))
        s = m.summary
        check(np.isfinite(lr_theta(m)).all() and 0.0 < s.accuracy <= 1.0,
              f"{name}: parameters not finite or accuracy {s.accuracy}")
        yp = y[:PREFIX]
        mc = est.fit((xp, yp), device="cpu")
        pc, qc = scored(mc, xp, "cpu")

        def gaps(m2) -> dict:
            p, q = scored(m2, xp, DEV)
            g = {"n_iter": abs(m2.n_iter - mc.n_iter), "proba": float(np.abs(p - pc).max()),
                 "rows": int((q != qc).sum()),
                 "accuracy": abs(m2.summary.accuracy - mc.summary.accuracy)}
            if binomial:
                g["auc"] = abs(m2.summary.area_under_roc - mc.summary.area_under_roc)
            return g

        md = est.fit((xp, yp), device=DEV)
        got = gaps(md)
        with contextlib.nullcontext() if binomial else tf32_matmuls():
            c_round = gaps(est.fit((tf32_round(xp) if binomial else xp, yp), device=DEV))
        c_short = gaps(dataclasses.replace(est, max_iter=mc.n_iter - 1).fit((xp, yp), device=DEV))
        c_areas = area_control(port, md, xp, yp, mc.summary) if binomial else {}
        text = cls_gated(name, got, worst(c_round, c_short, c_areas))
        shown = (f"AUC {s.area_under_roc:.6f}, AUPR {s.area_under_pr:.6f}, max-F1 threshold "
                 f"{s.max_f_measure_threshold:.4f}, " if binomial else "")
        say(f"{name}: LogisticRegression({EXAMPLE_KW[name]}) as examples/model_diagnostics.py "
            f"on {card}, {len(y)} hospital rows: fit {fit_s:.3f} s = {len(y) / fit_s:.4g} "
            f"records/s, n_iter {m.n_iter}, host syncs a fit {syncs}; summary {shown}accuracy "
            f"{s.accuracy:.6f}, weighted F1 {s.weighted_f_measure:.6f}; card vs CPU on {PREFIX} "
            f"rows: {text}; the controls apart: "
            f"{'TF32-rounded rows' if binomial else 'TF32 products'} ({as_text(c_round)}), "
            f"one step short ({as_text(c_short)}), bfloat16 scores ({as_text(c_areas)})")


def naive_bayes_part(port, x, yb, card: str) -> None:
    """NaiveBayes at bench.py's ``_bench_naive_bayes`` shape (10M x 32
    Poisson(3) counts drawn on the card, k=8, multinomial, seed 0): fit
    records/s and the fit's peak device memory beside the
    bytes bound (4·(d+1) bytes a row at 3.35 TB/s); card against CPU on
    1M rows, equal (integer sums below 2**24 are exact in any order; the
    control moves one count by one); the gaussian type on the hospital
    rows, card against CPU (TF32 control)."""
    import numpy as np
    import torch

    g = torch.Generator(device=DEV).manual_seed(0)
    xn = torch.poisson(torch.full((NB_N, NB_D), 3.0, device=DEV), generator=g)
    yn = torch.randint(0, NB_K, (NB_N,), device=DEV, generator=g).to(torch.float32)
    ds = port.DeviceDataset(x=xn, y=yn, w=torch.ones((NB_N,), device=DEV))
    xp, yp = xn[:NB_PREFIX].cpu().numpy(), yn[:NB_PREFIX].cpu().numpy()
    del xn, yn
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    est = port.NaiveBayes()
    est.fit(ds)
    sync()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        m = est.fit(ds)
    sync()
    fit_s = (time.perf_counter() - t0) / reps
    _, syncs = count_syncs(lambda: est.fit(ds))
    check(np.isfinite(m.pi).all() and np.isfinite(m.theta).all() and m.theta.shape == (NB_K, NB_D),
          "NaiveBayes: parameters not finite (8, 32)")
    peak = torch.cuda.max_memory_allocated() if DEV == "cuda" else 0
    del ds
    bound = HBM_BYTES_PER_S / (4 * (NB_D + 1))
    mc = est.fit((xp, yp), device="cpu")
    md = est.fit((xp, yp), device=DEV)
    check(np.array_equal(md.pi, mc.pi) and np.array_equal(md.theta, mc.theta),
          "NaiveBayes card vs CPU: pi or theta differ")
    moved = xp.copy()
    moved[0, 0] += 1.0
    ctl = est.fit((moved, yp), device="cpu")
    check(not np.array_equal(md.theta, ctl.theta), "NaiveBayes: one count moved by one went unseen")
    del xp, yp, moved

    g = port.NaiveBayes(model_type="gaussian")
    gm, g_s, g_syncs = timed_fit(g, port.device_dataset(x, yb, device=DEV))
    gc = g.fit((x, yb), device="cpu")

    def nb_gaps(a):
        return {"pi": float(np.abs(a.pi - gc.pi).max()),
                "theta": float(np.abs(a.theta - gc.theta).max() / np.abs(gc.theta).max()),
                "sigma": float((np.abs(a.sigma - gc.sigma) / gc.sigma).max())}

    with tf32_matmuls():
        g_ctl = nb_gaps(g.fit((x, yb), device=DEV))
    text = cls_gated("gaussian_nb", nb_gaps(gm), g_ctl)
    say(f"NaiveBayes multinomial k={NB_K} on {card}, {NB_N} x {NB_D} Poisson(3) rows: fit "
        f"{fit_s * 1e3:.2f} ms = {NB_N / fit_s:.4g} records/s against the bytes bound "
        f"{bound:.4g} records/s (4*(d+1) B a row at 3.35 TB/s: {100 * NB_N / fit_s / bound:.1f}%), "
        f"{syncs} host syncs a fit, peak device memory {peak / 2**30:.2f} GiB; card == CPU on "
        f"{NB_PREFIX} rows (pi, theta equal; the control with one count moved differs); "
        f"gaussian on {len(yb)} hospital rows: fit {g_s * 1e3:.2f} ms, {g_syncs} host syncs, "
        f"card vs CPU {text}")


def svc_part(port, x, yb, card: str) -> None:
    """LinearSVC on the binary hospital rows: resident and out of core on
    the card, the card against the CPU on the prefix, out of core against
    resident, each with its control on TF32-rounded rows."""
    est = port.LinearSVC(tol=CLS_TOL)
    n = len(yb)
    m, fit_s, syncs = timed_fit(est, port.device_dataset(x, yb, device=DEV))
    xp, yp = x[:PREFIX], yb[:PREFIX]
    mc = est.fit((xp, yp), device="cpu")
    gaps = fit_gaps(est.fit((xp, yp), device=DEV), mc)
    ctl = fit_gaps(est.fit((tf32_round(xp), yp), device=DEV), mc)
    text = cls_gated("svc", gaps, ctl)
    hd = port.HostDataset(x=x, y=yb, max_device_rows=CLS_BLOCK)
    sync()
    t0 = time.perf_counter()
    mo = est.fit(hd, device=DEV)
    sync()
    ooc_s = time.perf_counter() - t0
    o_ctl = fit_gaps(est.fit(port.HostDataset(x=tf32_round(x), y=yb, max_device_rows=CLS_BLOCK),
                             device=DEV), m)
    o_text = cls_gated("svc_ooc", fit_gaps(mo, m), o_ctl)
    say(f"LinearSVC(tol={CLS_TOL:g}) on {card}, {n} hospital rows: fit {fit_s * 1e3:.2f} ms = "
        f"{n / fit_s:.4g} records/s, n_iter {m.n_iter}, {syncs} host syncs; card vs CPU on "
        f"{PREFIX} rows: {text}; out of core {ooc_s:.3f} s, against resident: {o_text}")


def one_vs_rest_part(port, H, x, tiers, card: str) -> int:
    """OneVsRest(DecisionTreeClassifier(max_depth=5)) on the 3 triage tiers:
    3 one-vs-all trees, K3 at each of 6 levels (counted), and the card
    against the CPU on the prefix: the same trees (0/1 labels: every
    histogram sum is exact); the control, the CPU on TF32-rounded
    features, grows others.  → K3 launches of the 2M-row fit."""
    import numpy as np

    est = port.OneVsRest(port.DecisionTreeClassifier(max_depth=5))
    ds = port.device_dataset(x, tiers, device=DEV)
    H.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    m = est.fit(ds)
    sync()
    fit_s = time.perf_counter() - t0
    k3 = H.launch_counts()["fused_level_hist"]
    check(k3 == 3 * 6, f"OneVsRest over 3 depth-5 trees launched K3 {k3} times (expected 18)")
    acc = port.MulticlassClassificationEvaluator(num_classes=3).evaluate(m.transform(ds))
    check(0.5 < acc <= 1.0, f"OneVsRest accuracy {acc}")
    xp, tp = x[:PREFIX], tiers[:PREFIX]

    def same(a, b) -> bool:
        return all(np.array_equal(u.split_feat, v.split_feat)
                   and np.array_equal(u.threshold, v.threshold)
                   and np.array_equal(u.value, v.value) for u, v in zip(a.models, b.models))

    mc = est.fit((xp, tp), device="cpu")
    check(same(est.fit((xp, tp), device=DEV), mc), "OneVsRest card vs CPU: the trees differ")
    check(not same(est.fit((tf32_round(xp), tp), device="cpu"), mc),
          "OneVsRest: the TF32-rounded control grows the same trees")
    say(f"OneVsRest(DecisionTreeClassifier(max_depth=5)) on {card}, {len(tiers)} rows, 3 tiers: "
        f"fit {fit_s:.3f} s, K3 launched {k3} times (3 trees x 6 levels), accuracy {acc:.6f}; "
        f"card vs CPU on {PREFIX} rows: the same trees (the TF32-rounded control: others)")
    return k3


def composites_part(port, x, yb, card: str) -> None:
    """Pipeline([VectorAssembler, StandardScaler, LogisticRegression]) fit,
    saved, loaded and transforming == before and after; CrossValidator over
    reg_param {0, 0.01, 0.1}, 3 folds, areaUnderROC, on the prefix: the same
    best index as the CPU route."""
    import numpy as np

    cols = {c: x[:, j] for j, c in enumerate(port.FEATURE_COLS)}
    table = port.Table.from_dict({**cols, "LOS_binary": yb.astype(np.int64)})
    pipe = port.Pipeline([port.VectorAssembler(list(port.FEATURE_COLS)), port.StandardScaler(),
                          port.LogisticRegression(tol=CLS_TOL)])
    sync()
    t0 = time.perf_counter()
    pm = pipe.fit(table, device=DEV)
    sync()
    fit_s = time.perf_counter() - t0
    before = pm.transform(table, device=DEV).prediction.cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pipeline")
        pm.write().overwrite().save(path)
        loaded = port.load_model(path)
        check(type(loaded) is port.PipelineModel, "load_model did not give a PipelineModel")
        after = loaded.transform(table, device=DEV).prediction.cpu().numpy()
    check(np.array_equal(before, after), "the PipelineModel predicts otherwise after its round trip")
    grid = port.ParamGridBuilder().add_grid("reg_param", [0.0, 0.01, 0.1]).build()
    cv = port.CrossValidator(port.LogisticRegression(tol=CLS_TOL), grid,
                             port.BinaryClassificationEvaluator(), num_folds=3)
    xp, yp = x[:PREFIX], yb[:PREFIX]
    sync()
    t0 = time.perf_counter()
    cvd = cv.fit((xp, yp), device=DEV)
    sync()
    cv_s = time.perf_counter() - t0
    cvc = cv.fit((xp, yp), device="cpu")
    check(cvd.best_index == cvc.best_index,
          f"CrossValidator best index: card {cvd.best_index}, CPU {cvc.best_index}")
    say(f"Pipeline(VectorAssembler, StandardScaler, LogisticRegression) on {card}, "
        f"{len(yb)} rows: fit {fit_s:.3f} s, saved, loaded, predictions == before and after; "
        f"CrossValidator (reg_param {[g['reg_param'] for g in grid]}, 3 folds, areaUnderROC) on "
        f"{PREFIX} rows: {cv_s:.3f} s, best index {cvd.best_index} (CPU the same), average "
        f"metrics card {np.round(cvd.avg_metrics, 6).tolist()} CPU "
        f"{np.round(cvc.avg_metrics, 6).tolist()}")


def classification_phase(port, H, card: str) -> int:
    """Slice 5a at full width: the stage's 2M hospital rows (the 4 features,
    ``LOS_binary`` from the pipeline's Binarizer, and 3 triage tiers at the
    LOS quantiles [0.5, 0.85], ``examples/model_diagnostics.py``) through
    binomial and multinomial LogisticRegression (resident and out of
    core; also as the example fits them), LinearSVC, OneVsRest over
    decision trees (K3), Pipeline and CrossValidator, and NaiveBayes at
    bench.py's shape.  → K3 launches."""
    import numpy as np

    cols = hospital_events(TREE_N // 5)
    x = np.stack([cols[c] for c in port.FEATURE_COLS], axis=1)
    los = cols[port.LABEL_COL]
    del cols
    thr = port.PipelineConfig().los_threshold
    yb = port.Binarizer(port.LABEL_COL, "LOS_binary", thr).transform(
        port.Table.from_dict({port.LABEL_COL: los})).column("LOS_binary").astype(np.float32)
    tiers = np.digitize(los, np.quantile(los, [0.5, 0.85])).astype(np.float32)
    STAGE_ROWS.update(x=x, los=los, yb=yb)          # families_phase's rows
    lap("cls data")
    logistic_part(port, "binomial", port.LogisticRegression(tol=CLS_TOL), x, yb, card, False)
    lap("cls binomial")
    logistic_part(port, "multinomial", port.LogisticRegression(**MULTI_KW), x, tiers, card, True)
    lap("cls multinomial")
    example_part(port, x, yb, tiers, card)
    lap("cls the example's fits")
    naive_bayes_part(port, x, yb, card)
    lap("cls NaiveBayes")
    svc_part(port, x, yb, card)
    lap("cls LinearSVC")
    k3 = one_vs_rest_part(port, H, x, tiers, card)
    lap("cls OneVsRest")
    composites_part(port, x, yb, card)
    lap("cls Pipeline and CrossValidator")
    return k3


STAGE_ROWS: dict = {}                     # classification_phase's rows, for families_phase
FAM_BLOCK = 1 << 18                       # the out-of-core fits: 8 blocks of 2M rows
FAM_TOL = 1e-4                            # GLM card vs CPU: the stop is the algorithm's
GLM_NOISE_SEED = 24                       # the GLM comparisons' noise column
STREAM_BATCHES_5B, STREAM_ROWS_5B = 20, 100_000
# card-vs-CPU, out-of-core-vs-resident and against-float64 limits of slice
# 5b: about 10x the gap of the first chip run (NVIDIA H100 80GB HBM3,
# 700 W; the gaps repeat exactly from call to call; the GLM's as measured
# with the comparisons' noise column), one float32 ulp (1.2e-7 relative)
# where that gap was 0, and the geometric mean of the gap and its control
# where the control sat within 10x of the gap (the GLM's coefficients and
# some of its inference on raw hospital features, whose float32 noise
# floor is near what rounding the rows does).  Each must fail its control
# but the exact ones (FAM_EXACT: n_iter and the isotonic tables) and the
# FAM_NO_CONTROL ones (host algorithms, and a bias of the reference), each
# with its reason.  The controls:
# TF32 products where they reach the route's products (the MLP's and
# FM's matmuls, the streaming linear Gram, pearson, ANOVA); the route on
# TF32-rounded rows for AFT; and the route on bfloat16-rounded rows where
# TF32 cannot move it past its own float32 gap: the GLM's IRLS sums and
# the streaming logistic's are batched 5x128 products and η a
# matrix-vector product, which TF32 leaves as they are, and of the
# hospital features only seasonality_index is not exact in TF32 (the
# Summarizer, KS and FValue, the isotonic lerp).
FAM_LIMITS = {
    "glm_poisson": {"n_iter": 0, "coef": 1.3e-5, "deviance": 8.6e-6, "aic": 3.3e-7,
                    "se": 1e-5, "t": 9e-5, "p": 8.4e-6},
    "glm_gamma": {"n_iter": 0, "coef": 1.3e-5, "deviance": 1.2e-7, "aic": 1.05e-5, "se": 4.3e-6,
                  "t": 4.1e-5, "p": 8.3e-6},
    "glm_tweedie": {"n_iter": 0, "coef": 6.6e-6, "deviance": 2.9e-5, "se": 7.5e-6, "t": 3.3e-5,
                    "p": 6.6e-6},
    "glm_binomial": {"n_iter": 0, "coef": 5.4e-5, "deviance": 1.4e-5, "aic": 1.6e-5,
                     "se": 1.9e-4, "t": 1.2e-4, "p": 8.3e-6},
    "glm_gaussian": {"n_iter": 0, "coef": 1.4e-5, "deviance": 1.2e-6, "aic": 8.5e-7,
                     "se": 4.3e-6, "t": 1.26e-3, "p": 1.9e-5},
    "glm_offset": {"n_iter": 0, "coef": 3.3e-6, "deviance": 6e-7, "aic": 7.1e-7},
    "glm_vs_lr": {"coef": 2e-2},
    "glm_ooc": {"n_iter": 0, "coef": 5e-6, "deviance": 1.3e-6},
    "mlp": {"w1": 4.1e-5, "w2": 4.6e-5, "w5": 1.25e-4, "loss": 0.1, "rows": 10_000},
    "mlp_ooc": {"w": 3.6e-5},
    "aft": {"n_iter": 0, "theta": 6e-7, "quantiles": 2.5e-6},
    "fm_regressor": {"params": 3.7e-4, "loss": 8.2e-4},
    "fm_classifier": {"params": 1.9e-4, "loss": 5.8e-5},
    "isotonic": {"boundaries": 0, "predictions": 0, "interp": 5.9e-7},
    "streaming": {"linear": 8.8e-5, "linear_f64": 1.8e-4, "logistic": 2.9e-6},
    "stat": {"mean": 1.2e-7, "variance": 3e-5, "pearson": 2.3e-5, "ks": 1e-7, "anova": 1.4e-6,
             "fvalue": 8.6e-6},
    "stat_f64": {"mean": 1.2e-7, "variance": 1e-5, "pearson": 1e-5, "ks": 1.2e-7, "anova": 1.6e-6,
                 "fvalue": 7.7e-7, "spearman": 1e-12, "chi2": 1e-9},
}
FAM_EXACT = ("n_iter", "boundaries", "predictions")
# limits no control can fail, and why
FAM_NO_CONTROL = {
    ("stat_f64", "spearman"): "host float64 ranks",
    ("stat_f64", "chi2"): "host float64 contingency tables",
    ("glm_vs_lr", "coef"): "the gap is the reference's IRLS jitter (1e-7·tr/d on the raw "
                           "Gram), which LinearRegression does not add: the JAX package's "
                           "GLM sits 1.3e-2 from its LinearRegression on such rows on the "
                           "CPU (tests/test_torch_glm.py), and no rounding of the rows moves "
                           "either fit that far",
}


def fam_gated(name: str, gaps: dict, ctl: dict) -> str:
    return gated(FAM_LIMITS, name, gaps, ctl, exact=FAM_EXACT, no_control=FAM_NO_CONTROL)


def rel(a, b) -> float:
    """|a − b| over the largest |b| (arrays) or |b| (scalars)."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def rel_each(a, b) -> float:
    """The largest elementwise |a − b| / |b|."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def stage_rows():
    """The 2M hospital rows classification_phase builds: (x (n, 4), LOS,
    LOS_binary); built here when the phase runs alone."""
    import numpy as np

    if not STAGE_ROWS:
        import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port

        cols = hospital_events(TREE_N // 5)
        los = cols[port.LABEL_COL]
        STAGE_ROWS.update(
            x=np.stack([cols[c] for c in port.FEATURE_COLS], axis=1), los=los,
            yb=(los > port.PipelineConfig().los_threshold).astype(np.float32))
    return STAGE_ROWS["x"], STAGE_ROWS["los"], STAGE_ROWS["yb"]


def glm_theta(m):
    import numpy as np

    return np.r_[m.coefficients.cpu().numpy().astype(np.float64), float(m.intercept)]


def glm_gaps(a, b, summary: bool = True) -> dict:
    """Two GLM fits apart: n_iter, coefficients (of b's largest), deviance
    and AIC (relative), standard errors (largest relative) and p-values."""
    import numpy as np

    g = {"n_iter": abs(a.n_iter - b.n_iter), "coef": rel(glm_theta(a), glm_theta(b)),
         "deviance": abs(a.deviance - b.deviance) / abs(b.deviance)}
    if summary:
        sa, sb = a.summary, b.summary
        if a.family != "tweedie":
            g["aic"] = abs(sa.aic - sb.aic) / abs(sb.aic)
        if a.summary._reg_param == 0.0 and a.summary._offset is None:
            g["se"] = rel_each(sa.coefficient_standard_errors, sb.coefficient_standard_errors)
            g["t"] = rel_each(sa.t_values, sb.t_values)
            g["p"] = float(np.max(np.abs(sa.p_values - sb.p_values)))
    return g


def glm_part(port, x, los, yb, card: str) -> None:
    """GeneralizedLinearRegression on the 2M hospital rows: poisson / log
    and gamma / log on LOS in whole days (at least 1), tweedie p = 1.5 (log
    link) on the same, binomial / logit on ``LOS_binary``, gaussian /
    identity on LOS (also against LinearRegression), each with its
    summary; poisson with an offset column (log exposure = log of
    admission_count + 1) and out of core in 8 blocks of 2^18.  Each
    against the CPU route on the 200,000-row prefix at tol 1e-4, with a
    fifth column of seeded N(0, 1) noise (``GLM_NOISE_SEED``) whose |t| is
    0.47–2.63, so its p-value (0.009–0.64) is one the routes can disagree on;
    the control: the same card fits on bfloat16-rounded rows (see
    FAM_LIMITS)."""
    import numpy as np

    days = np.maximum(np.rint(los), 1.0).astype(np.float32)
    cases = {
        "glm_poisson": (dict(family="poisson"), days),
        "glm_gamma": (dict(family="gamma", link="log"), days),
        "glm_tweedie": (dict(family="tweedie", variance_power=1.5, link_power=0.0), days),
        "glm_binomial": (dict(family="binomial"), yb),
        "glm_gaussian": (dict(family="gaussian"), los.astype(np.float32)),
    }
    n = len(days)
    noise = np.random.default_rng(GLM_NOISE_SEED).normal(size=PREFIX).astype(np.float32)
    xp = np.c_[x[:PREFIX], noise]
    for name, (kw, y) in cases.items():
        est = port.GeneralizedLinearRegression(tol=FAM_TOL, **kw)
        m, fit_s, syncs = timed_fit(est, port.device_dataset(x, y, device=DEV))
        s = m.summary
        extra = ("" if m.family == "tweedie" else f"AIC {s.aic:.8g}, ")
        check(np.isfinite(glm_theta(m)).all() and np.isfinite(s.deviance),
              f"{name}: the fit is not finite")
        mc = est.fit((xp, y[:PREFIX]), device="cpu")
        md = est.fit((xp, y[:PREFIX]), device=DEV)
        gaps = glm_gaps(md, mc)
        ctl = glm_gaps(est.fit((bf16_round(xp), y[:PREFIX]), device=DEV), mc)
        p_noise = (md.summary.p_values[4], mc.summary.p_values[4])
        check(min(p_noise) > 1e-3 and max(p_noise) < 0.95,
              f"{name}: the noise column's p-values {p_noise} leave its limit nothing to hold")
        text = fam_gated(name, gaps, ctl)
        say(f"{name}: GeneralizedLinearRegression({kw}, tol={FAM_TOL:g}) on {card}, {n} "
            f"hospital rows: fit {fit_s:.3f} s, {m.n_iter} IRLS steps, host syncs a fit {syncs}, "
            f"{n * m.n_iter / fit_s:.4g} records/s; summary deviance {s.deviance:.8g}, "
            f"{extra}dispersion {s.dispersion:.6g}; card vs CPU on {PREFIX} rows with a noise "
            f"column (its p-value {p_noise[0]:.6g} on the card): {text}")
        if name == "glm_gaussian":
            md4 = est.fit((x[:PREFIX], y[:PREFIX]), device=DEV)
            lr = port.LinearRegression().fit((x[:PREFIX], y[:PREFIX]), device=DEV)
            lr_gap = {"coef": rel(glm_theta(md4), np.r_[lr.coefficients.cpu().numpy(),
                                                         float(lr.intercept)])}
            say(f"glm_vs_lr: gaussian / identity against LinearRegression on the same "
                f"{PREFIX} rows on the card: {fam_gated('glm_vs_lr', lr_gap, {})}")
    # poisson with an offset column, through a Table
    exposure = np.log(x[:, 0].astype(np.float64) + 1.0).astype(np.float32)
    names = list(port.FEATURE_COLS)

    def offset_table(rows, xr=x):
        cols = {c: xr[:rows, j] for j, c in enumerate(names)}
        cols.update({port.LABEL_COL: days[:rows], "log_exposure": exposure[:rows]})
        return port.VectorAssembler(names).transform(port.Table.from_dict(cols))

    est = port.GeneralizedLinearRegression(family="poisson", offset_col="log_exposure",
                                           tol=FAM_TOL)
    table = offset_table(n)
    m, fit_s, syncs = timed_fit(est, table)
    del table
    small = offset_table(PREFIX)
    mc, md = est.fit(small, device="cpu"), est.fit(small, device=DEV)
    ctl = glm_gaps(est.fit(offset_table(PREFIX, bf16_round(x[:PREFIX])), device=DEV), mc)
    text = fam_gated("glm_offset", glm_gaps(md, mc), ctl)
    say(f"glm_offset: poisson with offset_col log(admission_count + 1) on {n} rows: fit "
        f"{fit_s:.3f} s, {m.n_iter} IRLS steps, host syncs a fit {syncs}, null deviance "
        f"{m.summary.null_deviance:.8g}; card vs CPU on {PREFIX} rows: {text}")
    # out of core against resident, on the card
    est = port.GeneralizedLinearRegression(family="poisson", tol=FAM_TOL)
    resident = est.fit(port.device_dataset(x, days, device=DEV), device=DEV)
    hd = port.HostDataset(x=x, y=days, max_device_rows=FAM_BLOCK)
    sync()
    t0 = time.perf_counter()
    mo = est.fit(hd, device=DEV)
    sync()
    ooc_s = time.perf_counter() - t0
    ctl = glm_gaps(est.fit(port.HostDataset(x=bf16_round(x), y=days, max_device_rows=FAM_BLOCK),
                           device=DEV), resident, summary=False)
    text = fam_gated("glm_ooc", glm_gaps(mo, resident, summary=False), ctl)
    say(f"glm_ooc: poisson out of core ({hd.block_shape()[0]} blocks of {FAM_BLOCK}) "
        f"{ooc_s:.3f} s = {n * mo.n_iter / ooc_s:.4g} records/s, {mo.n_iter} IRLS steps, "
        f"host syncs {mo.fit_info['host_syncs']}; against resident: {text}")


def mlp_weights(m):
    return [t.cpu().numpy() for wb in m.weights for t in wb]


def mlp_part(port, x, yb, card: str) -> None:
    """MultilayerPerceptronClassifier(layers=(4, 16, 2), max_iter=150, seed
    0) on ``LOS_binary`` (examples/beyond_the_reference.py's topology) at
    2M rows, and out of core (Adam, 8 blocks, 5 epochs).  The card against
    the CPU route on the prefix: the weights after 1, 2 and 5 L-BFGS
    iterations, the whole fit's loss and the rows predicted otherwise (a
    non-convex fit: by 150 iterations the two routes' rounding has taken
    them to nearby but different weights), and the out-of-core weights;
    the control: the card with TF32 products."""
    import dataclasses

    import numpy as np
    import torch

    est = port.MultilayerPerceptronClassifier(layers=(4, 16, 2), max_iter=150, seed=0)
    n = len(yb)
    m, fit_s, syncs = timed_fit(est, port.device_dataset(x, yb, device=DEV))
    info = m.fit_info
    acc = float((m.predict(torch.from_numpy(x).to(DEV)).cpu().numpy() == yb).mean())
    check(np.isfinite(info["loss"]) and 0.5 < acc <= 1.0, f"mlp: loss {info['loss']}, "
          f"accuracy {acc}")
    xp, yp = x[:PREFIX], yb[:PREFIX]

    def gaps(dev_fit):
        g = {}
        for it in (1, 2, 5):
            short = dataclasses.replace(est, max_iter=it)
            g[f"w{it}"] = max(rel(a, b) for a, b in zip(mlp_weights(dev_fit(short)),
                                                         mlp_weights(cpu_short[it])))
        whole = dev_fit(est)
        g["loss"] = abs(whole.fit_info["loss"] - mc.fit_info["loss"]) / mc.fit_info["loss"]
        q = whole.predict(torch.from_numpy(xp).to(DEV)).cpu().numpy()
        g["rows"] = int((q != qc).sum())
        return g

    cpu_short = {it: dataclasses.replace(est, max_iter=it).fit((xp, yp), device="cpu")
                 for it in (1, 2, 5)}
    mc = est.fit((xp, yp), device="cpu")
    qc = mc.predict(torch.from_numpy(xp)).numpy()
    got = gaps(lambda e: e.fit((xp, yp), device=DEV))
    with tf32_matmuls():
        ctl = gaps(lambda e: e.fit((xp, yp), device=DEV))
    text = fam_gated("mlp", got, ctl)
    # out of core: Adam, one step a block, 5 epochs
    ooc = dataclasses.replace(est, max_iter=5)
    hd = port.HostDataset(x=x, y=yb, max_device_rows=FAM_BLOCK)
    sync()
    t0 = time.perf_counter()
    mo = ooc.fit(hd, device=DEV)
    sync()
    ooc_s = time.perf_counter() - t0
    hp = port.HostDataset(x=xp, y=yp, max_device_rows=PREFIX // 8)
    want = mlp_weights(ooc.fit(hp, device="cpu"))
    o_gap = {"w": max(rel(a, b) for a, b in zip(mlp_weights(ooc.fit(hp, device=DEV)), want))}
    with tf32_matmuls():
        o_ctl = {"w": max(rel(a, b) for a, b in zip(mlp_weights(ooc.fit(hp, device=DEV)), want))}
    o_text = fam_gated("mlp_ooc", o_gap, o_ctl)
    say(f"mlp: MultilayerPerceptronClassifier(layers=(4, 16, 2), max_iter=150) on {card}, {n} "
        f"hospital rows (LOS_binary): fit {fit_s:.3f} s, {info['n_iter']} iterations, "
        f"{info['evaluations']} loss evaluations, {info['host_reads']} host reads (host syncs "
        f"a fit {syncs}), {n * info['evaluations'] / fit_s:.4g} records/s, loss "
        f"{info['loss']:.6f}, accuracy {acc:.6f}; card vs CPU on {PREFIX} rows: {text}; out of "
        f"core ({hd.block_shape()[0]} blocks of {FAM_BLOCK}, Adam, 5 epochs) {ooc_s:.3f} s = "
        f"{5 * n / ooc_s:.4g} records/s, loss {mo.fit_info['loss']:.6f}; card vs CPU out of "
        f"core on the prefix in 8 blocks: {o_text}")


def aft_rows(n: int, seed: int = 11):
    """examples/beyond_the_reference.py's censored law (:80-85) at n rows."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, size=(n, 2)).astype(np.float32)
    t_true = np.exp(x @ [0.8, -0.5] + 1.0 + 0.5 * np.log(rng.exponential(size=n)))
    c_time = rng.exponential(4.0, size=n)
    observed = (t_true <= c_time).astype(np.float32)
    return x, np.minimum(t_true, c_time).astype(np.float32), observed


def aft_part(port, card: str) -> None:
    """AFTSurvivalRegression(max_iter=100) on the example's censored law at
    2M rows, and out of core (Adam, 8 blocks, 5 epochs).  The card against
    the CPU route on the prefix: n_iter, θ = (β, b, log σ) and the
    quantiles; the control: TF32-rounded rows (the fit's products are
    matrix-vector ones, which TF32 does not reach)."""
    import numpy as np
    import torch

    n = TREE_N
    x, y, cen = aft_rows(n)
    est = port.AFTSurvivalRegression(max_iter=100)
    ds = port.device_dataset(x, y, device=DEV)
    est.fit(ds, censor=cen, device=DEV)
    sync()
    t0 = time.perf_counter()
    m = est.fit(ds, censor=cen, device=DEV)
    sync()
    fit_s = time.perf_counter() - t0
    _, syncs = count_syncs(lambda: est.fit(ds, censor=cen, device=DEV))
    check(np.isfinite(m.coefficients).all() and np.isfinite(m.scale), "aft: not finite")
    xp, yp, cp = x[:PREFIX], y[:PREFIX], cen[:PREFIX]

    def theta(mm):
        return np.r_[mm.coefficients, mm.intercept, np.log(mm.scale)]

    mc = est.fit((xp, yp), censor=cp, device="cpu")
    qc = mc.predict_quantiles(torch.from_numpy(xp)).numpy()

    def gaps(mm):
        q = mm.predict_quantiles(torch.from_numpy(xp).to(DEV)).cpu().numpy()
        return {"n_iter": abs(mm.fit_info["n_iter"] - mc.fit_info["n_iter"]),
                "theta": rel(theta(mm), theta(mc)), "quantiles": float(np.max(np.abs(q - qc) / qc))}

    got = gaps(est.fit((xp, yp), censor=cp, device=DEV))
    ctl = gaps(est.fit((tf32_round(xp), yp), censor=cp, device=DEV))
    text = fam_gated("aft", got, ctl)
    hd = port.HostDataset(x=x, y=y, max_device_rows=FAM_BLOCK)
    ooc = port.AFTSurvivalRegression(max_iter=5)
    sync()
    t0 = time.perf_counter()
    mo = ooc.fit(hd, censor=cen, device=DEV)
    sync()
    ooc_s = time.perf_counter() - t0
    check(np.isfinite(theta(mo)).all(), "aft out of core: not finite")
    info = m.fit_info
    say(f"aft: AFTSurvivalRegression(max_iter=100) on {card}, {n} rows of the example's law "
        f"({100 * (1 - cen.mean()):.1f}% censored): fit {fit_s:.3f} s, {info['n_iter']} "
        f"iterations, {info['evaluations']} evaluations, {info['host_reads']} host reads (host "
        f"syncs a fit {syncs}), {n * info['evaluations'] / fit_s:.4g} records/s; coef "
        f"{np.round(m.coefficients, 4).tolist()}, intercept {m.intercept:.4f}, scale "
        f"{m.scale:.4f}; card vs CPU on {PREFIX} rows: {text}; out of core "
        f"({hd.block_shape()[0]} blocks of {FAM_BLOCK}, Adam, 5 epochs) {ooc_s:.3f} s = "
        f"{5 * n / ooc_s:.4g} records/s, scale {mo.scale:.4f}")


def fm_part(port, x, los, yb, card: str) -> None:
    """FMRegressor on LOS and FMClassifier on LOS_binary (factor_size 8,
    max_iter 100: 100 full-batch Adam steps) at 2M rows.  The card against
    the CPU route on the prefix: the parameters and the final loss; the
    control: TF32 products."""
    import numpy as np
    import torch

    n = len(yb)
    for name, cls, y in (("fm_regressor", port.FMRegressor, los.astype(np.float32)),
                         ("fm_classifier", port.FMClassifier, yb)):
        est = cls(factor_size=8, max_iter=100)
        m, fit_s, syncs = timed_fit(est, port.device_dataset(x, y, device=DEV))
        xp, yp = x[:PREFIX], y[:PREFIX]

        def loss(mm, dev):
            p = [torch.tensor(np.float32(mm.intercept), device=dev), mm.linear.to(dev),
                 mm.factors.to(dev)]
            kind = "squared" if name == "fm_regressor" else "logistic"
            fn = port.models.fm.fm_loss(torch.from_numpy(xp).to(dev),
                                        torch.from_numpy(yp).to(dev),
                                        torch.ones(len(yp), device=dev), 0.0, kind)
            return float(fn(p))

        def params(mm):
            return np.r_[mm.intercept, mm.linear.cpu().numpy(), mm.factors.cpu().numpy().ravel()]

        mc = est.fit((xp, yp), device="cpu")
        lc = loss(mc, "cpu")

        def gaps(mm):
            return {"params": rel(params(mm), params(mc)), "loss": abs(loss(mm, "cpu") - lc) / lc}

        got = gaps(est.fit((xp, yp), device=DEV))
        with tf32_matmuls():
            ctl = gaps(est.fit((xp, yp), device=DEV))
        text = fam_gated(name, got, ctl)
        check(np.isfinite(params(m)).all(), f"{name}: not finite")
        say(f"{name}: {cls.__name__}(factor_size=8, max_iter=100) on {card}, {n} hospital rows: "
            f"fit {fit_s:.3f} s = {n * 100 / fit_s:.4g} records/s (n · steps / s), host syncs a "
            f"fit {syncs}; card vs CPU on {PREFIX} rows: {text}")


def isotonic_part(port, x, los, card: str) -> None:
    """IsotonicRegression of LOS on current_occupancy (feature_index=1):
    the host fit from the card's rows, predict on the 2M rows on the card
    (``interp``) against the CPU route (``==``) and numpy's float64
    ``np.interp``; the control: the card's ``interp`` on bfloat16-rounded
    rows."""
    import numpy as np
    import torch

    est = port.IsotonicRegression(feature_index=1)
    data = (x, los.astype(np.float32))
    t0 = time.perf_counter()
    m = est.fit(data, device=DEV)
    fit_s = time.perf_counter() - t0
    mc = est.fit(data, device="cpu")
    xt = torch.from_numpy(x.astype(np.float32)).to(DEV)
    m.predict(xt)
    sync()
    pred_ms = gpu_ms(lambda: m.predict(xt), 10)
    got = m.predict(xt).cpu().numpy()
    want = mc.predict(torch.from_numpy(x.astype(np.float32))).numpy()
    ref = np.interp(x[:, 1].astype(np.float32), m.boundaries, m.predictions)
    gaps = {"boundaries": int((m.boundaries != mc.boundaries).sum()
                              + (m.predictions != mc.predictions).sum()),
            "predictions": int((got != want).sum()),
            "interp": rel_each(got, ref)}
    # the control: the card's interp on bfloat16-rounded rows (occupancies
    # above 256 move to an even neighbour)
    ctl = {"interp": rel_each(m.predict(torch.from_numpy(bf16_round(x)).to(DEV)).cpu().numpy(),
                              ref)}
    text = fam_gated("isotonic", gaps, ctl)
    say(f"isotonic: IsotonicRegression(feature_index=1) of LOS on current_occupancy, "
        f"{len(los)} rows on {card}: fit {fit_s:.3f} s (host PAVA over "
        f"{len(m.boundaries)} boundaries), predict {pred_ms:.3f} ms on the card = "
        f"{len(los) / pred_ms * 1e3:.4g} rows/s; card vs CPU and np.interp: {text}")


def streaming_regressions_part(port, x, los, yb, card: str) -> None:
    """StreamingLinearRegression on LOS and StreamingLogisticRegression on
    LOS_binary over 20 micro-batches of 100,000 hospital rows staged on
    the card: records/s and host syncs an update (linear 0, logistic 1);
    the linear stream at decay 1.0 against the float64 normal-equation fit
    of all 2M rows; both against the CPU route; the control: TF32
    products (bfloat16-rounded rows for the logistic stream)."""
    import numpy as np

    b, k = STREAM_ROWS_5B, STREAM_BATCHES_5B
    y = los.astype(np.float32)
    staged = [(port.device_dataset(x[i * b:(i + 1) * b], y[i * b:(i + 1) * b], device=DEV),
               port.device_dataset(x[i * b:(i + 1) * b], yb[i * b:(i + 1) * b], device=DEV))
              for i in range(k)]
    sync()

    def run(dev, staged_batches=None):
        lin, log = port.StreamingLinearRegression(), port.StreamingLogisticRegression()
        for i in range(k):
            if staged_batches is None:
                lin.update((x[i * b:(i + 1) * b], y[i * b:(i + 1) * b]), device=dev)
                log.update((x[i * b:(i + 1) * b], yb[i * b:(i + 1) * b]), device=dev)
            else:
                lin.update(staged_batches[i][0])
                log.update(staged_batches[i][1])
        return lin, log

    run(DEV, staged)
    sync()
    t0 = time.perf_counter()
    lin = port.StreamingLinearRegression()
    for i in range(k):
        lin.update(staged[i][0])
    sync()
    lin_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    log = port.StreamingLogisticRegression()
    for i in range(k):
        log.update(staged[i][1])
    sync()
    log_s = time.perf_counter() - t0
    _, lin_syncs = count_syncs(lambda: port.StreamingLinearRegression().update(staged[0][0]))
    _, log_syncs = count_syncs(lambda: port.StreamingLogisticRegression().update(staged[0][1]))
    check(lin_syncs == 0 and log_syncs == 1,
          f"streaming regressions: host syncs an update {lin_syncs} / {log_syncs} (want 0 / 1)")
    lin_c, log_c = run("cpu")
    xa = np.c_[x.astype(np.float64), np.ones(len(y))]
    exact = np.linalg.solve(xa.T @ xa, xa.T @ y.astype(np.float64))

    def theta(m):
        return np.r_[m.coefficients.cpu().numpy(), float(m.intercept)]

    def gaps(a, g):
        return {"linear": rel(theta(a.latest_model), theta(lin_c.latest_model)),
                "linear_f64": rel(theta(a.latest_model), exact),
                "logistic": rel(theta(g.latest_model), theta(log_c.latest_model))}

    got = gaps(lin, log)
    with tf32_matmuls():
        ctl = gaps(*run(DEV, staged))
    # the logistic stream's sums are batched 5x128 products, which TF32
    # leaves as they are: its control is the stream on bfloat16-rounded rows
    xr = bf16_round(x)
    rounded = [(None, port.device_dataset(xr[i * b:(i + 1) * b], yb[i * b:(i + 1) * b],
                                          device=DEV)) for i in range(k)]
    log_r = port.StreamingLogisticRegression()
    for i in range(k):
        log_r.update(rounded[i][1])
    ctl["logistic"] = rel(theta(log_r.latest_model), theta(log_c.latest_model))
    text = fam_gated("streaming", got, ctl)
    n = b * k
    say(f"streaming regressions: {k} micro-batches of {b} hospital rows on {card}: linear "
        f"{n / lin_s:.4g} records/s ({lin_syncs} host syncs an update), logistic "
        f"{n / log_s:.4g} records/s ({log_syncs} host sync an update); {text}")


def stat_part(port, x, los, yb, card: str) -> None:
    """``stat`` on the 2M hospital rows on the card: Summarizer, pearson
    Correlation, KS (LOS against the normal of its own mean and std),
    ANOVA (the features against LOS_binary) and FValue (against LOS), each
    against the CPU route and float64 numpy / scipy; spearman and χ²
    (emergency_visits against LOS_binary) on the prefix.  The controls:
    TF32 products for pearson and ANOVA, bfloat16-rounded rows for the
    others."""
    import numpy as np
    from scipy import stats as sps

    st = port.stat
    xf = x.astype(np.float32)
    y = los.astype(np.float32)
    mu, sd = float(y.astype(np.float64).mean()), float(y.astype(np.float64).std())
    ds = port.device_dataset(xf, y, device=DEV)
    dsy = port.device_dataset(y[:, None], device=DEV)

    def run(dev, rows=xf, col=y, d=None, dy=None):
        d = d if d is not None else port.device_dataset(rows, col, device=dev)
        dy = dy if dy is not None else port.device_dataset(col[:, None], device=dev)
        return {"summary": st.Summarizer.summary(d, device=dev),
                "pearson": st.Correlation.corr(d, device=dev),
                "ks": st.KolmogorovSmirnovTest.test(dy, "norm", mu, sd, device=dev).statistic,
                "anova": st.ANOVATest.test(d, yb, device=dev).f_values,
                "fvalue": st.FValueTest.test(d, col, device=dev).f_values}

    ms = {}
    for key, fn in (("Summarizer", lambda: st.Summarizer.summary(ds, device=DEV)),
                    ("pearson", lambda: st.Correlation.corr(ds, device=DEV)),
                    ("KS", lambda: st.KolmogorovSmirnovTest.test(dsy, "norm", mu, sd, device=DEV)),
                    ("ANOVA", lambda: st.ANOVATest.test(ds, yb, device=DEV)),
                    ("FValue", lambda: st.FValueTest.test(ds, y, device=DEV))):
        fn()
        t0 = time.perf_counter()
        fn()
        ms[key] = (time.perf_counter() - t0) * 1e3
    card_r = run(DEV, d=ds, dy=dsy)
    cpu_r = run("cpu")

    def gaps(a, b):
        sa, sb = a["summary"], b["summary"]
        return {"mean": rel_each(sa.mean, sb.mean),
                "variance": rel_each(sa.variance, sb.variance),
                "pearson": float(np.abs(a["pearson"] - b["pearson"]).max()),
                "ks": abs(a["ks"] - b["ks"]), "anova": rel_each(a["anova"], b["anova"]),
                "fvalue": rel_each(a["fvalue"], b["fvalue"])}

    got = gaps(card_r, cpu_r)
    with tf32_matmuls():
        c_prod = gaps(run(DEV), cpu_r)
    c_rows = gaps(run(DEV, rows=bf16_round(xf), col=bf16_round(y)), cpu_r)
    ctl = {a: (c_prod[a] if a in ("pearson", "anova") else c_rows[a]) for a in got}
    text = fam_gated("stat", got, ctl)
    # against float64 numpy / scipy
    x64, y64 = xf.astype(np.float64), y.astype(np.float64)
    groups = [x64[yb == c] for c in (0.0, 1.0)]
    ref = {"mean": x64.mean(0), "variance": x64.var(0, ddof=1),
           "pearson": np.corrcoef(x64, rowvar=False),
           "ks": sps.kstest(y64, sps.norm(loc=mu, scale=sd).cdf).statistic,
           "anova": sps.f_oneway(*groups).statistic,
           "fvalue": None}
    r = np.array([np.corrcoef(x64[:, j], y64)[0, 1] for j in range(x64.shape[1])])
    ref["fvalue"] = r * r / (1 - r * r) * (len(y64) - 2)

    def f64_gaps(a):
        s = a["summary"]
        return {"mean": rel_each(s.mean, ref["mean"]),
                "variance": rel_each(s.variance, ref["variance"]),
                "pearson": float(np.abs(a["pearson"] - ref["pearson"]).max()),
                "ks": abs(a["ks"] - ref["ks"]), "anova": rel_each(a["anova"], ref["anova"]),
                "fvalue": rel_each(a["fvalue"], ref["fvalue"])}

    f64 = f64_gaps(card_r)
    xp = xf[:PREFIX]
    t0 = time.perf_counter()
    sp = st.Correlation.corr(xp, "spearman", device=DEV)
    ms["spearman (prefix)"] = (time.perf_counter() - t0) * 1e3
    cats = np.c_[xp[:, 2]]
    t0 = time.perf_counter()
    chi = st.ChiSquareTest.test(cats, yb[:PREFIX], device=DEV)
    ms["chi2 (prefix)"] = (time.perf_counter() - t0) * 1e3
    table = np.zeros((int(cats.max()) + 1, 2))
    np.add.at(table, (cats[:, 0].astype(int), yb[:PREFIX].astype(int)), 1)
    f64["spearman"] = float(np.abs(sp - sps.spearmanr(xp.astype(np.float64)).statistic).max())
    chi_ref = sps.chi2_contingency(table, correction=False).statistic
    f64["chi2"] = abs(chi.statistics[0] - chi_ref) / chi_ref
    with tf32_matmuls():
        fc_prod = f64_gaps(run(DEV))
    fc_rows = f64_gaps(run(DEV, rows=bf16_round(xf), col=bf16_round(y)))
    f_ctl = {a: (fc_prod[a] if a in ("pearson", "anova") else fc_rows[a]) for a in fc_rows}
    f_text = fam_gated("stat_f64", f64, f_ctl)
    say(f"stat on {card}, {len(y)} hospital rows: "
        f"{', '.join(f'{k} {v:.2f} ms' for k, v in ms.items())}; card vs CPU: {text}; against "
        f"float64 numpy / scipy: {f_text}")


def families_phase(port, H, card: str) -> None:
    """Slice 5b at full width, on classification_phase's 2M hospital rows
    (the 4 features, LOS and ``LOS_binary``): GeneralizedLinearRegression
    (five families, a summary each, an offset, out of core), the MLP and
    AFT on the port's L-BFGS, FM, IsotonicRegression, the streaming
    regressions and ``stat``, each against the CPU route.  It launches no
    K1, K2 or K3: this slice has no kernel."""
    import numpy as np

    x, los, yb = stage_rows()
    x = x.astype(np.float32)
    lap("fam data")
    glm_part(port, x, los, yb, card)
    lap("fam GLM")
    mlp_part(port, x, yb, card)
    lap("fam MLP")
    aft_part(port, card)
    lap("fam AFT")
    fm_part(port, x, los, yb, card)
    lap("fam FM")
    isotonic_part(port, x, los, card)
    lap("fam isotonic")
    streaming_regressions_part(port, x, los, yb, card)
    lap("fam streaming regressions")
    stat_part(port, x, los, yb, card)
    lap("fam stat")


FEAT_N = 4_000_000                        # bench.py _bench_sql_device
FEAT_QUERY = (
    "SELECT admission_count, current_occupancy, emergency_visits, seasonality_index,"
    " CASE WHEN seasonality_index > 0.5 THEN 1.0 ELSE 0.0 END AS peak_season,"
    " abs(current_occupancy - 250) AS occ_dev,"
    " (emergency_visits / (admission_count + 1)) AS er_ratio,"
    " length_of_stay"
    " FROM events WHERE event_time BETWEEN"
    " '2025-03-31 22:00:00' AND '2025-03-31 23:55:00'"
)
FEAT_COLS = ("admission_count", "current_occupancy", "emergency_visits", "seasonality_index",
             "peak_season", "occ_dev", "er_ratio")
FEAT_NAN_SEED = 5                         # the Imputer's NaN draw: 1 % of two columns
FEAT_SCALING = (1.0, 0.5, 2.0, 0.25)      # ElementwiseProduct's scaling vector
FORMULA = ("length_of_stay ~ hospital_id + admission_count + current_occupancy + "
           "emergency_visits + seasonality_index")
# card-vs-CPU (and fused-vs-host-route) limits of slice 5c: about 10x the
# gap of the first chip run (NVIDIA H100 80GB HBM3, 700 W), one float32
# ulp (1.2e-7 relative) where that gap was 0, and the geometric mean of
# the gap and its control where the control sat within 10x of the gap
# (PCA's variances, RFormula's and the fused rows' LinearRegression); the
# fused fits' limits sit inside ROADMAP queue 3's bounds (1e-4 of the
# largest coefficient, RMSE rtol 1e-4).  KMeans on the PCA projection
# (coordinates up to ±200, not standardized) parts at near ties: the plain
# version's float32 |x|² − 2x·c + |c|² is off the kernels' d² by up to
# 2^-8 there, a few rows a step go to the other center (40 after one step),
# and 20 unconverged Lloyd steps compound them (457 rows, centers 1.26e-3
# apart); K1 and K2 themselves are held to their plain versions at this
# shape in ``kernel_case``.  Each must fail its control but the exact ones
# (FEAT_EXACT: the fused rows, the extremes and quantiles, which no
# arithmetic produces, and KMeans' n_iter, which max_iter caps in every
# route): the route on bfloat16-rounded rows (``bf16_round``; TF32 does not
# reach the stages' products, which are elementwise or batched 4x4096 Gram
# chunks), or for the fused tree bfloat16-rounded labels.
FEAT_LIMITS = {
    "fused": {"valid_rows": 0, "lr_coef": 1.01e-5, "dt_rmse": 1.2e-7},
    "minmax": {"extremes": 0, "transform": 1.2e-7},
    "maxabs": {"extremes": 0, "transform": 1.2e-7},
    "robust": {"quantiles": 0, "transform": 1.2e-7},
    "pca": {"components": 2.2e-7, "variance": 1.21e-5, "mean": 1.2e-7, "transform": 2.5e-7},
    "normalizer": {"transform": 1.2e-6},
    "polynomial": {"transform": 1.5e-11},
    "product": {"transform": 1.2e-7},
    "kmeans": {"n_iter": 0, "centers": 1.3e-2, "cost": 8.2e-4, "rows": 4600},
    "categorical_tree": {"rmse": 1.2e-7},
    "rformula_lr": {"coef": 3.2e-5},
}
FEAT_EXACT = ("valid_rows", "extremes", "quantiles", "n_iter")
# no limit goes without a control here
FEAT_NO_CONTROL: dict = {}


def feat_gated(name: str, gaps: dict, ctl: dict) -> str:
    return gated(FEAT_LIMITS, name, gaps, ctl, exact=FEAT_EXACT, no_control=FEAT_NO_CONTROL)


def sql_device_events(n: int, seed: int = 0) -> dict:
    """bench.py's ``_bench_sql_device`` table: 8 hospitals, events over the
    2 h from 22:00, the 4 features and a gamma LOS, from seed 0."""
    import numpy as np

    rng = np.random.default_rng(seed)
    names = np.array([f"H{i:02d}" for i in range(8)], dtype=object)
    return {
        "hospital_id": names[np.arange(n) % 8],
        "event_time": (np.datetime64("2025-03-31T22:00:00")
                       + rng.integers(0, 7200, n).astype("timedelta64[s]")
                       ).astype("datetime64[ns]"),
        "admission_count": rng.integers(0, 50, n),
        "current_occupancy": rng.integers(10, 500, n),
        "emergency_visits": rng.integers(0, 30, n),
        "seasonality_index": rng.random(n),
        "length_of_stay": rng.gamma(3.0, 1.5, n),
    }


def bf16_ds(ds, rows: bool):
    """``ds`` with its rows (or its labels) rounded to bfloat16: the fused
    fits' controls."""
    import torch

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.data import (
        DeviceDataset,
    )

    def rounded(t):
        return torch.from_numpy(bf16_round(t.cpu().numpy())).to(t.device)

    return DeviceDataset(x=rounded(ds.x) if rows else ds.x, y=ds.y if rows else rounded(ds.y),
                         w=ds.w)


def fit_rmse(port, est, ds) -> tuple:
    """(model, RMSE over its own rows) of ``est`` fit on ``ds``."""
    m = est.fit(ds)
    return m, port.RegressionEvaluator("rmse").evaluate(m.transform(ds))


def fused_part(port, H, card: str) -> int:
    """The fused path at bench.py's sql_device shape: 4M rows, the paper's
    window with the CASE / abs / ratio features, compiled (no fallback
    node), ``sql_to_device`` against the host route on the card
    (interpreter, ``na_drop``, VectorAssembler, ``device_dataset``): the
    valid rows ``==``, LinearRegression and a depth-5 tree (K3) on each;
    ``compact=True`` keeping the rows.  → K3 launches of the fused fit."""
    import numpy as np
    import torch

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import sql
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.sql_compile import (
        compile_rowlevel,
    )

    t0 = time.perf_counter()
    session = port.Session(device=DEV)
    session.register_table("events", port.Table.from_dict(sql_device_events(FEAT_N)))
    say(f"features_phase data: {FEAT_N} rows of bench.py's sql_device table in "
        f"{time.perf_counter() - t0:.2f} s")
    label = port.LABEL_COL
    try:
        ex = session.sql_explain(FEAT_QUERY)
        check(ex["route"] == "compiled" and not ex["fallback"],
              f"the sql_device query does not compile: {ex['route']}, {ex['fallback']}")

        def fused(clock=None):
            return session.sql_to_device(FEAT_QUERY, feature_cols=FEAT_COLS, label_col=label,
                                         clock=clock)

        stages = {}
        for run in ("cold", "warm"):
            clock = StageEvents()
            ds, ms = host_ms(lambda: fused(clock))
            compiled_route(f"sql_to_device ({run})")
            stages[run] = {"host_ms": ms, **clock.ms()}
        _, syncs = count_syncs(fused)

        def host_route():
            t = {}
            tab, t["sql"] = host_ms(lambda: sql.execute(FEAT_QUERY, session.table,
                                                        mode="interpret"))
            asm, t["assemble"] = host_ms(lambda: port.VectorAssembler(FEAT_COLS).transform(
                tab.na_drop(subset=[*FEAT_COLS, label])))
            hds, t["transfer"] = host_ms(lambda: asm.to_device(label_col=label, device=DEV))
            return hds, t

        (hds, host_parts), host_total = host_ms(host_route)
        valid = ds.w > 0
        n_valid = int(valid.sum())
        fx, fy = ds.x[valid], ds.y[valid]
        rows_gap = 0 if (n_valid == hds.n_padded and torch.equal(fx, hds.x)
                         and torch.equal(fy, hds.y)) else 1
        # the window holds 22:00:00-23:55:00 of the 2 h: 6,901 of 7,200 seconds
        share, want = n_valid / FEAT_N, 6901 / 7200
        check(abs(share - want) < 0.01 * want,
              f"the window kept {share:.4f} of the rows, not about {want:.4f}")
        check(ds.n_padded == FEAT_N and float(ds.count()) == n_valid,
              "the fused dataset is not at the view's row count")
        view = compile_rowlevel(FEAT_QUERY, session.table, device=DEV)
        small, compact_ms = host_ms(lambda: port.VectorAssembler(FEAT_COLS).transform_device(
            view, label_col=label, compact=True))
        check(small.n_padded == n_valid and torch.equal(small.x, fx) and torch.equal(small.y, fy)
              and torch.equal(small.w, ds.w[valid]), "compact=True lost or moved rows")
        # LinearRegression and a depth-5 tree on each route (K3)
        lr_f = port.LinearRegression().fit(ds)
        lr_h = port.LinearRegression().fit(hds)
        lr_c = port.LinearRegression().fit(bf16_ds(ds, rows=True))
        before = H.launch_counts()["fused_level_hist"]
        (dt_f, rmse_f), dt_s = host_ms(lambda: fit_rmse(port, port.DecisionTreeRegressor(
            max_depth=5), ds))
        k3 = H.launch_counts()["fused_level_hist"] - before
        check(k3 == 6, f"the fused dataset's tree launched K3 {k3} times (expected 6)")
        _, rmse_h = fit_rmse(port, port.DecisionTreeRegressor(max_depth=5), hds)
        _, rmse_c = fit_rmse(port, port.DecisionTreeRegressor(max_depth=5), bf16_ds(ds, rows=False))
        gaps = {"valid_rows": rows_gap, "lr_coef": rel(lr_theta(lr_f), lr_theta(lr_h)),
                "dt_rmse": abs(rmse_f - rmse_h) / rmse_h}
        ctl = {"lr_coef": rel(lr_theta(lr_c), lr_theta(lr_h)), "dt_rmse": abs(rmse_c - rmse_h) / rmse_h}
        text = feat_gated("fused", gaps, ctl)
        say(f"features_phase fused path: the sql_device query compiled (route compiled, no "
            f"fallback), {n_valid} of {FEAT_N} rows valid ({share:.4f}); fused vs host route "
            f"on the card: {text}; compact=True kept the {n_valid} rows in order "
            f"({compact_ms:.1f} ms); the fused tree fit {dt_s:.1f} ms, RMSE {rmse_f:.6f}")
        say(f"features_phase times on {card} (ms; stages by CUDA events, totals by host clock): "
            f"sql_to_device {json.dumps(stages)}; host route {host_total:.1f} "
            f"{json.dumps(host_parts)}; host syncs of a warm sql_to_device: {syncs}")
        return k3
    finally:
        session.stop()


def stage_gaps(card_out, cpu_out, ctl_out) -> tuple[dict, dict]:
    """({"transform": gap}, {"transform": control}) of a stage's outputs,
    relative to the CPU route's largest |value|."""
    return ({"transform": rel(card_out, cpu_out)}, {"transform": rel(ctl_out, cpu_out)})


def stages_part(port, L, H, card: str) -> dict:
    """The feature stages on the stage's 2M hospital rows (seed 7), each
    on the card against the CPU route, the control being the card route on
    bfloat16-rounded rows; PCA(3) → KMeans(k=16) on the card (K1, K2),
    StringIndexer → a categorical tree (K3), StringIndexer →
    OneHotEncoder, an Imputer over NaN in 1 % of two columns and
    RFormula → LinearRegression.  → the launches of the card's main-path
    fits."""
    import numpy as np
    import torch

    x, los, _ = stage_rows()
    xf, y = x.astype(np.float32), los.astype(np.float32)
    n = len(xf)
    # the rows' table: hospital_events gives each of the 5 hospitals a
    # block of n / 5 rows, and its first 3 features are integers
    names = np.array([f"H{h:02d}" for h in range(5)], dtype=object)
    cols = {"hospital_id": np.repeat(names, n // 5), port.LABEL_COL: los}
    for j, c in enumerate(port.FEATURE_COLS):
        cols[c] = x[:, j].astype(np.int64) if j < 3 else x[:, j]
    ds = {dev: port.device_dataset(xf, y, device=dev) for dev in (DEV, "cpu")}
    ctl_ds = port.device_dataset(bf16_round(xf), y, device=DEV)

    def out(d):
        return d.x.cpu().numpy()[:n] if hasattr(d, "x") else np.asarray(d)

    lines = []
    # the fits on a DeviceDataset, and their transforms
    for name, est, stat in (("minmax", port.MinMaxScaler(), ("data_min", "data_max")),
                            ("maxabs", port.MaxAbsScaler(), ("max_abs",)),
                            ("robust", port.RobustScaler(with_centering=True),
                             ("median", "iqr"))):
        t0 = time.perf_counter()
        m = {dev: est.fit(ds[dev]) for dev in (DEV, "cpu")}
        fit_s = time.perf_counter() - t0
        mc = est.fit(ctl_ds)
        key = "quantiles" if name == "robust" else "extremes"
        same = all(np.array_equal(getattr(m[DEV], a), getattr(m["cpu"], a)) for a in stat)
        gaps, ctl = stage_gaps(out(m[DEV].transform(ds[DEV])), out(m["cpu"].transform(
            ds["cpu"])), out(mc.transform(ctl_ds)))
        gaps[key] = 0 if same else 1
        ctl[key] = max(rel(getattr(mc, a), getattr(m["cpu"], a)) for a in stat)
        lines.append(f"{name} (both fits {fit_s:.2f} s): {feat_gated(name, gaps, ctl)}")
    pca = {dev: port.PCA(3).fit(ds[dev]) for dev in (DEV, "cpu")}
    pca_c = port.PCA(3).fit(ctl_ds)

    def pca_gaps(a, b):
        return {"components": float(np.abs(a.components - b.components).max()),
                "variance": rel_each(a.explained_variance, b.explained_variance),
                "mean": rel_each(a.mean, b.mean),
                "transform": rel(out(a.transform(ds[DEV])), out(b.transform(ds["cpu"])))}

    pca_text = feat_gated("pca", pca_gaps(pca[DEV], pca["cpu"]), pca_gaps(pca_c, pca["cpu"]))
    lines.append(f"pca: {pca_text}")
    for name, st in (("normalizer", port.Normalizer()),
                     ("polynomial", port.PolynomialExpansion(2)),
                     ("product", port.ElementwiseProduct(FEAT_SCALING))):
        gaps, ctl = stage_gaps(out(st.transform(ds[DEV])), out(st.transform(ds["cpu"])),
                               out(st.transform(ctl_ds)))
        lines.append(f"{name}: {feat_gated(name, gaps, ctl)}")
    say(f"features_phase stages on {card}, {n} hospital rows, card vs CPU: " + "; ".join(lines))

    # PCA(3) → KMeans(k=16): K1 a Lloyd step, K2 in predict, on all rows on
    # the card; card against CPU on the prefix's projection by the card,
    # the same rows on both (a one-ulp difference of the rows, as the two
    # routes' projections differ, moves this 20-step fit by about 1e-3)
    counts = {"fused_lloyd_stats": 0, "fused_assign": 0, "fused_level_hist": 0}
    z = pca[DEV].transform(ds[DEV])
    before = L.launch_counts()
    (km, fit_s) = host_ms(lambda: port.KMeans(k=16, seed=0).fit(z))
    pred = km.predict(z.x)
    after = L.launch_counts()
    counts["fused_lloyd_stats"] = after["fused_lloyd_stats"] - before["fused_lloyd_stats"]
    counts["fused_assign"] = after["fused_assign"] - before["fused_assign"]
    check(counts["fused_lloyd_stats"] == km.n_iter + 1 and counts["fused_assign"] >= 1,
          f"PCA → KMeans launched K1 {counts['fused_lloyd_stats']} times over {km.n_iter} "
          f"steps and K2 {counts['fused_assign']} times")
    check(int(torch.bincount(pred.to(torch.int64), minlength=16).max()) > 0, "no prediction")
    zrows = pca[DEV].transform(port.device_dataset(xf[:PREFIX], device=DEV)).x.cpu().numpy()
    zp = {dev: port.device_dataset(zrows, device=dev) for dev in (DEV, "cpu")}
    kmp = {dev: port.KMeans(k=16, seed=0).fit(zp[dev]) for dev in (DEV, "cpu")}
    zc = port.device_dataset(bf16_round(zrows), device=DEV)
    kmc = port.KMeans(k=16, seed=0).fit(zc)

    def km_gaps(a, b, za):
        return {"n_iter": abs(a.n_iter - b.n_iter),
                "centers": rel(a.cluster_centers, b.cluster_centers),
                "cost": abs(a.training_cost - b.training_cost) / b.training_cost,
                "rows": int((a.predict(za.x).cpu() != b.predict(zp["cpu"].x)).sum())}

    text = feat_gated("kmeans", km_gaps(kmp[DEV], kmp["cpu"], zp[DEV]),
                      km_gaps(kmc, kmp["cpu"], zc))
    say(f"features_phase PCA(3) → KMeans(k=16) on {n} rows on the card: {fit_s / 1e3:.3f} s, "
        f"n_iter {km.n_iter}, K1 {counts['fused_lloyd_stats']}, K2 {counts['fused_assign']}; "
        f"card vs CPU on {PREFIX} rows: {text}")

    # the table stages on each route: StringIndexer → OneHotEncoder, an
    # Imputer over NaN, then the assembler and a MinMaxScaler fit there
    rng = np.random.default_rng(FEAT_NAN_SEED)
    tcols = {c: cols[c] for c in ("hospital_id", *port.FEATURE_COLS, port.LABEL_COL)}
    for c in ("seasonality_index", "current_occupancy"):
        v = tcols[c].astype(np.float64).copy()
        v[rng.random(n) < 0.01] = np.nan
        tcols[c] = v
    table = port.Table.from_dict(tcols)
    imputed = ("seasonality_index_f", "current_occupancy_f")
    pipe = port.Pipeline([
        port.StringIndexer("hospital_id", "hid"), port.OneHotEncoder(["hid"]),
        port.Imputer(["seasonality_index", "current_occupancy"], list(imputed)),
        port.VectorAssembler(["hid_vec_0", "hid_vec_1", "hid_vec_2", "hid_vec_3",
                              "admission_count", "emergency_visits", *imputed]),
        port.MinMaxScaler()])
    fitted = {}
    for dev in (DEV, "cpu"):
        fitted[dev], fitted[dev + "_s"] = host_ms(lambda: pipe.fit(table, device=dev))
    same = all(a._artifacts()[1] == b._artifacts()[1] for a, b in
               zip(fitted[DEV].stages[:3], fitted["cpu"].stages[:3]))
    mm = [m.stages[4] for m in (fitted[DEV], fitted["cpu"])]
    check(same and np.array_equal(mm[0].data_min, mm[1].data_min)
          and np.array_equal(mm[0].data_max, mm[1].data_max),
          "StringIndexer / OneHotEncoder / Imputer / MinMaxScaler differ across the routes")
    labels = fitted[DEV].stages[0].labels
    surrogates = fitted[DEV].stages[2].surrogates
    nan_x = table.numeric_matrix(["seasonality_index", "current_occupancy"]).astype(np.float32)
    ma = {dev: port.MaxAbsScaler().fit(port.device_dataset(nan_x, device=dev)).max_abs
          for dev in (DEV, "cpu")}
    check(np.array_equal(ma[DEV], ma["cpu"])
          and np.array_equal(ma[DEV], np.nanmax(np.abs(nan_x), axis=0)),
          "the NaN-aware MaxAbsScaler differs across the routes or from numpy")
    say(f"features_phase table stages, card route vs CPU route ==: StringIndexer {labels}, "
        f"OneHotEncoder {fitted[DEV].stages[1].category_sizes}, Imputer surrogates "
        f"{surrogates} (NaN in {int(np.isnan(nan_x).sum())} cells), MinMaxScaler extremes; "
        f"the pipeline fit {fitted[DEV + '_s'] / 1e3:.2f} s (card) / "
        f"{fitted['cpu_s'] / 1e3:.2f} s (CPU); MaxAbsScaler over the NaN rows == numpy")

    # StringIndexer → a categorical tree (K3) on all rows on the card;
    # card against CPU on the prefix
    hid = fitted[DEV].stages[0].transform(table.select(["hospital_id"])).column("hid")
    xd = np.c_[hid, xf].astype(np.float32)
    tree = port.DecisionTreeRegressor(max_depth=5, categorical_features={0: 5})
    dds = port.device_dataset(xd, y, device=DEV)
    before = H.launch_counts()["fused_level_hist"]
    (_, rmse), dt_ms = host_ms(lambda: fit_rmse(port, tree, dds))
    counts["fused_level_hist"] = H.launch_counts()["fused_level_hist"] - before
    check(counts["fused_level_hist"] == 6,
          f"the categorical tree launched K3 {counts['fused_level_hist']} times (expected 6)")
    rm = {dev: fit_rmse(port, tree, port.device_dataset(xd[:PREFIX], y[:PREFIX], device=dev))[1]
          for dev in (DEV, "cpu")}
    rc = fit_rmse(port, tree, port.device_dataset(xd[:PREFIX], bf16_round(y[:PREFIX]),
                                                  device=DEV))[1]
    text = feat_gated("categorical_tree", {"rmse": abs(rm[DEV] - rm["cpu"]) / rm["cpu"]},
                      {"rmse": abs(rc - rm["cpu"]) / rm["cpu"]})
    say(f"features_phase StringIndexer → DecisionTreeRegressor(categorical_features={{0: 5}}) "
        f"on {n} rows: {dt_ms:.1f} ms, K3 {counts['fused_level_hist']}, RMSE {rmse:.6f}; card "
        f"vs CPU on {PREFIX} rows: {text}")

    # RFormula (hospital_id a factor, every column named) → LinearRegression
    fcols = {c: cols[c] for c in ("hospital_id", *port.FEATURE_COLS, port.LABEL_COL)}
    ftable = port.Table.from_dict(fcols)
    rf, rf_ms = host_ms(lambda: port.RFormula(FORMULA).fit(ftable))
    check(rf._artifacts() == port.RFormula(FORMULA).fit(ftable)._artifacts(),
          "RFormula fits differ")
    asm, tr_ms = host_ms(lambda: rf.transform(ftable))
    rds = {dev: asm.to_device(label_col=port.LABEL_COL, device=dev) for dev in (DEV, "cpu")}
    check(torch.equal(rds[DEV].x.cpu(), rds["cpu"].x), "RFormula's rows differ on the card")
    lrs = {dev: port.LinearRegression().fit(rds[dev]) for dev in (DEV, "cpu")}
    lr_c = port.LinearRegression().fit(port.device_dataset(bf16_round(asm.features),
                                                           asm.label(port.LABEL_COL),
                                                           device=DEV))
    text = feat_gated("rformula_lr", {"coef": rel(lr_theta(lrs[DEV]), lr_theta(lrs["cpu"]))},
                      {"coef": rel(lr_theta(lr_c), lr_theta(lrs["cpu"]))})
    say(f"features_phase RFormula {rf.feature_names} (fit {rf_ms:.0f} ms, transform "
        f"{tr_ms:.0f} ms) → LinearRegression card vs CPU: {text}")
    return counts


def features_phase(port, L, H, card: str) -> dict:
    """Slice 5c at full width: the fused SQL-to-device path at bench.py's
    sql_device shape against the host route, then the feature stages on
    the stage's 2M hospital rows against the CPU route, feeding KMeans (K1,
    K2) and trees (K3).  → the launches of its main path."""
    k3 = fused_part(port, H, card)
    lap("feat fused path")
    counts = stages_part(port, L, H, card)
    lap("feat stages")
    counts["fused_level_hist"] += k3
    return counts


BEYOND_CUT = PREFIX                       # the selectors' and the tree's card-vs-CPU rows
SELECT_NOISE_SEED = 24                    # the selectors' seeded N(0, 1) noise column
SELECT_BINS = 10                          # QuantileDiscretizer buckets before chi-square
NOTES = 100_000                           # clinical notes: 10 topics over 1,000 terms
NOTE_VOCAB = 1_000
NOTE_TOPICS = 10
NOTE_LEN = 40                             # content tokens a note
NOTE_STOP = 8                             # English stop words a note
NOTE_SEED = 17
HASH_FEATURES = 2048                      # the widest power of two under 2^28 / NOTES
LDA_BLOCKS = 8                            # the out-of-core LDA's HostDataset blocks
LDA_CUT = 5_000                           # LDA card against CPU
W2V_NOTES = 10_000                        # Word2Vec's notes: about 3.7M pairs
W2V_CUT = 500                             # Word2Vec card against CPU
ALS_USERS = 200_000
ALS_ITEMS = 5_000
ALS_RATINGS = 10_000_000
ALS_RANK = 10
ALS_SEED = 19
ALS_CUT_USERS = 20_000                    # about 1M ratings: implicit, NNLS, card vs CPU
PIC_K = 8
PIC_NEIGHBOURS = 10
# card-vs-CPU limits of slices 5d + 5e: about 10x the gap of the first chip
# run (NVIDIA H100 80GB HBM3, 700 W), one float32 ulp (1.2e-7) where that
# gap was 0 (DCT); Word2Vec's 1 − cos in float64 (4.4e-16: the cut's
# vectors agree to the last bits).  ALS's NNLS is rounding-sensitive:
# which coordinates sit at 0 moves with the rounding, and on another draw
# of the ratings its gap was 2.28e-4 (ROADMAP queue 3).
# Each must fail its control (BEYOND_EXACT aside): the route on
# bfloat16-rounded rows, ratings or weights (``bf16_round``); the card
# route with TF32 products (``tf32_matmuls``) where its products are float32
# matmuls and the inputs are small integers that bfloat16 rounds exactly
# (LDA's counts, DCT); for Word2Vec, whose batched products TF32 left
# unchanged, the fit with its step size one bfloat16 ulp larger.
BEYOND_LIMITS = {
    "selectors": {"selected": 0, "anova_p": 2.3e-5, "fvalue_p": 1.6e-7, "chi2_p": 0,
                  "variance": 9.4e-6, "tree_splits": 0},
    "lda": {"lam": 7.4e-5, "mixtures": 7.2e-4, "perplexity": 7.8e-7, "top_terms": 0},
    "word2vec": {"cosine": 4.4e-15, "synonyms": 0},
    "dct": {"forward": 1.2e-7, "inverse": 1.2e-7},
    "als": {"pred": 8.0e-5, "subspace": 1.9e-4, "recs_rows": 0},
    "als_implicit": {"pred": 3.7e-5, "subspace": 6.1e-5, "recs_rows": 0},
    "als_nonnegative": {"pred": 8.0e-5, "subspace": 1.4e-4, "recs_rows": 0},
    "pic": {"embedding": 2.5e-6, "rows": 60},
}
BEYOND_EXACT = ("selected", "chi2_p", "tree_splits", "top_terms", "synonyms", "recs_rows")
BEYOND_NO_CONTROL: dict = {}


def beyond_gated(name: str, gaps: dict, ctl: dict) -> str:
    return gated(BEYOND_LIMITS, name, gaps, ctl, exact=BEYOND_EXACT,
                 no_control=BEYOND_NO_CONTROL)


def count_ops(fn):
    """``fn()`` with its torch ops counted (on the card each op is one or
    more kernel launches; views included) and its host syncs → (result,
    ops, host syncs)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    n = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            n[0] += 1
            return func(*args, **(kwargs or {}))

    def run():
        with Count():
            return fn()

    out, syncs = count_syncs(run)
    return out, n[0], syncs


def timed(fn):
    """(result, host seconds) of ``fn()``, ending with the card idle."""
    out, ms = host_ms(fn)
    return out, ms / 1e3


def fit_line(name: str, seconds: float, records: float, unit: str, ops: int, syncs: int) -> str:
    return (f"{name} {seconds:.3f} s, {records / seconds:.4g} {unit}/s, {ops} device ops, "
            f"{syncs} host syncs")


def subspace_gap(a, b) -> float:
    """sin of the largest principal angle between the column spaces of two
    (n, r) factor matrices (0 when they span the same subspace)."""
    import numpy as np

    qa, _ = np.linalg.qr(np.asarray(a, np.float64))
    qb, _ = np.linalg.qr(np.asarray(b, np.float64))
    s = np.linalg.svd(qa.T @ qb, compute_uv=False)
    return float(np.sqrt(max(0.0, 1.0 - float(s.min()) ** 2)))


def relabelled_rows(a, b) -> int:
    """Rows whose clusters differ once ``b``'s labels are matched to
    ``a``'s (the assignment that maximizes agreement)."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment

    k = int(max(a.max(), b.max())) + 1
    table = np.zeros((k, k), np.int64)
    np.add.at(table, (a, b), 1)
    r, c = linear_sum_assignment(-table)
    return int(len(a) - table[r, c].sum())


def selectors_part(port, H, card: str) -> int:
    """Slice 5d's selectors on the stage's 2M hospital rows (seed 7), with a
    seeded N(0, 1) noise column so the p-values can move (every hospital
    feature's is 0): UnivariateFeatureSelector ANOVA on ``LOS_binary`` and
    F-value on LOS (numTopFeatures 2), ChiSqSelector on QuantileDiscretizer
    bins against the 3 LOS tiers, VarianceThresholdSelector, and
    VectorIndexer(max_categories=8) over the features and the hospital's
    StringIndexer index → DecisionTreeRegressor(max_depth=5) with its
    ``categorical_features`` (K3).  Card against CPU on a cut of every
    10th row (all five hospitals), the tree on integer LOS (exact sums:
    the same splits).  → K3 launches."""
    import numpy as np

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops.reductions import (
        host_moments,
    )

    x, los, yb = stage_rows()
    n = len(los)
    names = np.array([f"H{h:02d}" for h in range(5)], dtype=object)
    noise = np.random.default_rng(SELECT_NOISE_SEED).normal(size=n)
    tiers = np.digitize(los, np.quantile(los, [0.5, 0.85])).astype(np.float64)
    cols = {"hospital_id": np.repeat(names, n // 5), "noise": noise, port.LABEL_COL: los,
            "LOS_binary": yb.astype(np.float64), "tier": tiers}
    for j, c in enumerate(port.FEATURE_COLS):
        cols[c] = x[:, j]
    feats = [*port.FEATURE_COLS, "noise"]
    t0 = time.perf_counter()
    table = port.Table.from_dict(cols)
    for c in port.FEATURE_COLS:
        table = port.QuantileDiscretizer(SELECT_BINS, c, c + "_bin").fit(table).transform(table)
    table = port.StringIndexer("hospital_id", "hid").fit(table).transform(table)
    build_s = time.perf_counter() - t0

    def views(tab):
        return (port.VectorAssembler(feats).transform(tab),
                port.VectorAssembler([c + "_bin" for c in port.FEATURE_COLS]).transform(tab))

    def select(asm, binned, device):
        anova = port.UnivariateFeatureSelector(selection_threshold=2, label_col="LOS_binary")
        fval = port.UnivariateFeatureSelector("continuous", "continuous",
                                              selection_threshold=2, label_col=port.LABEL_COL)
        chi = port.ChiSqSelector(num_top_features=2, label_col="tier")
        out = {}
        for name, est, a in (("anova", anova, asm), ("fvalue", fval, asm), ("chi2", chi, binned)):
            out[name] = est.fit(a, device=device).selected
            lab = a.label(est.label_col)
            inner = est if name != "chi2" else port.UnivariateFeatureSelector(
                "categorical", "categorical", label_col="tier")
            out[name + "_p"] = np.asarray(inner._p_values(a.features, lab, device))
        vt = port.VarianceThresholdSelector(1.0).fit(asm, device=device)
        ds = asm.to_device(device=device)
        s = host_moments(ds.x, ds.w)
        out["variance"] = s["s2"] / s["n"] - (s["s1"] / s["n"]) ** 2
        out["variance_sel"] = vt.selected
        return out

    asm, binned = views(table)
    (full, full_s) = timed(lambda: select(asm, binned, DEV))
    check(all(len(full[k]) == 2 for k in ("anova", "fvalue", "chi2")),
          "a selector did not keep 2 features")
    # the hospitals are blocks of rows: every 10th row holds all five
    cut = np.arange(0, n, n // BEYOND_CUT)
    pre = table.mask(np.isin(np.arange(n), cut))
    pa, pb = views(pre)
    route = {dev: select(pa, pb, dev) for dev in (DEV, "cpu")}
    ctl_tab = port.Table.from_dict({**{c: pre.column(c) for c in pre.columns},
                                    **{c: bf16_round(pre.column(c).astype(np.float32))
                                       .astype(np.float64) for c in feats}})
    ctl = select(*views(ctl_tab), DEV)

    def p_gap(a, b):
        keep = b > 0          # the p-values that are 0 in both are compared as equal
        same_zero = bool(np.array_equal(a <= 0, b <= 0))
        return rel_each(a[keep], b[keep]) if same_zero and keep.any() else float("inf")

    c, g = route[DEV], route["cpu"]
    gaps = {"selected": int(any(c[k] != g[k] for k in ("anova", "fvalue", "chi2",
                                                       "variance_sel"))),
            "anova_p": p_gap(c["anova_p"], g["anova_p"]),
            "fvalue_p": p_gap(c["fvalue_p"], g["fvalue_p"]),
            "chi2_p": 0 if np.array_equal(c["chi2_p"], g["chi2_p"]) else 1,
            "variance": rel_each(c["variance"], g["variance"])}
    ctlg = {"anova_p": p_gap(ctl["anova_p"], g["anova_p"]),
            "fvalue_p": p_gap(ctl["fvalue_p"], g["fvalue_p"]),
            "variance": rel_each(ctl["variance"], g["variance"])}

    # VectorIndexer → the categorical tree (K3) on all rows on the card
    asm5 = port.VectorAssembler([*port.FEATURE_COLS, "hid"]).transform(table)
    vi, vi_s = timed(lambda: port.VectorIndexer(max_categories=8).fit(asm5))
    check(vi.categorical_features == {4: 5},
          f"VectorIndexer found {vi.categorical_features}, not the hospital index {{4: 5}}")
    indexed = vi.transform(asm5)
    tree = port.DecisionTreeRegressor(max_depth=5, categorical_features=vi.categorical_features)
    before = H.launch_counts()["fused_level_hist"]
    (dt, dt_s) = timed(lambda: tree.fit(indexed, device=DEV))
    k3 = H.launch_counts()["fused_level_hist"] - before
    check(k3 == 6, f"the indexed tree launched K3 {k3} times (expected 6)")
    check(dt.split_catmask is not None, "the indexed tree did not take the categorical spec")
    xp = indexed.features[cut].astype(np.float32)
    yp = np.round(los[cut]).astype(np.float32)
    trees = {dev: tree.fit(port.device_dataset(xp, yp, device=dev)) for dev in (DEV, "cpu")}
    a, b = trees[DEV]._arrays(), trees["cpu"]._arrays()
    gaps["tree_splits"] = int(any(not np.array_equal(a[k], b[k]) for k in a
                                  if k not in ("value", "feature_importances")))
    text = beyond_gated("selectors", gaps, ctlg)
    say(f"beyond_phase selectors on {card}, {n} hospital rows + a noise column (table, bins "
        f"and index {build_s:.2f} s): ANOVA on LOS_binary → {full['anova']}, F-value on LOS → "
        f"{full['fvalue']}, ChiSqSelector on {SELECT_BINS} bins vs 3 tiers → {full['chi2']}, "
        f"VarianceThreshold(1.0) → {full['variance_sel']} ({full_s:.2f} s on the card); "
        f"VectorIndexer(8) {vi.categorical_features} in {vi_s:.2f} s → "
        f"DecisionTreeRegressor(5) {dt_s:.2f} s, K3 {k3}, "
        f"{int((dt.split_feat == 4).sum())} splits on the hospital index; card vs CPU on {len(cut)} "
        f"rows (every 10th): {text}")
    return k3


def clinical_notes(n: int, stop_words, seed: int = NOTE_SEED) -> list:
    """``n`` notes of a seeded 10-topic law over 1,000 terms: each note a
    Dirichlet(0.2) topic mixture, each topic a Dirichlet(0.05) term law
    mixed with 10 % uniform (so every term is drawn), 40 content tokens and
    8 English stop words in a random order, the first letter capitalized."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vocab = np.array([f"term{i:04d}" for i in range(NOTE_VOCAB)], dtype=object)
    beta = 0.9 * rng.dirichlet(np.full(NOTE_VOCAB, 0.05), size=NOTE_TOPICS) + 0.1 / NOTE_VOCAB
    theta = rng.dirichlet(np.full(NOTE_TOPICS, 0.2), size=n)
    z = (rng.random((n, NOTE_LEN, 1)) > np.cumsum(theta, 1)[:, None, :]).sum(-1)
    z = np.minimum(z, NOTE_TOPICS - 1)
    words = np.empty((n, NOTE_LEN), np.int64)
    cb = np.cumsum(beta, 1)
    for t in range(NOTE_TOPICS):
        m = z == t
        words[m] = np.minimum(np.searchsorted(cb[t], rng.random(int(m.sum()))), NOTE_VOCAB - 1)
    stop = np.asarray(sorted(stop_words), dtype=object)
    toks = np.concatenate([vocab[words], stop[rng.integers(0, len(stop), (n, NOTE_STOP))]], 1)
    toks = np.take_along_axis(toks, np.argsort(rng.random(toks.shape), axis=1), 1)
    return [" ".join(r).capitalize() for r in toks]


def top_terms(m, k: int = 5) -> list:
    return [list(idx[:k]) for idx, _ in m.describe_topics(k)]


def text_part(port, card: str) -> None:
    """Slice 5d's text stages and slice 5e's LDA at full width: 100,000
    seeded notes → Tokenizer → StopWordsRemover → CountVectorizer(min_df=2)
    → LDA(k=10, max_iter=20) on the card, its transform and perplexity, and
    out of core in 8 HostDataset blocks; HashingTF(2048) → IDF on the card
    tensor; Word2Vec (Spark's defaults) on the first 10,000 notes twice on
    the card (bit-equal) and against the CPU on a cut; DCT forward and
    inverse on the 2M hospital rows.  Card against CPU within limits that a
    control fails."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    texts = clinical_notes(NOTES, port.StopWordsRemover().stop_words)
    gen_s = time.perf_counter() - t0
    (toks, tok_s) = timed(lambda: port.Tokenizer().transform(texts))
    (clean, stop_s) = timed(lambda: port.StopWordsRemover().transform(toks))
    check(all(len(r) == NOTE_LEN for r in clean[:1000]),
          "StopWordsRemover's default list left stop words in (or took terms out)")
    (cvm, cv_fit_s) = timed(lambda: port.CountVectorizer(min_df=2).fit(clean))
    (counts, cv_s) = timed(lambda: cvm.transform(clean))
    v = len(cvm.vocabulary)
    check(counts.shape == (NOTES, v) and float(counts.sum()) == NOTES * NOTE_LEN,
          "the count matrix does not hold every content token")
    say(f"beyond_phase notes: {NOTES} notes generated in {gen_s:.2f} s; Tokenizer {tok_s:.2f} s, "
        f"StopWordsRemover {stop_s:.2f} s, CountVectorizer(min_df=2) fit {cv_fit_s:.2f} s + "
        f"transform {cv_s:.2f} s → ({NOTES}, {v}) float32, {counts.nbytes / 1e6:.0f} MB")

    # LDA on the card: resident, transform, perplexity, out of core; first a
    # one-iteration fit on 100 notes takes the first use of its CUDA ops
    # (digamma is compiled at run time)
    (_, first_s) = timed(lambda: port.LDA(k=NOTE_TOPICS, max_iter=1).fit(counts[:100],
                                                                         device=DEV))
    lda = port.LDA(k=NOTE_TOPICS, max_iter=20)
    (dev_counts, _) = timed(lambda: torch.from_numpy(counts).to(DEV))
    (m, fit_s) = timed(lambda: lda.fit(dev_counts))
    # ops and host syncs of one iteration (the counter costs about 13 µs an op)
    _, ops, syncs = count_ops(lambda: port.LDA(k=NOTE_TOPICS, max_iter=1).fit(dev_counts))
    check(np.isfinite(m.lam).all() and m.lam.shape == (NOTE_TOPICS, v), "LDA's λ is not finite")
    (mix, tr_s) = timed(lambda: m.transform(dev_counts))
    check(np.allclose(mix.sum(1), 1.0), "LDA's topic mixtures do not sum to 1")
    (perp, perp_s) = timed(lambda: m.log_perplexity(dev_counts))
    check(np.isfinite(perp) and perp > 0, f"LDA's perplexity bound {perp} is not finite")
    del dev_counts
    hd = port.HostDataset(x=counts, max_device_rows=NOTES // LDA_BLOCKS)
    check(hd.block_shape()[0] == LDA_BLOCKS, "the notes do not cut into 8 blocks")
    (mo, ooc_s) = timed(lambda: port.LDA(k=NOTE_TOPICS, max_iter=20).fit(hd, device=DEV))
    check(np.isfinite(mo.lam).all(), "the out-of-core LDA's λ is not finite")
    say(f"beyond_phase LDA(k=10, max_iter=20) on {card}: first use of its ops {first_s:.2f} s; "
        f"resident fit {fit_s:.3f} s, {NOTES * 20 / fit_s:.4g} docs·iterations/s "
        f"({ops} torch ops and {syncs} host syncs in a one-iteration fit); transform "
        f"{tr_s:.2f} s, log_perplexity {perp:.6f} in {perp_s:.2f} s; out of core in "
        f"{LDA_BLOCKS} blocks: fit {ooc_s:.3f} s, "
        f"{NOTES // LDA_BLOCKS * 20 / ooc_s:.4g} docs·iterations/s, perplexity "
        f"{mo.log_perplexity(counts, device=DEV):.6f}")
    cut = counts[:LDA_CUT]
    fits = {dev: port.LDA(k=NOTE_TOPICS, max_iter=20).fit(cut, device=dev)
            for dev in (DEV, "cpu")}
    with tf32_matmuls():
        ctl_m = port.LDA(k=NOTE_TOPICS, max_iter=20).fit(cut, device=DEV)
        ctl_mix = ctl_m.transform(cut, device=DEV)
        ctl_perp = ctl_m.log_perplexity(cut, device=DEV)

    b = fits["cpu"]
    bmix, bperp = b.transform(cut, device="cpu"), b.log_perplexity(cut, device="cpu")

    def lda_gaps(a, amix, aperp):
        return {"lam": rel(a.lam, b.lam), "mixtures": rel(amix, bmix),
                "perplexity": abs(aperp - bperp) / abs(bperp),
                "top_terms": int(top_terms(a) != top_terms(b))}

    a = fits[DEV]
    gaps = lda_gaps(a, a.transform(cut, device=DEV), a.log_perplexity(cut, device=DEV))
    ctl = lda_gaps(ctl_m, ctl_mix, ctl_perp)
    say(f"beyond_phase LDA card vs CPU on {LDA_CUT} notes: {beyond_gated('lda', gaps, ctl)}")

    # HashingTF(2048) → IDF on the card tensor
    (tf, tf_s) = timed(lambda: port.HashingTF(HASH_FEATURES).transform(clean))
    (tf_dev, _) = timed(lambda: torch.from_numpy(tf).to(DEV))
    (idf, idf_s) = timed(lambda: port.IDF().fit(tf_dev))
    (tfidf, tfidf_s) = timed(lambda: idf.transform(tf_dev))
    check(tfidf.device == tf_dev.device and torch.equal(tfidf.cpu(), torch.from_numpy(idf.transform(tf))),
          "TF-IDF on the card differs from numpy")
    say(f"beyond_phase HashingTF({HASH_FEATURES}) {tf_s:.2f} s → IDF fit on the card tensor "
        f"{idf_s:.2f} s, transform {tfidf_s * 1e3:.1f} ms on the card == numpy")
    del tf_dev, tfidf

    # Word2Vec (Spark's defaults) on the first 10,000 notes: two card fits
    w2v = port.Word2Vec()
    docs = clean[:W2V_NOTES]
    (w1, w_s) = timed(lambda: w2v.fit(docs, device=DEV))
    known = set(w1.vocabulary)
    lens = np.asarray([sum(t in known for t in r) for r in docs])
    win = w2v.window_size

    def n_pairs(m: int) -> int:
        # each position pairs with its window: 2·win neighbours, fewer at the ends
        return sum(min(m, i + win + 1) - max(0, i - win) - 1 for i in range(m))

    pairs = int(sum(n_pairs(int(m)) * int(c)
                    for m, c in zip(*np.unique(lens, return_counts=True))))
    (w2, w_ops, w_syncs), w2_s = timed(lambda: count_ops(lambda: w2v.fit(docs, device=DEV)))
    check(np.array_equal(w1.vectors, w2.vectors) and w1.vocabulary == w2.vocabulary,
          "two Word2Vec fits of one seed on the card differ")
    steps = -(-pairs // w2v.batch_size)
    say(f"beyond_phase Word2Vec on {card}, {W2V_NOTES} notes, {pairs} pairs, {steps} steps "
        f"of {w2v.batch_size}: {fit_line('fit', w_s, pairs, 'pairs', w_ops, w_syncs)} "
        f"({steps / w_s:.0f} steps/s; ops and syncs of the second fit, {w2_s:.2f} s under the "
        f"counter); two fits bit-equal")
    wc = clean[:W2V_CUT]
    wm = {dev: w2v.fit(wc, device=dev) for dev in (DEV, "cpu")}
    wctl = port.Word2Vec(step_size=w2v.step_size * (1 + 2 ** -7)).fit(wc, device=DEV)

    def w2v_gaps(x):
        # cosines in float64: in float32 1 − cos resolves no finer than 6e-8
        a, ref = x.vectors.astype(np.float64), wm["cpu"]
        b = ref.vectors.astype(np.float64)
        cos = (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)
        words = ref.vocabulary[:20]
        return {"cosine": float(1.0 - cos.min()),
                "synonyms": int(any([t for t, _ in x.find_synonyms(w, 5)]
                                    != [t for t, _ in ref.find_synonyms(w, 5)] for w in words))}

    say(f"beyond_phase Word2Vec card vs CPU on {W2V_CUT} notes: "
        f"{beyond_gated('word2vec', w2v_gaps(wm[DEV]), w2v_gaps(wctl))}")

    # DCT forward and inverse on the 2M hospital rows
    x = stage_rows()[0].astype(np.float32)
    xd = torch.from_numpy(x).to(DEV)
    (fwd, dct_s) = timed(lambda: port.DCT().transform(xd))
    back = port.DCT(inverse=True).transform(fwd)
    cpu_f = port.DCT().transform(x, device="cpu")
    cpu_b = port.DCT(inverse=True).transform(cpu_f)
    with tf32_matmuls():
        ctl_f = port.DCT().transform(xd)
        ctl_b = port.DCT(inverse=True).transform(ctl_f)
    gaps = {"forward": rel(fwd.cpu().numpy(), cpu_f.numpy()),
            "inverse": rel(back.cpu().numpy(), cpu_b.numpy())}
    ctl = {"forward": rel(ctl_f.cpu().numpy(), cpu_f.numpy()),
           "inverse": rel(ctl_b.cpu().numpy(), cpu_b.numpy())}
    trip = rel(back.cpu().numpy(), x)
    check(trip <= 1e-6, f"DCT's round trip is {trip:.3g} off the rows")
    say(f"beyond_phase DCT on {len(x)} rows on the card {dct_s * 1e3:.1f} ms, round trip "
        f"{trip:.3g}; card vs CPU: {beyond_gated('dct', gaps, ctl)}")


def als_ratings():
    """Synthetic utilisation ratings: 200,000 patients × 5,000 services,
    10M distinct (patient, service) pairs, service popularity a seeded Zipf
    law (exponent 1.1), ratings 3 + a rank-10 product + N(0, 0.3)."""
    import numpy as np

    rng = np.random.default_rng(ALS_SEED)
    p = 1.0 / np.arange(1, ALS_ITEMS + 1) ** 1.1
    p /= p.sum()
    # the popular services saturate (nearly every patient uses the top few):
    # 1.7x the pairs draw about 10.7M distinct ones, of which 10M are kept
    pairs = np.empty(0, np.int64)
    while len(pairs) < ALS_RATINGS:
        draw = int((ALS_RATINGS - len(pairs)) * 1.7) + 1000
        pairs = np.unique(np.r_[pairs, rng.integers(0, ALS_USERS, draw) * ALS_ITEMS
                                + rng.choice(ALS_ITEMS, draw, p=p)])
    pairs = pairs[np.sort(rng.choice(len(pairs), ALS_RATINGS, replace=False))]
    uu, ii = pairs // ALS_ITEMS, pairs % ALS_ITEMS
    u = rng.normal(0, 1 / np.sqrt(ALS_RANK), (ALS_USERS, ALS_RANK))
    v = rng.normal(0, 1, (ALS_ITEMS, ALS_RANK))
    r = 3.0 + np.einsum("nf,nf->n", u[uu], v[ii]) + rng.normal(0, 0.3, len(uu))
    return uu, ii, r.astype(np.float32)


def held_out(uu, seed: int = ALS_SEED + 1):
    """A mask of 10 % of each patient's ratings (rounded down, at least
    one of a patient's ratings stays in training)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    order = np.argsort(uu + rng.random(len(uu)))       # patients' ratings shuffled
    counts = np.bincount(uu)
    starts = np.r_[0, np.cumsum(counts)[:-1]]
    pos = np.empty(len(uu), np.int64)
    pos[order] = np.arange(len(uu)) - starts[uu[order]]
    return pos < (counts[uu] // 10)


def recs_rows(a, b, sa, sb) -> int:
    """Rows whose top-k ids differ between two routes where the routes'
    k-th and (k+1)-th scores are further apart than their score gap."""
    import numpy as np

    gap = float(np.abs(sa - sb).max())
    diff = np.flatnonzero((a != b).any(axis=1))
    if diff.size == 0:
        return 0
    close = np.abs(np.diff(sb[diff], axis=1)).min(axis=1) <= 2 * gap
    return int((~close).sum())


def als_part(port, card: str) -> None:
    """Slice 5e's ALS at MovieLens-20M's order of size: 200,000 patients ×
    5,000 services, 10M ratings, 10 % of each patient's held out; ALS(rank
    10, max_iter 10, reg 0.1) on the card, recommend_for_all_users(10) (one
    200,000 × 5,000 product) and the RankingEvaluator on the held-out
    services; the implicit and NNLS fits on a 1M-rating cut, each card
    against CPU within limits that the card route on bfloat16-rounded
    ratings fails."""
    import numpy as np

    t0 = time.perf_counter()
    uu, ii, rr = als_ratings()
    hold = held_out(uu)
    gen_s = time.perf_counter() - t0
    train = (uu[~hold], ii[~hold], rr[~hold])
    n_train = int((~hold).sum())
    als = port.ALS(rank=ALS_RANK, max_iter=10, reg_param=0.1)
    (m, ops, syncs), fit_s = timed(lambda: count_ops(lambda: als.fit(train, device=DEV)))
    check(np.isfinite(m.user_factors).all() and np.isfinite(m.item_factors).all(),
          "ALS factors are not finite")
    rmse = float(np.sqrt(np.mean((m.predict(uu[hold], ii[hold]) - rr[hold]) ** 2)))
    spread = float(rr[hold].std())
    check(rmse < 0.6 * spread, f"ALS held-out RMSE {rmse:.4f} against the ratings' spread "
          f"{spread:.4f} (the noise is 0.3)")
    ((ids, scores), rec_s) = timed(lambda: m.recommend_for_all_users(10, device=DEV))
    check(ids.shape == (ALS_USERS, 10) and np.all(np.diff(scores, axis=1) <= 0),
          "recommendations are not (200000, 10) in descending order")
    truth_order = np.argsort(uu[hold], kind="stable")
    hu, hi = uu[hold][truth_order], ii[hold][truth_order]
    bounds = np.r_[0, np.cumsum(np.bincount(hu, minlength=ALS_USERS))]
    truth = [hi[bounds[u]:bounds[u + 1]].tolist() for u in range(ALS_USERS)]
    preds = ids.tolist()
    t0 = time.perf_counter()
    metrics = {name: port.RankingEvaluator(name, k=10).evaluate(preds, truth)
               for name in ("precisionAtK", "ndcgAtK", "meanAveragePrecision")}
    eval_s = time.perf_counter() - t0
    say(f"beyond_phase ALS on {card}: {len(uu)} ratings of {ALS_USERS} patients × {ALS_ITEMS} "
        f"services ({gen_s:.2f} s to draw), {n_train} in training; "
        f"{fit_line('fit', fit_s, n_train * 10, 'ratings·iterations', ops, syncs)}; held-out "
        f"RMSE {rmse:.4f}; recommend_for_all_users(10) {rec_s:.2f} s; RankingEvaluator "
        f"{json.dumps({k: round(v, 6) for k, v in metrics.items()})} in {eval_s:.2f} s")

    cut = uu < ALS_CUT_USERS
    cu, ci, cr = uu[cut], ii[cut], rr[cut]
    lines = []
    for name, kw, r in (("als", {}, cr), ("als_implicit", {"implicit_prefs": True},
                                          np.maximum(cr, 0.0)),
                        ("als_nonnegative", {"nonnegative": True}, cr)):
        est = port.ALS(rank=ALS_RANK, max_iter=10, reg_param=0.1, **kw)
        (mc, c_s) = timed(lambda: est.fit((cu, ci, r), device=DEV))
        # ops and host syncs of one iteration: NNLS runs about 120,000 ops an
        # iteration, and the counter (about 13 µs an op) would slow a timed fit
        one = port.ALS(rank=ALS_RANK, max_iter=1, reg_param=0.1, **kw)
        _, c_ops, c_syncs = count_ops(lambda: one.fit((cu, ci, r), device=DEV))
        mh = est.fit((cu, ci, r), device="cpu")
        ml = est.fit((cu, ci, bf16_round(r)), device=DEV)
        want = mh.predict(cu, ci)
        ri = {dev: mc.recommend_for_all_users(10, device=dev) for dev in (DEV, "cpu")}

        def gaps_of(x):
            return {"pred": rel(x.predict(cu, ci), want),
                    "subspace": subspace_gap(x.user_factors[:ALS_CUT_USERS],
                                             mh.user_factors[:ALS_CUT_USERS])}

        gaps = {**gaps_of(mc), "recs_rows": recs_rows(ri[DEV][0], ri["cpu"][0], ri[DEV][1],
                                                      ri["cpu"][1])}
        text = beyond_gated(name, gaps, gaps_of(ml))
        lines.append(f"{name} (card fit {c_s:.3f} s, {len(cu) * 10 / c_s:.4g} "
                     f"ratings·iterations/s; one iteration {c_ops} torch ops, {c_syncs} host "
                     f"syncs): {text}")
    say(f"beyond_phase ALS card vs CPU on {int(cut.sum())} ratings of {ALS_CUT_USERS} patients: "
        + "; ".join(lines))


def knn_graph(x, k: int):
    """(src, dst, weight) of the ``k``-nearest-neighbour graph of the rows
    ``x`` on the card (squared distances in float64, chunks of rows), with
    Gaussian weights exp(−d²/2σ²), σ the median neighbour distance."""
    import numpy as np
    import torch

    xd = torch.from_numpy(np.asarray(x, np.float64)).to(DEV)
    sq = (xd * xd).sum(1)
    nbr, dist = [], []
    for s in range(0, len(x), 4096):
        d2 = sq[s:s + 4096, None] - 2 * xd[s:s + 4096] @ xd.T + sq[None, :]
        d2[torch.arange(d2.shape[0]), torch.arange(s, s + d2.shape[0])] = float("inf")
        val, idx = torch.sort(d2, dim=1, stable=True)
        nbr.append(idx[:, :k].cpu().numpy())
        dist.append(torch.sqrt(torch.clamp(val[:, :k], min=0)).cpu().numpy())
    dst = np.concatenate(nbr).ravel()
    d = np.concatenate(dist).ravel()
    src = np.repeat(np.arange(len(x)), k)
    sigma = float(np.median(d))
    return src, dst, np.exp(-(d * d) / (2 * sigma * sigma)).astype(np.float32)


def pic_part(port, L, card: str) -> dict:
    """Slice 5e's PowerIterationClustering: the bundled CSV's 20,000
    standardized rows as a 10-nearest-neighbour graph (about 200,000 edges),
    k = 8, 20 iterations; the dense affinity (1.6 GB) on the card, then
    KMeans on the (20,000, 1) embedding (K1 a Lloyd step, K2 in predict),
    held to their plain versions at the fit's centers; against the CPU
    route on the same edges.  → K1 and K2 launches."""
    import numpy as np
    import torch

    table = port.read_csv(str(CSV), port.hospital_event_schema())
    x = table.numeric_matrix(port.FEATURE_COLS)
    x = (x - x.mean(0)) / x.std(0)
    (edges, knn_s) = timed(lambda: knn_graph(x, PIC_NEIGHBOURS))
    src, dst, w = edges
    pic = port.PowerIterationClustering(k=PIC_K, max_iter=20)
    before = L.launch_counts()
    (labels, ops, syncs), fit_s = timed(lambda: count_ops(
        lambda: pic.assign_clusters(src, dst, w, device=DEV)))
    after = L.launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    check(launches["fused_lloyd_stats"] >= 2 and launches["fused_assign"] >= 1,
          f"PIC's KMeans launched {launches} (K1 a Lloyd step, K2 in predict)")
    emb = {dev: pic.embed(src, dst, w, device=dev) for dev in (DEV, "cpu")}
    ctl_emb = pic.embed(src, dst, bf16_round(w), device="cpu")

    def cpu_labels_of(v):
        # assign_clusters' k-means step (Lin & Cohen step 3) on the CPU route
        ev = v[:, None].astype(np.float32)
        km = port.KMeans(k=PIC_K, seed=pic.seed, max_iter=40).fit(ev, device="cpu")
        return km.predict_numpy(ev, device="cpu").astype(np.int64)

    cpu_labels, ctl_labels = cpu_labels_of(emb["cpu"]), cpu_labels_of(ctl_emb)
    gaps = {"embedding": rel(emb[DEV], emb["cpu"]), "rows": relabelled_rows(cpu_labels, labels)}
    ctl = {"embedding": rel(ctl_emb, emb["cpu"]), "rows": relabelled_rows(cpu_labels, ctl_labels)}
    # K1 and K2 against their plain versions on the embedding at the fit's
    # centers (the same 1-D KMeans, refit on the card)
    e = emb[DEV][:, None].astype(np.float32)
    km = port.KMeans(k=PIC_K, seed=pic.seed, max_iter=40).fit(e, device=DEV)
    xe = torch.from_numpy(e).to(DEV)
    we = torch.ones(len(e), device=DEV)
    cen = torch.from_numpy(km.cluster_centers).to(DEV)
    cv = torch.ones(PIC_K, device=DEV)
    a, m2 = L.fused_assign(xe, cen, cv)
    ap, mp = L.fused_assign_plain(xe, cen, cv)
    s, c, cost = L.fused_lloyd_stats(xe, we, cen, cv)
    sp, cp, costp = L.fused_lloyd_stats_plain(xe, we, cen, cv)
    flips = int((a != ap).sum())
    k1 = {"sums": rel(s.cpu().numpy(), sp.cpu().numpy()),
          "counts": float((c - cp).abs().sum()), "cost": abs(float(cost) / float(costp) - 1)}
    check(flips <= len(e) // 1000 and k1["counts"] <= 2 * flips,
          f"K1/K2 on the PIC embedding: {flips} assignments and counts {k1['counts']} apart")
    say(f"beyond_phase PIC on {card}: {len(x)} bundled rows → {len(src)} edges of a "
        f"{PIC_NEIGHBOURS}-NN graph ({knn_s:.2f} s); "
        f"{fit_line('assign_clusters', fit_s, len(x) * 20, 'node·iterations', ops, syncs)}, "
        f"K1 {launches['fused_lloyd_stats']}, K2 {launches['fused_assign']}; cluster sizes "
        f"{np.bincount(labels, minlength=PIC_K).tolist()}; card vs CPU: "
        f"{beyond_gated('pic', gaps, ctl)}; K2 vs plain at the fit's centers: {flips} "
        f"assignments differ (min d² {float((m2 - mp).abs().max()):.3g} apart), K1 vs plain: "
        f"{as_text(k1)}")
    return {"fused_lloyd_stats": launches["fused_lloyd_stats"],
            "fused_assign": launches["fused_assign"]}


def beyond_phase(port, L, H, card: str) -> dict:
    """Slices 5d + 5e at full width: the selectors and the indexed
    categorical tree (K3) on the 2M hospital rows, the clinical-note text
    stages into LDA, Word2Vec and HashingTF → IDF, DCT, ALS with the
    ranking evaluators, and PowerIterationClustering (K1, K2 at d = 1).
    → the launches of its main path."""
    counts = {"fused_lloyd_stats": 0, "fused_assign": 0, "fused_level_hist": 0}
    counts["fused_level_hist"] += selectors_part(port, H, card)
    lap("beyond selectors")
    text_part(port, card)
    lap("beyond text")
    als_part(port, card)
    lap("beyond als")
    for k, v in pic_part(port, L, card).items():
        counts[k] += v
    lap("beyond pic")
    return counts


# ------------------------------------------------ slice 6: views and history
VIEW_N = 200_000                          # rows a hospital: 1M rows over the whole day (2M
                                          # until slice 7c)
VIEW_BATCHES = 40                         # bench.py _bench_sql_incremental: 25,000 rows a drop
VIEW_KILL_BATCHES = 8                     # the kill-and-resume leg's fresh table
VIEW_KILL_AT = 5
WINDOW_SPAN = ("2025-03-31 12:00:00", "2025-03-31 18:00:00")
HIST_BATCHES = 400                        # bench.py _bench_sql_history: 4 → 400 hourly batches
HIST_ROWS = 2_500                         # bench's 256 rows a batch, raised: 1M rows in all
                                          # (2M until slice 7c)
HIST_REPS = 9
FUZZ_SEEDS = (0, 1, 2)
HOSP_Q = ("SELECT hospital_id, count(*) AS n, sum(admission_count) AS adm, "
          "avg(current_occupancy) AS occ, max(length_of_stay) AS los_max "
          "FROM events GROUP BY hospital_id")
WINDOW_Q = (f"SELECT * FROM events WHERE event_time BETWEEN '{WINDOW_SPAN[0]}' "
            f"AND '{WINDOW_SPAN[1]}'")


def first_unequal_column(x, y) -> str | None:
    """The first column in which two tables differ in dtype or in any byte
    (object columns by value), else None."""
    for c in x.columns:
        a, b = x.column(c), y.column(c)
        same = a.tolist() == b.tolist() if a.dtype == object else a.tobytes() == b.tobytes()
        if a.dtype != b.dtype or not same:
            return c
    return None


def median_p90(xs) -> str:
    import numpy as np

    return f"median {np.median(xs):.2f} / p90 {np.percentile(xs, 90):.2f}"


def view_stream(port, root: str, views):
    """A StreamExecution over ``root`` with a 2-hour watermark on
    ``event_time`` and the registry ``views``, fed by the caller one CSV
    drop at a time (``drop``)."""
    os.makedirs(os.path.join(root, "incoming"), exist_ok=True)
    return port.StreamExecution(
        source=port.FileStreamSource(os.path.join(root, "incoming"),
                                     port.hospital_event_schema()),
        sink=port.UnboundedTable(os.path.join(root, "table"), port.hospital_event_schema(),
                                 name="events"),
        checkpoint=port.StreamCheckpoint(os.path.join(root, "ckpt")),
        watermark=port.WatermarkTracker("event_time", 120.0),
        views=views, device=DEV)


def drop(drops: str, root: str, b: int) -> None:
    """Drop ``b`` (written once into ``drops``) into ``root``'s incoming
    directory: a hard link, so the two streams below read one file."""
    name = f"drop-{b:03d}.csv"
    os.link(os.path.join(drops, name), os.path.join(root, "incoming", name))


def views_part(port, tmp: str, drops: str, bounds) -> dict:
    """The two views over the stream: 40 drops through ``Session.read_stream``
    with a 2-hour watermark; each view against the port's interpreter on
    the same snapshot after batches 0-3, every 10th and the last; both
    queries served by route "view"; the compaction; per-batch maintain,
    serve and full-recompute times.  → the session's last snapshot and
    the train_window view's rows."""
    import numpy as np

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import sql
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.sql_fuzz import (
        compare_tables,
    )

    os.makedirs(os.path.join(tmp, "incoming"))
    s = port.Session(device=DEV)
    try:
        sdf = (s.read_stream.schema(port.hospital_event_schema())
               .csv(os.path.join(tmp, "incoming")).with_watermark("event_time", "2 hours"))
        q = sdf.write_stream.option("checkpointLocation", os.path.join(tmp, "ckpt")).table(
            "events")
        views = {"hospital_stats": s.create_view("hospital_stats", HOSP_Q,
                                                 watermark=sdf.watermark),
                 "train_window": s.create_view("train_window", WINDOW_Q)}
        maintain = s.views.maintain
        maintain_ms: list[float] = []

        def timed_maintain(*a, **k):
            t0 = time.perf_counter()
            out = maintain(*a, **k)
            sync()
            maintain_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        s.views.maintain = timed_maintain
        checked = []
        for b, (lo, hi) in enumerate(bounds):
            drop(drops, tmp, b)
            infos = q.process_available()
            check(len(infos) == 1 and infos[0].num_late_rows == 0
                  and infos[0].num_appended_rows == hi - lo,
                  f"drop {b}: {[(i.num_appended_rows, i.num_late_rows) for i in infos]}")
            if b < 4 or (b + 1) % 10 == 0 or b == len(bounds) - 1:
                snap = s.table("events")
                for name, v in views.items():
                    want = sql.execute(v.query, lambda _n, t=snap: t, mode="interpret")
                    bad = compare_tables(want, v.read())
                    check(bad is None, f"view {name} after batch {b}: {bad}")
                checked.append(b)
        check(len(maintain_ms) == len(bounds), f"{len(maintain_ms)} maintenances timed")
        s.views.maintain = maintain
        snap = s.table("events")
        serve_ms = {}
        for name, v in views.items():
            ms = []
            for _ in range(3):
                out, t = host_ms(lambda: s.sql(v.query))
                ms.append(t)
                d = sql.last_dispatch()
                check(d.route == "view", f"Session.sql of {name} took route {d.route}")
            serve_ms[name] = float(np.median(ms))
        full_ms = {}
        for name, v in views.items():
            cold = snap.mask(np.ones(len(snap), dtype=bool))   # no device columns yet
            out1, first = host_ms(lambda: sql.execute(v.query, lambda _n: cold,
                                                      mode="compile", device=DEV))
            out2, again = host_ms(lambda: sql.execute(v.query, lambda _n: cold,
                                                      mode="compile", device=DEV))
            full_ms[name] = (first, again)
            c = first_unequal_column(out1, out2)
            check(c is None, f"two compiled runs of {name} on the card differ in {c}")
        d = views["hospital_stats"].describe()
        check(d["incremental"] and d["compacted_upto"] is not None,
              f"hospital_stats was not compacted: {d}")
        check(views["train_window"].describe()["incremental"], "train_window is not incremental")
        errs = q.execution.metrics.snapshot()["counters"].get("stream.view_maintain_errors", 0)
        check(errs == 0, f"stream.view_maintain_errors {errs}")
        early, late = maintain_ms[:8], maintain_ms[-8:]
        say(f"views: {len(bounds)} drops x {bounds[0][1] - bounds[0][0]} rows through "
            f"Session.read_stream (2-hour watermark) into {len(snap)} rows; hospital_stats and "
            f"train_window == the interpreter (rtol 1e-9) after batches {checked}; maintain "
            f"ms a batch (host clock, both views, first 8) {median_p90(early)}, (last 8) "
            f"{median_p90(late)}; Session.sql served by view: "
            f"{json.dumps({k: round(v, 3) for k, v in serve_ms.items()})} ms; a full compiled "
            f"recompute over the last snapshot (cold, warm; byte-equal): "
            f"{json.dumps({k: [round(x, 3) for x in v] for k, v in full_ms.items()})} ms; "
            f"hospital_stats compacted up to batch {d['compacted_upto']}, "
            f"{d['batches_retained']} partials retained")
        window = views["train_window"].read()
    finally:
        s.stop()
    return {"snapshot": snap, "window": window}


def kill_part(port, tmp: str, drops: str) -> None:
    """The first 8 drops in a fresh table, once straight through and once
    killed at ``sql.view.maintain`` on batch 5 and resumed in a new
    registry: hospital_stats reads byte for byte the same."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.sql_views import (
        ViewRegistry,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults

    def run(root: str, kill_at=None):
        reg = ViewRegistry(device=DEV)
        ex = view_stream(port, root, reg)
        view = reg.register("hospital_stats", HOSP_Q, ex.sink, watermark=ex.watermark)
        for b in range(VIEW_KILL_BATCHES):
            drop(drops, root, b)
            if b == kill_at:
                plan = faults.FaultPlan().crash("sql.view.maintain")
                with faults.active(plan):
                    try:
                        ex.run_once()
                        fail("the kill at sql.view.maintain did not fire")
                    except faults.InjectedCrash:
                        pass
                check(plan.fired("sql.view.maintain") == 1, "the view kill fired wrongly")
                reg = ViewRegistry(device=DEV)              # the restart
                ex = view_stream(port, root, reg)
                view = reg.register("hospital_stats", HOSP_Q, ex.sink, watermark=ex.watermark)
                check(ex.run_once() is None, "the killed batch was not committed")
            else:
                check(ex.run_once() is not None, f"drop {b} made no batch")
        return view.read()

    clean = run(os.path.join(tmp, "clean"))
    killed = run(os.path.join(tmp, "killed"), kill_at=VIEW_KILL_AT)
    c = first_unequal_column(clean, killed)
    check(c is None, f"resumed hospital_stats differs in {c}")
    say(f"views: killed at sql.view.maintain on batch {VIEW_KILL_AT} of "
        f"{VIEW_KILL_BATCHES} and resumed in a new registry: hospital_stats byte-equal "
        f"(tobytes) to the uninterrupted run's ({len(clean)} groups)")


def window_part(port, H, window, snap) -> dict:
    """train_window's rows into the stage's RandomForestRegressor (20
    trees, depth 5) on the card, and the interpreter's window the same
    way: the rows, the trees and the RMSE ``==``; K3 at the fit's shape
    against its plain version.  → the view fit's K3 launches and the
    shape's record."""
    import numpy as np

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import sql

    want = sql.execute(WINDOW_Q, lambda _n: snap, mode="interpret")
    bad = table_mismatch(window, want, exact=True)
    check(bad is None, f"train_window rows differ from the interpreter's: {bad}")
    cfg = port.PipelineConfig()

    def fit(tab):
        t = port.Binarizer(port.LABEL_COL, "LOS_binary", cfg.los_threshold).transform(
            tab.na_drop())
        train_t, test_t = port.train_test_split(t, cfg.train_fraction, cfg.split_seed)
        asm = port.VectorAssembler(port.FEATURE_COLS)
        train, test = asm.transform(train_t), asm.transform(test_t)
        model = port.RandomForestRegressor(max_depth=cfg.tree_max_depth,
                                           num_trees=cfg.rf_num_trees).fit(
            train, label_col=port.LABEL_COL, device=DEV)
        preds = model.transform(test, label_col=port.LABEL_COL, device=DEV)
        rmse = port.RegressionEvaluator("rmse", label_col=port.LABEL_COL).evaluate(preds)
        return model, rmse, len(train_t)

    H.reset_launch_counts()
    (model, rmse, n_train), fit_s = timed(lambda: fit(window))
    launches = H.launch_counts()["fused_level_hist"]
    check(launches == cfg.tree_max_depth + 1,
          f"the window forest launched K3 {launches} times (expected {cfg.tree_max_depth + 1})")
    ref, ref_rmse, _ = fit(want)
    for a in ("split_feat", "threshold", "value", "feature_importances"):
        check(np.array_equal(getattr(model, a), getattr(ref, a)),
              f"the view window's forest differs from the interpreter window's in {a}")
    check(rmse == ref_rmse and np.isfinite(rmse), f"RMSE {rmse} != {ref_rmse}")
    B, LN = 32, 2 ** cfg.tree_max_depth
    ins = k3_inputs(n_train, len(port.FEATURE_COLS), 3, cfg.rf_num_trees, LN, B, seed=41)
    err, _ = k3_check(H, *ins, LN, B, "train_window forest depth 5")
    t = k3_time(H, *ins, LN, B, reps=10)
    del ins
    say(f"views: train_window's {len(window)} rows == the interpreter's; RandomForestRegressor("
        f"{cfg.rf_num_trees} trees, depth {cfg.tree_max_depth}) on its {n_train} training rows "
        f"in {fit_s:.3f} s ({launches} K3 launches), trees and RMSE {rmse:.6f} == the "
        f"interpreter window's; K3 at (n={n_train} d=4 S=3 T={cfg.rf_num_trees} LN={LN} B={B}) "
        f"{t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, library {t['library_ms']:.4f}, bound "
        f"{t['bound_ms']:.4f} by {t['bound_by']}), integer stats exact")
    return {"launches": launches,
            "shape": {"n": n_train, "d": 4, "S": 3, "T": cfg.rf_num_trees, "LN": LN, "B": B,
                      "max_abs_err": err, **t}}


def history_part(port, tmp: str) -> None:
    """bench.py's history legs at 5,000 rows a batch: 4 then 400 hourly
    batches under bench's seal/retire policy; the "last two hours" query
    compiled and pruned on the card ``==`` the interpreter and an unpruned
    compiled scan; its medians of 9 at 4 and 400 batches; a flipped byte
    scrubbed and rebuilt with the answers unchanged."""
    import numpy as np

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import sql
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.table_lifecycle import (  # noqa: E501
        RetentionPolicy,
        TableLifecycle,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.obs.registry import (
        global_registry,
    )

    rng = np.random.default_rng(0)
    base = np.datetime64("2025-03-31T00:00:00")

    def make_batch(b: int):
        t = (base + (b * 3600 + rng.integers(0, 3600, HIST_ROWS)).astype("timedelta64[s]")
             ).astype("datetime64[ns]")
        return port.Table.from_dict({"hospital": rng.integers(0, 16, HIST_ROWS), "event_time": t,
                                     "admissions": rng.integers(0, 50, HIST_ROWS),
                                     "occupancy": rng.normal(250.0, 40.0, HIST_ROWS)})

    def recent(n_batches: int, hours: int = 2) -> str:
        cut = str((base + np.timedelta64(n_batches - hours, "h")).astype("datetime64[s]"))
        return ("SELECT hospital, admissions, occupancy FROM events"
                f" WHERE event_time >= '{cut.replace('T', ' ')}'")

    def median_ms(q, resolve):
        sql.execute(q, resolve, device=DEV)
        xs = [host_ms(lambda: sql.execute(q, resolve, device=DEV))[1] for _ in range(HIST_REPS)]
        return float(np.median(xs))

    policy = RetentionPolicy(min_seal_batches=4, hot_batches=2, max_segment_batches=32)
    sink = port.UnboundedTable(os.path.join(tmp, "history"), make_batch(0).schema, name="events")
    resolve = lambda _n: sink.read()  # noqa: E731
    t0 = time.perf_counter()
    for b in range(4):
        sink.append_batch(make_batch(b), b)
    TableLifecycle(sink, policy).tick()
    small_ms = median_ms(recent(4), resolve)
    for b in range(4, HIST_BATCHES):
        sink.append_batch(make_batch(b), b)
    ingest_s = time.perf_counter() - t0
    (lc, tick_s) = timed(lambda: TableLifecycle(sink, policy).tick())
    q = recent(HIST_BATCHES)
    skipped0 = global_registry().counters.get("table.segments_prune_skipped", 0)
    large_ms = median_ms(q, resolve)
    check(global_registry().counters.get("table.segments_prune_skipped", 0) > skipped0,
          "table.segments_prune_skipped did not move")
    got = sql.execute(q, resolve, device=DEV)
    d = sql.last_dispatch()
    check(d.route == "compiled" and d.reasons == (), f"the recent query ran {d}")
    bad = table_mismatch(got, sql.execute(q, resolve, mode="interpret"), exact=True)
    check(bad is None, f"pruned compiled scan != the interpreter: {bad}")
    snap = sink.read()
    detached = snap.mask(np.ones(len(snap), dtype=bool))   # no origin: nothing to prune
    bad = table_mismatch(got, sql.execute(q, lambda _n: detached, device=DEV), exact=True)
    check(bad is None, f"pruned compiled scan != the unpruned compiled scan: {bad}")
    unpruned_ms = median_ms(q, lambda _n: detached)
    prune = sql.explain(q, resolve)["prune"]
    check(prune["segments_pruned"] == prune["segments"] > 0
          and prune["rows_pruned"] == (HIST_BATCHES - 2) * HIST_ROWS,
          f"explain's prune {prune}")
    say(f"history: {HIST_BATCHES} hourly batches x {HIST_ROWS} rows ({len(snap)} rows) appended "
        f"in {ingest_s:.2f} s; tick {lc} in {tick_s:.2f} s; explain prune {json.dumps(prune)}; "
        f"the last-two-hours query ({len(got)} rows) compiled + pruned == the interpreter == "
        f"the unpruned compiled scan; median of {HIST_REPS} (host ms): at 4 batches "
        f"{small_ms:.3f}, at {HIST_BATCHES} {large_ms:.3f} (ratio {large_ms / small_ms:.3f}), "
        f"unpruned at {HIST_BATCHES} {unpruned_ms:.3f}")

    # a sealed segment whose parts survive, one byte of it flipped
    n = HIST_BATCHES
    for b in range(n, n + 6):
        sink.append_batch(make_batch(b), b)
    keep = RetentionPolicy(min_seal_batches=4, hot_batches=2, max_segment_batches=32,
                           retire_parts=False)
    check(TableLifecycle(sink, keep).seal() == 1, "the kept segment did not seal")
    q6 = recent(n + 6, hours=6)
    count_q = "SELECT count(*) AS n, sum(admissions) AS adm FROM events"
    before = [sql.execute(x, resolve, device=DEV) for x in (q6, count_q)]
    newest = max(sink._committed_state()[1], key=lambda e: e["_seq"])
    seg = os.path.join(sink.segments_dir, newest["file"])
    blob = bytearray(open(seg, "rb").read())
    blob[len(blob) // 2] ^= 0x01
    with open(seg, "wb") as f:
        f.write(bytes(blob))
    out, scrub_s = timed(lambda: TableLifecycle(sink, keep).scrub())
    check(out["repaired"] == 1 and out["quarantined"] == 0, f"scrub {out}")
    after = [sql.execute(x, resolve, device=DEV) for x in (q6, count_q)]
    for x, a, b in zip((q6, count_q), before, after):
        bad = table_mismatch(b, a, exact=True)
        check(bad is None, f"after the scrub {x!r} changed: {bad}")
    check(int(after[1]["n"][0]) == (n + 6) * HIST_ROWS, "count(*) lost rows")
    say(f"history: one byte of {os.path.basename(seg)} flipped; scrub {json.dumps(out)} in "
        f"{scrub_s:.2f} s; the last-six-hours query and count(*) == before")


def fuzz_part(port) -> None:
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import sql_fuzz

    t0 = time.perf_counter()
    for s in FUZZ_SEEDS:
        bad = sql_fuzz.run_fuzz(n_queries=40, seed=s, device=DEV)
        check(bad == [], f"run_fuzz seed {s} on the card: {bad}")
    bad = sql_fuzz.run_fuzz_incremental(n_queries=10, seed=0, device=DEV)
    check(bad == [], f"run_fuzz_incremental on the card: {bad}")
    say(f"fuzz on the card: run_fuzz(40) for seeds {list(FUZZ_SEEDS)} and "
        f"run_fuzz_incremental(10, seed 0) find no failure in "
        f"{time.perf_counter() - t0:.2f} s")


def history_phase(port, H, card: str) -> dict:
    """Slice 6 at full width: the materialized views over the stream
    (1M rows in 40 drops), a kill at view maintenance resumed byte-equal,
    the train_window view into the stage's forest (K3), the table
    lifecycle over 400 hourly batches with zone-map pruning and a
    scrubbed flipped byte, and the fuzz harness on the card.  No fallback
    route may be taken: the counters of view errors, rebuilds, full
    recomputes and failed prunes stay at 0.  → the view fit's K3
    launches and the K3 record at its shape."""
    import numpy as np

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.obs.registry import (
        global_registry,
    )

    watched = ("sql.view.serve_errors", "sql.view.rebuilds", "sql.view.full_recompute",
               "table.prune_errors")
    counters0 = {k: global_registry().counters.get(k, 0) for k in watched}
    cols = hospital_events(VIEW_N, whole_day=True)
    order = np.argsort(cols["event_time"], kind="stable")
    cols = {k: v[order] for k, v in cols.items()}
    n = len(order)
    edges = np.linspace(0, n, VIEW_BATCHES + 1).astype(int)
    bounds = list(zip(edges[:-1].tolist(), edges[1:].tolist()))
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["CMLHN_FLIGHT_DIR"] = os.path.join(tmp, "flight")
        drops = os.path.join(tmp, "drops")
        os.makedirs(drops)
        for b, (lo, hi) in enumerate(bounds):
            write_events_csv(os.path.join(drops, f"drop-{b:03d}.csv"), cols, lo, hi)
        del cols
        lap("history drops")
        views = views_part(port, os.path.join(tmp, "views"), drops, bounds)
        lap("history views")
        kill_part(port, os.path.join(tmp, "kill"), drops)
        lap("history kill")
        k3 = window_part(port, H, views["window"], views["snapshot"])
        del views
        lap("history window")
        history_part(port, tmp)
        lap("history lifecycle")
        os.environ.pop("CMLHN_FLIGHT_DIR")
    moved = {k: global_registry().counters.get(k, 0) - v for k, v in counters0.items()}
    check(not any(moved.values()), f"a fallback route was taken: {moved}")
    fuzz_part(port)
    lap("history fuzz")
    say(f"history_phase counters (must all be 0): {json.dumps(moved)}")
    return k3


# ------------------------------------------------------------- slice 7a
FRONT_CLIENTS = 16                        # the in-distribution traffic's client threads
FRONT_REQUESTS = 1_000                    # requests of 1-256 rows each (4,000 until slice 7b,
                                          # 2,000 until 7c)
FRONT_PLANT = 0.01                        # share of rows with a planted NaN, ±inf or far value
FRONT_WINDOW, FRONT_TRIP_AFTER = 4096, 3  # the drift monitor
FRONT_DRIFT_REQUESTS = 2_000              # one feature shifted by FRONT_SHIFT_SIGMA stds
FRONT_DRIFT_COL, FRONT_SHIFT_SIGMA = 2, 2.0
FRONT_REFIT_N = 2_000_000                 # the hot swap's refit on drifted rows
FRONT_SWAP_THREADS, FRONT_SWAP_POST = 8, 200   # load threads; requests each after the commit
FRONT_SWAP_MAX_ROWS = 16                  # rows a swap-load request (1-16)
FRONT_FAILURES, FRONT_RECOVERY_S = 3, 0.5  # the breaker's threshold and recovery
FRONT_DROPS, FRONT_DROP_ROWS = 40, 12_500  # the ingest firewall: 500,000 hospital rows (2M
                                           # until 7b, 1M until 7c)
FRONT_BAD = 0.001                         # share of planted bad rows
FRONT_KILL_BATCH = 19                     # the stream killed after this batch's read
FRONT_KNOB_REQUESTS = 500                 # requests a max_wait_ms value, 16 clients
FRONT_SEED = 31
FRONT_ALIASES = {"admits": "admission_count", "los": "length_of_stay"}
FRONT_RENAMED = ("event_time", "hospital_id", "admits", "current_occupancy", "emergency_visits",
                 "seasonality_index", "los")
#: the planted bad rows: kind → (the edit, its reject reasons)
FRONT_PLANTS = {
    "malformed": ("admission_count", "x#!corrupt", ("parse:admission_count",)),
    "ragged": (None, None, ("field_count",)),
    "out_of_range": ("admission_count", "20000", ("range:admission_count",)),
    "negative_los": ("length_of_stay", "-1.0", ("range:length_of_stay",)),
    "null_id": ("hospital_id", "", ("null:hospital_id",)),
    "inf_season": ("seasonality_index", "inf",
                   ("range:seasonality_index", "non_finite:seasonality_index")),
}


class LaunchLedger:
    """The K1 / K2 launches of a phase's main path: everything since the
    ledger opened, less what ran inside ``aside`` (references and
    kernel-against-plain comparisons)."""

    def __init__(self, L):
        self.L = L
        self.start = L.launch_counts()
        self.excluded = {k: 0 for k in self.start}

    @contextlib.contextmanager
    def aside(self):
        before = self.L.launch_counts()
        try:
            yield
        finally:
            after = self.L.launch_counts()
            for k in self.excluded:
                self.excluded[k] += after[k] - before[k]

    def main_path(self) -> dict:
        now = self.L.launch_counts()
        return {k: now[k] - self.start[k] - self.excluded[k] for k in now}


def count_runs(sm) -> list:
    """Count the device calls of one ServingModel (each is one K2 launch):
    its ``_run`` wrapped on the instance.  → the one-element counter."""
    box, run = [0], sm._run

    def counted(x):
        box[0] += 1
        return run(x)

    sm._run = counted
    return box


def front_requests(rng, n: int, lo: int, hi: int) -> list:
    """``n`` request sizes in ``lo..hi`` → (start, stop) slices of one
    concatenated row block."""
    import numpy as np

    sizes = rng.integers(lo, hi + 1, n)
    ends = np.cumsum(sizes)
    return list(zip((ends - sizes).tolist(), ends.tolist()))


def run_clients(n_threads: int, jobs: list, send) -> tuple[dict, float]:
    """``send(j)`` for every job index, from ``n_threads`` threads taking
    jobs round-robin.  → ({j: (result, seconds)}, wall seconds)."""
    answers = {}

    def client(ids):
        for j in ids:
            t0 = time.perf_counter()
            r = send(j)
            answers[j] = (r, time.perf_counter() - t0)

    threads = [threading.Thread(target=client, args=(range(t, len(jobs), n_threads),))
               for t in range(n_threads)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    check(not any(th.is_alive() for th in threads), "serving clients did not finish")
    return answers, time.perf_counter() - t0


def predict_rows(model, rows) -> "np.ndarray":
    import numpy as np
    import torch

    return model.predict(torch.from_numpy(np.ascontiguousarray(rows, dtype=np.float32))
                         .to(DEV)).cpu().numpy()


def front_profiled_artifact(port, L, model, x_host, tmp: str, ledger):
    """Step 1: the training profile over the 10M rows, the model saved
    with it, and the k=16 fallback fitted on the card on the same rows
    (K1, K2 held to their plain versions at its shapes).  → (path,
    profile, fallback ServingModel)."""
    import numpy as np
    import torch

    names = [f"f{j}" for j in range(x_host.shape[1])]
    t0 = time.perf_counter()
    profile = port.DataProfile.from_matrix(x_host, names)
    prof_s = time.perf_counter() - t0
    check(profile.total_rows == len(x_host), "the profile missed rows")
    path = os.path.join(tmp, "primary")
    t0 = time.perf_counter()
    model.save(path)
    port.io.attach_data_profile(path, profile.to_dict())
    save_s = time.perf_counter() - t0
    check(port.io.load_data_profile(path) == profile.to_dict(), "the saved profile differs")
    t0 = time.perf_counter()
    ds = port.device_dataset(x_host, device=DEV)
    fb_model = port.KMeans(k=16, seed=SEED, max_iter=MAX_ITER).fit(ds)
    fb = port.serve.ServingModel(fb_model, buckets=BUCKETS, device=DEV).warmup()
    fb_s = time.perf_counter() - t0
    with ledger.aside():
        # K1 and K2 at the fallback's shapes: its fit, and a batch it serves
        cen = torch.from_numpy(np.asarray(fb_model.cluster_centers, np.float32)).to(DEV)
        valid = torch.ones(len(cen), device=DEV)
        k1_err, k2_err, cost_rel, flips = compare(L, ds.x, ds.w, cen, valid,
                                                  f"fallback n={len(x_host)} k=16")
        batch_err, _ = compare_k2(L, ds.x[:BUCKETS[-1]].contiguous(), cen, valid,
                                  f"fallback batch n={BUCKETS[-1]} k=16")
    del ds
    say(f"front door: DataProfile.from_matrix over {len(x_host)} x {len(names)} rows "
        f"{prof_s:.2f} s ({len(x_host) / prof_s:.4g} rows/s); saved with its profile "
        f"{save_s:.2f} s; fallback KMeans(k=16) fitted on the card {fb_s:.2f} s "
        f"(n_iter {fb_model.n_iter}); K1 / K2 at its shape == their plain versions "
        f"(max_abs_err {k1_err:.3g} / {k2_err:.3g}, cost rel err {cost_rel:.3g}, {flips} "
        f"near-tie flips), K2 on a {BUCKETS[-1]}-row batch (max_abs_err {batch_err:.3g})")
    return path, profile, fb


def front_in_distribution(port, L, srv, model, x_host, profile, prim, ledger) -> int:
    """Step 2: 16 clients, 1,000 requests to the impute name and the same
    to the reject name; 1 % of the rows carry a planted NaN, ±inf or a
    value 10 spans out.  → requests sent."""
    import numpy as np
    import torch

    rng = np.random.default_rng(FRONT_SEED)
    jobs = front_requests(rng, FRONT_REQUESTS, 1, 256)
    n = jobs[-1][1]
    rows = x_host[rng.integers(0, len(x_host), n)].copy()
    bad = np.flatnonzero(rng.random(n) < FRONT_PLANT)
    cols = rng.integers(0, rows.shape[1], bad.size)
    kinds = rng.integers(0, 4, bad.size)
    span = np.array([profile.sketches[k].max - profile.sketches[k].min for k in profile.names])
    far = np.array([profile.sketches[k].max for k in profile.names]) + 10 * span
    rows[bad, cols] = np.where(kinds == 0, np.nan, np.where(
        kinds == 1, np.inf, np.where(kinds == 2, -np.inf, far[cols]))).astype(np.float32)
    guard = port.InputGuard(profile, policy="impute")
    fixed, n_bad, _ = guard.inspect(rows)
    check(n_bad == bad.size, f"the guard flags {n_bad} cells of {bad.size} planted")
    with ledger.aside():
        want = predict_rows(model, fixed)
    planted = np.zeros(n, dtype=bool)
    planted[bad] = True
    jobs_bad = [bool(planted[a:b].any()) for a, b in jobs]
    c0 = dict(srv.metrics.registry.counters)
    rej = count_runs(srv.registry.get("primary_reject"))
    runs0, k2_0 = prim[0], L.launch_counts()["fused_assign"]

    def send(j):
        a, b = jobs[j]
        return srv.predict("primary", rows[a:b]), srv.predict("primary_reject", rows[a:b])

    answers, wall = run_clients(FRONT_CLIENTS, jobs, send)
    lat = []
    for j, (a, b) in enumerate(jobs):
        (r, r2), sec = answers[j]
        lat.append(sec)
        check(r.status == "ok" and np.array_equal(r.value, want[a:b]),
              f"request {j}: {r.status}, or labels differ from predict on the imputed rows")
        if jobs_bad[j]:
            check(r2.status == "invalid_input", f"reject name: request {j} answered {r2.status}")
        else:
            check(r2.status == "ok" and np.array_equal(r2.value, want[a:b]),
                  f"reject name: request {j} answered {r2.status}")
    c1 = srv.metrics.registry.counters
    imputed = c1.get("serve.inputs_imputed", 0) - c0.get("serve.inputs_imputed", 0)
    refused = c1.get("serve.inputs_rejected", 0) - c0.get("serve.inputs_rejected", 0)
    check(imputed == bad.size, f"serve.inputs_imputed {imputed}, planted {bad.size}")
    check(refused == sum(jobs_bad), f"serve.inputs_rejected {refused}, planted {sum(jobs_bad)}")
    check(c1.get("serve.drift_trips", 0) == 0, "in-distribution traffic tripped the breaker")
    check(srv.health()["status"] == "ok", "the server is not ok after in-distribution traffic")
    k2 = L.launch_counts()["fused_assign"] - k2_0
    check(prim[0] > runs0 and k2 == prim[0] - runs0 + rej[0],
          f"K2 +{k2} against {prim[0] - runs0} + {rej[0]} served batches")
    # a served batch against K2's plain version
    j = int(np.argmax([b - a for a, b in jobs]))
    a, b = jobs[j]
    bucket = port.serve.bucket_for(b - a, BUCKETS)
    batch = port.serve.pad_to_bucket(np.ascontiguousarray(fixed[a:b], dtype=np.float32), bucket)
    with ledger.aside():
        xt = torch.from_numpy(batch).to(DEV)
        centers = torch.from_numpy(np.asarray(model.cluster_centers, np.float32)).to(DEV)
        err, flips = compare_k2(L, xt, centers, torch.ones(len(centers), device=DEV),
                                f"served batch n={bucket}")
    lat_ms = np.asarray(lat) * 1e3
    say(f"front door, in-distribution: {FRONT_REQUESTS} requests x 2 names from "
        f"{FRONT_CLIENTS} clients ({n} rows, {bad.size} planted cells in "
        f"{sum(jobs_bad)} requests): every answer == predict on the guard's imputed rows; "
        f"the reject name refused exactly the {sum(jobs_bad)} planted requests; "
        f"serve.inputs_imputed {imputed}; K2 +{k2}, one a served batch ({prim[0] - runs0} "
        f"primary, {rej[0]} reject-name); "
        f"client latency (both names) p50 {np.percentile(lat_ms, 50):.3f} ms, "
        f"p99 {np.percentile(lat_ms, 99):.3f} ms; {2 * FRONT_REQUESTS / wall:.1f} requests/s, "
        f"{2 * n / wall:.4g} rows/s over {wall:.2f} s; served batch n={bucket} == K2's plain "
        f"version (max_abs_err {err:.3g}, {flips.numel()} near-tie flips)")
    return 2 * FRONT_REQUESTS


def window_fill(srv, name: str) -> int:
    """Rows in the drift monitor's open window (its window-size bookkeeping)."""
    return srv._monitors[name]._window_seen


def close_window(srv, name: str, rows, rng) -> int:
    """Requests of at most 256 rows from ``rows`` that close the open window
    exactly.  → requests sent."""
    need, sent = FRONT_WINDOW - window_fill(srv, name), 0
    while need > 0:
        m = min(need, 256)
        srv.predict(name, rows[rng.integers(0, len(rows), m)])
        need, sent = need - m, sent + 1
    check(window_fill(srv, name) == 0, "the drift window did not close at its size")
    return sent


def front_drift(port, L, srv, model, x_host, fb, prim, fbr, shift, ledger) -> int:
    """Step 3: 2,000 requests, one at a time, with one feature shifted by 2
    training stds.  The breaker opens at the request that closes the
    ``trip_after``-th hot window, counted from the window sizes; every
    answer from there on is the fallback's, with no primary K2 launch.
    A lone client has no followers to wait for, so the step serves at
    ``max_wait_s = 0`` (the batcher's worker reads the attribute each
    batch, as ``tune.LiveRetuner`` applies it) and restores the linger
    after.  → requests sent."""
    import numpy as np

    batcher = srv._batcher("primary")
    linger, batcher.max_wait_s = batcher.max_wait_s, 0.0
    try:
        return front_drift_one_client(port, L, srv, model, x_host, fb, prim, fbr, shift,
                                      ledger)
    finally:
        batcher.max_wait_s = linger


def front_drift_one_client(port, L, srv, model, x_host, fb, prim, fbr, shift, ledger) -> int:
    import numpy as np

    rng = np.random.default_rng(FRONT_SEED + 1)
    sent = close_window(srv, "primary", x_host, rng)    # drift starts at a window boundary
    snap0 = srv._monitors["primary"].snapshot()
    check(snap0["hot_windows"] == 0, f"hot windows before the drift: {snap0}")
    jobs = front_requests(rng, FRONT_DRIFT_REQUESTS, 1, 256)
    rows = x_host[rng.integers(0, len(x_host), jobs[-1][1])] + shift
    with ledger.aside():
        want, want_fb = predict_rows(model, rows), predict_rows(fb.model, rows)
    # the window closes, from the sizes alone: the trip_after-th is the trip
    seen, closes = 0, []
    for j, (a, b) in enumerate(jobs):
        seen += b - a
        if seen >= FRONT_WINDOW:
            closes.append(j)
            seen = 0
    trip_at = closes[FRONT_TRIP_AFTER - 1]
    imputed0 = srv.metrics.registry.counters.get("serve.inputs_imputed", 0)
    k2_0 = L.launch_counts()["fused_assign"]
    for j, (a, b) in enumerate(jobs):
        if j == trip_at:
            prim_runs, fb_runs, k2_at = prim[0], fbr[0], L.launch_counts()["fused_assign"]
        r = srv.predict("primary", rows[a:b])
        if j < trip_at:
            check(r.status == "ok" and np.array_equal(r.value, want[a:b]),
                  f"drift request {j} (before the trip at {trip_at}): {r.status}")
        else:
            check(r.status == "unavailable" and r.degraded
                  and np.array_equal(r.value, want_fb[a:b]),
                  f"drift request {j} (trip at {trip_at}): {r.status}, not the fallback's")
    snap = srv._monitors["primary"].snapshot()
    check(snap["windows"] - snap0["windows"] == len(closes), f"windows {snap} vs {len(closes)}")
    check(srv.metrics.registry.counters.get("serve.inputs_imputed", 0) == imputed0,
          "the shifted rows were imputed")
    check(prim[0] == prim_runs, f"the primary ran {prim[0] - prim_runs} batches while open")
    k2_open = L.launch_counts()["fused_assign"] - k2_at
    check(k2_open == fbr[0] - fb_runs, f"K2 +{k2_open} while open, fallback batches "
          f"{fbr[0] - fb_runs}: the primary launched")
    h = srv.health()
    check(h["status"] == "degraded" and h["breakers"]["primary"]["state"] == "open",
          f"health after the drift: {h['status']}, {h['breakers']['primary']}")
    sent += close_window(srv, "primary", rows, rng)     # the swap starts at a boundary
    say(f"front door, drift: {FRONT_DRIFT_REQUESTS} requests with f{FRONT_DRIFT_COL} shifted "
        f"{FRONT_SHIFT_SIGMA} stds; windows of {FRONT_WINDOW} rows closed at requests "
        f"{closes[:FRONT_TRIP_AFTER + 1]}...; the breaker opened at request {trip_at}, the "
        f"{FRONT_TRIP_AFTER}rd hot window (max PSI {snap['max_psi']}); after it every answer "
        f"was the k=16 fallback's, primary K2 +0, fallback K2 +{k2_open}; "
        f"health {h['status']}; K2 +{L.launch_counts()['fused_assign'] - k2_0} in all")
    return sent + FRONT_DRIFT_REQUESTS


def front_swap(port, L, srv, model, x_host, fb, shift, ledger) -> tuple:
    """Step 4: KMeans k=256 refit on 2M drifted rows, warm-started from the
    serving model's centers (K1, held to its plain version at that
    shape), then ``prepare_swap`` while 8 threads submit and
    ``commit_swap``.  → (new model, the refit's K1 shape record,
    requests sent)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(FRONT_SEED + 2)
    drifted = x_host[rng.integers(0, len(x_host), FRONT_REFIT_N)] + shift
    t0 = time.perf_counter()
    ds = port.device_dataset(drifted, device=DEV)
    on_dev = ds.x
    k1_0 = L.launch_counts()["fused_lloyd_stats"]
    new = port.KMeans(k=K, seed=SEED, max_iter=MAX_ITER,
                      warm_start_centers=np.asarray(model.cluster_centers, np.float32)).fit(ds)
    sync()
    refit_s = time.perf_counter() - t0
    k1 = L.launch_counts()["fused_lloyd_stats"] - k1_0
    check(k1 == new.n_iter + 1, f"the refit launched K1 {k1} times over {new.n_iter} steps")
    t0 = time.perf_counter()
    profile = port.DataProfile.from_matrix(drifted, [f"f{j}" for j in range(drifted.shape[1])])
    prof_s = time.perf_counter() - t0
    with ledger.aside():
        centers = torch.from_numpy(np.asarray(new.cluster_centers, np.float32)).to(DEV)
        w = torch.ones(len(on_dev), device=DEV)
        c_valid = torch.ones(K, device=DEV)
        tag = f"refit n={FRONT_REFIT_N} d={D} k={K}"
        k1_err, k2_err, cost_rel, flips = compare(L, on_dev, w, centers, c_valid, tag)
        c_sq, x_sq = (centers * centers).sum(1), (on_dev * on_dev).sum(1)

        def lib_stats():
            mn, arg = library_assign(on_dev, centers, x_sq, c_sq)
            arg = arg.to(torch.int64)
            sums = torch.zeros(K, D, device=DEV).index_add_(0, arg, on_dev * w[:, None])
            return sums, torch.zeros(K, device=DEV).index_add_(0, arg, w), (mn * w).sum()

        k1t = {"ms": gpu_ms(lambda: L.fused_lloyd_stats(on_dev, w, centers, c_valid), 20),
             "plain_ms": gpu_ms(lambda: L.fused_lloyd_stats_plain(on_dev, w, centers, c_valid),
                                4),
             "library_ms": gpu_ms(lib_stats, 4)}
    k1_bound, by = bound_ms(FRONT_REFIT_N, D, K, stats=True)
    shape = {"n": FRONT_REFIT_N, "d": D, "k": K, "max_abs_err": k1_err, **k1t,
             "bound_ms": k1_bound, "bound_by": by}
    del ds, on_dev, w, x_sq
    # the load: 8 threads of 1-16 drifted rows; before the commit they may
    # observe fewer rows than close a window (no trip can land mid-swap)
    jobs = [front_requests(rng, 4 * FRONT_SWAP_POST, 1, FRONT_SWAP_MAX_ROWS)
            for _ in range(FRONT_SWAP_THREADS)]
    rows = [drifted[rng.integers(0, len(drifted), j[-1][1])] for j in jobs]
    with ledger.aside():
        old_want = [predict_rows(model, r) for r in rows]
        new_want = [predict_rows(new, r) for r in rows]
    deadline = time.perf_counter() + FRONT_RECOVERY_S + 5
    while srv.stats()["models"]["primary"]["breaker"] != "half_open" \
            and time.perf_counter() < deadline:
        time.sleep(0.01)
    check(srv.stats()["models"]["primary"]["breaker"] == "half_open",
          "the breaker is not half open before the swap")
    budget = [FRONT_WINDOW - 1 - window_fill(srv, "primary")]
    lock, committed = threading.Lock(), threading.Event()
    answers = [[] for _ in jobs]        # (after the commit returned, answer) per request

    def load(t):
        post = 0
        for j, (a, b) in enumerate(jobs[t]):
            after = committed.is_set()
            if not after:
                with lock:
                    ok = budget[0] >= b - a
                    if ok:
                        budget[0] -= b - a
                if not ok:
                    committed.wait(60)
                    after = True
            r = srv.predict("primary", rows[t][a:b])
            answers[t].append((j, after, r))
            post += after
            if post >= FRONT_SWAP_POST:
                return

    threads = [threading.Thread(target=load, args=(t,)) for t in range(FRONT_SWAP_THREADS)]
    for th in threads:
        th.start()
    deadline = time.perf_counter() + 30
    while sum(len(a) for a in answers) < 64 and budget[0] >= FRONT_SWAP_MAX_ROWS \
            and time.perf_counter() < deadline:
        time.sleep(0.001)
    pre = sum(len(a) for a in answers)
    t0 = time.perf_counter()
    prepared = srv.prepare_swap("primary", new, data_profile=profile.to_dict())
    prep_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    srv.commit_swap(prepared)
    commit_ms = (time.perf_counter() - t0) * 1e3
    committed.set()
    windows_at_commit = srv._monitors["primary"].snapshot()["windows"]
    for th in threads:
        th.join(120)
    check(not any(th.is_alive() for th in threads), "the swap's load threads did not finish")
    n_old = n_new = n_req = 0
    for t, got in enumerate(answers):
        for j, after, r in got:
            a, b = jobs[t][j]
            n_req += 1
            check(r.status == "ok", f"swap load request {t}/{j} answered {r.status} "
                  f"({r.detail})")
            is_new = np.array_equal(r.value, new_want[t][a:b])
            is_old = np.array_equal(r.value, old_want[t][a:b])
            check(is_new or (is_old and not after),
                  f"swap load request {t}/{j} (after the commit: {after}) got neither model's")
            n_new += is_new and not is_old
            n_old += is_old and not is_new
    check(n_old > 0 and n_new > 0, f"{n_old} old-model and {n_new} new-model answers")
    mon = srv._monitors["primary"].snapshot()
    h = srv.health()
    check(h["status"] == "ok" and h["breakers"]["primary"]["state"] == "closed",
          f"health after the swap: {h['status']} {h['breakers']['primary']}")
    post_windows = mon["windows"] - windows_at_commit
    check(post_windows >= 1 and mon["hot_windows"] == 0 and not mon["drifting"]
          and mon["rebases"] == 1, f"post-swap drift windows: {mon}")
    say(f"front door, hot swap: refit KMeans(k={K}) on {FRONT_REFIT_N} drifted rows from "
        f"the serving model's centers "
        f"{refit_s:.2f} s "
        f"(n_iter {new.n_iter}, K1 +{k1}; K1 at the refit shape {k1t['ms']:.4f} ms, plain "
        f"{k1t['plain_ms']:.4f}, library {k1t['library_ms']:.4f}, bound {k1_bound:.4f} by {by}, "
        f"max_abs_err {k1_err:.3g}, cost rel err {cost_rel:.3g}, {flips} near-tie flips); "
        f"its profile {prof_s:.2f} s; prepare_swap {prep_ms:.2f} ms after {pre} answers, "
        f"commit_swap {commit_ms:.3f} ms, under {FRONT_SWAP_THREADS} threads: {n_req} requests "
        f"all ok, {n_old} old-model answers, {n_new} new-model answers, none rejected or "
        f"lost; after: breaker closed, {post_windows} post-swap windows, max PSI "
        f"{mon['max_psi']} (noise floor {mon['noise_floor']}), health {h['status']}")
    return new, shape, n_req


def front_failure(port, srv, x_host, shift) -> tuple:
    """Step 5: the primary raises for a planted run of batches; the breaker
    opens after the threshold, goes half open after the recovery time and
    closes on the next success; the transitions equal ``metrics_text()``'s
    counter and the state gauge.  → (requests sent, the parsed text)."""
    import numpy as np

    rng = np.random.default_rng(FRONT_SEED + 3)
    sm = srv.registry.get("primary")
    calls, planted = [0], range(2, 2 + FRONT_FAILURES)
    orig = sm.predict_bucketed

    def flaky(x):
        calls[0] += 1
        if calls[0] - 1 in planted:
            raise RuntimeError("planted primary failure")
        return orig(x)

    sm.predict_bucketed = flaky
    c = srv.metrics.registry.counters
    moves0 = {s: c.get(f"serve.breaker.to_{s}", 0) for s in ("open", "half_open", "closed")}

    def gauge() -> float:
        return srv.obs_fragment()["gauges"]['serve.breaker_state{model="primary"}']

    statuses, seq = [], []
    for j in range(2 + FRONT_FAILURES + 3 + 3):
        if j == 2 + FRONT_FAILURES + 3:
            check(gauge() == 2.0, f"state gauge {gauge()} while open")
            time.sleep(FRONT_RECOVERY_S + 0.05)
            seq.append(srv.stats()["models"]["primary"]["breaker"])
            check(gauge() == 1.0, f"state gauge {gauge()} past the recovery time")
        r = srv.predict("primary", x_host[rng.integers(0, len(x_host), 8)] + shift)
        statuses.append(r.status)
        seq.append(srv.stats()["models"]["primary"]["breaker"])
    sm.predict_bucketed = orig
    want = (["ok"] * 2 + ["unavailable"] * FRONT_FAILURES + ["unavailable"] * 3 + ["ok"] * 3)
    check(statuses == want, f"statuses {statuses}")
    moves = {s: c.get(f"serve.breaker.to_{s}", 0) - v for s, v in moves0.items()}
    check(moves == {"open": 1, "half_open": 1, "closed": 1}, f"transitions {moves}")
    check(seq[FRONT_FAILURES + 1] == "open" and seq[-1] == "closed" and gauge() == 0.0,
          f"breaker states {seq}")
    text = srv.metrics_text()
    metric = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, val = line.rpartition(" ")
            metric[key] = float(val)
    opened = srv.health()["breakers"]["primary"]["opened_count"]
    check(metric['cmlhn_serve_breaker_opened_total{model="primary"}'] == opened
          == c.get("serve.breaker.to_open", 0), f"opened {opened} vs the text and counters")
    check(metric['cmlhn_serve_breaker_state{model="primary"}'] == 0.0, "state gauge not closed")
    say(f"front door, failing primary: {FRONT_FAILURES} planted failures opened the breaker "
        f"(states {seq}); half open after {FRONT_RECOVERY_S} s, closed on the next success; "
        f"transitions {moves} == metrics_text's breaker counters and state gauge; "
        f"opened {opened} times in all")
    return len(statuses), metric


def write_drop(path: str, cols: dict, plants: dict, renamed: bool) -> dict:
    """One drop's CSV text written to ``path`` (a worker process's job).
    → its planted rows' raw lines."""
    text, raw = firewall_drop_text(cols, 0, len(cols["hospital_id"]), plants, renamed)
    with open(path, "w") as f:
        f.write(text)
    return raw


def firewall_drop_text(cols, lo: int, hi: int, plants: dict, renamed: bool) -> tuple:
    """Rows ``lo:hi`` as CSV text with the planted rows edited, in the
    renamed and reordered header when ``renamed``.  → (text, {row: raw
    line})."""
    import numpy as np

    times = np.datetime_as_string(cols["event_time"][lo:hi].astype("datetime64[ns]"), unit="ns")
    fields = {
        "hospital_id": cols["hospital_id"][lo:hi].tolist(),
        "event_time": [t.replace("T", " ") for t in times.tolist()],
        **{c: cols[c][lo:hi].astype(str).tolist()
           for c in ("admission_count", "current_occupancy", "emergency_visits")},
        **{c: list(map(repr, cols[c][lo:hi].tolist()))
           for c in ("seasonality_index", "length_of_stay")},
    }
    order = [FRONT_ALIASES.get(c, c) for c in FRONT_RENAMED] if renamed else list(EVENT_COLS)
    head = FRONT_RENAMED if renamed else EVENT_COLS
    lines = [",".join(row) for row in zip(*(fields[c] for c in order))]
    raw = {}
    for i, kind in plants.items():
        col, value, _ = FRONT_PLANTS[kind]
        parts = [fields[c][i] for c in order]
        if kind == "ragged":
            parts = parts[:5]
        else:
            parts[order.index(col)] = value
        lines[i] = raw[i] = ",".join(parts)
    return ",".join(head) + "\n" + "".join(line + "\n" for line in lines), raw


def front_firewall(port, tmp: str, card: str) -> dict:
    """Step 6: 40 drops of 12,500 hospital rows through a firewalled stream,
    0.1 % planted bad rows and one renamed, reordered header; killed after
    a batch's read and resumed.  → the stream's metrics registry."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults

    t_all = time.perf_counter()
    cols = hospital_events(FRONT_DROPS * FRONT_DROP_ROWS // 5, seed=FRONT_SEED, whole_day=True)
    order = np.argsort(cols["event_time"], kind="stable")
    cols = {k: v[order] for k, v in cols.items()}
    n = len(order)
    rng = np.random.default_rng(FRONT_SEED + 4)
    bad = np.sort(rng.choice(n, int(n * FRONT_BAD), replace=False))
    kinds = list(FRONT_PLANTS)
    bad_kind = {int(i): kinds[k] for i, k in zip(bad, rng.integers(0, len(kinds), bad.size))}
    renamed_drop = FRONT_DROPS // 2
    incoming = os.path.join(tmp, "incoming")
    os.makedirs(incoming)
    want_rejects = {}                                 # batch → (histogram, raw lines)
    t0 = time.perf_counter()
    drops = []
    for b in range(FRONT_DROPS):
        lo, hi = b * FRONT_DROP_ROWS, (b + 1) * FRONT_DROP_ROWS
        drops.append((os.path.join(incoming, f"drop-{b:03d}.csv"),
                      {k: v[lo:hi] for k, v in cols.items()},
                      {i - lo: k for i, k in bad_kind.items() if lo <= i < hi},
                      b == renamed_drop))
    # the text is Python string formatting: a process a core writes it
    # (spawned, not forked, since this process holds the card and threads)
    with ProcessPoolExecutor(min(FRONT_DROPS, os.cpu_count() or 1),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        raws = list(pool.map(write_drop, *zip(*drops)))
    # the source takes files in (mtime, name) order: the drops arrive in turn
    stamp = time.time_ns()
    for b, (path, _, _, _) in enumerate(drops):
        os.utime(path, ns=(stamp + b * 1_000_000,) * 2)
    for b, ((_, _, plants, _), raw) in enumerate(zip(drops, raws)):
        hist = {}
        for k in plants.values():
            for reason in FRONT_PLANTS[k][2]:
                hist[reason] = hist.get(reason, 0) + 1
        want_rejects[b] = (hist, {raw[i] for i, k in plants.items()
                                  if k in ("malformed", "ragged")}, len(plants))
    write_s = time.perf_counter() - t0
    keep = np.ones(n, dtype=bool)
    keep[bad] = False
    # a parsed integer column stays float64 (NaN-capable), as every CSV
    # engine of both packages keeps it
    good = port.Table.from_dict({k: v[keep].astype(np.float64) if v.dtype.kind in "iu"
                                 else v[keep] for k, v in cols.items()},
                                port.hospital_event_schema())
    names = ("admission_count", "current_occupancy", "emergency_visits", "seasonality_index")
    reference = port.DataProfile.from_matrix(good.numeric_matrix(list(names)), names)
    metrics = port.utils.MetricsRegistry()
    firewalls = []

    def stream():
        fw = port.DataFirewall(port.hospital_event_schema(), port.hospital_constraints(),
                               aliases=FRONT_ALIASES, monitor=port.DriftMonitor(reference))
        firewalls.append(fw)
        return port.StreamExecution(
            source=port.FileStreamSource(incoming, port.hospital_event_schema(),
                                         max_files_per_batch=1),
            sink=port.UnboundedTable(os.path.join(tmp, "table"), port.hospital_event_schema()),
            checkpoint=port.StreamCheckpoint(os.path.join(tmp, "ckpt")),
            firewall=fw, metrics=metrics, device=DEV)

    t0 = time.perf_counter()
    plan = faults.FaultPlan().crash("stream.after_read", after=FRONT_KILL_BATCH)
    ex = stream()
    with faults.active(plan):
        try:
            while ex.run_once() is not None:
                pass
            fail("the stream was not killed")
        except faults.InjectedCrash:
            pass
    check(len(ex.history) == FRONT_KILL_BATCH, f"killed after {len(ex.history)} batches")
    ex = stream()
    while ex.run_once() is not None:
        pass
    stream_s = time.perf_counter() - t0
    got = ex.sink.read()
    check(len(got) == keep.sum(), f"{len(got)} rows committed, {int(keep.sum())} planted good")
    c = first_unequal_column(got.select(list(EVENT_COLS)), good)
    check(c is None, f"the committed rows differ from the planted good rows in {c}")
    recs = {e["batch_id"]: e for e in ex.checkpoint.quarantined_rows()}
    check(sorted(recs) == list(range(FRONT_DROPS)), f"row quarantine of batches {sorted(recs)}")
    for b, (hist, raws, n_bad) in want_rejects.items():
        e = recs[b]
        got_raw = {r["raw"] for r in e["rejects"] if "raw" in r}
        check(e["n_rejected"] == n_bad and e["reason_histogram"] == hist and got_raw == raws,
              f"batch {b}: quarantine {e['n_rejected']} {e['reason_histogram']} vs the plan "
              f"{n_bad} {hist}")
        events = [(d["kind"], d["target"], d["source"]) for d in e["drift_events"]]
        want_events = ([("column_renamed", "admission_count", "admits"),
                        ("column_renamed", "length_of_stay", "los"),
                        ("column_reordered", None, None)] if b == renamed_drop else [])
        check(events == want_events, f"batch {b}: drift events {events}")
    total = {}
    for hist, _, _ in want_rejects.values():
        for k, v in hist.items():
            total[k] = total.get(k, 0) + v
    check(ex.checkpoint.row_reason_histogram() == total
          and ex.checkpoint.quarantined_row_count() == bad.size,
          f"reject histogram {ex.checkpoint.row_reason_histogram()} vs the plan {total}")
    mc = metrics.counters
    check(mc.get("stream.rows_rejected") == bad.size and mc.get("stream.drift_events") == 3
          and mc.get("stream.batches") == FRONT_DROPS, f"stream counters {mc}")
    health = port.serve.InferenceServer(device=DEV, ingest_metrics=metrics).health()
    check(health["quarantined_rows"] == bad.size and health["drift_events"] == 3,
          f"health() quarantined_rows {health['quarantined_rows']}")
    parse = sum(f.stage_seconds["parse"] for f in firewalls)
    validate = sum(f.stage_seconds["validate"] for f in firewalls)
    rows_in = sum(f.rows_in for f in firewalls)
    say(f"front door, ingest firewall: {FRONT_DROPS} drops x {FRONT_DROP_ROWS} rows ({n}), "
        f"{bad.size} planted bad rows ({total}), drop {renamed_drop} renamed and reordered; "
        f"killed after batch {FRONT_KILL_BATCH}'s read and resumed: the committed rows == the "
        f"planted good rows, quarantine and histogram == the plan, 3 drift events; health() "
        f"quarantined_rows {health['quarantined_rows']}; firewall parse {parse:.2f} s, "
        f"validate {validate:.2f} s, {rows_in / (parse + validate):.4g} rows/s "
        f"({rows_in} rows in, the replayed batch twice); stream {stream_s:.2f} s "
        f"({n / stream_s:.4g} rows/s), drops written {write_s:.2f} s; "
        f"step {time.perf_counter() - t_all:.2f} s")
    return metrics


def front_knobs(port, model, x_host, tmp: str, card: str, ledger) -> None:
    """Step 7: ``serve.microbatch.max_wait_ms`` over its domain on served
    traffic (16 clients, 500 requests a value) into a TrialStore; a
    Selector then moves a new server's ``max_wait_s`` to the best value,
    and inside ``ab_fence()`` leaves the declared default."""
    import numpy as np

    name = "serve.microbatch.max_wait_ms"
    knob = port.tune.REGISTRY.get(name)
    rng = np.random.default_rng(FRONT_SEED + 5)
    jobs = front_requests(rng, FRONT_KNOB_REQUESTS, 1, 256)
    rows = x_host[rng.integers(0, len(x_host), jobs[-1][1])]
    with ledger.aside():
        want = predict_rows(model, rows)
    fingerprint = re.sub(r"[^A-Za-z0-9]+", "-", card).strip("-")
    trials, scores = [], {}
    for v in knob.domain:
        with port.serve.InferenceServer(device=DEV, max_wait_s=v / 1e3) as srv:
            srv.add_model("knob", model, buckets=BUCKETS)

            def send(j):
                a, b = jobs[j]
                return srv.predict("knob", rows[a:b])

            answers, wall = run_clients(FRONT_CLIENTS, jobs, send)
            for j, (a, b) in enumerate(jobs):
                r = answers[j][0]
                check(r.ok and np.array_equal(r.value, want[a:b]), f"knob {v}: request {j}")
            st = srv.stats()
        scores[v] = FRONT_KNOB_REQUESTS / wall
        trials.append(port.tune.make_trial(
            knob=name, value=v, score=scores[v], platform="gpu", fingerprint=fingerprint,
            shape_rows=jobs[-1][1] // len(jobs), metric=knob.metric, source="sweep",
            meta={"p50_ms": st["latency_p50_ms"], "p99_ms": st["latency_p99_ms"],
                  "batch_fill": st["batch_fill_ratio"], "card": card}))
    store = port.tune.TrialStore(os.path.join(tmp, "trials.json"))
    check(store.add(trials) == len(trials), "trials merged away")
    best = max(knob.domain, key=lambda v: (scores[v], repr(v)))
    sel = port.tune.Selector(port.tune.TrialStore(store.path), platform="gpu",
                             fingerprint=fingerprint)
    with port.tune.active(sel):
        with port.tune.ab_fence():
            fenced = port.serve.InferenceServer(device=DEV).max_wait_s
            fenced_reason = sel.explain(name)["reason"]
        tuned = port.serve.InferenceServer(device=DEV).max_wait_s
        reason = sel.explain(name)["reason"]
    check(fenced == knob.default / 1e3 and fenced_reason == port.tune.REASON_FROZEN_FENCED,
          f"inside ab_fence: {fenced} ({fenced_reason})")
    check(tuned == best / 1e3 and reason.startswith(port.tune.REASON_TUNED_PREFIX),
          f"the selector chose {tuned} ({reason}), the best measured is {best}")
    check(port.tune.installed() is None and port.serve.InferenceServer(device=DEV).max_wait_s
          == knob.default / 1e3, "the selector stayed installed")
    say(f"front door, knobs ({card}): {name} over {list(knob.domain)} at {FRONT_CLIENTS} "
        f"clients, {FRONT_KNOB_REQUESTS} requests a value: requests/s "
        f"{json.dumps({str(v): round(s, 1) for v, s in scores.items()})}; p99 ms "
        f"{json.dumps({str(t['value']): t['meta']['p99_ms'] for t in trials})}; the selector "
        f"resolves max_wait_s = {tuned} ({reason}); inside ab_fence() {fenced} "
        f"({fenced_reason})")


def front_door_phase(port, L, card: str, model=None, x_host=None) -> dict:
    """Slice 7a at full width: the KMeans k=256 server behind its data
    guards (a profiled artifact, in-distribution traffic with planted bad
    rows, a drift trip, a hot swap under load, a failing primary), the
    ingest firewall over 500,000 hospital rows, and the batcher's deadline
    tuned from the card's traffic.  No fallback hides the card: a primary
    failure, a fallback answer or an open breaker outside the planted
    windows fails the run.  ``model`` / ``x_host`` are the main path's
    KMeans model and its 10M standardized rows (fitted here when not
    given).  → {"launches": the main path's K1 / K2 launches, "shape":
    K1's record at the refit shape}."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    if model is None:
        x_host = make_data(N, D, K)
        model = port.KMeans(k=K, seed=SEED, max_iter=MAX_ITER).fit(
            port.device_dataset(x_host, device=DEV))
    ledger = LaunchLedger(L)
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["CMLHN_FLIGHT_DIR"] = os.path.join(tmp, "flight")
        path, profile, fb = front_profiled_artifact(port, L, model, x_host, tmp, ledger)
        fbr = count_runs(fb)
        lap("front artifact")
        srv = port.serve.InferenceServer(device=DEV, breaker_failure_threshold=FRONT_FAILURES,
                                         breaker_recovery_s=FRONT_RECOVERY_S)
        srv.add_model("primary", path, buckets=BUCKETS, fallback=fb, input_policy="impute",
                      drift_window_rows=FRONT_WINDOW, drift_trip_after=FRONT_TRIP_AFTER)
        srv.add_model("primary_reject", path, buckets=BUCKETS, input_policy="reject",
                      drift_window_rows=FRONT_WINDOW, drift_trip_after=FRONT_TRIP_AFTER)
        check(srv._monitors["primary"].reference.to_dict() == profile.to_dict(),
              "add_model did not load the artifact's profile")
        sent = 0
        with srv:
            prim = count_runs(srv.registry.get("primary"))
            sent += front_in_distribution(port, L, srv, model, x_host, profile, prim, ledger)
            lap("front traffic")
            std = profile.sketches[f"f{FRONT_DRIFT_COL}"].std
            shift = np.zeros(D, dtype=np.float32)
            shift[FRONT_DRIFT_COL] = FRONT_SHIFT_SIGMA * std
            sent += front_drift(port, L, srv, model, x_host, fb, prim, fbr, shift, ledger)
            lap("front drift")
            new, shape, n = front_swap(port, L, srv, model, x_host, fb, shift, ledger)
            sent += n
            lap("front swap")
            n, metric = front_failure(port, srv, x_host, shift)
            sent += n
            check(metric["cmlhn_serve_requests_total"] == sent
                  == sum(v for k, v in metric.items() if k.startswith("cmlhn_serve_status_")),
                  f"metrics_text requests {metric['cmlhn_serve_requests_total']}, sent {sent}")
            lap("front failure")
        front_firewall(port, os.path.join(tmp, "ingest"), card)
        lap("front firewall")
        front_knobs(port, model, x_host, tmp, card, ledger)
        lap("front knobs")
        os.environ.pop("CMLHN_FLIGHT_DIR")
    launches = ledger.main_path()
    check(launches["fused_lloyd_stats"] > 0 and launches["fused_assign"] > 0,
          f"front_door_phase launches {launches}")
    secs = time.perf_counter() - t_phase
    say(f"front_door_phase: {secs:.2f} s of host clock ({card}); {sent} requests to the "
        f"guarded server == metrics_text; main-path launches {json.dumps(launches)}")
    return {"launches": launches, "shape": shape}


# ------------------------------------------------------------------------
# slice 7b: the model farm and the continuous-learning lifecycle
# ------------------------------------------------------------------------
FARM_TENANTS = 4_096                      # bench.py _bench_model_farm: hospitals of 4-48 rows
FARM_D = 8
FARM_SAMPLE = 64                          # tenants of the looped baselines (bench.py's parity set)
FARM_CPU_CUT = 512                        # the first hospitals, fitted again on the CPU route
FARM_REG, FARM_POOL = 0.1, 5.0            # ridge; the partial-pooling fit's pseudo-rows
FARM_KM = {"k": 4, "max_iter": 10}
FARM_CLIENTS = 8
FARM_REQUESTS = 1_600                     # predict_tenant requests of 1-64 rows
FARM_UNKNOWN = 0.02                       # share of requests naming no hospital of the farm
FARM_DRIFT = 0.05                         # share of hospitals shifted (those of >= 16 rows)
FARM_SHIFT = 4.0                          # the shift, in feature stds
# card against the CPU route, relative to the largest |value|: the first run
# read 0 for all three (every op of the farm's fits is one IEEE elementwise
# operation or an exact min, on either device), so the limits are equality;
# each fails its control (the CPU route on TF32-rounded rows: 3.5e-4, 1.5e-4,
# 0.12 in that run)
FARM_LIMITS = {"theta": 0.0, "theta_pool": 0.0, "centers": 0.0}
LC_N, LC_K, LC_D = 400_000, 16, 8         # bench.py _bench_lifecycle's warm vs cold A/B
LC_SHIFT = 0.6
LC_BOOT = 20_000                          # the bootstrap fit's rows
LC_FILES, LC_FILE_ROWS = 8, 50_000        # the full cycle's drifted drops: 400,000 rows
LC_REQ_ROWS = 16                          # rows a request, a poll() after each
LC_BUCKETS = (1, 16, 64)
LC_CTRL = {"drift_window_rows": 128, "drift_trip_after": 2, "shadow_min_rows": 256,
           "canary_fraction": 0.25, "canary_min_rows": 64, "eval_rows": 256}
LC_OOC_ROWS = 131_072                     # the out-of-core retrain's block
# out-of-core against resident retrain, max |center| gap: the first run on
# the card read 4.77e-7 (blocked sums add in another order), so the limit
# is about 10x that; the control retrains on TF32-rounded rows and must
# land past it
LC_OOC_LIMIT = 5e-6
LC_CHAOS_FILES, LC_CHAOS_ROWS = 2, 2_000  # bench.py's 4,000-row loop snapshot
LC_SITES = ("lifecycle.journal.append", "lifecycle.retrain.commit", "lifecycle.shadow.start",
            "lifecycle.registry.flip", "lifecycle.registry.swap")
LC_STATES = ["serving", "drift_suspected", "retraining", "shadow", "canary", "promoted",
             "serving"]


def farm_fleet() -> dict:
    """bench.py's fleet (seed 0): hospital t has 4-48 rows of d = 8
    N(0, 1) features and y = x·(θ0 + 0.2·N(0, 1)) + 0.01·N(0, 1)."""
    import numpy as np

    rng = np.random.default_rng(0)
    theta0 = rng.normal(size=FARM_D)
    data = {}
    for t in range(FARM_TENANTS):
        n = int(rng.integers(4, 48))
        x = rng.normal(size=(n, FARM_D))
        y = x @ (theta0 + 0.2 * rng.normal(size=FARM_D)) + 0.01 * rng.normal(size=n)
        data[f"H{t:05d}"] = (x, y)
    return data


def farm_theta(m):
    import numpy as np

    return np.concatenate([m.arrays["coefficients"], m.arrays["intercepts"][:, None]], 1)


def rel_gap(a, b) -> float:
    import numpy as np

    return float(np.abs(np.asarray(a, np.float64) - b).max() / max(np.abs(b).max(), 1e-30))


def farm_fits(port, batch, kbatch, card: str) -> tuple:
    """The linear fits (ridge, and ridge + pooling) and the KMeans fit on
    the card, each against its looped baseline on 64 sampled tenants
    (bit for bit) and against the CPU route on the whole fleet (within
    ``FARM_LIMITS``, each failing its TF32-rounded control).  → (the
    ridge model, the KMeans model)."""
    import numpy as np
    import torch

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.farm import farm as pf

    F = port.farm
    T = batch.n_tenants
    lin_est = F.FarmLinearRegression(reg_param=FARM_REG)
    pool_est = F.FarmLinearRegression(reg_param=FARM_REG, pool=FARM_POOL)
    km_est = F.FarmKMeans(**FARM_KM)
    t0 = time.perf_counter()
    lin_est.fit(batch, device=DEV)
    first_s = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    lin, lin_syncs = count_syncs(lambda: lin_est.fit(batch, device=DEV))
    lin_s = time.perf_counter() - t0
    pool = pool_est.fit(batch, device=DEV)
    t0 = time.perf_counter()
    km, km_syncs = count_syncs(lambda: km_est.fit(kbatch, device=DEV))
    km_s = time.perf_counter() - t0
    # where the fits' time goes: the host's tenant sketches, and the KMeans
    # GLOBAL slot's pooled fit (8,192 rows at T = 1), each alone
    t0 = time.perf_counter()
    port.farm.farm.build_profile_stack(batch.x, batch.w, [f"f{j}" for j in range(FARM_D)])
    sketch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    km_est._fit_global(kbatch, torch.device(DEV))
    global_s = time.perf_counter() - t0

    # the looped baselines: the same functions on one-tenant slices
    sample = np.sort(np.random.default_rng(1).choice(T, FARM_SAMPLE, replace=False))
    x_dev, y_dev, w_dev = (pf._place_stack(a, DEV) for a in (batch.x, batch.y, batch.w))
    reg = pf._scalar(FARM_REG, DEV)
    zeros = torch.zeros(FARM_D + 1, device=DEV)
    for name, m, p, theta_g in (("ridge", lin, 0.0, zeros), ("pooled", pool, FARM_POOL,
                                torch.from_numpy(farm_theta(pool)[T]).to(DEV))):
        want = farm_theta(m)
        sync()
        t0 = time.perf_counter()
        got = [pf._tenant_solve(x_dev[i:i + 1], y_dev[i:i + 1], w_dev[i:i + 1], reg,
                                pf._scalar(p, DEV), theta_g, True)[0] for i in sample]
        got = [g.cpu().numpy()[0] for g in got]
        loop_s = time.perf_counter() - t0
        bad = [int(i) for i, g in zip(sample, got) if g.tobytes() != want[i].tobytes()]
        check(not bad, f"farm {name} fit != its looped baseline at tenants {bad[:5]}")
        if name == "ridge":
            lin_loop_rate = FARM_SAMPLE / loop_s
    kx, kw = pf._place_stack(kbatch.x, DEV), pf._place_stack(kbatch.w, DEV)
    sync()
    t0 = time.perf_counter()
    for i in sample:
        c0, cv = pf._init_farm_centers(kbatch.x[i:i + 1], kbatch.w[i:i + 1], FARM_KM["k"], 0,
                                       base_index=int(i))
        cen, counts, cost, n_iter, _ = pf._farm_kmeans_loop(
            kx[i:i + 1], kw[i:i + 1], pf._place_stack(c0, DEV), pf._place_stack(cv, DEV),
            FARM_KM["max_iter"], km_est.tol)
        for got, name in ((cen, "centers"), (counts, "sizes"), (cost, "costs"),
                          (n_iter, "n_iter")):
            check(got.cpu().numpy()[0].tobytes() == km.arrays[name][i].tobytes(),
                  f"farm KMeans {name} != its looped baseline at tenant {i}")
    km_loop_s = time.perf_counter() - t0

    # card against the CPU route on the first FARM_CPU_CUT hospitals: a
    # tenant's fit does not depend on the others, so the card's whole-fleet
    # rows are compared (the pooled fit gets the card's global θ as its
    # prior, through the refit), and the CPU route on TF32-rounded rows is
    # the control
    cut = FARM_CPU_CUT

    def head(b, rows=None):
        x = b.x[:cut] if rows is None else rows[:cut]
        return dataclasses.replace(b, tenant_ids=b.tenant_ids[:cut], x=x, y=b.y[:cut],
                                   w=b.w[:cut], n_rows=b.n_rows[:cut],
                                   masked_rows=b.masked_rows[:cut])

    def cpu_routes(rows=None, krows=None):
        sub = {t: (np.asarray(rows if rows is not None else batch.x)[i][batch.w[i] > 0],
                   batch.y[i][batch.w[i] > 0]) for i, t in enumerate(batch.tenant_ids[:cut])}
        return {"theta": farm_theta(lin_est.fit(head(batch, rows), device="cpu"))[:cut],
                "theta_pool": farm_theta(pool.refit(sub, device="cpu"))[:cut],
                "centers": km_est.fit(head(kbatch, krows), device="cpu").arrays["centers"][:cut]}

    card_out = {"theta": farm_theta(lin)[:cut], "theta_pool": farm_theta(pool)[:cut],
                "centers": km.arrays["centers"][:cut]}
    t0 = time.perf_counter()
    gaps = {k: rel_gap(card_out[k], v) for k, v in cpu_routes().items()}
    cpu_s = time.perf_counter() - t0
    ctl = {k: rel_gap(card_out[k], v) for k, v in cpu_routes(
        tf32_round(batch.x), tf32_round(kbatch.x)).items()}
    for k, lim in FARM_LIMITS.items():
        check(gaps[k] <= lim, f"farm {k}: card vs CPU {gaps[k]:.3g} > {lim}")
        check(ctl[k] > lim, f"farm {k}: the TF32-rounded control {ctl[k]:.3g} <= {lim}")
    say(f"farm: {T} hospitals ({int(batch.n_rows.sum())} rows, R={batch.pad_rows}, d={FARM_D}); "
        f"FarmLinearRegression(reg {FARM_REG}) {lin_s:.4f} s = {T / lin_s:.1f} tenants/s "
        f"(first call {first_s:.3f} s), {lin_syncs} host syncs a fit; looped "
        f"{lin_loop_rate:.1f} tenants/s ({T / lin_s / lin_loop_rate:.1f}x); "
        f"FarmKMeans(k={FARM_KM['k']}, max_iter {FARM_KM['max_iter']}) {km_s:.4f} s = "
        f"{T / km_s:.1f} tenants/s, {km.fit_info['steps']} steps, "
        f"{km.fit_info['done_reads']} reads of done, {km_syncs} host syncs a fit (alone: the "
        f"host's tenant sketches {sketch_s:.4f} s, the GLOBAL slot's pooled fit "
        f"{global_s:.4f} s); "
        f"looped {FARM_SAMPLE / km_loop_s:.1f} tenants/s ({T / km_s / (FARM_SAMPLE / km_loop_s):.1f}x); "
        f"ridge, pooled (pool {FARM_POOL}) and KMeans == their looped baselines bit for bit on "
        f"{FARM_SAMPLE} tenants; card vs CPU route on the first {cut} hospitals ({cpu_s:.2f} s) "
        f"{as_text(gaps)} "
        f"(limits {as_text(FARM_LIMITS)}; TF32-rounded control {as_text(ctl)}) ({card})")
    return lin, km


def farm_serving(port, data, lin, srv, card: str) -> None:
    """8 clients, ``FARM_REQUESTS`` requests of 1-64 rows over mixed
    hospitals (2 % unknown) through ``InferenceServer.predict_tenant`` on
    the started ``srv`` serving the farm as "farm" and a KMeans model as
    "kmeans": every answer == ``ModelFarmModel.predict`` on the routed
    rows, no recompile; ``predict_tenant`` on the KMeans name answers
    invalid_input."""
    import numpy as np

    rng = np.random.default_rng(21)
    ids = list(data)
    jobs = front_requests(rng, FARM_REQUESTS, 1, 64)
    tenants = [ids[int(i)] if u >= FARM_UNKNOWN else f"NEW{int(i)}"
               for i, u in zip(rng.integers(0, len(ids), len(jobs)), rng.random(len(jobs)))]
    rows = rng.normal(size=(jobs[-1][1], FARM_D))
    routed = np.concatenate([lin.route_request(t, rows[a:b])
                             for t, (a, b) in zip(tenants, jobs)]).astype(np.float32)
    want = lin.predict(routed, device=DEV).cpu().numpy()
    check(all(routed[a, 0] == lin.global_index for t, (a, _) in zip(tenants, jobs)
              if t.startswith("NEW")), "an unknown hospital was not routed to the GLOBAL slot")
    answers, wall = run_clients(FARM_CLIENTS, jobs, lambda j: srv.predict_tenant(
        "farm", tenants[j], rows[jobs[j][0]:jobs[j][1]]))
    for j, (a, b) in enumerate(jobs):
        r, _ = answers[j]
        check(r.ok and np.array_equal(r.value, want[a:b]),
              f"predict_tenant request {j} ({tenants[j]}): {r.status}, or != predict")
    check(srv.stats()["recompiles"] == 0, "farm serving met a shape outside the warmed buckets")
    r = srv.predict_tenant("kmeans", ids[0], rows[:3])
    check(r.status == "invalid_input" and "not tenant-routable" in r.detail,
          f"predict_tenant on a KMeans name answered {r.status}")
    check(srv.metrics.registry.counters.get("serve.not_routable") == 1,
          "serve.not_routable did not count the refused request")
    dev_rows = port.device_dataset(routed, device=DEV).x
    mixed_ms = gpu_ms(lambda: lin.predict(dev_rows), 20) if DEV == "cuda" else float("nan")
    unknown = sum(t.startswith("NEW") for t in tenants)
    say(f"farm serving: {FARM_REQUESTS} predict_tenant requests ({len(routed)} rows, {unknown} "
        f"to unknown hospitals -> the GLOBAL slot) from {FARM_CLIENTS} clients, every answer == "
        f"ModelFarmModel.predict, 0 recompiles; {FARM_REQUESTS / wall:.1f} requests/s, "
        f"{len(routed) / wall:.4g} rows/s over {wall:.2f} s; one mixed predict of "
        f"{len(routed)} rows {mixed_ms:.4f} ms on the card = {len(routed) / mixed_ms * 1e3:.4g} "
        f"rows/s; predict_tenant on a KMeans name -> invalid_input ({card})")


def farm_drift(port, data, lin, srv, card: str) -> None:
    """Shift 5 % of the hospitals (those of >= 16 rows) by ``FARM_SHIFT``;
    ``retrain_drifted`` must refit exactly them, leave every other hospital
    and the GLOBAL slot byte-identical, and ``swap_model`` the successor in
    under 8 clients' traffic with no request refused."""
    import numpy as np

    rng = np.random.default_rng(22)
    big = [t for t, (x, _) in data.items() if len(x) >= 16]
    shifted = set(rng.choice(big, int(FARM_DRIFT * len(data)), replace=False).tolist())
    new = {t: ((x + FARM_SHIFT, y) if t in shifted else (x, y)) for t, (x, y) in data.items()}
    ids = list(data)
    stop, results = threading.Event(), []

    def client(seed):
        r = np.random.default_rng(seed)
        while not stop.is_set():
            t = ids[int(r.integers(len(ids)))]
            results.append(srv.predict_tenant("farm", t, r.normal(size=(int(r.integers(1, 65)),
                                                                        FARM_D))))

    threads = [threading.Thread(target=client, args=(100 + c,), daemon=True)
               for c in range(FARM_CLIENTS)]
    for th in threads:
        th.start()
    try:
        t0 = time.perf_counter()
        new_model, report = port.lifecycle.retrain_drifted(
            lin, new, threshold=0.25, min_rows=16, server=srv, serving_name="farm", device=DEV)
        retrain_s = time.perf_counter() - t0
        time.sleep(0.2)
    finally:
        stop.set()
        for th in threads:
            th.join(60)
    check(set(report["drifted"]) == shifted,
          f"retrain_drifted refit {len(report['drifted'])} hospitals, shifted {len(shifted)}")
    check(report.get("swapped") == "farm" and srv.registry.get("farm").model is new_model,
          "the successor was not swapped in")
    check(results and all(r.ok for r in results),
          f"{sum(not r.ok for r in results)} of {len(results)} requests refused in the swap")
    keep = [i for i, t in enumerate(lin.tenant_ids) if t not in shifted] + [lin.global_index]
    for name in ("coefficients", "intercepts"):
        check(new_model.arrays[name][keep].tobytes() == lin.arrays[name][keep].tobytes(),
              f"an untouched hospital's {name} changed in the refit")
    moved = [lin.tenant_index(t) for t in shifted]
    check(not np.array_equal(new_model.arrays["coefficients"][moved],
                             lin.arrays["coefficients"][moved]), "the drifted hospitals kept θ")
    t = sorted(shifted)[0]
    x = new[t][0][:5]
    r = srv.predict_tenant("farm", t, x)
    check(r.ok and np.array_equal(r.value, new_model.predict_tenant(t, x, device=DEV)),
          "the server does not answer with the successor")
    say(f"farm drift: {len(shifted)} of {len(data)} hospitals shifted {FARM_SHIFT} stds; "
        f"retrain_drifted (PSI of {report['scored']} hospitals, masked refit, swap) "
        f"{retrain_s:.3f} s refit exactly them, every other hospital and the GLOBAL slot "
        f"byte-identical; {len(results)} requests from {FARM_CLIENTS} clients across the "
        f"swap, none refused ({card})")


def farm_preempt(port, kbatch, tmp: str) -> None:
    """A checkpointed ``FarmKMeans`` over the fleet killed at the 3rd
    checkpoint commit and resumed: bit-identical to an uninterrupted one."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults

    def est(d):
        return port.farm.FarmKMeans(**FARM_KM, tol=0.0, checkpoint_dir=os.path.join(tmp, d),
                                    checkpoint_every=1)

    ref = est("ref").fit(kbatch, device=DEV)
    plan = faults.FaultPlan().crash("fit_ckpt.save.commit", after=2)
    with faults.active(plan):
        try:
            est("killed").fit(kbatch, device=DEV)
            fail("the checkpointed farm fit was not killed")
        except faults.InjectedCrash:
            pass
    check(plan.fired("fit_ckpt.save.commit") == 1, "the farm checkpoint kill never fired")
    t0 = time.perf_counter()
    got = est("killed").fit(kbatch, device=DEV)
    resume_s = time.perf_counter() - t0
    for name in ("centers", "sizes", "costs", "n_iter"):
        check(got.arrays[name].tobytes() == ref.arrays[name].tobytes(),
              f"the resumed farm fit's {name} differ from the uninterrupted fit's")
    say(f"farm preemption: FarmKMeans with checkpoint_dir killed at the 3rd commit, resumed "
        f"in {resume_s:.3f} s, bit-identical to the uninterrupted fit")


def lc_draw(n: int, shift: float, rng):
    """bench.py _bench_lifecycle's law: 16 clusters of N(0, 1.5²) centers
    in 8-d, unit noise, all shifted by ``shift``."""
    import numpy as np

    true = np.random.default_rng(0).normal(scale=1.5, size=(LC_K, LC_D))
    return ((true + shift)[rng.integers(0, LC_K, n)]
            + rng.normal(scale=1.0, size=(n, LC_D))).astype(np.float32)


def lc_warm_cold(port, card: str) -> None:
    """bench.py's warm vs cold retrain A/B: 400,000 x 8 rows shifted 0.6,
    k = 16, max_iter 80, tol 1e-5 (K1)."""
    import numpy as np

    rng = np.random.default_rng(1)
    xa, xb = lc_draw(LC_N, 0.0, rng), lc_draw(LC_N, LC_SHIFT, rng)
    base = port.KMeans(k=LC_K, seed=0, max_iter=80, tol=1e-5).fit(xa, device=DEV)
    iters = {"cold": [], "warm": []}
    t0 = time.perf_counter()
    cold = port.KMeans(k=LC_K, seed=1, max_iter=80, tol=1e-5).fit(
        xb, device=DEV, on_iteration=lambda it, c, m: iters["cold"].append(it))
    cold_s = time.perf_counter() - t0
    wc = (base.cluster_centers + (xb.mean(0) - xa.mean(0))).astype(np.float32)
    t0 = time.perf_counter()
    warm = port.KMeans(k=LC_K, seed=1, max_iter=80, tol=1e-5, warm_start_centers=wc).fit(
        xb, device=DEV, on_iteration=lambda it, c, m: iters["warm"].append(it))
    warm_s = time.perf_counter() - t0
    ratio = warm.training_cost / cold.training_cost
    check(np.isfinite(ratio) and warm.cluster_centers.shape == (LC_K, LC_D),
          "the warm retrain is not finite")
    say(f"lifecycle warm vs cold retrain ({LC_N} x {LC_D}, k={LC_K}, shift {LC_SHIFT}): cold "
        f"{cold_s:.3f} s ({len(iters['cold'])} iterations), warm {warm_s:.3f} s "
        f"({len(iters['warm'])} iterations), {cold_s / warm_s:.2f}x; warm / cold cost "
        f"{ratio:.6f} ({card})")


def lc_world(port, work: str, feats, retrainer=None, server=None):
    """One incarnation of the lifecycle's server (``server``, or a new
    InferenceServer on the card), stream and controller over the durable
    state in ``work`` (bench.py's settings)."""
    PL = port.lifecycle
    schema = PL.feedback_schema(feats)
    incoming = os.path.join(work, "incoming")
    os.makedirs(incoming, exist_ok=True)
    stream = port.StreamExecution(
        source=port.FileStreamSource(incoming, schema),
        sink=port.UnboundedTable(os.path.join(work, "table"), schema),
        checkpoint=port.StreamCheckpoint(os.path.join(work, "ckpt")), device=DEV)
    srv = (server if server is not None
           else port.serve.InferenceServer(breaker_recovery_s=0.1, device=DEV))
    ctrl = PL.LifecycleController(
        os.path.join(work, "lc"), srv, "m",
        retrainer or PL.KMeansRetrainer(feats, k=LC_K, max_iter=80, tol=1e-5, device=DEV),
        stream=stream, buckets=LC_BUCKETS, **LC_CTRL)
    srv.attach_lifecycle(ctrl)
    return srv, stream, ctrl


def lc_drop(path: str, i: int, rows: int, feats) -> None:
    """Drifted drop ``i`` (seed [3, i]) as a feedback CSV: the features, a
    zero prediction and outcome (a worker process's job)."""
    import numpy as np

    x = lc_draw(rows, LC_SHIFT, np.random.default_rng([3, i]))
    body = np.concatenate([x, np.zeros((rows, 2), np.float32)], axis=1)
    with open(path, "w") as f:
        f.write(",".join((*feats, "prediction", "outcome")) + "\n")
        np.savetxt(f, body, fmt="%.9g", delimiter=",")   # float32 round-trips in 9 digits


def lc_seed(port, work: str, feats, boot, files: int, rows: int, server=None) -> tuple:
    """Bootstrap v0 and ingest ``files`` drifted drops of ``rows`` rows
    (written by spawned worker processes when there are many) for the
    controller over ``server`` (default a new InferenceServer).  →
    (server, stream, controller, write s, ingest s)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    m0, profile, x0 = boot
    srv, stream, ctrl = lc_world(port, work, feats, server=server)
    ctrl.bootstrap(m0, profile, train_x=x0)
    paths = [os.path.join(work, "incoming", f"drift-{i}.csv") for i in range(files)]
    t0 = time.perf_counter()
    if files * rows >= 100_000:
        with ProcessPoolExecutor(min(files, os.cpu_count() or 1),
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            list(pool.map(lc_drop, paths, range(files), [rows] * files, [feats] * files))
    else:
        for i, path in enumerate(paths):
            lc_drop(path, i, rows, feats)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    while stream.run_once() is not None:
        pass
    return srv, stream, ctrl, write_s, time.perf_counter() - t0


def lc_gauges(text: str) -> dict:
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^(cmlhn_lifecycle_\w+(?:\{[^}]*\})?) (\S+)$", text, re.M)}


def lc_agree(srv, ctrl, phase: str) -> None:
    """``health()["lifecycle"]`` and ``metrics_text()``'s lifecycle gauges
    against the journal's last entry."""
    last = ctrl.journal.last()
    h = srv.health()["lifecycle"]
    g = lc_gauges(srv.metrics_text())
    check(h["phase"] == last["state"] == phase and h["cycle"] == last["cycle"],
          f"health lifecycle {h['phase']} / {h['cycle']}, journal {last['state']} / "
          f"{last['cycle']}")
    check(g.get("cmlhn_lifecycle_cycle") == float(last["cycle"])
          and g.get(f'cmlhn_lifecycle_phase{{phase="{phase}"}}') == 1.0,
          f"metrics_text lifecycle gauges {g} disagree with the journal at {phase}")


def lc_answer(r, what: str) -> None:
    """A lifecycle request's answer is the primary's, the candidate's
    (canary), or ``unavailable`` because sustained drift holds the
    primary's breaker open ("circuit open"); any other answer (the primary
    raised on the card, a deadline) fails the phase."""
    check(r.status in ("ok", "canary")
          or (r.status == "unavailable" and r.detail == "circuit open"),
          f"{what}: {r.status} ({r.detail})")


def lc_full_cycle(port, L, tmp: str, feats, boot, card: str) -> tuple:
    """One full cycle over 400,000 drifted rows in 8 CSV drops: requests
    of 16 rows and a poll() after each until PROMOTED → SERVING; every
    answer the primary's, the candidate's or "circuit open"; the shadow
    scorer saw exactly the rows the primary answered during SHADOW, and at
    least one; every canary answer == the candidate's predict, with no
    candidate failure; health and metrics_text against the journal at
    CANARY and at the end.  → (the controller's work directory, the
    controller)."""
    from collections import Counter

    import numpy as np
    import torch

    work = os.path.join(tmp, "full")
    srv, stream, ctrl, write_s, ingest_s = lc_seed(port, work, feats, boot, LC_FILES,
                                                   LC_FILE_ROWS)
    trng = np.random.default_rng(4)
    steps, detect, t_detect, canary, states = 0, None, None, 0, []
    seen_canary = False
    tally, shadow_ok_rows = Counter(), 0
    with srv:
        t_start = time.perf_counter()
        while True:
            x = lc_draw(LC_REQ_ROWS, LC_SHIFT, trng)
            st = ctrl.state
            r = srv.predict("m", x, wait_timeout_s=30.0)
            lc_answer(r, f"request {steps} in {st}")
            tally[r.status] += 1
            if st == "shadow" and r.status == "ok":
                shadow_ok_rows += LC_REQ_ROWS
            if st == "canary":
                cand_failures = ctrl.health_fragment()["canary"]["candidate_failures"]
                check(cand_failures == 0, f"request {steps}: {cand_failures} candidate "
                      f"failures during CANARY")
            if r.status == "canary":
                canary += 1
                want = ctrl._candidate_model.predict(torch.from_numpy(x).to(DEV)).cpu().numpy()
                check(np.array_equal(r.value, want),
                      f"canary answer {canary} != the candidate's predict")
            ctrl.poll()
            steps += 1
            if detect is None and ctrl.state != "serving":
                detect, t_detect = steps * LC_REQ_ROWS, time.perf_counter()
            if not states or states[-1] != ctrl.state:
                states.append(ctrl.state)
            if ctrl.state == "canary" and not seen_canary:
                seen_canary = True
                lc_agree(srv, ctrl, "canary")
            if ctrl.state == "serving" and (ctrl.active_version or 0) > 0:
                break
            check(steps < 5_000, f"the lifecycle never promoted (state {ctrl.state})")
        e2e_s = time.perf_counter() - t_start
        promote_s = time.perf_counter() - t_detect
        lc_agree(srv, ctrl, "serving")
    journal = [e["state"] for e in ctrl.journal.entries()]
    check(journal == LC_STATES, f"journal {journal}")
    check(canary > 0, "no canary answer")
    shadow = next(e["info"] for e in ctrl.journal.entries() if e["state"] == "shadow")
    check(shadow["train_rows"] == LC_FILES * LC_FILE_ROWS and shadow["warm_started"],
          f"the retrain read {shadow['train_rows']} rows")
    # the shadow gate's divergence window: every row the primary answered
    # during SHADOW went through the candidate's ServingModel (K2), none lost
    gate = next(e["info"]["gate"] for e in ctrl.journal.entries() if e["state"] == "canary")
    shadow_rows = gate["shadow"]["rows"]
    check(shadow_rows == shadow_ok_rows and shadow_rows > 0,
          f"the shadow scorer saw {shadow_rows} rows; the primary answered {shadow_ok_rows} "
          f"during SHADOW")
    gate_path = ("full window" if shadow_rows >= LC_CTRL["shadow_min_rows"]
                 else "degraded: the drift breaker open, the metric gate decides")
    say(f"lifecycle full cycle: {LC_FILES} drops of {LC_FILE_ROWS} drifted rows written "
        f"{write_s:.2f} s, ingested {ingest_s:.2f} s; {steps} requests of {LC_REQ_ROWS} rows, "
        f"a poll() after each: journal {' -> '.join(journal)}; answers {dict(tally)} (every "
        f"unavailable one \"circuit open\"); shadow scorer {shadow_rows} rows == the primary's "
        f"ok rows during SHADOW, disagreement {gate['shadow']['disagreement_rate']}, gate "
        f"{gate_path}; detection at row {detect}; "
        f"drift to promotion {promote_s:.3f} s (retrain {shadow['retrain_s']} s on "
        f"{shadow['train_rows']} rows), first request to promotion {e2e_s:.3f} s; "
        f"{canary} canary answers == the candidate's predict, 0 candidate failures; health "
        f"and metrics_text == "
        f"the journal at CANARY and at the end ({card})")
    return work, ctrl


def lc_outofcore(port, work: str, ctrl, feats, boot, card: str) -> None:
    """The full cycle's retrain again with ``out_of_core_rows=131072``
    (``HostDataset`` blocks): the resident candidate's n_iter, centers
    within ``LC_OOC_LIMIT``, which the same retrain on TF32-rounded rows
    exceeds."""
    import types

    import numpy as np

    info = next(e["info"] for e in ctrl.journal.entries() if e["state"] == "retraining")
    table = ctrl.sink.read(upto_batch_id=info["snapshot_batch_id"])
    resident = port.load_model(os.path.join(work, "lc", "models", "v1"))
    retrain = port.lifecycle.KMeansRetrainer(
        feats, k=LC_K, max_iter=80, tol=1e-5, out_of_core_rows=LC_OOC_ROWS, device=DEV)
    t0 = time.perf_counter()
    ooc, _ = retrain(boot[0], table, os.path.join(work, "ooc_ckpt"), int(info["seed"]))
    ooc_s = time.perf_counter() - t0
    gap = float(np.abs(ooc.cluster_centers - resident.cluster_centers).max())
    rounded = types.SimpleNamespace(column=lambda c: tf32_round(table.column(c)))
    ctl, _ = retrain(boot[0], rounded, os.path.join(work, "ooc_ctl_ckpt"), int(info["seed"]))
    ctl_gap = float(np.abs(ctl.cluster_centers - resident.cluster_centers).max())
    check(ooc.n_iter == resident.n_iter, f"out-of-core retrain n_iter {ooc.n_iter}, resident "
          f"{resident.n_iter}")
    check(gap <= LC_OOC_LIMIT, f"out-of-core retrain centers {gap:.3g} off (limit "
          f"{LC_OOC_LIMIT})")
    check(ctl_gap > LC_OOC_LIMIT, f"the TF32-rounded control retrain is within {ctl_gap:.3g} "
          f"<= {LC_OOC_LIMIT}")
    say(f"lifecycle out-of-core retrain: {len(table)} rows in blocks of {LC_OOC_ROWS} "
        f"{ooc_s:.3f} s, n_iter {ooc.n_iter} == resident, centers within {gap:.3g} "
        f"(limit {LC_OOC_LIMIT}; the TF32-rounded control {ctl_gap:.3g}, n_iter "
        f"{ctl.n_iter}) ({card})")


def lc_chaos(port, tmp: str, feats, boot, card: str) -> dict:
    """bench.py's chaos matrix at its 4,000-row loop snapshot: a kill at each
    of the five promotion-path sites; every restart reaches PROMOTED with
    the final artifact's arrays == an uninterrupted run's.  → the
    uninterrupted run's final arrays."""
    from collections import Counter

    import numpy as np

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults

    answers = Counter()

    def cycle(site):
        work = os.path.join(tmp, "chaos", site or "ref")
        srv, _, ctrl, _, _ = lc_seed(port, work, feats, boot, LC_CHAOS_FILES, LC_CHAOS_ROWS)
        srv.start()
        plan = faults.FaultPlan().crash(site) if site else None
        if plan:
            faults.install(plan)
        crashes, trng = 0, np.random.default_rng(4)
        try:
            while not (ctrl.state == "serving" and (ctrl.active_version or 0) > 0):
                try:
                    st = ctrl.state
                    r = srv.predict("m", lc_draw(LC_REQ_ROWS, LC_SHIFT, trng),
                                    wait_timeout_s=30.0)
                    lc_answer(r, f"chaos {site}: a request in {st}")
                    answers[r.status] += 1
                    ctrl.poll()
                except faults.InjectedCrash:
                    crashes += 1
                    faults.clear()
                    srv.stop()
                    srv, _, ctrl = lc_world(port, work, feats)   # the restart
                    srv.start()
                except Exception as e:  # noqa: BLE001 — chaos_unhandled
                    fail(f"chaos {site}: unhandled {e!r}")
        finally:
            faults.clear()
            srv.stop()
        if plan:
            check(plan.fired(site) >= 1 and crashes >= 1, f"chaos {site}: the kill never fired")
        check([e["state"] for e in ctrl.journal.entries()][-2:] == ["promoted", "serving"],
              f"chaos {site}: did not end PROMOTED -> SERVING")
        with np.load(os.path.join(work, "lc", "models", "v1", "arrays.npz")) as z:
            return crashes, {k: z[k] for k in z.files}

    t0 = time.perf_counter()
    _, ref = cycle(None)
    crashes = 0
    for site in LC_SITES:
        n, got = cycle(site)
        crashes += n
        check(sorted(got) == sorted(ref) and all(
            got[k].tobytes() == v.tobytes() for k, v in ref.items()),
            f"chaos {site}: the final artifact differs from the uninterrupted run's")
    say(f"lifecycle chaos matrix ({LC_CHAOS_FILES * LC_CHAOS_ROWS}-row snapshot): a kill at "
        f"each of {len(LC_SITES)} sites, {crashes} crashes, every restart PROMOTED with the "
        f"final artifact == the uninterrupted run's; answers {dict(answers)} (every "
        f"unavailable one \"circuit open\"); chaos_unhandled 0; "
        f"{time.perf_counter() - t0:.2f} s ({card})")
    return ref


def farm_lifecycle_phase(port, L, card: str) -> dict:
    """Slice 7b at bench.py's shapes: the model farm (4,096 hospitals of
    4-48 rows: fits against their looped baselines and the CPU route,
    tenant serving, drifted-subset refit swapped under traffic, a preempted
    checkpointed fit) and the continuous-learning lifecycle (warm vs cold
    retrain at 400,000 x 8, k = 16; one full cycle over 400,000 drifted
    rows; the retrain out of core; the chaos matrix).  K1 and K2 are held
    to their plain versions at the lifecycle's shapes.  → {"launches": the
    main path's K1 / K2 launches, "k1": [shape records], "k2": [shape
    records]}."""
    import numpy as np

    import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.lifecycle  # noqa: F401

    t_phase = time.perf_counter()
    ledger = LaunchLedger(L)
    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    with ledger.aside():
        k_retrain = kernel_case(L, LC_N, LC_D, LC_K, 0, seed=15, reps=20)
        k_block = kernel_case(L, LC_OOC_ROWS, LC_D, LC_K, 0, seed=16, reps=50)[0]
        k2_served = k2_case(L, LC_BUCKETS[-1], LC_D, LC_K, seed=17, reps=200)
    shapes = {
        "k1": [{"n": LC_N, "d": LC_D, "k": LC_K, **{k: k_retrain[0][k] for k in keys}},
               {"n": LC_OOC_ROWS, "d": LC_D, "k": LC_K, **{k: k_block[k] for k in keys}}],
        "k2": [{"n": LC_N, "d": LC_D, "k": LC_K, **{k: k_retrain[1][k] for k in keys}},
               k2_served],
    }
    lap("farm kernels")
    data = farm_fleet()
    t0 = time.perf_counter()
    batch = port.farm.pack_tenants(data)
    kbatch = port.farm.pack_tenants({t: x for t, (x, _) in data.items()})
    say(f"farm: pack_tenants of {len(data)} hospitals {time.perf_counter() - t0:.3f} s (host)")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["CMLHN_FLIGHT_DIR"] = os.path.join(tmp, "flight")
        lin, km = farm_fits(port, batch, kbatch, card)
        lap("farm fits")
        srv = port.serve.InferenceServer(device=DEV)
        srv.add_model("farm", lin, buckets=BUCKETS)
        srv.add_model("kmeans", km.global_model(), buckets=BUCKETS)
        with srv:
            farm_serving(port, data, lin, srv, card)
            farm_drift(port, data, lin, srv, card)
        lap("farm serving and drift")
        farm_preempt(port, kbatch, tmp)
        lap("farm preemption")
        lc_warm_cold(port, card)
        lap("lifecycle warm vs cold")
        feats = tuple(f"f{j}" for j in range(LC_D))
        x0 = lc_draw(LC_BOOT, 0.0, np.random.default_rng(2))
        m0 = port.KMeans(k=LC_K, seed=0, max_iter=80, tol=1e-5).fit(x0, device=DEV)
        boot = (m0, port.DataProfile.from_matrix(x0.astype(np.float64), feats), x0)
        work, ctrl = lc_full_cycle(port, L, tmp, feats, boot, card)
        lap("lifecycle full cycle")
        lc_outofcore(port, work, ctrl, feats, boot, card)
        lap("lifecycle out of core")
        lc_ref = lc_chaos(port, tmp, feats, boot, card)
        lap("lifecycle chaos")
        os.environ.pop("CMLHN_FLIGHT_DIR")
    launches = ledger.main_path()
    check(launches["fused_lloyd_stats"] > 0 and launches["fused_assign"] > 0,
          f"farm_lifecycle_phase launches {launches}")
    say(f"farm_lifecycle_phase: {time.perf_counter() - t_phase:.2f} s of host clock ({card}); "
        f"main-path launches {json.dumps(launches)}")
    return {"launches": launches, "lc_ref": lc_ref, **shapes}


# ------------------------------------------------------------------------
# slice 7c: the serving fleet
# ------------------------------------------------------------------------
FLEET_N, FLEET_D, FLEET_K = 6_000, 64, 1_024   # bench.py _bench_serve_fleet's served model
FLEET_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)
FLEET_REPLICAS = 4                        # on one card: EvenPlacement round-robins onto cuda:0
FLEET_QUEUE = 384                         # rows a replica's queue holds
FLEET_OVERLOAD = 1.7                      # x the raw ServingModel rate at bucket 128
FLEET_SECONDS = 4.0
FLEET_CURVE = (0.35, 0.9, 1.7, 2.6)       # the degradation curve, 1.2 s a point
FLEET_CURVE_SECONDS = 1.2
FLEET_CHAOS = 0.9                         # the swap and kill legs' load, x the raw rate
FLEET_CHAOS_SECONDS = 1.5
PROC_N, PROC_D, PROC_K = 4_000, 32, 256   # bench.py _bench_serve_fleet_multiproc
PROC_ROWS = 16
PROC_OVERLOAD = 2.5
PROC_SECONDS = 1.5                        # bench.py's 3 s, halved for the script's time
PROC_LEGS = (1, 2, 4)
FLEET_WATCH_S = 5.0                       # the stall watchdog's window


def fleet_mix(F):
    """bench.py's 22-tenant mix: 8 interactive hospitals of 16 rows, 8
    batch of 64, 6 best-effort of 96."""
    return tuple([F.TenantMix(f"H{i:02d}", 1.0, "interactive", 16) for i in range(8)]
                 + [F.TenantMix(f"J{i:02d}", 1.0, "batch", 64) for i in range(8)]
                 + [F.TenantMix(f"B{i:02d}", 1.0, "best_effort", 96) for i in range(6)])


def fleet_schedule(F, mix, rows_per_s: float, seconds: float, seed: int = 42) -> list:
    """bench.py's open-loop schedule: Poisson at ``rows_per_s`` with the
    1.5x burst over the middle third."""
    per_req = sum(m.weight * m.rows for m in mix) / sum(m.weight for m in mix)
    return F.build_schedule(F.LoadProfile(
        base_rate_rps=rows_per_s / per_req, tenants=mix, seed=seed,
        burst_start_s=seconds / 3.0, burst_dur_s=seconds / 3.0, burst_mult=1.5), seconds)


def raw_rate(port, model, x, bucket: int) -> float:
    """Rows/s of one ServingModel on the card at ``bucket`` rows, 0.6 s."""
    sm = port.serve.ServingModel(model, buckets=(bucket,), device=DEV).warmup()
    t0, rows = time.perf_counter(), 0
    while time.perf_counter() - t0 < 0.6:
        sm.predict_bucketed(x[:bucket])
        rows += bucket
    return rows / (time.perf_counter() - t0)


class Served:
    """An open-loop submit that gives each arrival its own rows (a sliding
    window over ``x``) and keeps (arrival, start, request, era) for the
    checks after the replay; ``era`` counts the events fired before the
    submit."""

    def __init__(self, x, send):
        self.x, self.send, self.kept, self.era = x, send, [], 0

    def __call__(self, a):
        start = (len(self.kept) * 97) % (len(self.x) - 128)
        req = self.send(a, self.x[start:start + a.rows])
        self.kept.append((a, start, req, self.era))
        return req

    def answers(self):
        """→ [(rows start, n rows, result, era)] once the replay harvested."""
        return [(start, a.rows, req.wait(0.0), era) for a, start, req, era in self.kept]


def check_answers(served: Served, pred, what: str, era_pred=None) -> int:
    """Every ok answer == ``pred`` on its rows (``era_pred[era]`` where
    given: the model serving in that era).  → ok answers."""
    import numpy as np

    n = 0
    for start, rows, r, era in served.answers():
        if r.ok:
            want = (era_pred or {}).get(era, pred)
            ok = any(np.array_equal(r.value, w[start:start + rows])
                     for w in (want if isinstance(want, list) else [want]))
            check(ok, f"{what}: an ok answer (rows {start}..{start + rows}, era {era}) differs "
                  f"from predict")
            n += 1
    return n


def slo_line(rep: dict, pin_s: float) -> tuple[float, str]:
    """(interactive rows/s within the pin, the summary text)."""
    r = rep["reports"].get("interactive")
    hit = r.in_slo(pin_s) if r is not None else {"rows": 0, "p50_ms": None, "p99_ms": None}
    rate = hit["rows"] / rep["gen_wall_s"]
    shed = {k: v["shed_fraction"] for k, v in rep["per_class"].items()}
    return rate, (f"{rate:.1f} interactive rows/s within {pin_s * 1e3:.0f} ms (p50 "
                  f"{hit['p50_ms']} ms, p99 {hit['p99_ms']} ms); ok {rep['ok_rows']} of "
                  f"{rep['offered_rows']} rows; shed fractions {shed}; unanswered "
                  f"{rep['unanswered']}; pacing lag {rep['max_pacing_lag_s']} s")


def fleet_in_process(port, F, card: str, wd) -> dict:
    """(a) and (b): bench.py's fleet of 4 replicas on the card against one
    server (its default queue, and its queue at the fleet's total
    buffering) past saturation, the degradation curve, one routed trace;
    then a failed and a clean swap and a replica kill under load."""
    import numpy as np
    import torch

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.obs import trace
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults

    rng = np.random.default_rng(0)
    x = rng.normal(size=(FLEET_N, FLEET_D)).astype(np.float32)
    t0 = time.perf_counter()
    model = port.KMeans(k=FLEET_K, max_iter=2, seed=0).fit(x, device=DEV)
    fit_s = time.perf_counter() - t0
    pred = predict_rows(model, x)
    rate = raw_rate(port, model, x, FLEET_BUCKETS[-1])
    classes = F.default_slo_classes()
    deadlines = {n: c.default_deadline_s for n, c in classes.items()}
    pin = deadlines["interactive"]
    mix = fleet_mix(F)
    say(f"fleet model: KMeans(k={FLEET_K}, max_iter=2) on {FLEET_N} x {FLEET_D} rows "
        f"{fit_s:.3f} s (K1); raw ServingModel rate at bucket {FLEET_BUCKETS[-1]} "
        f"{rate:.1f} rows/s ({card})")

    def fleet():
        fs = F.ReplicaSet(n_replicas=FLEET_REPLICAS, max_queue_rows=FLEET_QUEUE)
        fs.add_model("km", model, buckets=FLEET_BUCKETS)
        wd.watch_fleet(fs)
        return fs

    def fleet_send(fs):
        return lambda a, rows: fs.submit("km", rows, tenant_id=a.tenant_id, slo=a.slo,
                                         deadline_s=deadlines[a.slo])

    def run_fleet(sched, **kw):
        fs = fleet()
        served = Served(x, fleet_send(fs))
        with fs:
            rep = F.replay(served, sched, wait_timeout_s=8.0, **kw)
            health = fs.health()
        return rep, served, health, fs

    def run_single(sched, queue_rows):
        srv = port.serve.InferenceServer(max_queue_rows=queue_rows, device=DEV)
        srv.add_model("km", model, buckets=FLEET_BUCKETS)
        served = Served(x, lambda a, rows: srv.submit("km", rows, deadline_s=deadlines[a.slo]))
        with srv:
            rep = F.replay(served, sched, wait_timeout_s=8.0)
        return rep, served

    # ---- (a) past saturation: the fleet against both single-server baselines
    sched = fleet_schedule(F, mix, FLEET_OVERLOAD * rate, FLEET_SECONDS)
    legs = {}
    for name, run in (("single (queue 4096)", lambda: run_single(sched, 4096)),
                      (f"single (queue {FLEET_QUEUE * FLEET_REPLICAS})",
                       lambda: run_single(sched, FLEET_QUEUE * FLEET_REPLICAS)),
                      (f"fleet ({FLEET_REPLICAS} replicas)", lambda: run_fleet(sched)[:2])):
        rep, served = run()
        check(rep["unanswered"] == 0, f"{name}: {rep['unanswered']} unanswered")
        n_ok = check_answers(served, pred, name)
        legs[name] = slo_line(rep, pin)
        say(f"fleet leg {name}, {len(sched)} requests at {FLEET_OVERLOAD}x the raw rate over "
            f"{FLEET_SECONDS} s: {legs[name][1]}; {n_ok} ok answers == predict ({card})")
    lap("fleet saturation legs")
    curve = []
    for mult in FLEET_CURVE:
        rep, served, _, _ = run_fleet(fleet_schedule(F, mix, mult * rate, FLEET_CURVE_SECONDS,
                                                     seed=7))
        check(rep["unanswered"] == 0, f"curve {mult}x: {rep['unanswered']} unanswered")
        check_answers(served, pred, f"curve {mult}x")
        fr = {slo: rep["per_class"].get(slo, {"shed_fraction": 0.0})["shed_fraction"]
              for slo in F.SLO_SHED_ORDER}
        check(fr["best_effort"] >= fr["batch"] >= fr["interactive"],
              f"curve {mult}x: shed fractions out of class order {fr}")
        curve.append((mult, fr))
    say("fleet degradation curve (shed fraction best_effort / batch / interactive): "
        + "; ".join(f"{m}x {f['best_effort']} / {f['batch']} / {f['interactive']}"
                    for m, f in curve) + f" — class order held at every point ({card})")
    lap("fleet degradation curve")

    # ---- one routed trace, and where the replicas' serving tensors lie
    tracer = trace.Tracer()
    fs = fleet()
    with fs:
        with trace.active(tracer):
            r = fs.predict("km", x[:4], tenant_id="H00", slo="interactive")
        check(r.ok and np.array_equal(r.value, pred[:4]), f"the traced request: {r.status}")
        root = [s for s in tracer.spans if s["name"] == "fleet.request"]
        check(len(root) == 1, "no fleet.request span")
        chain = trace.timeline(tracer.spans, root[0]["trace_id"])
        names = [s["name"] for s in chain]
        check({"fleet.request", "router.route", "serve.request"} <= set(names),
              f"the routed trace holds {names}")
        card0 = torch.device("cuda", 0)
        for rep_ in fs.replicas:
            sm = rep_.server.registry.get("km")
            out = sm._fn(torch.zeros((1, FLEET_D), device=sm.device))
            check(sm.device == card0 and rep_.server.device == card0 and out.device == card0
                  and all(t.device == card0 for t in sm.model._centers_on.values()),
                  f"replica {rep_.index} serves off cuda:0")
    say(f"fleet trace: one trace id {root[0]['trace_id']} holds {' > '.join(names)} "
        f"(replica {root[0]['attrs'].get('replica')}); all {FLEET_REPLICAS} replicas' "
        f"ServingModels, centers and outputs on cuda:0 ({card})")

    # ---- (b) promotion and chaos under load
    # the successor: two Lloyd steps from the served centers on a fresh
    # draw of the rows (a warm refit, no k-means++ init)
    x_new = np.random.default_rng(5).normal(size=(FLEET_N, FLEET_D)).astype(np.float32)
    succ = port.KMeans(k=FLEET_K, max_iter=2, seed=5,
                       warm_start_centers=model.cluster_centers).fit(x_new, device=DEV)
    pred_new = predict_rows(succ, x)
    check(not np.array_equal(pred_new, pred), "the refit predicts as the served model does")
    swap = {}

    def swap_leg(event, seed):
        """A replay at the curve's unsaturated point with ``event(fs,
        served)`` at its middle.  → (report, served, health)."""
        fs = fleet()
        served = Served(x, fleet_send(fs))
        with fs:
            rep = F.replay(served, fleet_schedule(F, mix, FLEET_CURVE[0] * rate,
                                                  FLEET_CHAOS_SECONDS, seed=seed),
                           wait_timeout_s=8.0,
                           events=[(FLEET_CHAOS_SECONDS / 2, lambda: event(fs, served))])
            health = fs.health()
        check(rep["unanswered"] == 0, f"a swap leg: {rep['unanswered']} unanswered")
        return rep, served, health

    def failed_swap(fs, served):
        plan = faults.FaultPlan().fail(
            "fleet.swap.prepare", when=lambda ctx: ctx.get("replica") == 1,
            error=lambda: RuntimeError("injected prepare failure"))
        with faults.active(plan):
            try:
                fs.swap_model("km", succ)
                fail("the swap with a failing prepare on replica 1 flipped")
            except RuntimeError as e:
                check("injected" in str(e), f"the failed swap raised {e!r}")
        check(plan.fired("fleet.swap.prepare") == 1, "the prepare fault never fired")
        check(all(r.server.registry.get("km").model is model for r in fs.replicas),
              "a replica flipped in the failed swap")
        served.era = 1

    def clean_swap(fs, served):
        t0 = time.perf_counter()
        fs.swap_model("km", succ)
        swap["ms"] = (time.perf_counter() - t0) * 1e3
        check(all(r.server.registry.get("km").model is succ for r in fs.replicas),
              "the clean swap left a replica on the old model")
        served.era = 1

    rep, served, health = swap_leg(failed_swap, 9)
    n_failed = check_answers(served, pred, "the failed swap's leg")
    check(health["promotions"] == 0, f"the failed swap counted {health['promotions']}")
    rep, served, health = swap_leg(clean_swap, 10)
    n_ok = check_answers(served, pred, "the clean swap's leg", {0: [pred, pred_new], 1: pred_new})
    answers = served.answers()
    refused = [r.status for *_, r, _ in answers if r.status == "unavailable" or (
        r.status == "rejected" and not (r.detail or "").startswith("admission:"))]
    ladder = sum(1 for *_, r, _ in answers
                 if r.status == "rejected" and (r.detail or "").startswith("admission:"))
    after = sum(1 for *_, r, era in answers if era == 1 and r.ok)
    late = sum(1 for *_, r, _ in answers if r.status == "deadline_exceeded")
    check(not refused, f"the clean swap's leg refused {len(refused)} requests")
    check(health["promotions"] == 1 and after > 0,
          f"promotions {health['promotions']}, {after} answers after the swap")
    say(f"fleet swaps at {FLEET_CURVE[0]}x load: the prepare fault on replica 1 flipped no "
        f"replica, {n_failed} ok answers == the served model's; the clean swap flipped all "
        f"{FLEET_REPLICAS} in {swap['ms']:.2f} ms, {after} ok answers after it == the refit's "
        f"predict ({n_ok} ok in the leg), none refused by a replica or the router ({ladder} "
        f"shed at the door by the SLO ladder), {late} past their deadline ({card})")

    fs = fleet()
    tenants = [f"T{i:03d}" for i in range(200)]
    home = {t: fs.router.route(tenant_id=t, model="km").index for t in tenants}
    victims = [t for t in tenants if home[t] == 1]
    served = Served(x, fleet_send(fs))
    with fs:
        rep = F.replay(served, fleet_schedule(F, mix, FLEET_CHAOS * rate, FLEET_CHAOS_SECONDS,
                                              seed=11),
                       wait_timeout_s=8.0, mid_hook=lambda: fs.kill_replica(1))
        check(rep["unanswered"] == 0, f"the kill leg: {rep['unanswered']} unanswered")
        n_ok = check_answers(served, pred, "the kill leg")
        over = {t: fs.router.route(tenant_id=t, model="km").index for t in victims}
        check(all(v != 1 for v in over.values()), "a dead replica's tenant routed to it")
        for t in victims[:5]:
            r = fs.predict("km", x[:2], tenant_id=t)
            check(r.ok and np.array_equal(r.value, pred[:2]), f"post-kill {t}: {r.status}")
        fs.revive_replica(1)
        back = {t: fs.router.route(tenant_id=t, model="km").index for t in tenants}
        check(back == home, "the revived replica's tenants did not come home")
        r = fs.predict("km", x[:2], tenant_id=victims[0])
        check(r.ok and np.array_equal(r.value, pred[:2]), f"after the revive: {r.status}")
        health = fs.health()
    check(health["replicas_killed"] == 1 and health["replicas_revived"] == 1
          and health["status"] == "ok", f"kill leg health {health}")
    say(f"fleet kill under {FLEET_CHAOS}x load: replica 1 killed mid-load, 0 unanswered, "
        f"{n_ok} ok answers == predict, rerouted {health['rerouted']}; revived, its "
        f"{len(victims)} of {len(tenants)} tenants home ({card})")
    lap("fleet swap and kill")
    return {"fit_s": fit_s, "raw_rate": rate, "legs": {k: v[0] for k, v in legs.items()},
            "swap_ms": swap["ms"]}


def note_launches(fs, seen: dict) -> None:
    """Each live worker's K2 launches, read from its ping, by pid (a
    worker's count only grows, so the newest reading is its total)."""
    for r in fs.replicas:
        if r.server.alive():
            p = r.server.ping()
            seen[p["pid"]] = p["launches"]["fused_assign"]


def balanced_tenants(F, n: int, legs) -> list:
    """``n`` interactive hospital ids, H00 upward, that the consistent-hash
    ring of every leg's fleet spreads evenly (n / workers a worker).
    bench.py's H00-H07 put 6 of 8 on one worker of 2 and none on the 4th
    of 4, so its legs measure fewer serving workers than they name."""
    rings = {}
    for w in legs:
        rings[w] = F.ConsistentHashRing()
        for i in range(w):
            rings[w].add(i)
    counts = {w: [0] * w for w in legs}
    names, i = [], 0
    while len(names) < n:
        name = f"H{i:02d}"
        owners = {w: ring.owner(name) for w, ring in rings.items()}
        if all(counts[w][o] < n // w for w, o in owners.items()):
            names.append(name)
            for w, o in owners.items():
                counts[w][o] += 1
        i += 1
    return names


def fleet_multiproc(port, F, FP, card: str) -> dict:
    """(c): bench.py's multi-process fleet, 16-row interactive requests at
    2.5x one server's raw rate over 1.5 s (bench.py: 3 s), one fresh fleet
    of 1, 2 and 4 worker processes on the card a leg (spawned side by side), as bench.py
    runs them.  The 8 tenants spread evenly over every leg's workers, and
    every worker must launch K2 during its leg.  After its leg the
    2-worker fleet takes a SIGKILL mid-load (revived) and one corrupted
    RPC frame (its worker reaped).  → {"launches": the workers' K2
    launches read from their pings, "legs": {workers: numbers},
    "revive_s": ...}."""
    import numpy as np

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults

    rng = np.random.default_rng(0)
    x = rng.normal(size=(PROC_N, PROC_D)).astype(np.float32)
    t0 = time.perf_counter()
    model = port.KMeans(k=PROC_K, max_iter=2, seed=0).fit(x, device=DEV)
    fit_s = time.perf_counter() - t0
    pred = predict_rows(model, x)
    rate = raw_rate(port, model, x, PROC_ROWS)
    deadlines = {n: c.default_deadline_s for n, c in F.default_slo_classes().items()}
    pin = deadlines["interactive"]
    tenants = balanced_tenants(F, 8, PROC_LEGS)
    mix = tuple(F.TenantMix(t, 1.0, "interactive", PROC_ROWS) for t in tenants)
    sched = F.build_schedule(F.LoadProfile(
        base_rate_rps=PROC_OVERLOAD * rate / PROC_ROWS, tenants=mix, seed=42,
        burst_start_s=PROC_SECONDS / 3, burst_dur_s=PROC_SECONDS / 3, burst_mult=1.5),
        PROC_SECONDS)
    say(f"proc fleet: KMeans(k={PROC_K}, max_iter=2) on {PROC_N} x {PROC_D} rows "
        f"{fit_s:.3f} s (K1); tenants {tenants}, 8 / n on each of a leg's n workers ({card})")
    total, legs, revive_s = 0, {}, None
    for n in PROC_LEGS:
        t0 = time.perf_counter()
        fs = FP.ProcReplicaSet(n_replicas=n, max_queue_rows=FLEET_QUEUE)
        spawn_s = time.perf_counter() - t0
        seen = {}
        try:
            fs.add_model("km", model, buckets=(PROC_ROWS,))
            fs.start()
            pings = [r.server.ping() for r in fs.replicas]
            pids = [p["pid"] for p in pings]
            check(len(set(pids)) == n and os.getpid() not in pids
                  and pids == [r.server.pid for r in fs.replicas], f"worker pids {pids}")
            check(all(p["device"] == "cuda:0" for p in pings),
                  f"workers report devices {[p['device'] for p in pings]}")
            before = [p["launches"]["fused_assign"] for p in pings]
            served = Served(x, lambda a, rows: fs.submit(
                "km", rows, tenant_id=a.tenant_id, slo=a.slo, deadline_s=deadlines[a.slo]))
            rep = F.replay(served, sched, wait_timeout_s=8.0)
            check(rep["unanswered"] == 0, f"{n} workers: {rep['unanswered']} unanswered")
            n_ok = check_answers(served, pred, f"{n} workers")
            goodput, text = slo_line(rep, pin)
            k2 = [r.server.ping()["launches"]["fused_assign"] - b
                  for r, b in zip(fs.replicas, before)]
            check(all(v > 0 for v in k2), f"{n} workers: a worker launched K2 no time "
                  f"during its leg: {k2}")
            note_launches(fs, seen)
            legs[n] = {"goodput": goodput, "spawn_s": spawn_s,
                       "p99": rep["reports"]["interactive"].in_slo(pin)["p99_ms"]}
            say(f"proc fleet, {n} worker(s) on cuda:0, a fresh fleet spawned side by side in "
                f"{spawn_s:.2f} s, pids {pids} (the parent {os.getpid()}): {len(sched)} "
                f"requests at {PROC_OVERLOAD}x the raw rate {rate:.1f} rows/s over "
                f"{PROC_SECONDS} s: {text}; {n_ok} ok answers == the parent's predict; each "
                f"worker's K2 launches during the leg {k2} ({card})")
            if n == 2:
                revive_s = proc_chaos(fs, x, pred, faults, seen, card)
        finally:
            fs.stop()
        total += sum(seen.values())
    check(revive_s is not None, "the proc fleet's chaos did not run")
    g = {n: v["goodput"] for n, v in legs.items()}
    say(f"proc fleet goodput ratios (no gate: the workers' CUDA contexts time-slice one card): "
        f"1->2 {g[2] / g[1] if g[1] else float('nan'):.2f}, 2->4 "
        f"{g[4] / g[2] if g[2] else float('nan'):.2f} ({card})")
    lap("fleet multi-process")
    return {"launches": total, "legs": legs, "revive_s": revive_s}


def proc_chaos(fs, x, pred, faults, seen: dict, card: str) -> float:
    """On a 2-worker fleet: a SIGKILL with 32 requests in flight (none
    unanswered; the worker revived), then one corrupted RPC frame
    (transport death, the worker reaped: one worker stays live); ``seen``
    gathers the workers' K2 launches before each death.  → the revive's
    seconds."""
    import numpy as np

    live = [r.index for r in fs.replicas if r.healthy()]
    note_launches(fs, seen)
    reqs = [fs.submit("km", x[i * 4:i * 4 + 4], tenant_id=f"t{i}") for i in range(32)]
    fs.kill_replica(live[0])
    res = [r.wait(15.0) for r in reqs]
    check(all(r.detail != "client wait timed out" for r in res)
          and {r.status for r in res} <= {"ok", "unavailable", "rejected"},
          f"SIGKILL mid-load: {[r.status for r in res]}")
    for i, r in enumerate(res):
        check(not r.ok or np.array_equal(r.value, pred[i * 4:i * 4 + 4]),
              "an answer around the SIGKILL differs from predict")
    t0 = time.perf_counter()
    fs.revive_replica(live[0])
    revive_s = time.perf_counter() - t0
    check(fs.replicas[live[0]].server.ping()["device"] == "cuda:0",
          "the revived worker's device")
    note_launches(fs, seen)
    target = fs.router.route(tenant_id="h1", model="km").index
    plan = faults.FaultPlan().corrupt("fleet.proc.rpc", at_byte=1, times=1,
                                      when=lambda ctx: ctx.get("replica") == target)
    with faults.active(plan):
        r = fs.submit("km", x[:4], tenant_id="h1").wait(10.0)
    check(r.status in ("ok", "unavailable") and plan.fired("fleet.proc.rpc") == 1,
          f"the corrupted frame: {r.status}, fired {plan.fired('fleet.proc.rpc')}")
    deadline = time.monotonic() + 10.0
    while fs.replicas[target].server.alive() and time.monotonic() < deadline:
        time.sleep(0.02)
    check(fs.reap() == [target], "the corrupted frame did not end its worker")
    after = fs.predict("km", x[:4], tenant_id="h1")
    check(after.ok and np.array_equal(after.value, pred[:4]),
          f"after the corrupted frame: {after.status}")
    say(f"proc fleet chaos (2 workers): SIGKILL with 32 requests in flight, "
        f"{sum(q.ok for q in res)} ok and {sum(q.status == 'unavailable' for q in res)} "
        f"unavailable, 0 unanswered, revived on cuda:0 in {revive_s:.2f} s; one corrupted RPC "
        f"frame to worker {target} answered {r.status} as transport death, the worker reaped, "
        f"the survivor answering == predict ({card})")
    return revive_s


def fleet_lifecycle(port, F, tmp: str, card: str, ref=None) -> None:
    """(d): the lifecycle over a 2-replica fleet on the card at
    farm_lifecycle_phase's 4,000-row chaos snapshot: PROMOTED on both
    replicas, the final artifact == a single server's (``ref``: the final
    arrays of farm_lifecycle_phase's uninterrupted chaos run of the same
    snapshot; run here when not given); a kill at fleet.swap.commit flips
    neither replica, and a restarted controller over the same fleet
    re-applies the flip on both."""
    import numpy as np

    import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.lifecycle  # noqa: F401
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults

    feats = tuple(f"f{j}" for j in range(LC_D))
    x0 = lc_draw(LC_BOOT, 0.0, np.random.default_rng(2))
    m0 = port.KMeans(k=LC_K, seed=0, max_iter=80, tol=1e-5).fit(x0, device=DEV)
    boot = (m0, port.DataProfile.from_matrix(x0.astype(np.float64), feats), x0)

    def drive(srv, ctrl, crash=False):
        trng, steps = np.random.default_rng(4), 0
        while not (ctrl.state == "serving" and (ctrl.active_version or 0) > 0):
            r = srv.predict("m", lc_draw(LC_REQ_ROWS, LC_SHIFT, trng), deadline_s=30.0,
                            wait_timeout_s=30.0)
            if r.status == "unavailable" and "no healthy replica" in r.detail:
                time.sleep(0.1)   # every replica's drift breaker open: wait out its recovery
            else:
                lc_answer(r, f"fleet lifecycle request {steps}")
            ctrl.poll()
            steps += 1
            check(steps < 5_000, f"the fleet lifecycle never promoted (state {ctrl.state})")
        return steps

    def arrays(work):
        with np.load(os.path.join(work, "lc", "models", "v1", "arrays.npz")) as z:
            return {k: z[k] for k in z.files}

    def centers(fs):
        return [r.server.registry.get("m").model.cluster_centers for r in fs.replicas]

    t0 = time.perf_counter()
    if ref is None:
        work = os.path.join(tmp, "single")
        srv, _, ctrl, _, _ = lc_seed(port, work, feats, boot, LC_CHAOS_FILES, LC_CHAOS_ROWS)
        with srv:
            drive(srv, ctrl)
        ref = arrays(work)
    single_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    work = os.path.join(tmp, "fleet")
    fs = F.ReplicaSet(n_replicas=2, breaker_recovery_s=0.1)
    _, _, ctrl, _, _ = lc_seed(port, work, feats, boot, LC_CHAOS_FILES, LC_CHAOS_ROWS, server=fs)
    with fs:
        steps = drive(fs, ctrl)
        journal = [e["state"] for e in ctrl.journal.entries()]
        check(journal == LC_STATES, f"the fleet's journal {journal}")
        got = arrays(work)
        check(sorted(got) == sorted(ref) and all(got[k].tobytes() == v.tobytes()
                                                 for k, v in ref.items()),
              "the fleet's promoted artifact differs from the single server's")
        check(all(np.array_equal(c, ref["cluster_centers"]) for c in centers(fs)),
              "PROMOTED did not land on both replicas")
    fleet_s = time.perf_counter() - t0

    work = os.path.join(tmp, "killed")
    fs = F.ReplicaSet(n_replicas=2, breaker_recovery_s=0.1)
    _, _, ctrl, _, _ = lc_seed(port, work, feats, boot, LC_CHAOS_FILES, LC_CHAOS_ROWS, server=fs)
    plan = faults.FaultPlan().crash("fleet.swap.commit")
    with fs:
        faults.install(plan)
        try:
            drive(fs, ctrl)
            fail("the kill at fleet.swap.commit never fired")
        except faults.InjectedCrash:
            pass
        finally:
            faults.clear()
        check(ctrl.journal.last()["state"] == "promoted", "the kill before PROMOTED was journaled")
        check(all(np.array_equal(c, m0.cluster_centers) for c in centers(fs)),
              "a replica flipped before the killed commit")
        _, _, again = lc_world(port, work, feats, server=fs)     # the restart
        check([e["state"] for e in again.journal.entries()][-2:] == ["promoted", "serving"],
              "the restart did not finish PROMOTED -> SERVING")
        check(all(np.array_equal(c, ref["cluster_centers"]) for c in centers(fs)),
              "the restart did not re-apply the flip on both replicas")
    say(f"fleet lifecycle ({LC_CHAOS_FILES * LC_CHAOS_ROWS}-row snapshot, 2 replicas on "
        f"cuda:0): journal {' -> '.join(journal)} in {steps} requests, {fleet_s:.2f} s (the "
        f"single server's run {single_s:.2f} s, 0 when farm_lifecycle_phase's was given); "
        f"PROMOTED on both replicas, the "
        f"artifact == the single server's; a kill at fleet.swap.commit flipped neither replica "
        f"and the restarted controller re-applied the flip on both ({card})")
    lap("fleet lifecycle")


def fleet_phase(port, L, card: str, lc_ref=None) -> dict:
    """Slice 7c at bench.py's shapes: the in-process fleet (4 replicas on
    the card, KMeans k=1024 at d=64; K1 in the fit, K2 in every served
    batch) against one server past saturation, the degradation curve, a
    routed trace, a failed and a clean swap and a replica kill under load,
    all under a stall watchdog; the multi-process fleet (1, 2 and 4 worker
    processes on the card, k=256 at d=32; K2 in every worker); the
    lifecycle over a 2-replica fleet; and K1 / K2 at the fleet's shapes
    against their plain versions.  → {"launches": the main path's K1 / K2
    launches (the workers' read from their pings), "k1": [...], "k2":
    [...]}."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve import fleet as F
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve.fleet import (
        proc as FP,
    )

    t_phase = time.perf_counter()
    ledger = LaunchLedger(L)
    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    with ledger.aside():
        k_fit = kernel_case(L, FLEET_N, FLEET_D, FLEET_K, 0, seed=21, reps=20)[0]
        k2_batch = k2_case(L, FLEET_BUCKETS[-1], FLEET_D, FLEET_K, seed=22, reps=200)
        k2_proc = k2_case(L, PROC_ROWS, PROC_D, PROC_K, seed=23, reps=200)
    shapes = {"k1": [{"n": FLEET_N, "d": FLEET_D, "k": FLEET_K, **{k: k_fit[k] for k in keys}}],
              "k2": [k2_batch, k2_proc]}
    lap("fleet kernels")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["CMLHN_FLIGHT_DIR"] = os.path.join(tmp, "flight")
        wd = F.StallWatchdog(window_s=FLEET_WATCH_S)
        with wd:
            inproc = fleet_in_process(port, F, card, wd)
            wd.check()
        check(wd.stalled() is None, "the stall watchdog declared a stall")
        say(f"fleet stall watchdog ({FLEET_WATCH_S} s window) over (a) and (b): no stall")
        procs = fleet_multiproc(port, F, FP, card)
        fleet_lifecycle(port, F, tmp, card, lc_ref)
        os.environ.pop("CMLHN_FLIGHT_DIR")
    launches = ledger.main_path()
    launches["fused_assign"] += procs["launches"]
    check(launches["fused_lloyd_stats"] > 0 and launches["fused_assign"] > 0,
          f"fleet_phase launches {launches}")
    say(f"fleet_phase: {time.perf_counter() - t_phase:.2f} s of host clock ({card}); "
        f"main-path launches {json.dumps(launches)} (K2 of it in the worker processes "
        f"{procs['launches']})")
    return {"launches": launches, **shapes}


# ------------------------------------- slices 7c-2 + 7d-1: federation, pipelined stream
FED_SILOS, FED_ROWS, FED_D, FED_K, FED_ITERS = 4, 500_000, 16, 64, 8   # bench.py _bench_federated
FED_SITES = ("fed.round.collect", "fed.round.merge", "fed.round.fit", "fed.round.broadcast")
#: federated against pooled KMeans on float rows: K1 sums a silo's rows in
#: its own block order, so the two differ by the sums' reassociation, and
#: over 8 rounds that moves rows between clusters; about 10x the first
#: run's gaps (my call 2: centers 1.949e-3 absolute, cost 3.16e-7
#: relative, 154 rows moved; NVIDIA H100 80GB HBM3, 700.00 W).  The
#: control, the silos' rows bf16-rounded, fails the cost limit (2.26e-5)
FED_GAP_LIMIT = {"centers": 0.02, "cost_rel": 3e-6, "moved": 1_500}
FED_GMM_SILOS, FED_GMM_ROWS, FED_GMM_D, FED_GMM_K = 4, 50_000, 8, 8
FED_LR_ROWS = 100_000                     # a hospital's CSV drop, 4 hospitals
#: x the largest coefficient: about 10x the first gap (1.67e-6, my call 2),
#: under the CPU tests' 1e-4; the Grams in TF32 (the control) read 9.1e-4
FED_LR_TOL = 2e-5
PIPE_FILES, PIPE_ROWS, PIPE_K = 10, 100_000, 8    # bench.py _bench_streaming_pipeline
PIPE_D = 4                                # the hospital FEATURE_COLS
PIPE_BAD = 10                             # planted garbage lines a drop (quarantine evidence)
PIPE_KILL_SITE, PIPE_KILL_AFTER = "stream.after_sink", 3
GBT_CENSUS_N = 200_000
#: the JAX package's GBT fit's stage names (models/tree/gbt.py), which
#: tests/test_torch_gbt.py holds the port's clock to on the CPU
JAX_GBT_STAGES = ["bin", "init", "boost", "fetch_materialize"]


def fed_silos(F, parts: list, order=None) -> list:
    """One ``Silo`` a row block (DeviceDatasets on the phase's device)."""
    silos = [F.Silo(f"s{i:02d}", ds, device=DEV) for i, ds in enumerate(parts)]
    return silos if order is None else [silos[i] for i in order]


def fed_cfg(F, **kw):
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils.retry import (
        RetryPolicy,
    )

    return F.FederatedConfig(retry=RetryPolicy(max_attempts=3, base_delay_s=0.0,
                                               max_delay_s=0.0),
                             breaker_recovery_s=0.0, **kw)


def same_kmeans(a, b) -> bool:
    import numpy as np

    return (np.array_equal(a.cluster_centers, b.cluster_centers)
            and float(a.training_cost) == float(b.training_cost) and a.n_iter == b.n_iter
            and np.array_equal(a.cluster_sizes, b.cluster_sizes))


def same_gmm(a, b) -> bool:
    import numpy as np

    return (all(np.array_equal(getattr(a, n), getattr(b, n))
                for n in ("weights", "means", "covariances"))
            and float(a.log_likelihood) == float(b.log_likelihood) and a.n_iter == b.n_iter)


def kmeans_gaps(a, b) -> dict:
    import numpy as np

    return {"centers": float(np.abs(a.cluster_centers - b.cluster_centers).max()),
            "cost_rel": abs(a.training_cost - b.training_cost) / abs(b.training_cost),
            "moved": int(np.abs(a.cluster_sizes - b.cluster_sizes).sum()) // 2}


def fed_trace(port, F, parts, tmp: str, k1_per_round: int) -> str:
    """``capture_trace`` of one federated round (and its closing collect)
    under ``trace_annotation("fed.round")``; checks that the Chrome trace
    holds K1's kernel events inside the annotation.  → the summary line."""
    import numpy as np
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import (
        profiling,
    )

    x0 = parts[0].x[:FED_K].cpu().numpy()
    one = port.KMeans(k=FED_K, max_iter=1, tol=0.0, warm_start_centers=x0, chunk_rows=FED_ROWS)
    log_dir = os.path.join(tmp, "trace")
    with profiling.capture_trace(log_dir) as prof:
        with profiling.trace_annotation("fed.round"):
            F.FederatedCoordinator(one, fed_silos(F, parts), fed_cfg(F), device=DEV).fit()
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    ann = [e for e in events if e.get("name") == "fed.round"]
    check(ann, "the trace holds no fed.round annotation")
    cpu_ann = min(ann, key=lambda e: e["ts"])
    lo, hi = cpu_ann["ts"], cpu_ann["ts"] + cpu_ann["dur"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kernels if "lloyd_kernel" in e["name"]]
    copies = [e for e in events if e.get("cat") in ("gpu_memcpy", "gpu_memset")]
    names = sorted({e.get("cat", "?") for e in ann})
    if DEV != "cuda":
        return f"trace (CPU rehearsal): {len(events)} events, annotation {names}"
    check(len(k1) == k1_per_round,
          f"the trace holds {len(k1)} K1 kernel events, expected {k1_per_round}")
    check(all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in k1),
          "a K1 kernel event lies outside the fed.round annotation")
    dev_us = sum(e["dur"] for e in kernels)
    k1_us = sum(e["dur"] for e in k1)
    top = sorted(((sum(e["dur"] for e in kernels if e["name"] == n), n)
                  for n in {e["name"] for e in kernels}), reverse=True)[:3]
    kav = prof.key_averages()
    dev_total = sum(getattr(a, "self_device_time_total", getattr(a, "self_cuda_time_total", 0))
                    for a in kav)
    return (f"trace of one federated round (+ its closing collect): annotation "
            f"{hi - lo:.0f} us of host clock, kinds {names}; {len(kernels)} kernel events "
            f"({dev_us:.1f} us on the card, {100 * dev_us / max(hi - lo, 1e-9):.2f} % of the "
            f"round), K1 {len(k1)} events {k1_us:.1f} us, all inside the annotation; "
            f"{len(copies)} copies / memsets; top kernels "
            + "; ".join(f"{re.sub(r'[(]anonymous namespace[)]::|^void ', '', n).split('(')[0]} "
                        f"{t:.1f} us" for t, n in top)
            + f"; key_averages device time {dev_total:.1f} us; {len(np.unique([e.get('tid') for e in kernels]))} stream(s)")


def fed_small_fits(port, F, tmp: str, card: str) -> None:
    """At a smaller size: federated GaussianMixture ``==`` its pooled warm
    fit (each silo one ``chunk_rows`` chunk); federated LinearRegression
    over one ``Silo.from_csv`` a hospital drop against the pooled fit,
    with a control; ``merged_profile`` against the pooled profile."""
    import numpy as np

    rng = np.random.default_rng(5)
    k, d, r = FED_GMM_K, FED_GMM_D, FED_GMM_ROWS
    c = rng.normal(0, 5, (k, d))
    gx = (c[rng.integers(0, k, FED_GMM_SILOS * r)] + rng.normal(size=(FED_GMM_SILOS * r, d))
          ).astype(np.float32)
    gm = port.GaussianMixture(k=k, max_iter=10, tol=1e-3, chunk_rows=r, warm_start_params=(
        np.full((k,), 1.0 / k, np.float32), gx[:k].copy(),
        np.stack([np.eye(d, dtype=np.float32) * 4.0] * k)))
    t0 = time.perf_counter()
    pooled = gm.fit(port.device_dataset(gx, device=DEV))
    sync()
    pooled_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fed = F.FederatedCoordinator(gm, fed_silos(F, [
        port.device_dataset(gx[i * r:(i + 1) * r], device=DEV) for i in range(FED_GMM_SILOS)]),
        fed_cfg(F), device=DEV).fit()
    fed_s = time.perf_counter() - t0
    check(same_gmm(fed.model, pooled), "federated GaussianMixture differs from its pooled fit")
    say(f"federated GaussianMixture k={k} on {FED_GMM_SILOS} x {r} x {d}: == the pooled warm "
        f"fit (n_iter {pooled.n_iter}, ll {pooled.log_likelihood:.9g}); pooled "
        f"{pooled_s:.3f} s, federated {fed_s:.3f} s ({card})")

    cols = hospital_events(FED_LR_ROWS, seed=11, hospitals=4)
    schema = port.hospital_event_schema()
    feats = list(port.FEATURE_COLS)
    silos = []
    t0 = time.perf_counter()
    for h in range(4):
        path = os.path.join(tmp, f"hospital-H{h:02d}.csv")
        write_events_csv(path, cols, h * FED_LR_ROWS, (h + 1) * FED_LR_ROWS)
        silos.append(F.Silo.from_csv(f"H{h:02d}", path, schema, feats,
                                     label_col=port.LABEL_COL,
                                     table_dir=os.path.join(tmp, f"silo-H{h:02d}"), device=DEV))
    ingest_s = time.perf_counter() - t0
    check([s.n_rows for s in silos] == [FED_LR_ROWS] * 4, "a hospital silo lost rows")
    x64 = np.concatenate([s.feature_matrix() for s in silos]).astype(np.float64)
    x = x64.astype(np.float32)
    y = np.concatenate([s.data.table.column(port.LABEL_COL) for s in silos]).astype(np.float32)
    est = port.LinearRegression(reg_param=0.1)
    pooled_lr = est.fit((x, y), device=DEV)
    fed_lr = F.FederatedCoordinator(est, silos, fed_cfg(F), device=DEV).fit().model

    def lr_gap(m) -> float:
        a = pooled_lr.coefficients.cpu().numpy()
        b = m.coefficients.cpu().numpy()
        scale = float(np.abs(a).max())
        return max(float(np.abs(a - b).max()), abs(float(pooled_lr.intercept) - float(m.intercept))
                   ) / scale

    gap = lr_gap(fed_lr)
    with tf32_matmuls():
        ctl = lr_gap(F.FederatedCoordinator(est, silos, fed_cfg(F), device=DEV).fit().model)
    check(gap <= FED_LR_TOL, f"federated LinearRegression {gap:.3g} of the largest coefficient "
          f"from the pooled fit (limit {FED_LR_TOL})")
    check(ctl > FED_LR_TOL, f"the control (the silos' Grams in TF32) passes the LR limit "
          f"({ctl:.3g})")
    say(f"federated LinearRegression over 4 hospital drops (Silo.from_csv: firewall -> "
        f"unbounded table -> assembler, {ingest_s:.2f} s for {4 * FED_LR_ROWS} rows): "
        f"{gap:.3g} of the largest coefficient from the pooled fit (limit {FED_LR_TOL}; "
        f"control, the silos' Grams in TF32, {ctl:.3g})")

    coord = F.FederatedCoordinator(est, silos, fed_cfg(F), device=DEV)
    prof = coord.merged_profile(names=feats)
    ref = port.DataProfile.from_matrix(x64, feats)
    worst = 0.0
    for j, name in enumerate(feats):
        a, b = prof.sketches[name], ref.sketches[name]
        check(a.count == b.count == float(len(x)) and a.min == b.min and a.max == b.max,
              f"merged profile {name}: count / min / max differ from the pooled profile")
        worst = max(worst, abs(a.mean - b.mean) / max(abs(b.mean), 1e-30),
                    abs(a.m2 - b.m2) / max(abs(b.m2), 1e-30))
    check(worst <= 1e-9, f"merged profile moments {worst:.3g} from the pooled profile's")
    say(f"merged_profile over the 4 hospitals: counts, min, max == the pooled profile's, "
        f"mean and m2 within {worst:.3g} relative (limit 1e-9: Chan's merge in float64)")


def federated_phase(port, ops, L, card: str) -> dict:
    """Slice 7c's federation at bench.py's federated shape: 4 silos x
    500,000 x 16 rows (``default_rng(0)``, the first half shifted by 4),
    KMeans k=64, 8 rounds, tol 0, warm-started on the first 64 rows,
    ``chunk_rows`` 500,000; each silo's rows a DeviceDataset on the card
    (K1 a silo a round, and in the closing collect), against the pooled
    fit (K1); determinism under a rerun, reverse registration, a dropout
    and a kill at each ``fed.round.*`` site; the smaller fits; a
    ``capture_trace`` of one round.  → {"launches": the main path's,
    "k1": [shape records]}."""
    import numpy as np
    import torch

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import (
        federated as F,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults

    t_phase = time.perf_counter()
    ledger = LaunchLedger(ops)
    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    shapes = []
    if DEV == "cuda":
        with ledger.aside():
            for n, seed in ((FED_ROWS, 31), (FED_SILOS * FED_ROWS, 32)):
                kr = kernel_case(L, n, FED_D, FED_K, 0, seed=seed, reps=20)[0]
                shapes.append({"n": n, "d": FED_D, "k": FED_K, **{key: kr[key] for key in keys}})
    lap("fed kernels")

    rng = np.random.default_rng(0)
    x = rng.normal(size=(FED_SILOS * FED_ROWS, FED_D)).astype(np.float32)
    x[: FED_SILOS * FED_ROWS // 2] += 4.0
    pooled_ds = port.device_dataset(x, device=DEV)
    parts = [port.device_dataset(x[i * FED_ROWS:(i + 1) * FED_ROWS], device=DEV)
             for i in range(FED_SILOS)]
    km = port.KMeans(k=FED_K, max_iter=FED_ITERS, tol=0.0, warm_start_centers=x[:FED_K].copy(),
                     chunk_rows=FED_ROWS)

    def fit(silos, cfg=None):
        return F.FederatedCoordinator(km, silos, cfg or fed_cfg(F), device=DEV).fit()

    k1 = lambda: ops.launch_counts()["fused_lloyd_stats"]  # noqa: E731
    sync()
    before = k1()
    t0 = time.perf_counter()
    pooled = km.fit(pooled_ds)
    sync()
    pooled_first_s = time.perf_counter() - t0
    k1_pooled = k1() - before
    silos = fed_silos(F, parts)
    t0 = time.perf_counter()
    res = fit(silos)
    sync()
    fed_first_s = time.perf_counter() - t0
    k1_fed = k1() - before - k1_pooled
    # warm: each path's torch kernels loaded by its first run
    t0 = time.perf_counter()
    pooled_again = km.fit(pooled_ds)
    sync()
    pooled_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = fit(fed_silos(F, parts))
    sync()
    fed_s = time.perf_counter() - t0
    check(same_kmeans(pooled_again, pooled), "two pooled card fits differ")
    check(same_kmeans(again.model, res.model), "two federated card fits differ")
    rounds = res.state.version
    if DEV == "cuda":
        check(k1_pooled == pooled.n_iter + 1,
              f"the pooled fit launched K1 {k1_pooled} times over {pooled.n_iter} steps")
        check(k1_fed == (rounds + 1) * FED_SILOS,
              f"the federated fit launched K1 {k1_fed} times: expected {rounds} rounds x "
              f"{FED_SILOS} silos + the closing collect's {FED_SILOS}")
    check(res.model.n_iter == pooled.n_iter == FED_ITERS,
          f"n_iter federated {res.model.n_iter}, pooled {pooled.n_iter}")
    check(all(s.compute_calls == rounds + 1 for s in silos),
          "a silo computed more than one partial a round")
    check(float(res.model.cluster_sizes.sum()) == float(len(x)), "federated sizes lose rows")
    t = {n: sum(getattr(r, "t_" + n) for r in res.rounds)
         for n in ("collect", "merge", "fit", "broadcast")}
    frac = (t["merge"] + t["broadcast"]) / max(sum(t.values()), 1e-12)
    gaps = kmeans_gaps(res.model, pooled)
    say(f"federated KMeans k={FED_K}: {FED_SILOS} silos x {FED_ROWS} x {FED_D} on the card; "
        f"pooled fit {pooled_s:.4f} s, federated {fed_s:.4f} s ({fed_s / pooled_s:.2f}x; "
        f"first runs {pooled_first_s:.4f} / {fed_first_s:.4f} s), "
        f"{len(res.rounds)} rounds ({rounds} + the closing collect); round seconds "
        + ", ".join(f"{n} {v:.4f}" for n, v in t.items())
        + f"; merge + broadcast {100 * frac:.3f} % of the rounds; K1 {k1_pooled} pooled, "
        f"{k1_fed} federated ({card})")
    with ledger.aside():
        ctl = fit(fed_silos(F, [port.device_dataset(bf16_round(x[i * FED_ROWS:(i + 1) * FED_ROWS]),
                                                    device=DEV) for i in range(FED_SILOS)]))
    ctl_gaps = kmeans_gaps(ctl.model, pooled)
    say(f"federated vs pooled: largest center gap {gaps['centers']:.4g}, cost gap "
        f"{gaps['cost_rel']:.4g} relative, rows moved {gaps['moved']} (limits "
        f"{FED_GAP_LIMIT}); the control, the silos' rows bf16-rounded: "
        + ", ".join(f"{key} {v:.4g}" for key, v in ctl_gaps.items()))
    check(all(gaps[key] <= FED_GAP_LIMIT[key] for key in FED_GAP_LIMIT),
          f"federated KMeans {gaps} from the pooled fit, limits {FED_GAP_LIMIT}")
    check(any(ctl_gaps[key] > FED_GAP_LIMIT[key] for key in FED_GAP_LIMIT),
          f"the bf16-rounded control {ctl_gaps} passes the limits {FED_GAP_LIMIT}")
    lap("fed fits")

    rev = fit(fed_silos(F, parts, order=list(reversed(range(FED_SILOS)))))
    check(same_kmeans(rev.model, res.model), "reverse registration changed the federated fit")
    plan = faults.FaultPlan().fail(F.FED_COLLECT_SITE, times=2,
                                   when=lambda ctx: ctx.get("silo") == "s01")
    drop_silos = fed_silos(F, parts)
    t0 = time.perf_counter()
    with faults.active(plan):
        drop = fit(drop_silos)
    sync()
    drop_s = time.perf_counter() - t0
    check(plan.fired(F.FED_COLLECT_SITE) == 2, "the dropout plan did not fire twice")
    check(same_kmeans(drop.model, res.model), "the dropout run differs from the clean fit")
    check(all(s.compute_calls == rounds + 1 for s in drop_silos),
          "a failed collect reached a silo's compute")
    with tempfile.TemporaryDirectory() as tmp:
        for site in FED_SITES:
            ksilos = fed_silos(F, parts)
            kcfg = fed_cfg(F, journal_dir=os.path.join(tmp, site))
            plan = faults.FaultPlan().crash(site)
            try:
                with faults.active(plan):
                    fit(ksilos, kcfg)
                fail(f"no crash at {site}")
            except faults.InjectedCrash:
                pass
            check(plan.fired(site) == 1, f"{site} fired {plan.fired(site)} times")
            resumed = fit(ksilos, kcfg)
            check(same_kmeans(resumed.model, res.model),
                  f"killed at {site} and resumed, the fit differs from the clean one")
            check(all(s.compute_calls == rounds + 1 for s in ksilos),
                  f"killed at {site}: a silo recomputed a banked partial")
        say(f"federated determinism on the card: a rerun, reverse registration, s01 failing "
            f"twice in its first collect (overhead {100 * (drop_s / fed_s - 1):.1f} %, "
            f"{drop_s:.3f} s) and a kill at each of {', '.join(FED_SITES)} with resume: each "
            f"bit-equal to the clean fit; no silo computed a partial twice")
        lap("fed determinism")
        fed_small_fits(port, F, tmp, card)
        lap("fed small fits")
        if DEV == "cuda":
            say(fed_trace(port, F, parts, tmp, 2 * FED_SILOS))
        lap("fed trace")
    launches = ledger.main_path()
    say(f"federated_phase: {time.perf_counter() - t_phase:.2f} s of host clock ({card}); "
        f"main-path launches {json.dumps(launches)}")
    del pooled_ds, parts
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "k1": shapes}


def pipe_fleet(incoming: str) -> int:
    """bench.py's ``_pipeline_csv_fleet`` (seed 0, hospital ``H{i % 4}``,
    2026-01-01 onward, one second a row) as ``PIPE_FILES`` drops of
    ``PIPE_ROWS`` rows, each with ``PIPE_BAD`` lines replaced by garbage
    the firewall must quarantine.  → the clean rows."""
    import numpy as np

    rng = np.random.default_rng(0)
    base = np.datetime64("2026-01-01T00:00:00")
    bad = np.random.default_rng(1)
    for i in range(PIPE_FILES):
        n = PIPE_ROWS
        cols = {
            "hospital_id": np.array([f"H{i % 4:02d}"] * n, dtype=object),
            "event_time": base + (np.arange(n) + i * n).astype("timedelta64[s]"),
            "admission_count": rng.integers(0, 50, n),
            "current_occupancy": rng.integers(20, 200, n),
            "emergency_visits": rng.integers(0, 30, n),
            "seasonality_index": np.round(rng.uniform(0.5, 1.5, n), 4),
            "length_of_stay": np.round(rng.uniform(1.0, 9.0, n), 4),
        }
        path = os.path.join(incoming, f"drop-{i:03d}.csv")
        write_events_csv(path + ".tmp", cols, 0, n)
        with open(path + ".tmp") as f:
            lines = f.read().split("\n")
        for j in bad.choice(np.arange(1, n + 1), size=PIPE_BAD, replace=False):
            lines[j] = f"H{i % 4:02d},2026-01-01 00:00:00,banana,100,5,1.0,4.0"
        with open(path + ".tmp", "w") as f:
            f.write("\n".join(lines))
        os.replace(path + ".tmp", path)
        os.utime(path, ns=(10**18 + i, 10**18 + i))
    return PIPE_FILES * (PIPE_ROWS - PIPE_BAD)


def pipe_run(port, incoming: str, sub: str, pipelined: bool, centers0, kill: bool = False):
    """One pass of the fleet through the serial or the pipelined stream
    (firewall on, ``max_files_per_batch=1``), StreamingKMeans k=8 on the
    card from ``centers0`` (through a ``ModelUpdateConsumer`` when
    pipelined).  With ``kill``, crash at ``PIPE_KILL_SITE`` after
    ``PIPE_KILL_AFTER`` batches and resume in a fresh pipelined stream.
    → (stream, model, infos, wall s)."""
    import numpy as np

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults

    S = port.streaming
    schema = port.hospital_event_schema()
    feats = list(port.FEATURE_COLS)

    def stream():
        kw = dict(source=S.FileStreamSource(incoming, schema, max_files_per_batch=1),
                  sink=S.UnboundedTable(os.path.join(sub, "table"), schema),
                  checkpoint=S.StreamCheckpoint(os.path.join(sub, "ckpt")),
                  firewall=port.DataFirewall(schema), device=DEV)
        if not pipelined:
            return S.StreamExecution(foreach_batch=lambda t, b: sk.update(
                t.numeric_matrix(feats).astype(np.float32), device=DEV), **kw), None
        ex = S.PipelinedStreamExecution(pipeline_depth=2, **kw)
        ex.stage = lambda t: t.numeric_matrix(feats).astype(np.float32)
        cons = S.ModelUpdateConsumer(sk, pipeline=ex, device=DEV)
        ex.foreach_batch = cons
        return ex, cons

    sk = port.StreamingKMeans(k=PIPE_K, seed=0)
    sk.set_initial_centers(centers0)
    ex, cons = stream()
    infos = []
    sync()
    t0 = time.perf_counter()
    try:
        if kill:
            for _ in range(PIPE_KILL_AFTER):
                infos.append(ex.run_once())
            plan = faults.FaultPlan().crash(PIPE_KILL_SITE)
            try:
                with faults.active(plan):
                    ex.run_once()
                fail(f"the pipelined stream did not crash at {PIPE_KILL_SITE}")
            except faults.InjectedCrash:
                pass
            check(plan.fired(PIPE_KILL_SITE) == 1, "the stream's kill fired more than once")
            ex.close()
            ex, cons = stream()
            while (info := ex.run_once()) is not None:
                infos.append(info)
        else:
            infos = ex.run(max_batches=PIPE_FILES, timeout_s=600.0)
        if cons is not None:
            cons.flush()
        sync()
    finally:
        if pipelined:
            ex.close()
    return ex, sk, infos, time.perf_counter() - t0


def pipeline_stream_phase(port, ops, L, card: str) -> dict:
    """Slice 7d's pipelined stream at bench.py's streaming-pipeline shape
    (10 hospital drops of 100,000 rows, ``max_files_per_batch=1``, the
    firewall on, 10 garbage lines a drop; StreamingKMeans k=8, K1 a batch):
    serial and pipelined ``==`` in batches, sink rows, quarantine evidence,
    WAL lines and final centers; the pipelined stream killed at
    ``stream.after_sink`` and resumed exactly once; the stage clock's
    shares; ``host_sync_census`` (syncs and host→device copies) on a GBT
    fit with ``stage_clock=``.  → {"launches": ..., "k1": [shape record]}."""
    import numpy as np

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.streaming.wal import (
        read_lines,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import (
        profiling,
    )

    t_phase = time.perf_counter()
    ledger = LaunchLedger(ops)
    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    shapes = []
    if DEV == "cuda":
        with ledger.aside():
            kr = kernel_case(L, PIPE_ROWS, PIPE_D, PIPE_K, 0, seed=33, reps=50)[0]
            shapes.append({"n": PIPE_ROWS, "d": PIPE_D, "k": PIPE_K,
                           **{key: kr[key] for key in keys}})
    with tempfile.TemporaryDirectory() as tmp:
        incoming = os.path.join(tmp, "incoming")
        os.makedirs(incoming)
        t0 = time.perf_counter()
        clean = pipe_fleet(incoming)
        say(f"pipelined stream: {PIPE_FILES} drops x {PIPE_ROWS} rows written in "
            f"{time.perf_counter() - t0:.2f} s ({PIPE_BAD} garbage lines a drop)")
        lap("pipe fleet")
        centers0 = np.random.default_rng(0).normal(size=(PIPE_K, PIPE_D)).astype(np.float32)
        before = ops.launch_counts()["fused_lloyd_stats"]
        ser, sk_s, infos_s, ser_s = pipe_run(port, incoming, os.path.join(tmp, "serial"), False,
                                             centers0)
        pipe, sk_p, infos_p, pipe_s = pipe_run(port, incoming, os.path.join(tmp, "pipe"), True,
                                               centers0)
        k1_runs = ops.launch_counts()["fused_lloyd_stats"] - before
        lap("pipe runs")

        def info_rows(infos):
            return [(i.batch_id, i.num_input_rows, i.num_appended_rows, i.num_rejected_rows,
                     os.path.basename(i.files[0]), i.status) for i in infos]

        check(all(i.status == "ok" for i in infos_s + infos_p),
              "a stream quarantined a batch (its update failed)")
        check(info_rows(infos_s) == info_rows(infos_p), "serial and pipelined batches differ")
        check(sum(i.num_appended_rows for i in infos_p) == clean,
              f"the pipelined stream appended {sum(i.num_appended_rows for i in infos_p)} rows, "
              f"expected {clean}")
        a, b = ser.sink.read(), pipe.sink.read()
        diff = [n for n in a.schema.names if n != "ingest_time" and columns_differ(a[n], b[n])]
        check(a.num_rows == b.num_rows == clean and not diff,
              f"serial and pipelined sinks differ in {diff}")

        def strip(recs):
            return [{k: v for k, v in r.items() if k != "quarantined_at"} for r in recs]

        check(strip(ser.checkpoint.quarantined_rows()) == strip(pipe.checkpoint.quarantined_rows())
              and ser.checkpoint.row_reason_histogram() == pipe.checkpoint.row_reason_histogram()
              and pipe.checkpoint.quarantined_row_count() == PIPE_FILES * PIPE_BAD,
              "serial and pipelined quarantine evidence differ")
        for log in ("offsets.log", "commits.log"):
            check(read_lines(os.path.join(ser.checkpoint.path, log))
                  == read_lines(os.path.join(pipe.checkpoint.path, log)),
                  f"serial and pipelined {log} differ")
        check(np.array_equal(sk_s.latest_model.cluster_centers, sk_p.latest_model.cluster_centers)
              and np.array_equal(sk_s.latest_model.cluster_weights,
                                 sk_p.latest_model.cluster_weights),
              "serial and pipelined StreamingKMeans states differ")
        if DEV == "cuda":
            check(k1_runs == 2 * PIPE_FILES, f"the two streams launched K1 {k1_runs} times, "
                  f"expected one a batch ({2 * PIPE_FILES})")
        secs = dict(pipe.clock.seconds)
        shares = pipe.clock.shares()
        say(f"serial {clean / ser_s:,.0f} rows/s ({ser_s:.3f} s), pipelined "
            f"{clean / pipe_s:,.0f} rows/s ({pipe_s:.3f} s): pipelined / serial "
            f"{ser_s / pipe_s:.3f}x; == in batches, {clean} sink rows, "
            f"{PIPE_FILES * PIPE_BAD} quarantined rows, WAL lines and centers; stage seconds "
            + ", ".join(f"{k} {v:.3f}" for k, v in sorted(secs.items()))
            + f" (sum {sum(secs.values()):.3f} s against {pipe_s:.3f} s wall), shares "
            + ", ".join(f"{k} {v:.3f}" for k, v in shares.items())
            + f"; K1 {k1_runs} ({card})")
        kex, _, kinfos, kill_s = pipe_run(port, incoming, os.path.join(tmp, "kill"), True,
                                          centers0, kill=True)
        rows = kex.sink.read().num_rows
        check(all(i.status == "ok" for i in kinfos), "the killed stream quarantined a batch")
        check(rows == clean and kex.sink.max_batch_id() == PIPE_FILES - 1
              and kex.checkpoint.quarantine_count() == 0
              and kex.checkpoint.quarantined_row_count() == PIPE_FILES * PIPE_BAD,
              f"killed at {PIPE_KILL_SITE} and resumed: {rows} rows (expected {clean}), last "
              f"batch {kex.sink.max_batch_id()}, quarantined rows "
              f"{kex.checkpoint.quarantined_row_count()}")
        say(f"pipelined stream killed at {PIPE_KILL_SITE} after batch {PIPE_KILL_AFTER} and "
            f"resumed in a fresh stream: every row exactly once ({rows}), batches 0-"
            f"{PIPE_FILES - 1}, the planted rows quarantined once, {kill_s:.2f} s")
        lap("pipe kill")

    rng = np.random.default_rng(0)
    gx = rng.normal(size=(GBT_CENSUS_N, D)).astype(np.float32)
    gy = (gx @ rng.normal(size=(D,)) + rng.normal(0.0, 0.3, GBT_CENSUS_N)).astype(np.float32)
    clock = profiling.StageClock()
    est = port.GBTRegressor(max_iter=5, max_depth=3, seed=0, stage_clock=clock)
    with profiling.host_sync_census(count_puts=True) as census:
        gbt = est.fit((gx, gy), device=DEV)
    check(list(clock.counts) == JAX_GBT_STAGES and set(clock.counts.values()) == {1},
          f"the GBT stage clock recorded {clock.counts}, the JAX fit's are {JAX_GBT_STAGES}")
    check(gbt.num_trees == 5, "the clocked GBT fit grew the wrong number of trees")
    import torch

    with profiling.host_sync_census(count_puts=True) as puts:
        for i in range(3):
            torch.from_numpy(gx[:1000 * (i + 1)]).to(DEV)
        torch.tensor(gy[:10], device=DEV)
        torch.ones(4, device=DEV).sum()
    want = 4 if DEV == "cuda" else 0
    check(puts["device_put"] == want,
          f"the census counted {puts} for four host->device copies (expected {want} puts)")
    say(f"host_sync_census on GBTRegressor(5 rounds, depth 3) at {GBT_CENSUS_N} x {D} with "
        f"stage_clock=: {census['device_get']} host syncs, {census['device_put']} host->device "
        f"copies; stages {clock.counts} (the JAX fit's names), shares "
        + ", ".join(f"{k} {v:.3f}" for k, v in clock.shares().items())
        + f"; the census on 3 .to() copies, a torch.tensor(device=) and an on-card sum: "
        f"{puts['device_put']} puts, {puts['device_get']} syncs (a blocking copy waits for the "
        f"card's stream)")
    lap("pipe census")
    launches = ledger.main_path()
    say(f"pipeline_stream_phase: {time.perf_counter() - t_phase:.2f} s of host clock ({card}); "
        f"main-path launches {json.dumps(launches)}")
    return {"launches": launches, "k1": shapes}



SOAK_CLI_SEED = 4242                      # the unseen seed the CLI runs in fresh processes
SOAK_CLI_TIMEOUT = 300                    # seconds each CLI process may take
SOAK_LEAK_BYTES = 1 << 20                 # device bytes a second smoke day may hold beyond the first


def soak_day_lines(payload: dict, what: str, card: str) -> None:
    """Print one day's wall seconds, phases, chaos, footprint, trace and
    retune, each on its own line."""
    res = payload["resources"]
    say(f"soak {what}: wall_s {payload['wall_s']} ({card}); phases "
        + "; ".join(f"{p['name']} offered rows {p['offered_rows']}, goodput "
                    f"{p['goodput_frac']} against floor {p['min_goodput_frac']}, unanswered "
                    f"{p['unanswered']}, in-SLO p99 {p['in_slo_p99_ms']} ms, phase wall "
                    f"{p['wall_s']} s" for p in payload["phases"]))
    say(f"soak {what}: {len(payload['kills'])} chaos events, "
        f"{sum(k['recovered'] for k in payload['kills'])} recovered, "
        f"{sum(len(k['postmortems']) for k in payload['kills'])} postmortems; "
        + ", ".join(f"{k['label']} ({len(k['postmortems'])} pm"
                    + (f", bit_identical {k['bit_identical']}" if "bit_identical" in k else "")
                    + ")" for k in payload["kills"]))
    say(f"soak {what}: RSS first {res['rss_first_kb'] / 1024:.1f} MiB, last "
        f"{res['rss_last_kb'] / 1024:.1f} MiB (ratio "
        f"{res['rss_last_kb'] / max(res['rss_first_kb'], 1.0):.3f}, ceiling "
        f"{payload['config']['rss_growth_ratio']}), disk {res['disk_last_kb'] / 1024:.2f} MB, "
        f"series {res['series_last']}, table at most "
        f"{max(x.get('table_kb', 0.0) for x in res['samples']) / 1024:.2f} MiB of "
        f"{payload['config']['table_budget_mb']}; ingest {json.dumps(payload['ingest'])}; "
        f"fleet {json.dumps(payload['fleet_health'])}")
    rt = payload["retune"] or {}
    say(f"soak {what}: trace {payload['trace'].get('trace_id')} spans "
        f"{payload['trace'].get('span_names')}; retune after "
        f"{rt.get('boundary_after_phase')}: {rt.get('old')} -> {rt.get('new')} ms, applied "
        f"{rt.get('applied')}, probe rps {rt.get('probe_rps')}, journal "
        f"{rt.get('journal_kinds')}")


def soak_day_checks(soak, payload: dict, path: str, what: str) -> None:
    """The machine check, the report read back, a flipped byte refused,
    every kill recovered, a bit-identical double kill and the schedule
    re-derived from the report's own config."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.soak.schedule import (
        SoakConfig,
    )

    violations = soak.check_report(payload)
    check(violations == [], f"soak {what}: check_report found {violations}")
    check(soak.read_report(path) == json.loads(json.dumps(payload, default=str)),
          f"soak {what}: read_report does not give back the payload")
    with open(path, "rb") as f:
        data = bytearray(f.read())
    i = data.index(b'"wall_s":') + len(b'"wall_s":')
    data[i] = ord("8") if data[i] == ord("9") else ord("9")
    flipped = path + ".flipped"
    with open(flipped, "wb") as f:
        f.write(bytes(data))
    try:
        soak.read_report(flipped)
        refused = False
    except ValueError:
        refused = True
    check(refused, f"soak {what}: a report with one flipped byte was read")
    check(all(k["recovered"] for k in payload["kills"]), f"soak {what}: a kill not recovered")
    check(any(k["kind"] == soak.KIND_DOUBLE_KILL and k.get("bit_identical") is True
              for k in payload["kills"]), f"soak {what}: no bit-identical double kill")
    rebuilt = [e.to_dict() for e in soak.build_chaos_schedule(
        SoakConfig.from_dict(payload["config"]))]
    check(rebuilt == payload["chaos_schedule"],
          f"soak {what}: the schedule rebuilt from the report's config differs")


def soak_phase(port, card: str) -> dict:
    """Slice 7d-2's compressed production day on the card: bench.py's soak
    shape (``SMOKE_CONFIG``) twice, then the reference's slow full day
    (``full_config(1107)``), each machine-checked clean with a
    bit-identical double kill; the two smoke days compared; the day-zero
    farm fitted again on the CPU ``==`` the card's saved artifact; an
    unseen seed through the CLI in two fresh processes; the device memory
    after each day.  The day launches no kernel (the farm and the views
    are torch ops): the K1/K2/K3 counts must not move.  → {"launches": ...}."""
    import gc

    import numpy as np
    import torch

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import ops
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import soak
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.soak import driver
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.soak.schedule import (
        full_config,
    )

    t_phase = time.perf_counter()
    before = ops.launch_counts()
    # the earlier phases' heap is the harness's, not the day's: frozen out
    # of the collector, so a full collection during the day walks only what
    # the day allocates (a fresh soak process has no such heap)
    gc.collect()
    gc.freeze()
    runs = []
    alloc = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (what, cfg) in enumerate((("smoke 1", soak.SMOKE_CONFIG),
                                         ("smoke 2", soak.SMOKE_CONFIG),
                                         ("full", full_config(1107)))):
            work = os.path.join(tmp, f"day{i}")
            if DEV == "cuda":
                torch.cuda.reset_peak_memory_stats()
            payload, path = soak.run_soak(cfg, work, device=DEV)
            gc.collect()
            if DEV == "cuda":
                torch.cuda.synchronize()
                alloc.append(torch.cuda.memory_allocated())
                say(f"soak {what}: device memory after the day {alloc[-1]} bytes allocated, "
                    f"peak {torch.cuda.max_memory_allocated()} bytes during it")
            soak_day_lines(payload, what, card)
            soak_day_checks(soak, payload, path, what)
            runs.append((payload, work))
            lap(f"soak {what}")
        (one, work1), (two, _), _ = runs
        same = {
            "chaos schedule": one["chaos_schedule"] == two["chaos_schedule"],
            "kill labels": [k["label"] for k in one["kills"]] == [k["label"] for k in two["kills"]],
            "offered rows": [p["offered_rows"] for p in one["phases"]]
            == [p["offered_rows"] for p in two["phases"]],
            "csv files": one["ingest"]["csv_files"] == two["ingest"]["csv_files"],
            "rows quarantined": one["ingest"]["rows_quarantined"]
            == two["ingest"]["rows_quarantined"],
        }
        check(all(same.values()), f"the two smoke days differ: {same}")
        if DEV == "cuda":
            check(alloc[1] - alloc[0] <= SOAK_LEAK_BYTES,
                  f"the second smoke day left {alloc[1] - alloc[0]} more device bytes allocated "
                  f"than the first (bound {SOAK_LEAK_BYTES})")
        say(f"soak smoke 1 == smoke 2 in {', '.join(same)}; device bytes allocated after each "
            f"day {alloc} (second minus first {alloc[1] - alloc[0] if alloc else 'n/a'}, "
            f"bound {SOAK_LEAK_BYTES})")

        # the day-zero farm again on the CPU from a fresh run's first draws
        cfg = soak.SMOKE_CONFIG
        pools = driver._SoakRun(cfg, os.path.join(tmp, "cpu"), device="cpu").day_zero_pools()
        cpu = port.farm.FarmKMeans(
            k=cfg.kmeans_k, max_iter=cfg.kmeans_iters, seed=cfg.seed,
            feature_names=list(driver.FEATURES)).fit(pools, device="cpu")
        saved = port.load_model(os.path.join(work1, "models", "farm-day0"))
        differ = sorted(k for k in set(cpu.arrays) | set(saved.arrays)
                        if k not in cpu.arrays or k not in saved.arrays
                        or not np.array_equal(cpu.arrays[k], saved.arrays[k]))
        check(not differ, f"the card's day-zero farm differs from the CPU fit in {differ}")
        say(f"soak day-zero farm: the card's saved models/farm-day0 == the CPU fit on the same "
            f"pools in all {len(cpu.arrays)} arrays ({', '.join(sorted(cpu.arrays))})")

        # an unseen seed through the CLI, each step in a fresh process
        cli = os.path.join(tmp, "cli")
        steps = (["--seed", str(SOAK_CLI_SEED), "--workdir", cli],
                 ["--check", os.path.join(cli, "soak_report.json")])
        for argv in steps:
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-m", f"{PKG}.soak", *argv]
                                 + (["--device", "cpu"] if DEV != "cuda" else []),
                                 cwd=ROOT, capture_output=True, text=True,
                                 timeout=SOAK_CLI_TIMEOUT)
            verdict = [ln for ln in out.stdout.splitlines() if ln.startswith(("PASS", "FAIL"))]
            check(out.returncode == 0 and verdict and verdict[0].startswith("PASS"),
                  f"the soak CLI {' '.join(argv)} exited {out.returncode}: {verdict} "
                  f"{out.stdout[-2000:]} {out.stderr[-2000:]}")
            say(f"soak CLI {' '.join(argv[:2])}: exit 0, {verdict[0]} "
                f"({time.perf_counter() - t0:.2f} s in a fresh process)")
        soak_day_lines(soak.read_report(os.path.join(cli, "soak_report.json")),
                       f"CLI seed {SOAK_CLI_SEED}", card)
        lap("soak cli")
    gc.unfreeze()
    after = ops.launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    check(all(v == 0 for v in launches.values()),
          f"the soak day launched kernels {launches}: its farm, views and serving are torch ops")
    say(f"soak_phase: {time.perf_counter() - t_phase:.2f} s of host clock ({card}); K1/K2/K3 "
        f"launches over the phase {json.dumps(launches)} (the day's farm fits, refits, views "
        f"and served batches are torch ops)")
    return {"launches": launches}


# ------------------------------------------------------------- slice 8a
MESH_DATA = 4                 # leg (b): a (4, 1) mesh over cuda:0, 2.5M rows a shard
MESH_PROC_N = 2_000_000       # legs (d)-(f): the main path's first 2M rows
MESH_HOSPITALS = 64           # leg (f): hospital ids over those rows
MESH_EXACT_N = 2_000_000      # leg (b)'s integer-valued rows
MESH_JOIN_S = 240             # seconds the spawned legs may take, start-up included
#: a sharded fit against the unsharded one: the out-of-core limits, set for
#: the same kind of reassociated K1 sums (read 2.26e-4 / 0 there)
MESH_TOL = {"centers": OOC_KMEANS_TOL["centers"], "cost_rel": OOC_KMEANS_TOL["cost_rel"]}


def mesh_rank_main(rank: int, world: int, store: str, backend: str, dev: str, rows_path: str,
                   warm_path: str, out_path: str) -> None:
    """One spawned process of ``mesh_phase``: joins a ``world``-process
    group through the ``file://`` store on ``dev`` (cuda:0), fits KMeans k=256 on its
    shard of the host-major (world, 1) mesh from the warm centers, and
    pickles what it saw to ``out_path`` (an exception is its result)."""
    import pickle

    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import (
        KMeans,
        MeshConfig,
        build_mesh,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import lloyd as L
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.parallel import (
        distributed,
    )

    res = {"rank": rank}
    try:
        ctx = distributed.initialize(f"file://{store}", world, rank, backend=backend, device=dev)
        res.update(backend=ctx.backend, world=ctx.num_processes)
        mesh = distributed.cluster_mesh() or build_mesh(MeshConfig(data=1), [dev])
        x, warm = np.load(rows_path), np.load(warm_path)
        before = L.launch_counts()
        if dev != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = KMeans(k=len(warm), seed=SEED, max_iter=MAX_ITER,
                   warm_start_centers=warm).fit(x, mesh=mesh)
        if dev != "cpu":
            torch.cuda.synchronize()
        res.update(fit_s=time.perf_counter() - t0, model=m, owned=mesh.local_data_shards(),
                   mesh=dict(mesh.shape),
                   launches={k: v - before[k] for k, v in L.launch_counts().items()})
        if backend == "gloo":
            # slice 8b-1 (f): the JAX package's cross-process phases on these rows
            from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import (
                tree_hist as H,
            )

            k3 = H.launch_counts()["fused_level_hist"]
            t0 = time.perf_counter()
            res["phases"] = mesh_model_phases(x, mesh)
            res.update(phases_s=time.perf_counter() - t0,
                       phases_k3=H.launch_counts()["fused_level_hist"] - k3)
    except Exception as e:  # noqa: BLE001 - the parent checks what each rank met
        res["error"] = f"{type(e).__name__}: {e}"
    try:
        distributed.shutdown()
    except Exception as e:  # noqa: BLE001
        res["shutdown_error"] = f"{type(e).__name__}: {e}"
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
    sys.stdout.flush()
    os._exit(0)   # a refused NCCL communicator must not hold the exit


def mesh_case(L, x, w, centers, c_valid, tag: str, reps: int = 20) -> tuple[dict, dict]:
    """K1 and K2 against their plain versions on one shard's own inputs
    (``compare``), with their times.  → (K1 shape record, K2 shape record)."""
    n, d = x.shape
    k = centers.shape[0]
    k1_err, k2_err, cost_rel, flips = compare(L, x, w, centers, c_valid, tag)
    t = kernel_times(L, x, w, centers, c_valid, reps)
    b1, b1_by = bound_ms(n, d, k, stats=True)
    b2, b2_by = bound_ms(n, d, k, stats=False)
    say(f"  shard {tag}: K1 {t['k1']:.4f} ms (plain {t['k1_plain']:.4f}, library "
        f"{t['k1_lib']:.4f}, bound {b1:.4f} by {b1_by}; max_abs_err {k1_err:.3g}, cost rel err "
        f"{cost_rel:.3g}) | K2 {t['k2']:.4f} ms (plain {t['k2_plain']:.4f}, library "
        f"{t['k2_lib']:.4f}, bound {b2:.4f} by {b2_by}; max_abs_err {k2_err:.3g}, {flips} "
        f"near-tie flips) — ok")
    shape = {"n": n, "d": d, "k": k}
    return ({**shape, "max_abs_err": k1_err, "ms": t["k1"], "plain_ms": t["k1_plain"],
             "library_ms": t["k1_lib"], "bound_ms": b1, "bound_by": b1_by},
            {**shape, "max_abs_err": k2_err, "ms": t["k2"], "plain_ms": t["k2_plain"],
             "library_ms": t["k2_lib"], "bound_ms": b2, "bound_by": b2_by})


def mesh_phase(port, L, card: str, ds, model, init, sil: float) -> dict:
    """Slice 8a: KMeans k=256 over a (data, model) mesh on the card,
    warm-started from the main path's init centers ``init``, on its 10M
    standardized rows ``ds`` (each shard a view of them):

    (a) a (1, 1) mesh == the main path's ``model`` bit for bit, n_iter + 1
        K1 launches; (b) a (4, 1) mesh over ``[cuda:0] * 4``: 4 K1 launches
        a step at 2.5M x 8 x 256, against (a) within ``MESH_TOL`` beside its
        control (the same fit on bf16-rounded rows, which must fail it),
        ``==`` on integer-valued rows, predict / compute_cost / silhouette
        shard by shard; (c) a (2, 2) mesh: K2 then the owner-masked K1 a
        shard at 5M x 8 x 128, the K1 counts summed over the model shards
        == the bincount of K2's global argmin, against (b) within the
        limits; (d) two spawned processes on the one card, a (2, 1) mesh
        over gloo (named: NCCL refuses two ranks on one card, and that
        refusal is checked), both ranks ``==`` the in-process (2, 1) fit on
        the same 2M rows; (e) one spawned process over NCCL at world size
        1, its (1, 1) fit through the NCCL all_gather ``==`` the in-process
        fit; (f) ``federated_dataset`` over a (4, 1) mesh of the 2M rows
        under 64 hospital ids, balanced, within the limits of the
        ingest-order (4, 1) fit.  → {"launches": the main path's, "k1",
        "k2": shape records}."""
    import pickle

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel as P
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.parallel import sharding

    t_phase = time.perf_counter()
    ledger = LaunchLedger(L)
    cuda0 = torch.device("cuda", 0) if DEV == "cuda" else torch.device(DEV)
    counts = L.launch_counts

    def fit(data, warm=init, **kw):
        sync()
        t0 = time.perf_counter()
        m = port.KMeans(k=K, seed=SEED, max_iter=MAX_ITER, warm_start_centers=warm).fit(data, **kw)
        sync()
        return m, time.perf_counter() - t0

    def gated(gaps: dict) -> bool:
        return all(gaps[key] <= MESH_TOL[key] for key in MESH_TOL)

    def mesh(data: int, model: int = 1):
        return P.build_mesh(port.MeshConfig(data=data, model=model), [cuda0] * (data * model))

    k1_shapes, k2_shapes = [], []
    with tempfile.TemporaryDirectory() as tmp:
        # ------------------- the spawned legs first: their start-up overlaps
        x2 = ds.x[:MESH_PROC_N].cpu().numpy()
        rows_path, warm_path = os.path.join(tmp, "rows.npy"), os.path.join(tmp, "warm.npy")
        np.save(rows_path, x2)
        np.save(warm_path, np.asarray(init, np.float32))
        spawn = mp.get_context("spawn")      # the parent's CUDA context exists: never fork
        procs = {}
        for leg, world, backend in (("gloo", 2, "gloo"), ("nccl1", 1, "nccl"),
                                    ("refused", 2, "nccl")):
            for r in range(world):
                out = os.path.join(tmp, f"{leg}{r}.pkl")
                p = spawn.Process(target=mesh_rank_main, args=(
                    r, world, os.path.join(tmp, f"store_{leg}"), backend, str(cuda0), rows_path,
                    warm_path, out))
                p.start()
                procs[leg, r] = (p, out)
        t_spawn = time.perf_counter()
        lap("mesh spawn")

        # ---------------------------------------------------- (a) (1, 1)
        before = counts()
        m_a, s_a = fit(ds, mesh=P.build_mesh(port.MeshConfig(data=1), [cuda0]))
        k1_a = counts()["fused_lloyd_stats"] - before["fused_lloyd_stats"]
        check(same_kmeans(m_a, model), "the (1, 1) mesh fit differs from the main path's fit")
        check(k1_a == m_a.n_iter + 1, f"the (1, 1) fit launched K1 {k1_a} times")
        say(f"mesh (a) (1, 1) over cuda:0: fit {s_a:.4f} s warm, n_iter {m_a.n_iter}, "
            f"{N * m_a.n_iter / s_a:.4g} Lloyd records/s, K1 {k1_a} launches; == the main "
            f"path's model bit for bit ({card})")
        lap("mesh (a)")

        # ---------------------------------------------------- (b) (4, 1)
        mesh4 = mesh(MESH_DATA)
        sds4 = sharding.shard_dataset(ds, mesh4)
        per = N // MESH_DATA
        check(all(s.x.data_ptr() == ds.x[i * per:].data_ptr() for i, s in enumerate(sds4.shards)),
              "a shard of the (4, 1) mesh is a copy, not a view of the rows")
        before = counts()
        m_b, s_b = fit(sds4)
        k1_b = counts()["fused_lloyd_stats"] - before["fused_lloyd_stats"]
        check(k1_b == MESH_DATA * (m_b.n_iter + 1),
              f"the (4, 1) fit launched K1 {k1_b} times over {m_b.n_iter} steps")
        gaps_b = kmeans_gaps(m_b, m_a)
        with ledger.aside():
            xr = ds.x.to(torch.bfloat16).to(torch.float32)
            ctl, _ = fit(sharding.shard_dataset(port.DeviceDataset(xr, ds.y, ds.w), mesh4))
            del xr
        ctl_gaps = kmeans_gaps(ctl, m_a)
        say(f"mesh (b) (4, 1) over [cuda:0] * 4: fit {s_b:.4f} s warm, n_iter {m_b.n_iter}, "
            f"{N * m_b.n_iter / s_b:.4g} Lloyd records/s, K1 {k1_b} launches (4 a step at "
            f"{per} x {D} x {K}); vs (a): " + as_text(gaps_b) + f" (limits {MESH_TOL}); the "
            f"control, the rows bf16-rounded: " + as_text(ctl_gaps))
        check(m_b.n_iter == m_a.n_iter and gated(gaps_b),
              f"(4, 1) vs (1, 1): n_iter {m_b.n_iter} / {m_a.n_iter}, {gaps_b}")
        check(not gated(ctl_gaps), f"the bf16-rounded control {ctl_gaps} passes {MESH_TOL}")
        before = counts()
        pred_b = m_b.predict(sds4.x)
        cost_b = m_b.compute_cost(sds4)
        sil_b = port.ClusteringEvaluator().evaluate(sds4, pred_b, k=K)
        sync()
        k2_b = counts()["fused_assign"] - before["fused_assign"]
        check(k2_b == 2 * MESH_DATA, f"predict + compute_cost launched K2 {k2_b} times")
        with ledger.aside():
            whole = m_b.predict(ds.x)
            check(torch.equal(torch.cat(pred_b.data_blocks()), whole),
                  "the sharded predict differs from the unsharded one")
            sil_whole = port.ClusteringEvaluator().evaluate(ds, whole, k=K)
        cost_rel = abs(cost_b - m_b.training_cost) / m_b.training_cost
        check(cost_rel <= 1e-6, f"sharded compute_cost {cost_b} vs training_cost "
              f"{m_b.training_cost}")
        check(abs(sil_b - sil_whole) <= 1e-5, f"sharded silhouette {sil_b} vs {sil_whole}")
        say(f"  (b) predict shard by shard == unsharded (K2 {k2_b} launches with compute_cost), "
            f"compute_cost rel {cost_rel:.3g} of training_cost, silhouette {sil_b:.6f} "
            f"(unsharded {sil_whole:.6f}, the main path's {sil:.6f})")
        rng = np.random.default_rng(SEED)
        cen = rng.integers(-30, 30, size=(K, D))
        xe = (cen[rng.integers(0, K, size=MESH_EXACT_N)]
              + rng.integers(-2, 3, size=(MESH_EXACT_N, D))).astype(np.float32)
        ide = port.device_dataset(xe, device=cuda0)
        e1, _ = fit(ide, warm=xe[:K])
        e4, _ = fit(sharding.shard_dataset(ide, mesh4), warm=xe[:K])
        check(np.array_equal(e1.cluster_centers, e4.cluster_centers)
              and np.array_equal(e1.cluster_sizes, e4.cluster_sizes) and e1.n_iter == e4.n_iter,
              "integer rows: the (4, 1) fit differs from the unsharded fit")
        say(f"  (b) integer-valued rows ({MESH_EXACT_N} x {D}): the (4, 1) fit == the "
            f"unsharded fit (centers, sizes, n_iter {e4.n_iter})")
        del ide, xe
        with ledger.aside():
            kr = mesh_case(L, sds4.shard(0).x, sds4.shard(0).w,
                           torch.from_numpy(m_b.cluster_centers).to(cuda0),
                           torch.ones(K, device=cuda0), f"(b) 0 of 4")
        k1_shapes.append(kr[0])
        k2_shapes.append(kr[1])
        lap("mesh (b)")

        # ---------------------------------------------------- (c) (2, 2)
        sds22 = sharding.shard_dataset(ds, mesh(2, 2))
        before = counts()
        m_c, s_c = fit(sds22)
        k1_c = counts()["fused_lloyd_stats"] - before["fused_lloyd_stats"]
        k2_c = counts()["fused_assign"] - before["fused_assign"]
        check(k1_c == k2_c == 4 * (m_c.n_iter + 1),
              f"the (2, 2) fit launched K1 {k1_c} and K2 {k2_c} times over {m_c.n_iter} steps")
        with ledger.aside():
            glob = torch.bincount(m_c.predict(ds.x).to(torch.int64), minlength=K).cpu().numpy()
        check(np.array_equal(m_c.cluster_sizes.astype(np.int64), glob),
              "(2, 2): the K1 counts summed over the model shards are not the bincount of "
              "K2's global argmin")
        gaps_c = kmeans_gaps(m_c, m_b)
        say(f"mesh (c) (2, 2) over [cuda:0] * 4: fit {s_c:.4f} s warm, n_iter {m_c.n_iter}, "
            f"{N * m_c.n_iter / s_c:.4g} Lloyd records/s, K2 {k2_c} + K1 {k1_c} launches (a "
            f"shard: {N // 2} x {D} x {K // 2}); the K1 counts summed over the model shards "
            f"== the bincount of K2's global argmin; vs (b): " + as_text(gaps_c))
        check(m_c.n_iter == m_b.n_iter and gated(gaps_c), f"(2, 2) vs (4, 1): {gaps_c}")
        with ledger.aside():
            x0, w0 = sds22.shard(0).x, sds22.shard(0).w
            c = torch.from_numpy(m_c.cluster_centers).to(cuda0)
            ones = torch.ones(K // 2, device=cuda0)
            mins = torch.stack([L.fused_assign(x0, c[:K // 2].contiguous(), ones)[1],
                                L.fused_assign(x0, c[K // 2:].contiguous(), ones)[1]])
            owned = (w0 * (mins.argmin(dim=0) == 0).float()).contiguous()
            kr = mesh_case(L, x0, owned, c[:K // 2].contiguous(), ones, "(c) (0, 0) of (2, 2)")
            del mins, owned
        k1_shapes.append(kr[0])
        k2_shapes.append(kr[1])
        del sds22
        lap("mesh (c)")

        # ------------------------------------- (f) per-hospital placement
        ids = np.random.default_rng(SEED + 1).integers(0, MESH_HOSPITALS, MESH_PROC_N)
        t0 = time.perf_counter()
        fd = port.federated_dataset(x2, ids, mesh=mesh4)
        fd_s = time.perf_counter() - t0
        hosp, n_h = np.unique(ids, return_counts=True)
        load = np.zeros(MESH_DATA, np.int64)
        for h, c_h in zip(hosp, n_h):
            load[fd.hospital_to_shard[h]] += c_h
        shard_len = fd.n_padded // MESH_DATA
        live = fd.row_order >= 0
        check(load.max() <= load.mean() + n_h.max(), f"hospital placement unbalanced: {load}")
        check(np.array_equal(np.flatnonzero(live) // shard_len,
                             [fd.hospital_to_shard[h] for h in ids[fd.row_order[live]]]),
              "a hospital's rows straddle shards")
        m_f, s_f = fit(fd)
        m_p, _ = fit(x2, mesh=mesh4)
        gaps_f = kmeans_gaps(m_f, m_p)
        say(f"mesh (f) federated_dataset over (4, 1): {MESH_PROC_N} rows of {MESH_HOSPITALS} "
            f"hospitals placed in {fd_s:.2f} s, shard loads {load.tolist()} (LPT bound "
            f"{load.mean() + n_h.max():.0f}), each hospital on one shard; fit {s_f:.4f} s, "
            f"n_iter {m_f.n_iter}; vs the ingest-order (4, 1) fit: " + as_text(gaps_f))
        check(m_f.n_iter == m_p.n_iter and gated(gaps_f), f"federated vs ingest order: {gaps_f}")
        del fd
        lap("mesh (f)")

        # ------------------------------------------- (d), (e): the ranks
        for (leg, r), (p, _) in procs.items():
            p.join(max(1.0, MESH_JOIN_S - (time.perf_counter() - t_spawn)))
            if p.is_alive():
                p.kill()
                p.join()
            check(p.exitcode == 0, f"mesh leg {leg} rank {r} exited {p.exitcode}")
        got = {}
        for key, (_, out) in procs.items():
            with open(out, "rb") as f:
                got[key] = pickle.load(f)
        spawned_s = time.perf_counter() - t_spawn
        lap("mesh spawned legs")
        refusals = [got["refused", r].get("error", "") for r in range(2)]
        check(all("duplicate gpu" in e.lower() or "invalidusage" in e.lower().replace(" ", "")
                  for e in refusals), f"NCCL took two ranks on one card: {refusals}")
        say(f"mesh: NCCL refuses two ranks on one card, as expected: "
            f"{refusals[0].splitlines()[0][:300]}")
        m_d, _ = fit(x2, mesh=mesh(2))
        for r in range(2):
            g = got["gloo", r]
            check("error" not in g, f"gloo rank {r}: {g.get('error')}")
            check(g["backend"] == "gloo" and g["world"] == 2 and g["owned"] == [r],
                  f"gloo rank {r} saw {g}")
            check(same_kmeans(g["model"], m_d), f"gloo rank {r} differs from the in-process "
                  "(2, 1) fit")
            check(g["launches"]["fused_lloyd_stats"] == g["model"].n_iter + 1,
                  f"gloo rank {r} launched K1 {g['launches']['fused_lloyd_stats']} times")
        say(f"mesh (d) two processes on {card} over gloo, a (2, 1) host-major mesh of "
            f"{MESH_PROC_N} rows: both ranks == each other and the in-process (2, 1) fit "
            f"(n_iter {m_d.n_iter}); K1 a rank {got['gloo', 0]['launches']['fused_lloyd_stats']}"
            f" / {got['gloo', 1]['launches']['fused_lloyd_stats']} (one {MESH_PROC_N // 2}-row "
            f"shard a step); rank fits {got['gloo', 0]['fit_s']:.3f} / "
            f"{got['gloo', 1]['fit_s']:.3f} s")
        g = got["nccl1", 0]
        m_e, _ = fit(x2, device=cuda0)
        check("error" not in g, f"the NCCL world-1 leg: {g.get('error')}")
        check(g["backend"] == "nccl" and g["world"] == 1 and same_kmeans(g["model"], m_e),
              "the NCCL world-1 fit differs from the in-process (1, 1) fit")
        check(g["launches"]["fused_lloyd_stats"] == g["model"].n_iter + 1,
              "the NCCL world-1 rank's K1 launches")
        say(f"mesh (e) one process over NCCL (world size 1), its statistics through the NCCL "
            f"all_gather: == the in-process (1, 1) fit (n_iter {m_e.n_iter}, fit "
            f"{g['fit_s']:.3f} s); spawned legs ended {spawned_s:.1f} s after their start")
        with ledger.aside():
            x1 = torch.from_numpy(x2[: MESH_PROC_N // 2]).to(cuda0)
            kr = mesh_case(L, x1, torch.ones(MESH_PROC_N // 2, device=cuda0),
                           torch.from_numpy(m_d.cluster_centers).to(cuda0),
                           torch.ones(K, device=cuda0), "(d) a rank's (1M rows)")
            del x1
        k1_shapes.append(kr[0])
        k2_shapes.append(kr[1])
        lap("mesh (d), (e)")
    launches = ledger.main_path()
    say(f"mesh_phase: {time.perf_counter() - t_phase:.2f} s of host clock ({card}); "
        f"main-path launches {json.dumps(launches)}")
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "k1": k1_shapes, "k2": k2_shapes, "x2": x2,
            "gloo": [got["gloo", r] for r in range(2)]}


# ------------------------------------------------------------- slice 8b-1
MM_DATA = 4                   # (b)-(e): a (4, 1) mesh over cuda:0, 350,000 training rows a shard
MM_SHARD_N = 350_000          # the stage's 1.4M training rows over 4 shards
#: the sharded stage against the unsharded one: LR coefficients within 1e-4
#: of the largest and the regressors' RMSE at rtol 1e-4 (ROADMAP queue 3's
#: LR and near-tie bounds), GBT predictions at gbt_phase's rtol
MM_LR_TOL = 1e-4
#: (c) the LR fit on integer LOS over (4, 1) and (2, 2) against (1, 1):
#: about 10x the larger gap of the first chip run (NVIDIA H100 80GB HBM3,
#: 700 W: 1.37e-6 and 1.79e-7 of the largest coefficient; not 0, since the
#: Gram's float32 entries pass 2**24 and the shards cut its row chunks
#: elsewhere), beside its own TF32 control
MM_LR_INT_TOL = 1.4e-5
MM_RMSE_RTOL = 1e-4
MM_GBT_RTOL = GBT_PRED_RTOL
#: the rest against one device: about 10x the gaps of the first chip run
#: (NVIDIA H100 80GB HBM3, 700 W: GBT leaf values 7.15e-7 on integer
#: labels; GMM means 1.19e-3, weights 2.13e-6, ll 7.29e-8 relative; the
#: logistic probabilities 0 and 5.96e-7), one float32 ulp where a gap was 0
MM_GBT_VALUE_TOL = 7.2e-6
MM_GMM_TOL = {"means": 1.2e-2, "weights": 2.1e-5, "ll_rel": 7.3e-7}
MM_LOGIT_TOL = {"binomial": 1.2e-7, "multinomial": 6e-6}
MM_MLR_ITERS = 10             # (f)'s multinomial Newton steps


def mesh_model_phases(x, mesh) -> dict:
    """The JAX package's cross-process phases 1, 3, 4 and 5
    (``tests/test_distributed.py``) on rows ``x`` over ``mesh``: the WLS, a
    depth-3 regression tree, 5 EM steps of a 3-component GMM and the
    multinomial fit, with labels drawn from ``x`` (seed ``SEED + 3``).
    → host arrays."""
    import numpy as np

    sys.path.insert(0, str(ROOT))
    import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port

    rng = np.random.default_rng(SEED + 3)
    y = (x @ rng.normal(size=x.shape[1]) + 0.25 + rng.normal(0, 0.3, len(x))).astype(np.float32)
    y3 = np.clip((x[:, 0] > 0).astype(np.int32) + 2 * (x[:, 1] > 0.5).astype(np.int32),
                 0, 2).astype(np.float32)
    lr = port.LinearRegression().fit((x, y), mesh=mesh)
    tree = port.DecisionTreeRegressor(max_depth=3, max_bins=16).fit((x, y), mesh=mesh)
    gm = port.GaussianMixture(k=3, max_iter=5, tol=0.0, seed=SEED).fit(x, mesh=mesh)
    ml = port.LogisticRegression(family="multinomial", reg_param=0.01,
                                 max_iter=MM_MLR_ITERS).fit((x, y3), mesh=mesh)
    return {"coef": lr.coefficients.cpu().numpy(), "intercept": lr.intercept.cpu().numpy(),
            "split_feat": tree.split_feat, "threshold": tree.threshold, "value": tree.value,
            "gmm_means": gm.means, "gmm_weights": gm.weights,
            "gmm_covariances": gm.covariances, "gmm_ll": np.float64(gm.log_likelihood),
            "gmm_n_iter": np.int64(gm.n_iter),
            "mlr_coef": ml.coefficient_matrix.cpu().numpy(),
            "mlr_intercept": ml.intercept_vector.cpu().numpy(),
            "mlr_n_iter": np.int64(ml.n_iter)}


def stage_split(port, table, cfg):
    """The stage's own train and test AssembledTables (its Binarizer,
    seed-42 split and assembler)."""
    binarized = port.Binarizer(port.LABEL_COL, "LOS_binary", cfg.los_threshold).transform(table)
    train_t, test_t = port.train_test_split(binarized, cfg.train_fraction, cfg.split_seed)
    assembler = port.VectorAssembler(port.FEATURE_COLS)
    return assembler.transform(train_t), assembler.transform(test_t)


def lr_gap(a, b) -> float:
    """Two LinearRegression fits' largest coefficient gap, relative to the
    largest coefficient of ``b``."""
    import numpy as np

    ca, cb = a.coefficients.cpu().numpy(), b.coefficients.cpu().numpy()
    return float(np.abs(ca - cb).max() / np.abs(cb).max())


def rmse_gap(a: dict, b: dict) -> float:
    return max(abs(a[k] - b[k]) / b[k] for k in b)


def same_forests(a, b) -> bool:
    """Two tree models with equal splits, thresholds and leaf values."""
    import numpy as np

    return all(np.array_equal(getattr(a, k), getattr(b, k))
               for k in ("split_feat", "threshold", "value"))


def mesh_models_phase(port, H, card: str, mp_: dict) -> dict:
    """Slice 8b-1: the model stage's estimators over a (data, model) mesh
    on the card.  (a) ``run_model_stage`` over a (1, 1) mesh on the stage's
    2M-row window ``==`` the stage (every RMSE, accuracy and importance);
    (b) over a (4, 1) mesh of ``[cuda:0] * 4``: K3 once a shard a level
    (4 x 6 x 4 = 96 launches), LR coefficients within ``MM_LR_TOL`` of the
    largest beside TF32 products (which must fail it), the regressors' RMSE
    at ``MM_RMSE_RTOL`` beside the stage on bf16-rounded LOS, the
    classifiers' accuracy and trees ``==``; (c) integer LOS: every tree
    over (4, 1) and (2, 2) ``==`` the (1, 1) stage's, the LR fit within
    ``MM_LR_INT_TOL`` beside a TF32 control; (d) GBT on gbt20's
    rows over (4, 1), its boost loop under ``set_sync_debug_mode("error")``,
    the same trees as one device on integer labels and predictions at
    ``MM_GBT_RTOL`` on float labels beside a TF32-rounded control; (e)
    GaussianMixture k=32 and binomial / multinomial LogisticRegression on
    the stage's 2M hospital rows over (4, 1) against one device, each
    limit beside its bf16-rounded control; (f) ``mesh_phase``'s two gloo
    ranks ran ``mesh_model_phases`` on their rows: both ``==`` each other
    and the in-process (2, 1) fits.  K3 against its plain version at the
    shard shape, with the plans at 350,000 and 1.4M rows.  → {"launches":
    K3's main-path launches, "shape": K3's shard-shape record}."""
    import numpy as np
    import torch

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel as P
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models.tree import gbt
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.parallel import sharding

    t_phase = time.perf_counter()
    ledger = LaunchLedger(H)
    cuda0 = torch.device("cuda", 0) if DEV == "cuda" else torch.device(DEV)
    cfg = port.PipelineConfig()
    table = STAGE_WINDOW["table"]

    def mesh(data: int, model: int = 1):
        return P.build_mesh(port.MeshConfig(data=data, model=model), [cuda0] * (data * model))

    def stage(tab, m):
        before = H.launch_counts()["fused_level_hist"]
        sync()
        t0 = time.perf_counter()
        res = port.run_model_stage(tab, cfg, mesh=m)
        sync()
        return res, time.perf_counter() - t0, H.launch_counts()["fused_level_hist"] - before

    # ------------------------------------------------------------ (a) (1, 1)
    res_a, s_a, k3_a = stage(table, mesh(1))
    check(res_a.regression_rmse == STAGE_WINDOW["rmse"]
          and res_a.classification_accuracy == STAGE_WINDOW["accuracy"]
          and res_a.feature_importances == STAGE_WINDOW["importances"],
          "the (1, 1) mesh stage differs from the stage on the card")
    check(k3_a == 24, f"the (1, 1) stage launched K3 {k3_a} times (expected 24)")
    say(f"mesh models (a) (1, 1) over cuda:0: run_model_stage on {table.num_rows} rows "
        f"{s_a:.3f} s, K3 {k3_a} launches; every RMSE, accuracy and importance == the stage's "
        f"({card})")
    lap("mm (a)")

    # ------------------------------------------------------------ (b) (4, 1)
    mesh4 = mesh(MM_DATA)
    res_b, s_b, k3_b = stage(table, mesh4)
    check(k3_b == MM_DATA * 24, f"the (4, 1) stage launched K3 {k3_b} times "
          f"(expected {MM_DATA} shards x 6 levels x 4 tree fits)")
    g_lr = lr_gap(res_b.models["LinearRegression"], res_a.models["LinearRegression"])
    g_rmse = rmse_gap(res_b.regression_rmse, res_a.regression_rmse)
    with ledger.aside():
        train, _ = stage_split(port, table, cfg)
        with tf32_matmuls():
            lr_ctl = port.LinearRegression().fit(train, label_col=port.LABEL_COL, mesh=mesh4)
        c_lr = lr_gap(lr_ctl, res_a.models["LinearRegression"])
        del train, lr_ctl
        rounded = table.with_column(port.LABEL_COL, bf16_round(table.column(port.LABEL_COL)),
                                    dtype="float")
        res_ctl, _, _ = stage(rounded, mesh4)
        c_rmse = rmse_gap(res_ctl.regression_rmse, res_a.regression_rmse)
        del rounded, res_ctl
    check(g_lr <= MM_LR_TOL < c_lr, f"(4, 1) LR coefficients {g_lr:.3g} of the largest apart, "
          f"TF32 control {c_lr:.3g} (limit {MM_LR_TOL:g})")
    check(g_rmse <= MM_RMSE_RTOL < c_rmse, f"(4, 1) RMSE rel {g_rmse:.3g}, bf16-LOS control "
          f"{c_rmse:.3g} (limit {MM_RMSE_RTOL:g})")
    check(res_b.classification_accuracy == res_a.classification_accuracy,
          f"(4, 1) accuracy {res_b.classification_accuracy} vs {res_a.classification_accuracy}")
    for name in ("DecisionTreeClassifier", "RandomForestClassifier"):
        check(same_forests(res_b.models[name], res_a.models[name]),
              f"(4, 1) {name} differs from the (1, 1) tree")
    say(f"mesh models (b) (4, 1) over [cuda:0] * 4: run_model_stage {s_b:.3f} s (1, 1: "
        f"{s_a:.3f} s), K3 {k3_b} launches (4 a level, {MM_SHARD_N} rows a shard); "
        + ", ".join(f"{k} {v:.3f} s" for k, v in res_b.seconds.items())
        + f"; LR coefficients {g_lr:.3g} of the largest apart (limit {MM_LR_TOL:g}; TF32 "
        f"control {c_lr:.3g}); RMSE rel {g_rmse:.3g} (limit {MM_RMSE_RTOL:g}; bf16-LOS control "
        f"{c_rmse:.3g}); classifier accuracy and trees == ({card})")
    del res_b
    lap("mm (b)")

    # ---------------------------------------------- (c) integer LOS, == trees
    ints = table.with_column(port.LABEL_COL, np.round(table.column(port.LABEL_COL)),
                             dtype="float")
    ref_c, s_c1, _ = stage(ints, mesh(1))
    gaps_c = {}
    for shape in ((MM_DATA, 1), (2, 2)):
        got, s_c, k3_c = stage(ints, mesh(*shape))
        check(k3_c == shape[0] * 24, f"{shape} integer-LOS stage launched K3 {k3_c} times")
        for name, m in got.models.items():
            if name != "LinearRegression":
                check(same_forests(m, ref_c.models[name]),
                      f"integer LOS over {shape}: {name} differs from the (1, 1) tree")
        check(got.feature_importances == ref_c.feature_importances
              and got.classification_accuracy == ref_c.classification_accuracy,
              f"integer LOS over {shape}: importances or accuracy differ")
        gaps_c[shape] = (lr_gap(got.models["LinearRegression"], ref_c.models["LinearRegression"]),
                         s_c, k3_c)
        check(gaps_c[shape][0] <= MM_LR_INT_TOL,
              f"integer LOS over {shape}: LR {gaps_c[shape][0]:.3g} of the largest apart "
              f"(limit {MM_LR_INT_TOL:g})")
        del got
    with ledger.aside():
        train, _ = stage_split(port, ints, cfg)
        with tf32_matmuls():
            lr_ctl = port.LinearRegression().fit(train, label_col=port.LABEL_COL, mesh=mesh4)
        c_lr_int = lr_gap(lr_ctl, ref_c.models["LinearRegression"])
        del train, lr_ctl
    check(c_lr_int > MM_LR_INT_TOL, f"the TF32 control passes (c)'s LR limit: {c_lr_int:.3g} "
          f"(limit {MM_LR_INT_TOL:g})")
    say(f"mesh models (c) integer LOS: over (4, 1) and (2, 2) every tree, importance and "
        f"accuracy == the (1, 1) stage's; LR within "
        + ", ".join(f"{g:.3g} of the largest over {sh} ({t:.3f} s, K3 {k})"
                    for sh, (g, t, k) in gaps_c.items())
        + f" (limit {MM_LR_INT_TOL:g}; TF32 control over (4, 1) {c_lr_int:.3g}; the Gram's "
        f"float32 entries pass 2**24, so the LR sums are not exact)")
    del ints, ref_c, res_a
    lap("mm (c)")

    # ------------------------------------------------------- (d) GBT over (4, 1)
    x, y = gbt_data()
    kw = dict(max_iter=GBT_ROUNDS, max_depth=GBT_DEPTH, seed=0)
    one = port.device_dataset(x, y, device=cuda0)
    sds = sharding.shard_dataset(one, mesh4)
    m_one = port.GBTRegressor(**kw).fit(one)
    rounds = gbt._GBTParams._device_rounds

    def guarded(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return rounds(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    before = H.launch_counts()["fused_level_hist"]
    gbt._GBTParams._device_rounds = guarded
    try:
        sync()
        t0 = time.perf_counter()
        m_sh = port.GBTRegressor(**kw).fit(sds)
        sync()
        gbt_s = time.perf_counter() - t0
    finally:
        gbt._GBTParams._device_rounds = rounds
    k3_d = H.launch_counts()["fused_level_hist"] - before
    check(k3_d == MM_DATA * GBT_ROUNDS * (GBT_DEPTH + 1), f"(4, 1) GBT launched K3 {k3_d} times")
    base = m_one.predict(one.x).cpu().numpy()

    def pred_gap(m) -> float:
        p = m.predict(one.x).cpu().numpy()
        return float((np.abs(p - base) / np.maximum(np.abs(base), 1e-6)).max())

    g_pred = pred_gap(m_sh)
    with ledger.aside():
        ctl = port.GBTRegressor(**kw).fit(
            sharding.shard_dataset(port.device_dataset(x, tf32_round(y), device=cuda0), mesh4))
        c_pred = pred_gap(ctl)
        yi = np.round(y)
        i_one = port.GBTRegressor(**kw).fit((x, yi), device=cuda0)
        v_ctl = tree_gap(port.GBTRegressor(**kw).fit((tf32_round(x), yi), mesh=mesh4), i_one)
    i_sh = port.GBTRegressor(**kw).fit((x, yi), mesh=mesh4)
    check(g_pred <= MM_GBT_RTOL < c_pred, f"(4, 1) GBT predictions rel {g_pred:.3g}, TF32 "
          f"control {c_pred:.3g} (limit {MM_GBT_RTOL:g})")
    v_gap = same_trees(i_sh, i_one, MM_GBT_VALUE_TOL)
    check(v_ctl > MM_GBT_VALUE_TOL, f"the TF32-rounded control passes the (4, 1) GBT value "
          f"limit: {v_ctl:.3g} (limit {MM_GBT_VALUE_TOL:g})")
    say(f"mesh models (d) GBT over (4, 1) on gbt20's {TREE_N} x 8 rows: fit {gbt_s:.3f} s, K3 "
        f"{MM_DATA * GBT_ROUNDS * (GBT_DEPTH + 1)} launches (4 a level), the boost loop under "
        f"set_sync_debug_mode('error'): no host sync; predictions rel {g_pred:.3g} of one "
        f"device's (limit {MM_GBT_RTOL:g}; TF32-rounded labels {c_pred:.3g}); integer labels: "
        f"the same trees, leaf values {v_gap:.3g} apart (limit {MM_GBT_VALUE_TOL:g}; "
        f"TF32-rounded features {v_ctl:.3g})")
    del one, sds, m_one, m_sh, ctl, i_one, i_sh, x, y
    lap("mm (d)")

    # ------------------------------------- (e) GMM and logistic over (4, 1)
    xh, _, yb = stage_rows()
    xh = xh.astype(np.float32)
    los = STAGE_ROWS["los"]
    tiers = np.digitize(los, np.quantile(los, [0.5, 0.85])).astype(np.float32)
    gkw = dict(k=GMM_K, max_iter=GMM_ITERS, tol=0.0, seed=SEED)

    def gmm_gaps(a, b) -> dict:
        return {"means": float(np.abs(a.means - b.means).max()),
                "weights": float(np.abs(a.weights - b.weights).max()),
                "ll_rel": abs(a.log_likelihood / b.log_likelihood - 1)}

    g_one = port.GaussianMixture(**gkw).fit(xh, device=cuda0)
    sync()
    t0 = time.perf_counter()
    g_sh = port.GaussianMixture(**gkw).fit(xh, mesh=mesh4)
    sync()
    gmm_s = time.perf_counter() - t0
    g_ctl = port.GaussianMixture(**gkw).fit(bf16_round(xh), mesh=mesh4)
    gg, gc = gmm_gaps(g_sh, g_one), gmm_gaps(g_ctl, g_one)
    check(all(gg[k] <= MM_GMM_TOL[k] < gc[k] for k in MM_GMM_TOL),
          f"(4, 1) GMM k={GMM_K} {gg}, bf16 control {gc} (limits {MM_GMM_TOL})")
    lines = [f"GMM k={GMM_K} x {GMM_ITERS} EM iterations {gmm_s:.3f} s: "
             + ", ".join(f"{k} {gg[k]:.3g} (limit {MM_GMM_TOL[k]:g}; bf16 {gc[k]:.3g})"
                         for k in MM_GMM_TOL)]
    for family, lab, est in (("binomial", yb, port.LogisticRegression(tol=CLS_TOL)),
                             ("multinomial", tiers, port.LogisticRegression(**MULTI_KW))):
        a = est.fit((xh, lab), device=cuda0)
        sync()
        t0 = time.perf_counter()
        b = est.fit((xh, lab), mesh=mesh4)
        sync()
        fit_s = time.perf_counter() - t0
        c = est.fit((bf16_round(xh), lab), mesh=mesh4)
        pa = a.predict_proba(torch.from_numpy(xh).to(cuda0))
        gap = float((b.predict_proba(torch.from_numpy(xh).to(cuda0)) - pa).abs().max())
        ctl_gap = float((c.predict_proba(torch.from_numpy(xh).to(cuda0)) - pa).abs().max())
        lim = MM_LOGIT_TOL[family]
        check(gap <= lim < ctl_gap and a.n_iter == b.n_iter,
              f"(4, 1) {family} logistic: probabilities {gap:.3g} apart, n_iter {b.n_iter} / "
              f"{a.n_iter}, bf16 control {ctl_gap:.3g} (limit {lim:g})")
        lines.append(f"{family} LogisticRegression {fit_s:.3f} s, n_iter {b.n_iter} == one "
                     f"device's, probabilities {gap:.3g} apart (limit {lim:g}; bf16 {ctl_gap:.3g})")
        del a, b, c, pa
    say(f"mesh models (e) over (4, 1) on the stage's {len(xh)} hospital rows against one "
        f"device: " + "; ".join(lines))
    del g_one, g_sh, g_ctl
    lap("mm (e)")

    # ------------------------------- (f) the JAX phases on the gloo ranks
    ranks = mp_["gloo"]
    for r, g in enumerate(ranks):
        check("error" not in g and "phases" in g, f"gloo rank {r}: {g.get('error')}")
    here = mesh_model_phases(mp_["x2"], mesh(2))
    for key, v in here.items():
        for r, g in enumerate(ranks):
            check(np.array_equal(np.asarray(g["phases"][key]), np.asarray(v)),
                  f"(f) gloo rank {r}'s {key} differs from the in-process (2, 1) fit")
    say(f"mesh models (f) the JAX package's cross-process phases (WLS, a depth-3 tree, 5 EM "
        f"steps of a k=3 GMM, {here['mlr_n_iter']} multinomial Newton steps) on mesh_phase's "
        f"two gloo ranks over {len(mp_['x2'])} rows: both ranks == each other and the "
        f"in-process (2, 1) fits on every array; rank phase seconds "
        f"{ranks[0]['phases_s']:.3f} / {ranks[1]['phases_s']:.3f}, K3 a rank "
        f"{ranks[0]['phases_k3']} / {ranks[1]['phases_k3']}")
    lap("mm (f)")

    # ------------------------------------ K3 at the shard shape, plain and plans
    with ledger.aside():
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        recs = []
        for S in (3, 2):
            ins = k3_inputs(MM_SHARD_N, 4, S, 20, 32, 32, seed=60 + S)
            err, _ = k3_check(H, *ins, 32, 32, f"stage shard S={S}")
            t = k3_time(H, *ins, 32, 32, reps=20)
            plans = {n: H.hist_plan(n, 4, S, 32, 32, 20, sms,
                                    H.occupancy(cuda0, 4, S, 32, 32, 20))
                     for n in (MM_SHARD_N, 4 * MM_SHARD_N)}
            say(f"K3 stage shard (n={MM_SHARD_N} d=4 S={S} T=20 LN=32 B=32): {t['ms']:.4f} ms "
                f"(plain {t['plain_ms']:.4f}, library {t['library_ms']:.4f}, bound "
                f"{t['bound_ms']:.4f} by {t['bound_by']}), max_abs_err {err:.3g}; plan at "
                + "; at ".join(f"{n} rows: TB {p['TB']}, blocks_x {p['blocks_x']}, "
                               f"{p['n_ptiles'] * p['n_ftiles']} tiles, {p['warps']} warps, "
                               f"{p['per_sm']} resident an SM, {p['waves']} wave(s)"
                               for n, p in plans.items()) + f" ({card})")
            recs.append({"n": MM_SHARD_N, "d": 4, "S": S, "T": 20, "LN": 32, "B": 32,
                         "max_abs_err": err, **t})
            del ins
    launches = ledger.main_path()["fused_level_hist"]
    say(f"mesh_models_phase: {time.perf_counter() - t_phase:.2f} s of host clock ({card}); "
        f"K3 main-path launches {launches}")
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "shapes": recs}


# ------------------------------------------------------------- slice 8c-1
MC_DATA = 4                   # (b)-(f): a (4, 1) mesh over cuda:0
MC_STREAM_MIN = 16_384        # (b)'s override: a 100,000-row batch's 25,000-row shards take it
MC_LIN_ROWS = 400_000         # (c): the stage's 2M hospital rows in 5 batches, 100,000 a shard
MC_KILL_AT = 5                # (d), (e): the fit killed after this step / EM iteration
MC_KM_ITERS = 10              # (d): the checkpointed k=256 fit's steps (tol 0)
#: (a), (b), (c) against one device: about 10x the first chip run's gaps,
#: two float32 ulp at the values' magnitude where a gap was 0 (NVIDIA H100
#: 80GB HBM3, 700 W: bisecting centers 0 (|c| about 2; bf16-rounded control
#: 3.0e-4), streaming centers 2.38e-7 and weights 0 (bf16 control 3.22 /
#: 1.02), logistic probabilities 8.05e-7 (bf16 control 3.2e-5)); the linear
#: stream at queue 3's bound on the hospital Gram, 1e-4 of the largest
#: coefficient, beside TF32 products
MC_BISECT_TOL = 5e-7
MC_STREAM_TOL = {"centers": 2.4e-6, "weights_rel": 2.4e-7}
MC_LIN_TOL = MM_LR_TOL
MC_LOGIT_TOL = 8e-6


class _Killed(Exception):
    """The preemption (d) and (e) inject through ``on_iteration``."""


def bisect_gaps(a, b) -> dict:
    import numpy as np

    return {"centers": float(np.abs(a.cluster_centers - b.cluster_centers).max()),
            "sizes": float(np.abs(a.cluster_sizes - b.cluster_sizes).max()),
            "splits": int(a.fit_info["splits"] != b.fit_info["splits"])}


def same_stream(a, b) -> bool:
    import torch

    return all(torch.equal(getattr(a, n).cpu(), getattr(b, n).cpu())
               for n in ("_centers", "_weights", "_weights_lo")) and a._steps == b._steps


def stream_gaps(a, b) -> dict:
    import numpy as np

    ma, mb = a.latest_model, b.latest_model
    return {"centers": float(np.abs(ma.cluster_centers - mb.cluster_centers).max()),
            "weights_rel": float(np.abs(ma.cluster_weights / mb.cluster_weights - 1).max())}


def mesh_clustering_phase(port, L, card: str, ds, model, pred_h, x_host, init, x2) -> dict:
    """Slice 8c-1: the clustering family, the streams and bulk scoring over
    virtual meshes of ``cuda:0``.  (a) BisectingKMeans, config 4 (2M x 8,
    k=8, one restart): (1, 1) ``==`` one device, (4, 1) and (2, 2) the same
    splits and sizes, centers within ``MC_BISECT_TOL`` beside a
    bf16-rounded control, ``==`` on integer rows; predict over the mesh
    (K2 a shard) ``==`` one device.  (b) StreamingKMeans, config 5 (12
    batches of 100,000 x 8, k=16, half_life 5) over (4, 1): at the default
    threshold every batch on one device, ``==`` the one-device stream;
    with ``shard_min_rows_per_device=MC_STREAM_MIN`` K1 4 a batch in
    ``update`` and ``update_many``, within ``MC_STREAM_TOL`` (a bf16
    control), ``==`` on integer rows, a 13th update with no host sync, and
    ``ModelUpdateConsumer(mesh=)`` over 10 drops ``==`` the direct
    updates.  (c) the streaming linear and logistic models on the stage's
    2M hospital rows in 5 batches of 400,000 over (4, 1) (sharded at the
    default threshold) against one device, beside TF32 / bf16 controls.
    (d) KMeans k=256 over (4, 1) on the main path's first 2M rows with
    ``checkpoint_dir``, killed after step ``MC_KILL_AT`` and resumed ``==``
    the uninterrupted fit; a (2, 2) bf16 fit against the (2, 2) "highest"
    fit at ``precision_phase``'s limit.  (e) GaussianMixture k=32 over (4,
    1) on the 2M hospital rows, killed and resumed ``==``.  (f) the main
    path's 10M rows scored over (4, 1): ``bulk_score``, ``ShardedScorer``
    and ``assign_clusters_chunked`` ``==`` predict, K2 4 a chunk.  K1 and
    K2 against their plain versions at the new shard shapes.  → {"launches":
    the main path's K1 / K2, "k1", "k2": shape records}."""
    import numpy as np
    import torch

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel as P
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import streaming as S
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models import (
        streaming_linear as psl,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops.distance import (
        assign_clusters_chunked,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.parallel import sharding
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.parallel.partitioner import (
        family,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve.scoring import (
        DEFAULT_CHUNK_ROWS,
    )

    t_phase = time.perf_counter()
    ledger = LaunchLedger(L)
    cuda0 = torch.device("cuda", 0) if DEV == "cuda" else torch.device(DEV)
    counts = L.launch_counts

    def mesh(data: int, model: int = 1):
        return P.build_mesh(port.MeshConfig(data=data, model=model), [cuda0] * (data * model))

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def launched(fn, name: str):
        before = counts()[name]
        out = fn()
        sync()
        return out, counts()[name] - before

    mesh4 = mesh(MC_DATA)
    k1_shapes, k2_shapes = [], []

    # -------------------------------------------- (a) BisectingKMeans
    x = make_data(BISECT_N, D, BISECT_K)
    bkw = dict(k=BISECT_K, seed=SEED, n_restarts=1)
    one_ds = port.device_dataset(x, device=cuda0)
    with ledger.aside():
        one, s_one = timed(lambda: port.BisectingKMeans(**bkw).fit(one_ds))
    m11, s11 = timed(lambda: port.BisectingKMeans(**bkw).fit(one_ds, mesh=mesh(1)))
    check(bisect_gaps(m11, one) == {"centers": 0.0, "sizes": 0.0, "splits": 0}
          and m11.training_cost == one.training_cost, "bisecting: (1, 1) differs from one device")
    lines, shard_ds = [], {}
    for shape in ((MC_DATA, 1), (2, 2)):
        shard_ds[shape] = sharding.shard_dataset(one_ds, mesh(*shape))
        m, s = timed(lambda: port.BisectingKMeans(**bkw).fit(shard_ds[shape]))
        g = bisect_gaps(m, one)
        check(g["splits"] == 0 and g["sizes"] == 0.0 and g["centers"] <= MC_BISECT_TOL,
              f"bisecting {shape} vs one device: {g} (limit {MC_BISECT_TOL:g})")
        lines.append(f"{shape} {s:.3f} s, {len(m.fit_info['levels'])} levels, centers "
                     f"{g['centers']:.3g}")
        if shape == (MC_DATA, 1):
            m4 = m
    with ledger.aside():
        ctl = port.BisectingKMeans(**bkw).fit(sharding.shard_dataset(
            port.device_dataset(bf16_round(x), device=cuda0), mesh4))
        c_ctl = bisect_gaps(ctl, one)["centers"]
    check(c_ctl > MC_BISECT_TOL, f"bisecting: the bf16-rounded control {c_ctl:.3g} passes "
          f"{MC_BISECT_TOL:g}")
    pred4, k2_a = launched(lambda: m4.predict(shard_ds[MC_DATA, 1].x), "fused_assign")
    check(k2_a == MC_DATA, f"bisecting predict over (4, 1) launched K2 {k2_a} times")
    with ledger.aside():
        check(torch.equal(torch.cat(pred4.data_blocks()), m4.predict(one_ds.x)),
              "bisecting: predict over the mesh differs from one device")
        k2_shapes.append(k2_record(L, shard_ds[MC_DATA, 1].shard(0).x,
                                   torch.from_numpy(m4.cluster_centers).to(cuda0),
                                   f"bisecting (4, 1) shard n={BISECT_N // MC_DATA}", 20))
    rng = np.random.default_rng(SEED + 8)
    cen = rng.integers(-3, 4, size=(BISECT_K, D))
    xi = (cen[rng.integers(0, BISECT_K, BISECT_N)]
          + rng.integers(-1, 2, size=(BISECT_N, D))).astype(np.float32)
    ids = port.device_dataset(xi, device=cuda0)
    with ledger.aside():
        one_i = port.BisectingKMeans(**bkw).fit(ids)
    for shape in ((MC_DATA, 1), (2, 2)):
        mi = port.BisectingKMeans(**bkw).fit(sharding.shard_dataset(ids, mesh(*shape)))
        check(bisect_gaps(mi, one_i) == {"centers": 0.0, "sizes": 0.0, "splits": 0}
              and mi.training_cost == one_i.training_cost,
              f"bisecting integer rows over {shape}: {bisect_gaps(mi, one_i)}")
    say(f"mesh clustering (a) BisectingKMeans k={BISECT_K} on {BISECT_N} x {D}: one device "
        f"{s_one:.3f} s, (1, 1) {s11:.3f} s == one device; " + "; ".join(lines)
        + f" (limit {MC_BISECT_TOL:g}; bf16-rounded control {c_ctl:.3g}); the same splits "
        f"and sizes; integer rows == one device over (4, 1) and (2, 2); predict over (4, 1) "
        f"K2 {k2_a} launches == one device ({card})")
    del one_ds, shard_ds, ids, pred4, x, xi
    lap("mc (a)")

    # -------------------------------------------- (b) StreamingKMeans
    xs = make_data(STREAM_BATCH * STREAM_BATCHES, D, STREAM_K)
    batches = [xs[i * STREAM_BATCH:(i + 1) * STREAM_BATCH] for i in range(STREAM_BATCHES)]
    skw = dict(k=STREAM_K, half_life=5.0, seed=SEED)

    def stream(bs, where: dict, **kw):
        sk = port.StreamingKMeans(**skw, **kw)
        k1 = []
        for b in bs[:2]:
            k1.append(launched(lambda: sk.update(b, **where), "fused_lloyd_stats")[1])
        k1.append(launched(lambda: sk.update_many(bs[2:], **where), "fused_lloyd_stats")[1])
        return sk, k1

    with ledger.aside():
        ref, _ = stream(batches, {"device": cuda0})
    (sk_def, k1_def), s_def = timed(lambda: stream(batches, {"mesh": mesh4}))
    check(same_stream(sk_def, ref) and k1_def == [1, 1, STREAM_BATCHES - 2],
          f"streaming over (4, 1) at the default threshold: K1 {k1_def}, state == one "
          f"device: {same_stream(sk_def, ref)}")
    (sko, k1_o), s_o = timed(lambda: stream(batches, {"mesh": mesh4},
                                            shard_min_rows_per_device=MC_STREAM_MIN))
    check(k1_o == [MC_DATA, MC_DATA, MC_DATA * (STREAM_BATCHES - 2)],
          f"streaming over (4, 1) with the override: K1 {k1_o} (want 4 a batch)")
    g_s = stream_gaps(sko, ref)
    with ledger.aside():
        ctl_s = stream_gaps(stream([bf16_round(b) for b in batches], {"mesh": mesh4},
                                   shard_min_rows_per_device=MC_STREAM_MIN)[0], ref)
        rng = np.random.default_rng(SEED + 9)
        cen = rng.integers(-8, 9, size=(STREAM_K, D))
        ib = [(cen[rng.integers(0, STREAM_K, STREAM_BATCH)]
               + rng.integers(-2, 3, size=(STREAM_BATCH, D))).astype(np.float32)
              for _ in range(STREAM_BATCHES)]
        ref_i, _ = stream(ib, {"device": cuda0})
    sko_i, _ = stream(ib, {"mesh": mesh4}, shard_min_rows_per_device=MC_STREAM_MIN)
    check(same_stream(sko_i, ref_i), "streaming integer rows over (4, 1) differ from one device")
    check(all(g_s[k] <= MC_STREAM_TOL[k] for k in MC_STREAM_TOL)
          and ctl_s["centers"] > MC_STREAM_TOL["centers"],
          f"streaming over (4, 1) vs one device {g_s}, bf16 control {ctl_s} "
          f"(limits {MC_STREAM_TOL})")
    sds = sharding.shard_dataset(port.device_dataset(batches[0], device=cuda0), mesh4)
    sync()
    before = counts()["fused_lloyd_stats"]
    if DEV == "cuda":
        torch.cuda.set_sync_debug_mode("error")
    try:
        sko.update(sds)
    finally:
        if DEV == "cuda":
            torch.cuda.set_sync_debug_mode("default")
    sync()
    k1_13 = counts()["fused_lloyd_stats"] - before
    check(k1_13 == MC_DATA, f"the 13th sharded update launched K1 {k1_13} times")
    direct = port.StreamingKMeans(**skw, shard_min_rows_per_device=MC_STREAM_MIN)
    fed = port.StreamingKMeans(**skw, shard_min_rows_per_device=MC_STREAM_MIN)
    for b in batches[:10]:
        direct.update(b, mesh=mesh4)
    cons = S.ModelUpdateConsumer(fed, mesh=mesh4)
    _, k1_cons = launched(lambda: [cons(b, i) for i, b in enumerate(batches[:10])],
                          "fused_lloyd_stats")
    check(same_stream(fed, direct) and k1_cons == 10 * MC_DATA,
          f"ModelUpdateConsumer(mesh=) over 10 drops: K1 {k1_cons}, == the direct updates: "
          f"{same_stream(fed, direct)}")
    with ledger.aside():
        k1_shapes.append(mesh_case(L, sds.shard(0).x, sds.shard(0).w, sko._centers.clone(),
                                   torch.ones(STREAM_K, device=cuda0),
                                   f"streaming (4, 1) shard n={STREAM_BATCH // MC_DATA}",
                                   reps=50)[0])
    say(f"mesh clustering (b) StreamingKMeans k={STREAM_K} over (4, 1), {STREAM_BATCHES} "
        f"batches of {STREAM_BATCH} x {D}: default threshold {s_def:.3f} s, K1 {k1_def} (one "
        f"device a batch: {STREAM_BATCH // MC_DATA} rows a shard < 65,536), == the one-device "
        f"stream; shard_min_rows_per_device={MC_STREAM_MIN} {s_o:.3f} s, K1 {k1_o} (4 a "
        f"batch in update and update_many), vs one device " + as_text(g_s)
        + f" (limits {MC_STREAM_TOL}; bf16 control " + as_text(ctl_s) + "); integer rows "
        f"==; a 13th update from the card: no host sync, K1 {k1_13}; ModelUpdateConsumer(mesh=) "
        f"over 10 drops == the direct updates, K1 {k1_cons} ({card})")
    del sds, batches, xs, ib
    lap("mc (b)")

    # ----------------------------------- (c) the streaming linear models
    xh, los, yb = stage_rows()
    xh = xh.astype(np.float32)
    y = los.astype(np.float32)
    n_b = len(xh) // MC_LIN_ROWS

    def streams(rows, where: dict):
        lin, log = port.StreamingLinearRegression(), port.StreamingLogisticRegression()
        for i in range(n_b):
            sl = slice(i * MC_LIN_ROWS, (i + 1) * MC_LIN_ROWS)
            lin.update((rows[sl], y[sl]), **where)
            log.update((rows[sl], yb[sl]), **where)
        return lin, log

    def theta(m):
        return np.r_[m.coefficients.cpu().numpy(), float(m.intercept)]

    x_dev = torch.from_numpy(xh).to(cuda0)

    def proba_gap(a, b) -> float:
        return float((a.latest_model.predict_proba(x_dev)
                      - b.latest_model.predict_proba(x_dev)).abs().max())

    with ledger.aside():
        lin1, log1 = streams(xh, {"device": cuda0})
    calls = []
    real = psl.lin_batch_stats

    def counted(*a):
        calls.append(a[0].shape[0])
        return real(*a)

    psl.lin_batch_stats = counted
    try:
        (lin4, log4), s_c = timed(lambda: streams(xh, {"mesh": mesh4}))
    finally:
        psl.lin_batch_stats = real
    check(calls == [MC_LIN_ROWS // MC_DATA] * (MC_DATA * n_b),
          f"the linear stream's batches did not run a shard each: {calls[:8]}")
    g_lin, g_log = rel(theta(lin4.latest_model), theta(lin1.latest_model)), proba_gap(log4, log1)
    with ledger.aside():
        with tf32_matmuls():
            c_lin = rel(theta(streams(xh, {"mesh": mesh4})[0].latest_model),
                        theta(lin1.latest_model))
        c_log = proba_gap(streams(bf16_round(xh), {"mesh": mesh4})[1], log1)
    check(g_lin <= MC_LIN_TOL < c_lin, f"the (4, 1) linear stream {g_lin:.3g} of the largest "
          f"coefficient from one device, TF32 control {c_lin:.3g} (limit {MC_LIN_TOL:g})")
    check(g_log <= MC_LOGIT_TOL < c_log, f"the (4, 1) logistic stream's probabilities "
          f"{g_log:.3g} from one device, bf16 control {c_log:.3g} (limit {MC_LOGIT_TOL:g})")
    say(f"mesh clustering (c) the streaming regressions on the stage's {len(xh)} hospital rows "
        f"in {n_b} batches of {MC_LIN_ROWS} over (4, 1) ({MC_LIN_ROWS // MC_DATA} rows a shard, "
        f"sharded at the default threshold): {s_c:.3f} s for both streams; linear "
        f"{g_lin:.3g} of the largest coefficient from one device (limit {MC_LIN_TOL:g}; TF32 "
        f"control {c_lin:.3g}); logistic probabilities {g_log:.3g} apart (limit "
        f"{MC_LOGIT_TOL:g}; bf16 control {c_log:.3g}) ({card})")
    del x_dev
    lap("mc (c)")

    # ------------------------------- (d) KMeans k=256: checkpoint, bf16
    kkw = dict(k=K, seed=SEED, max_iter=MC_KM_ITERS, tol=0.0, warm_start_centers=init)
    one2 = port.device_dataset(x2, device=cuda0)
    sds4 = sharding.shard_dataset(one2, mesh4)
    (plain, k1_plain), s_plain = timed(lambda: launched(
        lambda: port.KMeans(**kkw).fit(sds4), "fused_lloyd_stats"))
    check(k1_plain == MC_DATA * (plain.n_iter + 1), f"(d) the (4, 1) fit launched K1 "
          f"{k1_plain} times over {plain.n_iter} steps")
    with tempfile.TemporaryDirectory() as tmp:
        est = port.KMeans(checkpoint_dir=tmp, checkpoint_every=1, **kkw)

        def bomb(it, cost, move):
            if it == MC_KILL_AT:
                raise _Killed()

        try:
            est.fit(sds4, on_iteration=bomb)
            fail("(d) the kill did not fire")
        except _Killed:
            pass
        seen = []
        resumed, s_res = timed(lambda: est.fit(sds4, on_iteration=lambda it, c, m: seen.append(it)))
    check(seen[0] == MC_KILL_AT + 1 and same_kmeans(resumed, plain),
          f"(d) the resumed fit (from step {seen[0]}) differs from the uninterrupted one")
    sds22 = sharding.shard_dataset(one2, mesh(2, 2))
    hkw = dict(k=K, seed=SEED, max_iter=MAX_ITER, warm_start_centers=init)
    hi22, s_hi = timed(lambda: port.KMeans(**hkw).fit(sds22))
    (bf22, k2_bf), s_bf = timed(lambda: launched(
        lambda: port.KMeans(matmul_precision="bf16", **hkw).fit(sds22), "fused_assign"))
    rel_bf = abs(bf22.training_cost / hi22.training_cost - 1)
    check(np.isfinite(bf22.training_cost) and rel_bf <= BF16_COST_RTOL["bf16"]
          and float(bf22.cluster_sizes.sum()) == len(x2) and k2_bf == 4,
          f"(d) (2, 2) bf16 against (2, 2) highest: cost rel {rel_bf:.3g} (limit "
          f"{BF16_COST_RTOL['bf16']:g}), K2 {k2_bf} (the final exact pass: 4)")
    say(f"mesh clustering (d) KMeans k={K} over (4, 1) on the main path's first {len(x2)} rows, "
        f"checkpoint_dir: uninterrupted {s_plain:.3f} s (n_iter {plain.n_iter}, K1 {k1_plain}); "
        f"killed after step {MC_KILL_AT}, resumed from step {seen[0]} in {s_res:.3f} s == the "
        f"uninterrupted fit; (2, 2) bf16 {s_bf:.3f} s (n_iter {bf22.n_iter}) against (2, 2) "
        f"highest {s_hi:.3f} s (n_iter {hi22.n_iter}): cost rel {rel_bf:.3g} (limit "
        f"{BF16_COST_RTOL['bf16']:g}) ({card})")
    del one2, sds4, sds22
    lap("mc (d)")

    # ----------------------------------------- (e) GaussianMixture k=32
    gkw = dict(k=GMM_K, max_iter=GMM_ITERS, tol=0.0, seed=SEED)
    g_plain, s_g = timed(lambda: port.GaussianMixture(**gkw).fit(xh, mesh=mesh4))
    with tempfile.TemporaryDirectory() as tmp:
        gest = port.GaussianMixture(checkpoint_dir=tmp, checkpoint_every=2, **gkw)

        def gbomb(it, ll):
            if it == MC_KILL_AT:
                raise _Killed()

        try:
            gest.fit(xh, mesh=mesh4, on_iteration=gbomb)
            fail("(e) the kill did not fire")
        except _Killed:
            pass
        gseen = []
        g_res, s_gr = timed(lambda: gest.fit(xh, mesh=mesh4,
                                             on_iteration=lambda it, ll: gseen.append(it)))
    check(gseen[0] == MC_KILL_AT and same_gmm(g_res, g_plain),
          f"(e) the resumed GMM (from iteration {gseen[0]}) differs from the uninterrupted one")
    say(f"mesh clustering (e) GaussianMixture k={GMM_K} over (4, 1) on the {len(xh)} hospital "
        f"rows, checkpoint_dir: uninterrupted {s_g:.3f} s ({g_plain.n_iter} EM iterations); "
        f"killed after iteration {MC_KILL_AT}, resumed from iteration {gseen[0]} (the commit "
        f"at {gseen[0] - 1}) in {s_gr:.3f} s == the uninterrupted fit ({card})")
    lap("mc (e)")

    # ------------------------------------------------ (f) bulk scoring
    chunk = family("rows").round_rows(DEFAULT_CHUNK_ROWS, mesh4)
    n_chunks = -(-len(x_host) // chunk)
    (scored, k2_bulk), s_bulk = timed(lambda: launched(
        lambda: port.serve.bulk_score(model, x_host, mesh=mesh4), "fused_assign"))
    check(np.array_equal(scored, pred_h) and k2_bulk == MC_DATA * n_chunks,
          f"(f) bulk_score over (4, 1): == predict {np.array_equal(scored, pred_h)}, K2 "
          f"{k2_bulk} (want {MC_DATA} a chunk x {n_chunks})")
    scorer = port.serve.ShardedScorer(model, mesh=mesh4)
    (got, k2_sc), s_sc = timed(lambda: launched(lambda: scorer.warmup().score(x_host),
                                                "fused_assign"))
    check(np.array_equal(got, pred_h) and k2_sc == MC_DATA * (n_chunks + 1),
          f"(f) ShardedScorer over (4, 1): == predict {np.array_equal(got, pred_h)}, K2 {k2_sc}")
    sds10 = sharding.shard_dataset(ds, mesh4)
    (a, k2_acc), s_acc = timed(lambda: launched(lambda: assign_clusters_chunked(
        sds10.x, torch.from_numpy(model.cluster_centers)), "fused_assign"))
    check(np.array_equal(P.unpad(a, len(x_host)), pred_h) and k2_acc == MC_DATA,
          f"(f) assign_clusters_chunked over (4, 1): K2 {k2_acc}")
    with ledger.aside():
        xc = torch.from_numpy(np.ascontiguousarray(x_host[:chunk // MC_DATA])).to(cuda0)
        k2_shapes.append(k2_record(L, xc, torch.from_numpy(model.cluster_centers).to(cuda0),
                                   f"bulk_score (4, 1) shard chunk n={chunk // MC_DATA}", 20))
        del xc
    say(f"mesh clustering (f) scoring the main path's {len(x_host)} rows over (4, 1): "
        f"bulk_score {s_bulk:.3f} s, {n_chunks} chunks of {chunk} rows, K2 {k2_bulk} ({MC_DATA} "
        f"a chunk); ShardedScorer warmup + score {s_sc:.3f} s, K2 {k2_sc}; "
        f"assign_clusters_chunked {s_acc:.3f} s, K2 {k2_acc}; each == predict ({card})")
    del sds10, a, scored, got
    lap("mc (f)")

    launches = ledger.main_path()
    say(f"mesh_clustering_phase: {time.perf_counter() - t_phase:.2f} s of host clock ({card}); "
        f"main-path launches {json.dumps(launches)}")
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "k1": k1_shapes, "k2": k2_shapes}


# ------------------------------------------------------------- slice 8c-2
MO_DATA = 4                   # (a)-(e): a (4, 1) mesh over cuda:0
MO_SUB_N = 2_000_000          # (a)'s (2, 2) leg, its kill and its control: the first 2M rows
MO_KILL_AT = 3                # (a): the (4, 1) fit killed after this step
MO_KILL_ITERS = 6             # (a): the killed fit's steps (tol 0)
MO_GBT_ROUNDS = 5             # (d): gbt20's rows, 5 of its 20 rounds (the phase's time)
MO_FOREST_N = TREE_N // 2     # (d): the forest legs (`==` one device) on rf20's first 1M
                              # rows in 4 blocks (half the rows: the script's time)
#: (b) against the one-device out-of-core fit on the card, about 10x the
#: first gaps (NVIDIA H100 80GB HBM3, 700 W: LinearRegression 4.66e-7 of the
#: largest coefficient, far inside queue 3's 1e-4, where TF32 products read
#: 2.68e-6 and cannot serve as the control; the binomial probabilities
#: 5.96e-7), each beside bf16-rounded rows
MO_LR_TOL = 4.7e-6
MO_LOGIT_TOL = 6e-6
MO_GMM_TOL = MM_GMM_TOL       # (c): mesh_models_phase's GMM limits


def mesh_link_and_fill(hd, mesh, b: int) -> tuple[float, float, int]:
    """The link and the host fill of one staged block over ``mesh``: its D
    segments pinned -> the card in one copy (entries sharing the card),
    CUDA events; and one block's segments filled from the memmap (host
    clock).  → (copy ms, fill ms, staged bytes)."""
    import torch

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.parallel import (
        outofcore,
    )

    lay = outofcore._Layout(mesh, b, hd._width(b // mesh.devices.shape[0]), True)
    width = len(lay.local) * lay.seg
    pinned = torch.empty((width,), dtype=torch.float32, pin_memory=True)
    on_dev = torch.empty((width,), dtype=torch.float32, device=DEV)
    copy_ms = gpu_ms(lambda: on_dev.copy_(pinned, non_blocking=True), 10)
    t0 = time.perf_counter()
    for i in range(3):
        hd._stage(lay, pinned.numpy(), i)
    return copy_ms, (time.perf_counter() - t0) / 3 * 1e3, width * 4


def same_forest(a, b) -> bool:
    import numpy as np

    return all(np.array_equal(getattr(a, n), getattr(b, n))
               for n in ("split_feat", "threshold", "value"))


def mesh_outofcore_phase(port, L, H, card: str, x_host, init) -> dict:
    """Slice 8c-2: the out-of-core fits over virtual meshes of ``cuda:0``,
    each leg against the one-device out-of-core fit on the card.  (a)
    KMeans k=256 on the main path's 10M x 8 rows (``x_host``) memory-mapped,
    in blocks of 2**20, warm-started from its init centers (``init``): over (4, 1)
    (K1 once a shard a block a step), (1, 1) ``==`` one device, the same
    n_iter, centers and cost within the out-of-core limits; the epoch, the
    fill and the copy of a block, and peak device memory against two
    blocks + k-state + K1 workspace + 1 MiB; over (2, 2) on the first 2M
    rows (K2 + the owner-masked K1 a (data, model) shard) within the same
    limits, beside a bf16-rounded control; integer rows ``==``; killed
    after step ``MO_KILL_AT`` over (4, 1) and resumed ``==`` the
    uninterrupted fit.  (b) LinearRegression and binomial LogisticRegression
    on the stage's 2M hospital rows in blocks of 2**18 over (4, 1).  (c)
    GaussianMixture k=32, config 3's 2M x 8, in blocks of 2**19 over (4, 1),
    killed and resumed ``==``.  (d) the rf20 forest shape (its first
    ``MO_FOREST_N`` rows) in blocks of 2**18 over (4, 1) on integer LOS,
    without and with bootstrap, ``==`` one device, K3 4 x blocks x levels; GBT on gbt20's rows (integer labels)
    over (4, 1).  (e) BisectingKMeans on config 4 over (4, 1) and (2, 2):
    the same splits and sizes, centers within ``BISECT_CENTER_TOL``,
    ``==`` on integer rows.  K1 / K2 and K3 against their plain versions at
    the new shard shapes.  → {"launches": the main path's K1 / K2 / K3,
    "k1", "k2", "k3": shape records}."""
    import numpy as np
    import torch

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel as P
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models.tree import (
        engine,
    )

    t_phase = time.perf_counter()
    ledger = LaunchLedger(L)
    k3_aside = [0]
    k3_start = H.launch_counts()["fused_level_hist"]
    cuda0 = torch.device("cuda", 0) if DEV == "cuda" else torch.device(DEV)

    def mesh(data: int, model: int = 1):
        return P.build_mesh(port.MeshConfig(data=data, model=model), [cuda0] * (data * model))

    @contextlib.contextmanager
    def aside():
        k3 = H.launch_counts()["fused_level_hist"]
        with ledger.aside():
            yield
        k3_aside[0] += H.launch_counts()["fused_level_hist"] - k3

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    mesh4 = mesh(MO_DATA)
    k1_shapes, k2_shapes, k3_shapes = [], [], []
    sms = torch.cuda.get_device_properties(0).multi_processor_count if DEV == "cuda" else 132
    tmp = tempfile.mkdtemp(prefix="mooc-")
    try:
        # --------------------------------------- (a) KMeans k=256, 10M rows
        np.save(os.path.join(tmp, "kmeans.npy"), x_host)
        x = np.load(os.path.join(tmp, "kmeans.npy"), mmap_mode="r")
        hd = port.HostDataset(x=x, max_device_rows=OOC_BLOCK)
        n_blocks, b = hd.block_shape(mesh4)
        check(b == OOC_BLOCK and hd.block_shape() == (n_blocks, b),
              f"(a) block_shape over (4, 1) {hd.block_shape(mesh4)} differs from one device's")
        copy_ms, fill_ms, staged = mesh_link_and_fill(hd, mesh4, b)
        kw = dict(k=K, seed=SEED, max_iter=MAX_ITER, warm_start_centers=init)
        with aside():
            one, s_one = timed(lambda: port.KMeans(**kw).fit(hd, device=cuda0))
            m11 = port.KMeans(**kw).fit(hd, mesh=mesh(1))
        check(np.array_equal(m11.cluster_centers, one.cluster_centers)
              and m11.training_cost == one.training_cost and m11.n_iter == one.n_iter,
              "(a) KMeans out of core over (1, 1) differs from one device")
        k_pad_floats = 8 * (K * (D + 1) + 1) * 4
        plan = L.lloyd_plan(b // MO_DATA, D, K, sms,
                            L._stats_occupancy(cuda0, D, K)) if DEV == "cuda" else \
            {"partial_floats": 0}
        sync()
        if DEV == "cuda":
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        stamps = []
        k1_0 = L.launch_counts()["fused_lloyd_stats"]
        m4, s4 = timed(lambda: port.KMeans(**kw).fit(
            hd, mesh=mesh4, on_iteration=lambda it, c, m: stamps.append(time.perf_counter())))
        peak = torch.cuda.max_memory_allocated() - base if DEV == "cuda" else 0
        k1_4 = L.launch_counts()["fused_lloyd_stats"] - k1_0
        check(k1_4 == MO_DATA * n_blocks * (m4.n_iter + 1),
              f"(a) KMeans over (4, 1) launched K1 {k1_4} times (want 4 x {n_blocks} blocks x "
              f"(n_iter {m4.n_iter} + 1))")
        bound = 2 * staged + k_pad_floats + plan["partial_floats"] * 4 + (1 << 20)
        check(peak <= bound, f"(a) peak device memory {peak} B above the bound {bound} B = 2 "
                             f"blocks x {staged} + k-state {k_pad_floats} + K1 workspace "
                             f"{plan['partial_floats'] * 4} + 1 MiB")
        g4 = kmeans_gaps(m4, one)
        check(m4.n_iter == one.n_iter and g4["centers"] <= OOC_KMEANS_TOL["centers"]
              and g4["cost_rel"] <= OOC_KMEANS_TOL["cost_rel"],
              f"(a) KMeans over (4, 1) vs one device: n_iter {m4.n_iter} / {one.n_iter}, {g4} "
              f"(limits {OOC_KMEANS_TOL})")
        epoch_ms = float(np.median(np.diff(stamps))) * 1e3 if len(stamps) > 1 else s4 * 1e3
        with aside():
            c_shard = torch.from_numpy(np.array(x[:b // MO_DATA])).to(cuda0)
            w_shard = torch.ones((b // MO_DATA,), device=cuda0)
            cen = torch.from_numpy(m4.cluster_centers).to(cuda0)
            r1, _ = mesh_case(L, c_shard, w_shard, cen, torch.ones((K,), device=cuda0),
                              f"(4, 1) block shard n={b // MO_DATA}")
            k1_shapes.append(r1)
            del c_shard, w_shard
        say(f"mesh out of core (a) KMeans k={K} on the main path's {N} x {D} memmapped rows, "
            f"{n_blocks} blocks of {b}, warm-started from its init: one device {s_one:.3f} s, "
            f"(4, 1) {s4:.3f} s (n_iter {m4.n_iter}, K1 {k1_4} = 4 a block a step), (1, 1) == "
            f"one device; epoch {epoch_ms:.1f} ms (median of {max(len(stamps) - 1, 0)}); a block's "
            f"host fill {fill_ms:.2f} ms and copy {copy_ms:.3f} ms ({staged} B in one copy, the "
            f"4 shards its segments); peak device memory {peak / 2**20:.1f} MiB <= bound "
            f"{bound / 2**20:.1f} MiB; vs one device: centers {g4['centers']:.3g} (limit "
            f"{OOC_KMEANS_TOL['centers']:g}), cost rel {g4['cost_rel']:.3g} (limit "
            f"{OOC_KMEANS_TOL['cost_rel']:g}) ({card})")
        del one, m11, m4
        lap("mo (a) 10M")

        # (2, 2) on the first 2M rows: K2 + the owner-masked K1, and its control
        xs = np.array(x[:MO_SUB_N])
        hs = port.HostDataset(x=xs, max_device_rows=OOC_BLOCK)
        with aside():
            one2 = port.KMeans(**kw).fit(hs, device=cuda0)
        k2_0 = L.launch_counts()["fused_assign"]
        m22, s22 = timed(lambda: port.KMeans(**kw).fit(hs, mesh=mesh(2, 2)))
        k2_22 = L.launch_counts()["fused_assign"] - k2_0
        g22 = kmeans_gaps(m22, one2)
        with aside():
            ctl = port.KMeans(**kw).fit(port.HostDataset(x=bf16_round(xs),
                                                         max_device_rows=OOC_BLOCK),
                                        mesh=mesh(2, 2))
        gc = kmeans_gaps(ctl, one2)
        check(m22.n_iter == one2.n_iter and g22["centers"] <= OOC_KMEANS_TOL["centers"]
              and g22["cost_rel"] <= OOC_KMEANS_TOL["cost_rel"]
              and (gc["centers"] > OOC_KMEANS_TOL["centers"]
                   or gc["cost_rel"] > OOC_KMEANS_TOL["cost_rel"]),
              f"(a) KMeans over (2, 2) vs one device: {g22}, bf16 control {gc} (limits "
              f"{OOC_KMEANS_TOL})")
        check(k2_22 == 4 * hs.block_shape(mesh(2, 2))[0] * (m22.n_iter + 1),
              f"(a) (2, 2) launched K2 {k2_22} times")
        with aside():
            half = hs.block_shape(mesh(2, 2))[1] // 2
            xr = torch.from_numpy(np.ascontiguousarray(xs[:half])).to(cuda0)
            cen = torch.from_numpy(np.ascontiguousarray(m22.cluster_centers[:K // 2])).to(cuda0)
            r1, r2 = mesh_case(L, xr, torch.ones((half,), device=cuda0), cen,
                               torch.ones((K // 2,), device=cuda0),
                               f"(2, 2) block shard n={half} k={K // 2}")
            k1_shapes.append(r1)
            k2_shapes.append(r2)
            del xr

        # killed after step MO_KILL_AT over (4, 1), resumed
        kkw = dict(kw, max_iter=MO_KILL_ITERS, tol=0.0)
        plain = port.KMeans(**kkw).fit(hs, mesh=mesh4)
        ck = os.path.join(tmp, "km-ck")

        def bomb(it, cost, move):
            if it == MO_KILL_AT:
                raise _Killed()

        try:
            port.KMeans(checkpoint_dir=ck, checkpoint_every=1, **kkw).fit(
                hs, mesh=mesh4, on_iteration=bomb)
            fail("(a) the kill did not fire")
        except _Killed:
            pass
        seen = []
        res = port.KMeans(checkpoint_dir=ck, checkpoint_every=1, **kkw).fit(
            hs, mesh=mesh4, on_iteration=lambda it, c, m: seen.append(it))
        check(seen[:1] == [MO_KILL_AT + 1]
              and kmeans_gaps(res, plain) == {"centers": 0.0, "cost_rel": 0.0, "moved": 0},
              f"(a) the resumed (4, 1) fit (from step {seen[:1]}) differs from the uninterrupted")
        # integer rows: == one device, over (4, 1) and (2, 2)
        rng = np.random.default_rng(0)
        cen_i = rng.integers(-30, 30, size=(EXACT_K, D))
        xi = (cen_i[rng.integers(0, EXACT_K, size=EXACT_N)]
              + rng.integers(-2, 3, size=(EXACT_N, D))).astype(np.float32)
        hi = port.HostDataset(x=xi, max_device_rows=EXACT_BLOCK)
        with aside():
            one_i = port.KMeans(k=EXACT_K, seed=SEED).fit(hi, device=cuda0)
        for shape in ((MO_DATA, 1), (2, 2)):
            mi = port.KMeans(k=EXACT_K, seed=SEED).fit(hi, mesh=mesh(*shape))
            check(np.array_equal(mi.cluster_centers, one_i.cluster_centers)
                  and np.array_equal(mi.cluster_sizes, one_i.cluster_sizes)
                  and mi.n_iter == one_i.n_iter,
                  f"(a) integer rows over {shape} differ from one device")
        say(f"mesh out of core (a) (2, 2) on the first {MO_SUB_N} rows: {s22:.3f} s, n_iter "
            f"{m22.n_iter}, K2 {k2_22} (4 a block a step), centers {g22['centers']:.3g}, cost "
            f"rel {g22['cost_rel']:.3g} (bf16-rounded control {gc['centers']:.3g} / "
            f"{gc['cost_rel']:.3g}); (4, 1) killed after step {MO_KILL_AT}, resumed == the "
            f"uninterrupted fit; integer rows ({EXACT_N} x {D}, blocks of {EXACT_BLOCK}) over "
            f"(4, 1) and (2, 2) == one device ({card})")
        del x, hd, xs, hs, one2, m22, ctl, plain, res, xi, hi
        lap("mo (a)")

        # ---------------------- (b) LinearRegression and binomial logistic
        xh, _, yb = stage_rows()
        xh = xh.astype(np.float32)
        los = STAGE_ROWS["los"]
        hl = port.HostDataset(x=xh, y=los, max_device_rows=LR_OOC_BLOCK)
        with aside():
            lr1 = port.LinearRegression().fit(hl, device=cuda0)
        lr4, s_lr = timed(lambda: port.LinearRegression().fit(hl, mesh=mesh4))
        with aside():
            lrc = port.LinearRegression().fit(port.HostDataset(
                x=bf16_round(xh), y=los, max_device_rows=LR_OOC_BLOCK), mesh=mesh4)
        lg, lc = lr_gap(lr4, lr1), lr_gap(lrc, lr1)
        check(lg <= MO_LR_TOL < lc,
              f"(b) LinearRegression over (4, 1): {lg:.3g} of the largest coefficient from one "
              f"device, bf16 control {lc:.3g} (limit {MO_LR_TOL:g})")
        est = port.LogisticRegression(tol=CLS_TOL)
        hb = port.HostDataset(x=xh, y=yb, max_device_rows=LR_OOC_BLOCK)
        with aside():
            a = est.fit(hb, device=cuda0)
        bm, s_lg = timed(lambda: est.fit(hb, mesh=mesh4))
        with aside():
            c = est.fit(port.HostDataset(x=bf16_round(xh), y=yb, max_device_rows=LR_OOC_BLOCK),
                        mesh=mesh4)
        xt = torch.from_numpy(xh).to(cuda0)
        pa = a.predict_proba(xt)
        gap = float((bm.predict_proba(xt) - pa).abs().max())
        ctl_gap = float((c.predict_proba(xt) - pa).abs().max())
        check(gap <= MO_LOGIT_TOL < ctl_gap and a.n_iter == bm.n_iter,
              f"(b) binomial logistic over (4, 1): probabilities {gap:.3g} apart, n_iter "
              f"{bm.n_iter} / {a.n_iter}, bf16 control {ctl_gap:.3g} (limit {MO_LOGIT_TOL:g})")
        say(f"mesh out of core (b) on the stage's {len(xh)} hospital rows in blocks of "
            f"{LR_OOC_BLOCK} over (4, 1) against one device: LinearRegression {s_lr:.3f} s, "
            f"{lg:.3g} of the largest coefficient (limit {MO_LR_TOL:g}; bf16 control "
            f"{lc:.3g}); binomial "
            f"LogisticRegression {s_lg:.3f} s, n_iter {bm.n_iter} == one device's, probabilities "
            f"{gap:.3g} apart (limit {MO_LOGIT_TOL:g}; bf16 control {ctl_gap:.3g}) ({card})")
        del xt, pa, hl, hb
        lap("mo (b)")

        # ------------------------------------------------ (c) GMM k=32
        xg, xgm = ooc_rows(GMM_OOC_N, D, GMM_K, tmp, "gmm")
        hg = port.HostDataset(x=xgm, max_device_rows=GMM_OOC_BLOCK)
        gkw = dict(k=GMM_K, max_iter=GMM_ITERS, tol=0.0, seed=SEED)

        def gmm_gaps(p, q) -> dict:
            return {"means": float(np.abs(p.means - q.means).max()),
                    "weights": float(np.abs(p.weights - q.weights).max()),
                    "ll_rel": abs(p.log_likelihood / q.log_likelihood - 1)}

        with aside():
            g1 = port.GaussianMixture(**gkw).fit(hg, device=cuda0)
        g4m, s_g = timed(lambda: port.GaussianMixture(**gkw).fit(hg, mesh=mesh4))
        with aside():
            gctl = port.GaussianMixture(**gkw).fit(port.HostDataset(
                x=bf16_round(xg), max_device_rows=GMM_OOC_BLOCK), mesh=mesh4)
        gg, gcg = gmm_gaps(g4m, g1), gmm_gaps(gctl, g1)
        check(all(gg[k] <= MO_GMM_TOL[k] < gcg[k] for k in MO_GMM_TOL),
              f"(c) GMM over (4, 1) {gg}, bf16 control {gcg} (limits {MO_GMM_TOL})")
        gest = port.GaussianMixture(checkpoint_dir=os.path.join(tmp, "g-ck"),
                                    checkpoint_every=1, **gkw)

        def gbomb(it, ll):
            if it == MO_KILL_AT:
                raise _Killed()

        try:
            gest.fit(hg, mesh=mesh4, on_iteration=gbomb)
            fail("(c) the kill did not fire")
        except _Killed:
            pass
        gseen = []
        gres = gest.fit(hg, mesh=mesh4, on_iteration=lambda it, ll: gseen.append(it))
        check(gseen[:1] == [MO_KILL_AT + 1] and same_gmm(gres, g4m),
              f"(c) the resumed GMM (from iteration {gseen[:1]}) differs from the uninterrupted")
        say(f"mesh out of core (c) GaussianMixture k={GMM_K} on {GMM_OOC_N} x {D} rows in blocks "
            f"of {GMM_OOC_BLOCK} over (4, 1): {s_g:.3f} s ({GMM_ITERS} EM iterations); vs one "
            f"device " + ", ".join(f"{k} {gg[k]:.3g} (limit {MO_GMM_TOL[k]:g}; bf16 "
                                   f"{gcg[k]:.3g})" for k in MO_GMM_TOL)
            + f"; killed after iteration {MO_KILL_AT}, resumed == the uninterrupted fit ({card})")
        del xg, xgm, hg
        lap("mo (c)")

        # ----------------------------- (d) the rf20 forest shape, and GBT
        rng = np.random.default_rng(0)
        cols = make_table_columns(MO_FOREST_N, D, 16, 0)
        xf = np.stack([cols[f"f{j}"] for j in range(D)], axis=1)
        del cols
        xf = ((xf - xf.mean(axis=0)) / xf.std(axis=0)).astype(np.float32)
        yf = xf @ rng.normal(size=(D,)) + rng.normal(0.0, 0.3, size=MO_FOREST_N)
        yi = np.clip(np.round(yf + 1.5), 0, 3).astype(np.float32)       # integer LOS 0..3
        np.save(os.path.join(tmp, "forest.npy"), xf)
        hf = port.HostDataset(x=np.load(os.path.join(tmp, "forest.npy"), mmap_mode="r"), y=yi,
                              max_device_rows=FOREST_BLOCK)
        fb = hf.block_shape(mesh4)[0]
        fkw = dict(task="regression", num_trees=20, max_depth=5, seed=0)
        lines = []
        for boot in (False, True):
            with aside():
                f1 = engine.grow_forest_outofcore(hf, device=cuda0, bootstrap=boot, **fkw)
            k3_0 = H.launch_counts()["fused_level_hist"]
            f4, s_f = timed(lambda: engine.grow_forest_outofcore(hf, mesh=mesh4, bootstrap=boot,
                                                                 **fkw))
            k3_f = H.launch_counts()["fused_level_hist"] - k3_0
            check(same_forest(f4, f1) and k3_f == MO_DATA * fb * (fkw["max_depth"] + 1),
                  f"(d) the forest over (4, 1) (bootstrap {boot}) differs from one device or "
                  f"launched K3 {k3_f} times (want 4 x {fb} blocks x 6 levels)")
            lines.append(f"bootstrap {boot} {s_f:.3f} s, K3 {k3_f}, == one device")
        rf = port.RandomForestRegressor(num_trees=20, max_depth=5, seed=0,
                                        feature_subset_strategy="all").fit(hf, mesh=mesh4)
        check(np.array_equal(rf.split_feat, f4.split_feat),
              "(d) RandomForestRegressor over (4, 1) differs from the engine's forest")
        xb_, yb_ = gbt_data()
        yg = np.clip(np.round(yb_), -4, 4).astype(np.float32)             # integer labels
        hgb = port.HostDataset(x=xb_, y=yg, max_device_rows=GBT_BLOCK)
        gbkw = dict(max_iter=MO_GBT_ROUNDS, max_depth=GBT_DEPTH, seed=0)
        with aside():
            b1 = port.GBTRegressor(**gbkw).fit(hgb, device=cuda0)
        b4, s_b = timed(lambda: port.GBTRegressor(**gbkw).fit(hgb, mesh=mesh4))
        with aside():
            bc = port.GBTRegressor(**gbkw).fit(port.HostDataset(
                x=bf16_round(xb_), y=yg, max_device_rows=GBT_BLOCK), mesh=mesh4)
        vg = float(np.abs(b4.value - b1.value).max())
        vc = float(np.abs(bc.value - b1.value).max()) if bc.value.shape == b1.value.shape \
            else float("inf")
        check(np.array_equal(b4.split_feat, b1.split_feat) and vg <= GBT_OOC_VALUE_TOL < vc,
              f"(d) GBT over (4, 1): splits equal {np.array_equal(b4.split_feat, b1.split_feat)}"
              f", values {vg:.3g} (limit {GBT_OOC_VALUE_TOL:g}; bf16 control {vc:.3g})")
        with aside():
            ins = k3_inputs(FOREST_BLOCK // MO_DATA, D, 3, 20, 32, 32, seed=70)
            err, _ = k3_check(H, *ins, 32, 32, "(4, 1) forest block shard")
            t = k3_time(H, *ins, 32, 32, reps=20)
            k3_shapes.append({"n": FOREST_BLOCK // MO_DATA, "d": D, "S": 3, "T": 20, "LN": 32,
                              "B": 32, "max_abs_err": err, **t})
            del ins
        say(f"mesh out of core (d) the rf20 forest shape ({MO_FOREST_N} x {D}, {fb} blocks of "
            f"{FOREST_BLOCK}, integer LOS) over (4, 1): " + "; ".join(lines)
            + f"; RandomForestRegressor.fit == the engine; GBT {MO_GBT_ROUNDS} rounds on gbt20's "
            f"rows (integer labels) {s_b:.3f} s, the same splits, values {vg:.3g} (limit "
            f"{GBT_OOC_VALUE_TOL:g}; bf16 control {vc:.3g}); K3 at the shard (n="
            f"{FOREST_BLOCK // MO_DATA} d={D} S=3 T=20 LN=32 B=32) {t['ms']:.4f} ms (plain "
            f"{t['plain_ms']:.4f}, library {t['library_ms']:.4f}, bound {t['bound_ms']:.4f} by "
            f"{t['bound_by']}), max_abs_err {err:.3g} ({card})")
        del xf, yf, yi, hf, xb_, yb_, hgb
        lap("mo (d)")

        # ------------------------------------------ (e) BisectingKMeans
        xbk = make_data(BISECT_N, D, BISECT_K)
        hbk = port.HostDataset(x=xbk, max_device_rows=BISECT_OOC_BLOCK)
        bkw = dict(k=BISECT_K, seed=SEED, n_restarts=1)
        with aside():
            k1b = port.BisectingKMeans(**bkw).fit(hbk, device=cuda0)
            ctlb = port.BisectingKMeans(**bkw).fit(port.HostDataset(
                x=bf16_round(xbk), max_device_rows=BISECT_OOC_BLOCK), mesh=mesh4)
        c_ctl = bisect_gaps(ctlb, k1b)["centers"]
        lines = []
        for shape in ((MO_DATA, 1), (2, 2)):
            mb, s_bk = timed(lambda: port.BisectingKMeans(**bkw).fit(hbk, mesh=mesh(*shape)))
            g = bisect_gaps(mb, k1b)
            check(g["splits"] == 0 and g["sizes"] == 0.0 and g["centers"] <= BISECT_CENTER_TOL
                  < c_ctl, f"(e) bisecting over {shape}: {g}, bf16 control {c_ctl:.3g} (limit "
                           f"{BISECT_CENTER_TOL:g})")
            lines.append(f"{shape} {s_bk:.3f} s, centers {g['centers']:.3g}")
        rng = np.random.default_rng(SEED + 8)
        cen_b = rng.integers(-3, 4, size=(BISECT_K, D))
        xbi = (cen_b[rng.integers(0, BISECT_K, EXACT_N)]
               + rng.integers(-1, 2, size=(EXACT_N, D))).astype(np.float32)
        hbi = port.HostDataset(x=xbi, max_device_rows=EXACT_BLOCK)
        with aside():
            one_b = port.BisectingKMeans(**bkw).fit(hbi, device=cuda0)
        for shape in ((MO_DATA, 1), (2, 2)):
            mb = port.BisectingKMeans(**bkw).fit(hbi, mesh=mesh(*shape))
            check(bisect_gaps(mb, one_b) == {"centers": 0.0, "sizes": 0.0, "splits": 0},
                  f"(e) bisecting integer rows over {shape}: {bisect_gaps(mb, one_b)}")
        say(f"mesh out of core (e) BisectingKMeans config 4 ({BISECT_N} x {D}, k={BISECT_K}, "
            f"blocks of {BISECT_OOC_BLOCK}) against one device: " + "; ".join(lines)
            + f" (limit {BISECT_CENTER_TOL:g}; bf16 control {c_ctl:.3g}), the same splits and "
            f"sizes; integer rows ({EXACT_N}) over (4, 1) and (2, 2) == ({card})")
        del xbk, hbk, xbi, hbi
        lap("mo (e)")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    launches = ledger.main_path()
    launches["fused_level_hist"] = (H.launch_counts()["fused_level_hist"] - k3_start
                                    - k3_aside[0])
    say(f"mesh_outofcore_phase: {time.perf_counter() - t_phase:.2f} s of host clock ({card}); "
        f"main-path launches {json.dumps(launches)}")
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "k1": k1_shapes, "k2": k2_shapes, "k3": k3_shapes}


# ------------------------------------------------------------- slice 8c-3
ME_DATA = 4                   # (a)-(d): a (4, 1) mesh over cuda:0
ME_TUNE_N = 250_000           # (d): the tuners' rows, the stage's first 250,000
ME_OOC_N = 1_000_000          # (a): the out-of-core legs on the stage's first 1M rows
ME_OOC_BLOCK = 1 << 17        # ... in 8 blocks (half the rows: the script's time)
ME_SHORT = 5                  # (c): the MLP's weights after 5 L-BFGS iterations
ME_EPOCHS = 3                 # (a), (c): the minibatch fits' epochs out of core
#: against the one-device fit on the card: about 10x the gaps of the first
#: chip run (NVIDIA H100 80GB HBM3, 700 W; a gap of 0 gets one
#: float32 ulp, 1.2e-7), each failing its control: the same mesh fit on
#: bfloat16-rounded rows, or, where Adam or L-BFGS on those rows lands
#: within 1.3x of the gap (the FM, the MLP, the minibatch fits out of
#: core), the same mesh fit one step or one epoch short.  n_iter, the
#: priors, the chosen index and the rows of the OneVsRest and NaiveBayes
#: legs are held exactly (AFT's n_iter within one: its stop compares a
#: loss change with tol); the MLP's whole 150-iteration fit is held by its
#: outcome, as families_phase holds it, and its n_iter is printed, not
#: held: the non-convex path parts after a few steps (133 against one
#: device's 115 on the comparison rows)
ME_LIMITS = {
    "svc": {"n_iter": 0, "coef": 6.6e-7},
    "svc_ooc": {"n_iter": 0, "coef": 1.2e-7},
    "nb_gaussian": {"pi": 0.0, "theta": 7.4e-7, "sigma": 4.5e-6},
    "nb_gaussian_ooc": {"pi": 0.0, "theta": 7.4e-7, "sigma": 4.5e-6},
    "ovr_logistic": {"n_iter": 0, "coef": 1.2e-6},
    "ovr_logistic_ooc": {"n_iter": 0, "coef": 1.2e-6},
    "glm_poisson": {"n_iter": 0, "coef": 2.7e-5, "deviance": 1.2e-7, "aic": 5.4e-8,
                    "se": 4.7e-6},
    "glm_gamma": {"n_iter": 0, "coef": 9.1e-6, "deviance": 1.2e-7, "aic": 1.04e-7,
                  "se": 1.4e-5},
    "glm_ooc": {"n_iter": 0, "coef": 1.3e-5, "deviance": 3.8e-7},
    "aft": {"n_iter": 1, "theta": 1.8e-6},
    "aft_ooc": {"theta": 1.3e-6},
    "fm": {"params": 4.3e-4},
    "fm_ooc": {"params": 1.4e-5},
    "mlp": {"w5": 1e-4, "loss": FAM_LIMITS["mlp"]["loss"], "rows": FAM_LIMITS["mlp"]["rows"]},
    "mlp_ooc": {"w": 1.2e-4},
    "pipe_lr": {"coef": 4.5e-7, "pred": 1.6e-6},
    "pipe_kmeans": {"n_iter": 0, "centers": 3.3e-4, "moved": 180},
    "cv_tree": {"index": 0, "metrics": 2.2e-7},
    "tvs_kmeans": {"index": 0, "metrics": 9.5e-4},
}
ME_EXACT = ("n_iter", "pi", "index", "rows")
ME_NO_CONTROL = {
    ("mlp", "loss"): "the whole non-convex fit is held by its outcome, as families_phase "
                     "holds the card against the CPU (FAM_LIMITS)",
    ("mlp", "rows"): "the same",
}


class ShapeLog:
    """The shapes of the K1, K2 and K3 launches the main path makes while
    the context is open and ``on`` (the models' kernel entry points
    wrapped): ``k1`` / ``k2`` hold (n, d, k), ``k3`` (n, d, S, T, LN, B)."""

    on = True

    def __enter__(self):
        from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models import (
            kmeans,
        )
        from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models.tree import (
            engine,
        )

        self.k1, self.k2, self.k3 = set(), set(), set()
        self.mods = (kmeans, kmeans, engine)
        self.names = ("fused_lloyd_stats", "fused_assign", "fused_level_hist")
        self.orig = [getattr(m, n) for m, n in zip(self.mods, self.names)]
        k1, k2, k3 = self.orig

        def stats(x, w, c, v):
            if self.on:
                self.k1.add((x.shape[0], x.shape[1], c.shape[0]))
            return k1(x, w, c, v)

        def assign(x, c, v):
            if self.on:
                self.k2.add((x.shape[0], x.shape[1], c.shape[0]))
            return k2(x, c, v)

        def hist(binned, base, w, pos, level_nodes, B):
            if self.on:
                self.k3.add((binned.shape[1], binned.shape[0], base.shape[0], w.shape[0],
                             level_nodes, B))
            return k3(binned, base, w, pos, level_nodes, B)

        for m, n, f in zip(self.mods, self.names, (stats, assign, hist)):
            setattr(m, n, f)
        return self

    def __exit__(self, *exc):
        for m, n, f in zip(self.mods, self.names, self.orig):
            setattr(m, n, f)


def theta_gap(a, b) -> float:
    """Two linear models' [coef | intercept] apart, of b's largest."""
    import numpy as np

    def th(m):
        c = m.coefficients
        c = c.cpu().numpy() if hasattr(c, "cpu") else np.asarray(c)
        return np.r_[c.astype(np.float64).ravel(), float(m.intercept)]

    return rel(th(a), th(b))


def mesh_estimators_phase(port, L, H, card: str) -> dict:
    """Slice 8c-3: the other estimators and the composites over virtual
    meshes of ``cuda:0`` at full width, each leg against the one-device fit
    on the card, on classification_phase's 2M hospital rows (``STAGE_ROWS``:
    the 4 features, LOS, ``LOS_binary`` and the 3 LOS tiers).  (a)
    LinearSVC, NaiveBayes (multinomial on the integer features cut to small
    counts, gaussian), ``OneVsRest(DecisionTreeClassifier(max_depth=5))``
    on the tiers (K3 once a data shard a level) and
    ``OneVsRest(LogisticRegression)`` over (1, 1), (4, 1) and (2, 2), and
    out of core on the first ``ME_OOC_N`` rows in 8 blocks over (4, 1).
    (b) GLM Poisson and Gamma-log
    with an offset column and the summary over (4, 1), and Poisson out of
    core.  (c) AFT on the families phase's 2M censored rows, FMRegressor
    and the MLP (4, 16, 2) at families_phase's comparisons' rows
    (``PREFIX``) and iteration counts over (4, 1), each out of core on the
    2M rows too (minibatch Adam, ``ME_EPOCHS`` epochs);
    IsotonicRegression over (4, 1).  (d) over (4, 1): Pipelines of scaler
    → LinearRegression and scaler → KMeans k=16 (K1 a shard a step), fit
    and transform; ``CrossValidator(DecisionTreeRegressor, max_depth ∈
    {3, 5}, 3 folds)`` on integer LOS and ``TrainValidationSplit(KMeans k
    ∈ {8, 16})`` with the silhouette (K2 a shard in the score) on the
    first ``ME_TUNE_N`` rows.  (1, 1) is ``==`` one device; NaiveBayes on
    counts, the trees, isotonic and the chosen indices ``==`` on every
    shape; every float leg within ``ME_LIMITS`` beside a bf16-rounded
    control.  Every K1 / K2 / K3 shard shape the legs launched is held
    against its plain version.  → {"launches", "k1", "k2", "k3"}."""
    import dataclasses

    import numpy as np
    import torch

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel as P

    t_phase = time.perf_counter()
    ledger = LaunchLedger(L)
    k3_aside = [0]
    k3_start = H.launch_counts()["fused_level_hist"]
    cuda0 = torch.device("cuda", 0) if DEV == "cuda" else torch.device(DEV)

    def mesh(data: int, model: int = 1):
        return P.build_mesh(port.MeshConfig(data=data, model=model), [cuda0] * (data * model))

    log = ShapeLog()

    @contextlib.contextmanager
    def aside():
        """References, controls and kernel-against-plain checks: off the
        main path's launch counts and shapes."""
        k3, on = H.launch_counts()["fused_level_hist"], log.on
        log.on = False
        with ledger.aside():
            yield
        log.on = on
        k3_aside[0] += H.launch_counts()["fused_level_hist"] - k3

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def held(name: str, gaps: dict, ctl: dict) -> str:
        return gated(ME_LIMITS, name, gaps, ctl, exact=ME_EXACT, no_control=ME_NO_CONTROL)

    x, los, yb = stage_rows()
    x = x.astype(np.float32)
    n = len(x)
    xb16 = bf16_round(x)
    tiers = np.digitize(los, np.quantile(los, [0.5, 0.85])).astype(np.float32)
    counts = np.floor(x[:, :3] / np.array([8.0, 64.0, 8.0], np.float32))   # 0..6 each
    days = np.maximum(np.rint(los), 1.0).astype(np.float32)
    shapes = ((1, 1), (ME_DATA, 1), (2, 2))
    mesh4 = mesh(ME_DATA)
    k3_legs = {}
    with log:
        # -------------------------------- (a) the classifiers, three shapes
        def svc_gaps(a, b):
            return {"n_iter": abs(a.n_iter - b.n_iter), "coef": theta_gap(a, b)}

        def nb_gaps(a, b):
            return {"pi": float(np.abs(a.pi - b.pi).max()),
                    "theta": rel(a.theta, b.theta),
                    "sigma": rel_each(a.sigma, b.sigma)}

        def ovr_gaps(a, b):
            return {"n_iter": max(abs(p.n_iter - q.n_iter) for p, q in zip(a.models, b.models)),
                    "coef": max(theta_gap(p, q) for p, q in zip(a.models, b.models))}

        def same_trees(a, b) -> bool:
            return all(np.array_equal(getattr(p, k), getattr(q, k))
                       for p, q in zip(a.models, b.models)
                       for k in ("split_feat", "threshold", "value"))

        def zero(gaps_of):
            return lambda a, b: not any(gaps_of(a, b).values())

        ovr_tree = port.OneVsRest(port.DecisionTreeClassifier(max_depth=5))
        # name: (estimator, rows, labels, gaps, equal to one device)
        legs = {
            "svc": (port.LinearSVC(tol=CLS_TOL), x, yb, svc_gaps, zero(svc_gaps)),
            "nb_multinomial": (port.NaiveBayes(), counts, tiers, None, lambda a, b: (
                np.array_equal(a.pi, b.pi) and np.array_equal(a.theta, b.theta))),
            "nb_gaussian": (port.NaiveBayes(model_type="gaussian"), x, tiers, nb_gaps,
                            zero(nb_gaps)),
            "ovr_tree": (ovr_tree, x, tiers, None, same_trees),
            "ovr_logistic": (port.OneVsRest(port.LogisticRegression(tol=CLS_TOL)), x, tiers,
                             ovr_gaps, zero(ovr_gaps)),
        }
        lines = []
        for name, (est, xx, yy, gaps_of, same) in legs.items():
            with aside():
                one, s_one = timed(lambda: est.fit((xx, yy), device=cuda0))
                ctl = None if gaps_of is None else gaps_of(
                    est.fit((bf16_round(xx), yy), mesh=mesh4), one)
            texts = []
            for shape in shapes:
                k3_0 = H.launch_counts()["fused_level_hist"]
                got, s = timed(lambda: est.fit((xx, yy), mesh=mesh(*shape)))
                k3_n = H.launch_counts()["fused_level_hist"] - k3_0
                if shape == (1, 1) or gaps_of is None:
                    check(same(got, one), f"(a) {name} over {shape} differs from one device")
                    texts.append(f"{shape} {s:.3f} s ==")
                else:
                    texts.append(f"{shape} {s:.3f} s, " + held(name, gaps_of(got, one), ctl))
                if name == "ovr_tree":
                    want = 3 * shape[0] * 6
                    check(k3_n == want, f"(a) OneVsRest's trees over {shape} launched K3 {k3_n} "
                                        f"times (want 3 trees x {shape[0]} shards x 6 levels)")
                    k3_legs[str(shape)] = k3_n
                    texts[-1] += f", K3 {k3_n}"
            lines.append(f"{name}: one device {s_one:.3f} s; " + "; ".join(texts))
        say(f"mesh estimators (a) on the stage's {n} hospital rows against one device: "
            + " | ".join(lines) + f" ({card})")
        lap("me (a) resident")

        ooc = []
        for name, (est, xx, yy, gaps_of, same) in legs.items():
            xx, yy = xx[:ME_OOC_N], yy[:ME_OOC_N]
            hd = port.HostDataset(x=xx, y=yy, max_device_rows=ME_OOC_BLOCK)
            with aside():
                one = est.fit(hd, device=cuda0)
            k3_0 = H.launch_counts()["fused_level_hist"]
            got, s = timed(lambda: est.fit(hd, mesh=mesh4))
            k3_n = H.launch_counts()["fused_level_hist"] - k3_0
            if gaps_of is None:
                check(same(got, one), f"(a) {name} out of core over (4, 1) differs from one device")
                ooc.append(f"{name} {s:.3f} s ==")
            else:
                with aside():
                    ctl = gaps_of(est.fit(port.HostDataset(x=bf16_round(xx), y=yy,
                                                           max_device_rows=ME_OOC_BLOCK),
                                          mesh=mesh4), one)
                ooc.append(f"{name} {s:.3f} s, " + held(name + "_ooc", gaps_of(got, one), ctl))
            if name == "ovr_tree":
                want = 3 * ME_DATA * hd.block_shape(mesh4)[0] * 6
                check(k3_n == want, f"(a) OneVsRest's trees out of core over (4, 1) launched K3 "
                                    f"{k3_n} times (want 3 x 4 shards x 8 blocks x 6 levels)")
                k3_legs["(4, 1) out of core"] = k3_n
                ooc[-1] += f", K3 {k3_n}"
        say(f"mesh estimators (a) out of core, the first {ME_OOC_N} rows in "
            f"{hd.block_shape()[0]} blocks of {ME_OOC_BLOCK} over (4, 1) "
            f"against one device: " + "; ".join(ooc) + f" ({card})")
        lap("me (a) out of core")

        # ------------------------------------------------------ (b) the GLM
        exposure = np.log(x[:, 0].astype(np.float64) + 1.0).astype(np.float32)
        names = list(port.FEATURE_COLS)

        def offset_table(xr):
            cols = {c: xr[:, j] for j, c in enumerate(names)}
            cols.update({port.LABEL_COL: days, "log_exposure": exposure})
            return port.VectorAssembler(names).transform(port.Table.from_dict(cols))

        def glm_mesh_gaps(a, b, summary=True):
            g = glm_gaps(a, b, summary=summary)
            if summary:
                g["se"] = rel_each(a.summary.coefficient_standard_errors,
                                   b.summary.coefficient_standard_errors)
            return g

        table, table16 = offset_table(x), offset_table(xb16)
        glines = []
        for name, kw in (("glm_poisson", dict(family="poisson")),
                         ("glm_gamma", dict(family="gamma", link="log"))):
            est = port.GeneralizedLinearRegression(tol=FAM_TOL, offset_col="log_exposure", **kw)
            with aside():
                one = est.fit(table, device=cuda0)
            got, s = timed(lambda: est.fit(table, mesh=mesh4))
            with aside():
                ctl = glm_mesh_gaps(est.fit(table16, mesh=mesh4), one)
            glines.append(f"{name} {s:.3f} s ({got.n_iter} IRLS steps), "
                          + held(name, glm_mesh_gaps(got, one), ctl))
        del table, table16
        est = port.GeneralizedLinearRegression(family="poisson", tol=FAM_TOL)
        hd = port.HostDataset(x=x, y=days, max_device_rows=FAM_BLOCK)
        with aside():
            one = est.fit(hd, device=cuda0)
        got, s = timed(lambda: est.fit(hd, mesh=mesh4))
        with aside():
            ctl = glm_mesh_gaps(est.fit(port.HostDataset(x=xb16, y=days,
                                                         max_device_rows=FAM_BLOCK), mesh=mesh4),
                                one, summary=False)
        glines.append(f"glm_ooc poisson {s:.3f} s, "
                      + held("glm_ooc", glm_mesh_gaps(got, one, summary=False), ctl))
        say(f"mesh estimators (b) GeneralizedLinearRegression(tol={FAM_TOL:g}) on {n} rows with "
            f"an offset column (log(admission_count + 1)) and the summary over (4, 1) against "
            f"one device: " + "; ".join(glines) + f" ({card})")
        lap("me (b)")

        # ------------------------------------------- (c) AFT, FM, MLP, isotonic
        clines = []
        xa, ya, cen = aft_rows(TREE_N)

        def aft_theta(m):
            return np.r_[m.coefficients, m.intercept, np.log(m.scale)]

        def aft_gaps(a, b):
            return {"n_iter": abs(a.fit_info["n_iter"] - b.fit_info["n_iter"]),
                    "theta": rel(aft_theta(a), aft_theta(b))}

        est = port.AFTSurvivalRegression(max_iter=100)
        with aside():
            one = est.fit((xa, ya), device=cuda0, censor=cen)
        got, s = timed(lambda: est.fit((xa, ya), mesh=mesh4, censor=cen))
        with aside():
            ctl = aft_gaps(est.fit((bf16_round(xa), ya), mesh=mesh4, censor=cen), one)
        clines.append(f"aft {s:.3f} s ({got.fit_info['n_iter']} iterations, "
                      f"{got.fit_info['evaluations']} evaluations), "
                      + held("aft", aft_gaps(got, one), ctl))
        est = port.AFTSurvivalRegression(max_iter=ME_EPOCHS)
        hd = port.HostDataset(x=xa, y=ya, max_device_rows=FAM_BLOCK)
        with aside():
            one = est.fit(hd, device=cuda0, censor=cen)
        got, s = timed(lambda: est.fit(hd, mesh=mesh4, censor=cen))
        with aside():      # the control: one epoch short
            ctl = {"theta": rel(aft_theta(dataclasses.replace(est, max_iter=ME_EPOCHS - 1).fit(
                hd, mesh=mesh4, censor=cen)), aft_theta(one))}
        clines.append(f"aft_ooc {s:.3f} s, "
                      + held("aft_ooc", {"theta": rel(aft_theta(got), aft_theta(one))}, ctl))
        del xa, ya, cen

        def fm_params(m):
            return np.r_[m.intercept, m.linear.cpu().numpy(), m.factors.cpu().numpy().ravel()]

        lf = los.astype(np.float32)
        # the resident FM and MLP on families_phase's comparison rows (PREFIX)
        xp, lp, ybp = x[:PREFIX], lf[:PREFIX], yb[:PREFIX]
        fm = port.FMRegressor(factor_size=8, max_iter=100)
        fm_ooc = dataclasses.replace(fm, max_iter=ME_EPOCHS)
        for tag, est, data, control in (
                # the resident fit's control: one Adam step short
                ("fm", fm, (xp, lp), (dataclasses.replace(fm, max_iter=99), (xp, lp))),
                ("fm_ooc", fm_ooc, port.HostDataset(x=x, y=lf, max_device_rows=FAM_BLOCK),
                 (fm_ooc, port.HostDataset(x=xb16, y=lf, max_device_rows=FAM_BLOCK)))):
            with aside():
                one = est.fit(data, device=cuda0)
            got, s = timed(lambda: est.fit(data, mesh=mesh4))
            with aside():
                ctl = {"params": rel(fm_params(control[0].fit(control[1], mesh=mesh4)),
                                     fm_params(one))}
            clines.append(f"{tag} {s:.3f} s, "
                          + held(tag, {"params": rel(fm_params(got), fm_params(one))}, ctl))

        est = port.MultilayerPerceptronClassifier(layers=(4, 16, 2), max_iter=150, seed=0)
        short = dataclasses.replace(est, max_iter=ME_SHORT)

        def w_gap(a, b):
            return max(rel(p, q) for p, q in zip(mlp_weights(a), mlp_weights(b)))

        xt = torch.from_numpy(xp).to(cuda0)

        with aside():
            one, one5 = est.fit((xp, ybp), device=cuda0), short.fit((xp, ybp), device=cuda0)
        got, s = timed(lambda: est.fit((xp, ybp), mesh=mesh4))
        got5 = short.fit((xp, ybp), mesh=mesh4)
        rows = int((got.predict(xt) != one.predict(xt)).sum())
        gaps = {"w5": w_gap(got5, one5), "rows": rows,
                "loss": abs(got.fit_info["loss"] - one.fit_info["loss"]) / one.fit_info["loss"]}
        with aside():      # the control: one L-BFGS iteration short
            ctl = {"w5": w_gap(dataclasses.replace(short, max_iter=ME_SHORT - 1).fit(
                (xp, ybp), mesh=mesh4), one5)}
        clines.append(f"mlp {s:.3f} s ({got.fit_info['n_iter']} iterations, one device "
                      f"{one.fit_info['n_iter']}), " + held("mlp", gaps, ctl))
        del xt
        ooc_mlp = dataclasses.replace(est, max_iter=ME_EPOCHS)
        hd = port.HostDataset(x=x, y=yb, max_device_rows=FAM_BLOCK)
        with aside():
            one = ooc_mlp.fit(hd, device=cuda0)
        got, s = timed(lambda: ooc_mlp.fit(hd, mesh=mesh4))
        with aside():      # the control: one epoch short
            ctl = {"w": w_gap(dataclasses.replace(ooc_mlp, max_iter=ME_EPOCHS - 1).fit(
                hd, mesh=mesh4), one)}
        clines.append(f"mlp_ooc {s:.3f} s, " + held("mlp_ooc", {"w": w_gap(got, one)}, ctl))
        est = port.IsotonicRegression(feature_index=1)
        with aside():
            one = est.fit((x, lf), device=cuda0)
        got, s = timed(lambda: est.fit((x, lf), mesh=mesh4))
        check(np.array_equal(got.boundaries, one.boundaries)
              and np.array_equal(got.predictions, one.predictions),
              "(c) IsotonicRegression over (4, 1) differs from one device")
        clines.append(f"isotonic {s:.3f} s == ({len(got.boundaries)} boundaries)")
        say(f"mesh estimators (c) over (4, 1) against one device (FM and MLP resident on the "
            f"first {PREFIX} rows): " + "; ".join(clines)
            + f" ({card})")
        lap("me (c)")

        # ------------------------------------------------- (d) the composites
        cols = {c: x[:, j] for j, c in enumerate(names)}
        cols[port.LABEL_COL] = lf
        table = port.Table.from_dict(cols)
        table16 = port.Table.from_dict({**{c: xb16[:, j] for j, c in enumerate(names)},
                                        port.LABEL_COL: lf})

        def lr_pipe():
            return port.Pipeline([port.VectorAssembler(names), port.StandardScaler(),
                                  port.LinearRegression()])

        def pipe_lr_gaps(pm, pm_one, tb):
            a = pm.transform(tb, mesh=mesh4).to_numpy()[0]
            b = pm_one.transform(tb, device=cuda0).to_numpy()[0]
            return {"coef": theta_gap(pm.stages[2], pm_one.stages[2]), "pred": rel(a, b)}

        with aside():
            one = lr_pipe().fit(table, device=cuda0)
        got, s_lr = timed(lambda: lr_pipe().fit(table, mesh=mesh4))
        g_lr = pipe_lr_gaps(got, one, table)
        with aside():
            ctl = pipe_lr_gaps(lr_pipe().fit(table16, mesh=mesh4), one, table)
        t_lr = held("pipe_lr", g_lr, ctl)

        def km_pipe():
            return port.Pipeline([port.VectorAssembler(names), port.StandardScaler(),
                                  port.KMeans(k=16, seed=SEED, max_iter=MAX_ITER)])

        with aside():
            one = km_pipe().fit(table, device=cuda0)
            want = one.transform(table, device=cuda0).column("prediction")

        def pipe_km_gaps(pm):
            ka, kb = pm.stages[2], one.stages[2]
            return {"n_iter": abs(ka.n_iter - kb.n_iter),
                    "centers": float(np.abs(ka.cluster_centers - kb.cluster_centers).max()),
                    "moved": int((pm.transform(table, mesh=mesh4).column("prediction")
                                  != want).sum())}

        k1_0 = L.launch_counts()["fused_lloyd_stats"]
        got, s_km = timed(lambda: km_pipe().fit(table, mesh=mesh4))
        k1_km = L.launch_counts()["fused_lloyd_stats"] - k1_0
        check(k1_km == ME_DATA * (got.stages[2].n_iter + 1),
              f"(d) the KMeans pipeline over (4, 1) launched K1 {k1_km} times (want 4 x "
              f"(n_iter {got.stages[2].n_iter} + 1))")
        g_km = pipe_km_gaps(got)
        with aside():
            ctl = pipe_km_gaps(km_pipe().fit(table16, mesh=mesh4))
        t_km = held("pipe_kmeans", g_km, ctl)
        del table, table16

        xs, ds_ = x[:ME_TUNE_N], days[:ME_TUNE_N]
        grid = port.ParamGridBuilder().add_grid("max_depth", [3, 5]).build()
        cv = port.CrossValidator(port.DecisionTreeRegressor(), grid,
                                 port.RegressionEvaluator("rmse"), num_folds=3, seed=0)

        def tuned_gaps(a, b, metrics):
            return {"index": abs(a.best_index - b.best_index),
                    "metrics": rel_each(getattr(a, metrics), getattr(b, metrics))}

        with aside():
            one = cv.fit((xs, ds_), device=cuda0)
        k3_0 = H.launch_counts()["fused_level_hist"]
        got, s_cv = timed(lambda: cv.fit((xs, ds_), mesh=mesh4))
        k3_legs["cv"] = H.launch_counts()["fused_level_hist"] - k3_0
        with aside():
            ctl = tuned_gaps(cv.fit((bf16_round(xs), ds_), mesh=mesh4), one, "avg_metrics")
        t_cv = held("cv_tree", tuned_gaps(got, one, "avg_metrics"), ctl)
        xz = ((xs - xs.mean(axis=0)) / xs.std(axis=0)).astype(np.float32)
        tvs = port.TrainValidationSplit(
            port.KMeans(seed=SEED, max_iter=MAX_ITER),
            port.ParamGridBuilder().add_grid("k", [8, 16]).build(), port.ClusteringEvaluator(),
            seed=0)
        with aside():
            one = tvs.fit(xz, device=cuda0)
        k2_0 = L.launch_counts()["fused_assign"]
        got, s_tvs = timed(lambda: tvs.fit(xz, mesh=mesh4))
        k2_tvs = L.launch_counts()["fused_assign"] - k2_0
        with aside():
            ctl = tuned_gaps(tvs.fit(bf16_round(xz), mesh=mesh4), one, "validation_metrics")
        t_tvs = held("tvs_kmeans", tuned_gaps(got, one, "validation_metrics"), ctl)
        say(f"mesh estimators (d) over (4, 1) against one device: Pipeline(VectorAssembler, "
            f"StandardScaler, LinearRegression) on {n} rows {s_lr:.3f} s, {t_lr}; "
            f"Pipeline(..., KMeans(k=16)) {s_km:.3f} s, K1 {k1_km} (4 a step), {t_km}; "
            f"CrossValidator(DecisionTreeRegressor, max_depth {{3, 5}}, 3 folds) on the first "
            f"{ME_TUNE_N} rows (integer LOS) {s_cv:.3f} s, best index {got.best_index}, "
            f"K3 {k3_legs['cv']}, {t_cv}; TrainValidationSplit(KMeans k {{8, 16}}, silhouette) "
            f"{s_tvs:.3f} s, K2 {k2_tvs}, {t_tvs} ({card})")
        lap("me (d)")
    say(f"mesh estimators: K3 launches of the OneVsRest trees and the CV "
        f"{json.dumps(k3_legs)}; shard shapes launched: K1 {sorted(log.k1)}, K2 "
        f"{sorted(log.k2)}, K3 {sorted(log.k3)}")

    # --------------------- every shard shape against its plain version
    k1_shapes, k2_shapes, k3_shapes = [], [], []
    with aside():
        for (nn, d, k) in sorted(log.k1 | log.k2):
            g = torch.Generator(device=DEV).manual_seed(nn + k)
            xr = torch.randn((nn, d), device=DEV, generator=g)
            cen = xr[:k].clone()
            r1, r2 = mesh_case(L, xr, torch.ones((nn,), device=DEV), cen,
                               torch.ones((k,), device=DEV), f"n={nn} d={d} k={k}")
            if (nn, d, k) in log.k1:
                k1_shapes.append(r1)
            if (nn, d, k) in log.k2:
                k2_shapes.append(r2)
            del xr, cen
        top = {}
        for (nn, d, S, T, LN, B) in log.k3:
            key = (nn, d, S, T, B)
            top[key] = max(top.get(key, 0), LN)
        for (nn, d, S, T, B), LN in sorted(top.items()):
            ins = k3_inputs(nn, d, S, T, LN, B, seed=80 + S)
            err, _ = k3_check(H, *ins, LN, B, f"8c-3 shard n={nn} S={S}")
            t = k3_time(H, *ins, LN, B, reps=20)
            say(f"K3 8c-3 shard (n={nn} d={d} S={S} T={T} LN={LN} B={B}): {t['ms']:.4f} ms "
                f"(plain {t['plain_ms']:.4f}, library {t['library_ms']:.4f}, bound "
                f"{t['bound_ms']:.4f} by {t['bound_by']}), max_abs_err {err:.3g} ({card})")
            k3_shapes.append({"n": nn, "d": d, "S": S, "T": T, "LN": LN, "B": B,
                              "max_abs_err": err, **t})
            del ins
    lap("me shapes")
    launches = ledger.main_path()
    launches["fused_level_hist"] = (H.launch_counts()["fused_level_hist"] - k3_start
                                    - k3_aside[0])
    say(f"mesh_estimators_phase: {time.perf_counter() - t_phase:.2f} s of host clock ({card}); "
        f"main-path launches {json.dumps(launches)}")
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "k1": k1_shapes, "k2": k2_shapes, "k3": k3_shapes}


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
    lap("start")
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
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, timeout=60)
    check(gxx.returncode == 0, "g++ is missing: the native CSV engine cannot be built")
    t0 = time.perf_counter()
    host_lib = _build.build_host("csv_scan")
    say(f"host build: {gxx.stdout.splitlines()[0]}; native/csv_scan.cpp -> {host_lib.name} "
        f"in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        if log.exists():
            for fn, usage in ptxas_usage(log.read_text()):
                say(f"  ptxas[{name}] {fn}: {usage}")
    lap("build")

    # ------------------------------------------------- kernel vs plain
    records = kernel_case(L, N, D, K, 0, seed=1, reps=20)
    # K2's other shapes on the main path: a bulk_score chunk, a served batch
    records[1]["shapes"] = [k2_case(L, 262_144, D, K, seed=4, reps=20),
                            k2_case(L, 200, D, K, seed=5, reps=200)]
    # slice 4a's shapes: K1 on a streaming micro-batch (config 5), K2 in
    # the bisecting (config 4) and streaming predicts
    k1_stream = kernel_case(L, STREAM_BATCH, D, STREAM_K, 0, seed=6, reps=50)[0]
    records[0]["shapes"] = [{"n": STREAM_BATCH, "d": D, "k": STREAM_K,
                             **{key: k1_stream[key] for key in (
                                 "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                                 "bound_by")}}]
    # slice 4b: K1 at the out-of-core flagship's block shape
    k1_block = kernel_case(L, OOC_BLOCK, D, K, 0, seed=9, reps=20)[0]
    records[0]["shapes"].append({"n": OOC_BLOCK, "d": D, "k": K, **{key: k1_block[key] for key in (
        "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}})
    records[1]["shapes"] += [k2_case(L, BISECT_N, D, BISECT_K, seed=7, reps=20),
                             k2_case(L, STREAM_BATCH * STREAM_BATCHES, D, STREAM_K, seed=8,
                                     reps=20)]
    # slice 5c: K1 and K2 at features_phase's PCA(3) → KMeans(k=16) shape
    k_pca = kernel_case(L, TREE_N, 3, 16, 0, seed=12, reps=20)
    for rec, kr in zip(records[:2], k_pca):
        rec["shapes"].append({"n": TREE_N, "d": 3, "k": 16, **{key: kr[key] for key in (
            "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}})
    # slices 5d + 5e: K1 and K2 at PowerIterationClustering's 1-D KMeans
    k_pic = kernel_case(L, 20_000, 1, PIC_K, 0, seed=13, reps=50)
    for rec, kr in zip(records[:2], k_pic):
        rec["shapes"].append({"n": 20_000, "d": 1, "k": PIC_K, **{key: kr[key] for key in (
            "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}})
    kernel_case(L, 1_000_003, D, 16, 3, seed=2, reps=10, dup=True)
    kernel_case(L, 1_000_000, 64, 1024, 0, seed=3, reps=5)
    edge_cases(L)
    lap("K1 and K2 against their plain versions")
    records.append(k3_phase(H))
    lap("K3 against its plain version")

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
    init_centers = port.KMeans(k=K, seed=SEED, max_iter=MAX_ITER)._init_centers(ds)
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
    lap("KMeans path")

    # ------------------------------------- the SQL window on the card
    sql_window(port, card)
    lap("sql_window")

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
    lap("model stage and artifacts")
    with tempfile.TemporaryDirectory() as tmp:
        # ---------------------------------------- run_pipeline end to end (K3)
        os.environ["CMLHN_FLIGHT_DIR"] = os.path.join(tmp, "flight")
        counts["fused_level_hist"] += pipeline_phase(port, H, tmp, card)
        os.environ.pop("CMLHN_FLIGHT_DIR")
    lap("pipeline_phase")
    rf20(port)
    lap("rf20")

    # ------------------------- slice 4a: BASELINE configs 5, 3 and 4 (K1, K2)
    k1, k2 = streaming_phase(port, L, card)
    counts["fused_lloyd_stats"] += k1
    counts["fused_assign"] += k2
    gmm_phase(port, card)
    counts["fused_assign"] += bisecting_phase(port, L, card)
    lap("configs 5, 3, 4")

    # ------------------- slice 4b: the out-of-core fits (K1, K2, K3 a block)
    for name, v in outofcore_phase(port, L, H, card, k1_block["ms"]).items():
        counts[name] += v
    lap("outofcore_phase")

    # -------------- slices 3e + 4c: GBT (K3 at T = 1), LinearRegression, the
    # precision modes, BisectingKMeans' cosine, weights and out of core (K2)
    with tempfile.TemporaryDirectory() as tmp:
        counts["fused_level_hist"] += gbt_phase(port, H, card, tmp)
    lr_phase(port, card)
    precision_phase(port, ds, model, card)
    counts["fused_assign"] += bisecting_more(port, L, card)
    lap("gbt, lr, precision, bisecting_more")

    # ------- slice 5a: the LOS_binary classifiers (K3 through OneVsRest)
    counts["fused_level_hist"] += classification_phase(port, H, card)

    # ------- slice 5b: the L-BFGS, Adam and IRLS families (no kernel: the
    # counts must not move)
    before = ops.launch_counts()
    families_phase(port, H, card)
    check(ops.launch_counts() == before, "families_phase launched a kernel")

    # ------- slice 5c: the feature stages and the fused SQL-to-device path,
    # feeding KMeans (K1, K2) and trees (K3)
    for name, v in features_phase(port, L, H, card).items():
        counts[name] += v

    # ------- slices 5d + 5e: selectors, text, LDA, Word2Vec, ALS, PIC,
    # feeding a categorical tree (K3) and PIC's 1-D KMeans (K1, K2)
    for name, v in beyond_phase(port, L, H, card).items():
        counts[name] += v

    # ------- slice 6: materialized views over the stream, sealed history
    # and the fuzz harness; the train_window view feeds the forest (K3)
    hist = history_phase(port, H, card)
    counts["fused_level_hist"] += hist["launches"]
    records[-1]["shapes"].append(hist["shape"])

    # ------- slice 7a: the serving front door (K2 in every served batch of
    # the primary, K1 in the fallback's fit and the hot swap's refit) and
    # the ingest firewall
    front = front_door_phase(port, L, card, model, x_host)
    for name, v in front["launches"].items():
        counts[name] += v
    records[0]["shapes"].append(front["shape"])

    # ------- slice 7b: the model farm (torch ops, no kernel) and the
    # lifecycle (K1 in the retrains, K2 in every served, shadow and canary
    # batch)
    fl = farm_lifecycle_phase(port, L, card)
    for name, v in fl["launches"].items():
        counts[name] += v
    records[0]["shapes"] += fl["k1"]
    records[1]["shapes"] += fl["k2"]

    # ------- slice 7c: the serving fleet (K1 in the served models' fits, K2
    # in every replica's and every worker process's served batches)
    fleet = fleet_phase(port, L, card, lc_ref=fl["lc_ref"])
    for name, v in fleet["launches"].items():
        counts[name] += v
    records[0]["shapes"] += fleet["k1"]
    records[1]["shapes"] += fleet["k2"]

    # ------- slice 7c's federation: K1 a silo a round and in the closing
    # collect, K1 in the pooled fits
    fed = federated_phase(port, ops, L, card)
    for name, v in fed["launches"].items():
        counts[name] += v
    records[0]["shapes"] += fed["k1"]

    # ------- slice 7d's pipelined stream (K1 a batch in StreamingKMeans)
    # and profiling (K3 in the clocked GBT fit)
    pipe = pipeline_stream_phase(port, ops, L, card)
    for name, v in pipe["launches"].items():
        counts[name] += v
    records[0]["shapes"] += pipe["k1"]

    # ------- slice 7d-2: the compressed production day under chaos (no
    # kernel: the counts must not move)
    soak_phase(port, card)

    # ------- slice 8a: KMeans k=256 over a (data, model) mesh, in one
    # process and across processes (K1 a shard a step; K2 + K1 a shard on a
    # model axis; K2 a shard in predict and compute_cost)
    mp_ = mesh_phase(port, L, card, ds, model, init_centers, sil)
    for name, v in mp_["launches"].items():
        counts[name] += v
    records[0]["shapes"] += mp_["k1"]
    records[1]["shapes"] += mp_["k2"]

    # ------- slice 8b-1: the model stage over a mesh (K3 once a data shard
    # a level in DT, RF and GBT), and the JAX package's cross-process
    # phases on mesh_phase's gloo ranks
    mm = mesh_models_phase(port, H, card, mp_)
    counts["fused_level_hist"] += mm["launches"]
    records[2]["shapes"] += mm["shapes"]

    # ------- slice 8c-1: BisectingKMeans, the streams, the checkpointed
    # KMeans / GMM and bulk scoring over a mesh (K1 a shard a batch or a
    # step, K2 a shard a predict or a scoring chunk)
    mc = mesh_clustering_phase(port, L, card, ds, model, pred_h, x_host, init_centers,
                               mp_["x2"])
    for name, v in mc["launches"].items():
        counts[name] += v
    records[0]["shapes"] += mc["k1"]
    records[1]["shapes"] += mc["k2"]
    del mp_

    # ------- slice 8c-2: the out-of-core fits over a mesh (K1 a shard a
    # block a step, K2 + K1 a (data, model) shard, K3 a shard a block a
    # level)
    mo = mesh_outofcore_phase(port, L, H, card, x_host, init_centers)
    for name, v in mo["launches"].items():
        counts[name] += v
    records[0]["shapes"] += mo["k1"]
    records[1]["shapes"] += mo["k2"]
    records[2]["shapes"] += mo["k3"]

    # ------- slice 8c-3: the other estimators and the composites over a
    # mesh (K3 a shard a level in OneVsRest's and the CV's trees, K1 a
    # shard a step and K2 a shard in the pipeline's and the TVS's KMeans)
    me = mesh_estimators_phase(port, L, H, card)
    for name, v in me["launches"].items():
        counts[name] += v
    records[0]["shapes"] += me["k1"]
    records[1]["shapes"] += me["k2"]
    records[2]["shapes"] += me["k3"]

    check(all(v > 0 for v in counts.values()), "a kernel was never launched")
    say(f"phase seconds (host clock): "
        f"{json.dumps({k: round(v, 2) for k, v in PHASE_S.items()})}; "
        f"classification_phase {sum(v for k, v in PHASE_S.items() if k.startswith('cls ')):.2f}; "
        f"families_phase {sum(v for k, v in PHASE_S.items() if k.startswith('fam ')):.2f}; "
        f"features_phase {sum(v for k, v in PHASE_S.items() if k.startswith('feat ')):.2f}; "
        f"beyond_phase {sum(v for k, v in PHASE_S.items() if k.startswith('beyond ')):.2f}; "
        f"history_phase {sum(v for k, v in PHASE_S.items() if k.startswith('history ')):.2f}; "
        f"front_door_phase {sum(v for k, v in PHASE_S.items() if k.startswith('front ')):.2f}; "
        f"farm_lifecycle_phase "
        f"{sum(v for k, v in PHASE_S.items() if k.startswith(('farm ', 'lifecycle '))):.2f}; "
        f"fleet_phase {sum(v for k, v in PHASE_S.items() if k.startswith('fleet ')):.2f}; "
        f"federated_phase {sum(v for k, v in PHASE_S.items() if k.startswith('fed ')):.2f}; "
        f"pipeline_stream_phase "
        f"{sum(v for k, v in PHASE_S.items() if k.startswith('pipe ')):.2f}; "
        f"soak_phase {sum(v for k, v in PHASE_S.items() if k.startswith('soak ')):.2f}; "
        f"mesh_phase {sum(v for k, v in PHASE_S.items() if k.startswith('mesh ')):.2f}; "
        f"mesh_models_phase {sum(v for k, v in PHASE_S.items() if k.startswith('mm ')):.2f}; "
        f"mesh_clustering_phase "
        f"{sum(v for k, v in PHASE_S.items() if k.startswith('mc ')):.2f}; "
        f"mesh_outofcore_phase "
        f"{sum(v for k, v in PHASE_S.items() if k.startswith('mo ')):.2f}; "
        f"mesh_estimators_phase "
        f"{sum(v for k, v in PHASE_S.items() if k.startswith('me ')):.2f}; "
        f"all phases {sum(PHASE_S.values()):.2f}")
    say(f"kernels launched on the main paths: {json.dumps(counts)}")
    for rec in records:
        rec["launches"] = counts[rec["name"]]
    say(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
