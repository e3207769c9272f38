#!/usr/bin/env python3
"""KMeans k=256 over a mesh of several cards, in one process and across
processes, held to the same mesh shape on one card.

    python3 mesh_cards.py             # every visible card (at least 2)
    python3 mesh_cards.py --cpu 4     # rehearsal: 4 CPU entries, gloo ranks

``chip_smoke.py``'s ``mesh_phase`` runs the mesh on one card, where the
shards time-slice it and the ranks meet over gloo.  This script runs it
where a mesh is meant to run, on C cards, on the main path's data
(``chip_smoke.make_data``: 10M x 8 standardized rows, seed 0) warm-started
from its first 256 rows:

1. one process: a (C, 1) and a (C/2, 2) mesh over cuda:0 .. cuda:C-1,
   each ``==`` the same mesh shape over ``[cuda:0] * C`` (the same shards,
   the same K1 plans, the same ordered fold on cuda:0), with each fit's
   warm seconds;
2. the hospital pipeline's model stage (``run_model_stage``, on
   ``chip_smoke.py``'s 2M-row window of the example generator's law) over a
   (C, 1) mesh of the C cards, ``==`` the (C, 1) mesh over
   ``[cuda:0] * C`` (every RMSE, accuracy, importance, the LR coefficients
   and every tree), with each stage's warm seconds, before the legs of
   item 3 and again after them (their tensors freed and the allocators'
   caches emptied), to read whether what they leave behind slows it;
3. the clustering family and bulk scoring over a (C, 1) mesh of the C
   cards, each ``==`` the (C, 1) mesh over ``[cuda:0] * C``:
   BisectingKMeans (BASELINE config 4: 2M x 8, k=8, one restart),
   StreamingKMeans (config 5: 12 batches of 100,000 x 8, k=16, half_life
   5, each batch sharded: ``shard_min_rows_per_device=16,384``) and
   ``bulk_score`` of the 10M rows with a k=256 model, with their warm
   seconds;
4. out of core over a (C, 1) mesh of the C cards, each ``==`` the (C, 1)
   mesh over ``[cuda:0] * C``: KMeans k=256 on the main path's 10M rows
   memory-mapped in blocks of 2**20 (warm-started as in item 1) and the
   rf20 forest shape (2M x 8, 20 trees, depth 5, bootstrap) on integer LOS
   in 8 blocks of 2**18, with their warm seconds: each card takes its
   shard's segment of every block on its own copy stream;
5. C processes, one card each, NCCL through a ``file://`` store: the
   host-major (C, 1) mesh, every rank's model ``==`` the in-process (C, 1)
   fit, each rank's warm fit seconds (its second fit) and the seconds of
   it inside the ordered gather (``collectives.gather_shards``).

It prints the card's name and power limit, a line a leg, and one JSON
object last; any disagreement exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
K, SEED, MAX_ITER = 256, 0, 20
JOIN_S = 600


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def same(a, b) -> bool:
    import numpy as np

    return (np.array_equal(a.cluster_centers, b.cluster_centers)
            and np.array_equal(a.cluster_sizes, b.cluster_sizes)
            and a.training_cost == b.training_cost and a.n_iter == b.n_iter)


def sync(dev: str) -> None:
    import torch

    if dev != "cpu":
        torch.cuda.synchronize()


def sync_all(dev: str) -> None:
    import torch

    if dev != "cpu":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def stage_leg(port, window, C: int, cards: list, one: list, dev: str, card: str,
              when: str) -> dict:
    """The model stage on the training ``window`` over a (C, 1) mesh of the
    cards against the same shape over one card: every metric and model
    ``==``.  → its seconds."""
    import numpy as np

    cfg = port.PipelineConfig()
    runs = {}
    for name, devs in (("cards", cards), ("one_card", one)):
        mesh = port.build_mesh(port.MeshConfig(data=C), devs)
        port.run_model_stage(window, cfg, mesh=mesh)            # first use of each card
        sync_all(dev)
        t0 = time.perf_counter()
        res = port.run_model_stage(window, cfg, mesh=mesh)
        sync_all(dev)
        runs[name] = (res, time.perf_counter() - t0)
    (a, s_a), (b, s_b) = runs["cards"], runs["one_card"]
    if (a.regression_rmse != b.regression_rmse
            or a.classification_accuracy != b.classification_accuracy
            or a.feature_importances != b.feature_importances):
        fail(f"the ({C}, 1) stage over {C} cards differs from one card's")
    for name, m in a.models.items():
        other = b.models[name]
        if name == "LinearRegression":
            same_m = np.array_equal(m.coefficients.cpu().numpy(), other.coefficients.cpu().numpy())
        else:
            same_m = all(np.array_equal(getattr(m, k), getattr(other, k))
                         for k in ("split_feat", "threshold", "value"))
        if not same_m:
            fail(f"the ({C}, 1) stage's {name} over {C} cards differs from one card's")
    print(f"({C}, 1) model stage on {window.num_rows} rows, one process, {when}: over {C} "
          f"cards {s_a:.4f} s, over one card {s_b:.4f} s ({s_b / s_a:.2f}x); every metric and "
          f"model == bit for bit ({card})", flush=True)
    return {"cards_s": s_a, "one_card_s": s_b, "rows": window.num_rows,
            "seconds": {k: round(v, 4) for k, v in a.seconds.items()}}


def clustering_leg(port, cs, C: int, cards: list, one: list, dev: str, scale: int,
                   model, x, card: str) -> dict:
    """BisectingKMeans, StreamingKMeans and ``bulk_score`` over a (C, 1)
    mesh of the cards against the same shape over one card: ``==``.  Rows
    are ``chip_smoke.py``'s configs 4 and 5 divided by ``scale``.  → their
    seconds."""
    import numpy as np
    import torch

    xb = cs.make_data(cs.BISECT_N // scale, cs.D, cs.BISECT_K)
    xs = cs.make_data(cs.STREAM_BATCH * cs.STREAM_BATCHES // scale, cs.D, cs.STREAM_K)
    batches = np.array_split(xs, cs.STREAM_BATCHES)
    runs = {}
    for name, devs in (("cards", cards), ("one_card", one)):
        mesh = port.build_mesh(port.MeshConfig(data=C), devs)
        got = {}
        for leg, run in (
            ("bisecting", lambda: port.BisectingKMeans(k=cs.BISECT_K, seed=SEED, n_restarts=1)
             .fit(xb, mesh=mesh)),
            ("streaming", lambda: port.StreamingKMeans(
                k=cs.STREAM_K, half_life=5.0, seed=SEED,
                shard_min_rows_per_device=cs.STREAM_BATCH // scale // (2 * C))
             .update_many(batches, mesh=mesh)),
            ("bulk_score", lambda: port.serve.bulk_score(model, x, mesh=mesh)),
        ):
            run()                                               # first use of each card
            sync_all(dev)
            t0 = time.perf_counter()
            out = run()
            sync_all(dev)
            got[leg] = (out, time.perf_counter() - t0)
        runs[name] = got
    a, b = runs["cards"], runs["one_card"]
    same_b = (np.array_equal(a["bisecting"][0].cluster_centers, b["bisecting"][0].cluster_centers)
              and a["bisecting"][0].fit_info["splits"] == b["bisecting"][0].fit_info["splits"])
    same_s = all(torch.equal(getattr(a["streaming"][0], k).cpu(),
                             getattr(b["streaming"][0], k).cpu())
                 for k in ("_centers", "_weights", "_weights_lo"))
    same_f = np.array_equal(a["bulk_score"][0], b["bulk_score"][0])
    if not (same_b and same_s and same_f):
        fail(f"the clustering legs over {C} cards differ from one card's: bisecting {same_b}, "
             f"streaming {same_s}, bulk_score {same_f}")
    secs = {leg: {"cards_s": a[leg][1], "one_card_s": b[leg][1]} for leg in a}
    print(f"({C}, 1) clustering legs, one process, over {C} cards against one card: "
          + "; ".join(f"{leg} {v['cards_s']:.4f} s / {v['one_card_s']:.4f} s "
                      f"({v['one_card_s'] / v['cards_s']:.2f}x)" for leg, v in secs.items())
          + f"; each == bit for bit ({card})", flush=True)
    return secs


def outofcore_leg(port, cs, C: int, cards: list, one: list, dev: str, x, warm, tmp: str,
                  scale: int, card: str) -> dict:
    """KMeans and the forest out of core over a (C, 1) mesh of the cards
    against the same shape over one card: ``==``.  Rows are the main path's
    ``x`` (memory-mapped from ``tmp``) and ``chip_smoke.py``'s rf20 shape,
    the blocks divided by ``scale``.  → their seconds."""
    import numpy as np

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models.tree import (
        engine,
    )

    np.save(os.path.join(tmp, "ooc.npy"), x)
    hk = port.HostDataset(x=np.load(os.path.join(tmp, "ooc.npy"), mmap_mode="r"),
                          max_device_rows=cs.OOC_BLOCK // scale)
    xf = cs.make_data(cs.TREE_N // scale, cs.D, 16)
    rng = np.random.default_rng(0)
    yf = xf @ rng.normal(size=(cs.D,)) + rng.normal(0.0, 0.3, size=len(xf))
    hf = port.HostDataset(x=xf, y=np.clip(np.round(yf + 1.5), 0, 3).astype(np.float32),
                          max_device_rows=cs.FOREST_BLOCK // scale)
    runs = {}
    for name, devs in (("cards", cards), ("one_card", one)):
        mesh = port.build_mesh(port.MeshConfig(data=C), devs)
        got = {}
        for leg, run in (
            ("kmeans", lambda: port.KMeans(k=K, seed=SEED, max_iter=MAX_ITER,
                                           warm_start_centers=warm).fit(hk, mesh=mesh)),
            ("forest", lambda: engine.grow_forest_outofcore(
                hf, mesh=mesh, task="regression", num_trees=20, max_depth=5, bootstrap=True,
                seed=0)),
        ):
            run()                                               # first use of each card
            sync_all(dev)
            t0 = time.perf_counter()
            out = run()
            sync_all(dev)
            got[leg] = (out, time.perf_counter() - t0)
        runs[name] = got
    a, b = runs["cards"], runs["one_card"]
    same_k = same(a["kmeans"][0], b["kmeans"][0])
    same_f = all(np.array_equal(getattr(a["forest"][0], k), getattr(b["forest"][0], k))
                 for k in ("split_feat", "threshold", "value"))
    if not (same_k and same_f):
        fail(f"out of core over {C} cards differs from one card's: kmeans {same_k}, "
             f"forest {same_f}")
    secs = {leg: {"cards_s": a[leg][1], "one_card_s": b[leg][1]} for leg in a}
    print(f"({C}, 1) out of core, one process, over {C} cards against one card: KMeans k={K} "
          f"on {hk.n} memmapped rows in {hk.block_shape()[0]} blocks, n_iter "
          f"{a['kmeans'][0].n_iter}; the forest on {hf.n} rows in {hf.block_shape()[0]} blocks; "
          + "; ".join(f"{leg} {v['cards_s']:.4f} s / {v['one_card_s']:.4f} s "
                      f"({v['one_card_s'] / v['cards_s']:.2f}x)" for leg, v in secs.items())
          + f"; each == bit for bit ({card})", flush=True)
    return secs


def fit(port, ds, warm, mesh, dev: str):
    """A warm KMeans fit of the dataset ``ds`` laid over ``mesh`` →
    (model, seconds)."""
    sync(dev)
    t0 = time.perf_counter()
    m = port.KMeans(k=len(warm), seed=SEED, max_iter=MAX_ITER, warm_start_centers=warm).fit(
        ds, mesh=mesh)
    sync(dev)
    return m, time.perf_counter() - t0


def rank_main(rank: int, world: int, store: str, dev: str, rows_path: str, out_path: str):
    """One rank: joins the group on its own entry, fits over the host-major
    (world, 1) mesh, pickles its model and seconds to ``out_path``."""
    import numpy as np

    sys.path.insert(0, str(ROOT))
    import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.parallel import (
        collectives,
        distributed,
    )

    res = {"rank": rank}
    try:
        device = "cpu" if dev == "cpu" else f"cuda:{rank}"
        ctx = distributed.initialize(f"file://{store}", world, rank, device=device)
        gather_s, inner = [0.0], collectives.gather_shards

        def timed_gather(parts, mesh):
            t0 = time.perf_counter()
            try:
                return inner(parts, mesh)
            finally:
                gather_s[0] += time.perf_counter() - t0

        collectives.gather_shards = timed_gather
        x = np.load(rows_path, mmap_mode="r")
        mesh = distributed.cluster_mesh()
        ds = port.parallel.device_dataset(x, mesh=mesh)      # this rank's shard
        fit(port, ds, np.asarray(x[:K]), mesh, dev)           # first use: the kernels' load
        gather_s[0] = 0.0
        m, s = fit(port, ds, np.asarray(x[:K]), mesh, dev)
        res.update(backend=ctx.backend, model=m, fit_s=s, gather_s=gather_s[0],
                   owned=mesh.local_data_shards())
    except Exception as e:  # noqa: BLE001 - the parent reports each rank's
        res["error"] = f"{type(e).__name__}: {e}"
    try:
        distributed.shutdown()
    except Exception as e:  # noqa: BLE001
        res["shutdown_error"] = f"{type(e).__name__}: {e}"
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
    os._exit(0)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", type=int, default=0,
                    help="rehearse on this many CPU entries (gloo ranks, small rows)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    import chip_smoke as cs
    import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port

    if args.cpu:
        dev, C, n = "cpu", args.cpu, 200_000
        card = f"cpu rehearsal, {C} entries"
    else:
        if not torch.cuda.is_available():
            fail("no CUDA device: pass --cpu N to rehearse")
        dev, C, n = "cuda", torch.cuda.device_count(), cs.N
        if C < 2:
            fail(f"{C} card(s): this script needs at least 2")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        card = "; ".join(sorted(set(smi.stdout.strip().splitlines())))
        from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import _build

        _build.build()
    print(card, flush=True)
    x = cs.make_data(n, cs.D, K, SEED)
    warm = x[:K].copy()
    out = {"cards": C, "card": card, "rows": n}
    cards = [dev if dev == "cpu" else f"cuda:{i}" for i in range(C)]
    one = [dev if dev == "cpu" else "cuda:0"] * C
    ds = port.device_dataset(x, device=one[0])
    legs = {}
    for shape in ((C, 1), (C // 2, 2)):
        if shape[0] < 1 or shape[0] * shape[1] != C:
            continue
        cfg = port.MeshConfig(data=shape[0], model=shape[1])
        mesh_c, mesh_1 = port.build_mesh(cfg, cards), port.build_mesh(cfg, one)
        on_cards = port.parallel.sharding.shard_dataset(ds, mesh_c)
        on_one = port.parallel.sharding.shard_dataset(ds, mesh_1)
        fit(port, on_cards, warm, mesh_c, dev)                   # first use of each card
        spread, s_spread = fit(port, on_cards, warm, mesh_c, dev)
        single, s_single = fit(port, on_one, warm, mesh_1, dev)
        if not same(spread, single):
            fail(f"{shape} over {C} cards differs from {shape} over one card")
        legs[str(shape)] = {"cards_s": s_spread, "one_card_s": s_single,
                            "n_iter": spread.n_iter}
        print(f"{shape} mesh, one process: over {C} cards {s_spread:.4f} s, over one card "
              f"{s_single:.4f} s ({s_single / s_spread:.2f}x), n_iter {spread.n_iter}, "
              f"== bit for bit ({card})", flush=True)
        if shape == (C, 1):
            ref = spread
        del on_cards, on_one
    out["in_process"] = legs
    del ds
    window = port.extract_training_window(
        port.Table.from_dict(cs.hospital_events((40_000 if dev == "cpu" else cs.TREE_N) // 5),
                             port.hospital_event_schema()), port.PipelineConfig(), device=one[0])
    out["model_stage"] = stage_leg(port, window, C, cards, one, dev, card,
                                   "before the clustering legs")
    out["clustering"] = clustering_leg(port, cs, C, cards, one, dev, 50 if dev == "cpu" else 1,
                                       ref, x, card)
    if dev != "cpu":
        torch.cuda.empty_cache()
    # the stage once more: what the clustering legs leave behind slows it or not
    out["model_stage_after_clustering"] = stage_leg(port, window, C, cards, one, dev, card,
                                                    "after the clustering legs")
    if dev != "cpu":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out["outofcore"] = outofcore_leg(port, cs, C, cards, one, dev, x, warm, tmp,
                                         50 if dev == "cpu" else 1, card)
    if dev != "cpu":
        torch.cuda.empty_cache()

    # the ranks after the in-process legs, so no leg shares a card
    with tempfile.TemporaryDirectory() as tmp:
        rows_path = os.path.join(tmp, "rows.npy")
        np.save(rows_path, x)
        spawn = mp.get_context("spawn")
        procs = []
        for r in range(C):
            res_path = os.path.join(tmp, f"rank{r}.pkl")
            p = spawn.Process(target=rank_main, args=(r, C, os.path.join(tmp, "store"), dev,
                                                      rows_path, res_path))
            p.start()
            procs.append((p, res_path))
        t_spawn = time.perf_counter()
        for p, _ in procs:
            p.join(max(1.0, JOIN_S - (time.perf_counter() - t_spawn)))
            if p.is_alive():
                p.kill()
                p.join()
        ranks = []
        for p, res_path in procs:
            if p.exitcode != 0 or not os.path.exists(res_path):
                fail(f"a rank exited {p.exitcode} without its result")
            with open(res_path, "rb") as f:
                ranks.append(pickle.load(f))
        for r in ranks:
            if "error" in r:
                fail(f"rank {r['rank']}: {r['error']}")
            if not same(r["model"], ref):
                fail(f"rank {r['rank']} differs from the in-process ({C}, 1) fit")
        out["ranks"] = {"backend": ranks[0]["backend"],
                        "fit_s": [r["fit_s"] for r in ranks],
                        "gather_s": [r["gather_s"] for r in ranks],
                        "wall_s": time.perf_counter() - t_spawn}
        print(f"({C}, 1) mesh over {C} processes, one entry each, {ranks[0]['backend']}: every "
              f"rank == the in-process fit; fit s {[round(r['fit_s'], 4) for r in ranks]}, of it "
              f"in the ordered gather {[round(r['gather_s'], 4) for r in ranks]} ({card})",
              flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
