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
   it inside the ordered gather (``collectives.gather_shards``);
6. slice 8c-3's estimators and composites over a (C, 1) mesh of the C
   cards on ``chip_smoke.py``'s 2M hospital rows (``mesh_estimators_phase``'s
   (4, 1) legs), each ``==`` the (C, 1) mesh over ``[cuda:0] * C``:
   LinearSVC, gaussian NaiveBayes, OneVsRest over trees and over
   LogisticRegression, the Poisson GLM with an offset and its summary,
   AFT, FMRegressor, the MLP, IsotonicRegression, the two pipelines, the
   CrossValidator and the TrainValidationSplit (its silhouette metrics
   too: the silhouette's first pass sums in a fixed order), with their
   seconds;
7. slice 8c-4's modules over a (C, 1) mesh of the C cards, each ``==`` the
   (C, 1) mesh over ``[cuda:0] * C``: the sharded moments, PCA,
   MinMaxScaler, MaxAbsScaler, RobustScaler and VarianceThresholdSelector,
   ``stat/``'s Summarizer, Correlation, KS, ANOVA and FValue and the
   ANOVA selector on ``chip_smoke.py``'s 2M hospital rows; LDA(k=10)
   resident and out of core on 20,000 of its clinical notes;
   PowerIterationClustering on the bundled CSV's 20,000-node graph; ALS
   (explicit and implicit) on its first 20,000 patients' ratings; with
   their seconds.

``--legs`` runs a subset of the legs (the numbers above, default all), so
a call that tests one slice's path runs that path alone.

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


def estimators_leg(port, cs, C: int, cards: list, one: list, dev: str, scale: int,
                   card: str) -> dict:
    """Slice 8c-3's fits over a (C, 1) mesh of the cards against the same
    shape over one card: every fitted array ``==``.  Rows are
    ``chip_smoke.py``'s 2M hospital rows (its 2M censored AFT rows)
    divided by ``scale``.  → each leg's seconds."""
    import dataclasses

    import numpy as np
    import torch

    cs.TREE_N //= scale
    try:
        x, los, yb = cs.stage_rows()
        xa, ya, cen = cs.aft_rows(cs.TREE_N)
    finally:
        cs.TREE_N *= scale
    x, los = x.astype(np.float32), los.astype(np.float32)
    tiers = np.digitize(los, np.quantile(los, [0.5, 0.85])).astype(np.float32)
    days = np.maximum(np.rint(los), 1.0).astype(np.float32)
    names = list(port.FEATURE_COLS)
    cols = {c: x[:, j] for j, c in enumerate(names)}
    table = port.Table.from_dict({**cols, port.LABEL_COL: los})
    glm_table = port.VectorAssembler(names).transform(port.Table.from_dict(
        {**cols, port.LABEL_COL: days,
         "log_exposure": np.log(x[:, 0].astype(np.float64) + 1.0).astype(np.float32)}))
    tune = len(x) // 4
    xz = ((x[:tune] - x[:tune].mean(axis=0)) / x[:tune].std(axis=0)).astype(np.float32)

    def arrays(m) -> list:
        """Every array a fitted model (or composite) holds, on the host."""
        if hasattr(m, "models"):
            return [a for sub in m.models for a in arrays(sub)]
        if hasattr(m, "stages"):
            return [a for sub in m.stages for a in arrays(sub)]
        if hasattr(m, "best_model"):
            metrics = getattr(m, "avg_metrics", getattr(m, "validation_metrics", None))
            return [np.asarray(metrics), np.asarray(m.best_index)] + arrays(m.best_model)
        if hasattr(m, "weights") and isinstance(m.weights, list):
            return [t.cpu().numpy() for wb in m.weights for t in wb]
        out = []
        for f in dataclasses.fields(m) if dataclasses.is_dataclass(m) else ():
            v = getattr(m, f.name)
            if isinstance(v, torch.Tensor):
                out.append(v.cpu().numpy())
            elif isinstance(v, (np.ndarray, float, int)):
                out.append(np.asarray(v))
        return out

    grid_d = port.ParamGridBuilder().add_grid("max_depth", [3, 5]).build()
    grid_k = port.ParamGridBuilder().add_grid("k", [8, 16]).build()
    legs = {
        "svc": lambda m: port.LinearSVC(tol=cs.CLS_TOL).fit((x, yb), mesh=m),
        "nb_gaussian": lambda m: port.NaiveBayes(model_type="gaussian").fit((x, tiers), mesh=m),
        "ovr_tree": lambda m: port.OneVsRest(port.DecisionTreeClassifier(max_depth=5)).fit(
            (x, tiers), mesh=m),
        "ovr_logistic": lambda m: port.OneVsRest(port.LogisticRegression(tol=cs.CLS_TOL)).fit(
            (x, tiers), mesh=m),
        "glm": lambda m: port.GeneralizedLinearRegression(
            family="poisson", tol=cs.FAM_TOL, offset_col="log_exposure").fit(glm_table, mesh=m),
        "aft": lambda m: port.AFTSurvivalRegression(max_iter=100).fit((xa, ya), mesh=m,
                                                                      censor=cen),
        "fm": lambda m: port.FMRegressor(factor_size=8, max_iter=100).fit((x, los), mesh=m),
        "mlp": lambda m: port.MultilayerPerceptronClassifier(
            layers=(4, 16, 2), max_iter=150, seed=0).fit((x, yb), mesh=m),
        "isotonic": lambda m: port.IsotonicRegression(feature_index=1).fit((x, los), mesh=m),
        "pipe_lr": lambda m: port.Pipeline([port.VectorAssembler(names), port.StandardScaler(),
                                            port.LinearRegression()]).fit(table, mesh=m),
        "pipe_kmeans": lambda m: port.Pipeline([
            port.VectorAssembler(names), port.StandardScaler(),
            port.KMeans(k=16, seed=SEED, max_iter=MAX_ITER)]).fit(table, mesh=m),
        "cv_tree": lambda m: port.CrossValidator(
            port.DecisionTreeRegressor(), grid_d, port.RegressionEvaluator("rmse"),
            num_folds=3).fit((x[:tune], days[:tune]), mesh=m),
        "tvs_kmeans": lambda m: port.TrainValidationSplit(
            port.KMeans(seed=SEED, max_iter=MAX_ITER), grid_k,
            port.ClusteringEvaluator()).fit(xz, mesh=m),
    }
    legs["svc"](port.build_mesh(port.MeshConfig(data=C), cards))   # first use of each card
    secs = {}
    for leg, run in legs.items():
        got = {}
        for name, devs in (("cards", cards), ("one_card", one)):
            mesh = port.build_mesh(port.MeshConfig(data=C), devs)
            sync_all(dev)
            t0 = time.perf_counter()
            model = run(mesh)
            sync_all(dev)
            got[name] = (arrays(model), time.perf_counter() - t0)
        (a, s_a), (b, s_b) = got["cards"], got["one_card"]
        if not a or len(a) != len(b) or not all(np.array_equal(u, v) for u, v in zip(a, b)):
            fail(f"slice 8c-3's {leg} over {C} cards differs from one card's")
        secs[leg] = {"cards_s": s_a, "one_card_s": s_b}
    print(f"({C}, 1) slice 8c-3 estimators and composites, one process, on {len(x)} hospital "
          f"rows over {C} cards against one card: "
          + "; ".join(f"{leg} {v['cards_s']:.4f} s / {v['one_card_s']:.4f} s "
                      f"({v['one_card_s'] / v['cards_s']:.2f}x)" for leg, v in secs.items())
          + f"; each == bit for bit ({card})", flush=True)
    return secs


def features_leg(port, cs, C: int, cards: list, one: list, dev: str, scale: int,
                 card: str) -> dict:
    """Slice 8c-4's modules over a (C, 1) mesh of the cards against the same
    shape over one card: every result ``==``.  The hospital rows, notes,
    ratings and graph are ``chip_smoke.py``'s, their counts divided by
    ``scale``.  → each leg's seconds."""
    import dataclasses

    import numpy as np
    import torch

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import reductions

    cs.TREE_N //= scale
    try:
        x, los, _ = cs.stage_rows()
    finally:
        cs.TREE_N *= scale
    x, lf = x.astype(np.float32), los.astype(np.float32)
    tiers = np.digitize(lf, np.quantile(lf, [0.5, 0.85])).astype(np.float32)
    z = ((lf - lf.mean()) / lf.std()).astype(np.float32)[:, None]
    names = list(port.FEATURE_COLS)
    asm = port.VectorAssembler(names).transform(port.Table.from_dict(
        {**{c: x[:, j] for j, c in enumerate(names)}, "tier": tiers}))
    texts = cs.clinical_notes(cs.MF_DOCS // scale, port.StopWordsRemover().stop_words)
    clean = port.StopWordsRemover().transform(port.Tokenizer().transform(texts))
    docs = port.CountVectorizer(min_df=2).fit(clean).transform(clean)
    uu, ii, rr = cs.als_ratings()
    cut = uu < cs.ALS_CUT_USERS // scale
    cu, ci, cr = uu[cut], ii[cut], rr[cut]
    table = port.read_csv(str(cs.CSV), port.hospital_event_schema())
    xg = table.numeric_matrix(port.FEATURE_COLS)[: 20_000 // scale]
    cs.DEV = one[0]
    src, dst, w = cs.knn_graph((xg - xg.mean(0)) / xg.std(0), cs.PIC_NEIGHBOURS)

    def arrays(m) -> list:
        if isinstance(m, dict):
            return [np.asarray(v) for v in m.values()]
        if isinstance(m, (tuple, list)):
            return [np.asarray(v) for v in m]
        if isinstance(m, np.ndarray):
            return [m]
        if dataclasses.is_dataclass(m):
            out = []
            for f in dataclasses.fields(m):
                v = getattr(m, f.name)
                if isinstance(v, torch.Tensor):
                    out.append(v.cpu().numpy())
                elif isinstance(v, (np.ndarray, float, int, tuple)):
                    out.append(np.asarray(v))
            return out
        return [np.asarray(v) for v in vars(m).values()]

    st = port.stat
    hd = port.HostDataset(x=docs, max_device_rows=len(docs) // cs.LDA_BLOCKS)

    def rows(m):
        return port.parallel.device_dataset(x, mesh=m)

    legs = {
        "moments": lambda m: reductions.host_moments(rows(m).x, rows(m).w),
        "pca": lambda m: port.PCA(3).fit(rows(m)),
        "minmax": lambda m: port.MinMaxScaler().fit(rows(m)),
        "maxabs": lambda m: port.MaxAbsScaler().fit(rows(m)),
        "robust": lambda m: port.RobustScaler().fit(rows(m)),
        "variance": lambda m: port.VarianceThresholdSelector(1.0).fit(rows(m)).selected,
        "summary": lambda m: st.Summarizer.summary(x, m),
        "corr": lambda m: st.Correlation.corr(x, "pearson", m),
        "ks": lambda m: st.KolmogorovSmirnovTest.test(z, "norm", 0.0, 1.0, m),
        "anova": lambda m: st.ANOVATest.test(x, tiers, m),
        "fvalue": lambda m: st.FValueTest.test(x, lf, m),
        "selector": lambda m: port.UnivariateFeatureSelector(
            selection_mode="numTopFeatures", selection_threshold=2,
            label_col="tier").fit(asm, mesh=m).selected,
        "lda": lambda m: port.LDA(k=cs.NOTE_TOPICS, max_iter=cs.MF_LDA_ITERS).fit(docs, mesh=m),
        "lda_ooc": lambda m: port.LDA(k=cs.NOTE_TOPICS, max_iter=cs.LDA_BLOCKS).fit(hd, mesh=m),
        "pic": lambda m: port.PowerIterationClustering(k=cs.PIC_K, max_iter=20).assign_clusters(
            src, dst, w, m),
        "als": lambda m: port.ALS(rank=cs.ALS_RANK, max_iter=10, reg_param=0.1).fit(
            (cu, ci, cr), mesh=m),
        "als_implicit": lambda m: port.ALS(rank=cs.ALS_RANK, max_iter=10, reg_param=0.1,
                                           implicit_prefs=True).fit(
            (cu, ci, np.maximum(cr, 0.0)), mesh=m),
    }
    legs["moments"](port.build_mesh(port.MeshConfig(data=C), cards))   # first use of each card
    secs = {}
    for leg, run in legs.items():
        got = {}
        for name, devs in (("cards", cards), ("one_card", one)):
            mesh = port.build_mesh(port.MeshConfig(data=C), devs)
            sync_all(dev)
            t0 = time.perf_counter()
            out = run(mesh)
            sync_all(dev)
            got[name] = (arrays(out), time.perf_counter() - t0)
        (a, s_a), (b, s_b) = got["cards"], got["one_card"]
        if not a or len(a) != len(b) or not all(np.array_equal(u, v) for u, v in zip(a, b)):
            fail(f"slice 8c-4's {leg} over {C} cards differs from one card's")
        secs[leg] = {"cards_s": s_a, "one_card_s": s_b}
    print(f"({C}, 1) slice 8c-4 modules, one process, on {len(x)} hospital rows, {len(docs)} "
          f"notes, {len(cu)} ratings and {len(xg)} graph nodes over {C} cards against one card: "
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


def in_process_leg(port, x, warm, C: int, cards: list, one: list, dev: str, card: str,
                   out: dict):
    """Item 1: KMeans over (C, 1) and (C/2, 2) meshes of the cards against
    the same shapes over one card.  → the (C, 1) fit."""
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
    return ref


def ranks_leg(x, C: int, dev: str, ref, card: str) -> dict:
    """Item 5: C processes, one card each, every rank's model ``==`` the
    in-process (C, 1) fit ``ref``.  → the ranks' seconds."""
    import numpy as np
    import torch.multiprocessing as mp

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
        res = {"backend": ranks[0]["backend"], "fit_s": [r["fit_s"] for r in ranks],
               "gather_s": [r["gather_s"] for r in ranks],
               "wall_s": time.perf_counter() - t_spawn}
        print(f"({C}, 1) mesh over {C} processes, one entry each, {ranks[0]['backend']}: every "
              f"rank == the in-process fit; fit s {[round(r['fit_s'], 4) for r in ranks]}, of it "
              f"in the ordered gather {[round(r['gather_s'], 4) for r in ranks]} ({card})",
              flush=True)
    return res


def empty_caches(dev: str) -> None:
    if dev != "cpu":
        import torch

        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", type=int, default=0,
                    help="rehearse on this many CPU entries (gloo ranks, small rows)")
    ap.add_argument("--legs", default="1,2,3,4,5,6,7",
                    help="the legs to run, by their numbers above (default all)")
    args = ap.parse_args()
    legs_on = {int(v) for v in args.legs.split(",")}
    sys.path.insert(0, str(ROOT))
    import torch

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
    if legs_on & {1, 3, 4, 5}:
        x = cs.make_data(n, cs.D, K, SEED)
        warm = x[:K].copy()
    out = {"cards": C, "card": card, "rows": n}
    cards = [dev if dev == "cpu" else f"cuda:{i}" for i in range(C)]
    one = [dev if dev == "cpu" else "cuda:0"] * C
    if legs_on & {1, 3, 5}:       # legs 3 and 5 hold to leg 1's (C, 1) fit
        ref = in_process_leg(port, x, warm, C, cards, one, dev, card, out)
    if legs_on & {2, 3}:
        window = port.extract_training_window(
            port.Table.from_dict(cs.hospital_events((40_000 if dev == "cpu" else cs.TREE_N) // 5),
                                 port.hospital_event_schema()), port.PipelineConfig(),
            device=one[0])
    if 2 in legs_on:
        out["model_stage"] = stage_leg(port, window, C, cards, one, dev, card,
                                       "before the clustering legs")
    if 3 in legs_on:
        out["clustering"] = clustering_leg(port, cs, C, cards, one, dev,
                                           50 if dev == "cpu" else 1, ref, x, card)
        empty_caches(dev)
        # the stage once more: what the clustering legs leave behind slows it or not
        out["model_stage_after_clustering"] = stage_leg(port, window, C, cards, one, dev, card,
                                                        "after the clustering legs")
    empty_caches(dev)
    if 4 in legs_on:
        with tempfile.TemporaryDirectory() as tmp:
            out["outofcore"] = outofcore_leg(port, cs, C, cards, one, dev, x, warm, tmp,
                                             50 if dev == "cpu" else 1, card)
        empty_caches(dev)
    if 6 in legs_on:
        out["estimators"] = estimators_leg(port, cs, C, cards, one, dev,
                                           50 if dev == "cpu" else 1, card)
        empty_caches(dev)
    if 7 in legs_on:
        out["features"] = features_leg(port, cs, C, cards, one, dev,
                                       50 if dev == "cpu" else 1, card)
        empty_caches(dev)
    if 5 in legs_on:
        # the ranks after the in-process legs, so no leg shares a card
        out["ranks"] = ranks_leg(x, C, dev, ref, card)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
