"""Gradient-boosted trees — GBTRegressor / GBTClassifier (the JAX
package's ``models/tree/gbt.py``).

Spark's ``GBTRegressor`` (squared loss) and ``GBTClassifier`` (LogLoss on
labels 0/1: F is half the log-odds, F₀ = ½ log(p/(1−p)), pseudo-residual
4(y − σ(2F))).  Boosting is sequential in rounds; each round is one tree
of the level-order engine (``engine.py``) on the pseudo-residuals, K3 at
T = 1 once a level on the card:

    residual (device) → grow one tree → its heap tensors on the device
                      → F ← F + lr·tree(x)

The quantile thresholds and the (d, n) bin matrix depend only on x, so
both are computed once and reused by every round, and F never leaves the
device.  Two routes:

- the default: every round on the device with no host sync — each tree
  is a ``grow_forest(..., defer_fetch=True)`` whose winners become heap
  tensors (``engine.device_tree_arrays``) that the margin update walks —
  and one copy of every round's winners at the end;
- ``validation_indicator_col``: rows marked true train nothing and score
  every round; the fit stops when their loss stops improving by
  ``validation_tol`` (Spark's runWithValidation), one host sync a round
  by design, and keeps the best prefix of rounds.

The resident boost runs over data shards (``models.base.Shards``: one
device is one shard, ``fit(..., mesh=)`` or a ``ShardedDataset`` spread the
rows over a mesh): the margin F, the residuals and the bin matrix live a
data shard on its device; each round's tree grows through the engine (K3
once a shard a level, the histograms summed in shard order) and its heap
tensors, built once on the home device, move to every shard to advance F.
In one process the rounds make no host sync.  The validation rows are cut
as the data is, and their loss is summed in shard order.

A :class:`~...parallel.outofcore.HostDataset` boosts out of core, on one
device or over a mesh: the margin column lives on the host, each round
grows one out-of-core tree (``engine.grow_forest_outofcore``) and streams
the blocks through it to advance F, each block shard predicted on its
device; ``checkpoint_dir`` commits the margin and the trees every
``checkpoint_every`` rounds (``io/fit_checkpoint.py``, the reference's
signature), so a preempted fit resumes at the next round.

``use_pallas``, ``fused_levels`` and ``fused_rounds`` are accepted and
change nothing: K3 is the histogram on the card, and in eager torch the
reference's scanned rounds and its per-round deferred loop are one loop.

``stage_clock`` (a ``utils.profiling.StageClock``) brackets the resident
fit's stages under the reference's names: ``bin`` (the sample, the
thresholds and the bin matrix), ``init`` (F₀), ``boost`` (every round,
drained on the card before the stage closes, so it measures the device
work and not the launches) and ``fetch_materialize`` (the one bulk copy
and the trees built from it); a validation fit bills its whole loop to
``boost``.  Out-of-core fits ignore it, as in the reference.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ...io.model_io import register_model
from ...parallel.outofcore import HostDataset, shard_rows, stream_mesh
from ...parallel.sharding import sample_valid_rows
from ..base import Estimator, Model, Shards, check_features, is_sharded, on_mesh
from . import engine
from .binning import quantile_thresholds


def _stage(clock, name: str):
    """StageClock stage when a clock is attached, else a no-op context."""
    return clock.stage(name) if clock is not None else nullcontext()


@register_model("GBTModel")
@dataclass
class GBTModel(Model):
    """Stacked boosted trees: prediction = init + lr · Σ_t tree_t(x)."""

    task: str                    # "regression" | "classification"
    split_feat: np.ndarray       # (T, total)
    threshold: np.ndarray        # (T, total)
    value: np.ndarray            # (T, total, 1)
    init: float                  # F₀ (mean | half the base log-odds)
    learning_rate: float
    feature_importances: np.ndarray
    max_depth: int
    # categorical (unordered-set) splits; None for all-continuous fits
    split_catmask: np.ndarray | None = None
    cat_arities: np.ndarray | None = None

    @property
    def num_trees(self) -> int:
        return self.split_feat.shape[0]

    def _raw(self, x: torch.Tensor) -> torch.Tensor:
        check_features(x, self.feature_importances.shape[-1], "GBTModel")
        cat_mask = cat_flags = None
        if self.split_catmask is not None:
            cat_mask = self.split_catmask
            cat_flags = np.asarray(self.cat_arities) > 0
        out = engine.predict_forest(x.to(torch.float32), self.split_feat, self.threshold,
                                    self.value, cat_mask, cat_flags)[:, :, 0]   # (T, n)
        return self.init + self.learning_rate * out.sum(dim=0)

    def predict_raw(self, x: torch.Tensor) -> torch.Tensor:
        return self._raw(x)

    def predict_proba(self, x: torch.Tensor) -> torch.Tensor:
        if self.task != "classification":
            raise ValueError("predict_proba is classification-only")
        return torch.sigmoid(2.0 * self._raw(x))    # Spark's ±1 margin

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        raw = self._raw(x)
        if self.task == "regression":
            return raw
        return (raw > 0).to(torch.float32)

    def _artifacts(self):
        arrays = {
            "split_feat": np.asarray(self.split_feat, np.int32),
            "threshold": np.asarray(self.threshold, np.float32),
            "value": np.asarray(self.value, np.float32),
            "feature_importances": np.asarray(self.feature_importances, np.float64),
        }
        if self.split_catmask is not None:
            arrays["split_catmask"] = np.asarray(self.split_catmask, np.uint32)
            arrays["cat_arities"] = np.asarray(self.cat_arities)
        return (
            "GBTModel",
            {
                "task": self.task,
                "init": float(self.init),
                "learning_rate": float(self.learning_rate),
                "max_depth": int(self.max_depth),
            },
            arrays,
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        def arr(key, dtype=None):
            v = arrays.get(key)
            return None if v is None else np.asarray(v, dtype=dtype)

        return cls(
            task=params["task"],
            split_feat=arr("split_feat", np.int32),
            threshold=arr("threshold", np.float32),
            value=arr("value", np.float32),
            init=float(params["init"]),
            learning_rate=float(params["learning_rate"]),
            feature_importances=arr("feature_importances"),
            max_depth=int(params["max_depth"]),
            split_catmask=arr("split_catmask", np.uint32),
            cat_arities=arr("cat_arities"),
        )


def _val_loss(y, f, loss: str) -> torch.Tensor:
    """Per-row validation loss: squared error, or Spark's LogLoss
    2·log(1 + e^(−2y±F))."""
    if loss == "squared":
        return (y - f) ** 2
    ypm = 2.0 * y - 1.0
    return 2.0 * torch.log1p(torch.exp(-2.0 * ypm * f))


def _prior_margin(ybar: float, loss: str) -> float:
    """F₀: the label mean (squared loss) or half the base log-odds
    (Spark's LogLoss prior)."""
    if loss == "squared":
        return ybar
    p = min(max(ybar, 1e-6), 1.0 - 1e-6)
    return 0.5 * float(np.log(p / (1.0 - p)))


def _ensemble(trees: list, loss: str, f0: float, step_size: float, max_depth: int,
              cat: dict | None) -> GBTModel:
    """The boosted rounds' trees (one-tree ``GrownForest``s) → GBTModel."""
    imp = np.sum([g.importances[0] for g in trees], axis=0)
    s = imp.sum()
    return GBTModel(
        task="regression" if loss == "squared" else "classification",
        split_feat=np.concatenate([g.split_feat for g in trees]),
        threshold=np.concatenate([g.threshold for g in trees]),
        value=np.concatenate([g.value for g in trees]),
        init=f0,
        learning_rate=step_size,
        feature_importances=imp / s if s > 0 else imp,
        max_depth=max_depth,
        split_catmask=np.concatenate([g.split_catmask for g in trees]) if cat else None,
        cat_arities=trees[0].cat_arities if cat else None,
    )


@dataclass(frozen=True)
class _GBTParams:
    max_iter: int = 20            # Spark's maxIter (number of trees)
    max_depth: int = 5
    max_bins: int = 32
    step_size: float = 0.1        # Spark's stepSize (learning rate)
    min_instances_per_node: int = 1
    min_info_gain: float = 0.0
    subsampling_rate: float = 1.0
    seed: int = 0
    label_col: str = "length_of_stay"
    features_col: str = "features"
    weight_col: str | None = None
    init_sample_size: int = 65536     # the binning sample
    #: MLlib's categoricalFeaturesInfo: feature index → arity
    categorical_features: dict[int, int] | None = None
    #: Spark's validationIndicatorCol / validationTol: rows where the named
    #: boolean column is true are held out; boosting stops when their loss
    #: stops improving
    validation_indicator_col: str | None = None
    validation_tol: float = 0.01      # Spark default
    #: out-of-core (HostDataset) fits commit the margin and the trees every
    #: ``checkpoint_every`` rounds; resident fits ignore it
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1
    #: the reference's switches; no effect here (module docstring)
    fused_rounds: bool = True
    fused_levels: bool = True
    use_pallas: bool = False
    stage_clock: Any = field(default=None, compare=False, repr=False)

    def _resolve_validation(self, data, ds):
        """validation_indicator_col → the (n_pad,) float 0/1 column cut as
        the data is, ``{shard: its part on its device}`` (a DeviceDataset
        is shard 0), or None."""
        if self.validation_indicator_col is None:
            return None
        from ...features.assembler import AssembledTable

        if not isinstance(data, AssembledTable):
            raise ValueError(
                f"validation_indicator_col={self.validation_indicator_col!r} "
                "needs a table input to resolve the column; got "
                f"{type(data).__name__} — pass an AssembledTable"
            )
        ind = np.asarray(data.table.column(self.validation_indicator_col)).astype(bool)
        pad = np.zeros((ds.n_padded,), np.float32)
        pad[: ind.shape[0]] = ind
        if is_sharded(ds):
            from ...parallel.sharding import shard_rows

            cut = shard_rows(pad, ds.mesh)
            return {i: cut.block(i) for i in ds.mesh.local_data_shards()}
        return {0: torch.from_numpy(pad).to(ds.x.device)}

    def _boost(self, sh: Shards, loss: str, val_ind=None) -> GBTModel:
        """The resident boost over the data shards of ``sh`` (one shard on
        one device): F, the residuals, the bin matrix and the validation
        rows a shard on its device, each round's tree grown by the engine
        over the shards, its heap tensors built on the home device and
        moved to every shard; F is a ``{shard: tensor}`` map."""
        clock = self.stage_clock
        home = sh.home
        f32 = torch.float32
        x = {i: s.x.to(f32) for i, s in sh.data.items()}
        y = {i: s.y.to(f32) for i, s in sh.data.items()}
        w_all = {i: s.w.to(f32) for i, s in sh.data.items()}
        if val_ind is not None:
            # held-out rows train nothing (weight 0) but score every round
            w = {i: w_all[i] * (1.0 - val_ind[i]) for i in sh.local}
            w_val = {i: w_all[i] * val_ind[i] for i in sh.local}
            if float(sh.sum(lambda i, s: (w_val[i].sum(),))[0]) == 0.0:
                raise ValueError("validation_indicator_col selected no validation rows")
        else:
            w, w_val = w_all, None
        train = sh.with_rows(x=x, y=y, w=w)
        B = self.max_bins
        cat = self.categorical_features
        with _stage(clock, "bin"):
            # binning depends only on x: thresholds (from the training
            # rows' sample) and the bin matrix, once for every round; the
            # categorical range check covers every valid row, held-out
            # ones too
            sample = sample_valid_rows(train.dataset(), self.init_sample_size, self.seed)
            if sample.shape[0] == 0:
                raise ValueError("GBT fit on an empty dataset")
            thr = quantile_thresholds(sample, B)
            binned = {i: engine.bin_feature_matrix(x[i], thr, cat, w=w_all[i])
                      for i in sh.local}
        with _stage(clock, "init"):
            sw, syw = sh.sum(lambda i, s: (w[i].sum(), (y[i] * w[i]).sum()))
            f0 = _prior_margin(float(syw / torch.clamp(sw, min=1.0)), loss)

        d = sh.n_features
        cat_arities = tuple(cat.get(f, 0) for f in range(d)) if cat else None
        is_cat_host = np.asarray([f in cat for f in range(d)] if cat else np.zeros(d, bool))
        is_cat = torch.as_tensor(is_cat_host, device=home)
        cat_sh = {i: is_cat.to(sh.device(i)) for i in sh.local} if cat else None
        thr_dev = torch.as_tensor(thr, dtype=f32, device=home)
        lr = float(np.float32(self.step_size))
        f_cur = {i: torch.full(y[i].shape, float(np.float32(f0)), dtype=f32,
                               device=sh.device(i)) for i in sh.local}

        def residual(i, f):
            if loss == "squared":
                return y[i] - f
            # Spark's LogLoss: loss 2·log(1 + e^(−2y±F)), so the
            # pseudo-residual is 4(y01 − σ(2F)); the factor matters for
            # stepSize parity with Spark
            return 4.0 * (y[i] - torch.sigmoid(2.0 * f))

        def advance(f, sf, th, val, cm):
            # categorical rounds route by the set mask here too: the later
            # rounds' residuals depend on this prediction
            out = {}
            for i in sh.local:
                dev = sh.device(i)
                cmi = cm.to(dev) if isinstance(cm, torch.Tensor) else cm
                out[i] = f[i] + lr * engine.predict_forest(
                    x[i], sf.to(dev), th.to(dev), val.to(dev), cmi,
                    None if cat_sh is None else cat_sh[i])[0, :, 0]
            return out

        def grow_round(t: int, f, defer: bool):
            return engine.grow_forest(
                train.with_rows(y={i: residual(i, f[i]) for i in sh.local}),
                task="regression", num_trees=1, max_depth=self.max_depth, max_bins=B,
                min_instances_per_node=self.min_instances_per_node,
                min_info_gain=self.min_info_gain, bootstrap=self.subsampling_rate < 1.0,
                subsampling_rate=self.subsampling_rate, seed=self.seed + t,
                bin_thresholds=thr, binned_t=binned, categorical_features=cat,
                defer_fetch=defer, cat_flags=is_cat if cat else None)

        template = engine.DeferredForest(
            level_out=[], thr=thr, task="regression", num_classes=2,
            cat_arities=cat_arities, B=B, max_depth=self.max_depth,
            is_cat_host=is_cat_host, T=1, d=d, S=3)
        if val_ind is None:
            with _stage(clock, "boost"):
                packed = self._device_rounds(f_cur, grow_round, advance, thr_dev, is_cat)
                if clock is not None:
                    # attribution only (clocked fits): drain the rounds so
                    # "boost" measures the device work, not the launches
                    from ...utils.profiling import device_fence

                    device_fence(packed)
            with _stage(clock, "fetch_materialize"):
                fetched = packed.cpu().numpy()  # the one bulk fetch
                trees = [template.fetch_packed(fetched[t : t + 1])
                         for t in range(self.max_iter)]
        else:
            # the validated loop fetches each round to decide the stop:
            # its growth and fetches bill to "boost" together
            def val_err(f):
                e, nv = sh.sum(lambda i, s: ((_val_loss(y[i], f[i], loss) * w_val[i]).sum(),
                                             w_val[i].sum()))
                return e / torch.clamp(nv, min=1.0)

            with _stage(clock, "boost"):
                trees = self._boost_validated(grow_round, advance, f_cur, val_err, home)
        return _ensemble(trees, loss, f0, self.step_size, self.max_depth, cat)

    def _fit(self, data, label_col, device, mesh, loss: str) -> GBTModel:
        """A resident fit on ``device`` or over ``mesh``."""
        ds = on_mesh(data, label_col or self.label_col, device, self.weight_col, mesh)
        if loss == "logistic":
            _check_binary_labels(ds)
        return self._boost(Shards(ds), loss, self._resolve_validation(data, ds))

    def _device_rounds(self, f_cur, grow_round, advance, thr_dev, is_cat) -> torch.Tensor:
        """Every boosting round on the device with no host sync: the
        pseudo-residual, one deferred tree (K3 a level), its heap tensors
        and the margin update.  → every round's winners packed,
        (max_iter, W), for one fetch."""
        packed = []
        for t in range(self.max_iter):
            level_out = grow_round(t, f_cur, defer=True).level_out
            f_cur = advance(f_cur, *engine.device_tree_arrays(level_out, thr_dev, is_cat,
                                                              self.max_bins))
            packed.append(engine._pack_levels(level_out))
        return torch.cat(packed, dim=0)

    def _boost_validated(self, grow_round, advance, f_cur, val_err, dev):
        """Spark's runWithValidation: each round grown and fetched, F
        advanced by the host-materialized tree, the held-out loss
        ``val_err(F)`` read on the host; stop when the best-so-far loss
        improves by less than ``validation_tol`` (relative to max(err,
        0.01)); keep the best prefix."""
        trees = []
        best_err, best_m = np.inf, 0
        for t in range(self.max_iter):
            grown = grow_round(t, f_cur, defer=False)
            trees.append(grown)
            cm = grown.split_catmask if grown.split_catmask is not None else None
            f_cur = advance(f_cur, torch.as_tensor(grown.split_feat, device=dev),
                            torch.as_tensor(grown.threshold, device=dev),
                            torch.as_tensor(grown.value, device=dev), cm)
            err = float(val_err(f_cur))
            if best_err - err < self.validation_tol * max(err, 0.01):
                break
            if err < best_err:
                best_err, best_m = err, t + 1
        return trees[:best_m] if best_m > 0 else trees

    def _boost_outofcore(self, hd: HostDataset, mesh, loss: str) -> GBTModel:
        """Rows ≫ device memory: the margin column F lives on the host,
        each round grows one out-of-core tree on the host pseudo-residuals
        over ``mesh`` and streams the blocks through it, shard by shard, to
        advance F.  The thresholds
        are computed once; ``validation_indicator_col`` needs a table and
        is refused."""
        if self.validation_indicator_col is not None:
            raise ValueError(
                "validation_indicator_col needs a table input to resolve "
                "the column; out-of-core HostDataset fits train on all rows"
            )
        if hd.y is None:
            raise ValueError("GBT fit needs labels: HostDataset(y=...)")
        if hd.n == 0 or hd.count() == 0.0:
            raise ValueError("GBT fit on an empty dataset")
        y = np.asarray(hd.y, np.float32)
        w = np.asarray(hd.w, np.float32) if hd.w is not None else np.ones((hd.n,), np.float32)
        n = max(float(w.sum()), 1.0)
        thr = quantile_thresholds(hd.sample_rows(self.init_sample_size, self.seed),
                                  self.max_bins)
        f0 = _prior_margin(float((y * w).sum() / n), loss)

        def residual(f):
            if loss == "squared":
                return y - f
            return 4.0 * (y - 1.0 / (1.0 + np.exp(-2.0 * f)))

        cat = self.categorical_features
        cat_flags = np.asarray([f in cat for f in range(hd.n_features)]) if cat else None
        cat_arities = (np.asarray([cat.get(f, 0) for f in range(hd.n_features)], np.int32)
                       if cat else None)
        f_cur = np.full((hd.n,), np.float32(f0), np.float32)
        trees: list = []

        # the round boundary is the checkpoint: the host margin and the
        # trees so far are the whole fit state
        ckpt = None
        start_t = 0
        if self.checkpoint_dir:
            from ...io.fit_checkpoint import FitCheckpointer, data_fingerprint

            signature = {
                "estimator": "GBT", "storage": "outofcore", "loss": loss,
                "max_iter": self.max_iter, "max_depth": self.max_depth,
                "max_bins": self.max_bins, "step_size": self.step_size,
                "min_instances_per_node": self.min_instances_per_node,
                "min_info_gain": self.min_info_gain,
                "subsampling_rate": self.subsampling_rate,
                # lists, not tuples: the committed signature is compared
                # after a JSON round trip
                "seed": self.seed,
                "cat": [list(t) for t in sorted((cat or {}).items())],
                "data": data_fingerprint(hd.x, hd.w),
                "labels": data_fingerprint(y[:, None]),
                "n": hd.n,
            }
            ckpt = FitCheckpointer(self.checkpoint_dir, signature)
            resumed = ckpt.resume()
            if resumed is not None:
                step0, arrays, _ = resumed
                thr = arrays["thr"]
                f_cur = arrays["f_cur"].astype(np.float32)
                for i in range(step0 + 1):
                    sl = slice(i, i + 1)
                    trees.append(engine.GrownForest(
                        split_feat=arrays["split_feat"][sl],
                        split_bin=np.zeros_like(arrays["split_feat"][sl]),
                        threshold=arrays["threshold"][sl],
                        value=arrays["value"][sl],
                        importances=arrays["importances"][sl],
                        max_depth=self.max_depth,
                        bin_thresholds=thr,
                        split_catmask=arrays["split_catmask"][sl] if cat else None,
                        cat_arities=cat_arities,
                    ))
                start_t = step0 + 1

        _, b = hd.block_shape(mesh)
        for t in range(start_t, self.max_iter):
            grown = engine.grow_forest_outofcore(
                HostDataset(hd.x, residual(f_cur).astype(np.float32), hd.w,
                            max_device_rows=hd.max_device_rows),
                task="regression",
                num_trees=1,
                max_depth=self.max_depth,
                max_bins=self.max_bins,
                min_instances_per_node=self.min_instances_per_node,
                min_info_gain=self.min_info_gain,
                bootstrap=self.subsampling_rate < 1.0,
                subsampling_rate=self.subsampling_rate,
                seed=self.seed + t,
                mesh=mesh,
                categorical_features=cat,
                bin_thresholds=thr,
            )
            trees.append(grown)
            # advance the host margin: stream the blocks through the new tree
            heap = {}

            def predict(i, sh):
                dv = sh.x.device
                if dv not in heap:
                    heap[dv] = tuple(torch.as_tensor(a, device=dv) for a in
                                     (grown.split_feat, grown.threshold, grown.value))
                return engine.predict_forest(sh.x, *heap[dv], grown.split_catmask,
                                             cat_flags)[0, :, 0]

            for i, blk in enumerate(hd.blocks(mesh)):
                pred = shard_rows(blk, predict)
                s = i * b
                e = min(s + b, hd.n)
                f_cur[s:e] += self.step_size * pred[: e - s]
            if ckpt is not None and (t + 1) % max(self.checkpoint_every, 1) == 0:
                arrays = {
                    "thr": thr,
                    "f_cur": f_cur,
                    "split_feat": np.concatenate([g.split_feat for g in trees]),
                    "threshold": np.concatenate([g.threshold for g in trees]),
                    "value": np.concatenate([g.value for g in trees]),
                    "importances": np.concatenate([g.importances for g in trees]),
                }
                if cat:
                    arrays["split_catmask"] = np.concatenate([g.split_catmask for g in trees])
                ckpt.save(t, arrays)
        return _ensemble(trees, loss, f0, self.step_size, self.max_depth, cat)


@dataclass(frozen=True)
class GBTRegressor(Estimator, _GBTParams):
    mesh_fit = True

    def fit(self, data, label_col: str | None = None, device=None, mesh=None) -> GBTModel:
        """Fit on ``data`` (DeviceDataset, ShardedDataset, AssembledTable,
        (x, y[, w])) on ``device`` (default the card) or over ``mesh``; a
        :class:`HostDataset` boosts out of core, streaming its blocks
        there."""
        if isinstance(data, HostDataset):
            return self._boost_outofcore(data, stream_mesh(mesh, device), loss="squared")
        return self._fit(data, label_col, device, mesh, "squared")


def _check_binary(y: np.ndarray) -> None:
    uniq = np.unique(y)
    if not np.all(np.isin(uniq, [0.0, 1.0])):
        raise ValueError(f"GBTClassifier is binary (labels 0/1); got labels {uniq[:5]}")


def _check_binary_labels(ds) -> None:
    """The valid rows' labels are 0/1: a count of the other labels summed
    in shard order (every rank decides alike), then the local shards'
    labels for the message."""
    sh = Shards(ds)
    bad = sh.sum(lambda i, s: ((((s.y != 0) & (s.y != 1)) & (s.w > 0)).sum().to(torch.float64),))
    if float(bad[0]) > 0:
        uniq = np.unique(np.concatenate([s.y[s.w > 0].cpu().numpy() for s in sh.data.values()]))
        raise ValueError(f"GBTClassifier is binary (labels 0/1); got labels {uniq[:5]}")


@dataclass(frozen=True)
class GBTClassifier(Estimator, _GBTParams):
    label_col: str = "LOS_binary"
    mesh_fit = True

    def fit(self, data, label_col: str | None = None, device=None, mesh=None) -> GBTModel:
        """As :meth:`GBTRegressor.fit`, on labels 0/1."""
        if isinstance(data, HostDataset):
            if data.y is None:
                raise ValueError("GBT fit needs labels: HostDataset(y=...)")
            yv = np.asarray(data.y)
            _check_binary(yv[np.asarray(data.w) > 0] if data.w is not None else yv)
            return self._boost_outofcore(data, stream_mesh(mesh, device), loss="logistic")
        return self._fit(data, label_col, device, mesh, "logistic")


__all__ = ["GBTClassifier", "GBTModel", "GBTRegressor"]
