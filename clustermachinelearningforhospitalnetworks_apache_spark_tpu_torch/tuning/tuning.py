"""Model selection (the JAX package's ``tuning/tuning.py``,
``pyspark.ml.tuning``).

``ParamGridBuilder`` / ``CrossValidator`` / ``TrainValidationSplit``: the
search is a sequential loop of fits on the device or over a mesh (every
fit already spans it), fold membership decided once on the host by the
same seeded permutation as the reference's (``np.random.default_rng(seed)``),
and each fold's train and validation rows cut on the host; each fit moves
its rows to ``device``, or lays them over ``mesh``, itself.  ``fit`` and
``transform`` take the reference's order ``(data, label_col, mesh)``, with
``device=`` a keyword.

Estimators are frozen or plain dataclasses, so a param map is a plain
dict applied with ``dataclasses.replace``:

- bare keys (``"reg_param"``) set fields of the estimator itself; for a
  ``Pipeline`` they set the **last stage that has the field** (the
  estimator's slot, by convention),
- dotted keys (``"1.reg_param"``) set an explicit Pipeline stage.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import json
import os
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import numpy as np

from ..features.assembler import AssembledTable
from ..io.model_io import (
    METADATA_FILE,
    load_model,
    finalize_artifact_dir,
    prepare_artifact_dir,
    register_composite,
    validate_persistable,
    write_metadata,
)
from ..pipeline.ml_pipeline import Pipeline, _call_stage
from ..version import __version__


class ParamGridBuilder:
    """``ParamGridBuilder().add_grid("reg_param", [0.0, 0.1]).build()`` →
    cartesian-product list of param dicts (Spark's ``addGrid``/``build``)."""

    def __init__(self) -> None:
        self._grid: dict[str, Sequence[Any]] = {}

    def add_grid(self, param: str, values: Sequence[Any]) -> "ParamGridBuilder":
        if not values:
            raise ValueError(f"empty value list for param {param!r}")
        self._grid[param] = list(values)
        return self

    def base_on(self, params: Mapping[str, Any]) -> "ParamGridBuilder":
        """Fixed (non-swept) params merged into every map (Spark ``baseOn``)."""
        for k, v in params.items():
            self._grid[k] = [v]
        return self

    def build(self) -> list[dict[str, Any]]:
        keys = list(self._grid)
        return [
            dict(zip(keys, combo))
            for combo in itertools.product(*(self._grid[k] for k in keys))
        ]


def _replace_field(obj: Any, name: str, value: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        if name not in {f.name for f in dataclasses.fields(obj)}:
            raise ValueError(
                f"{type(obj).__name__} has no param {name!r}; fields: "
                f"{sorted(f.name for f in dataclasses.fields(obj))}"
            )
        return dataclasses.replace(obj, **{name: value})
    if not hasattr(obj, name):
        raise ValueError(f"{type(obj).__name__} has no param {name!r}")
    clone = copy.copy(obj)
    setattr(clone, name, value)
    return clone


def apply_params(estimator: Any, params: Mapping[str, Any]) -> Any:
    """A copy of ``estimator`` with the param map applied (see module doc
    for bare-vs-dotted key semantics on Pipelines)."""
    if not params:
        return estimator
    if isinstance(estimator, Pipeline):
        stages = list(estimator.stages)
        for key, value in params.items():
            if "." in key:
                idx_s, name = key.split(".", 1)
                idx = int(idx_s)
                if not 0 <= idx < len(stages):
                    raise ValueError(
                        f"param {key!r}: stage index {idx} out of range "
                        f"({len(stages)} stages)"
                    )
                stages[idx] = _replace_field(stages[idx], name, value)
            else:
                for idx in range(len(stages) - 1, -1, -1):
                    target = stages[idx]
                    names = (
                        {f.name for f in dataclasses.fields(target)}
                        if dataclasses.is_dataclass(target)
                        else set(vars(target))
                    )
                    if key in names:
                        stages[idx] = _replace_field(target, key, value)
                        break
                else:
                    raise ValueError(
                        f"no pipeline stage has param {key!r}; use a dotted "
                        "'<stage>.<param>' key to target one explicitly"
                    )
        return Pipeline(tuple(stages))
    out = estimator
    for key, value in params.items():
        out = _replace_field(out, key, value)
    return out


def _num_rows(data: Any) -> int:
    if isinstance(data, AssembledTable):
        return len(data)
    if isinstance(data, tuple) and len(data) in (2, 3):
        return int(np.asarray(data[0]).shape[0])
    if hasattr(data, "num_rows"):
        return int(data.num_rows)
    return int(np.asarray(data).shape[0])


def _row_subset(data: Any, keep: np.ndarray) -> Any:
    """Host-side row filter for the supported fit inputs (Table,
    AssembledTable, (x, y[, w]), bare array); each fold's rows reach the
    device through the estimator's own ``fit``."""
    if isinstance(data, AssembledTable):
        return dataclasses.replace(
            data, table=data.table.mask(keep), features=data.features[keep]
        )
    if isinstance(data, tuple) and len(data) in (2, 3):
        return tuple(np.asarray(a)[keep] for a in data)
    if hasattr(data, "mask"):
        return data.mask(keep)
    return np.asarray(data)[keep]


def _val_features(val) -> np.ndarray:
    if isinstance(val, AssembledTable):
        return np.asarray(val.features, dtype=np.float32)
    if isinstance(val, tuple):
        return np.asarray(val[0], dtype=np.float32)
    return np.asarray(val, dtype=np.float32)


def _score(model, val, evaluator, label_col, mesh, device=None) -> float:
    from ..evaluation.clustering import ClusteringEvaluator

    if isinstance(evaluator, ClusteringEvaluator):
        # a clustering model is scored on (features, assignments): the
        # silhouette needs the features, not a PredictionResult.  Over a
        # mesh the assignments are taken a shard at a time (K2 once a data
        # shard for KMeans) and the silhouette runs over the same mesh
        from ..models.base import as_device_dataset, is_sharded
        from ..parallel.sharding import unpad

        x = _val_features(val)
        ds = as_device_dataset(x, device=device, mesh=mesh)
        pred = ds.x.map_data(model.predict) if is_sharded(ds) else model.predict(ds.x)
        assign = np.asarray(unpad(pred, x.shape[0]))
        k = getattr(model, "k", None) or getattr(
            model, "cluster_centers", np.zeros((0,))
        ).shape[0] or None
        where = {"mesh": mesh} if mesh is not None else {"device": device}
        return float(evaluator.evaluate(x, assign, k=k, **where))
    pred = _call_stage(model.transform, val, label_col, mesh, device)
    return float(evaluator.evaluate(pred))


def _fit_and_score(estimator, params, train, val, evaluator, label_col, mesh, device):
    est = apply_params(estimator, params)
    model = _call_stage(est.fit, train, label_col, mesh, device)
    return model, _score(model, val, evaluator, label_col, mesh, device)


def _best_index(avg: np.ndarray, larger_better: bool) -> int:
    """NaN-safe winner selection: np.argmax/argmin treat NaN as the
    extremum, so one NaN-scoring (fold, param) cell — a degenerate
    silhouette, an r2 on a pathological fold — would silently win."""
    if np.all(np.isnan(avg)):
        raise ValueError(
            "every parameter map scored NaN; the metric is undefined on "
            "this data/estimator combination"
        )
    return int(np.nanargmax(avg) if larger_better else np.nanargmin(avg))


@dataclass(frozen=True)
class CrossValidator:
    """K-fold model selection (Spark ``CrossValidator``): every param map is
    fit on each fold's train split and scored on its validation split; the
    best average wins and is refit on the full data."""

    estimator: Any
    param_maps: Sequence[Mapping[str, Any]]
    evaluator: Any
    num_folds: int = 3
    seed: int = 0
    collect_sub_models: bool = False

    def fit(self, data: Any, label_col: str | None = None, mesh=None, *,
            device=None) -> "CrossValidatorModel":
        """Every (param map, fold) fit and scored over ``mesh`` (or on
        ``device``, default the card), the best refit on all the rows."""
        if self.num_folds < 2:
            raise ValueError(f"num_folds must be ≥2, got {self.num_folds}")
        if not self.param_maps:
            raise ValueError("param_maps is empty; build one with ParamGridBuilder")
        n = _num_rows(data)
        fold_of = np.random.default_rng(self.seed).permutation(n) % self.num_folds
        metrics = np.zeros((len(self.param_maps), self.num_folds))
        sub_models: list[list[Any]] = [[] for _ in self.param_maps]
        for fold in range(self.num_folds):
            val_mask = fold_of == fold
            train = _row_subset(data, ~val_mask)
            val = _row_subset(data, val_mask)
            for pi, params in enumerate(self.param_maps):
                model, score = _fit_and_score(
                    self.estimator, params, train, val, self.evaluator,
                    label_col, mesh, device,
                )
                metrics[pi, fold] = score
                if self.collect_sub_models:
                    sub_models[pi].append(model)
        avg = metrics.mean(axis=1)
        larger = getattr(self.evaluator, "is_larger_better", True)
        best = _best_index(avg, larger)
        best_est = apply_params(self.estimator, self.param_maps[best])
        best_model = _call_stage(best_est.fit, data, label_col, mesh, device)
        return CrossValidatorModel(
            best_model=best_model,
            avg_metrics=avg,
            best_index=best,
            param_maps=tuple(dict(p) for p in self.param_maps),
            fold_metrics=metrics,
            sub_models=tuple(map(tuple, sub_models)) if self.collect_sub_models else None,
        )


@dataclass(frozen=True)
class TrainValidationSplit:
    """Single-split model selection (Spark ``TrainValidationSplit``)."""

    estimator: Any
    param_maps: Sequence[Mapping[str, Any]]
    evaluator: Any
    train_ratio: float = 0.75
    seed: int = 0

    def fit(self, data: Any, label_col: str | None = None, mesh=None, *,
            device=None) -> "TrainValidationSplitModel":
        """Every param map fit on the train split and scored on the rest
        over ``mesh`` (or on ``device``, default the card), the best refit
        on all the rows."""
        if not 0.0 < self.train_ratio < 1.0:
            raise ValueError(f"train_ratio must be in (0, 1), got {self.train_ratio}")
        if not self.param_maps:
            raise ValueError("param_maps is empty; build one with ParamGridBuilder")
        n = _num_rows(data)
        perm = np.random.default_rng(self.seed).permutation(n)
        n_train = int(round(n * self.train_ratio))
        train_mask = np.zeros(n, dtype=bool)
        train_mask[perm[:n_train]] = True
        train = _row_subset(data, train_mask)
        val = _row_subset(data, ~train_mask)
        metrics = np.zeros(len(self.param_maps))
        for pi, params in enumerate(self.param_maps):
            _, metrics[pi] = _fit_and_score(
                self.estimator, params, train, val, self.evaluator, label_col, mesh, device
            )
        larger = getattr(self.evaluator, "is_larger_better", True)
        best = _best_index(metrics, larger)
        best_est = apply_params(self.estimator, self.param_maps[best])
        best_model = _call_stage(best_est.fit, data, label_col, mesh, device)
        return TrainValidationSplitModel(
            best_model=best_model,
            validation_metrics=metrics,
            best_index=best,
            param_maps=tuple(dict(p) for p in self.param_maps),
        )


class _SelectedModel:
    """Shared transform/persistence shell around ``best_model``."""

    _ARTIFACT: str = ""

    def transform(self, data: Any, label_col: str | None = None, mesh=None, *, device=None):
        return _call_stage(self.best_model.transform, data, label_col, mesh, device)

    def _validate_persistable(self, prefix: str = "") -> None:
        validate_persistable(self.best_model, label=f"{prefix}bestModel")
        for pi, fold_models in enumerate(self._extra_models() or ()):
            for fi, m in enumerate(fold_models):
                validate_persistable(m, label=f"{prefix}subModel {pi}/{fi}")

    def _extra_models(self):
        return getattr(self, "sub_models", None)

    def save(self, path: str, overwrite: bool = True) -> None:
        # pre-validate so a failed save never destroys an existing artifact
        self._validate_persistable()
        prepare_artifact_dir(path, overwrite)
        self.best_model.save(os.path.join(path, "bestModel"))
        subs = self._extra_models()
        if subs:
            for pi, fold_models in enumerate(subs):
                for fi, m in enumerate(fold_models):
                    m.save(os.path.join(path, "subModels", f"p{pi}", f"f{fi}"))
        write_metadata(path, {
            "model_class": self._ARTIFACT,
            "framework_version": __version__,
            **self._selection_meta(),
        })
        finalize_artifact_dir(path)  # commit: drop sentinel, discard .old

    def write(self):
        from ..models.base import _Writer

        return _Writer(self)

    def _selection_meta(self) -> dict:
        raise NotImplementedError

    @classmethod
    def load(cls, path: str, _meta: dict | None = None):
        if _meta is None:
            with open(os.path.join(path, METADATA_FILE)) as f:
                _meta = json.load(f)
        best = load_model(os.path.join(path, "bestModel"))
        return cls._from_meta(best, _meta, path)

    @classmethod
    def _from_meta(cls, best, meta, path):
        raise NotImplementedError

    @staticmethod
    def _load_sub_models(meta: dict, path: str):
        shape = meta.get("sub_models_shape")
        if not shape:
            return None
        return tuple(
            tuple(
                load_model(os.path.join(path, "subModels", f"p{pi}", f"f{fi}"))
                for fi in range(shape[1])
            )
            for pi in range(shape[0])
        )


@dataclass(frozen=True)
class CrossValidatorModel(_SelectedModel):
    best_model: Any
    avg_metrics: np.ndarray
    best_index: int
    param_maps: tuple[dict, ...]
    fold_metrics: np.ndarray | None = None
    sub_models: tuple | None = None

    _ARTIFACT = "CrossValidatorModel"

    def _selection_meta(self) -> dict:
        return {
            "avg_metrics": np.asarray(self.avg_metrics).tolist(),
            "best_index": int(self.best_index),
            "param_maps": [dict(p) for p in self.param_maps],
            "fold_metrics": (
                np.asarray(self.fold_metrics).tolist()
                if self.fold_metrics is not None
                else None
            ),
            "sub_models_shape": (
                [len(self.sub_models), len(self.sub_models[0])]
                if self.sub_models
                else None
            ),
        }

    @classmethod
    def _from_meta(cls, best, meta, path):
        return cls(
            best_model=best,
            avg_metrics=np.asarray(meta["avg_metrics"]),
            best_index=int(meta["best_index"]),
            param_maps=tuple(meta["param_maps"]),
            fold_metrics=(
                np.asarray(meta["fold_metrics"])
                if meta.get("fold_metrics") is not None
                else None
            ),
            sub_models=cls._load_sub_models(meta, path),
        )


@dataclass(frozen=True)
class TrainValidationSplitModel(_SelectedModel):
    best_model: Any
    validation_metrics: np.ndarray
    best_index: int
    param_maps: tuple[dict, ...]

    _ARTIFACT = "TrainValidationSplitModel"

    def _selection_meta(self) -> dict:
        return {
            "validation_metrics": np.asarray(self.validation_metrics).tolist(),
            "best_index": int(self.best_index),
            "param_maps": [dict(p) for p in self.param_maps],
        }

    @classmethod
    def _from_meta(cls, best, meta, path):
        return cls(
            best_model=best,
            validation_metrics=np.asarray(meta["validation_metrics"]),
            best_index=int(meta["best_index"]),
            param_maps=tuple(meta["param_maps"]),
        )


register_composite(
    "CrossValidatorModel",
    "clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.tuning.tuning:"
    "CrossValidatorModel",
)
register_composite(
    "TrainValidationSplitModel",
    "clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.tuning.tuning:"
    "TrainValidationSplitModel",
)
