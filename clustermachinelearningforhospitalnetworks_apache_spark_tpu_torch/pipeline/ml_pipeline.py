"""Pipeline / PipelineModel — composable stage chains.

The JAX package's ``pipeline/ml_pipeline.py`` (``pyspark.ml.Pipeline``):
a *stage* is anything with ``fit`` (an estimator, replaced by its fitted
model in the ``PipelineModel``) or else ``transform`` (a transformer,
carried as it is).  Data flows through whatever each stage produces —
``Table`` → ``AssembledTable`` → ``DeviceDataset`` — and a stage that
takes ``mesh=`` (or ``label_col=``) is handed the pipeline's, in the
reference's positional order ``fit(data, label_col, mesh)``; ``device=``
is a keyword, handed to the stages that take it (:func:`_call_stage`).

Persistence is the JAX package's layout: one directory per stage
(``stages/<i>_<ClassName>``) and a pipeline-level ``metadata.json``;
each stage saves and loads through the same registry as a standalone
model (``io/model_io.py``), nested composites through their own layout,
so a PipelineModel saved by either package loads in the other.
"""

from __future__ import annotations

import inspect
import json
import os
from dataclasses import dataclass
from typing import Any, Sequence

from ..io.model_io import (
    METADATA_FILE,
    PIPELINE_CLASS as _PIPELINE_CLASS,
    finalize_artifact_dir,
    is_composite,
    load_model,
    prepare_artifact_dir,
    save_model,
    validate_persistable,
    write_metadata,
)
from ..version import __version__


def _accepts(fn, name: str) -> bool:
    try:
        return name in inspect.signature(fn).parameters
    except (TypeError, ValueError):  # builtins / C callables
        return False


def _call_stage(fn, data, label_col, mesh, device=None):
    """``fn(data)`` with the pipeline's ``label_col`` and ``mesh`` (or
    ``device``) where it takes them.  A stage that takes ``mesh`` gets it
    (an estimator whose fit does not run over shards yet raises there); a
    stage that takes only ``device`` runs on one device, the mesh's first
    for a one-entry mesh, and raises over a larger one rather than fit the
    rows of every shard on one device."""
    from ..models.base import require_single_shard

    kwargs = {}
    if label_col is not None and _accepts(fn, "label_col"):
        kwargs["label_col"] = label_col
    if mesh is not None:
        if device is not None:
            raise ValueError("pass a mesh or a device, not both")
        if _accepts(fn, "mesh"):
            kwargs["mesh"] = mesh
        elif _accepts(fn, "device"):
            require_single_shard(None, mesh, getattr(fn, "__qualname__", repr(fn)))
            kwargs["device"] = mesh.device(0, 0)
    elif device is not None and _accepts(fn, "device"):
        kwargs["device"] = device
    return fn(data, **kwargs)


@dataclass(frozen=True)
class Pipeline:
    """Ordered stages; ``fit`` threads the data through them, fitting each
    estimator stage on the output of every stage before it."""

    stages: Sequence[Any]

    def fit(self, data: Any, label_col: str | None = None, mesh=None, *,
            device=None) -> "PipelineModel":
        """Fit every estimator stage over ``mesh`` (or on ``device``,
        default the card) on the output of the stages before it."""
        fitted: list[Any] = []
        cur = data
        last = len(self.stages) - 1
        for i, stage in enumerate(self.stages):
            if hasattr(stage, "fit"):
                model = _call_stage(stage.fit, cur, label_col, mesh, device)
            elif hasattr(stage, "transform"):
                model = stage
            else:
                raise TypeError(
                    f"pipeline stage {i} ({type(stage).__name__}) has neither fit nor transform")
            fitted.append(model)
            if i < last:
                cur = _call_stage(model.transform, cur, label_col, mesh, device)
        return PipelineModel(tuple(fitted))


@dataclass(frozen=True)
class PipelineModel:
    """The fitted chain: every stage is now a transformer."""

    stages: tuple[Any, ...]

    def transform(self, data: Any, label_col: str | None = None, mesh=None, *, device=None):
        """Every stage's ``transform`` in turn, over ``mesh`` (or on
        ``device``)."""
        cur = data
        for stage in self.stages:
            cur = _call_stage(stage.transform, cur, label_col, mesh, device)
        return cur

    def _validate_persistable(self, prefix: str = "") -> None:
        """The recursive pre-save check (nested composites too), so a failed
        save never destroys a previous artifact; ``prefix`` carries the
        nesting path into the error."""
        for i, stage in enumerate(self.stages):
            validate_persistable(stage, label=f"{prefix}stage {i}")

    # persistence -------------------------------------------------------
    def save(self, path: str, overwrite: bool = True) -> None:
        # the whole stage tree is validated before the target is touched
        self._validate_persistable()
        prepare_artifact_dir(path, overwrite)
        os.makedirs(os.path.join(path, "stages"))
        dirs = []
        for i, stage in enumerate(self.stages):
            if is_composite(stage):
                # a nested composite writes its own layout; load_model
                # dispatches on its model_class
                d = f"{i}_{type(stage).__name__}"
                stage.save(os.path.join(path, "stages", d))
            else:
                name, meta, arrays = stage._artifacts()
                d = f"{i}_{name}"
                save_model(os.path.join(path, "stages", d), name, meta, arrays)
            dirs.append(d)
        write_metadata(path, {"model_class": _PIPELINE_CLASS,
                              "framework_version": __version__, "stage_dirs": dirs})
        finalize_artifact_dir(path)  # commit: drop the sentinel, discard .old

    def write(self):
        from ..models.base import _Writer

        return _Writer(self)

    @classmethod
    def load(cls, path: str, _meta: dict | None = None) -> "PipelineModel":
        if _meta is None:
            with open(os.path.join(path, METADATA_FILE)) as f:
                _meta = json.load(f)
        if _meta.get("model_class") != _PIPELINE_CLASS:
            raise ValueError(
                f"{path} holds a {_meta.get('model_class')!r}, not a PipelineModel; "
                "use load_model for single-model artifacts")
        return cls(tuple(load_model(os.path.join(path, "stages", d))
                         for d in _meta["stage_dirs"]))


def load_pipeline_model(path: str) -> PipelineModel:
    return PipelineModel.load(path)


__all__ = ["Pipeline", "PipelineModel", "load_pipeline_model"]
