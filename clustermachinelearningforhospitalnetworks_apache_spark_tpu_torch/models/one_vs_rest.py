"""OneVsRest — a multiclass reduction over any binary classifier.

The JAX package's ``models/one_vs_rest.py`` (``pyspark.ml.classification.
OneVsRest``): one binary model per class (label == c → 1), prediction by
the highest per-class confidence.  The one-vs-all labels are made on the
device the rows lie on, a data shard at a time over a mesh, and the k
fits run one after another over the same shards (a tree classifier
inside launches K3 at every level of each, once a data shard); scoring
stacks the k confidences and takes the argmax on the device.

The confidence is the model's ``predict_proba`` (the class-1 column) or,
failing that, its ``predict_raw`` margin.  The model persists as a
composite artifact, one sub-directory per class model, in the JAX
package's layout.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..io.model_io import (
    METADATA_FILE,
    finalize_artifact_dir,
    load_model,
    prepare_artifact_dir,
    register_composite,
    save_model,
    validate_persistable,
    write_metadata,
)
from ..parallel.collectives import gather_shards
from ..parallel.outofcore import HostDataset
from ..version import __version__
from .base import Estimator, Model, Shards, is_sharded, on_mesh

_OVR_CLASS = "OneVsRestModel"


def _confidence(model: Any, x: torch.Tensor) -> torch.Tensor:
    """(n,) class-1 confidence from whichever surface the model has."""
    if hasattr(model, "predict_proba"):
        p = model.predict_proba(x)
        return p[:, 1] if p.ndim == 2 else p
    if hasattr(model, "predict_raw"):
        r = model.predict_raw(x)
        return r[:, 1] if r.ndim == 2 else r
    raise TypeError(
        f"{type(model).__name__} exposes neither predict_proba nor "
        "predict_raw; OneVsRest needs a per-class confidence")


@dataclass
class OneVsRestModel(Model):
    models: tuple[Any, ...]          # one binary model per class, in order

    @property
    def num_classes(self) -> int:
        return len(self.models)

    def predict_raw(self, x: torch.Tensor) -> torch.Tensor:
        """(n, k) per-class confidences, with no host read between classes."""
        return torch.stack([_confidence(m, x) for m in self.models], dim=1)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.predict_raw(x), dim=1).to(torch.float32)

    # persistence: a composite, one sub-artifact per class --------------
    def save(self, path: str, overwrite: bool = True) -> None:
        for i, m in enumerate(self.models):
            validate_persistable(m, label=f"class {i} model")
        prepare_artifact_dir(path, overwrite)
        os.makedirs(os.path.join(path, "models"))
        dirs = []
        for i, m in enumerate(self.models):
            name, meta, arrays = m._artifacts()
            d = f"{i}_{name}"
            save_model(os.path.join(path, "models", d), name, meta, arrays)
            dirs.append(d)
        write_metadata(path, {"model_class": _OVR_CLASS, "framework_version": __version__,
                              "model_dirs": dirs})
        finalize_artifact_dir(path)  # commit: drop the sentinel, discard .old

    @classmethod
    def load(cls, path: str, _meta: dict | None = None) -> "OneVsRestModel":
        if _meta is None:
            with open(os.path.join(path, METADATA_FILE)) as f:
                _meta = json.load(f)
        return cls(tuple(load_model(os.path.join(path, "models", d))
                         for d in _meta["model_dirs"]))


def _refuse_inner_weight_col(classifier, what: str) -> None:
    if getattr(classifier, "weight_col", None) is not None:
        raise ValueError(
            "set weight_col on OneVsRest itself, not the inner classifier "
            f"(the one-vs-all {what} already carries the weights)")


@dataclass(frozen=True)
class OneVsRest(Estimator):
    classifier: Any = None            # a binary classifier estimator
    label_col: str = "LOS_binary"
    features_col: str = "features"
    weight_col: str | None = None

    def fit(self, data, label_col: str | None = None, device=None,
            mesh=None) -> OneVsRestModel:
        """k one-vs-all fits of ``classifier`` on ``device`` (default the
        card) or over ``mesh``: the 0/1 labels are made a shard at a time
        and each fit runs over the same shards.  A :class:`HostDataset`
        goes through the inner estimator's own out-of-core path, to
        ``device`` or over ``mesh``, with host 0/1 labels."""
        if self.classifier is None:
            raise ValueError("OneVsRest needs a classifier estimator")
        if isinstance(data, HostDataset):
            if data.y is None:
                raise ValueError("OneVsRest needs labels: HostDataset(y=...)")
            _refuse_inner_weight_col(self.classifier, "HostDataset")
            y_host = np.asarray(data.y)
            w_host = np.asarray(data.w) if data.w is not None else np.ones(data.n, np.float32)
            if not np.any(w_host > 0):
                raise ValueError("OneVsRest fit on an empty dataset")
            k = int(y_host[w_host > 0].max()) + 1
            if k < 2:
                raise ValueError("OneVsRest needs at least 2 classes")
            where = {"mesh": mesh} if mesh is not None else {"device": device}
            return OneVsRestModel(tuple(
                self.classifier.fit(HostDataset(x=data.x, y=(y_host == float(c)).astype(np.float32),
                                                w=data.w, max_device_rows=data.max_device_rows),
                                    **where)
                for c in range(k)))
        ds = on_mesh(data, label_col or self.label_col, device, self.weight_col, mesh)
        sh = Shards(ds)

        # one host read: whether any row is valid, and the class count
        def head(i, s):
            valid = s.w > 0
            return torch.stack([valid.any().to(s.y.dtype),
                                torch.where(valid, s.y, torch.zeros_like(s.y)).max()])

        parts: list = [None] * sh.D
        for i, s in sh.data.items():
            parts[i] = head(i, s)
        some, top = torch.stack(gather_shards(parts, sh.mesh)).max(dim=0).values.tolist()
        if not some:
            raise ValueError("OneVsRest fit on an empty dataset")
        k = int(top) + 1
        if k < 2:
            raise ValueError("OneVsRest needs at least 2 classes")
        _refuse_inner_weight_col(self.classifier, "DeviceDataset")
        # one-vs-all labels on each shard's device; the inner estimator's
        # label_col is not read for a dataset
        models = []
        for c in range(k):
            sub = sh.with_rows(y={i: (s.y == float(c)).to(torch.float32)
                                  for i, s in sh.data.items()})
            if is_sharded(ds):
                models.append(self.classifier.fit(sub.dataset(), mesh=ds.mesh))
            else:
                models.append(self.classifier.fit(sub.data[0]))
        return OneVsRestModel(tuple(models))


register_composite(
    _OVR_CLASS,
    "clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models.one_vs_rest:"
    "OneVsRestModel",
)

__all__ = ["OneVsRest", "OneVsRestModel"]
