"""Estimator / Model protocol (the JAX package's ``models/base.py``).

Estimators consume a padded :class:`~..data.DeviceDataset` (or anything
coercible to one) and models predict on the device the input lies on;
``Model.transform`` returns a :class:`PredictionResult` whose tensors stay
on the device until an evaluator reduces them.  Over a mesh of more than
one shard the data is a :class:`~..parallel.sharding.ShardedDataset`: a fit
computes its statistics once a local data shard on the shard's device
(:class:`Shards`; one device is one shard), sums them in ascending
data-shard order (``collectives.aggregate_shards``) and solves once on the
home device, and
``transform`` predicts shard by shard into :class:`~..parallel.sharding.
MeshArray` columns.  ``Model.save`` and the
Spark-style ``model.write().overwrite().save(path)`` write the JAX
package's artifact layout (``io/model_io.py``).
"""

from __future__ import annotations

import functools
import inspect
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..data import DeviceDataset, device_dataset, unpad
from ..device import resolve_device
from ..features.assembler import AssembledTable


#: the slice of the port that brings ``mesh=`` to the estimators that still
#: fit on one device (PCA, the selectors, LSH, ``stat/``, LDA, PIC)
MESH_SLICE = "8c-4"


def _sharded(data: Any) -> bool:
    from ..parallel.federation import FederatedDataset
    from ..parallel.sharding import ShardedDataset

    if isinstance(data, FederatedDataset):
        data = data.data
    return isinstance(data, ShardedDataset)


def require_single_shard(data: Any, mesh, what: str) -> None:
    """Raise ``NotImplementedError`` naming slice 8c-4 when ``mesh`` has more
    than one entry (or a process group is active) or ``data`` is sharded:
    ``what`` runs on one device until its mesh slice lands, and never
    gathers the shards silently."""
    from ..parallel.sharding import uses_shards

    if (mesh is not None and uses_shards(mesh)) or _sharded(data):
        raise NotImplementedError(
            f"{what} over a mesh of more than one shard comes with slice {MESH_SLICE} of "
            "the port; run it on one device (device=) or a one-entry mesh"
        )


def _mesh_guarded(fit):
    """``fit`` taking ``mesh=`` (the reference's keyword): a mesh of more
    than one shard, or sharded data, raises (:func:`require_single_shard`);
    a one-entry mesh runs the fit on its device."""
    sig = inspect.signature(fit)
    params = list(sig.parameters)
    takes_mesh = "mesh" in params
    device_at = params.index("device") if "device" in params else None

    @functools.wraps(fit)
    def guarded(self, *args, mesh=None, **kw):
        data = args[0] if args else kw.get(params[1])
        require_single_shard(data, mesh, f"{type(self).__name__}.fit")
        if mesh is not None:
            if takes_mesh:
                kw["mesh"] = mesh
            if device_at is not None and len(args) < device_at and kw.get("device") is None:
                kw["device"] = mesh.device(0, 0)
        return fit(self, *args, **kw)

    # the signature callers read (a Pipeline's ``_call_stage``) names
    # ``mesh``, so a mesh reaches the guard and is never dropped
    if not takes_mesh:
        guarded.__signature__ = sig.replace(parameters=[
            *sig.parameters.values(),
            inspect.Parameter("mesh", inspect.Parameter.KEYWORD_ONLY, default=None)])
    return guarded


def as_device_dataset(data: Any, label_col: str | None = None, device=None,
                      weight_col: str | None = None, mesh=None, sharded: bool = False):
    """Coerce (DeviceDataset | AssembledTable | (X, y[, w]) | X) to a
    padded dataset on ``device`` (default the card), or over ``mesh``.  A
    DeviceDataset is returned as it is, on its own device; a
    FederatedDataset gives its data; an AssembledTable takes its labels
    (``label_col``) and weights (``weight_col``) from its source table.

    ``mesh=None`` keeps ``device=``; a mesh of one entry (and no process
    group) gives the single-device dataset on its device.  A caller that
    runs over shards passes ``sharded=True`` and gets a ShardedDataset for
    a larger mesh; any other caller raises (:func:`require_single_shard`)."""
    from ..parallel.federation import FederatedDataset
    from ..parallel.sharding import ShardedDataset, shard_dataset, uses_shards

    if isinstance(data, FederatedDataset):
        data = data.data
    if not sharded:
        require_single_shard(data, mesh, "fitting or predicting")
    if isinstance(data, (DeviceDataset, ShardedDataset)):
        return data
    if mesh is not None:
        if device is not None:
            raise ValueError("pass a mesh or a device, not both")
        if uses_shards(mesh):
            # padded and weighted on the host, then split over the mesh
            return shard_dataset(as_device_dataset(data, label_col, "cpu", weight_col), mesh)
        device = mesh.device(0, 0)
    if isinstance(data, AssembledTable):
        return data.to_device(label_col=label_col, device=device, weight_col=weight_col)
    if weight_col is not None:
        raise ValueError(
            f"weight_col={weight_col!r} needs a table input to resolve the "
            f"column; got {type(data).__name__} — pass an AssembledTable, "
            "an (x, y, weights) tuple, or a pre-weighted DeviceDataset"
        )
    if isinstance(data, tuple) and len(data) == 3:
        return device_dataset(np.asarray(data[0]), np.asarray(data[1]),
                              device=device, weights=np.asarray(data[2]))
    if isinstance(data, tuple) and len(data) == 2:
        return device_dataset(np.asarray(data[0]), np.asarray(data[1]),
                              device=device)
    return device_dataset(np.asarray(data), None, device=device)


def stream_batch(data: Any, label_col: str | None = None, device=None, mesh=None,
                 min_rows_per_device: int | None = None):
    """A streaming micro-batch as a dataset on ``device`` (default the
    card), or over ``mesh`` (not both) with the reference's adaptive
    placement: a host batch is laid over the mesh only when every data
    shard gets at least ``min_rows_per_device`` rows
    (``parallel.sharding.microbatch_mesh``), else it runs on the mesh's
    first device.  A DeviceDataset or ShardedDataset runs where it lies."""
    from ..data import batch_rows
    from ..parallel.sharding import ShardedDataset, microbatch_mesh

    if mesh is not None:
        if device is not None:
            raise ValueError("pass a mesh or a device, not both")
        if not isinstance(data, (DeviceDataset, ShardedDataset)):
            mesh = microbatch_mesh(batch_rows(data), mesh, min_rows_per_device)
    return as_device_dataset(data, label_col, device=device, mesh=mesh, sharded=True)


def on_mesh(data: Any, label_col: str | None = None, device=None,
            weight_col: str | None = None, mesh=None):
    """``data`` as a DeviceDataset on ``device`` (default the card; a
    dataset stays where it lies), or over ``mesh`` (not both): a one-entry
    mesh with no process group is its device, a larger one (or a group)
    gives a ShardedDataset, a DeviceDataset given with it split into its
    shards.  A ShardedDataset fits on its own mesh, which ``mesh`` must
    equal."""
    from ..parallel.sharding import ShardedDataset, shard_dataset, uses_shards

    ds = as_device_dataset(data, label_col, device=device, weight_col=weight_col, mesh=mesh,
                           sharded=True)
    if isinstance(ds, ShardedDataset):
        if mesh is not None and mesh != ds.mesh:
            raise ValueError(f"the data lies on {ds.mesh}, not on the mesh given ({mesh})")
    elif mesh is not None and uses_shards(mesh):
        ds = shard_dataset(ds, mesh)
    return ds


def is_sharded(ds) -> bool:
    from ..parallel.sharding import ShardedDataset

    return isinstance(ds, ShardedDataset)


def padded_column(values, ds):
    """A host column of ``ds``'s rows (a GLM offset, AFT's censor flags),
    zero-extended to its padded rows and laid out as they are: row-sharded
    over its mesh's data axis (``shard_rows``), or a tensor on its
    device."""
    from ..parallel.sharding import shard_rows

    col = np.zeros((ds.n_padded,), np.float32)
    values = np.asarray(values, np.float32)
    col[: values.shape[0]] = values
    if is_sharded(ds):
        return shard_rows(col, ds.mesh)
    return torch.from_numpy(col).to(ds.x.device)


class Shards:
    """The data shards a fit runs over: a DeviceDataset is one shard on its
    device (a one-entry mesh, D = 1); a ShardedDataset gives the data
    shards this process owns.  ``sum(fn)`` runs ``fn(i, shard)`` once a
    local data shard on the shard's device (its ``(i, 0)`` entry: the model
    axis is replicated) and sums each statistic over the data shards in
    ascending order on ``home``, this process's first local shard's device
    (``collectives.aggregate_shards``).  One shard's sum is its statistics
    as they are; every process of a group gets the same bits, so every rank
    solves alike and stops alike."""

    def __init__(self, ds):
        from ..parallel.mesh import Mesh, check_model_local

        if isinstance(ds, DeviceDataset):
            self.mesh = Mesh(np.asarray([[ds.x.device]], dtype=object))
            self.data = {0: ds}
        else:
            check_model_local(ds.mesh)
            self.mesh = ds.mesh
            self.data = {i: ds.shard(i) for i in ds.mesh.local_data_shards()}
            if not self.data:
                raise ValueError(f"this process owns no data shard of {ds.mesh}")
        self.D = self.mesh.devices.shape[0]
        self.local = list(self.data)
        self.home = self.data[self.local[0]].x.device
        self.n_padded = ds.n_padded
        self.n_features = ds.n_features

    def device(self, i: int) -> torch.device:
        return self.data[i].x.device

    def sum(self, fn):
        """Each statistic of ``fn(i, shard)`` (a sequence of tensors)
        summed over the data shards in ascending order, on ``home``: one
        gather under a process group."""
        from ..parallel.collectives import aggregate_shards

        return aggregate_shards(lambda i: tuple(fn(i, self.data[i])), self.mesh)

    def put(self, t: torch.Tensor) -> dict:
        """``t`` on every local shard's device (a repeated device holds it
        once: ``.to`` of a tensor already there is the tensor)."""
        return {i: t.to(self.device(i)) for i in self.local}

    def count(self) -> float:
        """Σw over every shard, on the host."""
        return float(self.sum(lambda i, s: (s.w.to(torch.float32).sum(),))[0])

    def rows(self, fn) -> np.ndarray:
        """``fn(i, shard)`` (a tensor aligned with the shard's rows, pad
        rows included, so every shard's part has one shape) on every data
        shard, on the host in global row order: the shards' parts in
        data-shard order (gathered over the process group when one is
        active)."""
        from ..parallel.collectives import gather_shards

        parts: list = [None] * self.D
        for i, s in self.data.items():
            parts[i] = fn(i, s)
        return torch.cat([p.cpu() for p in gather_shards(parts, self.mesh)]).numpy()

    def valid_labels(self) -> np.ndarray:
        """The labels of the valid rows (w > 0), on the host in row order
        (float64: a float32 label's value exactly)."""
        yw = self.rows(lambda i, s: torch.stack([s.y.to(torch.float64),
                                                 s.w.to(torch.float64)], dim=1))
        return yw[yw[:, 1] > 0, 0]

    def parts(self, col) -> dict:
        """A row-aligned column laid out as the shards' rows are (a
        MeshArray over the data axis, or one device's tensor) →
        ``{i: its part on shard i's device}``."""
        from ..parallel.sharding import MeshArray

        if isinstance(col, MeshArray):
            return {i: col.block(i) for i in self.local}
        return {0: col}

    def with_rows(self, x: dict | None = None, y: dict | None = None,
                  w: dict | None = None) -> "Shards":
        """The same shards with their rows, labels or weights replaced
        (``{i: tensor on shard i's device}``)."""
        out = object.__new__(Shards)
        out.__dict__.update(self.__dict__)
        out.data = {i: DeviceDataset(x=s.x if x is None else x[i], y=s.y if y is None else y[i],
                                     w=s.w if w is None else w[i])
                    for i, s in self.data.items()}
        return out

    def dataset(self):
        """The shards as a ShardedDataset (what ``sample_valid_rows``
        reads): each local data shard on every model entry of its row."""
        from ..parallel.sharding import ShardedDataset

        blocks = np.empty(self.mesh.devices.shape, dtype=object)
        for i, s in self.data.items():
            for j in range(blocks.shape[1]):
                blocks[i, j] = s
        return ShardedDataset(self.mesh, blocks)


@dataclass
class PredictionResult:
    """Predictions, labels and validity weights (pad rows w = 0), as
    tensors on the device the model ran on."""

    prediction: torch.Tensor
    label: torch.Tensor
    weight: torch.Tensor

    def to_numpy(self, n: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        pred, lab = host_array(self.prediction), host_array(self.label)
        if n is None:
            valid = host_array(self.weight) > 0
            return pred[valid], lab[valid]
        return pred[:n], lab[:n]


def host_array(t) -> np.ndarray:
    """A tensor, or a row-sharded MeshArray (gathered), on the host."""
    from ..parallel.sharding import MeshArray

    return t.numpy() if isinstance(t, MeshArray) else t.cpu().numpy()


class Estimator:
    """Base: subclasses implement ``fit(data, label_col=None, device=None)
    -> Model``.

    Estimators that fit from mergeable sufficient statistics also
    implement the **partials protocol** (the JAX package's, for
    ``federated/``): set :attr:`partials_family` and override
    :meth:`partial_fit_stats` / :meth:`fit_from_partials` (single-round
    families) plus the state hooks (iterative families).  A silo's
    statistics run on the silo's device; the coordinator's update and
    solve run on ``device=`` (default the card).  ``fit(pooled)`` and
    ``fit_from_partials(merge(per-silo partials))`` agree bit for bit
    where the estimator's own pooled fit folds the same zero-initialized
    pieces in the same order (each model's module says where that holds).
    """

    #: partials-family name (``federated.partials`` registry) or ``None``
    #: when the estimator cannot fit from merged statistics
    partials_family: str | None = None

    #: True where ``fit`` runs over a mesh of more than one shard itself
    #: (the clustering family, LinearRegression, the trees, GaussianMixture,
    #: LogisticRegression, LinearSVC, NaiveBayes, OneVsRest, the GLM, AFT,
    #: the FMs, the MLP, IsotonicRegression).  Every other subclass's
    #: ``fit`` takes ``mesh=`` too: a one-entry mesh names its device, a
    #: larger one raises until slice 8c-4 (:func:`_mesh_guarded`)
    mesh_fit: bool = False

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        fit = cls.__dict__.get("fit")
        if fit is not None and not cls.mesh_fit:
            cls.fit = _mesh_guarded(fit)

    def fit(self, data: Any, label_col: str | None = None, device=None):
        raise NotImplementedError

    # ---------------------------------------------------- partials protocol
    def supports_partials(self) -> bool:
        return self.partials_family is not None

    def _no_partials(self):
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the mergeable-"
            "partials protocol (partials_family="
            f"{self.partials_family!r})"
        )

    def init_partials_state(self, n_features: int, mesh=None):
        """Round-0 ``FitState`` when it needs no data, else ``None`` — the
        coordinator then runs a data-dependent init round
        (:meth:`local_init_stats` → :meth:`init_state_from_merged`)."""
        self._no_partials()

    def local_init_stats(self, data: Any, label_col: str | None = None, mesh=None,
                         device=None):
        """One silo's init-round contribution (e.g. k-means++ candidate
        centers from the local sample) as a ``Partials``."""
        self._no_partials()

    def init_state_from_merged(self, merged):
        """Build the round-0 ``FitState`` from merged init partials."""
        self._no_partials()

    def partial_fit_stats(self, data: Any, label_col: str | None = None, mesh=None,
                          state=None, final: bool = False, device=None):
        """One silo's sufficient statistics for the next update, computed
        against ``state`` (ignored by single-round families) on ``device``
        (default the card; a DeviceDataset stays where it is).  ``final``
        marks the exact-precision closing collect of families that
        require one (:meth:`partials_final_collect`)."""
        self._no_partials()

    def apply_partials(self, state, merged, device=None):
        """Fold merged statistics into ``state`` → ``(state', done)``, the
        update on ``device`` (default the card).  ``done`` mirrors the
        family's own convergence test on the host in float32."""
        self._no_partials()

    def fit_from_partials(self, merged, state=None, device=None):
        """Build the final Model from merged statistics (and, for
        iterative families, the converged ``state``); a solve runs on
        ``device`` (default the card)."""
        self._no_partials()

    def partials_max_rounds(self) -> int:
        """Round budget: 1 for single-shot families, ``max_iter`` for
        iterative ones."""
        return 1

    def partials_final_collect(self) -> bool:
        """True when the family needs one extra exact-precision collect
        after convergence (k-means' final stats pass)."""
        return False


def check_features(x, expected: int, model_name: str) -> None:
    """Friendly feature-width validation at the model's front door."""
    got = x.shape[-1] if getattr(x, "ndim", 0) >= 2 else None
    if got is not None and got != expected:
        raise ValueError(
            f"{model_name} was trained on {expected} features but the input "
            f"has {got} (shape {tuple(x.shape)}); assemble the same feature "
            "columns used at fit time"
        )


class Model:
    """Base: subclasses implement ``predict(x) -> Tensor`` on x's device."""

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def serving_predict_fn(self):
        """Stable raw-tensor predict entry point for the ``serve/`` layer:
        ``(batch, d) tensor -> (batch,)`` predictions, deterministic and
        row-local (row i of the output depends only on row i of the
        input), so the server may pad batches and slice real rows back."""
        return self.predict

    @property
    def num_features(self) -> int | None:
        """Feature width the model was trained on, when recoverable from
        its parameters — the serve registry sizes its buckets with it."""
        for attr, axis in (
            ("coefficients", -1),         # linear family
            ("cluster_centers", 1),       # kmeans
            ("theta", 1),                 # naive bayes
            ("feature_importances", -1),  # tree ensembles
        ):
            v = getattr(self, attr, None)
            if v is not None and len(getattr(v, "shape", ())) >= 1:
                return int(v.shape[axis])
        return None

    def transform(self, data: Any, label_col: str | None = None, device=None,
                  mesh=None) -> PredictionResult:
        """Predict on ``data`` (coerced as :func:`on_mesh` does) →
        predictions beside its labels and weights; over a mesh of more
        than one shard each shard predicts on its device and the columns
        are row-sharded MeshArrays (the reference's sharded result)."""
        ds = on_mesh(data, label_col, device, None, mesh)
        return self._result(ds, self.predict)

    @staticmethod
    def _result(ds, predict) -> PredictionResult:
        """``predict`` on ``ds``'s rows (shard by shard on a ShardedDataset)
        beside its labels and weights."""
        if is_sharded(ds):
            return PredictionResult(prediction=ds.x.map_data(predict), label=ds.y, weight=ds.w)
        return PredictionResult(prediction=predict(ds.x), label=ds.y, weight=ds.w)

    def predict_numpy(self, x: np.ndarray, device=None) -> np.ndarray:
        """Host rows in, host predictions out; computed on ``device``
        (default the card)."""
        ds = as_device_dataset(np.asarray(x), device=resolve_device(device))
        n = np.asarray(x).shape[0]
        return unpad(self.predict(ds.x), n)

    # persistence sugar -------------------------------------------------
    def save(self, path: str, overwrite: bool = True) -> None:
        from ..io.model_io import save_model

        name, meta, arrays = self._artifacts()
        save_model(path, name, meta, arrays, overwrite=overwrite)

    def write(self) -> "_Writer":
        """Spark-style ``model.write().overwrite().save(path)`` chain."""
        return _Writer(self)

    def _artifacts(self) -> tuple[str, dict, dict[str, np.ndarray]]:
        """→ (``model_class`` tag, JSON params, numpy payload arrays)."""
        raise NotImplementedError


class ClusteringModel(Model):
    """Model base for the clustering family, adding Spark's DataFrame-style
    ``transform``: an :class:`AssembledTable` comes back as its source
    :class:`Table` with an int ``prediction`` column appended (the
    assignments, computed on ``device``, default the card).  Non-table
    inputs keep the base behavior (:class:`PredictionResult`)."""

    def transform(self, data: Any, label_col: str | None = None, device=None, mesh=None):
        if isinstance(data, AssembledTable):
            if mesh is not None and device is None:
                device = mesh.devices.flat[0].device
            pred = self.predict_numpy(data.features, device=device).astype(np.int32)
            return data.table.with_column("prediction", pred, dtype="int")
        return super().transform(data, label_col=label_col, device=device, mesh=mesh)


@dataclass
class _Writer:
    model: Model
    _overwrite: bool = False

    def overwrite(self) -> "_Writer":
        self._overwrite = True
        return self

    def save(self, path: str) -> None:
        self.model.save(path, overwrite=self._overwrite)
