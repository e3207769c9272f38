"""Per-hospital federation: explicit hospital → data-shard placement (the
JAX package's ``parallel/federation.py``).

The reference's data model carries a ``hospital_id`` per event; this
module places every hospital's rows contiguously inside exactly one shard
of the mesh's ``data`` axis, so per-hospital statistics are shard-local
until the ordered sum, a hospital's rows never straddle processes, and
global fits are unchanged (weighted sums do not care where a row lives;
tested).  Placement is deterministic LPT (largest hospital first onto the
least loaded shard), host code.  Each shard is padded to the largest
shard's rows with weight-0 rows, so the pad rows sit at the end of each
shard, and ``row_order`` maps every padded slot back to its row.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..data import DeviceDataset
from .mesh import DATA_AXIS, Mesh, default_mesh
from .sharding import place_dataset, uses_shards


def place_hospitals(hospital_ids: np.ndarray, n_shards: int) -> dict[object, int]:
    """Deterministic balanced placement: hospital id → shard index.

    LPT greedy: hospitals sorted by row count (desc, id as tie-break) are
    assigned to the currently least-loaded shard."""
    ids, counts = np.unique(np.asarray(hospital_ids), return_counts=True)
    order = np.lexsort((ids.astype(str), -counts))
    load = np.zeros(n_shards, dtype=np.int64)
    placement: dict[object, int] = {}
    for i in order:
        s = int(np.argmin(load))
        placement[ids[i]] = s
        load[s] += int(counts[i])
    return placement


@dataclass
class FederatedDataset:
    """A dataset whose row layout honors hospital placement.

    ``data`` is consumable like a plain ``device_dataset`` result (a
    ShardedDataset, or a DeviceDataset on a one-entry mesh);
    ``hospital_to_shard`` records the placement; ``row_order[i]`` is the
    original row index now in padded slot ``i`` (-1 for padding)."""

    data: object
    hospital_to_shard: dict[object, int]
    row_order: np.ndarray
    n_rows: int

    @property
    def x(self):
        return self.data.x

    @property
    def y(self):
        return self.data.y

    @property
    def w(self):
        return self.data.w

    @property
    def n_padded(self) -> int:
        return self.data.n_padded

    @property
    def n_features(self) -> int:
        return self.data.n_features


def federated_dataset(features, hospital_ids=None, y=None, mesh: Mesh | None = None,
                      hospital_col: str = "hospital_id", dtype=np.float32) -> FederatedDataset:
    """Shard a dataset with one-hospital-one-shard placement over ``mesh``
    (default :func:`~.mesh.default_mesh`, every card; raises without one).

    ``features`` may be an :class:`AssembledTable` (hospital ids and the
    label column are read from its source table) or an (n, d) array with
    ``hospital_ids`` (and optionally ``y``) given explicitly."""
    from ..features.assembler import AssembledTable

    mesh = mesh or default_mesh()
    if isinstance(features, AssembledTable):
        tab = features.table
        if hospital_ids is None:
            hospital_ids = tab.column(hospital_col)
        if y is None and features.output_col != hospital_col:
            from ..core.schema import LABEL_COL

            if LABEL_COL in tab.schema:
                y = tab.column(LABEL_COL).astype(np.float64)
        features = features.features
    x = np.atleast_2d(np.asarray(features, dtype=dtype))
    n = x.shape[0]
    ids = np.asarray(hospital_ids)
    if ids.shape[0] != n:
        raise ValueError(f"hospital_ids length {ids.shape[0]} != rows {n}")

    n_shards = mesh.shape[DATA_AXIS]
    placement = place_hospitals(ids, n_shards)
    shard_of_row = np.fromiter((placement[i] for i in ids), dtype=np.int64, count=n)
    # stable sort: hospitals stay contiguous inside their shard, original
    # order preserved within a hospital
    order = np.argsort(shard_of_row, kind="stable")
    per_shard = np.bincount(shard_of_row, minlength=n_shards)
    shard_len = max(int(per_shard.max()), 1)

    row_order = np.full((shard_len * n_shards,), -1, dtype=np.int64)
    xp = np.zeros((shard_len * n_shards, x.shape[1]), dtype=np.float32)
    yp = np.zeros((shard_len * n_shards,), dtype=np.float32)
    w = np.zeros((shard_len * n_shards,), dtype=np.float32)
    yv = None if y is None else np.asarray(y).reshape(-1)
    start = 0
    for s in range(n_shards):
        rows = order[start : start + per_shard[s]]
        start += per_shard[s]
        base = s * shard_len
        row_order[base : base + rows.shape[0]] = rows
        xp[base : base + rows.shape[0]] = x[rows]
        w[base : base + rows.shape[0]] = 1.0
        if yv is not None:
            yp[base : base + rows.shape[0]] = yv[rows]
    if uses_shards(mesh):
        data = place_dataset(xp, yp, w, mesh)
    else:
        dev = mesh.device(0, 0)
        data = DeviceDataset(x=torch.from_numpy(xp).to(dev), y=torch.from_numpy(yp).to(dev),
                             w=torch.from_numpy(w).to(dev))
    return FederatedDataset(data=data, hospital_to_shard=placement, row_order=row_order, n_rows=n)
