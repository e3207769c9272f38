"""StreamingKMeans — incremental k-means over micro-batches (BASELINE
config 5), the JAX package's ``models/streaming_kmeans.py`` on one CUDA
device.

Spark's forgetful update rule with a decay factor (or a half-life in
batches or points):

    cₜ₊₁ = (cₜ·nₜ·α + Σ_{batch} x) / (nₜ·α + mₜ)
    nₜ₊₁ = nₜ·α + mₜ

Each micro-batch is one launch of the K1 kernel (``ops/lloyd.py``,
every center valid) for the batch's per-cluster sums and counts, then the
decayed merge with the weights carried as a Kahan (value, compensation)
pair, then the dying-cluster reseed — all torch ops on the batch's device,
with no host sync: the reseed walks the k clusters in index order with
``torch.where``, and its noise is drawn through ``prng.split`` and
``prng.normal`` in the JAX package's order (the step's key is
``fold_in(key(seed), step)``).  ``update_many`` applies the same rule
batch by batch (ragged batches too).  The state stays on the device until
``latest_model`` reads it.

A first batch with no centers set initializes them from a host sample:
k-means++ and ten host Lloyd iterations, the JAX package's init, bit-equal.

Over a mesh (``update(batch, mesh=)``) the placement is the reference's
adaptive one: a host batch is sharded only when every data shard gets at
least ``shard_min_rows_per_device`` rows (``parallel.sharding.
microbatch_mesh``; default 65,536, the ``CMLHN_STREAM_SHARD_MIN_ROWS`` env
var), else it runs on the mesh's first device; a dataset already on the
device runs where it lies.  A sharded batch launches K1 once a data shard
on that shard's device (``base.Shards``), the statistics are summed in
ascending shard order (``collectives.aggregate_shards``), and the decayed
merge and the reseed run once on the home device, where the state lives.
One shard keeps the one-device bits.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import prng
from ..data import batch_rows
from ..io.model_io import register_model
from ..ops.lloyd import fused_lloyd_stats
from ..parallel.sharding import microbatch_mesh, sample_valid_rows
from .base import Shards, as_device_dataset, stream_batch
from .kmeans import KMeansModel, _kmeans_pp_init, _lloyd_refine


def _batch_stats(x, w, centers):
    """One Lloyd pass over the batch: K1 on the card, its plain version on
    the CPU → (sums (k, d), counts (k,), cost ())."""
    c_valid = torch.ones((centers.shape[0],), dtype=torch.float32, device=x.device)
    return fused_lloyd_stats(x, w, centers, c_valid)


def _alpha(mode: str, param: float, m: torch.Tensor):
    """The decay of this batch: a float32 tensor on m's device (half-life
    in points) or a Python float rounded to float32."""
    if mode == "points":
        if param <= 0:
            return 0.0
        return torch.where(m > 0, torch.pow(0.5, m / param), 1.0)
    if mode == "batches":
        return float(np.float32(0.5 ** (1.0 / param))) if param > 0 else 0.0
    return float(np.float32(param))


def _update_step(sh: Shards, centers, w_hi, w_lo, key, mode: str, param: float):
    """One micro-batch over the data shards of ``sh``: K1 a shard, the
    statistics summed in shard order on the home device, then the decayed
    Kahan merge and the reseed there → (centers, w_hi, w_lo)."""
    k, d = centers.shape
    cen = sh.put(centers)
    sums, counts, _ = sh.sum(lambda i, s: _batch_stats(
        s.x.to(torch.float32).contiguous(), s.w.to(torch.float32).contiguous(), cen[i]))
    alpha = _alpha(mode, param, counts.sum())
    # decay both limbs, then Kahan-add this batch's counts
    hi, lo = w_hi * alpha, w_lo * alpha
    add = counts + lo
    new_hi = hi + add
    new_lo = (hi - new_hi) + add           # exact residual of the add
    decayed = hi + lo
    new_w = new_hi + new_lo
    safe = torch.clamp(new_w, min=1e-12)
    merged = (centers * decayed[:, None] + sums) / safe[:, None]
    # a cluster with no mass this step and no history keeps its center
    centers = torch.where(new_w[:, None] > 1e-12, merged, centers)

    # Dying-cluster reseed (Spark's rule): walk the clusters in index
    # order, splitting the current heaviest for each effectively dead one;
    # touched entries collapse their Kahan pair (hi = half, lo = 0).
    subs = []
    for _ in range(k):
        key, sub = prng.split(key)
        subs.append(sub)
    noise = prng.normal_each(torch.stack(subs), (d,), device=sh.home)
    hi, lo = new_hi, new_lo
    zero = torch.zeros((), dtype=torch.float32, device=sh.home)
    for i in range(k):
        eff = hi + lo
        total = eff.sum()
        # a (1,) index: indexing with a 0-d device tensor would read it on
        # the host
        big = torch.argmax(eff).reshape(1)
        act = (eff[i] < 1e-8 * total) & (big[0] != i) & (total > 0)
        cb = centers.index_select(0, big)[0]
        jitter = 1e-4 * (cb.abs() + 1e-4)
        centers[i] = torch.where(act, cb + noise[i] * jitter, centers[i])
        half = eff.index_select(0, big)[0] / 2
        hi[i] = torch.where(act, half, hi[i])
        lo[i] = torch.where(act, zero, lo[i])
        hi.index_put_((big,), torch.where(act, half, hi.index_select(0, big)[0]).reshape(1))
        lo.index_put_((big,), torch.where(act, zero, lo.index_select(0, big)[0]).reshape(1))
    return centers, hi, lo


@register_model("StreamingKMeansModel")
@dataclass
class StreamingKMeansModel(KMeansModel):
    cluster_weights: np.ndarray | None = None  # decayed nₜ per cluster

    def _artifacts(self):
        _, meta, arrays = super()._artifacts()
        arrays["cluster_weights"] = (
            np.asarray(self.cluster_weights)
            if self.cluster_weights is not None
            else np.zeros((self.k,))
        )
        return ("StreamingKMeansModel", meta, arrays)

    @classmethod
    def from_artifacts(cls, params, arrays):
        m = super().from_artifacts(params, arrays)
        m.cluster_weights = arrays.get("cluster_weights")
        return m


@dataclass
class StreamingKMeans:
    """Stateful estimator: ``update(batch)`` per micro-batch.

    decay_factor=1.0 → all history weighted equally; 0.0 → only the latest
    batch.  ``half_life`` (in points or batches) overrides decay_factor,
    matching Spark's ``setHalfLife``.
    """

    k: int = 8
    decay_factor: float = 1.0
    half_life: float | None = None
    time_unit: str = "batches"  # or "points"
    seed: int = 0
    #: over a mesh, shard a micro-batch only when every data shard gets at
    #: least this many rows, else run it on the mesh's first device
    #: (``parallel.sharding.microbatch_mesh``); None → the
    #: ``CMLHN_STREAM_SHARD_MIN_ROWS`` env default (65,536)
    shard_min_rows_per_device: int | None = None
    _centers: torch.Tensor | None = field(default=None, repr=False)
    _weights: torch.Tensor | None = field(default=None, repr=False)
    _weights_lo: torch.Tensor | None = field(default=None, repr=False)
    _steps: int = field(default=0, repr=False)

    def set_initial_centers(self, centers: np.ndarray, weights: np.ndarray | None = None):
        """Set the state (kept where it is until the next ``update`` moves
        it to the batch's device)."""
        self._centers = torch.from_numpy(np.asarray(centers, dtype=np.float32).copy())
        self._weights = (
            torch.from_numpy(np.asarray(weights, dtype=np.float32).copy())
            if weights is not None
            else torch.zeros((self._centers.shape[0],), dtype=torch.float32)
        )
        self._weights_lo = torch.zeros_like(self._weights)
        return self

    def set_random_centers(self, dim: int, weight: float = 0.0):
        rng = np.random.default_rng(self.seed)
        return self.set_initial_centers(
            rng.normal(size=(self.k, dim)), np.full((self.k,), weight)
        )

    @property
    def latest_model(self) -> StreamingKMeansModel:
        if self._centers is None:
            raise ValueError("StreamingKMeans has no centers yet; call update or set_*")
        return StreamingKMeansModel(
            cluster_centers=self._centers.cpu().numpy().astype(np.float32),
            n_iter=self._steps,
            cluster_weights=self._weights.cpu().numpy().astype(np.float64)
            + self._weights_lo.cpu().numpy().astype(np.float64),
        )

    def update(self, batch, mesh=None, device=None) -> "StreamingKMeans":
        """Consume one micro-batch (a DeviceDataset, ShardedDataset,
        AssembledTable, ``(x, y[, w])`` or x) on ``device`` (default the
        card) or over ``mesh`` (not both; the adaptive placement of the
        module docstring); returns ``self``.  The state stays on the
        device: read ``latest_model`` to bring it to the host."""
        return self._update(stream_batch(batch, device=device, mesh=mesh,
                                         min_rows_per_device=self.shard_min_rows_per_device))

    def update_many(self, batches, mesh=None, device=None) -> "StreamingKMeans":
        """Drain a backlog: ``update``'s rule applied batch by batch, in
        order (the batches may differ in length).  Over a mesh the
        placement is decided once, by the backlog's largest batch, as the
        reference's stacked drain decides it."""
        batches = list(batches)
        if mesh is not None and batches:
            if device is not None:
                raise ValueError("pass a mesh or a device, not both")
            mesh = microbatch_mesh(max(batch_rows(b) for b in batches), mesh,
                                   self.shard_min_rows_per_device)
        for b in batches:
            self._update(as_device_dataset(b, device=device, mesh=mesh, sharded=True))
        return self

    def _update(self, ds) -> "StreamingKMeans":
        sh = Shards(ds)
        self._ensure_centers(ds)
        self._place_state(sh)
        mode, param = self._alpha()
        key = prng.fold_in(prng.key(self.seed), self._steps)
        self._centers, self._weights, self._weights_lo = _update_step(
            sh, self._centers, self._weights, self._weights_lo, key, mode, param)
        self._steps += 1
        return self

    def _place_state(self, sh: Shards) -> None:
        """The state (k×d + 2k floats) on the batch's home device: a no-op
        while the placement does not change."""
        self._centers, self._weights, self._weights_lo = (
            t.to(sh.home) for t in (self._centers, self._weights, self._weights_lo))

    def _ensure_centers(self, ds) -> None:
        if self._centers is not None:
            return
        # lazily init from the first batch: k-means++ seeding + short
        # Lloyd refinement on a host sample
        host = sample_valid_rows(ds, 65536, self.seed)
        self.set_initial_centers(
            _lloyd_refine(host, _kmeans_pp_init(host, self.k, self.seed), iters=10)
        )

    def _alpha(self) -> tuple[str, float]:
        if self.half_life is not None:
            if self.time_unit not in ("points", "batches"):
                raise ValueError(
                    f"time_unit must be 'points' or 'batches', got {self.time_unit!r}"
                )
            return self.time_unit, float(self.half_life)
        return "decay", float(self.decay_factor)

    def predict(self, x):
        return self.latest_model.predict(x)
