"""KMeans — the north-star workload: k=256 Lloyd on one CUDA device.

The JAX package's ``models/kmeans.py``, step for step:

- k-means++ init on a host sample of valid rows, copied unchanged, so
  the same seed gives bit-equal init centers (or ``warm_start_centers``);
- each Lloyd step is one launch of the K1 kernel (``ops/lloyd.py``)
  followed by the centroid rule: empty clusters keep their center, cosine
  centers are re-normalized, and ``move`` is the largest squared shift
  over valid centers;
- one more exact stats pass on the returned centers gives
  ``training_cost`` (Σ w·min d², on unit rows in cosine mode) and
  ``cluster_sizes``.

``distance_measure="cosine"`` runs K1 and K2 unchanged on unit rows (pad
rows zeroed by the 0/1 mask, never by the weight value).

``matmul_precision`` other than ``"highest"`` runs the Lloyd steps'
statistics as the reference's row-chunked XLA matmuls do, in torch ops
(:func:`lloyd_stats_reduced`, ``ops/distance.py::matmul_p``): ``"bf16"``
rounds the assignment product's operands to bfloat16 and sums in float32;
``fused_stats`` (bf16 only) also takes the argmin on the x²-free basis
``c_sq − 2·x·cᵀ`` and gets sums and counts from one bf16 one-hot product
against ``[x | 1]``.  The final pass that gives ``training_cost`` and
``cluster_sizes`` stays K1 (exact), as the reference keeps it.

Two stopping rules, as in the reference.  Its device loop (no checkpoint,
no ``on_iteration``) stops when ``move <= tol²`` compared in float32; its
host loop (a checkpoint or ``on_iteration`` on the resident path, and
every out-of-core fit) compares in Python floats.  A ``move`` between
the two thresholds stops a step apart, so the port keeps each rule where
the reference has it.

The partials protocol (``federated/``, family ``"kmeans"``): a silo's
statistics are one Lloyd pass over its rows (K1 on the card) against the
broadcast centers; the coordinator applies the centroid rule on its
device and stops as the device loop does (``move > tol²`` in float32).

Over a mesh (``fit(..., mesh=)``, or a ``ShardedDataset``; ``parallel/``)
each Lloyd step launches K1 once per data shard on that shard's device,
sums the shards' statistics in ascending shard order (across processes an
ordered all_gather, ``parallel/collectives.py``) and applies the centroid
rule once.  The model axis splits the ``k_pad = padded_slots(k, m)``
centers: each (data, model) shard launches K2 on its ``k_pad/m`` centers,
the owner of a row is the first model shard with the smallest min d² (the
reference's rule), and each shard launches K1 with the weights
``w · (owner == m)``; K1 and K2 share one d² expression, so the counts
summed over the model shards are the bincount of the global argmin.  A
reduced ``matmul_precision`` on a model axis applies the same owner rule
to each chunk's reduced-precision mins (:func:`lloyd_stats_reduced_model`).
``checkpoint_dir`` over shards signs the rows by their global padded
indices (``io/fit_checkpoint.py::data_fingerprint``) and resumes bit-equal
to the uninterrupted sharded fit.  A mesh of one shard is the
single-device fit, bit for bit.

A :class:`~..parallel.outofcore.HostDataset` takes the out-of-core path,
on one device or over a mesh (``fit(HostDataset, mesh=)``): each Lloyd
step streams the blocks, each block one sharded pass (K1 once a data
shard of the block; on a model axis K2 then the owner-masked K1 once a
(data, model) shard), the statistics summed over the block's shards in
ascending order and then over the blocks, then one centroid update on the
home device.  A one-device block is the (1, 1) case of the same pass.
``checkpoint_dir`` commits the centers every ``checkpoint_every`` steps on
both paths (``io/fit_checkpoint.py``, the reference's signatures key for
key).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..data import DeviceDataset, pad_slots, padded_slots, slot_mask
from ..device import resolve_device
from ..io.model_io import register_model
from ..ops.distance import matmul_p, pairwise_sqdist, sq_norms, validate_matmul_precision
from ..ops.lloyd import fused_assign, fused_lloyd_stats
from ..parallel.collectives import ordered_sum
from ..parallel.mesh import MODEL_AXIS, check_model_local, single_device_mesh
from ..parallel.outofcore import HostDataset, add_stats, stream_home, stream_mesh
from ..parallel.partitioner import family
from ..parallel.sharding import MeshArray, ShardedDataset, sample_valid_rows
from .base import ClusteringModel, Estimator, as_device_dataset, check_features, on_mesh
from .summary import ClusteringSummary

DISTANCE_MEASURES = ("euclidean", "cosine")

#: invalid (k-padding) centers' distance in the reduced-precision steps
_BIG = 1e30

#: center placement over the mesh's model axis (``parallel/partitioner.py``)
_PT = family("kmeans")


def normalize_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit rows: cosine distance is Euclidean distance on the sphere."""
    return x / torch.sqrt(torch.clamp((x * x).sum(dim=-1), min=eps))[:, None]


def _cosine_prep(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Unit rows with pad rows zeroed by the 0/1 mask: fractional weights
    must not rescale the unit vectors (they enter through the weighted
    statistics instead)."""
    return (normalize_rows(x.to(torch.float32)) * (w[:, None] > 0)).contiguous()


def _centroid_rule(sums, counts, centers, c_valid, cosine: bool = False):
    """Empty clusters keep their previous center (Spark behavior); cosine
    re-normalizes after every update, or the ||c||² term stops ordering by
    cosine similarity.  → (new centers, move)."""
    new_centers = torch.where(
        (counts > 0)[:, None],
        sums / torch.clamp(counts, min=1.0)[:, None],
        centers,
    )
    if cosine:
        new_centers = normalize_rows(new_centers)
    move = (((new_centers - centers) ** 2).sum(dim=1) * c_valid).max()
    return new_centers, move


def lloyd_stats_model(parts) -> list:
    """One exact Lloyd pass over one data shard's model shards: each of
    ``parts`` is a model shard's ``(x, w, centers, c_valid)`` (the same
    rows, its ``k_pad / m`` centers) on its device.  One part is one K1
    launch.  More: K2 a model shard, the owner of a row the first model
    shard with the smallest min d² (the reference's rule), and K1 a model
    shard on the weights ``w · (owner == m)``.  → [(sums, counts, cost)] a
    model shard."""
    if len(parts) == 1:
        return [fused_lloyd_stats(*parts[0])]
    home = parts[0][0].device
    mins = [fused_assign(x, c, v)[1].to(home) for x, _, c, v in parts]
    owner = torch.stack(mins).argmin(dim=0)
    return [fused_lloyd_stats(x, w * (owner == j).to(x.device, torch.float32), c, v)
            for j, (x, w, c, v) in enumerate(parts)]


def lloyd_stats_reduced(x, w, centers, c_valid, precision: str, fuse_stats: bool,
                        chunk: int):
    """One Lloyd pass's (sums (k, d), counts (k,), cost ()) under a
    reduced matmul precision, ``chunk`` rows at a time (the reference's
    ``_lloyd_shard_stats`` on one device).

    Plain: the assignment product under ``precision``, invalid centers at
    +BIG, argmin, then a float32 one-hot product for the sums.
    ``fuse_stats``: the argmin on ``c_sq − 2·x·cᵀ`` (bf16 product; x² is
    constant along a row and is added back for the cost only), and sums
    and counts from one bf16 one-hot product of the bf16-rounded weights
    against ``[x | 1]``, summed in float32."""
    return lloyd_stats_reduced_model([(x, w, centers, c_valid)], precision, fuse_stats,
                                     chunk)[0]


def lloyd_stats_reduced_model(parts, precision: str, fuse_stats: bool, chunk: int) -> list:
    """:func:`lloyd_stats_reduced` over one data shard's model shards: each
    of ``parts`` is a model shard's ``(x, w, centers, c_valid)`` (the same
    rows, its ``k_pad / m`` centers) on its device.  Chunk by chunk, each
    model shard takes its local min and argmin under ``precision``; the
    owner of a row is the first model shard with the smallest min (the
    reference's ``all_gather`` over ``MODEL_AXIS``), and each shard sums
    the rows it owns.  The cost (Σ w·global min) is the first shard's, the
    others' are 0, so their sum is the reference's ``pmax`` over the model
    axis.  → [(sums, counts, cost)] a model shard; one shard is
    :func:`lloyd_stats_reduced`."""
    if fuse_stats and precision != "bf16":
        raise ValueError("fuse_stats requires matmul_precision='bf16'")
    home = parts[0][0].device
    acc, prep = [], []
    for x, w, centers, c_valid in parts:
        k, d = centers.shape
        f32 = dict(dtype=torch.float32, device=x.device)
        acc.append([torch.zeros((k, d), **f32), torch.zeros((k,), **f32),
                    torch.zeros((), **f32)])
        prep.append((sq_norms(centers), (c_valid > 0)[None, :]))
    n = parts[0][0].shape[0]
    for s in range(0, n, max(chunk, 1)):
        mins, args = [], []
        for (x, w, centers, _), (c_sq, valid) in zip(parts, prep):
            xb = x[s:s + chunk]
            if fuse_stats:
                basis = c_sq[None, :] - 2.0 * matmul_p(xb, centers.T, "bf16")
            else:
                basis = pairwise_sqdist(xb, centers, c_sq=c_sq, precision=precision)
            mn, arg = torch.where(valid, basis, torch.full_like(basis, _BIG)).min(dim=1)
            mins.append(mn)
            args.append(arg)
        if len(parts) == 1:
            g_min, owner = mins[0], None
        else:
            all_min = torch.stack([m.to(home) for m in mins])
            g_min, owner = all_min.min(dim=0).values, all_min.argmin(dim=0)
        for j, (x, w, centers, _) in enumerate(parts):
            xb, wb = x[s:s + chunk], w[s:s + chunk]
            k, d = centers.shape
            mine = wb > 0 if owner is None else (owner.to(x.device) == j) & (wb > 0)
            wv = torch.where(mine, wb, torch.zeros_like(wb))
            if fuse_stats:
                wv = wv.to(torch.bfloat16)
                oh = torch.nn.functional.one_hot(args[j], k).to(torch.float32) * wv.to(
                    torch.float32)[:, None]
                x1 = torch.cat([xb, torch.ones((xb.shape[0], 1), dtype=torch.float32,
                                               device=xb.device)], dim=1)
                sc = matmul_p(oh.T, x1, "bf16")
                acc[j][0] = acc[j][0] + sc[:, :d]
                acc[j][1] = acc[j][1] + sc[:, d]
            else:
                oh = torch.nn.functional.one_hot(args[j], k).to(torch.float32) * wv[:, None]
                acc[j][0] = acc[j][0] + oh.T @ xb
                acc[j][1] = acc[j][1] + oh.sum(dim=0)
        gm = g_min
        if fuse_stats:
            x0 = parts[0][0][s:s + chunk]
            gm = torch.clamp(g_min + sq_norms(x0), min=0.0)
        acc[0][2] = acc[0][2] + (gm * parts[0][1][s:s + chunk]).sum()
    return [tuple(a) for a in acc]


def _kmeans_pp_init(sample: np.ndarray, k: int, seed: int) -> np.ndarray:
    """Greedy k-means++ on a host-side sample: at each step draw
    ``2 + ⌊log k⌋`` D²-weighted candidates and keep the one minimizing the
    resulting potential."""
    rng = np.random.default_rng(seed)
    n = sample.shape[0]
    if n == 0:
        raise ValueError("cannot initialize k-means on an empty dataset")
    n_trials = 2 + int(np.log(max(k, 2)))
    centers = np.empty((k, sample.shape[1]), dtype=np.float64)
    idx = int(rng.integers(n))
    centers[0] = sample[idx]
    d2 = np.sum((sample - centers[0]) ** 2, axis=1)
    for i in range(1, k):
        total = d2.sum()
        if total <= 0:
            centers[i:] = sample[rng.integers(n, size=k - i)]
            break
        # replace=False requires at least `size` nonzero-probability entries
        cand = rng.choice(
            n,
            size=min(n_trials, n, int(np.count_nonzero(d2))),
            p=d2 / total,
            replace=False,
        )
        cand_d2 = np.minimum(
            d2[None, :],
            ((sample[None, :, :] - sample[cand][:, None, :]) ** 2).sum(axis=2),
        )
        best = int(np.argmin(cand_d2.sum(axis=1)))
        centers[i] = sample[cand[best]]
        d2 = cand_d2[best]
    return centers


def _host_sqdist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(n, d), (k, d) → (n, k) squared distances on the host."""
    return (
        (a * a).sum(axis=1)[:, None]
        - 2.0 * a @ b.T
        + (b * b).sum(axis=1)[None, :]
    )


def _lloyd_refine(
    sample: np.ndarray, centers: np.ndarray, iters: int = 10, return_assign: bool = False
):
    """A few host Lloyd iterations to polish an init (numpy, bounded
    sample; copied unchanged so inits stay bit-equal)."""
    centers = centers.copy()
    assign = np.zeros(sample.shape[0], dtype=np.int64)
    for _ in range(iters):
        assign = np.argmin(_host_sqdist(sample, centers), axis=1)
        for j in range(centers.shape[0]):
            m = assign == j
            if m.any():
                centers[j] = sample[m].mean(axis=0)
    if return_assign:
        return centers, np.argmin(_host_sqdist(sample, centers), axis=1)
    return centers


class _ShardedLloyd:
    """The Lloyd statistics of a :class:`ShardedDataset`: K1 once a data
    shard (on a model axis, K2 then the owner-masked K1 once a (data,
    model) shard), the shards' statistics summed in ascending data-shard
    order (``collectives.ordered_sum``), unpacked on this process's first
    local shard's device (``home``).  A DeviceDataset is the (1, 1) mesh of
    its device; ``c_valid`` (the slot mask laid over the mesh) may be given
    by a caller that passes many datasets of one mesh shape (the streamed
    blocks)."""

    def __init__(self, sds, k: int, cosine: bool, c_valid: MeshArray | None = None):
        if isinstance(sds, DeviceDataset):
            blocks = np.empty((1, 1), dtype=object)
            blocks[0, 0] = sds
            sds = ShardedDataset(single_device_mesh(sds.x.device), blocks)
        mesh = sds.mesh
        check_model_local(mesh)
        self.mesh = mesh
        self.D, self.M = mesh.devices.shape
        self.k_pad = padded_slots(k, self.M)
        self.k_loc = self.k_pad // self.M
        self.local = mesh.local_data_shards()
        if not self.local:
            raise ValueError(f"this process owns no data shard of {mesh}")
        self.home = mesh.device(self.local[0], 0)
        prepped, self.x, self.w = {}, {}, {}
        blocks = np.empty(mesh.devices.shape, dtype=object)
        for i in self.local:
            for j in range(self.M):
                blk = sds.shard(i, j)
                key = (i, str(blk.x.device))  # a repeated device prepares once
                if key not in prepped:
                    x = blk.x.to(torch.float32).contiguous()
                    w = blk.w.to(torch.float32).contiguous()
                    prepped[key] = (_cosine_prep(x, w) if cosine else x, w)
                self.x[i, j], self.w[i, j] = prepped[key]
                blocks[i, j] = DeviceDataset(self.x[i, j], blk.y, self.w[i, j])
        #: the prepared rows, which the init samples
        self.data = ShardedDataset(mesh, blocks)
        self.c_valid = (c_valid if c_valid is not None
                        else _PT.put("state/c_valid", slot_mask(k, self.k_pad), mesh))

    def stats(self, centers: torch.Tensor, fn):
        """One pass against ``centers`` (k_pad, d): ``fn`` (:func:`lloyd_stats_model`
        or :func:`lloyd_stats_reduced_model`) over each data shard's model
        shards → (sums (k_pad, d), counts (k_pad,), cost ()) on ``home``."""
        cen = _PT.put("state/centers", centers, self.mesh)
        cv = self.c_valid
        parts: list = [None] * self.D
        for i in self.local:
            dev = self.mesh.device(i, 0)
            got = fn([(self.x[i, j], self.w[i, j], cen.block(i, j), cv.block(i, j))
                      for j in range(self.M)])
            parts[i] = torch.cat([torch.cat([s.reshape(-1), c, t.reshape(1)]).to(dev)
                                  for s, c, t in got])
        tot = ordered_sum(parts, self.mesh).to(self.home)
        d, kl = centers.shape[1], self.k_loc
        per = [tot[j * (kl * d + kl + 1):(j + 1) * (kl * d + kl + 1)] for j in range(self.M)]
        sums = torch.cat([b[: kl * d].view(kl, d) for b in per])
        counts = torch.cat([b[kl * d : kl * d + kl] for b in per])
        cost = per[0][-1]
        for b in per[1:]:
            cost = cost + b[-1]
        return sums, counts, cost


@register_model("KMeansModel")
@dataclass
class KMeansModel(ClusteringModel):
    cluster_centers: np.ndarray          # (k, d)
    distance_measure: str = "euclidean"
    training_cost: float = 0.0           # final inertia (Spark trainingCost)
    n_iter: int = 0
    cluster_sizes: np.ndarray | None = None

    def __post_init__(self):
        if self.distance_measure not in DISTANCE_MEASURES:
            raise ValueError(
                f"distance_measure={self.distance_measure!r}: KMeans measures are "
                f"{DISTANCE_MEASURES}"
            )
        self._centers_on: dict[str, torch.Tensor] = {}

    def __getstate__(self) -> dict:
        """Pickle the model's arrays, not its per-device center cache: a
        model served on the card crosses a process boundary (the
        multi-process fleet's ``add_model``) with no CUDA tensor in it."""
        state = dict(self.__dict__)
        state.pop("_centers_on", None)
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._centers_on = {}

    @property
    def k(self) -> int:
        return self.cluster_centers.shape[0]

    @property
    def summary(self) -> ClusteringSummary:
        return ClusteringSummary(
            k=self.k,
            num_iter=self.n_iter,
            cluster_sizes=(
                np.asarray(self.cluster_sizes)
                if self.cluster_sizes is not None else None
            ),
            training_cost=float(self.training_cost),
        )

    def _centers(self, device: torch.device) -> torch.Tensor:
        """The centers as float32 on ``device``, moved there once."""
        key = str(device)
        c = self._centers_on.get(key)
        if c is None:
            c = torch.tensor(
                np.asarray(self.cluster_centers, dtype=np.float32), device=device
            )
            self._centers_on[key] = c
        return c

    def _prep(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        x = normalize_rows(x) if self.distance_measure == "cosine" else x
        return x.contiguous()

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """(n, d) tensor → (n,) int32 cluster indices on x's device (the K2
        kernel on the card; unit rows in cosine mode).  A row-sharded
        :class:`~..parallel.sharding.MeshArray` is assigned shard by shard
        on each shard's device, one K2 launch a shard."""
        check_features(x, self.cluster_centers.shape[1], type(self).__name__)
        if isinstance(x, MeshArray):
            return x.map_data(self.predict)
        c_valid = torch.ones((self.k,), dtype=torch.float32, device=x.device)
        return fused_assign(self._prep(x), self._centers(x.device), c_valid)[0]

    def _cost(self, ds: DeviceDataset) -> torch.Tensor:
        centers = self._centers(ds.x.device)
        c_valid = torch.ones((self.k,), dtype=torch.float32, device=ds.x.device)
        _, mind2 = fused_assign(self._prep(ds.x), centers, c_valid)
        return (mind2 * ds.w).sum()

    def compute_cost(self, data, device=None, mesh=None) -> float:
        """Sum of weighted squared distances to the nearest center (Spark
        computeCost; on unit rows in cosine mode).  Over a mesh each data
        shard runs K2 on its device and the shards' sums add in ascending
        shard order."""
        ds = as_device_dataset(data, device=device, mesh=mesh)
        if isinstance(ds, ShardedDataset):
            return float(ordered_sum([None if s is None else self._cost(s)
                                      for s in ds.shards], ds.mesh))
        return float(self._cost(ds))

    def _artifacts(self):
        return (
            "KMeansModel",
            {
                "distance_measure": self.distance_measure,
                "training_cost": self.training_cost,
                "n_iter": self.n_iter,
            },
            {
                "cluster_centers": np.asarray(self.cluster_centers),
                "cluster_sizes": (
                    np.asarray(self.cluster_sizes)
                    if self.cluster_sizes is not None
                    else np.zeros((self.k,))
                ),
            },
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(
            cluster_centers=np.asarray(arrays["cluster_centers"], dtype=np.float32),
            distance_measure=params.get("distance_measure", "euclidean"),
            training_cost=float(params.get("training_cost", 0.0)),
            n_iter=int(params.get("n_iter", 0)),
            cluster_sizes=(None if arrays.get("cluster_sizes") is None
                           else np.asarray(arrays["cluster_sizes"])),
        )


@dataclass(frozen=True)
class KMeans(Estimator):
    k: int = 8
    max_iter: int = 20            # Spark default
    tol: float = 1e-4             # Spark default
    seed: int = 0
    init_mode: str = "k-means++"  # or "random"
    distance_measure: str = "euclidean"  # or "cosine"
    #: begin Lloyd from these (k, d) centers instead of the init; the
    #: checkpoint signature hashes them
    warm_start_centers: np.ndarray | None = None
    init_sample_size: int = 65536
    #: rows a chunk of the reduced-precision steps (the reference's scan)
    chunk_rows: int = 32768
    #: the Lloyd steps' matmul precision (``ops/distance.MATMUL_PRECISIONS``);
    #: "highest" is K1 on the card
    matmul_precision: str = "highest"
    #: bf16 only: the x²-free argmin and one bf16 one-hot product for the
    #: sums and counts (``lloyd_stats_reduced``)
    fused_stats: bool = False
    #: the reference's switch for its Pallas kernel; K1 is the "highest"
    #: step on the card whatever it says
    use_pallas: bool | None = None
    #: commit the centers every ``checkpoint_every`` Lloyd steps, so a
    #: preempted fit resumes from the last commit
    checkpoint_dir: str | None = None
    checkpoint_every: int = 5
    weight_col: str | None = None  # Spark's weightCol

    def _init_from_sample(self, valid: np.ndarray) -> np.ndarray:
        """(sample of valid rows) → (k, d) start centers."""
        if valid.shape[0] == 0:
            raise ValueError("k-means fit on an empty dataset")
        rng = np.random.default_rng(self.seed)
        if self.distance_measure == "cosine":
            norms = np.sqrt(np.maximum((valid * valid).sum(axis=1), 1e-12))
            valid = valid / norms[:, None]
        if self.init_mode == "random":
            pick = rng.choice(valid.shape[0], size=min(self.k, valid.shape[0]),
                              replace=False)
            centers = valid[pick]
            if centers.shape[0] < self.k:  # fewer distinct rows than k
                extra = valid[rng.integers(valid.shape[0],
                                           size=self.k - centers.shape[0])]
                centers = np.concatenate([centers, extra])
            return centers
        return _kmeans_pp_init(valid, self.k, self.seed)

    def _warm_centers(self, d: int) -> np.ndarray | None:
        """Validated warm-start centers as float32 (unit rows in cosine
        mode, the space the update keeps), or None without them."""
        if self.warm_start_centers is None:
            return None
        c = np.asarray(self.warm_start_centers, dtype=np.float32)
        if c.shape != (self.k, d):
            raise ValueError(
                f"warm_start_centers must be ({self.k}, {d}); got {tuple(c.shape)}"
            )
        if self.distance_measure == "cosine":
            norms = np.sqrt(np.maximum((c * c).sum(axis=1), 1e-12))
            c = c / norms[:, None]
        return c

    def _warm_fingerprint(self) -> str | None:
        """Warm-start identity for the checkpoint signature."""
        if self.warm_start_centers is None:
            return None
        from ..io.fit_checkpoint import array_fingerprint

        return array_fingerprint(np.asarray(self.warm_start_centers, dtype=np.float32))

    def _stats_fn(self):
        """The Lloyd steps' statistics over a data shard's model shards
        (one part on one device): K1 at "highest"
        (:func:`lloyd_stats_model`), else the reduced-precision torch pass
        (:func:`lloyd_stats_reduced_model`)."""
        if self.matmul_precision == "highest":
            if self.fused_stats:
                raise ValueError("fuse_stats requires matmul_precision='bf16'")
            return lloyd_stats_model
        return functools.partial(lloyd_stats_reduced_model, precision=self.matmul_precision,
                                 fuse_stats=self.fused_stats, chunk=self.chunk_rows)

    def _init_centers(self, ds: DeviceDataset) -> np.ndarray:
        return self._init_from_sample(
            sample_valid_rows(ds, self.init_sample_size, self.seed)
        )

    def _checkpointer(self, signature: dict):
        """→ (FitCheckpointer or None, its resumed state or None)."""
        if not self.checkpoint_dir:
            return None, None
        from ..io.fit_checkpoint import FitCheckpointer

        ckpt = FitCheckpointer(self.checkpoint_dir, signature)
        return ckpt, ckpt.resume()

    def _start(self, resumed, d: int, k_pad: int, sample_fn):
        """→ (float32 (k_pad, d) start centers, first step): the resumed
        commit, else the warm start, else the init on ``sample_fn()``."""
        if resumed is not None:
            step0, arrays, _ = resumed
            cen = arrays["centers"].astype(np.float32)
            if cen.shape != (k_pad, d):
                raise ValueError(
                    f"checkpointed centers shape {cen.shape} does not match "
                    f"the padded layout {(k_pad, d)}"
                )
            return cen, step0 + 1
        centers0 = self._warm_centers(d)
        if centers0 is None:
            centers0 = self._init_from_sample(sample_fn())
        return pad_slots(centers0, k_pad), 1

    def _host_loop(self, step, centers, start_it: int, ckpt, on_iteration):
        """The reference's host loop: ``step(centers)`` → (new centers,
        cost, move) per Lloyd step, a commit every ``checkpoint_every``
        steps, ``on_iteration``, and the stop at ``move <= tol²`` in Python
        floats.  → (centers, last step)."""
        it = start_it - 1
        for it in range(start_it, self.max_iter + 1):
            centers, cost, move = step(centers)
            if ckpt is not None and it % max(self.checkpoint_every, 1) == 0:
                ckpt.save(it, {"centers": centers})
            if on_iteration is not None:
                on_iteration(it, float(cost), float(move))
            if float(move) <= self.tol * self.tol:
                break
        return centers, it

    def _model(self, centers, counts, cost, it: int) -> KMeansModel:
        return KMeansModel(
            cluster_centers=centers.cpu().numpy()[: self.k],
            distance_measure=self.distance_measure,
            training_cost=float(cost),
            n_iter=it,
            cluster_sizes=counts.cpu().numpy()[: self.k],
        )

    # ---------------------------------------------------- partials protocol
    # K1 sums a silo's rows in its own block order, so the federated fit
    # equals the pooled one bit for bit only where every float32 sum is
    # exact (integer-valued rows); on float rows the gap is the sums'
    # reassociation (ROADMAP "Decided").
    partials_family = "kmeans"

    def partials_max_rounds(self) -> int:
        return self.max_iter

    def partials_final_collect(self) -> bool:
        # cost / sizes must describe the RETURNED centers (Spark's
        # summary.trainingCost) at exact precision: one closing collect
        return True

    def init_partials_state(self, n_features: int, mesh=None):
        from ..federated.partials import FitState

        c0 = self._warm_centers(n_features)
        if c0 is None:
            return None  # the coordinator runs the candidate init round
        return FitState(
            family=self.partials_family, version=0,
            params={"centers": c0.astype(np.float32)}, meta={},
        )

    def local_init_stats(self, data, label_col: str | None = None, mesh=None, device=None):
        """One silo's init contribution: its local k-means++ candidates
        (each a weighted summary of the silo's geometry — candidate
        CENTERS cross the wire, never rows)."""
        from ..federated.partials import Partials

        ds = self._on_mesh(data, None if mesh is not None else device, mesh)
        sample = sample_valid_rows(ds, self.init_sample_size, self.seed)
        cand = self._init_from_sample(np.asarray(sample, np.float64))
        return Partials(
            family="kmeans.init",
            stats={"candidates": np.asarray(cand, np.float64)},
            n_rows=float(sample.shape[0]),
        )

    def init_state_from_merged(self, merged):
        """Round-0 centers from the concatenated per-silo candidates:
        k-means++ re-seeds over the candidate pool (ascending silo order),
        then ten host Lloyd polish passes — the distributed analogue of
        the pooled sample init (host numpy, bit-equal to the reference)."""
        from ..federated.partials import FitState

        cand = np.asarray(merged.stats["candidates"], np.float64)
        centers = _kmeans_pp_init(cand, self.k, self.seed)
        centers = _lloyd_refine(cand, centers, iters=10)
        if self.distance_measure == "cosine":
            norms = np.sqrt(np.maximum((centers * centers).sum(axis=1), 1e-12))
            centers = centers / norms[:, None]
        return FitState(
            family=self.partials_family, version=0,
            params={"centers": centers.astype(np.float32)}, meta={},
        )

    def partial_fit_stats(self, data, label_col: str | None = None, mesh=None, state=None,
                          final: bool = False, device=None):
        """One silo's Lloyd statistics against ``state``'s centers on
        ``device`` (default the card; a DeviceDataset where it lies), or
        over ``mesh`` (the sharded pass of the fit): K1 at "highest" and in
        the closing ``final`` collect, else the reduced-precision pass."""
        from ..federated.partials import Partials

        if state is None:
            raise ValueError("kmeans partials need the broadcast FitState")
        validate_matmul_precision(self.matmul_precision)
        ds = self._on_mesh(data, None if mesh is not None else device, mesh)
        # exact precision for the closing pass, as the resident fit's final pass
        stats = lloyd_stats_model if final else self._stats_fn()
        cen_h = np.asarray(state.params["centers"], np.float32)
        if isinstance(ds, ShardedDataset):
            lloyd = self._sharded_lloyd(ds)
            centers = torch.from_numpy(pad_slots(cen_h, lloyd.k_pad)).to(lloyd.home)
            sums, counts, cost = lloyd.stats(centers, stats)
        else:
            x = ds.x.to(torch.float32).contiguous()
            w = ds.w.to(torch.float32).contiguous()
            if self.distance_measure == "cosine":
                x = _cosine_prep(x, w)
            k_pad = padded_slots(self.k, 1)
            dev = x.device
            centers = torch.from_numpy(pad_slots(cen_h, k_pad)).to(dev)
            c_valid = torch.from_numpy(slot_mask(self.k, k_pad)).to(dev)
            sums, counts, cost = stats([(x, w, centers, c_valid)])[0]
        counts_h = counts.cpu().numpy()[: self.k]
        return Partials(
            family=self.partials_family,
            stats={
                "sums": sums.cpu().numpy()[: self.k],
                "counts": counts_h,
                "cost": cost.cpu().numpy(),
            },
            n_rows=float(counts_h.sum()),
            state_version=state.version,
        )

    def apply_partials(self, state, merged, device=None):
        """The centroid rule on ``device`` (default the card), and the
        stop decided on the host as the resident device loop decides it:
        ``move > tol²`` in float32."""
        from ..federated.partials import FitState

        dev = resolve_device(device)
        centers = torch.from_numpy(np.asarray(state.params["centers"], np.float32)).to(dev)
        c_valid = torch.ones((centers.shape[0],), dtype=torch.float32, device=dev)
        new_centers, move = _centroid_rule(
            torch.from_numpy(np.asarray(merged.stats["sums"], np.float32)).to(dev),
            torch.from_numpy(np.asarray(merged.stats["counts"], np.float32)).to(dev),
            centers, c_valid, self.distance_measure == "cosine",
        )
        version = state.version + 1
        done = not bool(np.float32(move.item()) > np.float32(float(self.tol * self.tol)))
        done = done or version >= self.max_iter
        return FitState(
            family=self.partials_family, version=version,
            params={"centers": new_centers.cpu().numpy()},
            meta={"cost": float(np.asarray(merged.stats["cost"]))},
        ), done

    def fit_from_partials(self, merged, state=None, device=None) -> KMeansModel:
        """Final model from the closing exact-precision collect
        (``merged``) at the converged ``state`` centers (host arrays)."""
        if state is None:
            raise ValueError("kmeans fit_from_partials needs the converged FitState")
        return KMeansModel(
            cluster_centers=np.asarray(state.params["centers"], np.float32)[: self.k],
            distance_measure=self.distance_measure,
            training_cost=float(np.asarray(merged.stats["cost"])),
            n_iter=state.version,
            cluster_sizes=np.asarray(merged.stats["counts"])[: self.k],
        )

    def _on_mesh(self, data, device, mesh):
        """``data`` as a DeviceDataset on ``device``, or over ``mesh``
        (``base.on_mesh``)."""
        return on_mesh(data, None, device, self.weight_col, mesh)

    def _sharded_lloyd(self, sds: ShardedDataset) -> _ShardedLloyd:
        return _ShardedLloyd(sds, self.k, self.distance_measure == "cosine")

    def _signature(self, d: int, k_pad: int, x, w, n_padded: int) -> dict | None:
        """The checkpoint signature, the reference's keys (``x`` / ``w``
        the prepared rows and weights: a tensor, or a row-sharded
        MeshArray fingerprinted over its global padded rows)."""
        if not self.checkpoint_dir:
            return None
        from ..io.fit_checkpoint import data_fingerprint

        return {
            "estimator": "KMeans", "k": self.k, "d": d,
            "k_pad": k_pad,
            "data": data_fingerprint(x, w),
            "n_padded": n_padded, "seed": self.seed,
            "init_mode": self.init_mode,
            "warm": self._warm_fingerprint(),
            "distance_measure": self.distance_measure, "tol": self.tol,
        }

    def _lloyd(self, step, centers, start_it: int, ckpt, on_iteration):
        """The Lloyd loop → (centers, last step): the reference's device
        loop (``move`` against tol² in float32) without a checkpoint or
        ``on_iteration``, else its host loop."""
        if ckpt is None and on_iteration is None:
            tol_sq = float(np.float32(self.tol * self.tol))
            it, move = 0, float("inf")
            while it < self.max_iter and move > tol_sq:
                centers, _, move_t = step(centers)
                move = float(move_t)
                it += 1
            return centers, it
        return self._host_loop(step, centers, start_it, ckpt, on_iteration)

    def fit(self, data, label_col: str | None = None, device=None,
            on_iteration=None, mesh=None) -> KMeansModel:
        """Fit on ``data`` (DeviceDataset, ShardedDataset, AssembledTable,
        (x, y[, w]) or x), moved to ``device`` (default the card) unless it
        already is a dataset; a :class:`HostDataset` streams its blocks to
        ``device``.  ``mesh`` lays the rows over its data axis and the
        centers over its model axis (a one-entry mesh is its device); a
        ShardedDataset fits on its own mesh, a HostDataset streams its blocks
        over ``mesh``.  ``on_iteration(it, cost, move)`` (optional) fires
        after every Lloyd step."""
        if self.init_mode not in ("k-means++", "random"):
            raise ValueError(f"unknown init_mode {self.init_mode!r}")
        if self.distance_measure not in DISTANCE_MEASURES:
            raise ValueError(f"unknown distance_measure {self.distance_measure!r}")
        validate_matmul_precision(self.matmul_precision)
        stats = self._stats_fn()
        if isinstance(data, HostDataset):
            return self._fit_outofcore(data, mesh, device, stats, on_iteration)
        ds = self._on_mesh(data, device, mesh)
        if isinstance(ds, ShardedDataset):
            return self._fit_sharded(ds, stats, on_iteration)
        dev = ds.x.device
        x = ds.x.to(torch.float32).contiguous()
        w = ds.w.to(torch.float32).contiguous()
        cosine = self.distance_measure == "cosine"
        if cosine:
            x = _cosine_prep(x, w)
        d = x.shape[1]
        k_pad = padded_slots(self.k, 1)

        ckpt, resumed = self._checkpointer(self._signature(d, k_pad, x, w, ds.n_padded))
        cen, start_it = self._start(resumed, d, k_pad,
                                    lambda: sample_valid_rows(DeviceDataset(x, ds.y, w),
                                                              self.init_sample_size, self.seed))
        centers = torch.from_numpy(cen).to(dev)
        c_valid = torch.from_numpy(slot_mask(self.k, k_pad)).to(dev)

        def step(cen):
            sums, counts, cost = stats([(x, w, cen, c_valid)])[0]
            new, move = _centroid_rule(sums, counts, cen, c_valid, cosine)
            return new, cost, move

        centers, it = self._lloyd(step, centers, start_it, ckpt, on_iteration)
        # final pass: cost/sizes describe the RETURNED centers
        _, counts, cost = fused_lloyd_stats(x, w, centers, c_valid)
        return self._model(centers, counts, cost, it)

    def _fit_sharded(self, sds: ShardedDataset, stats, on_iteration=None) -> KMeansModel:
        """The fit over a mesh: each Lloyd step is one sharded pass
        (:class:`_ShardedLloyd`) and one centroid rule on the home device;
        every process of a group runs the same steps on the same summed
        bits, so all stop together.  ``checkpoint_dir`` signs the prepared
        rows over their global padded indices and commits from the
        reference's host loop, so a resumed fit is the uninterrupted one."""
        lloyd = self._sharded_lloyd(sds)
        cosine = self.distance_measure == "cosine"
        d = sds.n_features
        ckpt, resumed = self._checkpointer(
            self._signature(d, lloyd.k_pad, lloyd.data.x, lloyd.data.w, sds.n_padded))
        cen, start_it = self._start(resumed, d, lloyd.k_pad,
                                    lambda: sample_valid_rows(lloyd.data, self.init_sample_size,
                                                              self.seed))
        centers = torch.from_numpy(cen).to(lloyd.home)
        c_valid = torch.from_numpy(slot_mask(self.k, lloyd.k_pad)).to(lloyd.home)

        def step(cen):
            sums, counts, cost = lloyd.stats(cen, stats)
            new, move = _centroid_rule(sums, counts, cen, c_valid, cosine)
            return new, cost, move

        centers, it = self._lloyd(step, centers, start_it, ckpt, on_iteration)
        # final pass (exact, K1): cost/sizes describe the RETURNED centers
        _, counts, cost = lloyd.stats(centers, lloyd_stats_model)
        return self._model(centers, counts, cost, it)

    def _fit_outofcore(self, hd: HostDataset, mesh, device, stats,
                       on_iteration=None) -> KMeansModel:
        """Rows ≫ device memory: each Lloyd step streams the blocks over
        ``mesh`` (or to ``device``), one sharded pass a block
        (:class:`_ShardedLloyd`: one K1 launch a data shard, K2 + K1 a
        (data, model) shard on a model axis), the statistics summed over
        the block's shards and then over the blocks, and one centroid
        update on the home device; device memory stays bounded by the
        block size.  The result matches the resident fit (bit-equal when
        the sums are exact, e.g. on integer-valued features)."""
        cosine = self.distance_measure == "cosine"
        d = hd.n_features
        sm = stream_mesh(mesh, device)
        k_pad = padded_slots(self.k, sm.shape[MODEL_AXIS])

        signature = None
        if self.checkpoint_dir:
            from ..io.fit_checkpoint import data_fingerprint

            signature = {
                "estimator": "KMeans", "storage": "outofcore",
                "k": self.k, "d": d, "k_pad": k_pad,
                "data": data_fingerprint(hd.x, hd.w),
                "n": hd.n, "seed": self.seed,
                "init_mode": self.init_mode,
                "warm": self._warm_fingerprint(),
                "distance_measure": self.distance_measure, "tol": self.tol,
            }
        ckpt, resumed = self._checkpointer(signature)
        cen, start_it = self._start(
            resumed, d, k_pad, lambda: hd.sample_rows(self.init_sample_size, self.seed))
        home = stream_home(sm)
        centers = torch.from_numpy(cen).to(home)
        c_valid = torch.from_numpy(slot_mask(self.k, k_pad)).to(home)
        c_valid_mesh = _PT.put("state/c_valid", slot_mask(self.k, k_pad), sm)

        def epoch(cen, stats_fn):
            tot = None
            for blk in hd.blocks(sm):
                s = _ShardedLloyd(blk, self.k, cosine, c_valid_mesh).stats(cen, stats_fn)
                tot = s if tot is None else add_stats(tot, s)
            if tot is None:
                raise ValueError("k-means fit on an empty dataset")
            return tot

        def step(cen):
            sums, counts, cost = epoch(cen, stats)
            new, move = _centroid_rule(sums, counts, cen, c_valid, cosine)
            return new, cost, move

        centers, it = self._host_loop(step, centers, start_it, ckpt, on_iteration)
        # final pass (exact, K1): cost/sizes describe the RETURNED centers
        _, counts, cost = epoch(centers, lloyd_stats_model)
        return self._model(centers, counts, cost, it)
