"""KMeans — the north-star workload: k=256 Lloyd on one CUDA device.

The resident Euclidean fit of the JAX package's ``models/kmeans.py``,
step for step:

- k-means++ init on a host sample of valid rows, copied unchanged, so
  the same seed gives bit-equal init centers;
- each Lloyd step is one launch of the K1 kernel (``ops/lloyd.py``)
  followed by the centroid rule: empty clusters keep their center, and
  ``move`` is the largest squared shift over valid centers;
- the loop stops when ``move <= tol²`` (a float32 comparison, as in the
  reference's device loop) or after ``max_iter`` steps;
- one more exact stats pass on the returned centers gives
  ``training_cost`` and ``cluster_sizes``.

The loop syncs the host on ``move`` once per step.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..data import DeviceDataset, pad_slots, padded_slots, sample_valid_rows, slot_mask
from ..io.model_io import register_model
from ..ops.lloyd import fused_assign, fused_lloyd_stats
from .base import ClusteringModel, Estimator, as_device_dataset, check_features
from .summary import ClusteringSummary


def _centroid_rule(sums, counts, centers, c_valid):
    """Empty clusters keep their previous center (Spark behavior)."""
    new_centers = torch.where(
        (counts > 0)[:, None],
        sums / torch.clamp(counts, min=1.0)[:, None],
        centers,
    )
    move = (((new_centers - centers) ** 2).sum(dim=1) * c_valid).max()
    return new_centers, move


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


@register_model("KMeansModel")
@dataclass
class KMeansModel(ClusteringModel):
    cluster_centers: np.ndarray          # (k, d)
    distance_measure: str = "euclidean"
    training_cost: float = 0.0           # final inertia (Spark trainingCost)
    n_iter: int = 0
    cluster_sizes: np.ndarray | None = None

    def __post_init__(self):
        if self.distance_measure != "euclidean":
            raise ValueError(
                f"distance_measure={self.distance_measure!r}: the port serves "
                "euclidean KMeans only"
            )
        self._centers_on: dict[str, torch.Tensor] = {}

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

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """(n, d) tensor → (n,) int32 cluster indices on x's device (the K2
        kernel on the card)."""
        check_features(x, self.cluster_centers.shape[1], type(self).__name__)
        c_valid = torch.ones((self.k,), dtype=torch.float32, device=x.device)
        return fused_assign(
            x.to(torch.float32).contiguous(), self._centers(x.device), c_valid
        )[0]

    def compute_cost(self, data, device=None) -> float:
        """Sum of weighted squared distances to the nearest center."""
        ds = as_device_dataset(data, device=device)
        centers = self._centers(ds.x.device)
        c_valid = torch.ones((self.k,), dtype=torch.float32, device=ds.x.device)
        _, mind2 = fused_assign(ds.x, centers, c_valid)
        return float((mind2 * ds.w).sum())

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
    init_sample_size: int = 65536

    def _init_from_sample(self, valid: np.ndarray) -> np.ndarray:
        """(sample of valid rows) → (k, d) start centers."""
        if valid.shape[0] == 0:
            raise ValueError("k-means fit on an empty dataset")
        rng = np.random.default_rng(self.seed)
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

    def _init_centers(self, ds: DeviceDataset) -> np.ndarray:
        return self._init_from_sample(
            sample_valid_rows(ds, self.init_sample_size, self.seed)
        )

    def fit(self, data, label_col: str | None = None, device=None) -> KMeansModel:
        """Fit on ``data`` (DeviceDataset, AssembledTable, (x, y[, w]) or
        x), moved to ``device`` (default the card) unless it already is a
        DeviceDataset."""
        if self.init_mode not in ("k-means++", "random"):
            raise ValueError(f"unknown init_mode {self.init_mode!r}")
        ds = as_device_dataset(data, device=device)
        dev = ds.x.device
        x = ds.x.to(torch.float32).contiguous()
        w = ds.w.to(torch.float32).contiguous()
        k_pad = padded_slots(self.k, 1)
        centers0 = self._init_centers(DeviceDataset(x, ds.y, w))
        centers = torch.from_numpy(pad_slots(centers0, k_pad)).to(dev)
        c_valid = torch.from_numpy(slot_mask(self.k, k_pad)).to(dev)

        tol_sq = float(np.float32(self.tol * self.tol))
        it, move = 0, float("inf")
        while it < self.max_iter and move > tol_sq:
            sums, counts, _ = fused_lloyd_stats(x, w, centers, c_valid)
            centers, move_t = _centroid_rule(sums, counts, centers, c_valid)
            move = float(move_t)
            it += 1
        # final pass: cost/sizes describe the RETURNED centers
        _, counts, cost = fused_lloyd_stats(x, w, centers, c_valid)
        return KMeansModel(
            cluster_centers=centers.cpu().numpy()[: self.k],
            training_cost=float(cost),
            n_iter=it,
            cluster_sizes=counts.cpu().numpy()[: self.k],
        )
