"""The model farm: per-tenant estimators over a leading tenant axis (the
JAX package's ``farm/farm.py``, on one device).

Stack every hospital's (tiny) dataset along a leading tenant axis —
ragged sizes padded with a weight mask, the contract every estimator here
already consumes — and fit all of them with one sequence of batched torch
ops on ``device`` (default the card).  A looped baseline pays one
sequence of launches per hospital; the farm pays one per fleet.

Families (the contract is "per-tenant sufficient statistics over the
tenant axis, masked convergence, stacked parameter arrays with a trailing
GLOBAL slot"):

* **linear** — per-tenant weighted least squares with Spark-style ridge
  (``reg_param`` scaled by tenant weight, intercept unpenalized) plus
  hierarchical partial pooling: ``pool`` acts as that many pseudo-rows of
  the pooled global fit, so a 3-row hospital lands near the global model
  while a 10k-row hospital keeps its own parameters.  The global (pooled,
  exact all-tenant WLS) fit comes from the same per-tenant Gram sums.
* **kmeans** — per-tenant Lloyd with masked convergence: a converged
  tenant's centers freeze while the rest keep iterating.  The global slot
  is a pooled-sample fit through the same step.

**The farm equals its looped baseline bit for bit, on any device, by
construction.**  A batched reduction and a single one need not agree
(their summation orders may change with the batch), so no statistic here
is a reduction whose order can depend on the tenant count T:

* every row's contribution (``w·x·xᵀ``, ``w·x·y``, a one-hot row of the
  Lloyd sums, ``w·min d²``) is an elementwise product, and the rows are
  summed by pairwise halving inside fixed chunks of :data:`ROW_CHUNK`
  rows, the chunk sums then added in row order (:func:`_row_sum`);
* sums over the feature axis (the distances, the linear predict) halve the
  same way (:func:`_halve`);
* the per-tenant solve is Gauss-Jordan in outer-product form — elementwise
  updates only, no batched LAPACK call (:func:`_posdef_solve`);
* the argmin takes the first index on ties and is exact in any order; no
  float atomics (``index_add_``) touch a statistic.

The looped baselines (:func:`_tenant_solve` and :func:`_farm_kmeans_loop`
on a one-tenant slice) are the same functions at T = 1.  The JAX package's masked ``lax.while_loop`` becomes a Python
loop that reads ``done.all()`` once every :data:`SYNC_EVERY` steps: a
converged tenant's centers freeze and ``n_iter`` counts only applied
steps, so steps after every tenant has converged change nothing.

Quality stance: NaN is MISSING, not wrong — a non-finite row gets weight
0 at pack time, an all-NaN tenant degrades to an empty tenant (global
parameters under pooling, zeros without), and nothing a single hospital
sends can poison the farm's sums.

Every model slice remains a first-class citizen: ``tenant_model(tid)``
materializes the ordinary ``LinearRegressionModel`` / ``KMeansModel``,
and the whole farm saves as ONE ``io/model_io`` artifact (the JAX
package's layout: either package loads the other's).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ..data import slot_mask, stack_ragged
from ..device import resolve_device
from ..io.model_io import register_model
from ..obs import trace as _trace
from ..obs.registry import cohort_label, global_registry
from ..quality.sketches import DataProfile, FeatureSketch
from .profiles import build_profile_stack, profile_of

#: distance of invalid centroids
_BIG = 1e30

#: base Tikhonov floor on every per-tenant solve — keeps a 1-row
#: hospital's rank-1 Gram solvable in f32 instead of returning garbage
_EPS = 1e-6

#: rows a chunk of the T-independent row sums (:func:`_row_sum`)
ROW_CHUNK = 64

#: Lloyd steps between the farm loop's reads of ``done.all()``
SYNC_EVERY = 4


def _next_pow2(n: int, floor: int | None = None) -> int:
    # floor=None → the registry's farm.pack.r_floor: the smallest
    # tenant-bucket R the farm pads fleets to (callers with a different
    # axis to pad — e.g. the tenant-count axis — pass their own floor)
    if floor is None:
        from ..tune import knob

        floor = int(knob("farm.pack.r_floor"))
    p = floor
    while p < n:
        p *= 2
    return p


# ==========================================================================
# Tenant packing: ragged per-hospital data → (T, R, d) + weight mask
# ==========================================================================


@dataclass
class TenantBatch:
    """Ragged per-tenant datasets stacked along a leading tenant axis.

    ``x``: (T, R, d) features, ``y``: (T, R) labels (zeros when absent),
    ``w``: (T, R) validity/sample weights (0 past each tenant's rows AND
    on rows carrying non-finite values), ``n_rows``: valid rows per
    tenant, ``masked_rows``: rows zero-weighted for non-finite values
    (the quality stance: missing, not fatal)."""

    tenant_ids: tuple[str, ...]
    x: np.ndarray
    y: np.ndarray
    w: np.ndarray
    n_rows: np.ndarray
    masked_rows: np.ndarray

    @property
    def n_tenants(self) -> int:
        return len(self.tenant_ids)

    @property
    def n_features(self) -> int:
        return self.x.shape[2]

    @property
    def pad_rows(self) -> int:
        return self.x.shape[1]


def pack_tenants(
    data: Mapping[str, Any],
    pad_to: int | None = None,
) -> TenantBatch:
    """Pack ``{tenant_id: x | (x, y) | (x, y, w)}`` into a
    :class:`TenantBatch` (host numpy).

    ``pad_to`` pins the row-padded length R (refits reuse the original
    farm's R); otherwise R is the next power of two ≥ the largest tenant,
    floored at the ``farm.pack.r_floor`` knob.  Rows with any non-finite
    value get weight 0 and are counted in ``masked_rows``."""
    items = [(str(t), v) for t, v in data.items()]
    ids = tuple(t for t, _ in items)
    if not ids:
        raise ValueError("pack_tenants needs at least one tenant")
    if len(set(ids)) != len(ids):
        raise ValueError("tenant ids collide after str() normalization")
    xs: list[np.ndarray] = []
    ys: list[np.ndarray] = []
    ws: list[np.ndarray] = []
    masked = np.zeros((len(ids),), dtype=np.int64)
    for i, (tid, v) in enumerate(items):
        if isinstance(v, tuple):
            xv = np.atleast_2d(np.asarray(v[0], dtype=np.float64))
            yv = (
                np.asarray(v[1], dtype=np.float64).reshape(-1)
                if len(v) > 1 and v[1] is not None
                else np.zeros((xv.shape[0],))
            )
            wv = (
                np.asarray(v[2], dtype=np.float64).reshape(-1)
                if len(v) > 2 and v[2] is not None
                else np.ones((xv.shape[0],))
            )
        else:
            xv = np.atleast_2d(np.asarray(v, dtype=np.float64))
            yv = np.zeros((xv.shape[0],))
            wv = np.ones((xv.shape[0],))
        if xv.shape[0] != yv.shape[0] or xv.shape[0] != wv.shape[0]:
            raise ValueError(
                f"tenant {tid!r}: x has {xv.shape[0]} rows, y "
                f"{yv.shape[0]}, w {wv.shape[0]}"
            )
        if np.any(wv < 0):
            raise ValueError(f"tenant {tid!r}: sample weights must be >= 0")
        finite = np.isfinite(xv).all(axis=1) & np.isfinite(yv)
        masked[i] = int(xv.shape[0] - finite.sum())
        wv = np.where(finite, wv, 0.0)
        xv = np.where(finite[:, None], xv, 0.0)  # inert under w=0
        yv = np.where(finite, yv, 0.0)
        xs.append(xv)
        ys.append(yv.reshape(-1, 1))
        ws.append(wv)
    d = xs[0].shape[1]
    for tid, xv in zip(ids, xs):
        if xv.shape[1] != d:
            raise ValueError(
                f"tenant {tid!r} has {xv.shape[1]} features, expected {d}"
            )
    max_rows = max(x.shape[0] for x in xs)
    R = pad_to if pad_to is not None else _next_pow2(max(max_rows, 1))
    x_stack, w_stack = stack_ragged(xs, ws, pad_to=R)
    y_stack, _ = stack_ragged(ys, None, pad_to=R)
    n_rows = np.array([int((wv > 0).sum()) for wv in ws], dtype=np.int64)
    return TenantBatch(
        tenant_ids=ids,
        x=x_stack,
        y=y_stack[:, :, 0],
        w=w_stack,
        n_rows=n_rows,
        masked_rows=masked,
    )


# ==========================================================================
# T-independent sums
# ==========================================================================


def _place_stack(arr, device: torch.device) -> torch.Tensor:
    """A tenant-stacked host array as float32 on ``device``.  (The JAX
    package places it through its partitioner's farm rules; on one device
    that is a plain move.)"""
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32)).to(device)


def _halve(p: torch.Tensor, dim: int) -> torch.Tensor:
    """Σ of ``p`` over ``dim`` by pairwise halving: elementwise adds whose
    order depends on that axis' length only, never on the other axes."""
    if p.shape[dim] == 0:
        return p.sum(dim)
    while p.shape[dim] > 1:
        n = p.shape[dim]
        h = n // 2
        s = p.narrow(dim, 0, h) + p.narrow(dim, h, h)
        if n % 2:
            s = torch.cat([s, p.narrow(dim, 2 * h, 1)], dim)
        p = s
    return p.squeeze(dim)


def _row_sum(part, r: int) -> torch.Tensor:
    """Σ over the row axis (dim 1) of ``part(lo, hi)`` — the (T, hi − lo,
    …) contributions of rows lo..hi — halved within chunks of
    :data:`ROW_CHUNK` rows, the chunk sums added in row order: the same
    order for every tenant count T."""
    total = None
    for lo in range(0, max(r, 1), ROW_CHUNK):
        s = _halve(part(lo, min(lo + ROW_CHUNK, r)), 1)
        total = s if total is None else total + s
    return total


# ==========================================================================
# Linear family
# ==========================================================================


def _linear_stats(xa, y, w):
    """Per-tenant WLS sufficient statistics on the (T, R, dd) augmented
    design: (Gram (T, dd, dd), moment (T, dd), Σw (T,)).  The one copy
    both the farm fit and the looped single-tenant baseline run."""
    xw = xa * w[..., None]
    r = xa.shape[1]
    gram = _row_sum(lambda lo, hi: xw[:, lo:hi, :, None] * xa[:, lo:hi, None, :], r)
    mom = _row_sum(lambda lo, hi: xw[:, lo:hi] * y[:, lo:hi, None], r)
    nt = _row_sum(lambda lo, hi: w[:, lo:hi], r)
    return gram, mom, nt


def _posdef_solve(a, b):
    """Gauss-Jordan solve for the (small, SPD) per-tenant systems, batched
    over any leading axes.

    Written in outer-product form — every operation is elementwise or a
    broadcast, with NO reductions — so a batched solve equals the
    single-tenant solve bit for bit (a batched LAPACK-style solve need
    not).  SPD systems need no pivoting; the caller guarantees a positive
    diagonal (ridge + ε floor)."""
    dd = a.shape[-1]
    idx = torch.arange(dd, device=a.device)
    for i in range(dd):
        piv = a[..., i, i]
        m = torch.where(idx != i, a[..., :, i] / piv[..., None], 0.0)
        a = a - m[..., :, None] * a[..., i, None, :]
        b = b - m * b[..., i, None]
    return b / torch.diagonal(a, dim1=-2, dim2=-1)


def _linear_solve(gram, mom, nt, reg, pool, theta_g, pen):
    """(Gram, moment) → θ with Spark-style ridge (``reg·Σw`` on the
    penalized dims) plus partial pooling: ``pool`` pseudo-rows of the
    global fit θ_g — solve (G + reg·Σw·diag(pen) + (pool+ε)I)θ =
    m + pool·θ_g.  An empty tenant (G = m = 0) lands on θ_g exactly as
    pool/(pool+ε) → θ_g."""
    dd = gram.shape[-1]
    eye = torch.eye(dd, dtype=gram.dtype, device=gram.device)
    a = gram + torch.diag_embed((reg * nt)[..., None] * pen) + (pool + _EPS) * eye
    return _posdef_solve(a, mom + pool * theta_g)


def _augment(x, fit_intercept: bool):
    if not fit_intercept:
        return x
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _linear_prologue(x, y, w, fit_intercept: bool):
    """The one copy of the linear fits' shared preamble (f32 cast,
    intercept augmentation, ridge-penalty mask with the intercept
    unpenalized) — fit, refit and the looped single-tenant baseline all
    run through it."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    w = w.to(torch.float32)
    xa = _augment(x, fit_intercept)
    pen = torch.ones((xa.shape[-1],), dtype=torch.float32, device=x.device)
    if fit_intercept:
        pen[x.shape[-1]:] = 0.0
    return xa, y, w, pen


def _scalar(v, device) -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def _route_index(col, g: int):
    """Tenant-index column → safe farm index: anything non-finite,
    negative, or past the GLOBAL slot routes to the GLOBAL slot — a
    malformed request must never be answered with some other hospital's
    private parameters.  The clip happens on the FLOAT (a float-to-int
    cast of a huge value is undefined), then the validity test."""
    raw = torch.nan_to_num(col, nan=-1.0, posinf=-1.0, neginf=-1.0)
    idx = torch.clamp(raw, -1.0, float(g)).to(torch.int64)
    return torch.where((idx >= 0) & (idx <= g), idx, g)


def _tenant_solve(x, y, w, reg, pool, theta_g, fit_intercept: bool):
    """The one copy of the linear solve, for any (T, R, d) tenant stack:
    per-tenant stats, then each tenant's shrinkage solve toward θ_g.
    ``theta_g=None`` (the farm fit) solves the pooled global fit from the
    same stats first; the masked refit passes the FROZEN global (a drifted
    subset must not drag every stable tenant's prior toward the drift),
    and the looped baseline passes it with a one-tenant slice.
    → (θ (T, dd), θ_g (dd,))."""
    xa, y, w, pen = _linear_prologue(x, y, w, fit_intercept)
    gram, mom, nt = _linear_stats(xa, y, w)
    if theta_g is None:
        zeros = torch.zeros((xa.shape[-1],), dtype=torch.float32, device=xa.device)
        theta_g = _linear_solve(
            _halve(gram, 0), _halve(mom, 0), _halve(nt, 0), reg,
            _scalar(0.0, xa.device), zeros, pen,
        )
    return _linear_solve(gram, mom, nt, reg, pool, theta_g, pen), theta_g


# ==========================================================================
# KMeans family
# ==========================================================================


def _sqdist(x, centers):
    """(T, n, d) rows × (T, k, d) centers → (T, n, k) squared distances as
    direct differences, summed over the features by halving."""
    diff = x[:, :, None, :] - centers[:, None, :, :]
    return _halve(diff * diff, 3)


def _kmeans_assign_stats(x, w, centers, c_valid):
    """Per-tenant Lloyd sufficient statistics on (T, R, d) rows × (T, k,
    d) centers: (sums (T, k, d), counts (T, k), cost (T,)).  Each chunk of
    rows is assigned (first index on ties) and its one-hot contributions
    summed by :func:`_row_sum` — one packed row of k·d + k + 1 values."""
    t, r, d = x.shape
    k = centers.shape[1]
    ks = torch.arange(k, device=x.device)

    def part(lo, hi):
        xs, ws = x[:, lo:hi], w[:, lo:hi]
        d2 = torch.where(c_valid[:, None, :] > 0, _sqdist(xs, centers), _BIG)
        mind, arg = d2.min(dim=2)
        oh = (arg[..., None] == ks).to(torch.float32) * ws[..., None]
        sums = (oh[..., None] * xs[:, :, None, :]).reshape(t, hi - lo, k * d)
        return torch.cat([sums, oh, (mind * ws)[..., None]], dim=2)

    packed = _row_sum(part, r)
    return (packed[:, : k * d].reshape(t, k, d), packed[:, k * d: k * d + k],
            packed[:, k * d + k])


def _kmeans_update(x, w, centers, c_valid):
    """One Lloyd update for every tenant → (new_centers, move²).  Empty
    clusters keep their previous center (Spark behavior, the same rule as
    ``models/kmeans._centroid_rule``)."""
    sums, counts, _ = _kmeans_assign_stats(x, w, centers, c_valid)
    new_centers = torch.where(
        (counts > 0)[..., None], sums / torch.clamp(counts, min=1.0)[..., None], centers
    )
    shift = new_centers - centers
    move = (_halve(shift * shift, 2) * c_valid).amax(dim=1)
    return new_centers, move


def _farm_kmeans_step(x, w, centers, c_valid, done, n_iter, tol_sq):
    """One masked farm Lloyd iteration: tenants not yet converged apply
    the update and count the iteration; converged tenants' centers stay
    frozen."""
    new_centers, move = _kmeans_update(x, w, centers, c_valid)
    apply = ~done
    centers = torch.where(apply[:, None, None], new_centers, centers)
    n_iter = n_iter + apply.to(torch.int32)
    done = done | (move <= tol_sq)
    return centers, done, n_iter


def _farm_kmeans_loop(x, w, centers, c_valid, max_iter: int, tol: float, *,
                      start_it: int = 1, done=None, n_iter=None, on_step=None):
    """The whole farm Lloyd trajectory: masked steps until every tenant
    has converged or ``max_iter`` steps ran.  ``done.all()`` is read once
    every :data:`SYNC_EVERY` steps (the steps in between change nothing
    once every tenant is done), and never past ``max_iter``.

    A resumed fit passes the committed ``centers``, ``done`` and ``n_iter``
    with ``start_it`` the step after the commit; ``on_step(it, centers,
    done, n_iter)`` runs after every step (the checkpointer's commit).
    → (centers, counts, cost, n_iter, host reads of ``done``)."""
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    t = x.shape[0]
    if done is None:
        done = torch.zeros((t,), dtype=torch.bool, device=x.device)
        n_iter = torch.zeros((t,), dtype=torch.int32, device=x.device)
    tol_sq = _scalar(float(tol) ** 2, x.device)
    reads = 0
    for it in range(start_it, max_iter + 1):
        centers, done, n_iter = _farm_kmeans_step(x, w, centers, c_valid, done, n_iter,
                                                  tol_sq)
        if on_step is not None:
            on_step(it, centers, done, n_iter)
        if it % SYNC_EVERY == 0 and it < max_iter:
            reads += 1
            if bool(done.all()):
                break
    # final stats pass: cost/sizes describe the RETURNED centers
    _, counts, cost = _kmeans_assign_stats(x, w, centers, c_valid)
    return centers, counts, cost, n_iter, reads


def _init_farm_centers(
    x: np.ndarray, w: np.ndarray, k: int, seed: int, base_index: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side per-tenant init: k distinct valid rows drawn from a
    per-tenant seeded stream (``[seed, base_index + t]`` — the fold
    keeps the draw identical whether the tenant is fit in the full farm,
    a looped baseline, or a refit subset).  Tenants with fewer than k
    valid rows get that many valid centers; empty tenants get none."""
    t_n, _, d = x.shape
    centers = np.zeros((t_n, k, d), dtype=np.float32)
    c_valid = np.zeros((t_n, k), dtype=np.float32)
    for t in range(t_n):
        valid = np.flatnonzero(w[t] > 0)
        if valid.size == 0:
            continue
        rng = np.random.default_rng([seed, base_index + t])
        take = min(k, valid.size)
        pick = rng.choice(valid, size=take, replace=False)
        centers[t, :take] = x[t, pick]
        c_valid[t, :take] = 1.0
    return centers, c_valid


def _to_host(*ts):
    return tuple(t.cpu().numpy() for t in ts)


# ==========================================================================
# The farm model (one artifact, every tenant + the global slot)
# ==========================================================================


@register_model("ModelFarmModel")
@dataclass(eq=False)  # array-holding dict fields make a generated __eq__
# ambiguous; identity comparison is the meaningful one for artifacts
class ModelFarmModel:
    """Every tenant's parameters stacked along a leading axis, with one
    extra trailing GLOBAL slot (index ``n_tenants``) holding the pooled
    model — the fallback slice unknown tenants route to.

    The serving contract is the repo's standard row-local function, with
    the tenant carried IN-BAND: requests are ``(batch, 1 + d)`` where
    column 0 is the farm index (``route_request`` prepends it from a
    tenant id) and the predict gathers each row's parameter slice on the
    rows' device — shape-bucketed by the serve layer like any other
    family.  ``fit_info`` (not saved) holds the fit's Lloyd steps and its
    host reads of the convergence flags (KMeans)."""

    family: str                       # "linear" | "kmeans"
    tenant_ids: tuple[str, ...]
    arrays: dict[str, np.ndarray]
    config: dict

    def __post_init__(self):
        self.tenant_ids = tuple(str(t) for t in self.tenant_ids)
        self._index = {t: i for i, t in enumerate(self.tenant_ids)}
        self._params_on: dict[str, tuple] = {}
        self._lock = threading.Lock()
        self.fit_info: dict = {}

    def __getstate__(self) -> dict:
        """Pickle the parameters, not the per-device tensor cache or the
        lock: a farm served on the card crosses a process boundary (the
        multi-process fleet's ``add_model``) as host arrays and rebuilds
        its cache where it is served next."""
        state = dict(self.__dict__)
        state.pop("_params_on", None)
        state.pop("_lock", None)
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._params_on = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ shape
    @property
    def n_tenants(self) -> int:
        return len(self.tenant_ids)

    @property
    def global_index(self) -> int:
        return self.n_tenants

    @property
    def d(self) -> int:
        return int(self.config["d"])

    @property
    def num_features(self) -> int:
        """d features + the in-band tenant-index column."""
        return self.d + 1

    def tenant_index(self, tenant_id: str, strict: bool = False) -> int:
        i = self._index.get(str(tenant_id))
        if i is None:
            if strict:
                raise KeyError(
                    f"unknown tenant {tenant_id!r} (farm has "
                    f"{self.n_tenants} tenants)"
                )
            return self.global_index
        return i

    # ------------------------------------------------------------ predict
    def _params(self, device: torch.device) -> tuple:
        """The family's stacked parameters as float32 on ``device``, moved
        there once."""
        key = str(device)
        with self._lock:
            p = self._params_on.get(key)
        if p is None:
            names = (("coefficients", "intercepts") if self.family == "linear"
                     else ("centers", "center_valid"))
            p = tuple(
                torch.from_numpy(np.ascontiguousarray(self.arrays[n], dtype=np.float32))
                .to(device) for n in names
            )
            with self._lock:
                self._params_on[key] = p
        return p

    def serving_predict_fn(self):
        """Row-local ``(batch, 1+d) tensor -> (batch,)`` predict on the
        rows' device: gather each row's tenant slice (column 0 = farm
        index; non-finite or out-of-range indices clamp to the GLOBAL
        slot), then the family rule on the remaining d feature columns —
        the linear dot product summed by halving, the KMeans distance as
        direct differences with the first index on ties."""
        if self.family not in ("linear", "kmeans"):  # from_artifacts validates
            raise ValueError(f"unknown farm family {self.family!r}")
        g = self.global_index
        linear = self.family == "linear"

        def fn(x):
            x = x.to(torch.float32)
            a, b = self._params(x.device)
            idx = _route_index(x[:, 0], g)
            f = x[:, 1:]
            if linear:
                return _halve(f * a[idx], 1) + b[idx]
            d2 = _sqdist(f[:, None, :], a[idx])[:, 0]
            d2 = torch.where(b[idx] > 0, d2, _BIG)
            return d2.min(dim=1).indices.to(torch.float32)

        return fn

    def predict(self, x, device=None) -> torch.Tensor:
        """In-band ``(n, 1+d)`` rows → (n,) predictions: a tensor runs
        where it lies, host rows on ``device`` (default the card)."""
        from ..models.base import check_features

        check_features(x, self.num_features, "ModelFarmModel")
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
            x = x.to(resolve_device(device))
        elif device is not None:
            x = x.to(resolve_device(device))
        return self.serving_predict_fn()(x)

    def route_request(self, tenant_id: str, x: np.ndarray) -> np.ndarray:
        """tenant id + (n, d) features → the (n, 1+d) in-band request the
        serve layer's bucket ladder consumes.  Unknown tenants route to
        the GLOBAL slot; the routed cohort is counted (bounded labels —
        obs.cohort_label, never one series per tenant)."""
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        idx = self.tenant_index(tenant_id)
        global_registry().inc(
            f'farm.requests{{cohort="{cohort_label(tenant_id)}"}}'
        )
        if idx == self.global_index and tenant_id not in self._index:
            global_registry().inc("farm.requests_unknown_tenant")
        return np.concatenate(
            [np.full((x.shape[0], 1), float(idx)), x], axis=1
        )

    def affinity_key(self, tenant_id) -> str:
        """The key the serving fleet's consistent-hash router sticks a
        tenant to — the SAME normalized id space ``tenant_index`` uses,
        so an int/np database key and its string form land on the same
        replica (and the same in-band farm slice)."""
        return str(tenant_id)

    def predict_tenant(self, tenant_id: str, x: np.ndarray, device=None) -> np.ndarray:
        """Host-side convenience: route + predict + fetch for one tenant on
        ``device`` (default the card); serving goes through ``serve/``
        instead, in the same routed form."""
        with _trace.span("farm.predict", {"cohort": cohort_label(tenant_id)}):
            xt = self.route_request(tenant_id, x)
            return self.predict(xt.astype(np.float32), device=device).cpu().numpy()

    # ------------------------------------------------------------ slices
    def tenant_model(self, tenant_id: str):
        """Materialize one tenant's slice as the ordinary family model —
        the farm is a packing, not a new estimator family."""
        i = self.tenant_index(tenant_id, strict=True)
        return self._slice_model(i)

    def global_model(self):
        """The pooled global slice (what unknown tenants answer with)."""
        return self._slice_model(self.global_index)

    def _slice_model(self, i: int):
        if self.family == "linear":
            from ..models.linear_regression import LinearRegressionModel

            return LinearRegressionModel(
                coefficients=torch.tensor(
                    np.asarray(self.arrays["coefficients"][i], np.float32)),
                intercept=torch.tensor(
                    np.asarray(self.arrays["intercepts"][i], np.float32)),
            )
        from ..models.kmeans import KMeansModel

        valid = self.arrays["center_valid"][i] > 0
        if not valid.any():
            raise ValueError(
                "tenant has no valid centers (empty tenant); predictions "
                "route to cluster 0 — there is no per-tenant model to slice"
            )
        return KMeansModel(
            cluster_centers=np.asarray(self.arrays["centers"][i][valid], np.float32),
            training_cost=float(self.arrays["costs"][i]),
            n_iter=int(self.arrays["n_iter"][i]),
            cluster_sizes=np.asarray(self.arrays["sizes"][i][valid]),
        )

    # ------------------------------------------------------------ profiles
    def tenant_profile(self, tenant_id: str) -> DataProfile:
        """The tenant's training-time feature sketches (the per-tenant
        drift reference), rebuilt from the stacked arrays."""
        i = self.tenant_index(tenant_id, strict=True)
        return profile_of(self.arrays, self.feature_names, i)

    @property
    def feature_names(self) -> tuple[str, ...]:
        return tuple(self.config["feature_names"])

    def live_profile(self) -> DataProfile:
        """An empty profile over the farm's shared reference edges — the
        live-side accumulator for PSI scoring."""
        edges = self.arrays["profile_edges"]
        names = self.feature_names
        return DataProfile(
            names=names,
            sketches={
                n: FeatureSketch(edges=edges[j].copy())
                for j, n in enumerate(names)
            },
        )

    # ------------------------------------------------------------ refit
    def refit(self, data: Mapping[str, Any], seed: int | None = None,
              device=None) -> "ModelFarmModel":
        """Masked refit of a tenant SUBSET (the drifted ones) on ``device``
        (default the card): repack just those tenants at the farm's
        original padded row length, refit them against the FROZEN global
        slot, and scatter the results into a new farm — every untouched
        tenant's parameters (and the global slot) are byte-identical to
        the old artifact's.

        The subset's tenant axis is padded to a power of two with inert
        zero-weight dummies, as the JAX package pads it."""
        data = {str(t): v for t, v in data.items()}
        ids = list(data)
        if not ids:
            return self
        dev = resolve_device(device)
        idx = np.array(
            [self.tenant_index(t, strict=True) for t in ids], dtype=np.int64
        )
        sp = _trace.span("farm.refit", {"tenants": len(ids)})
        with sp:
            max_rows = max(
                (np.atleast_2d(np.asarray(v[0] if isinstance(v, tuple) else v))
                 .shape[0])
                for v in data.values()
            )
            r_pad = max(
                int(self.config["pad_rows"]), _next_pow2(max(max_rows, 1))
            )
            batch = pack_tenants(data, pad_to=r_pad)
            s_pad = _next_pow2(len(ids), floor=2)
            x = np.zeros((s_pad, r_pad, self.d), np.float32)
            y = np.zeros((s_pad, r_pad), np.float32)
            w = np.zeros((s_pad, r_pad), np.float32)
            x[: len(ids)] = batch.x
            y[: len(ids)] = batch.y
            w[: len(ids)] = batch.w
            arrays = {k: v.copy() for k, v in self.arrays.items()}
            cfg = dict(self.config)
            if self.family == "linear":
                theta_g = np.concatenate(
                    [
                        arrays["coefficients"][self.global_index],
                        arrays["intercepts"][self.global_index: self.global_index + 1],
                    ]
                ) if cfg["fit_intercept"] else arrays["coefficients"][self.global_index]
                theta, _ = _tenant_solve(
                    _place_stack(x, dev), _place_stack(y, dev), _place_stack(w, dev),
                    _scalar(cfg["reg_param"], dev), _scalar(cfg["pool"], dev),
                    _place_stack(theta_g, dev), cfg["fit_intercept"],
                )
                theta = theta.cpu().numpy()[: len(ids)]
                d = self.d
                arrays["coefficients"][idx] = theta[:, :d]
                arrays["intercepts"][idx] = (
                    theta[:, d] if cfg["fit_intercept"] else 0.0
                )
            else:
                k = int(cfg["k"])
                centers0 = np.zeros((s_pad, k, self.d), np.float32)
                c_valid = np.zeros((s_pad, k), np.float32)
                for j, t_glob in enumerate(idx):
                    c, v = _init_farm_centers(
                        batch.x[j: j + 1], batch.w[j: j + 1], k,
                        int(cfg["seed"] if seed is None else seed),
                        base_index=int(t_glob),
                    )
                    centers0[j], c_valid[j] = c[0], v[0]
                cen, counts, cost, n_iter, _ = _farm_kmeans_loop(
                    _place_stack(x, dev), _place_stack(w, dev),
                    _place_stack(centers0, dev), _place_stack(c_valid, dev),
                    int(cfg["max_iter"]), float(cfg["tol"]),
                )
                cen, counts, cost, n_iter = (
                    a[: len(ids)] for a in _to_host(cen, counts, cost, n_iter))
                arrays["centers"][idx] = cen
                arrays["center_valid"][idx] = c_valid[: len(ids)]
                arrays["sizes"][idx] = counts
                arrays["costs"][idx] = cost
                arrays["n_iter"][idx] = n_iter
            # refreshed tenants get refreshed sketches (same shared edges
            # — profiles stay mergeable across the whole farm's history)
            prof = build_profile_stack(
                batch.x, batch.w, self.feature_names,
                edges=arrays["profile_edges"],
            )
            arrays["profile_counts"][idx] = prof["profile_counts"]
            arrays["profile_stats"][idx] = prof["profile_stats"]
            arrays["tenant_rows"][idx] = batch.n_rows
            arrays["masked_rows"][idx] = batch.masked_rows
            reg = global_registry()
            reg.inc("farm.refit_tenants", float(len(ids)))
            reg.inc("farm.refit_rows", float(batch.n_rows.sum()))
            if sp.trace_id is not None:
                sp.note("rows", int(batch.n_rows.sum()))
        return ModelFarmModel(
            family=self.family,
            tenant_ids=self.tenant_ids,
            arrays=arrays,
            config=cfg,
        )

    # ------------------------------------------------------------ persist
    def _artifacts(self):
        params = dict(self.config)
        params["family"] = self.family
        params["tenant_ids"] = list(self.tenant_ids)
        return "ModelFarmModel", params, dict(self.arrays)

    @classmethod
    def from_artifacts(cls, params, arrays):
        params = dict(params)
        family = params.pop("family")
        tenant_ids = tuple(params.pop("tenant_ids"))
        if family not in ("linear", "kmeans"):
            raise ValueError(f"unknown farm family {family!r}")
        return cls(
            family=family,
            tenant_ids=tenant_ids,
            arrays={k: np.asarray(v) for k, v in arrays.items()},
            config=params,
        )

    def save(self, path: str, overwrite: bool = True) -> None:
        from ..io.model_io import save_model

        name, meta, arrays = self._artifacts()
        save_model(path, name, meta, arrays, overwrite=overwrite)


# ==========================================================================
# Estimators
# ==========================================================================


def _common_config(batch: TenantBatch, feature_names, profile_bins) -> dict:
    names = (
        tuple(feature_names)
        if feature_names is not None
        else tuple(f"f{j}" for j in range(batch.n_features))
    )
    if len(names) != batch.n_features:
        raise ValueError(
            f"{len(names)} feature names for {batch.n_features} features"
        )
    return {
        "d": batch.n_features,
        "pad_rows": batch.pad_rows,
        "feature_names": list(names),
        "profile_bins": int(profile_bins),
    }


def _record_fit(sp, batch: TenantBatch, family: str) -> None:
    reg = global_registry()
    reg.inc("farm.fit_tenants", float(batch.n_tenants))
    reg.inc("farm.fit_rows", float(batch.n_rows.sum()))
    reg.set("farm.tenants", float(batch.n_tenants))
    if sp.trace_id is not None:
        sp.note("family", family)
        sp.note("tenants", batch.n_tenants)
        sp.note("rows", int(batch.n_rows.sum()))


@dataclass(frozen=True)
class FarmLinearRegression:
    """Per-hospital weighted least squares over the tenant axis.

    ``pool`` is the partial-pooling strength in pseudo-rows of the
    pooled global fit: 0 = fully independent per-tenant fits (the
    looped-baseline semantics), larger values shrink small hospitals
    toward the network-wide model (an empty hospital lands ON it).
    ``reg_param`` is Spark-style ridge on unstandardized coefficients
    (intercept unpenalized)."""

    reg_param: float = 0.0
    pool: float = 0.0
    fit_intercept: bool = True
    feature_names: Sequence[str] | None = None
    profile_bins: int = 16

    def fit(self, data: Mapping[str, Any] | TenantBatch, device=None) -> ModelFarmModel:
        """Fit every tenant on ``device`` (default the card)."""
        dev = resolve_device(device)
        batch = data if isinstance(data, TenantBatch) else pack_tenants(data)
        sp = _trace.span("farm.fit", {"family": "linear"})
        with sp:
            theta, theta_g = _to_host(*_tenant_solve(
                _place_stack(batch.x, dev), _place_stack(batch.y, dev),
                _place_stack(batch.w, dev),
                _scalar(self.reg_param, dev), _scalar(self.pool, dev),
                None, self.fit_intercept,
            ))
            d = batch.n_features
            stacked = np.concatenate([theta, theta_g[None, :]], axis=0)
            coef = stacked[:, :d].astype(np.float32)
            intercept = (
                stacked[:, d].astype(np.float32)
                if self.fit_intercept
                else np.zeros((stacked.shape[0],), np.float32)
            )
            cfg = _common_config(batch, self.feature_names, self.profile_bins)
            cfg.update(
                reg_param=float(self.reg_param), pool=float(self.pool),
                fit_intercept=bool(self.fit_intercept),
            )
            arrays = {
                "coefficients": coef,
                "intercepts": intercept,
                "tenant_rows": batch.n_rows.astype(np.int64),
                "masked_rows": batch.masked_rows.astype(np.int64),
            }
            arrays.update(
                build_profile_stack(
                    batch.x, batch.w, cfg["feature_names"],
                    bins=self.profile_bins,
                )
            )
            _record_fit(sp, batch, "linear")
        return ModelFarmModel(
            family="linear", tenant_ids=batch.tenant_ids,
            arrays=arrays, config=cfg,
        )


@dataclass(frozen=True)
class FarmKMeans:
    """Per-hospital k-means over the tenant axis: one masked loop fits
    every hospital's Lloyd trajectory simultaneously; the GLOBAL slot is
    a pooled-sample fit through the same step.

    ``checkpoint_dir`` commits the loop's state through ``io/fit_checkpoint``
    every ``checkpoint_every`` steps, so a preempted farm fit resumes from
    the last commit bit-identically instead of restarting the fleet."""

    k: int = 4
    max_iter: int = 20
    tol: float = 1e-4
    seed: int = 0
    global_sample: int = 8192
    feature_names: Sequence[str] | None = None
    profile_bins: int = 16
    checkpoint_dir: str | None = None
    checkpoint_every: int = 5

    def fit(self, data: Mapping[str, Any] | TenantBatch, device=None) -> ModelFarmModel:
        """Fit every tenant on ``device`` (default the card)."""
        dev = resolve_device(device)
        batch = data if isinstance(data, TenantBatch) else pack_tenants(data)
        sp = _trace.span("farm.fit", {"family": "kmeans"})
        with sp:
            model = self._fit_inner(batch, dev)
            _record_fit(sp, batch, "kmeans")
        return model

    def _fit_inner(self, batch: TenantBatch, dev: torch.device) -> ModelFarmModel:
        t_n, r_pad, d = batch.x.shape
        centers0, c_valid = _init_farm_centers(
            batch.x, batch.w, self.k, self.seed
        )
        x_dev = _place_stack(batch.x, dev)
        w_dev = _place_stack(batch.w, dev)
        cv_dev = _place_stack(c_valid, dev)

        resume = {}
        if self.checkpoint_dir:
            from ..io.fit_checkpoint import FitCheckpointer, data_fingerprint

            signature = {
                "estimator": "FarmKMeans", "T": t_n, "R": r_pad,
                "k": self.k, "d": d,
                "data": data_fingerprint(
                    batch.x.reshape(-1, d), batch.w.reshape(-1)
                ),
                "seed": self.seed, "tol": self.tol,
            }
            ckpt = FitCheckpointer(self.checkpoint_dir, signature)
            every = max(self.checkpoint_every, 1)

            def commit(it, cen, done, n_iter):
                # iteration-boundary commits: a resume replays exactly
                if it % every == 0:
                    ckpt.save(it, {
                        "centers": cen.cpu().numpy(),
                        "done": done.cpu().numpy().astype(np.uint8),
                        "n_iter": n_iter.cpu().numpy(),
                    })

            resume["on_step"] = commit
            resumed = ckpt.resume()
            if resumed is not None:
                step0, arrs, _ = resumed
                centers0 = arrs["centers"]
                resume.update(
                    start_it=step0 + 1,
                    done=torch.from_numpy(arrs["done"].astype(bool)).to(dev),
                    n_iter=torch.from_numpy(arrs["n_iter"].astype(np.int32)).to(dev),
                )

        cen, counts, cost, n_iter, reads = _farm_kmeans_loop(
            x_dev, w_dev, _place_stack(centers0, dev), cv_dev,
            self.max_iter, self.tol, **resume,
        )
        cen, counts, cost, n_iter = _to_host(cen, counts, cost, n_iter)

        # global slot: pooled-sample fit through the SAME step (T=1)
        g_cen, g_valid, g_counts, g_cost, g_iter = self._fit_global(batch, dev)
        cfg = _common_config(batch, self.feature_names, self.profile_bins)
        cfg.update(
            k=int(self.k), max_iter=int(self.max_iter), tol=float(self.tol),
            seed=int(self.seed),
        )
        arrays = {
            "centers": np.concatenate([cen, g_cen[None]], axis=0),
            "center_valid": np.concatenate([c_valid, g_valid[None]], axis=0),
            "sizes": np.concatenate([counts, g_counts[None]], axis=0),
            "costs": np.concatenate(
                [cost, np.float32(g_cost)[None]], axis=0
            ).astype(np.float32),
            "n_iter": np.concatenate(
                [n_iter, np.int32(g_iter)[None]], axis=0
            ).astype(np.int32),
            "tenant_rows": batch.n_rows.astype(np.int64),
            "masked_rows": batch.masked_rows.astype(np.int64),
        }
        arrays.update(
            build_profile_stack(
                batch.x, batch.w, cfg["feature_names"], bins=self.profile_bins
            )
        )
        model = ModelFarmModel(
            family="kmeans", tenant_ids=batch.tenant_ids,
            arrays=arrays, config=cfg,
        )
        model.fit_info = {"steps": int(n_iter.max()) if n_iter.size else 0,
                          "done_reads": reads}
        return model

    def _fit_global(self, batch: TenantBatch, dev: torch.device):
        """Pooled-sample k-means for the GLOBAL slot (unknown-tenant
        fallback): a bounded uniform sample of valid rows across every
        tenant, fit through the same loop at T=1."""
        valid = batch.w.reshape(-1) > 0
        pool_rows = batch.x.reshape(-1, batch.n_features)[valid]
        if pool_rows.shape[0] == 0:
            k = self.k
            return (
                np.zeros((k, batch.n_features), np.float32),
                np.zeros((k,), np.float32),
                np.zeros((k,), np.float32),
                0.0, 0,
            )
        rng = np.random.default_rng([self.seed, batch.n_tenants])
        if pool_rows.shape[0] > self.global_sample:
            pick = rng.choice(
                pool_rows.shape[0], size=self.global_sample, replace=False
            )
            pool_rows = pool_rows[np.sort(pick)]
        r_g = _next_pow2(pool_rows.shape[0])
        xg = np.zeros((1, r_g, batch.n_features), np.float32)
        xg[0, : pool_rows.shape[0]] = pool_rows
        wg = slot_mask(pool_rows.shape[0], r_g)[None, :]
        c0, cv = _init_farm_centers(
            xg, wg, self.k, self.seed, base_index=batch.n_tenants
        )
        cen, counts, cost, n_iter, _ = _farm_kmeans_loop(
            _place_stack(xg, dev), _place_stack(wg, dev), _place_stack(c0, dev),
            _place_stack(cv, dev), self.max_iter, self.tol,
        )
        cen, counts, cost, n_iter = _to_host(cen, counts, cost, n_iter)
        return cen[0], cv[0], counts[0], float(cost[0]), int(n_iter[0])
