"""ALS — collaborative filtering (the JAX package's ``models/als.py``;
``pyspark.ml.recommendation.ALS``).

Alternating least squares over (user, item, rating) triplets, explicit
(ALS-WR, Zhou et al. — Spark's default: per-row regularization scaled by
the rating count) and implicit preference (Hu-Koren confidence weighting,
Spark's ``implicitPrefs=True``), as dense batched linear algebra on
``device`` (default the card):

- Ratings are grouped per user (then per item) into COUNT-CAPPED padded
  buckets (:func:`_group_ratings_bucketed`, on the host): rows are binned
  by rating count into power-of-4 caps, each bucket a dense ``(U_b, C_b)``
  index/rating/mask block, so total padded cells stay ≤ 4× nnz.
- One half-step gathers the opposite factors ``Y[idx] -> (U_b, C_b, f)``,
  builds every row's normal equations with two batched products
  (``A_u = Σ m·y yᵀ + λ n_u I``, ``b_u = Σ m r y``) and solves each
  bucket's rows at once with one batched ``torch.linalg.solve_ex`` (no
  host sync).  Products run in float32 with TF32 off (``device.py``).
- Implicit mode follows Hu-Koren: ``A_u = YᵀY + Σ α r yᵀy + λI``,
  ``b_u = Σ (1 + α r) y`` over OBSERVED items only, with the dense
  ``YᵀY`` term computed once per half-step.

The factors stay on the device across iterations; the index/rating
blocks are built once on the host and moved once.  Over a mesh
(``fit(..., mesh=)``) each bucket of at least D rows (D data shards) is
zero-padded to a multiple of the data axis and split over it: each shard
solves its own rows' normal equations against the opposite factors sent
to its device.  A smaller bucket (the heavy tail) is solved once, on the
home device.  The solved rows are written back into the one factor
matrix on the home device, in row order (one gather a bucket under a
process group).  Every row's system is its own, so a sharded fit gives
the one-device factors.  ``predict`` is host
numpy, as in the JAX package; ``recommend_*`` score on ``device`` with
one product and take the top k in ``lax.top_k``'s order (ties to the
lower index).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..io.model_io import register_model
from ..parallel.collectives import gather_shards
from ..parallel.sharding import pad_block_host, pad_rows
from .base import Estimator, Model


def _group_ratings(ids: np.ndarray, other: np.ndarray, ratings: np.ndarray, n: int):
    """Single padded (n, C) layout with C = the max count — the ORACLE
    layout (tests drive the half-step solvers with it directly); the
    production fit uses :func:`_group_ratings_bucketed`, of which this is
    the one-bucket-per-row scatter."""
    counts = np.bincount(ids, minlength=n) if len(ids) else np.zeros(n, np.int64)
    c = max(int(counts.max()), 1) if len(ids) else 1
    idx = np.zeros((n, c), np.int32)
    val = np.zeros((n, c), np.float32)
    msk = np.zeros((n, c), np.float32)
    for rows, bidx, bval, bmsk, _ in _group_ratings_bucketed(ids, other, ratings, n):
        w = bidx.shape[1]
        idx[rows, :w] = bidx
        val[rows, :w] = bval
        msk[rows, :w] = bmsk
    return idx, val, msk, counts.astype(np.float32)


#: smallest bucket cap and cap growth factor for the count-capped padding
#: (powers of _BUCKET_FACTOR from _BUCKET_BASE): every row's padded width
#: is < _BUCKET_FACTOR × its true count (or _BUCKET_BASE for tiny rows),
#: so total padded cells are bounded by max(_BUCKET_BASE, _BUCKET_FACTOR)
#: × nnz — one power-law user can no longer inflate every row to its C.
_BUCKET_BASE = 4
_BUCKET_FACTOR = 4


def _bucket_caps(max_count: int) -> list[int]:
    caps, c = [], _BUCKET_BASE
    while c < max_count:
        caps.append(c)
        c *= _BUCKET_FACTOR
    caps.append(max(max_count, _BUCKET_BASE))
    return caps


def _group_ratings_bucketed(
    ids: np.ndarray, other: np.ndarray, ratings: np.ndarray, n: int
):
    """Triplets grouped by ``ids`` → COUNT-CAPPED padded buckets.

    VERDICT r4 #3's scalability cliff: a single (n, C) layout takes C from
    the heaviest row, so one user with 10⁴ ratings inflates the whole
    (n, C, f) gather ~10³×.  Rows are instead binned by rating count into
    power-of-:data:`_BUCKET_FACTOR` caps; each bucket is its own dense
    (U_b, C_b) problem with the SAME batched-Cholesky half-step, and the
    per-bucket shapes are what jit specializes on (few buckets — cap
    growth is geometric).  → list of (row_ids, idx, val, msk, counts)."""
    counts = np.bincount(ids, minlength=n)
    order = np.argsort(ids, kind="stable")
    sid = ids[order]
    soth = other[order]
    sval = ratings[order]
    starts = np.r_[0, np.cumsum(counts)[:-1]]
    pos_all = np.arange(len(sid)) - starts[sid]

    out = []
    prev = 0
    for cap in _bucket_caps(int(counts.max()) if len(ids) else 1):
        rows = np.flatnonzero((counts > prev) & (counts <= cap))
        prev = cap
        if rows.size == 0:
            continue
        local = np.full(n, -1, np.int64)
        local[rows] = np.arange(rows.size)
        in_b = local[sid] >= 0
        lr = local[sid[in_b]]
        pos = pos_all[in_b]
        idx = np.zeros((rows.size, cap), np.int32)
        val = np.zeros((rows.size, cap), np.float32)
        msk = np.zeros((rows.size, cap), np.float32)
        idx[lr, pos] = soth[in_b]
        val[lr, pos] = sval[in_b]
        msk[lr, pos] = 1.0
        out.append((rows, idx, val, msk, counts[rows].astype(np.float32)))
    return out


def _nnls_cd(a, b, rank: int, sweeps: int = 60):
    """Batched non-negative least squares: minimize ½xᵀAx − bᵀx s.t.
    x ≥ 0 for every row's (A, b) at once, by projected cyclic coordinate
    descent — Spark's ``nonnegative=True`` runs a per-user NNLS; here each
    sweep is ``rank`` vectorized (n,)-wide updates, one Python step each
    (launch-bound: a few launches an update).  A is PD (λ·n_u·I ridge), so
    CD converges to the unique constrained optimum; the warm start is the
    clipped unconstrained solve."""
    diag = torch.clamp(torch.diagonal(a, dim1=1, dim2=2), min=1e-12)  # (n, f)
    x = torch.clamp(torch.linalg.solve_ex(a, b[..., None])[0][..., 0], min=0.0)
    for _ in range(sweeps):
        for f in range(rank):
            resid = b[:, f] - torch.einsum("nr,nr->n", a[:, f, :], x) + diag[:, f] * x[:, f]
            x[:, f] = torch.clamp(resid / diag[:, f], min=0.0)
    return x


def _solve(a, lam, b, rank: int, nonnegative: bool):
    """Add the ridge ``lam`` to every (f, f) system and solve it."""
    a = a + lam[:, None, None] * torch.eye(rank, dtype=a.dtype, device=a.device)[None]
    if nonnegative:
        return _nnls_cd(a, b, rank)
    return torch.linalg.solve_ex(a, b[..., None])[0][..., 0]


def _solve_explicit(y, idx, val, msk, cnt, reg: float, rank: int, nonnegative: bool = False):
    """ALS-WR half-step: solve every row's (A, b) at once.

    y: (m, f) opposite factors; idx/val/msk: (n, C); cnt: (n,)
    A_u = Σ_c m·y yᵀ + λ·n_u·I  (λ·n_u — Spark's ALS-WR scaling)
    """
    g = y[idx]                                       # (n, C, f)
    gm = g * msk[..., None]
    a = torch.einsum("ncf,ncg->nfg", gm, g)          # (n, f, f)
    b = torch.einsum("ncf,nc->nf", gm, val)          # (n, f)
    lam = reg * torch.clamp(cnt, min=1.0)
    return _solve(a, lam, b, rank, nonnegative)


def _solve_implicit(y, yty, idx, val, msk, reg: float, alpha: float, rank: int,
                    nonnegative: bool = False):
    """Hu-Koren half-step: confidence c = 1 + α·r on observed pairs, all
    unobserved pairs carry preference 0 at confidence 1 — absorbed by the
    dense YᵀY term so only observed items enter the batched sums.
    ``yty`` is computed ONCE per half-step by the caller (shared across
    the count buckets).  Regularization scales by the per-row count of
    POSITIVE ratings (Spark's ``numExplicits · regParam``)."""
    g = y[idx]                                        # (n, C, f)
    conf_extra = alpha * val * msk                    # c − 1 on observed
    a = yty[None] + torch.einsum("ncf,ncg->nfg", g * conf_extra[..., None], g)
    pref = (val > 0).to(y.dtype) * msk
    n_pos = torch.sum(pref, dim=1)
    lam = reg * torch.clamp(n_pos, min=1.0)
    b = torch.einsum("ncf,nc->nf", g, pref * (1.0 + alpha * val))
    return _solve(a, lam, b, rank, nonnegative)


def _stage_buckets(buckets, dev, mesh=None):
    """Host buckets → tensors, staged once before the loop (indices as
    int64, the type torch indexes with) → ``[(rows on dev, {part: (idx,
    val, msk, cnt)})]``.  On one device (``mesh`` None or of one data
    shard), or for a bucket of fewer rows than data shards, the one part
    ``None`` is the whole bucket on ``dev``.  Otherwise the bucket is
    zero-padded to a multiple of the data axis (pad rows: mask 0, count 0,
    solved to 0 and dropped) and part ``i`` is shard i's contiguous rows on
    its device, for every local data shard."""
    D = 1 if mesh is None else mesh.devices.shape[0]
    out = []
    for rows, *arrs in buckets:
        arrs = [a.astype(np.int64) if a.dtype.kind == "i" else a for a in arrs]
        r = torch.from_numpy(rows.astype(np.int64)).to(dev)
        if D == 1 or rows.size < D:
            out.append((r, {None: tuple(torch.from_numpy(a).to(dev) for a in arrs)}))
            continue
        per = pad_rows(rows.size, D) // D
        padded = [pad_block_host(a, per * D, a.dtype) for a in arrs]
        out.append((r, {i: tuple(torch.from_numpy(a[i * per:(i + 1) * per]).to(mesh.device(i, 0))
                                 for a in padded)
                        for i in mesh.local_data_shards()}))
    return out


#: score rows a chunk of ``recommend_*``: the (rows, targets) float32
#: scores and their sort stay near 2**26 elements whatever the catalogue
_RECS_CHUNK_ELEMS = 1 << 26


@register_model("ALSModel")
@dataclass
class ALSModel(Model):
    user_factors: np.ndarray      # (num_users, rank)
    item_factors: np.ndarray      # (num_items, rank)
    # ids seen at fit time (Spark's coldStartStrategy decides the rest)
    cold_start_strategy: str = "nan"

    @property
    def rank(self) -> int:
        return self.user_factors.shape[1]

    def predict(self, user_ids, item_ids) -> np.ndarray:
        """Per-pair predicted ratings; unseen ids follow
        ``cold_start_strategy``: "nan" marks them NaN, "drop" removes the
        pairs (Spark's two strategies)."""
        u = np.asarray(user_ids, np.int64)
        i = np.asarray(item_ids, np.int64)
        if u.shape != i.shape:
            raise ValueError(f"user/item id shapes differ: {u.shape} vs {i.shape}")
        known = (
            (u >= 0) & (u < self.user_factors.shape[0])
            & (i >= 0) & (i < self.item_factors.shape[0])
        )
        uf = self.user_factors[np.clip(u, 0, self.user_factors.shape[0] - 1)]
        vf = self.item_factors[np.clip(i, 0, self.item_factors.shape[0] - 1)]
        pred = np.einsum("nf,nf->n", uf, vf)
        if self.cold_start_strategy == "drop":
            return pred[known]
        pred = pred.astype(np.float64)
        pred[~known] = np.nan
        return pred


    @staticmethod
    def _top_k_recs(query_factors, target_factors, k: int, device=None):
        """One copy of the recommend body — (query, f) @ (f, T) scores on
        ``device`` (default the card), the top k over targets in
        ``lax.top_k``'s order: descending, ties to the lower index (a
        stable descending sort; ``torch.topk`` promises no order among
        ties).  Shared by the all-/subset- user/item calls so their
        rankings are identical by construction."""
        dev = resolve_device(device)
        q = torch.as_tensor(np.asarray(query_factors, np.float32), device=dev)
        t = torch.as_tensor(np.asarray(target_factors, np.float32), device=dev)
        k = min(k, t.shape[0])
        rows = max(1, _RECS_CHUNK_ELEMS // max(t.shape[0], 1))
        ids, top = [], []
        for s in range(0, q.shape[0], rows):
            # + 0.0 turns -0.0 into +0.0: the two compare equal (a tie for
            # lax.top_k), but a radix sort orders them
            scores = q[s:s + rows] @ t.T + 0.0
            val, idx = torch.sort(scores, dim=1, descending=True, stable=True)
            ids.append(idx[:, :k].to(torch.int32))
            top.append(val[:, :k])
        if not ids:
            return np.zeros((0, k), np.int32), np.zeros((0, k), np.float32)
        return torch.cat(ids).cpu().numpy(), torch.cat(top).cpu().numpy()

    def recommend_for_all_users(self, num_items: int, device=None):
        """→ (item ids (U, k), scores (U, k)) — one product + the top k,
        on ``device`` (default the card)."""
        return self._top_k_recs(self.user_factors, self.item_factors, num_items, device)

    def recommend_for_all_items(self, num_users: int, device=None):
        return self._top_k_recs(self.item_factors, self.user_factors, num_users, device)

    def recommend_for_user_subset(self, user_ids, num_items: int, device=None):
        """Spark's ``recommendForUserSubset``: top items for the GIVEN
        users only → (item ids (len(user_ids), k), scores).  Unknown ids
        raise (the Spark call joins on known ids; a silent clip would
        return another user's recommendations)."""
        u = self._check_subset_ids(user_ids, self.user_factors.shape[0], "user")
        return self._top_k_recs(self.user_factors[u], self.item_factors, num_items, device)

    def recommend_for_item_subset(self, item_ids, num_users: int, device=None):
        """Spark's ``recommendForItemSubset``: top users for the GIVEN
        items only."""
        i = self._check_subset_ids(item_ids, self.item_factors.shape[0], "item")
        return self._top_k_recs(self.item_factors[i], self.user_factors, num_users, device)

    @staticmethod
    def _check_subset_ids(ids, bound: int, kind: str) -> np.ndarray:
        out = np.asarray(ids, np.int64).reshape(-1)
        bad = (out < 0) | (out >= bound)
        if bad.any():
            raise ValueError(
                f"unknown {kind} id(s) {out[bad][:5].tolist()} — fit saw "
                f"{kind} ids 0..{bound - 1}"
            )
        return out

    def _artifacts(self):
        return (
            "ALSModel",
            {"cold_start_strategy": self.cold_start_strategy},
            {
                "user_factors": np.asarray(self.user_factors),
                "item_factors": np.asarray(self.item_factors),
            },
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(
            user_factors=arrays["user_factors"],
            item_factors=arrays["item_factors"],
            cold_start_strategy=params.get("cold_start_strategy", "nan"),
        )


@dataclass(frozen=True)
class ALS(Estimator):
    """Spark defaults: rank 10, maxIter 10, regParam 0.1, alpha 1.0,
    implicitPrefs False, nonnegative False, coldStartStrategy "nan".
    ``nonnegative=True`` solves each half-step's normal equations under
    x ≥ 0 (Spark's NNLS solver) via batched projected coordinate descent
    — see :func:`_nnls_cd`."""

    rank: int = 10
    max_iter: int = 10
    reg_param: float = 0.1
    implicit_prefs: bool = False
    alpha: float = 1.0
    seed: int = 0
    cold_start_strategy: str = "nan"
    nonnegative: bool = False

    def fit(self, ratings, label_col: str | None = None, device=None, mesh=None) -> ALSModel:
        """``ratings``: (user, item, rating) as a 3-tuple of arrays, an
        (n, 3) array, or a Table with user/item/rating columns; the
        half-steps run on ``device`` (default the card), or over ``mesh``:
        each bucket of at least D rows split over its data shards
        (:func:`_stage_buckets`), the factors on its home device."""
        from ..parallel.outofcore import stream_home, stream_mesh

        if self.cold_start_strategy not in ("nan", "drop"):
            raise ValueError(
                f"cold_start_strategy must be nan|drop, got "
                f"{self.cold_start_strategy!r}"
            )
        dev = stream_home(stream_mesh(mesh, device))
        users, items, vals = self._coerce(ratings)
        if len(users) == 0:
            raise ValueError("ALS fit on an empty rating set")
        if self.implicit_prefs and (vals < 0).any():
            raise ValueError("implicit_prefs=True needs non-negative ratings")
        n_users = int(users.max()) + 1
        n_items = int(items.max()) + 1

        u_buckets = _stage_buckets(_group_ratings_bucketed(users, items, vals, n_users), dev,
                                   mesh)
        i_buckets = _stage_buckets(_group_ratings_bucketed(items, users, vals, n_items), dev,
                                   mesh)

        rng = np.random.default_rng(self.seed)
        # Spark seeds factors with scaled |N(0,1)|-ish draws; scale keeps
        # initial predictions O(mean rating)
        scale = 1.0 / np.sqrt(self.rank)
        uf = rng.normal(0, scale, size=(n_users, self.rank)).astype(np.float32)
        vf = rng.normal(0, scale, size=(n_items, self.rank)).astype(np.float32)
        if self.nonnegative:
            # Spark seeds |N| draws for NNLS — a first half-step against
            # mixed-sign factors would start CD from a meaningless corner
            uf, vf = np.abs(uf), np.abs(vf)
        # rows with no ratings are never solved; zero them like the solver
        # does (λI a, 0 b → 0), so id gaps keep the pre-bucketing behavior
        uf[np.bincount(users, minlength=n_users) == 0] = 0.0
        vf[np.bincount(items, minlength=n_items) == 0] = 0.0
        uf, vf = torch.from_numpy(uf).to(dev), torch.from_numpy(vf).to(dev)
        reg = float(np.float32(self.reg_param))
        alpha = float(np.float32(self.alpha))

        for _ in range(self.max_iter):
            self._half_step(vf, u_buckets, uf, reg, alpha, mesh)
            self._half_step(uf, i_buckets, vf, reg, alpha, mesh)
        return ALSModel(
            user_factors=uf.cpu().numpy(),
            item_factors=vf.cpu().numpy(),
            cold_start_strategy=self.cold_start_strategy,
        )

    def _half_step(self, y, buckets, out, reg: float, alpha: float, mesh=None) -> None:
        """Solve every count bucket against ``y`` (sent once to each device
        a part lies on) and write the results into ``out``'s rows: a split
        bucket's parts in data-shard order (``collectives.gather_shards``),
        its pad rows dropped."""
        yty = (y.T @ y) if self.implicit_prefs else None
        on: dict = {}
        for rows, parts in buckets:
            solved: dict = {}
            for i, (idx, val, msk, cnt) in parts.items():
                if idx.device not in on:
                    on[idx.device] = (y.to(idx.device),
                                      None if yty is None else yty.to(idx.device))
                yi, ytyi = on[idx.device]
                if self.implicit_prefs:
                    solved[i] = _solve_implicit(
                        yi, ytyi, idx, val, msk, reg, alpha, self.rank, self.nonnegative,
                    )
                else:
                    solved[i] = _solve_explicit(
                        yi, idx, val, msk, cnt, reg, self.rank, self.nonnegative
                    )
            if None in solved:
                out[rows] = solved[None]
            else:
                got = gather_shards([solved.get(i) for i in range(mesh.devices.shape[0])], mesh)
                out[rows] = torch.cat(got)[: rows.shape[0]].to(out.device)

    @staticmethod
    def _coerce(ratings):
        from ..core.table import Table

        if isinstance(ratings, Table):
            cols = ratings.columns
            need = [c for c in ("user", "item", "rating") if c not in cols]
            if need:
                raise ValueError(
                    f"ALS table input needs user/item/rating columns; "
                    f"missing {need} (have {sorted(cols)})"
                )
            u = np.asarray(ratings.column("user"))
            i = np.asarray(ratings.column("item"))
            r = np.asarray(ratings.column("rating"), np.float32)
        elif isinstance(ratings, tuple) and len(ratings) == 3:
            u, i, r = (np.asarray(a) for a in ratings)
            r = r.astype(np.float32)
        else:
            arr = np.asarray(ratings)
            if arr.ndim != 2 or arr.shape[1] != 3:
                raise ValueError(
                    "ALS expects (user, item, rating) arrays, an (n, 3) "
                    f"matrix, or a Table; got shape {getattr(arr, 'shape', None)}"
                )
            u, i, r = arr[:, 0], arr[:, 1], arr[:, 2].astype(np.float32)
        ui = np.asarray(u)
        ii = np.asarray(i)
        if len(ui) and (np.min(ui) < 0 or np.min(ii) < 0):
            raise ValueError("ALS ids must be non-negative integers")
        return ui.astype(np.int64), ii.astype(np.int64), np.asarray(r, np.float32)


__all__ = ["ALS", "ALSModel"]
