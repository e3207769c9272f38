"""LinearRegression — weighted least squares on the device.

The JAX package's ``models/linear_regression.py`` (the reference
script's ``LinearRegression`` → ``length_of_stay``): one pass builds the
Gram matrix ``XᵀWX`` and the moments ``XᵀWy`` of the intercept-augmented
design, and the (d+1)×(d+1) normal equations are solved on the device in
float32 (TF32 off, ``device.py``).  Ridge (``reg_param``) is Spark's L2
on standardized coefficients, the intercept unpenalized.

The Gram and the moments are summed per chunk of ``GRAM_CHUNK`` rows and
then over the chunks (:func:`chunked_gram`), as the reference's
row-sharded products are summed per device and then ``psum``'d: one
float32 pass over 400,000 hospital rows (occupancy up to 400) lands 1e-3
of the largest coefficient off float64, the chunked sum at the
reference's 6e-6.

``elastic_net_param > 0`` (with ``reg_param > 0``) is Spark's elastic
net: FISTA on the (d, d) standardized Gram of the centered design
(:func:`_fista`).  The reference's ``lax.while_loop`` stops on
``delta <= tol``; here the iterations run in fixed chunks on the device,
a done flag freezing the state at the iteration where the reference
stops, and the host reads the flag once a chunk, so ``n_iter`` equals the
reference's.

A :class:`~..parallel.outofcore.HostDataset` takes the out-of-core
path, on one device or over a mesh: one pass over the streamed blocks sums
weighted moments and the Gram matrix of features shifted by a host-sample
mean (each block's shards on their devices, summed in ascending shard
order, then over the blocks), then the small (d, d) system is solved (or
FISTA'd) once, on the home device, in centered, standardized coordinates.

The partials protocol (``federated/``, family ``"linear"``): a silo's
statistics are the fit's own sums (:func:`_wls_partial_stats`: Σw, Σw·x,
Σw·x², the augmented Gram and moments) on the silo's device, and the
merged sums are solved on the coordinator's (:func:`_wls_fit_from_stats`),
so the resident fit is the one-silo case of the federated one.  The
elastic net, which centers on the pooled mean, stays pooled-only.

The resident fit runs over data shards (``base.Shards``: one device is
one shard, ``fit(..., mesh=)`` or a ``ShardedDataset`` spread the rows
over a mesh): each data shard computes :func:`_wls_partial_stats` on its
device, the shards' sums add in ascending shard order and
:func:`_wls_fit_from_stats` solves once on the home device, so the WLS is
the federated fit with each shard a silo.  The elastic net takes two such
passes, the moments (its centering) and then the Gram of the centered,
scaled rows, and FISTA runs on the home device.

A fresh resident fit carries a lazy training summary
(``models/summary.py``); a loaded model, or an out-of-core fit, has none
and ``summary`` raises, as in the reference.  ``model.fit_info`` holds
the elastic net's ``n_iter`` and host syncs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..io.model_io import register_model
from ..parallel.outofcore import HostDataset, add_stats, shard_sum, stream_home, stream_mesh
from .base import Estimator, Model, Shards, check_features, on_mesh
from .summary import SummaryMixin

#: rows summed by one partial product of :func:`chunked_gram`
GRAM_CHUNK = 4096
#: FISTA iterations run on the device between two reads of its done flag
FISTA_CHUNK = 16


def chunked_gram(a: torch.Tensor, b: torch.Tensor, chunk: int = GRAM_CHUNK) -> torch.Tensor:
    """``aᵀb`` over the rows (a (n, p); b (n, q) or (n,)), summed per
    chunk of ``chunk`` rows and then over the chunks: the reference's
    per-device products and their ``psum``, which keep the float32 sum of
    400,000 rows near float64 where one pass does not."""
    b2 = b[:, None] if b.ndim == 1 else b
    nc, tail = divmod(a.shape[0], chunk)
    full = nc * chunk
    parts = []
    if nc:       # views of the whole chunks: nothing is copied
        parts.append(torch.bmm(a[:full].reshape(nc, chunk, -1).transpose(1, 2),
                               b2[:full].reshape(nc, chunk, -1)))
    if tail or not nc:
        # the last rows, zero-padded to one whole chunk: a copy of at most
        # ``chunk`` rows, summed as every other chunk is
        at = a.new_zeros((1, chunk, a.shape[1]))
        bt = b2.new_zeros((1, chunk, b2.shape[1]))
        at[0, :tail] = a[full:]
        bt[0, :tail] = b2[full:]
        parts.append(torch.bmm(at.transpose(1, 2), bt))
    out = torch.cat(parts).sum(dim=0)
    return out[:, 0] if b.ndim == 1 else out


def moments_from_sums(sw, sx, sxx):
    """(n, mean, std) from Σw, Σw·x and Σw·x²: n = max(Σw, 1), and a
    (near-)constant feature gets std 1.0."""
    n = torch.clamp(sw, min=1.0)
    mean = sx / n
    var = sxx / n - mean * mean
    std = torch.where(var > 1e-12, torch.sqrt(torch.clamp(var, min=1e-12)),
                      torch.ones_like(var))
    return n, mean, std


def weighted_moments(x: torch.Tensor, w: torch.Tensor):
    """Weighted per-feature moments (:func:`moments_from_sums`).
    → (n, mean, std)."""
    wcol = w[:, None]
    return moments_from_sums(w.sum(), (x * wcol).sum(dim=0), (x * x * wcol).sum(dim=0))


def shard_moments(sh):
    """:func:`weighted_moments` over the data shards of ``sh``
    (``base.Shards``; one device is one shard): each shard's sums on its
    device, added in ascending shard order.  → (n, mean, std) on the home
    device."""
    def sums(i, s):
        x, w = s.x.to(torch.float32), s.w.to(torch.float32)
        wcol = w[:, None]
        return w.sum(), (x * wcol).sum(dim=0), (x * x * wcol).sum(dim=0)

    return moments_from_sums(*sh.sum(sums))


def standardized_design(x, w, reg_param: float, fit_intercept: bool, standardize: bool):
    """The intercept-augmented design and the ridge vector (L2 on
    standardized coefficients, intercept unpenalized).
    → (xa, ridge, nfeat, n)."""
    n, _, std = weighted_moments(x, w)
    scale = std if standardize else torch.ones_like(std)
    xa = torch.cat([x, torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)], dim=1) \
        if fit_intercept else x
    nfeat = x.shape[1]
    ridge = torch.zeros((xa.shape[1],), dtype=x.dtype, device=x.device)
    ridge[:nfeat] = reg_param * n * scale * scale
    return xa, ridge, nfeat, n


def _wls_partial_stats(x, y, w, fit_intercept: bool):
    """WLS sufficient statistics, the summation-mergeable pieces of the
    fit: the raw feature moments (for the standardization scale, the rule
    of :func:`weighted_moments`), the intercept-augmented Gram and the
    moment vector (:func:`chunked_gram`).  Summed across silos and fed to
    :func:`_wls_fit_from_stats` they give the pooled fit: bit for bit when
    the per-silo sums are exact (e.g. integer-valued features), else to
    the merge's reassociation."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    w = w.to(torch.float32)
    xa = torch.cat([x, torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)], dim=1) \
        if fit_intercept else x
    wcol = w[:, None]
    xw = xa * wcol
    return (
        w.sum(),                          # Σw
        (x * wcol).sum(dim=0),            # Σw·x
        (x * x * wcol).sum(dim=0),        # Σw·x²
        chunked_gram(xw, xa),             # XᵀWX (augmented)
        chunked_gram(xw, y),              # XᵀWy
    )


def _wls_fit_from_stats(sw, sx, sxx, gram, mom, reg_param: float, fit_intercept: bool,
                        standardize: bool):
    """Summed statistics → (coef, intercept): the moments rule of
    :func:`weighted_moments`, Spark's ridge on standardized coefficients
    (intercept unpenalized) and the jitter, then the solve (``solve_ex``:
    no host sync on the card, and a singular system gives non-finite
    coefficients instead of raising, as the reference's solve)."""
    n, _, std = moments_from_sums(sw, sx, sxx)
    scale = std if standardize else torch.ones_like(std)
    nfeat = sx.shape[0]
    dd = gram.shape[0]
    ridge = torch.zeros((dd,), dtype=gram.dtype, device=gram.device)
    ridge[:nfeat] = reg_param * n * scale * scale
    eye = torch.eye(dd, dtype=torch.float32, device=gram.device)
    theta = torch.linalg.solve_ex((gram + torch.diag(ridge)) + 1e-8 * eye, mom)[0]
    coef = theta[:nfeat]
    intercept = theta[nfeat] if fit_intercept else torch.zeros((), dtype=gram.dtype,
                                                              device=gram.device)
    return coef, intercept


def _fista(g, c, l1: float, l2: float, tol: float, max_iter: int):
    """FISTA on a standardized (d, d) Gram: minimizes ½β̃ᵀGβ̃ − cᵀβ̃ +
    l1‖β̃‖₁ + l2/2‖β̃‖².  The Lipschitz constant λmax(G) + l2 comes from 32
    power steps (one device loop, no stop test).  The proximal steps run
    ``FISTA_CHUNK`` at a time with a done flag (``it < max_iter`` and
    ``delta > tol``, the reference's loop test) that freezes the state, so
    the host reads the flag once a chunk.  → (β̃, n_iter, host syncs)."""
    d_feat = g.shape[0]
    dev = g.device
    v = torch.ones((d_feat,), dtype=g.dtype, device=dev) / float(np.sqrt(np.float32(d_feat)))
    for _ in range(32):
        v = g @ v
        v = v / torch.clamp(torch.linalg.norm(v), min=1e-30)
    lips = torch.clamp(v @ (g @ v), min=1e-12) + l2

    beta = torch.zeros((d_feat,), dtype=g.dtype, device=dev)
    z = beta
    t = torch.ones((), dtype=g.dtype, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    delta = torch.full((), float("inf"), dtype=g.dtype, device=dev)
    syncs = 0
    for _ in range(0, max_iter, FISTA_CHUNK):
        for _ in range(FISTA_CHUNK):
            go = (it < max_iter) & (delta > tol)
            grad = g @ z - c + l2 * z
            u = z - grad / lips
            beta_new = torch.sign(u) * torch.clamp(torch.abs(u) - l1 / lips, min=0.0)
            t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
            z_new = beta_new + ((t - 1.0) / t_new) * (beta_new - beta)
            delta_new = torch.max(torch.abs(beta_new - beta))
            beta = torch.where(go, beta_new, beta)
            z = torch.where(go, z_new, z)
            t = torch.where(go, t_new, t)
            delta = torch.where(go, delta_new, delta)
            it = it + go.to(torch.int32)
        syncs += 1
        if not bool((it < max_iter) & (delta > tol)):
            break
    return beta, int(it), syncs


def _en_penalties(reg_param: float, en_param: float):
    """(l1, l2) as the reference forms them, in float32."""
    reg, en = np.float32(reg_param), np.float32(en_param)
    return float(reg * en), float(reg * (np.float32(1.0) - en))


def _elastic_net_fit(sh, reg_param: float, en_param: float, tol: float,
                     fit_intercept: bool, standardize: bool, max_iter: int):
    """Elastic-net WLS via FISTA on the Gram matrix of the centered,
    scaled design (Spark's ``elasticNetParam``) over the data shards of
    ``sh`` (``base.Shards``): minimizes 1/(2n) Σ wᵢ(yᵢ − xᵢβ − b)² +
    λ(α‖β̃‖₁ + (1−α)/2 ‖β̃‖²), intercept unpenalized.  Two passes over
    the shards, the moments (the centering) and then the centered Gram,
    each summed in ascending shard order; FISTA on the home device.
    → (coef, intercept, n_iter, host syncs)."""
    n, mean, std = shard_moments(sh)
    scale = std if standardize else torch.ones_like(std)
    sy, = sh.sum(lambda i, s: ((s.y.to(torch.float32) * s.w.to(torch.float32)).sum(),))
    ybar = sy / n
    if fit_intercept:
        xc_mean, yc = mean, ybar
    else:
        xc_mean, yc = torch.zeros_like(mean), torch.zeros_like(ybar)
    put_m, put_s, put_y = sh.put(xc_mean), sh.put(scale), sh.put(yc)

    def gram(i, s):
        x, y, w = (t.to(torch.float32) for t in (s.x, s.y, s.w))
        xs = (x - put_m[i][None, :]) / put_s[i][None, :]
        xw = xs * w[:, None]
        return chunked_gram(xw, xs), chunked_gram(xw, y - put_y[i])

    g, c = sh.sum(gram)
    l1, l2 = _en_penalties(reg_param, en_param)
    beta, n_iter, syncs = _fista(g / n, c / n, l1, l2, float(np.float32(tol)), max_iter)
    coef = beta / scale
    intercept = ybar - mean @ coef if fit_intercept else torch.zeros(
        (), dtype=beta.dtype, device=beta.device)
    return coef, intercept, n_iter, syncs


def _lr_block_stats(x, y, w, shift):
    """One block's weighted moments and Gram on SHIFTED features
    (xs = x − shift; the host-sample mean as shift keeps the
    Gram-minus-mean-outer cancellation out of float32): → (Σw, Σw·xs,
    Σw·xs², Σw·y, XsᵀWXs, XsᵀWy)."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    w = w.to(torch.float32)
    xs = x - shift[None, :]
    xw = xs * w[:, None]
    return (w.sum(), xw.sum(dim=0), (xs * xs * w[:, None]).sum(dim=0), (y * w).sum(),
            xw.T @ xs, xw.T @ y)


def _lr_solve_from_stats(stats, shift, reg_param: float, fit_intercept: bool,
                         standardize: bool, elastic: bool = False, en_param: float = 0.0,
                         tol: float = 1e-6, max_iter: int = 100):
    """Summed block statistics → (coef, intercept, fit_info) in centered,
    standardized coordinates: ``(g + λ·I)β̃ = c`` for ridge (the resident
    WLS with Spark's unpenalized intercept), or FISTA on ``g`` for the
    elastic net (the resident path's solver)."""
    sw, sx, sxx, sy, gram, mom = stats
    n, mean_s, std = moments_from_sums(sw, sx, sxx)   # mean_s: of the shifted features
    scale = std if standardize else torch.ones_like(std)
    ybar = sy / n
    if fit_intercept:
        g_c = gram / n - torch.outer(mean_s, mean_s)
        c_c = mom / n - mean_s * ybar
    else:  # the shift is 0 here
        g_c = gram / n
        c_c = mom / n
    g = g_c / torch.outer(scale, scale)
    c = c_c / scale
    info = {}
    if elastic:
        l1, l2 = _en_penalties(reg_param, en_param)
        beta, info["n_iter"], info["host_syncs"] = _fista(g, c, l1, l2,
                                                          float(np.float32(tol)), max_iter)
    else:
        d = g.shape[0]
        lam = torch.tensor(reg_param, dtype=torch.float32, device=g.device) + 1e-8
        beta = torch.linalg.solve_ex(g + lam * torch.eye(d, dtype=g.dtype, device=g.device),
                                     c)[0]
    coef = beta / scale
    if fit_intercept:
        intercept = ybar - (mean_s + shift) @ coef
    else:
        intercept = torch.zeros((), dtype=g.dtype, device=g.device)
    return coef, intercept, info


@register_model("LinearRegressionModel")
@dataclass
class LinearRegressionModel(SummaryMixin, Model):
    """``coefficients`` (d,) and ``intercept`` () as float32 tensors."""

    coefficients: torch.Tensor
    intercept: torch.Tensor
    _summary: object | None = field(default=None, repr=False, compare=False)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        check_features(x, self.coefficients.shape[0], "LinearRegressionModel")
        coef = self.coefficients.to(x.device)
        return x.to(torch.float32) @ coef + self.intercept.to(x.device)

    def _artifacts(self):
        return (
            "LinearRegressionModel",
            {},
            {
                "coefficients": self.coefficients.detach().cpu().numpy(),
                "intercept": self.intercept.detach().cpu().numpy(),
            },
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        """CPU float32 tensors; ``predict`` moves them to the rows' device."""
        return cls(
            coefficients=torch.tensor(np.asarray(arrays["coefficients"], dtype=np.float32)),
            intercept=torch.tensor(np.asarray(arrays["intercept"], dtype=np.float32)),
        )


@dataclass(frozen=True)
class LinearRegression(Estimator):
    """Spark's ``LinearRegression``: ``elastic_net_param`` 0 is pure L2
    ridge (the closed-form WLS), 1 lasso, in between the elastic net
    (FISTA); ``max_iter`` / ``tol`` apply to the elastic net only."""

    label_col: str = "length_of_stay"
    reg_param: float = 0.0
    elastic_net_param: float = 0.0
    max_iter: int = 100        # Spark default
    tol: float = 1e-6          # Spark default
    fit_intercept: bool = True
    standardize: bool = True
    weight_col: str | None = None

    #: ``fit`` runs over a mesh of more than one shard
    mesh_fit = True

    def fit(self, data, label_col: str | None = None, device=None,
            mesh=None) -> LinearRegressionModel:
        """Fit on ``data`` (DeviceDataset, ShardedDataset, AssembledTable,
        (x, y[, w])) on ``device`` (default the card) or over ``mesh``; a
        :class:`HostDataset` streams its blocks there."""
        if isinstance(data, HostDataset):
            return self._fit_outofcore(data, stream_mesh(mesh, device))
        ds = on_mesh(data, label_col or self.label_col, device, self.weight_col, mesh)
        sh = Shards(ds)
        info = {}
        if self._elastic:
            coef, intercept, info["n_iter"], info["host_syncs"] = _elastic_net_fit(
                sh, float(self.reg_param), float(self.elastic_net_param), float(self.tol),
                self.fit_intercept, self.standardize, self.max_iter)
        else:
            # the WLS: each shard a silo of the federated fit
            stats = sh.sum(lambda i, s: _wls_partial_stats(s.x, s.y, s.w, self.fit_intercept))
            coef, intercept = _wls_fit_from_stats(*stats, float(self.reg_param),
                                                  self.fit_intercept, self.standardize)
        model = LinearRegressionModel(coefficients=coef, intercept=intercept)
        model.fit_info = info
        # the lazy training summary holds references only; each metric is
        # computed on first read
        from .summary import LinearRegressionTrainingSummary

        model._summary = LinearRegressionTrainingSummary(
            model, ds, self.reg_param, self.elastic_net_param, self.fit_intercept
        )
        return model

    @property
    def _elastic(self) -> bool:
        return self.elastic_net_param > 0.0 and self.reg_param > 0.0

    # ---------------------------------------------------- partials protocol
    partials_family = "linear"

    def supports_partials(self) -> bool:
        # the elastic net centers the design on the POOLED mean before its
        # FISTA Gram: that coupling does not decompose into per-silo sums
        return not self._elastic

    def init_partials_state(self, n_features: int, mesh=None):
        return None  # single-shot family: no state between rounds

    def partial_fit_stats(self, data, label_col: str | None = None, mesh=None, state=None,
                          final: bool = False, device=None):
        """One silo's WLS statistics, computed on ``device`` (default the
        card; a DeviceDataset where it lies) or over ``mesh`` (a shard on
        its device, summed in ascending shard order); only the (d+1)² sums
        cross to the host."""
        from ..federated.partials import Partials

        if not self.supports_partials():
            raise NotImplementedError(
                "elastic-net LinearRegression centers the design on the "
                "pooled mean — not partials-decomposable; use reg_param "
                "with elastic_net_param=0 (ridge) for federated fits"
            )
        ds = on_mesh(data, label_col or self.label_col, None if mesh is not None else device,
                     self.weight_col, mesh)
        stats = Shards(ds).sum(lambda i, s: _wls_partial_stats(s.x, s.y, s.w,
                                                                self.fit_intercept))
        sw, sx, sxx, gram, mom = (t.cpu().numpy() for t in stats)
        return Partials(
            family=self.partials_family,
            stats={"sw": sw, "sx": sx, "sxx": sxx, "gram": gram, "mom": mom},
            n_rows=float(sw),
        )

    def apply_partials(self, state, merged, device=None):
        return state, True  # one update, then done

    def fit_from_partials(self, merged, state=None, device=None) -> LinearRegressionModel:
        """The merged statistics solved on ``device`` (default the card)."""
        dev = resolve_device(device)
        stats = [torch.from_numpy(np.asarray(merged.stats[k], np.float32)).to(dev)
                 for k in ("sw", "sx", "sxx", "gram", "mom")]
        coef, intercept = _wls_fit_from_stats(*stats, float(self.reg_param),
                                              self.fit_intercept, self.standardize)
        return LinearRegressionModel(coefficients=coef, intercept=intercept)

    def _fit_outofcore(self, hd: HostDataset, mesh) -> LinearRegressionModel:
        """Rows ≫ device memory: one pass of block statistics over ``mesh``
        (each block's shards summed in shard order, then the blocks), then
        the (d, d) solve on the home device.  No training summary (it would pin the whole
        dataset on the device), as in the reference."""
        if hd.y is None:
            raise ValueError("LinearRegression needs labels: HostDataset(y=...)")
        if hd.n == 0:
            raise ValueError("LinearRegression fit on an empty dataset")
        # the shift is a host-sample mean, exactly 0 without an intercept to
        # absorb it (or when every weight is 0)
        dev = stream_home(mesh)
        sample = hd.sample_rows(65536, seed=0) if self.fit_intercept else None
        if sample is not None and sample.shape[0] > 0:
            shift = torch.from_numpy(sample.mean(axis=0).astype(np.float32)).to(dev)
        else:
            shift = torch.zeros((hd.n_features,), dtype=torch.float32, device=dev)
        tot = None
        for blk in hd.blocks(mesh):
            s = shard_sum(blk, lambda i, sh: _lr_block_stats(sh.x, sh.y, sh.w,
                                                             shift.to(sh.x.device)))
            tot = s if tot is None else add_stats(tot, s)
        coef, intercept, info = _lr_solve_from_stats(
            tot, shift, float(self.reg_param), self.fit_intercept, self.standardize,
            self._elastic, float(self.elastic_net_param), float(self.tol), self.max_iter)
        model = LinearRegressionModel(coefficients=coef, intercept=intercept)
        model.fit_info = info
        return model


__all__ = [
    "LinearRegression", "LinearRegressionModel", "chunked_gram", "standardized_design",
    "weighted_moments",
]
