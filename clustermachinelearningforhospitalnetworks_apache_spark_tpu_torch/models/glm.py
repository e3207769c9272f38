"""GeneralizedLinearRegression — IRLS over exponential families.

The JAX package's ``models/glm.py`` (Spark's
``GeneralizedLinearRegression``): families gaussian, binomial, poisson,
gamma and tweedie (power variance and power links) with their canonical
and alternative links, L2 ``reg_param`` on standardized coefficients with
the intercept unpenalized, an ``offset_col`` added to the linear
predictor, sample weights.

Per family (μ = g⁻¹(η)): working response z = η + (y − μ)·g'(μ), IRLS
weight ω = w / (g'(μ)²·V(μ)).  Each iteration is one pass over the rows
building XᵀΩX and XᵀΩ(z − offset), summed per chunk of ``STAT_CHUNK``
rows and then over the chunks (``logistic_regression.row_sums``, as the
reference's products are summed per device and then ``psum``'d), then a
float32 solve with the jitter ``1e-7·tr/d + 1e-9`` (``solve_ex``: no
host sync).  The first iteration starts from the family's μ-init η₀,
not from X·θ₀.  The reference's ``lax.while_loop`` stops on ``it <
max_iter and max|Δθ| / max(max|θ|, 1) > tol``; here the iterations run
in ``logistic_regression.newton_loop``, a few at a time on the device
with a done flag that freezes the state where the reference stops, and
the host reads the flag once a chunk, so ``n_iter`` equals the
reference's where the stop is decided above float32 rounding.

The resident fit runs over data shards (``base.Shards``: one device is
one shard; ``fit(..., mesh=)`` or a ``ShardedDataset`` spread the rows over
a mesh): the moments, every iteration's sums and the deviance a shard,
added in ascending shard order, the solve once on the home device; the
offset column is laid out as the rows are (``sharding.shard_rows`` over a
mesh).  A fresh resident fit carries a lazy training summary (deviance,
null deviance, Pearson χ², dispersion, AIC, the four residual types, and
on unregularized fits the standard errors, t- and p-values), its sums
taken over the same shards.  A :class:`~..parallel.outofcore.HostDataset`
fits out of core, to one device or over a mesh: the standardization
pre-pass (``streamed_standardization(extra="ysum")``), then one pass over
the blocks an iteration and one host read of the step, as in the
reference; it has no summary and no offset.
``model.fit_info`` holds ``n_iter`` and the host syncs of the fit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import torch

from ..data import DeviceDataset
from ..io.model_io import register_model
from ..parallel.outofcore import (HostDataset, shard_sum, standardized_ridge, stream_home,
                                  stream_mesh, streamed_standardization)
from .base import Estimator, Model, Shards, check_features, on_mesh, padded_column
from .linear_regression import shard_moments
from .logistic_regression import newton_loop, row_sums, streamed_newton_loop, with_intercept
from .summary import SummaryMixin

FAMILY_LINKS = {
    "gaussian": ("identity", ("identity", "log")),
    "binomial": ("logit", ("logit",)),
    "poisson": ("log", ("log", "identity", "sqrt")),
    "gamma": ("inverse", ("inverse", "log", "identity")),
    # tweedie's links are powers μ^link_power (log at 0), set by link_power
    "tweedie": ("power", ("power",)),
}


def link_fns(link: str, link_power: float = 0.0):
    """(g(μ), g⁻¹(η), g'(μ)); ``link="power"`` is tweedie's μ^link_power
    (log at 0).  A fractional power of η < 0 is NaN, as in the reference,
    so a diverging fit shows."""
    if link == "power":
        lp = float(link_power)
        if lp == 0.0:
            return link_fns("log")
        if lp == 1.0:
            return link_fns("identity")
        if lp == -1.0:
            return link_fns("inverse")
        return (
            lambda mu: mu ** lp,
            lambda eta: torch.where(eta >= 0, eta, torch.full_like(eta, float("nan")))
            ** (1.0 / lp),
            lambda mu: float(np.float32(lp)) * mu ** (lp - 1.0),
        )
    if link == "identity":
        return (lambda mu: mu, lambda eta: eta, torch.ones_like)
    if link == "log":
        return (torch.log, torch.exp, lambda mu: 1.0 / mu)
    if link == "logit":
        return (lambda mu: torch.log(mu / (1.0 - mu)), torch.sigmoid,
                lambda mu: 1.0 / (mu * (1.0 - mu)))
    if link == "inverse":
        return (lambda mu: 1.0 / mu, lambda eta: 1.0 / eta, lambda mu: -1.0 / (mu * mu))
    if link == "sqrt":
        return (torch.sqrt, lambda eta: eta * eta, lambda mu: 0.5 / torch.sqrt(mu))
    raise ValueError(f"unknown link {link!r}")


def variance_fn(family: str, var_power: float = 0.0):
    if family == "tweedie":
        vp = float(var_power)
        return lambda mu: mu ** vp
    return {
        "gaussian": torch.ones_like,
        "binomial": lambda mu: mu * (1.0 - mu),
        "poisson": lambda mu: mu,
        "gamma": lambda mu: mu * mu,
    }[family]


def mu_clip(family: str, mu, var_power: float = 0.0):
    """μ inside the family's domain, so V(μ) and g'(μ) stay finite
    (tweedie at variance power 0 is gaussian: unclipped)."""
    if family == "binomial":
        return torch.clamp(mu, 1e-6, 1.0 - 1e-6)
    if family in ("poisson", "gamma") or (family == "tweedie" and float(var_power) != 0.0):
        return torch.clamp(mu, min=1e-8)
    return mu


def glm_mu0_eta(y, ybar, family: str, link: str, var_power: float, link_power: float):
    """The μ-init → η₀ per row (the resident loop's start and the
    out-of-core first pass)."""
    g, _, _ = link_fns(link, link_power)
    if family == "binomial":
        mu0 = torch.clamp((y + 0.5) / 2.0, 1e-3, 1.0 - 1e-3)
    elif family in ("poisson", "gamma") or (family == "tweedie" and var_power != 0.0):
        mu0 = torch.clamp(y, min=0.0) + 0.1 * torch.clamp(ybar, min=0.1)
    else:
        mu0 = y
    return g(mu_clip(family, mu0, var_power))


def unit_deviance(family: str, y, mu, var_power: float = 0.0):
    """Per-row deviance d(y, μ) (McCullagh & Nelder): the fit's deviance,
    the summary's null deviance and the deviance residuals."""
    if family == "gaussian":
        r = y - mu
        return r * r
    if family == "binomial":
        return 2.0 * (y * torch.log(torch.clamp(y, min=1e-12) / mu)
                      + (1.0 - y) * torch.log(torch.clamp(1.0 - y, min=1e-12) / (1.0 - mu)))
    if family == "poisson":
        ylog = torch.where(y > 0, y * torch.log(y / mu), torch.zeros_like(y))
        return 2.0 * (ylog - (y - mu))
    if family == "tweedie":
        p = float(var_power)
        if p == 0.0:
            return unit_deviance("gaussian", y, mu)
        if p == 1.0:
            return unit_deviance("poisson", y, mu)
        if p == 2.0:
            return unit_deviance("gamma", y, mu)
        yp = torch.clamp(y, min=0.0)
        first = torch.where(yp > 0, yp ** (2.0 - p), torch.zeros_like(yp))
        return 2.0 * (first / ((1.0 - p) * (2.0 - p)) - y * mu ** (1.0 - p) / (1.0 - p)
                      + mu ** (2.0 - p) / (2.0 - p))
    return 2.0 * (-torch.log(torch.clamp(y, min=1e-12) / mu) + (y - mu) / mu)


def _irls_terms(xa, y, w, eta, family, link, var_power, link_power):
    """At η: the working response z and the IRLS weight ω."""
    _, ginv, gprime = link_fns(link, link_power)
    mu = mu_clip(family, ginv(eta), var_power)
    gp = gprime(mu)
    z = eta + (y - mu) * gp
    om = w / torch.clamp(gp * gp * variance_fn(family, var_power)(mu), min=1e-12)
    return z, om


def _damped_solve(theta, gram, mom, ridge):
    """The reference's solve on summed statistics → (θ_new, the relative
    step max|Δθ| / max(max|θ_new|, 1))."""
    d = gram.shape[0]
    g = gram + torch.diag(ridge)
    jitter = 1e-7 * torch.trace(g) / d + 1e-9
    eye = torch.eye(d, dtype=gram.dtype, device=gram.device)
    theta_new = torch.linalg.solve_ex(g + jitter * eye, mom)[0]
    delta = torch.max(torch.abs(theta_new - theta)) / torch.clamp(
        torch.max(torch.abs(theta_new)), min=1.0)
    return theta_new, delta


def irls_glm(x, y, w, offset, reg_param: float, tol: float, family: str, link: str,
             fit_intercept: bool, standardize: bool, max_iter: int, var_power: float = 0.0,
             link_power: float = 0.0):
    """The one-device IRLS fit (:func:`irls_shards` of one shard) →
    (coef (d,), intercept (), n_iter, deviance (), host syncs), float32 on
    the inputs' device."""
    return irls_shards(Shards(DeviceDataset(x=x, y=y, w=w)), {0: offset.to(torch.float32)},
                       reg_param, tol, family, link, fit_intercept, standardize, max_iter,
                       var_power, link_power)


def irls_shards(sh, off: dict, reg_param: float, tol: float, family: str, link: str,
                fit_intercept: bool, standardize: bool, max_iter: int, var_power: float = 0.0,
                link_power: float = 0.0):
    """IRLS over the data shards of ``sh`` (``base.Shards``; one device is
    one shard), ``off`` each shard's float32 part of the offset column
    (:func:`offset_parts`): the standardization moments (→ the ridge) and
    Σw·y (→ the μ-init's ȳ) summed in shard order, then every iteration's (XᵀΩX,
    XᵀΩ(z − offset)) a shard on its device against the broadcast θ, summed,
    and the damped solve once on the home device; the deviance a shard,
    summed.  → (coef (d,), intercept (), n_iter, deviance (), host syncs),
    float32 on the home device."""
    f32 = torch.float32
    xa = {i: with_intercept(s.x.to(f32), fit_intercept) for i, s in sh.data.items()}
    y = {i: s.y.to(f32) for i, s in sh.data.items()}
    w = {i: s.w.to(f32) for i, s in sh.data.items()}
    n, _, std = shard_moments(sh)
    scale = std if standardize else torch.ones_like(std)
    nfeat = sh.n_features
    ridge = torch.zeros((xa[sh.local[0]].shape[1],), dtype=f32, device=sh.home)
    ridge[:nfeat] = reg_param * n * scale * scale
    ybar = sh.sum(lambda i, s: ((y[i] * w[i]).sum(),))[0] / n
    eta0 = {i: glm_mu0_eta(y[i], ybar.to(y[i].device), family, link, var_power, link_power)
            for i in sh.local}
    first = [True]

    def step(theta):
        # the first iteration starts from the μ-init, every later one from X·θ
        th = sh.put(theta)
        start, first[0] = first[0], False

        def stats(i, s):
            eta = eta0[i] if start else xa[i] @ th[i] + off[i]
            z, om = _irls_terms(xa[i], y[i], w[i], eta, family, link, var_power, link_power)
            xo = xa[i] * om[:, None]
            return row_sums(xo, xa[i]), row_sums(xo, z - off[i])

        gram, mom = sh.sum(stats)
        return _damped_solve(theta, gram, mom, ridge)

    theta = torch.zeros((ridge.shape[0],), dtype=f32, device=sh.home)
    theta, n_iter, syncs = newton_loop(step, theta, tol, max_iter)
    _, ginv, _ = link_fns(link, link_power)
    th = sh.put(theta)

    def deviance(i, s):
        mu = mu_clip(family, ginv(xa[i] @ th[i] + off[i]), var_power)
        return (torch.sum(unit_deviance(family, y[i], mu, var_power) * w[i]),)

    dev_sum = sh.sum(deviance)[0]
    intercept = theta[nfeat] if fit_intercept else torch.zeros((), device=sh.home)
    return theta[:nfeat], intercept, n_iter, dev_sum, syncs


def offset_parts(sh, offset) -> dict:
    """Each shard's part of the offset column (laid out as the rows are;
    zeros without one), float32 on its device."""
    if offset is None:
        return {i: torch.zeros_like(s.y, dtype=torch.float32) for i, s in sh.data.items()}
    return {i: v.to(torch.float32) for i, v in sh.parts(offset).items()}


def _block_irls_stats(x, y, w, theta, ybar, family, link, fit_intercept: bool, first: bool,
                      var_power, link_power):
    """One block's (gram, moment) at θ; the first iteration's η is the
    μ-init, as in the resident loop."""
    xa = with_intercept(x.to(torch.float32), fit_intercept)
    y = y.to(torch.float32)
    w = w.to(torch.float32)
    if first:
        eta = glm_mu0_eta(y, ybar, family, link, var_power, link_power)
    else:
        eta = xa @ theta
    z, om = _irls_terms(xa, y, w, eta, family, link, var_power, link_power)
    xo = xa * om[:, None]
    return row_sums(xo, xa), row_sums(xo, z)


def _block_deviance(x, y, w, theta, family, link, fit_intercept: bool, var_power, link_power):
    xa = with_intercept(x.to(torch.float32), fit_intercept)
    _, ginv, _ = link_fns(link, link_power)
    mu = mu_clip(family, ginv(xa @ theta), var_power)
    return torch.sum(unit_deviance(family, y.to(torch.float32), mu, var_power) * w)


@dataclass
class GeneralizedLinearRegressionTrainingSummary:
    """Spark's ``GeneralizedLinearRegressionTrainingSummary``: deviance,
    null deviance, dispersion, AIC, Pearson χ², residuals, and on
    unregularized fits the standard errors, t- and p-values (normal for
    binomial / poisson, Student's t otherwise).  Lazy: one reduction on
    the device at first read, cached."""

    _model: "GeneralizedLinearRegressionModel" = field(repr=False)
    _ds: object = field(repr=False)          # a DeviceDataset or ShardedDataset
    _reg_param: float = 0.0
    _fit_intercept: bool = True
    _offset: object | None = field(default=None, repr=False)   # laid out as _ds's rows

    def _eta(self, x, off):
        m = self._model
        return (x.to(torch.float32) @ m.coefficients.to(x.device)
                + float(np.float32(m.intercept)) + off.to(torch.float32))

    def _shards(self):
        """The fit's rows as ``base.Shards`` and each shard's offset."""
        sh = Shards(self._ds)
        return sh, offset_parts(sh, self._offset)

    @cached_property
    def _stats(self) -> dict:
        """One pass over the shards → every scalar the summary needs, read
        to the host once (the null model's ȳ, and with an offset its
        intercept's sweeps, are passes of their own).  The per-row terms
        are float32 and their sums accumulate in float64, a shard and then
        over the shards in ascending order: the gamma AIC's terms cancel
        about a hundredfold, so a float32 sum would carry the device's
        reduction order into it."""
        m = self._model
        fam, vp = m.family, m.variance_power
        g_link, ginv, gprime = link_fns(m.link, m.link_power)
        vfn = variance_fn(fam, vp)
        sh, off = self._shards()
        y = {i: s.y.to(torch.float32) for i, s in sh.data.items()}
        w = {i: s.w.to(torch.float32) for i, s in sh.data.items()}
        mu = {i: mu_clip(fam, ginv(self._eta(s.x, off[i])), vp) for i, s in sh.data.items()}
        sw, sy = sh.sum(lambda i, s: (w[i].sum(), (y[i] * w[i]).sum()))
        ybar = sy / torch.clamp(sw, min=1e-12)
        if self._offset is None:
            # the intercept-only MLE is the weighted mean for every link
            mu0 = {i: (mu_clip(fam, ybar.to(y[i].device) * torch.ones_like(y[i]), vp)
                       if self._fit_intercept
                       else mu_clip(fam, ginv(torch.zeros_like(y[i])), vp)) for i in sh.local}
        elif not self._fit_intercept:
            mu0 = {i: mu_clip(fam, ginv(off[i]), vp) for i in sh.local}
        else:
            # with an offset the null model's b₀ has no closed form: 25
            # scalar IRLS sweeps, as the reference, each summed over the shards
            b0 = g_link(mu_clip(fam, torch.clamp(ybar, min=1e-8) * torch.ones((), device=sh.home),
                                vp))

            def sweep(i, s, b):
                mu_ = mu_clip(fam, ginv(b + off[i]), vp)
                gp_ = gprime(mu_)
                om_ = w[i] / torch.clamp(gp_ * gp_ * vfn(mu_), min=1e-12)
                z_ = b + (y[i] - mu_) * gp_
                return torch.sum(om_ * z_), torch.sum(om_)

            for _ in range(25):
                bs = sh.put(b0)
                num, den = sh.sum(lambda i, s: sweep(i, s, bs[i]))
                b0 = num / torch.clamp(den, min=1e-12)
            bs = sh.put(b0)
            mu0 = {i: mu_clip(fam, ginv(bs[i] + off[i]), vp) for i in sh.local}

        def sum64(t):
            return torch.sum(t, dtype=torch.float64)

        def terms(i, s):
            yi, wi, mui = y[i], w[i], mu[i]
            if fam == "binomial":
                ll = sum64(wi * (yi * torch.log(mui) + (1.0 - yi) * torch.log1p(-mui)))
            elif fam == "poisson":
                ll = sum64(wi * (yi * torch.log(torch.clamp(mui, min=1e-12)) - mui
                                 - torch.lgamma(yi + 1.0)))
            else:
                ll = torch.zeros((), dtype=torch.float64, device=yi.device)
            zero = torch.zeros_like(yi)
            return (sum64(unit_deviance(fam, yi, mui, vp) * wi),
                    sum64(unit_deviance(fam, yi, mu0[i], vp) * wi),
                    sum64(wi * (yi - mui) ** 2 / torch.clamp(vfn(mui), min=1e-12)),
                    ll, sum64(wi), sum64(wi > 0),
                    sum64(torch.where(wi > 0, torch.log(torch.clamp(yi, min=1e-12)), zero) * wi),
                    sum64(torch.where(wi > 0, torch.log(torch.clamp(mui, min=1e-12)), zero) * wi),
                    sum64(wi * yi / torch.clamp(mui, min=1e-12)))

        names = ("deviance", "null_deviance", "pearson", "ll", "wsum", "nrows", "logy",
                 "logmu", "y_over_mu")
        vals = torch.stack(sh.sum(terms)).tolist()
        return dict(zip(names, vals))

    @property
    def deviance(self) -> float:
        return self._stats["deviance"]

    @property
    def null_deviance(self) -> float:
        return self._stats["null_deviance"]

    @property
    def pearson_chi_squared(self) -> float:
        """Σ w·(y−μ)²/V(μ)."""
        return self._stats["pearson"]

    @cached_property
    def num_instances(self) -> int:
        return int(self._stats["nrows"])

    @property
    def rank(self) -> int:
        return int(self._model.coefficients.shape[0]) + (1 if self._fit_intercept else 0)

    @property
    def degrees_of_freedom(self) -> int:
        return max(self.num_instances - self.rank, 0)

    @property
    def residual_degree_of_freedom(self) -> int:
        return self.degrees_of_freedom

    @property
    def residual_degree_of_freedom_null(self) -> int:
        return max(self.num_instances - (1 if self._fit_intercept else 0), 0)

    @cached_property
    def dispersion(self) -> float:
        """1 for binomial / poisson; Pearson χ² / dof otherwise."""
        if self._model.family in ("binomial", "poisson"):
            return 1.0
        return self.pearson_chi_squared / max(self.degrees_of_freedom, 1)

    @cached_property
    def aic(self) -> float:
        """Spark's per-family AIC + 2·rank (the dispersion's +2 inside the
        gaussian and gamma terms)."""
        from scipy.special import gammaln

        s = self._stats
        fam = self._model.family
        if fam == "tweedie":
            raise RuntimeError(
                "AIC is not defined for the tweedie family (no closed-form likelihood); "
                "Spark's GeneralizedLinearRegression raises here too")
        if fam == "gaussian":
            fam_aic = s["wsum"] * (np.log(2.0 * np.pi * s["deviance"] / s["wsum"]) + 1.0) + 2.0
        elif fam in ("binomial", "poisson"):
            fam_aic = -2.0 * s["ll"]
        else:
            a = 1.0 / self.dispersion
            ll = ((a - 1.0) * s["logy"] - a * s["y_over_mu"] - a * s["logmu"]
                  + s["wsum"] * (a * np.log(a) - gammaln(a)))
            fam_aic = -2.0 * ll + 2.0
        return float(fam_aic + 2.0 * self.rank)

    def residuals(self, residuals_type: str = "deviance") -> np.ndarray:
        """Per-row residuals of the valid rows: deviance | pearson |
        working | response (√w-scaled where Spark scales them)."""
        m = self._model
        _, _, gprime = link_fns(m.link, m.link_power)
        vfn = variance_fn(m.family, m.variance_power)
        sh, off = self._shards()
        y = sh.rows(lambda i, s: s.y).astype(np.float64)
        w = sh.rows(lambda i, s: s.w).astype(np.float64)
        mu = sh.rows(lambda i, s: m.predict(s.x, offset=off[i])).astype(np.float64)
        valid = w > 0
        y, w, mu = y[valid], w[valid], mu[valid]

        def f32(fn, *a):   # the reference evaluates these on float32 copies
            return fn(*(torch.from_numpy(v.astype(np.float32)) for v in a)).numpy()

        if residuals_type == "response":
            return y - mu
        if residuals_type == "working":
            return (y - mu) * f32(gprime, mu)
        if residuals_type == "pearson":
            v = np.maximum(f32(vfn, mu), 1e-12)
            return (y - mu) / np.sqrt(v) * np.sqrt(w)
        if residuals_type == "deviance":
            d = f32(lambda a, b: unit_deviance(m.family, a, b, m.variance_power), y, mu)
            return np.sign(y - mu) * np.sqrt(np.maximum(d, 0.0) * w)
        raise ValueError("residuals_type must be deviance|pearson|working|response, got "
                         f"{residuals_type!r}")

    def _require_unregularized(self) -> None:
        if self._reg_param != 0.0:
            raise RuntimeError(
                "coefficient standard errors / t / p values are only available for an "
                "unregularized fit (reg_param=0), matching Spark's IRLS-solver restriction")

    @cached_property
    def coefficient_standard_errors(self) -> np.ndarray:
        """√(diag((XᵀΩX)⁻¹)·dispersion) at the fitted coefficients, ordered
        (coefficients…, intercept); raises on a (near-)singular Gram.  The
        Gram is summed per chunk of rows as the fit's is (``row_sums``)."""
        self._require_unregularized()
        m = self._model
        _, ginv, gprime = link_fns(m.link, m.link_power)
        sh, off = self._shards()

        def gram(i, s):
            w = s.w.to(torch.float32)
            mu = mu_clip(m.family, ginv(self._eta(s.x, off[i])), m.variance_power)
            gp = gprime(mu)
            om = w / torch.clamp(gp * gp * variance_fn(m.family, m.variance_power)(mu),
                                 min=1e-12)
            xa = with_intercept(s.x.to(torch.float32), self._fit_intercept)
            return (row_sums(xa * om[:, None], xa),)

        g = sh.sum(gram)[0].cpu().numpy().astype(np.float64)
        cond = np.linalg.cond(g)
        if not np.isfinite(cond) or cond > 1e7:
            raise RuntimeError(
                "weighted design matrix is (near-)collinear (Gram condition number "
                f"{cond:.2e}); standard errors are undefined")
        return np.sqrt(np.maximum(np.diag(np.linalg.inv(g)) * self.dispersion, 0.0))

    @cached_property
    def t_values(self) -> np.ndarray:
        self._require_unregularized()
        beta = self._model.coefficients.cpu().numpy().astype(np.float64)
        if self._fit_intercept:
            beta = np.r_[beta, float(self._model.intercept)]
        return beta / self.coefficient_standard_errors

    @cached_property
    def p_values(self) -> np.ndarray:
        self._require_unregularized()
        from scipy import stats

        t = np.abs(self.t_values)
        if self._model.family in ("binomial", "poisson"):
            return 2.0 * stats.norm.sf(t)
        return 2.0 * stats.t.sf(t, max(self.degrees_of_freedom, 1))


@register_model("GeneralizedLinearRegressionModel")
@dataclass
class GeneralizedLinearRegressionModel(SummaryMixin, Model):
    """``coefficients`` (d,) float32 tensor."""

    coefficients: torch.Tensor
    intercept: float
    family: str
    link: str
    n_iter: int = 0
    deviance: float = 0.0
    variance_power: float = 0.0
    link_power: float = 0.0
    _summary: object | None = field(default=None, repr=False, compare=False)

    def predict(self, x: torch.Tensor, offset=None) -> torch.Tensor:
        """μ = g⁻¹(xβ + b [+ offset])."""
        _, ginv, _ = link_fns(self.link, self.link_power)
        return ginv(self.predict_link(x, offset))

    def predict_link(self, x: torch.Tensor, offset=None) -> torch.Tensor:
        """The linear predictor η."""
        check_features(x, self.coefficients.shape[0], type(self).__name__)
        eta = (x.to(torch.float32) @ self.coefficients.to(x.device)
               + float(np.float32(self.intercept)))
        if offset is not None:
            eta = eta + torch.as_tensor(offset, dtype=torch.float32, device=x.device)
        return eta

    def _artifacts(self):
        return (
            "GeneralizedLinearRegressionModel",
            {"family": self.family, "link": self.link, "intercept": float(self.intercept),
             "n_iter": int(self.n_iter), "deviance": float(self.deviance),
             "variance_power": float(self.variance_power),
             "link_power": float(self.link_power)},
            {"coefficients": self.coefficients.detach().cpu().numpy()},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(
            coefficients=torch.from_numpy(np.asarray(arrays["coefficients"], np.float32)),
            intercept=float(params["intercept"]), family=params["family"],
            link=params["link"], n_iter=int(params.get("n_iter", 0)),
            deviance=float(params.get("deviance", 0.0)),
            variance_power=float(params.get("variance_power", 0.0)),
            link_power=float(params.get("link_power", 0.0)))


@dataclass(frozen=True)
class GeneralizedLinearRegression(Estimator):
    family: str = "gaussian"          # Spark default
    link: str | None = None           # None = the family's canonical link
    reg_param: float = 0.0
    max_iter: int = 25                # Spark default
    tol: float = 1e-6                 # Spark default
    fit_intercept: bool = True
    standardize: bool = True
    label_col: str = "length_of_stay"
    features_col: str = "features"
    weight_col: str | None = None
    # tweedie: V(μ) = μ^p, p ∈ {0} ∪ [1, ∞); link μ^link_power (default 1 − p)
    variance_power: float = 0.0
    link_power: float | None = None
    # a table column added as it is to the linear predictor
    offset_col: str | None = None

    def _link_and_powers(self):
        if self.family not in FAMILY_LINKS:
            raise ValueError(f"family must be one of {sorted(FAMILY_LINKS)}, got "
                             f"{self.family!r}")
        default, allowed = FAMILY_LINKS[self.family]
        link = self.link or default
        if link not in allowed:
            raise ValueError(
                f"link {link!r} is not supported for family {self.family!r}; one of "
                f"{allowed}" + (" (tweedie selects its link via link_power)"
                                if self.family == "tweedie" else ""))
        vp = float(self.variance_power)
        lp = 0.0
        if self.family == "tweedie":
            if not (vp == 0.0 or vp >= 1.0):
                raise ValueError(f"variance_power must be 0 or >= 1 (Spark's tweedie "
                                 f"domain); got {vp}")
            lp = float(self.link_power) if self.link_power is not None else 1.0 - vp
        return link, vp, lp

    #: ``fit`` runs over a mesh of more than one shard
    mesh_fit = True

    def fit(self, data, label_col: str | None = None, device=None, mesh=None):
        """Fit on ``data`` (DeviceDataset, ShardedDataset, AssembledTable,
        (x, y[, w])) on ``device`` (default the card) or over ``mesh``; a
        :class:`HostDataset` streams its blocks there.  An ``offset_col``
        is laid out as the rows are (row-sharded over a mesh)."""
        link, vp, lp = self._link_and_powers()
        if isinstance(data, HostDataset):
            return self._fit_outofcore(data, link, vp, lp, stream_mesh(mesh, device))
        ds = on_mesh(data, label_col or self.label_col, device, self.weight_col, mesh)
        sh = Shards(ds)
        offset = None
        if self.offset_col is not None:
            from ..features.assembler import AssembledTable

            if not isinstance(data, AssembledTable):
                raise ValueError(f"offset_col={self.offset_col!r} needs a table input to "
                                 f"resolve the column; got {type(data).__name__}")
            if self.offset_col not in data.table.schema:
                raise KeyError(f"offset_col {self.offset_col!r} is not a column of the "
                               f"table; available: {data.table.schema.names}")
            offset = padded_column(data.table.column(self.offset_col), ds)
        self._validate_labels(sh.valid_labels(), link, vp)
        coef, intercept, n_iter, deviance, syncs = irls_shards(
            sh, offset_parts(sh, offset), float(self.reg_param), float(self.tol), self.family,
            link, self.fit_intercept, self.standardize, self.max_iter, vp, lp)
        head = torch.stack([intercept.reshape(()), deviance]).tolist()
        model = GeneralizedLinearRegressionModel(
            coefficients=coef, intercept=head[0], family=self.family, link=link,
            n_iter=n_iter, deviance=head[1], variance_power=vp, link_power=lp)
        # host reads: the valid labels (the checks), the loop's flags, the head
        model.fit_info = {"n_iter": n_iter, "host_syncs": syncs + 2}
        model._summary = GeneralizedLinearRegressionTrainingSummary(
            model, ds, self.reg_param, self.fit_intercept, offset)
        return model

    def _validate_labels(self, yv: np.ndarray, link: str, vp: float) -> None:
        if yv.size == 0:
            raise ValueError("GeneralizedLinearRegression fit on an empty dataset")
        if self.family == "binomial" and not np.all(np.isin(yv, (0.0, 1.0))):
            raise ValueError("binomial family needs 0/1 labels")
        if self.family in ("poisson", "gamma"):
            lo = 0.0 if self.family == "poisson" else np.nextafter(0, 1)
            if yv.min() < lo:
                raise ValueError(
                    f"{self.family} family needs "
                    f"{'non-negative' if self.family == 'poisson' else 'positive'} labels")
        if self.family == "tweedie":
            if vp >= 2.0 and yv.min() <= 0.0:
                raise ValueError(f"tweedie with variance_power={vp} needs positive labels")
            if 1.0 <= vp < 2.0 and yv.min() < 0.0:
                raise ValueError(f"tweedie with variance_power={vp} needs non-negative "
                                 "labels")
        if self.family == "gaussian" and link == "log" and yv.min() <= 0.0:
            raise ValueError("gaussian family with log link needs positive labels")

    def _fit_outofcore(self, hd: HostDataset, link: str, vp: float, lp: float, mesh):
        """Rows ≫ device memory: each iteration streams the blocks over
        ``mesh`` summing the resident fit's (XᵀΩX, XᵀΩz) a shard at a time,
        then the same damped solve on the home device; one host read of
        the step an iteration."""
        if self.offset_col is not None:
            raise ValueError("offset_col needs a table input to resolve the column; "
                             "HostDataset has no columns")
        if hd.y is None:
            raise ValueError("GeneralizedLinearRegression needs labels: HostDataset(y=...)")
        w_host = np.asarray(hd.w) if hd.w is not None else np.ones(hd.n, np.float32)
        self._validate_labels(np.asarray(hd.y)[w_host > 0], link, vp)
        dev = stream_home(mesh)
        n, _, std, sy = streamed_standardization(hd, mesh, extra="ysum")
        ybar = torch.tensor(np.float32(sy / n), device=dev)
        nfeat = hd.n_features
        ridge = torch.from_numpy(standardized_ridge(
            n, std, self.reg_param, nfeat, self.fit_intercept, self.standardize)).to(dev)
        first = [True]

        def stats(blk, theta):
            return _block_irls_stats(blk.x, blk.y, blk.w, theta, ybar.to(blk.x.device),
                                     self.family, link, self.fit_intercept, first[0], vp, lp)

        def update(theta, gram, mom):
            first[0] = False
            return _damped_solve(theta, gram, mom, ridge)

        theta = torch.zeros((ridge.shape[0],), dtype=torch.float32, device=dev)
        theta, it = streamed_newton_loop(hd, mesh, stats, update, theta, self.tol, self.max_iter)
        dev_sum = None
        for blk in hd.blocks(mesh):
            d = shard_sum(blk, lambda i, s: (_block_deviance(
                s.x, s.y, s.w.to(torch.float32), theta.to(s.x.device), self.family, link,
                self.fit_intercept, vp, lp),))[0].to(torch.float64)
            dev_sum = d if dev_sum is None else dev_sum + d
        theta_h = theta.cpu().numpy()
        model = GeneralizedLinearRegressionModel(
            coefficients=theta[:nfeat],
            intercept=float(theta_h[nfeat]) if self.fit_intercept else 0.0,
            family=self.family, link=link, n_iter=it, deviance=float(dev_sum), variance_power=vp,
            link_power=lp)
        model.fit_info = {"n_iter": it, "host_syncs": it + 3}
        return model


__all__ = ["GeneralizedLinearRegression", "GeneralizedLinearRegressionModel",
           "GeneralizedLinearRegressionTrainingSummary", "irls_glm", "link_fns",
           "unit_deviance", "variance_fn"]
