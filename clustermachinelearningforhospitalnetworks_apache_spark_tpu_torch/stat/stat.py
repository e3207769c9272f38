"""Statistics — ``pyspark.ml.stat`` (the JAX package's ``stat/stat.py``):
Summarizer, Correlation, ChiSquareTest, KolmogorovSmirnovTest,
ANOVATest, FValueTest.

Each device statistic is one weighted reduction over the rows on the
device (``ops/reductions.py``), and only the (d, d) moment matrix or the
per-column vectors reach the host.  Spearman ranks and the chi-square
contingency tables are host work, as in the reference.  The KS statistic
sorts on the device (pad rows pushed to +inf) and reduces the ECDF gap
there, the normal CDF being ``torch.special.ndtr`` of the standardized
values.  The p-values come from scipy on the host.

Every entry point takes ``device=`` (default the card) and raises without
one unless it names the CPU, the host-only tests included.  The device
tests take the reference's ``mesh=`` too: over a mesh of more than one
shard (or for a ShardedDataset) each statistic is taken a data shard on
its device and the sums are added in ascending shard order
(``collectives.aggregate_shards``); a centred statistic takes its global
means first, summed so, then its centred sums a shard; the KS sort
gathers the valid values of every shard to the home device, as the
reference's sort of a sharded array does.  ``device=`` is a keyword.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..data import DeviceDataset
from ..device import resolve_device
from ..features.assembler import AssembledTable
from ..models.base import Shards, host_array, is_sharded, on_mesh, padded_column
from ..models.linear_regression import chunked_gram
from ..ops.reductions import host_moments
from ..parallel.collectives import gather_shards
from ..parallel.sharding import ShardedDataset


def _as_ds(data, device=None, mesh=None):
    """``data`` as a DeviceDataset on ``device`` (default the card; a
    dataset where it lies), or laid over ``mesh`` (a ShardedDataset for
    more than one shard)."""
    if mesh is None and not is_sharded(data):
        device = resolve_device(device)
    return on_mesh(data, None, device, None, mesh)


def _as_xw(data, mesh=None, device=None):
    """(x, w) of any accepted feature container, on ``device`` or over
    ``mesh`` (row-sharded MeshArrays)."""
    ds = _as_ds(data, device, mesh)
    return ds.x, ds.w


@dataclass(frozen=True)
class ChiSquareTestResult:
    p_values: np.ndarray            # (d,)
    degrees_of_freedom: np.ndarray  # (d,)
    statistics: np.ndarray          # (d,)


def _host_features(data, allow_weights: bool = False) -> np.ndarray:
    if isinstance(data, AssembledTable):
        return np.asarray(data.features, dtype=np.float64)
    if isinstance(data, (DeviceDataset, ShardedDataset)):
        x = host_array(data.x).astype(np.float64)
        w = host_array(data.w)
        if not allow_weights and not np.all((w == 0) | (w == 1)):
            raise ValueError(
                "spearman correlation does not support fractional sample weights; drop "
                "the weights or use method='pearson'")
        return x[w > 0]
    return np.asarray(data, dtype=np.float64)


class ChiSquareTest:
    """Pearson's independence test of every categorical feature against a
    categorical label; the contingency tables are built on the host."""

    @staticmethod
    def test(features, labels, device=None) -> ChiSquareTestResult:
        resolve_device(device)
        if isinstance(features, (DeviceDataset, ShardedDataset)):
            x = host_array(features.x).astype(np.float64)
            w = host_array(features.w).astype(np.float64)
        else:
            x = _host_features(features, allow_weights=True)
            w = np.ones(x.shape[0])
        y = np.asarray(labels).reshape(-1)
        if y.shape[0] != x.shape[0]:
            raise ValueError(
                f"labels rows {y.shape[0]} != features rows {x.shape[0]} (for a padded "
                "DeviceDataset pass the padded-length labels, e.g. ds.y)")
        keep = w > 0
        x, y, w = x[keep], y[keep], w[keep]
        from scipy import stats as sps

        stats_, dofs, ps = [], [], []
        y_codes, y_inv = np.unique(y, return_inverse=True)
        for j in range(x.shape[1]):
            v_codes, v_inv = np.unique(x[:, j], return_inverse=True)
            if len(v_codes) > 10_000:
                raise ValueError(
                    f"feature {j} has {len(v_codes)} distinct values (>10000); chi-square "
                    "needs categorical features — discretize first "
                    "(QuantileDiscretizer/Bucketizer)")
            table = np.zeros((len(v_codes), len(y_codes)))
            np.add.at(table, (v_inv, y_inv), w)
            row = table.sum(axis=1, keepdims=True)
            col = table.sum(axis=0, keepdims=True)
            expect = row @ col / table.sum()
            with np.errstate(invalid="ignore", divide="ignore"):
                chi2 = float(np.nansum((table - expect) ** 2 / expect))
            dof = (len(v_codes) - 1) * (len(y_codes) - 1)
            stats_.append(chi2)
            dofs.append(dof)
            ps.append(float(sps.chi2.sf(chi2, dof)) if dof > 0 else 1.0)
        return ChiSquareTestResult(p_values=np.asarray(ps), degrees_of_freedom=np.asarray(dofs),
                                   statistics=np.asarray(stats_))


def _avg_rank(v: np.ndarray) -> np.ndarray:
    """Average ranks, ties averaged (scipy's rankdata 'average')."""
    _, inv, counts = np.unique(v, return_inverse=True, return_counts=True)
    ends = np.cumsum(counts)
    starts = ends - counts + 1
    return 0.5 * (starts + ends)[inv]


class Correlation:
    """``Correlation.corr(data, method="pearson"|"spearman")`` → (d, d)."""

    @staticmethod
    def corr(data, method: str = "pearson", mesh=None, *, device=None) -> np.ndarray:
        if method not in ("pearson", "spearman"):
            raise ValueError(f"method must be pearson|spearman, got {method!r}")
        if method == "spearman":
            if mesh is None:
                resolve_device(device)
            x = _host_features(data)
            ranks = np.empty_like(x, dtype=np.float64)
            for j in range(x.shape[1]):
                ranks[:, j] = _avg_rank(x[:, j])
            return np.corrcoef(ranks, rowvar=False)
        s = host_moments(*_as_xw(data, mesh, device))
        n = max(s["n"], 1.0)
        mean = s["s1"] / n
        cov = s["xtx"] / n - np.outer(mean, mean)
        std = np.sqrt(np.maximum(np.diag(cov), 0.0))
        denom = np.outer(std, std)
        with np.errstate(invalid="ignore", divide="ignore"):
            r = cov / denom
        r[denom == 0] = np.nan   # a constant column: undefined, as Spark
        np.fill_diagonal(r, 1.0)
        return np.clip(r, -1.0, 1.0)


@dataclass(frozen=True)
class KolmogorovSmirnovTestResult:
    p_value: float
    statistic: float


def ks_statistic(x: torch.Tensor, w: torch.Tensor, mean: float, std: float):
    """One-sample KS statistic against N(mean, std) on x's device: one sort
    (pad rows at +inf), then the largest ECDF gap.  → (D, n) tensors."""
    n = torch.sum(w > 0)
    xs = torch.sort(torch.where(w > 0, x, torch.full_like(x, float("inf")))).values
    idx = torch.arange(xs.shape[0], dtype=torch.float32, device=x.device)
    cdf = torch.special.ndtr((xs - float(np.float32(mean))) / float(np.float32(std)))
    valid = idx < n
    nf = torch.clamp(n.to(torch.float32), min=1.0)
    ninf = torch.full_like(cdf, float("-inf"))
    d_plus = torch.max(torch.where(valid, (idx + 1.0) / nf - cdf, ninf))
    d_minus = torch.max(torch.where(valid, cdf - idx / nf, ninf))
    return torch.maximum(d_plus, d_minus), n


def _ks_rows(ds):
    """The sample column and its weights on one device: a DeviceDataset's
    own, or every shard's gathered to the home device in row order (the
    sort is global, as the reference's sort of a sharded array)."""
    if not isinstance(ds, ShardedDataset):
        return ds.x[:, 0], ds.w
    sh = Shards(ds)
    parts: list = [None] * sh.D
    for i, s in sh.data.items():
        parts[i] = torch.stack([s.x[:, 0].to(torch.float32), s.w.to(torch.float32)])
    xw = torch.cat(gather_shards(parts, sh.mesh), dim=1)
    return xw[0], xw[1]


class KolmogorovSmirnovTest:
    """One-sample KS test against a normal distribution (the only
    distribution Spark supports); the statistic on the device, the exact
    p-value from scipy (``kstwo``)."""

    @staticmethod
    def test(data, dist: str = "norm", mean: float = 0.0, std: float = 1.0, mesh=None, *,
             device=None) -> KolmogorovSmirnovTestResult:
        if dist != "norm":
            raise ValueError(f"only the 'norm' theoretical distribution is supported "
                             f"(Spark parity), got {dist!r}")
        if std <= 0:
            raise ValueError(f"std must be positive, got {std}")
        ds = _as_ds(data, device, mesh)
        if ds.n_features != 1:
            raise ValueError(f"KS is a single-column test; got {ds.n_features} columns "
                             "— select one (Spark's sampleCol)")
        x, w = _ks_rows(ds)
        stat, n = ks_statistic(x.to(torch.float32), w, mean, std)
        stat, n = torch.stack([stat.to(torch.float64), n.to(torch.float64)]).tolist()
        n = int(n)
        if n == 0:
            raise ValueError("KS test on an empty sample")
        from scipy import stats as sps

        p = float(sps.kstwo.sf(stat, n))
        return KolmogorovSmirnovTestResult(p_value=min(max(p, 0.0), 1.0), statistic=stat)


@dataclass(frozen=True)
class FTestResult:
    """Per-feature F-test results (ANOVATest / FValueTest)."""

    p_values: np.ndarray            # (d,)
    degrees_of_freedom: np.ndarray  # (d,)
    f_values: np.ndarray            # (d,)


def _padded_labels(ds, y: np.ndarray, test_name: str):
    """Labels zero-padded to the padded row count and laid out as the rows
    are (``base.padded_column``: a tensor on the dataset's device, or
    row-sharded over its mesh); refuses labels that stop short of a valid
    row (positional alignment would shift them)."""
    if y.shape[0] > ds.n_padded:
        raise ValueError(f"{test_name}: {y.shape[0]} labels exceed the padded row count "
                         f"{ds.n_padded}")
    w_host = host_array(ds.w)
    if np.any(w_host[y.shape[0]:] > 0):
        last = int(np.flatnonzero(w_host > 0).max()) + 1
        raise ValueError(f"{test_name}: labels have {y.shape[0]} rows but valid feature "
                         f"rows extend to row {last} — pass one label per feature row")
    return padded_column(y, ds)


def _global_means(sh: Shards, ys: dict | None = None):
    """(n, Σw·x / n[, Σw·y / n]) over every shard, the sums added in shard
    order, on the home device: the means a centred statistic subtracts
    (n = max(Σw, 1))."""
    def sums(i, s):
        x, w = s.x.to(torch.float32), s.w.to(torch.float32)
        out = (w.sum(), torch.sum(x * w[:, None], dim=0))
        return out if ys is None else out + (torch.sum(ys[i] * w),)

    tot = sh.sum(sums)
    n = torch.clamp(tot[0], min=1.0)
    return (n,) + tuple(t / n for t in tot[1:])


def anova_stats(x, y, w, k: int, gmean):
    """Per-class (count, Σxc, Σxc²) on globally centred features (no
    float32 Σx² − n·mean² cancellation; F is shift-invariant).  ``gmean``:
    the global weighted mean of every shard's rows (``_global_means``)."""
    xc = x - gmean[None, :]
    yi = y.to(torch.int64)
    onehot = (yi[:, None] == torch.arange(k, device=x.device)[None, :]).to(x.dtype) * w[:, None]
    return onehot.sum(dim=0), chunked_gram(onehot, xc), chunked_gram(onehot, xc * xc)


class ANOVATest:
    """One-way ANOVA F-test of every continuous feature against a
    categorical label (scipy's ``f_oneway``)."""

    @staticmethod
    def test(features, labels, mesh=None, *, device=None) -> FTestResult:
        ds = _as_ds(features, device, mesh)
        y = np.asarray(labels).reshape(-1)
        k = int(y.max()) + 1 if y.size else 1
        if k < 2:
            raise ValueError("ANOVA needs at least 2 label classes")
        sh = Shards(ds)
        ys = sh.parts(_padded_labels(ds, y, "ANOVA"))
        gmean = sh.put(_global_means(sh)[1])
        counts, s1, s2 = sh.sum(lambda i, s: anova_stats(
            s.x.to(torch.float32), ys[i], s.w.to(torch.float32), k, gmean[i]))
        flat = torch.cat([counts, s1.reshape(-1), s2.reshape(-1)]).cpu().numpy()
        flat = flat.astype(np.float64)
        d = ds.n_features
        counts, s1, s2 = flat[:k], flat[k:k + k * d].reshape(k, d), flat[k + k * d:].reshape(k, d)
        n = counts.sum()
        mean_c = s1 / np.maximum(counts[:, None], 1e-12)
        gmean = s1.sum(axis=0) / n
        ss_between = (counts[:, None] * (mean_c - gmean[None, :]) ** 2).sum(axis=0)
        ss_within = (s2 - counts[:, None] * mean_c ** 2).sum(axis=0)
        k_eff = int((counts > 0).sum())
        if k_eff < 2:
            raise ValueError("ANOVA needs at least 2 observed label classes")
        df_b, df_w = k_eff - 1, n - k_eff
        with np.errstate(invalid="ignore", divide="ignore"):
            f = (ss_between / df_b) / (ss_within / max(df_w, 1e-12))
        from scipy import stats as sps

        return FTestResult(p_values=np.asarray(sps.f.sf(f, df_b, df_w)),
                           degrees_of_freedom=np.full(f.shape, df_w), f_values=np.asarray(f))


def fvalue_stats(x, y, w, means):
    """(Σw, Σw·xc², Σw·yc², Σw·xc·yc) of centred columns.  ``means``: the
    global weighted (x mean, y mean) of every shard's rows
    (``_global_means``)."""
    wcol = w[:, None]
    xc = x - means[0][None, :]
    yc = y - means[1]
    return (torch.sum(w), torch.sum(xc * xc * wcol, dim=0), torch.sum(yc * yc * w),
            torch.sum(xc * (yc * w)[:, None], dim=0))


class FValueTest:
    """F-test of linear dependence of each feature on a continuous label:
    F = r²/(1 − r²)·(n − 2) (sklearn's ``f_regression``)."""

    @staticmethod
    def test(features, labels, mesh=None, *, device=None) -> FTestResult:
        ds = _as_ds(features, device, mesh)
        y = np.asarray(labels, dtype=np.float64).reshape(-1)
        sh = Shards(ds)
        ys = sh.parts(_padded_labels(ds, y, "FValueTest"))
        _, xm, ym = _global_means(sh, ys)
        xms, yms = sh.put(xm), sh.put(ym)
        sw, sxx, syy, sxy = sh.sum(lambda i, s: fvalue_stats(
            s.x.to(torch.float32), ys[i], s.w.to(torch.float32), (xms[i], yms[i])))
        d = ds.n_features
        flat = torch.cat([sw.reshape(1), sxx, syy.reshape(1), sxy]).cpu().numpy()
        flat = flat.astype(np.float64)
        n, sxx, syy, sxy = flat[0], flat[1:1 + d], flat[1 + d], flat[2 + d:]
        cov = sxy / n
        vx = sxx / n
        vy = syy / n
        with np.errstate(invalid="ignore", divide="ignore"):
            r2 = np.clip(cov * cov / np.maximum(vx * vy, 1e-300), 0.0, 1.0)
            f = r2 / np.maximum(1.0 - r2, 1e-300) * (n - 2)
        from scipy import stats as sps

        return FTestResult(p_values=np.asarray(sps.f.sf(f, 1, n - 2)),
                           degrees_of_freedom=np.full(f.shape, n - 2), f_values=np.asarray(f))


@dataclass(frozen=True)
class SummaryStats:
    """Per-column summary, every metric from one device pass."""

    count: float
    weight_sum: float
    mean: np.ndarray
    variance: np.ndarray   # unbiased (Σw − 1 denominator), Spark's convention
    std: np.ndarray
    min: np.ndarray
    max: np.ndarray
    norm_l1: np.ndarray
    norm_l2: np.ndarray
    num_non_zeros: np.ndarray


class Summarizer:
    """``Summarizer.summary(data)``: the ``pyspark.ml.stat.Summarizer``
    metrics in one reduction."""

    @staticmethod
    def summary(data, mesh=None, *, device=None) -> SummaryStats:
        s = host_moments(*_as_xw(data, mesh, device))
        n = max(s["n"], 1.0)
        mean = s["s1"] / n
        biased = np.maximum(s["s2"] / n - mean * mean, 0.0)
        var = biased * (n / max(n - 1.0, 1.0))
        return SummaryStats(count=float(s["count"]), weight_sum=float(s["n"]), mean=mean,
                            variance=var, std=np.sqrt(var), min=s["min"], max=s["max"],
                            norm_l1=s["l1"], norm_l2=np.sqrt(s["s2"]),
                            num_non_zeros=s["nnz"])


__all__ = [
    "ANOVATest", "ChiSquareTest", "ChiSquareTestResult", "Correlation", "FTestResult",
    "FValueTest", "KolmogorovSmirnovTest", "KolmogorovSmirnovTestResult", "Summarizer",
    "SummaryStats", "anova_stats", "fvalue_stats", "ks_statistic",
]
