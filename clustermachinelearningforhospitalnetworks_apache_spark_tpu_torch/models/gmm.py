"""GaussianMixture — EM with full covariances (BASELINE config 3: k=32),
the JAX package's ``models/gmm.py`` on one CUDA device, in-core.

Spark's ``GaussianMixture`` surface (``weights``, means and covariances,
``summary.logLikelihood``; maxIter=100, tol=0.01, full covariance).  Each
EM iteration is a row-chunked pass (``chunk_rows`` rows at a time, so only
a (chunk, k) responsibility tile and a (chunk, d²) tile of row outer
products exist at once) that accumulates Spark's sufficient statistics —
(nk, Σr·x, Σr·xxᵀ, log-likelihood) — then the (k, d, d) refit.  All of it
is torch ops in float32 on the data's device (TF32 off, ``device.py``):
the per-component triangular solves are one batched
``torch.linalg.solve_triangular`` over the k components, the moment
contractions are ``torch.matmul``; the JAX package runs no Pallas kernel
here either.

Rows are recentered around the init sample's mean inside the pass: the
covariance refit ``Σr·xxᵀ/nk − μμᵀ`` cancels catastrophically in float32
when the data's mean dwarfs its spread.  The init (k-means++, ten host
Lloyd steps, per-cluster diagonal covariances) is host numpy, copied
unchanged, so it is bit-equal to the JAX package's.

The fast path syncs the host once per iteration, on the log-likelihood
that decides convergence (``|Δll| >= tol`` in float32, as the reference's
device loop); a checkpoint or ``on_iteration`` takes the reference's host
loop (Python floats).  A :class:`~..parallel.outofcore.HostDataset`
streams its blocks, to one device or over a mesh, through the same
chunked E-step statistics, each block's shards summed in ascending shard
order and then the blocks, then one M-step an iteration on the home
device.  ``checkpoint_dir`` commits the parameters with **unshifted**
means (``io/fit_checkpoint.py``; in float64, where the sum of the float32
shifted means and the shift is exact, so a resume is bit-equal to the
uninterrupted fit), and a warm start (``warm_start_params``) runs
unshifted.

``matmul_precision`` other than ``"highest"`` takes the reference's
factor-form E-step: the k inverse Cholesky factors, stacked into one
(d, k·d) matrix once an iteration (:func:`_pdf_factors`), turn the
per-component triangular solves into one product a row chunk
(:func:`_batched_log_pdf`), and that product and the two moment products
run under the precision (``ops/distance.py::matmul_p``: TF32 on the card
for "high" / "default", bf16 operands with float32 sums for "bf16").

The resident fit runs over data shards (``base.Shards``: one device is one
shard, ``fit(..., mesh=)`` or a ``ShardedDataset`` spread the rows over a
mesh): each EM iteration runs :func:`_em_pass` once a data shard on its
device against the parameters broadcast from the home device,
sums (nk, Σr·x, Σr·xxᵀ, ll) in ascending shard order and runs the M-step
once on the home device; the init draws the global sample.  ``score``,
``predict_assigned`` and ``transform`` work shard by shard, and the
partials calls take ``mesh=``.  ``checkpoint_dir`` over shards signs the
rows by their global padded indices, so a resumed sharded fit is the
uninterrupted one.

The partials protocol (federated EM, ``federated/``): a silo's
statistics are one unshifted :func:`_em_pass` over its rows, the
coordinator's M-step is :func:`_m_step_rule`.  With each silo one chunk
of ``chunk_rows`` rows, a warm federated fit equals the pooled warm fit
bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..io.model_io import register_model
from ..ops.distance import matmul_p, validate_matmul_precision
from ..parallel.outofcore import HostDataset, add_stats, shard_sum, stream_home, stream_mesh
from ..parallel.sharding import MeshArray, sample_valid_rows
from .base import ClusteringModel, Estimator, Shards, check_features, is_sharded, on_mesh
from .kmeans import _kmeans_pp_init, _lloyd_refine
from .summary import ClusteringSummary

def _log_pdf(x, means, chols):
    """(n, d) rows → (n, k) log N(x; mean_j, L_j·L_jᵀ), the k triangular
    solves batched."""
    d = x.shape[1]
    diff = x[None, :, :] - means[:, None, :]                       # (k, n, d)
    sol = torch.linalg.solve_triangular(chols, diff.transpose(1, 2), upper=False)
    maha = (sol * sol).sum(dim=1)                                   # (k, n)
    logdet = 2.0 * torch.log(torch.diagonal(chols, dim1=1, dim2=2)).sum(dim=1)
    return (-0.5 * (d * math.log(2.0 * math.pi) + logdet[:, None] + maha)).T


def _pdf_factors(means, chols):
    """→ (W (d, k·d), offset (k, d), const (k,)) for the matmul E-step:
    with L⁻¹ the inverse Cholesky factor, maha_k(x) = ‖x·L_k⁻ᵀ −
    mean_k·L_k⁻ᵀ‖², so stacking the L⁻ᵀ over components makes the k
    triangular solves of :func:`_log_pdf` one (chunk, d) @ (d, k·d)
    product."""
    k, d = means.shape
    eye = torch.eye(d, dtype=torch.float32, device=means.device)
    linv = torch.linalg.solve_triangular(chols, eye.expand(k, d, d), upper=False)  # L⁻¹
    linv_t = linv.transpose(1, 2)                        # [k, i, j] = L⁻ᵀ entries
    w_fac = linv_t.transpose(0, 1).reshape(d, k * d)
    offset = torch.einsum("kd,kde->ke", means, linv_t)
    logdet = 2.0 * torch.log(torch.diagonal(chols, dim1=1, dim2=2)).sum(dim=1)
    const = -0.5 * (d * math.log(2.0 * math.pi) + logdet)
    return w_fac, offset, const


def _batched_log_pdf(xb, w_fac, offset, const, precision: str = "highest"):
    """(chunk, k) log densities from :func:`_pdf_factors`: the values of
    :func:`_log_pdf` up to the product's rounding, subtracting in the
    transformed basis."""
    k, d = offset.shape
    y = matmul_p(xb, w_fac, precision).reshape(-1, k, d) - offset[None]
    return const[None, :] - 0.5 * (y * y).sum(dim=-1)


def _chunks(n: int, chunk: int):
    chunk = max(min(chunk, n), 1)
    return range(0, max(n, 1), chunk), chunk


def _e_step(x, w, log_weights, means, chols, chunk: int = 65536):
    """Total weighted log-likelihood of the rows (model-side scoring)."""
    starts, c = _chunks(x.shape[0], chunk)
    ll = torch.zeros((), dtype=torch.float32, device=x.device)
    for s in starts:
        lr = _log_pdf(x[s:s + c], means, chols) + log_weights[None, :]
        ll = ll + (torch.logsumexp(lr, dim=1) * w[s:s + c]).sum()
    return ll


def _em_pass(x, w, shift, logw, means, chols, chunk: int, precision: str = "highest"):
    """One E-step's sufficient statistics (nk, Σr·x, Σr·xxᵀ, ll) over row
    chunks, rows recentered by ``shift``.  "highest" solves per component
    (diff first, stable when components sit far apart); the other
    precisions take the factor form and run the log-density and moment
    products under ``precision``."""
    k, d = means.shape
    if precision != "highest":
        w_fac, offset, const = _pdf_factors(means, chols)
    f32 = dict(dtype=torch.float32, device=x.device)
    nk = torch.zeros((k,), **f32)
    sums = torch.zeros((k, d), **f32)
    outer = torch.zeros((k, d, d), **f32)
    ll = torch.zeros((), **f32)
    starts, c = _chunks(x.shape[0], chunk)
    for s in starts:
        xb = x[s:s + c] - shift[None, :]
        wb = w[s:s + c]
        if precision != "highest":
            log_pdf = _batched_log_pdf(xb, w_fac, offset, const, precision)
        else:
            log_pdf = _log_pdf(xb, means, chols)
        log_resp_un = log_pdf + logw[None, :]
        log_norm = torch.logsumexp(log_resp_un, dim=1)
        resp = torch.exp(log_resp_un - log_norm[:, None]) * wb[:, None]    # (c, k)
        nk = nk + resp.sum(dim=0)
        sums = sums + matmul_p(resp.T, xb, precision)
        # (chunk, d·d) row outer products against (chunk, k) resp
        xx = (xb[:, :, None] * xb[:, None, :]).reshape(-1, d * d)
        outer = outer + matmul_p(resp.T, xx, precision).reshape(k, d, d)
        ll = ll + (log_norm * wb).sum()
    return nk, sums, outer, ll


def _m_step_rule(nk, sums, outer, reg_covar: float):
    """The M-step refit: means, covariances and weights from the
    accumulated statistics."""
    d = sums.shape[1]
    eye = torch.eye(d, dtype=torch.float32, device=sums.device)
    nk = torch.clamp(nk, min=1e-6)
    means = sums / nk[:, None]
    covs = outer / nk[:, None, None] - torch.einsum("kd,ke->kde", means, means)
    covs = covs + reg_covar * eye[None]
    weights = nk / nk.sum()
    return means, covs, weights


def _gmm_chols(covs, reg_covar: float):
    d = covs.shape[-1]
    eye = torch.eye(d, dtype=torch.float32, device=covs.device)
    return torch.linalg.cholesky(covs + reg_covar * eye[None])


def _init_params(valid: np.ndarray, k: int, d: int, seed: int, reg_covar: float):
    """EM init from a SHIFTED host sample → (means, covs, weights):
    k-means++ and ten host Lloyd steps, then per-cluster diagonal
    covariances and cluster-share weights from the init assignment."""
    means64, assign0 = _lloyd_refine(
        valid, _kmeans_pp_init(valid, k, seed), iters=10, return_assign=True
    )
    means = means64.astype(np.float32)
    covs = np.empty((k, d, d), dtype=np.float32)
    weights = np.empty((k,), dtype=np.float32)
    global_var = np.maximum(valid.var(axis=0), reg_covar)
    for j in range(k):
        mask = assign0 == j
        weights[j] = max(mask.mean(), 1e-6)
        if mask.sum() >= 2:
            covs[j] = np.diag(np.maximum(valid[mask].var(axis=0), reg_covar))
        else:
            covs[j] = np.diag(global_var)
    return means, covs, weights / weights.sum()


@register_model("GaussianMixtureModel")
@dataclass
class GaussianMixtureModel(ClusteringModel):
    weights: np.ndarray      # (k,)
    means: np.ndarray        # (k, d)
    covariances: np.ndarray  # (k, d, d)
    log_likelihood: float = 0.0      # TOTAL (Spark summary.logLikelihood)
    avg_log_likelihood: float = 0.0  # per-row mean (sklearn .score parity)
    n_iter: int = 0

    @property
    def k(self) -> int:
        return self.means.shape[0]

    @property
    def num_features(self) -> int:
        return int(np.shape(self.means)[1])

    @property
    def summary(self) -> ClusteringSummary:
        """Spark's summary surface (logLikelihood / numIter); the sizes of
        hard assignments are not stored, so ``cluster_sizes`` is None."""
        return ClusteringSummary(k=self.k, num_iter=self.n_iter,
                                 log_likelihood=float(self.log_likelihood))

    def _device_params(self, device):
        means = torch.tensor(np.asarray(self.means, np.float32), device=device)
        covs = torch.tensor(np.asarray(self.covariances, np.float32), device=device)
        logw = torch.log(torch.tensor(np.asarray(self.weights, np.float32), device=device))
        return logw, means, torch.linalg.cholesky(covs)

    def _log_resp(self, x, chunk: int = 65536):
        """Per chunk of rows: (start, (c, k) log weight + log density)."""
        check_features(x, self.means.shape[1], "GaussianMixtureModel")
        logw, means, chols = self._device_params(x.device)
        x = x.to(torch.float32)
        starts, c = _chunks(x.shape[0], chunk)
        for s in starts:
            yield s, _log_pdf(x[s:s + c], means, chols) + logw[None, :]

    def predict_proba(self, x: torch.Tensor) -> torch.Tensor:
        """(n, d) → (n, k) posteriors on x's device."""
        out = torch.empty((x.shape[0], self.k), dtype=torch.float32, device=x.device)
        for s, lr in self._log_resp(x):
            out[s:s + lr.shape[0]] = torch.exp(lr - torch.logsumexp(lr, dim=1)[:, None])
        return out

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] * self.k > (1 << 24):
            return self.predict_assigned(x)[0]
        return torch.argmax(self.predict_proba(x), dim=1).to(torch.int32)

    def predict_assigned(self, x: torch.Tensor, chunk: int = 65536):
        """→ (component (n,) int32, assigned-component posterior (n,)):
        ``argmax(predict_proba)`` one row chunk at a time, so no (n, k)
        tensor exists.  A row-sharded MeshArray is assigned shard by shard
        on each shard's device (two MeshArrays)."""
        if isinstance(x, MeshArray):
            pairs = {}

            def first(b):
                pairs[id(b)] = self.predict_assigned(b, chunk)
                return pairs[id(b)][0]

            pred = x.map_data(first)
            return pred, x.map_data(lambda b: pairs[id(b)][1])
        pred = torch.empty((x.shape[0],), dtype=torch.int32, device=x.device)
        prob = torch.empty((x.shape[0],), dtype=torch.float32, device=x.device)
        for s, lr in self._log_resp(x, chunk):
            top, arg = lr.max(dim=1)
            pred[s:s + lr.shape[0]] = arg.to(torch.int32)
            prob[s:s + lr.shape[0]] = torch.exp(top - torch.logsumexp(lr, dim=1))
        return pred, prob

    def score(self, data, device=None, mesh=None) -> float:
        """Mean per-row log-likelihood (over a mesh: each shard's sums on
        its device, added in ascending shard order)."""
        ds = on_mesh(data, None, device, None, mesh)

        def sums(i, s):
            logw, means, chols = self._device_params(s.x.device)
            return _e_step(s.x.to(torch.float32), s.w, logw, means, chols), s.w.sum()

        ll, n = Shards(ds).sum(sums)
        return float(ll / torch.clamp(n, min=1.0))

    def transform(self, data, label_col: str | None = None, device=None, mesh=None):
        """An AssembledTable comes back as its source Table with the
        ``prediction`` column and the assigned component's posterior as
        ``probability``; other inputs as :class:`PredictionResult`."""
        from ..features.assembler import AssembledTable
        from .base import host_array

        if isinstance(data, AssembledTable):
            n = len(data)
            ds = on_mesh(data.features, None, device, None, mesh)
            pred, prob = self.predict_assigned(ds.x)
            out = data.table.with_column(
                "prediction", host_array(pred)[:n].astype(np.int32), dtype="int")
            return out.with_column("probability", host_array(prob)[:n], dtype="float")
        return super().transform(data, label_col=label_col, device=device, mesh=mesh)

    def _artifacts(self):
        return (
            "GaussianMixtureModel",
            {
                "log_likelihood": self.log_likelihood,
                "avg_log_likelihood": self.avg_log_likelihood,
                "n_iter": self.n_iter,
            },
            {
                "weights": np.asarray(self.weights),
                "means": np.asarray(self.means),
                "covariances": np.asarray(self.covariances),
            },
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(
            weights=arrays["weights"],
            means=arrays["means"],
            covariances=arrays["covariances"],
            log_likelihood=float(params.get("log_likelihood", 0.0)),
            avg_log_likelihood=float(params.get("avg_log_likelihood", 0.0)),
            n_iter=int(params.get("n_iter", 0)),
        )


@dataclass(frozen=True)
class GaussianMixture(Estimator):
    k: int = 2
    max_iter: int = 100        # Spark default
    tol: float = 0.01          # Spark default (log-likelihood delta)
    seed: int = 0
    reg_covar: float = 1e-6
    init_sample_size: int = 65536
    #: rows per E-step chunk: bounds the (chunk, k) and (chunk, d²) tiles
    chunk_rows: int = 65536
    #: commit the EM state every ``checkpoint_every`` iterations, so a
    #: preempted fit resumes from the last commit
    checkpoint_dir: str | None = None
    checkpoint_every: int = 5
    weight_col: str | None = None  # Spark's weightCol
    #: begin EM from (weights (k,), means (k, d), covariances (k, d, d));
    #: a warm fit runs unshifted
    warm_start_params: tuple | None = None
    matmul_precision: str = "highest"

    def _warm_params(self, d: int):
        """Validated warm-start (weights, means, covs) as float32, or None."""
        if self.warm_start_params is None:
            return None
        w, m, c = self.warm_start_params
        w = np.asarray(w, np.float32)
        m = np.asarray(m, np.float32)
        c = np.asarray(c, np.float32)
        if w.shape != (self.k,) or m.shape != (self.k, d) or c.shape != (self.k, d, d):
            raise ValueError(
                "warm_start_params must be (weights (k,), means (k, d), "
                f"covariances (k, d, d)) for k={self.k}, d={d}; got "
                f"{w.shape}, {m.shape}, {c.shape}"
            )
        return w, m, c

    def _warm_fingerprint(self) -> str | None:
        """Warm-start identity for the checkpoint signature."""
        if self.warm_start_params is None:
            return None
        from ..io.fit_checkpoint import array_fingerprint

        return "|".join(array_fingerprint(np.asarray(a, dtype=np.float32))
                        for a in self.warm_start_params)

    def _start(self, signature, d: int, sample_fn):
        """→ (checkpointer or None, shift, means, covs, weights, first
        iteration, resumed prev_ll): the resumed commit (its unshifted
        means moved by this fit's shift), else the warm start (unshifted),
        else the init on the shifted host sample."""
        ckpt = resumed = None
        if signature is not None:
            from ..io.fit_checkpoint import FitCheckpointer

            ckpt = FitCheckpointer(self.checkpoint_dir, signature)
            resumed = ckpt.resume()
        warm = self._warm_params(d)
        if warm is None:
            valid = sample_fn()
            shift = (valid.mean(axis=0).astype(np.float32) if valid.shape[0]
                     else np.zeros((d,), np.float32))
        else:
            valid, shift = None, np.zeros((d,), np.float32)
        if resumed is not None:
            step0, arrays, extra = resumed
            # the float64 commit minus the shift is the float32 state exactly
            # (a float32 commit rounds as the JAX package's resume rounds it)
            means = (arrays["means"].astype(np.float64) - shift).astype(np.float32)
            covs = arrays["covariances"].astype(np.float32)
            weights = arrays["weights"].astype(np.float32)
            return ckpt, shift, means, covs, weights, step0 + 1, float(
                extra.get("prev_ll", -np.inf))
        if warm is not None:
            weights, means, covs = warm
        else:
            means, covs, weights = _init_params(valid - shift, self.k, d, self.seed,
                                                self.reg_covar)
        return ckpt, shift, means, covs, weights, 1, -np.inf

    def _host_loop(self, step, params, shift, start_it: int, prev_ll: float, ckpt,
                   on_iteration):
        """The reference's host loop: one EM iteration a ``step(params)``
        → (params, ll tensor), a commit every ``checkpoint_every``
        iterations (unshifted means), ``on_iteration(it, ll)``, and the stop
        at ``|ll − prev_ll| < tol`` in Python floats.  → (params, ll, last
        iteration)."""
        ll = prev_ll if np.isfinite(prev_ll) else 0.0
        it = start_it - 1
        for it in range(start_it, self.max_iter + 1):
            params, ll_d = step(params)
            ll = float(ll_d)  # TOTAL log-likelihood — Spark tol here
            if ckpt is not None and it % max(self.checkpoint_every, 1) == 0:
                means_d, covs_d, weights_d = params
                # unshifted means, in float64: the sum of two float32 arrays
                # is exact there, so a resume recovers the state bit for bit
                ckpt.save(
                    it,
                    {"means": means_d.cpu().numpy().astype(np.float64) + shift,
                     "covariances": covs_d, "weights": weights_d},
                    extra={"prev_ll": ll},
                )
            if on_iteration is not None:
                on_iteration(it, ll)
            if abs(ll - prev_ll) < self.tol:
                break
            prev_ll = ll
        return params, ll, it

    def _model(self, params, shift, ll: float, n: float, it: int) -> GaussianMixtureModel:
        means_d, covs_d, weights_d = params
        return GaussianMixtureModel(
            weights=weights_d.cpu().numpy(),
            means=means_d.cpu().numpy() + shift,
            covariances=covs_d.cpu().numpy(),
            log_likelihood=ll,
            avg_log_likelihood=ll / max(n, 1.0),
            n_iter=it,
        )

    #: ``fit`` runs over a mesh of more than one shard
    mesh_fit = True

    def fit(self, data, label_col: str | None = None, mesh=None, on_iteration=None,
            device=None) -> GaussianMixtureModel:
        """Fit on ``data`` (DeviceDataset, ShardedDataset, AssembledTable,
        (x, y[, w]) or x) on ``device`` (default the card) or over
        ``mesh``; a :class:`HostDataset`
        streams its blocks to ``device``.  ``on_iteration(it,
        log_likelihood)`` (optional) fires after every EM step."""
        validate_matmul_precision(self.matmul_precision)
        if isinstance(data, HostDataset):
            return self._fit_outofcore(data, stream_mesh(mesh, device), on_iteration)
        ds = on_mesh(data, None, device, self.weight_col, mesh)
        sh = Shards(ds)
        x = {i: s.x.to(torch.float32).contiguous() for i, s in sh.data.items()}
        w = {i: s.w.to(torch.float32).contiguous() for i, s in sh.data.items()}
        prepped = sh.with_rows(x=x, w=w)
        d = sh.n_features
        n = prepped.count()
        if n == 0:
            raise ValueError("GaussianMixture fit on an empty dataset")
        signature = None
        if self.checkpoint_dir:
            from ..io.fit_checkpoint import data_fingerprint

            # over shards the rows are signed by their global padded indices
            rows = prepped.dataset() if is_sharded(ds) else prepped.data[0]
            signature = {
                "estimator": "GaussianMixture", "k": self.k, "d": d,
                "data": data_fingerprint(rows.x, rows.w),
                "n_padded": ds.n_padded, "seed": self.seed,
                "warm": self._warm_fingerprint(),
                "reg_covar": self.reg_covar, "tol": self.tol,
            }
        # the init's bounded host sample (of every shard's rows) also gives
        # the recentering shift that keeps the float32 covariance refit
        # stable
        ckpt, shift, means, covs, weights, start_it, prev_ll = self._start(
            signature, d,
            lambda: sample_valid_rows(prepped.dataset(), self.init_sample_size, self.seed))
        params = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(sh.home)
                       for a in (means, covs, weights))
        step = self._em_step(sh, x, w, sh.put(torch.from_numpy(shift)), self.matmul_precision)
        params, ll, it = self._em(step, params, shift, start_it, prev_ll, ckpt, on_iteration)
        return self._model(params, shift, ll, n, it)

    def _em(self, step, params, shift, start_it: int, prev_ll: float, ckpt, on_iteration):
        """The EM iterations → (params, ll, last iteration): the
        reference's device loop (``|ll − prev_ll| >= tol`` in float32) with
        no checkpoint or ``on_iteration``, else its host loop."""
        if ckpt is None and on_iteration is None:
            it = 0
            prev, ll = np.float32(-np.inf), np.float32(np.inf)
            tol = np.float32(self.tol)
            while it < self.max_iter and np.abs(ll - prev) >= tol:
                params, ll_d = step(params)
                prev, ll = ll, np.float32(ll_d.item())
                it += 1
            return params, float(ll), it
        return self._host_loop(step, params, shift, start_it, prev_ll, ckpt, on_iteration)

    def _em_stats(self, sh: Shards, x: dict, w: dict, shift: dict, params, precision: str):
        """One E-step's statistics over the data shards of ``sh`` (``x`` /
        ``w`` / ``shift`` a shard's on its device): the parameters'
        Cholesky factors once on the home device, broadcast; :func:`_em_pass`
        a shard on its device; (nk, Σr·x, Σr·xxᵀ, ll) summed in ascending
        shard order on the home device."""
        means_d, covs_d, weights_d = params
        chols = sh.put(_gmm_chols(covs_d, self.reg_covar))
        logw, means = sh.put(torch.log(weights_d)), sh.put(means_d)
        return sh.sum(lambda i, s: _em_pass(x[i], w[i], shift[i], logw[i], means[i], chols[i],
                                            self.chunk_rows, precision))

    def _em_step(self, sh: Shards, x: dict, w: dict, shift: dict, precision: str):
        """→ ``step(params)`` → (params, ll): :meth:`_em_stats`, then the
        M-step on the home device."""
        def step(params):
            nk, sums, outer, ll = self._em_stats(sh, x, w, shift, params, precision)
            return _m_step_rule(nk, sums, outer, self.reg_covar), ll

        return step

    def _fit_outofcore(self, hd: HostDataset, mesh, on_iteration=None) -> GaussianMixtureModel:
        """Rows ≫ device memory: each EM iteration streams the blocks over
        ``mesh``, sums their chunked E-step statistics (nk, Σr·x, Σr·xxᵀ,
        ll) a shard on its device, over the block's shards in ascending
        order and then over the blocks, and applies one M-step on the home
        device; device memory stays bounded by the block size."""
        d = hd.n_features
        n = hd.count()
        if n == 0:
            raise ValueError("GaussianMixture fit on an empty dataset")
        signature = None
        if self.checkpoint_dir:
            from ..io.fit_checkpoint import data_fingerprint

            signature = {
                "estimator": "GaussianMixture", "storage": "outofcore",
                "k": self.k, "d": d,
                "data": data_fingerprint(hd.x, hd.w),
                "n": hd.n, "seed": self.seed,
                "warm": self._warm_fingerprint(),
                "reg_covar": self.reg_covar, "tol": self.tol,
            }
        ckpt, shift, means, covs, weights, start_it, prev_ll = self._start(
            signature, d, lambda: hd.sample_rows(self.init_sample_size, self.seed))
        dev = stream_home(mesh)
        params = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                       for a in (means, covs, weights))
        shift_d = torch.from_numpy(shift).to(dev)

        def step(params):
            means_d, covs_d, weights_d = params
            state = (shift_d, torch.log(weights_d), means_d, _gmm_chols(covs_d, self.reg_covar))

            def stats(i, sh):
                shift_s, logw, means_s, chols = (t.to(sh.x.device) for t in state)
                return _em_pass(sh.x, sh.w, shift_s, logw, means_s, chols, self.chunk_rows,
                                self.matmul_precision)

            tot = None
            for blk in hd.blocks(mesh):
                s = shard_sum(blk, stats)
                tot = s if tot is None else add_stats(tot, s)
            nk, sums, outer, ll = tot
            return _m_step_rule(nk, sums, outer, self.reg_covar), ll

        params, ll, it = self._host_loop(step, params, shift, start_it, prev_ll, ckpt,
                                         on_iteration)
        return self._model(params, shift, ll, n, it)

    # ---------------------------------------------------- partials protocol
    # Federated EM: silos run _em_pass on their private rows against the
    # broadcast parameters, the coordinator's zero-init ascending fold sums
    # the statistics, and _m_step_rule on the coordinator's device + a
    # host float32 mirror of the device loop's |ll − prev_ll| test replay
    # the resident loop.  Everything runs unshifted (the warm start's
    # convention).  _em_pass folds zero-initialized chunks in order, so
    # with one chunk_rows chunk a silo the merge IS the pooled fold and a
    # warm federated fit equals the pooled warm fit bit for bit.
    partials_family = "gmm"

    def partials_max_rounds(self) -> int:
        return self.max_iter

    def init_partials_state(self, n_features: int, mesh=None):
        from ..federated.partials import FitState

        warm = self._warm_params(n_features)
        if warm is None:
            return None  # the coordinator runs the candidate init round
        weights, means, covs = warm
        return FitState(
            family=self.partials_family, version=0,
            params={"weights": weights, "means": means, "covariances": covs},
            # the device loop's first test compares ll₁ against +inf: the
            # host mirror starts there to reproduce iteration counts
            meta={"prev_ll": float("inf"), "ll": 0.0, "n": 0.0},
        )

    def local_init_stats(self, data, label_col: str | None = None, mesh=None, device=None):
        """One silo's init contribution: local k-means++ candidates of its
        sample (candidate centers cross the wire, never rows)."""
        from ..federated.partials import Partials

        ds = on_mesh(data, None, None if mesh is not None else device, self.weight_col,
                     mesh)
        sample = np.asarray(sample_valid_rows(ds, self.init_sample_size, self.seed), np.float64)
        n_cand = min(max(4 * self.k, 2 * self.k + 8), sample.shape[0])
        cand = _kmeans_pp_init(sample, n_cand, self.seed)
        return Partials(
            family="gmm.init",
            stats={"candidates": np.asarray(cand, np.float64)},
            n_rows=float(sample.shape[0]),
        )

    def init_state_from_merged(self, merged):
        """Round-0 EM parameters from the concatenated per-silo candidates
        (the pooled sample init's ``_init_params`` on the candidate pool,
        unshifted; host numpy, bit-equal to the reference)."""
        from ..federated.partials import FitState

        cand = np.asarray(merged.stats["candidates"], np.float64)
        d = cand.shape[1]
        means, covs, weights = _init_params(cand, self.k, d, self.seed, self.reg_covar)
        return FitState(
            family=self.partials_family, version=0,
            params={
                "weights": np.asarray(weights, np.float32),
                "means": np.asarray(means, np.float32),
                "covariances": np.asarray(covs, np.float32),
            },
            meta={"prev_ll": float("inf"), "ll": 0.0, "n": 0.0},
        )

    def partial_fit_stats(self, data, label_col: str | None = None, mesh=None, state=None,
                          final: bool = False, device=None):
        """One silo's E-step statistics (nk, Σr·x, Σr·xxᵀ, ll): one
        unshifted :func:`_em_pass` on ``device`` (default the card; a
        DeviceDataset where it lies)."""
        from ..federated.partials import Partials

        if state is None:
            raise ValueError("gmm partials need the broadcast FitState")
        validate_matmul_precision(self.matmul_precision)
        ds = on_mesh(data, None, None if mesh is not None else device, self.weight_col,
                     mesh)
        sh = Shards(ds)
        covs_d, weights_d, means_d = (
            torch.from_numpy(np.ascontiguousarray(state.params[k], np.float32)).to(sh.home)
            for k in ("covariances", "weights", "means"))
        x = {i: s.x.to(torch.float32).contiguous() for i, s in sh.data.items()}
        w = {i: s.w.to(torch.float32).contiguous() for i, s in sh.data.items()}
        zero = sh.put(torch.zeros((ds.n_features,), dtype=torch.float32))
        nk, sums, outer, ll = self._em_stats(sh, x, w, zero, (means_d, covs_d, weights_d),
                                             self.matmul_precision)
        return Partials(
            family=self.partials_family,
            stats={"nk": nk.cpu().numpy(), "sums": sums.cpu().numpy(),
                   "outer": outer.cpu().numpy(), "ll": ll.cpu().numpy()},
            n_rows=sh.count(),
            state_version=state.version,
        )

    def apply_partials(self, state, merged, device=None):
        """The M-step on ``device`` (default the card), and the stop
        decided on the host as the resident device loop decides it:
        ``|ll − prev_ll| < tol`` in float32."""
        from ..federated.partials import FitState

        dev = resolve_device(device)
        means, covs, weights = _m_step_rule(
            *(torch.from_numpy(np.asarray(merged.stats[k], np.float32)).to(dev)
              for k in ("nk", "sums", "outer")),
            self.reg_covar,
        )
        ll = np.float32(np.asarray(merged.stats["ll"]))
        prev_ll = np.float32(state.meta.get("prev_ll", float("inf")))
        version = state.version + 1
        done = bool(np.abs(ll - prev_ll) < np.float32(self.tol))
        done = done or version >= self.max_iter
        return FitState(
            family=self.partials_family, version=version,
            params={"weights": weights.cpu().numpy(), "means": means.cpu().numpy(),
                    "covariances": covs.cpu().numpy()},
            meta={"prev_ll": float(ll), "ll": float(ll), "n": float(merged.n_rows)},
        ), done

    def fit_from_partials(self, merged, state=None, device=None) -> GaussianMixtureModel:
        """The converged ``state``'s parameters as the model (host arrays)."""
        if state is None:
            raise ValueError("gmm fit_from_partials needs the converged FitState")
        ll = float(state.meta.get("ll", 0.0))
        n = float(state.meta.get("n", 0.0))
        return GaussianMixtureModel(
            weights=np.asarray(state.params["weights"], np.float32),
            means=np.asarray(state.params["means"], np.float32),
            covariances=np.asarray(state.params["covariances"], np.float32),
            log_likelihood=ll,
            avg_log_likelihood=ll / max(n, 1.0),
            n_iter=state.version,
        )
