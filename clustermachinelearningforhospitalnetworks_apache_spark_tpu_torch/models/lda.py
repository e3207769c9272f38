"""LDA — latent Dirichlet allocation (the JAX package's ``models/lda.py``;
``pyspark.ml.clustering.LDA``).

Online variational Bayes (Hoffman, Blei & Bach 2010) — the algorithm
behind Spark's default ``optimizer="online"``.  Each iteration is one pass
over the document-term matrix on ``device`` (default the card):

- E-step: every document's variational γ runs as a FIXED number of
  batched fixed-point sweeps of ``γ = α + (counts · φ)`` with
  φ ∝ exp(E[log θ])·exp(E[log β]) — all documents at once, two products
  per sweep (the classic Blei-code vectorization: work with the (n, k)
  and (k, v) expected-log matrices, never materialize per-word φ).
- M-step: λ ← (1−ρ)λ + ρ·λ̂ with ρ_t = (τ₀+t)^{−κ} (Spark's
  learningOffset/learningDecay defaults 1024/0.51).

Over a mesh (``fit(..., mesh=)`` or a ``ShardedDataset``; one device is
one shard of ``base.Shards``) the E-step runs once a data shard on its
device, the sufficient statistics are summed in ascending shard order and
λ is updated once on the home device, then sent to every shard.  A
:class:`~..parallel.outofcore.HostDataset` trains as Hoffman's minibatch
form, one streamed block an update (a block over the mesh's shards, its
size rounded to the data axis as the reference rounds it).  ``transform`` returns
per-document topic mixtures; ``describe_topics`` and the variational
``log_perplexity`` bound mirror Spark's surface.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..data import DeviceDataset
from ..device import resolve_device
from ..io.model_io import register_model
from .base import Estimator, Model, Shards, check_features, on_mesh


def _dirichlet_expectation(a):
    """Row-wise E[log X] for X ~ Dir(a) on a 2-D parameter matrix:
    digamma(a) − digamma(Σ_row a)."""
    return torch.special.digamma(a) - torch.special.digamma(
        torch.sum(a, dim=-1, keepdim=True)
    )


def _e_step(counts, w, expelog_beta, alpha: float, n_sweeps: int):
    """Batched variational E-step.

    counts: (n, v) document-term matrix (pad rows w=0 are inert);
    expelog_beta: (k, v) exp(E[log β]).  → (γ (n, k), sstats (k, v)).
    """
    n = counts.shape[0]
    k = expelog_beta.shape[0]
    gamma = torch.ones((n, k), dtype=torch.float32, device=counts.device)
    for _ in range(n_sweeps):
        expelog_theta = torch.exp(_dirichlet_expectation(gamma))    # (n, k)
        # φ normalizer per (doc, word): Σ_k expelogθ·expelogβ
        norm = expelog_theta @ expelog_beta + 1e-30                 # (n, v)
        gamma = alpha + expelog_theta * ((counts / norm) @ expelog_beta.T)
    expelog_theta = torch.exp(_dirichlet_expectation(gamma))
    norm = expelog_theta @ expelog_beta + 1e-30
    # sufficient statistics for λ̂: sstats[k, w] = Σ_d φ_dwk·counts (before
    # the final expelog_beta factor, which multiplies back in the M-step)
    sstats = expelog_theta.T @ ((counts * w[:, None]) / norm)       # (k, v)
    return gamma, sstats


def _counts_on(counts, device) -> torch.Tensor:
    """A count matrix as float32 on ``device`` (default the card); a
    tensor stays where it lies."""
    if isinstance(counts, torch.Tensor):
        return counts.to(torch.float32)
    return torch.as_tensor(np.asarray(counts, np.float32), device=resolve_device(device))


@register_model("LDAModel")
@dataclass
class LDAModel(Model):
    lam: np.ndarray                  # (k, v) topic-word Dirichlet params
    alpha: float
    eta: float
    n_docs_trained: float = 0.0
    e_step_sweeps: int = 50          # inference sweeps (fit-time setting)

    @property
    def k(self) -> int:
        return self.lam.shape[0]

    @property
    def vocab_size(self) -> int:
        return self.lam.shape[1]

    def topics_matrix(self) -> np.ndarray:
        """(vocab, k) column-normalized topic-word probabilities (Spark's
        ``topicsMatrix`` orientation)."""
        t = np.asarray(self.lam, np.float64)
        return (t / t.sum(axis=1, keepdims=True)).T

    def describe_topics(self, max_terms: int = 10):
        """[(term indices, weights), ...] per topic — Spark's surface."""
        probs = self.topics_matrix().T        # (k, v)
        out = []
        for kk in range(self.k):
            idx = np.argsort(probs[kk])[::-1][:max_terms]
            out.append((idx.astype(np.int64), probs[kk][idx]))
        return out

    def _expelog_beta(self, dev):
        lam = torch.as_tensor(np.asarray(self.lam, np.float32), device=dev)
        return torch.exp(_dirichlet_expectation(lam))

    def _gamma(self, x):
        check_features(x, self.vocab_size, "LDAModel")
        expelog_beta = self._expelog_beta(x.device)
        gamma, _ = _e_step(x, torch.ones((x.shape[0],), dtype=torch.float32, device=x.device),
                           expelog_beta, float(np.float32(self.alpha)), self.e_step_sweeps)
        return gamma, expelog_beta

    def transform(self, counts, mesh=None, device=None) -> np.ndarray:
        """(n, k) normalized per-document topic mixtures (Spark's
        ``topicDistribution`` column), inferred on ``device`` (default
        the card; a tensor where it lies) or on ``mesh``'s first device,
        where the reference infers them unsharded."""
        if mesh is not None:
            if device is not None:
                raise ValueError("pass a mesh or a device, not both")
            device = mesh.device(0, 0)
        gamma, _ = self._gamma(_counts_on(counts, device))
        g = gamma.cpu().numpy().astype(np.float64)
        return g / g.sum(axis=1, keepdims=True)

    def log_perplexity(self, counts, device=None) -> float:
        """Upper bound on per-token perplexity via the variational bound
        (lower is better; Spark's ``logPerplexity`` analogue), on
        ``device`` (default the card; a tensor where it lies)."""
        x = _counts_on(counts, device)
        gamma, expelog_beta = self._gamma(x)
        expelog_theta = torch.exp(_dirichlet_expectation(gamma))
        norm = expelog_theta @ expelog_beta + 1e-30
        ll = torch.sum(x * torch.log(norm))
        tokens = torch.clamp(torch.sum(x), min=1.0)
        return float(-ll / tokens)

    def _artifacts(self):
        return (
            "LDAModel",
            {
                "alpha": float(self.alpha),
                "eta": float(self.eta),
                "n_docs_trained": float(self.n_docs_trained),
                "e_step_sweeps": int(self.e_step_sweeps),
            },
            {"lam": np.asarray(self.lam)},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(
            lam=arrays["lam"],
            alpha=float(params["alpha"]),
            eta=float(params["eta"]),
            n_docs_trained=float(params.get("n_docs_trained", 0.0)),
            e_step_sweeps=int(params.get("e_step_sweeps", 50)),
        )


@dataclass(frozen=True)
class LDA(Estimator):
    """Spark defaults: k 10, maxIter 20, docConcentration α = 1/k,
    topicConcentration η = 1/k, learningOffset 1024, learningDecay 0.51,
    optimizer "online" (the one implemented)."""

    k: int = 10
    max_iter: int = 20
    doc_concentration: float | None = None      # None → 1/k (Spark auto)
    topic_concentration: float | None = None    # None → 1/k
    learning_offset: float = 1024.0
    learning_decay: float = 0.51
    e_step_sweeps: int = 50
    optimizer: str = "online"
    seed: int = 0

    def _priors(self) -> tuple[float, float]:
        alpha = self.doc_concentration if self.doc_concentration is not None else 1.0 / self.k
        eta = self.topic_concentration if self.topic_concentration is not None else 1.0 / self.k
        return alpha, eta

    def _init_lam(self, v: int, dev) -> torch.Tensor:
        rng = np.random.default_rng(self.seed)
        return torch.from_numpy(
            rng.gamma(100.0, 1.0 / 100.0, size=(self.k, v)).astype(np.float32)
        ).to(dev)

    def _update(self, lam, shard_sum, alpha: float, eta: float, scale: float, t: int):
        """One online step: ``shard_sum(fn)`` sums ``fn(i, shard)``'s
        statistics over the documents' shards in shard order; each shard's
        E-step runs on its device against exp(E[log β]) sent there, and its
        statistics are scaled by ``scale`` (n / |batch|; 1 on the full
        batch)."""
        expelog_beta = torch.exp(_dirichlet_expectation(lam))
        a = float(np.float32(alpha))

        def stats(i, s):
            eb = expelog_beta.to(s.x.device)
            return (_e_step(s.x.to(torch.float32), s.w.to(torch.float32), eb, a,
                            self.e_step_sweeps)[1],)

        sstats = shard_sum(stats)[0]
        lam_hat = eta + (scale * sstats if scale != 1.0 else sstats) * expelog_beta
        rho = (self.learning_offset + t) ** (-self.learning_decay)
        return (1.0 - rho) * lam + rho * lam_hat

    def fit(self, counts, label_col: str | None = None, device=None, mesh=None) -> LDAModel:
        """``counts``: (n_docs, vocab) term-count matrix (CountVectorizer
        output shape), moved to ``device`` (default the card) or laid over
        ``mesh``; a DeviceDataset, ShardedDataset or tensor trains where it
        lies, a HostDataset streams its blocks to ``device`` or over
        ``mesh``."""
        if self.optimizer != "online":
            raise ValueError(
                f"optimizer must be 'online' (Spark's default; EM is not "
                f"implemented); got {self.optimizer!r}"
            )
        if self.k < 2:
            raise ValueError(f"k must be >= 2, got {self.k}")
        from ..parallel.outofcore import HostDataset

        if isinstance(counts, HostDataset):
            return self._fit_outofcore(counts, mesh, device)
        if isinstance(counts, torch.Tensor):
            counts = DeviceDataset(x=counts, y=counts.new_zeros(counts.shape[0]),
                                   w=counts.new_ones(counts.shape[0], dtype=torch.float32))
        sh = Shards(on_mesh(counts, None, device, None, mesh))
        lo = sh.rows(lambda i, s: s.x.min().reshape(1)).min()
        if lo < 0:
            raise ValueError("LDA needs a non-negative term-count matrix")
        n, v = int(sh.sum(lambda i, s: (torch.sum(s.w > 0),))[0]), sh.n_features
        if n == 0:
            raise ValueError("LDA fit on an empty dataset")
        alpha, eta = self._priors()
        lam = self._init_lam(v, sh.home)
        for t in range(self.max_iter):
            lam = self._update(lam, sh.sum, alpha, eta, 1.0, t)
        return LDAModel(
            lam=lam.cpu().numpy(),
            alpha=float(alpha),
            eta=float(eta),
            n_docs_trained=float(n),
            e_step_sweeps=self.e_step_sweeps,
        )

    def _fit_outofcore(self, hd, mesh=None, device=None) -> LDAModel:
        """Docs ≫ device memory online VB — Hoffman's algorithm in its
        NATIVE form: each update consumes one minibatch (here: one
        streamed host block, over ``mesh`` or on ``device``) with
        sufficient statistics scaled by n/|batch|, blended at rate ρ_t.
        Each block step counts as one iteration (Spark's convention too);
        |batch| counts the valid rows of the block's span at the
        mesh-rounded block size."""
        from ..parallel.outofcore import shard_sum, stream_home, stream_mesh

        if np.min(hd.x) < 0:
            raise ValueError("LDA needs a non-negative term-count matrix")
        w_host = (
            np.asarray(hd.w) if hd.w is not None else np.ones(hd.n, np.float32)
        )
        n = int(np.sum(w_host > 0))
        if n == 0:
            raise ValueError("LDA fit on an empty dataset")
        alpha, eta = self._priors()
        home = stream_home(stream_mesh(mesh, device))
        lam = self._init_lam(hd.n_features, home)
        n_blocks, b = hd.block_shape(mesh)
        shuffle = np.random.default_rng(self.seed + 1)
        t = 0
        while t < self.max_iter:
            perm = shuffle.permutation(n_blocks)
            for i, blk in zip(perm, hd.blocks(mesh, order=perm, device=device)):
                if t >= self.max_iter:
                    break
                s, e = int(i) * b, min(int(i) * b + b, hd.n)
                bsz = max(float(np.sum(w_host[s:e] > 0)), 1.0)
                lam = self._update(lam, lambda fn: shard_sum(blk, fn), alpha, eta,
                                   n / bsz, t)
                t += 1
        return LDAModel(
            lam=lam.cpu().numpy(),
            alpha=float(alpha),
            eta=float(eta),
            n_docs_trained=float(n),
            e_step_sweeps=self.e_step_sweeps,
        )


__all__ = ["LDA", "LDAModel"]
