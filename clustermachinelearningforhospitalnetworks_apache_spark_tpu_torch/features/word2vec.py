"""Word2Vec + FeatureHasher (the JAX package's ``features/word2vec.py``;
``pyspark.ml.feature``).

Word2Vec: skip-gram with negative sampling (Mikolov et al.).  The host
builds the vocabulary and the (center, context) pair table once from the
token lists (string work stays on the host) and draws every random
number with numpy, as the JAX package does; training runs on ``device``
(default the card) as one Python step per pair minibatch: an embedding
gather, a dot product against 1 positive + k sampled negatives (one
batched product), the sigmoid loss gradient, and two scatter-adds.

The scatter-adds are deterministic: ``index_put_(accumulate=True)`` under
``torch.use_deterministic_algorithms`` sums each row's duplicates in a
fixed order on the card (a plain CUDA ``index_add_`` uses float atomics,
whose order moves between runs) and in index order on the CPU, as the
JAX package's CPU scatter does.  Two fits of one seed on one card give
bit-equal vectors.

``transform`` averages word vectors per document (Spark's document
embedding rule: mean of found tokens, zeros when none found);
``find_synonyms`` ranks by cosine similarity.

FeatureHasher: Spark's row-dict hasher — numeric values accumulate at
``hash(col) % F`` with their value, string/categorical values accumulate
1.0 at ``hash(col + '=' + value) % F``; CRC32 keeps it process-stable.
"""

from __future__ import annotations

import contextlib
import zlib
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from ..device import resolve_device
from ..io.model_io import register_model
from .text import HashingTF, _tokens_column


@contextlib.contextmanager
def _deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the block, restored
    after it."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def _scatter_add(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> None:
    """``table[idx] += rows`` with duplicate indices summed in a fixed
    order (see the module docstring).  The mode covers the scatter alone:
    under it a cuBLAS product raises unless ``CUBLAS_WORKSPACE_CONFIG`` is
    set."""
    with _deterministic():
        table.index_put_((idx,), rows, accumulate=True)


def _sgns_train(emb_in, emb_out, centers, contexts, negatives, lr: float, batch: int,
                neg: int, steps: int):
    """Skip-gram negative-sampling SGD over pre-drawn pair minibatches, on
    the device of the tensors; updates ``emb_in`` / ``emb_out`` in place
    and returns them.

    centers/contexts: (steps·batch,) int64; negatives: (steps·batch, neg).
    Per step: gather embeddings, one batched (B, 1+neg) score product,
    sigmoid-loss gradients scattered back — the classic SGNS update.
    """
    labels = torch.zeros((batch, 1 + neg), dtype=torch.float32, device=emb_in.device)
    labels[:, 0] = 1.0
    d = emb_in.shape[1]
    for i in range(steps):
        sl = slice(i * batch, (i + 1) * batch)
        c = centers[sl]
        targets = torch.cat([contexts[sl, None], negatives[sl]], dim=1)   # (B, 1+neg)
        v = emb_in[c]                                   # (B, d)
        u = emb_out[targets]                            # (B, 1+neg, d)
        scores = torch.einsum("bd,bkd->bk", v, u)
        # mean-loss scaling: scatter-adds SUM duplicate-index grads, so the
        # per-step update must be the batch MEAN or the effective lr
        # multiplies by B and the embeddings blow up along a shared direction
        g = (torch.sigmoid(scores) - labels) / batch
        grad_v = torch.einsum("bk,bkd->bd", g, u)
        grad_u = g[:, :, None] * v[:, None, :]
        _scatter_add(emb_in, c, -lr * grad_v)
        _scatter_add(emb_out, targets.reshape(-1), (-lr * grad_u).reshape(-1, d))
    return emb_in, emb_out


@register_model("Word2VecModel")
@dataclass
class Word2VecModel:
    vocabulary: tuple
    vectors: np.ndarray              # (|vocab|, d)

    @cached_property
    def _index(self) -> dict:
        """token → row, built once (transform is called per batch)."""
        return {t: i for i, t in enumerate(self.vocabulary)}

    @property
    def vector_size(self) -> int:
        return self.vectors.shape[1]

    def get_vectors(self) -> dict:
        return {t: self.vectors[i] for i, t in enumerate(self.vocabulary)}

    def transform(self, tokens) -> np.ndarray:
        """(n, d) document embeddings: mean of found token vectors
        (Spark's rule; all-unknown documents embed to zeros)."""
        index = self._index
        rows = _tokens_column(tokens)
        out = np.zeros((len(rows), self.vector_size), np.float32)
        for i, row in enumerate(rows):
            ids = [index[t] for t in row if t in index]
            if ids:
                out[i] = self.vectors[ids].mean(axis=0)
        return out

    def find_synonyms(self, word: str, num: int = 5):
        """[(term, cosine similarity), ...] excluding the query word."""
        index = self._index
        if word not in index:
            raise KeyError(f"{word!r} is not in the fitted vocabulary")
        v = self.vectors[index[word]]
        norms = np.linalg.norm(self.vectors, axis=1) * max(
            np.linalg.norm(v), 1e-12
        )
        sims = self.vectors @ v / np.maximum(norms, 1e-12)
        order = np.argsort(sims)[::-1]
        out = []
        for j in order:
            if self.vocabulary[j] != word:
                out.append((self.vocabulary[j], float(sims[j])))
            if len(out) == num:
                break
        return out

    def _artifacts(self):
        return (
            "Word2VecModel",
            {"vocabulary": list(self.vocabulary)},
            {"vectors": np.asarray(self.vectors)},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(vocabulary=tuple(params["vocabulary"]), vectors=arrays["vectors"])


@dataclass(frozen=True)
class Word2Vec:
    """Spark defaults where they transfer: vectorSize 100, windowSize 5,
    minCount 5, maxIter 1.  ``step_size`` applies to batch-MEAN gradients
    (Spark's 0.025 is a per-pair SGD rate; the equivalent mean-batch rate
    is larger), ``num_negatives`` is the SGNS sample count (Spark's
    hierarchical softmax has no analogue knob)."""

    vector_size: int = 100
    window_size: int = 5
    min_count: int = 5
    max_iter: int = 1
    step_size: float = 0.5
    num_negatives: int = 5
    batch_size: int = 1024
    seed: int = 0

    def fit(self, tokens, device=None) -> Word2VecModel:
        """Vocabulary, pairs and draws on the host; training on ``device``
        (default the card)."""
        dev = resolve_device(device)
        if self.vector_size < 1:
            raise ValueError(f"vector_size must be >= 1, got {self.vector_size}")
        if self.max_iter < 1:
            raise ValueError(f"max_iter must be >= 1, got {self.max_iter}")
        if self.window_size < 1:
            raise ValueError(f"window_size must be >= 1, got {self.window_size}")
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")
        if self.num_negatives < 1:
            raise ValueError(
                f"num_negatives must be >= 1, got {self.num_negatives}"
            )
        rows = _tokens_column(tokens)
        counts: dict[str, int] = {}
        for row in rows:
            for t in row:
                counts[t] = counts.get(t, 0) + 1
        vocab = sorted(
            (t for t, c in counts.items() if c >= self.min_count),
            key=lambda t: (-counts[t], t),
        )
        if not vocab:
            raise ValueError(
                f"no token reaches min_count={self.min_count}; vocabulary empty"
            )
        index = {t: i for i, t in enumerate(vocab)}
        v = len(vocab)

        # host pass: (center, context) pairs within the window
        centers, contexts = [], []
        for row in rows:
            ids = [index[t] for t in row if t in index]
            for i, c in enumerate(ids):
                lo = max(0, i - self.window_size)
                hi = min(len(ids), i + self.window_size + 1)
                for j in range(lo, hi):
                    if j != i:
                        centers.append(c)
                        contexts.append(ids[j])
        if not centers:
            raise ValueError("no skip-gram pairs (documents too short)")
        centers = np.asarray(centers, np.int32)
        contexts = np.asarray(contexts, np.int32)

        # unigram^0.75 negative-sampling table (Mikolov's distribution)
        freq = np.asarray([counts[t] for t in vocab], np.float64) ** 0.75
        p_neg = freq / freq.sum()

        rng = np.random.default_rng(self.seed)
        d = self.vector_size
        emb_in = torch.from_numpy(
            rng.uniform(-0.5 / d, 0.5 / d, size=(v, d)).astype(np.float32)
        ).to(dev)
        emb_out = torch.zeros((v, d), dtype=torch.float32, device=dev)
        centers_t = torch.from_numpy(centers.astype(np.int64)).to(dev)
        contexts_t = torch.from_numpy(contexts.astype(np.int64)).to(dev)

        n_pairs = len(centers)
        batch = min(self.batch_size, n_pairs)
        for _ in range(self.max_iter):
            perm = rng.permutation(n_pairs)
            # ceil-div + wrap-around fill: the shuffled tail trains too
            # (truncating would silently drop up to batch−1 pairs/epoch)
            steps = -(-n_pairs // batch)
            take = torch.from_numpy(np.resize(perm, steps * batch)).to(dev)
            negs = rng.choice(
                v, size=(steps * batch, self.num_negatives), p=p_neg
            ).astype(np.int32)
            emb_in, emb_out = _sgns_train(
                emb_in, emb_out, centers_t[take], contexts_t[take],
                torch.from_numpy(negs.astype(np.int64)).to(dev), float(np.float32(self.step_size)),
                batch, self.num_negatives, steps,
            )
        return Word2VecModel(vocabulary=tuple(vocab), vectors=emb_in.cpu().numpy())


@register_model("FeatureHasher")
@dataclass(frozen=True)
class FeatureHasher:
    """Hash mixed-type row dicts into a fixed-width vector (Spark's
    semantics: numeric columns land at hash(col) with their value,
    string/bool values at hash(col=value) with 1.0)."""

    num_features: int = 1 << 18
    # ONE budget policy for every dense hasher (shared with HashingTF)
    _MAX_DENSE_ELEMS = HashingTF._MAX_DENSE_ELEMS

    def __post_init__(self):
        if self.num_features < 1:
            raise ValueError(f"num_features must be >= 1, got {self.num_features}")

    def _artifacts(self):
        return ("FeatureHasher", {"num_features": self.num_features}, {})

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(num_features=int(params["num_features"]))

    def transform(self, rows) -> np.ndarray:
        """``rows``: iterable of {column: value} dicts (or a Table, whose
        rows are hashed column-wise)."""
        from ..core.table import Table

        if isinstance(rows, Table):
            cols = {c: rows.column(c) for c in rows.columns}
            rows = [
                {c: cols[c][i] for c in cols} for i in range(len(rows))
            ]
        rows = list(rows)
        if len(rows) * self.num_features > self._MAX_DENSE_ELEMS:
            raise ValueError(
                f"dense FeatureHasher output {len(rows)}×{self.num_features} "
                f"exceeds the element budget; lower num_features"
            )
        out = np.zeros((len(rows), self.num_features), np.float32)
        for i, row in enumerate(rows):
            if not isinstance(row, dict):
                raise TypeError(
                    f"FeatureHasher rows must be dicts; got {type(row).__name__}"
                )
            for col, val in row.items():
                # nulls contribute nothing (Spark ignores missing values)
                if val is None or (
                    isinstance(val, (float, np.floating)) and np.isnan(val)
                ):
                    continue
                if isinstance(val, (bool, np.bool_, str, np.str_)):
                    j = zlib.crc32(f"{col}={val}".encode()) % self.num_features
                    out[i, j] += 1.0
                else:
                    j = zlib.crc32(str(col).encode()) % self.num_features
                    out[i, j] += float(val)
        return out


__all__ = ["FeatureHasher", "Word2Vec", "Word2VecModel"]
