"""Text feature stages (the JAX package's ``features/text.py``):
Tokenizer, RegexTokenizer, StopWordsRemover, NGram, CountVectorizer,
HashingTF, IDF, DCT.

Parity with the corresponding ``pyspark.ml.feature`` stages.  Tokenizing,
stop words, n-grams, the vocabulary and the count matrices are host
string work over object columns, as in the JAX package, and take no
``device=``; ``CountVectorizer`` / ``HashingTF`` emit exactly the dense
(n, v) float32 term matrix LDA / NaiveBayes / IDF consume.
``IDFModel.transform`` keeps a tensor on its device (an ndarray comes
back an ndarray) and ``DCT.transform`` runs on ``device`` (default the
card; a tensor where it lies).

Hashing uses CRC32 (deterministic across processes — Python's ``hash``
is salted per interpreter and would make HashingTF output unstable
between a fit and a later serve process).
"""

from __future__ import annotations

import re
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..io.model_io import register_model

# Spark's english stop-word default list (loadDefaultStopWords) — the
# commonly hit subset; extend via the stop_words param.
_ENGLISH_STOP_WORDS = (
    "a an and are as at be but by for if in into is it no not of on or "
    "such that the their then there these they this to was will with i "
    "me my we our you your he him his she her its them what which who "
    "whom am been being have has had having do does did doing would "
    "should could ought"
).split()


def _tokens_column(col) -> list[list[str]]:
    """Accept an object column of token lists (pass through) — raises on
    plain strings so mis-wired stages fail loudly."""
    out = []
    for v in col:
        if isinstance(v, (list, tuple, np.ndarray)):
            out.append([str(t) for t in v])
        else:
            raise TypeError(
                f"expected token lists (Tokenizer output); got {type(v).__name__}"
            )
    return out


def _as_object_column(rows: list[list[str]]) -> np.ndarray:
    out = np.empty(len(rows), object)
    for i, r in enumerate(rows):
        out[i] = list(r)
    return out


@register_model("Tokenizer")
@dataclass(frozen=True)
class Tokenizer:
    """Lowercase whitespace tokenizer (Spark's ``Tokenizer``)."""

    def _artifacts(self):
        return ("Tokenizer", {}, {})

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls()

    def transform(self, texts) -> np.ndarray:
        return _as_object_column(
            [str(t).lower().split() for t in np.asarray(texts, object)]
        )


@register_model("RegexTokenizer")
@dataclass(frozen=True)
class RegexTokenizer:
    """Spark defaults: pattern "\\s+" used as a DELIMITER (gaps=True),
    min_token_length 1, to_lowercase True; gaps=False matches tokens."""

    pattern: str = r"\s+"
    gaps: bool = True
    min_token_length: int = 1
    to_lowercase: bool = True

    def _artifacts(self):
        return (
            "RegexTokenizer",
            {
                "pattern": self.pattern,
                "gaps": self.gaps,
                "min_token_length": self.min_token_length,
                "to_lowercase": self.to_lowercase,
            },
            {},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(
            pattern=params["pattern"],
            gaps=bool(params["gaps"]),
            min_token_length=int(params["min_token_length"]),
            to_lowercase=bool(params["to_lowercase"]),
        )

    def transform(self, texts) -> np.ndarray:
        rx = re.compile(self.pattern)
        rows = []
        for t in np.asarray(texts, object):
            s = str(t).lower() if self.to_lowercase else str(t)
            toks = rx.split(s) if self.gaps else rx.findall(s)
            rows.append([x for x in toks if len(x) >= self.min_token_length])
        return _as_object_column(rows)


@register_model("StopWordsRemover")
@dataclass(frozen=True)
class StopWordsRemover:
    stop_words: tuple = tuple(_ENGLISH_STOP_WORDS)
    case_sensitive: bool = False

    def _artifacts(self):
        return (
            "StopWordsRemover",
            {
                "stop_words": list(self.stop_words),
                "case_sensitive": self.case_sensitive,
            },
            {},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(
            stop_words=tuple(params["stop_words"]),
            case_sensitive=bool(params["case_sensitive"]),
        )

    def transform(self, tokens) -> np.ndarray:
        if self.case_sensitive:
            stop = set(self.stop_words)
            keep = lambda t: t not in stop
        else:
            stop = {w.lower() for w in self.stop_words}
            keep = lambda t: t.lower() not in stop
        return _as_object_column(
            [[t for t in row if keep(t)] for row in _tokens_column(tokens)]
        )


@register_model("NGram")
@dataclass(frozen=True)
class NGram:
    n: int = 2

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")

    def _artifacts(self):
        return ("NGram", {"n": self.n}, {})

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(n=int(params["n"]))

    def transform(self, tokens) -> np.ndarray:
        rows = []
        for row in _tokens_column(tokens):
            rows.append(
                [" ".join(row[i : i + self.n]) for i in range(len(row) - self.n + 1)]
            )
        return _as_object_column(rows)


@register_model("CountVectorizerModel")
@dataclass(frozen=True)
class CountVectorizerModel:
    vocabulary: tuple                 # term strings, index = column
    binary: bool = False
    min_tf: float = 1.0

    def _artifacts(self):
        return (
            "CountVectorizerModel",
            {
                "vocabulary": list(self.vocabulary),
                "binary": self.binary,
                "min_tf": self.min_tf,
            },
            {},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(
            vocabulary=tuple(params["vocabulary"]),
            binary=bool(params.get("binary", False)),
            min_tf=float(params.get("min_tf", 1.0)),
        )

    def transform(self, tokens) -> np.ndarray:
        """(n, |vocab|) dense term-count matrix — the document-term shape
        LDA / NaiveBayes / IDF consume.  ``min_tf`` follows Spark: ≥ 1 is
        an absolute in-document count threshold, < 1 is a FRACTION of the
        document's token count."""
        index = {t: i for i, t in enumerate(self.vocabulary)}
        rows = _tokens_column(tokens)
        out = np.zeros((len(rows), len(self.vocabulary)), np.float32)
        for i, row in enumerate(rows):
            for t in row:
                j = index.get(t)
                if j is not None:
                    out[i, j] += 1.0
        if self.min_tf > 1.0:
            out[out < self.min_tf] = 0.0
        elif 0.0 < self.min_tf < 1.0:
            doc_len = out.sum(axis=1, keepdims=True)
            out[out < self.min_tf * doc_len] = 0.0
        if self.binary:
            out = (out > 0).astype(np.float32)
        return out


@dataclass(frozen=True)
class CountVectorizer:
    """Spark defaults: vocabSize 2¹⁸, minDF 1.0 (docs), minTF 1.0,
    binary False.  Vocabulary ordered by descending corpus frequency
    (Spark's order), ties broken lexically for determinism."""

    vocab_size: int = 1 << 18
    min_df: float = 1.0
    min_tf: float = 1.0
    binary: bool = False

    def fit(self, tokens) -> CountVectorizerModel:
        rows = _tokens_column(tokens)
        df: dict[str, int] = {}
        tf: dict[str, int] = {}
        for row in rows:
            seen = set()
            for t in row:
                tf[t] = tf.get(t, 0) + 1
                if t not in seen:
                    seen.add(t)
                    df[t] = df.get(t, 0) + 1
        n_docs = max(len(rows), 1)
        min_docs = (
            self.min_df if self.min_df >= 1.0 else self.min_df * n_docs
        )
        terms = [t for t, c in df.items() if c >= min_docs]
        terms.sort(key=lambda t: (-tf[t], t))
        return CountVectorizerModel(
            vocabulary=tuple(terms[: self.vocab_size]),
            binary=self.binary,
            min_tf=self.min_tf,
        )

    def fit_transform(self, tokens) -> np.ndarray:
        return self.fit(tokens).transform(tokens)


@register_model("HashingTF")
@dataclass(frozen=True)
class HashingTF:
    """Term frequencies by feature hashing (no vocabulary state).  CRC32
    (deterministic across processes) stands in for Spark's murmur3."""

    num_features: int = 1 << 18
    binary: bool = False

    def __post_init__(self):
        if self.num_features < 1:
            raise ValueError(f"num_features must be >= 1, got {self.num_features}")

    def _artifacts(self):
        return (
            "HashingTF",
            {"num_features": self.num_features, "binary": self.binary},
            {},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(
            num_features=int(params["num_features"]),
            binary=bool(params.get("binary", False)),
        )

    def indices_of(self, terms) -> np.ndarray:
        return np.asarray(
            [zlib.crc32(str(t).encode()) % self.num_features for t in terms],
            np.int64,
        )

    #: dense-output element budget: Spark emits sparse vectors at the
    #: 2¹⁸ default width; this implementation is dense, so a huge corpus
    #: at full width must raise instead of silently OOMing the host
    _MAX_DENSE_ELEMS = 1 << 28

    def transform(self, tokens) -> np.ndarray:
        rows = _tokens_column(tokens)
        if len(rows) * self.num_features > self._MAX_DENSE_ELEMS:
            raise ValueError(
                f"dense HashingTF output {len(rows)}×{self.num_features} "
                f"exceeds the element budget ({self._MAX_DENSE_ELEMS}); "
                "lower num_features (Spark's sparse vectors don't pay "
                "this, the dense document-term matrix here does)"
            )
        out = np.zeros((len(rows), self.num_features), np.float32)
        for i, row in enumerate(rows):
            if row:
                np.add.at(out[i], self.indices_of(row), 1.0)
        if self.binary:
            out = (out > 0).astype(np.float32)
        return out


@register_model("IDFModel")
@dataclass(frozen=True)
class IDFModel:
    idf: np.ndarray

    def _artifacts(self):
        return ("IDFModel", {}, {"idf": np.asarray(self.idf)})

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(idf=arrays["idf"])

    def transform(self, tf):
        """TF matrix → TF·IDF: a tensor stays on its device, an ndarray
        comes back an ndarray.  Integer count matrices promote to f32 —
        casting idf to an int dtype would floor the log weights to zero."""
        if isinstance(tf, torch.Tensor):
            out = tf.to(torch.float32) if not tf.is_floating_point() else tf
            idf = torch.as_tensor(np.asarray(self.idf, np.float32), device=tf.device)
            return out * idf.to(out.dtype)[None, :]
        out = np.asarray(tf, np.float32) if np.issubdtype(
            np.dtype(getattr(tf, "dtype", np.float32)), np.integer
        ) else tf
        return out * np.asarray(self.idf, np.float32)[None, :]


@dataclass(frozen=True)
class IDF:
    """Spark's smoothed idf: log((n_docs + 1) / (df + 1)); columns with
    df < min_doc_freq get idf 0 (zeroing them in every document)."""

    min_doc_freq: int = 0

    def fit(self, tf) -> IDFModel:
        x = tf.detach().cpu().numpy() if isinstance(tf, torch.Tensor) else np.asarray(tf)
        if x.ndim != 2 or x.shape[0] == 0:
            raise ValueError(f"IDF needs a non-empty (n, v) TF matrix; got {x.shape}")
        df = (x > 0).sum(axis=0).astype(np.float64)
        n = x.shape[0]
        idf = np.log((n + 1.0) / (df + 1.0))
        if self.min_doc_freq > 0:
            idf[df < self.min_doc_freq] = 0.0
        return IDFModel(idf=idf.astype(np.float32))

    def fit_transform(self, tf):
        return self.fit(tf).transform(tf)


@register_model("DCT")
@dataclass(frozen=True)
class DCT:
    """Row-wise type-II (orthogonal) discrete cosine transform — Spark's
    ``DCT`` stage; ``inverse=True`` applies DCT-III."""

    inverse: bool = False

    def _artifacts(self):
        return ("DCT", {"inverse": self.inverse}, {})

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(inverse=bool(params["inverse"]))

    def transform(self, x, device=None):
        """Rows of ``x`` → their orthonormal DCT-II (DCT-III with
        ``inverse``), float32, on ``device`` (default the card); a tensor
        is transformed where it lies."""
        if isinstance(x, torch.Tensor):
            arr = x.to(torch.float32)
        else:
            arr = torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))
        if arr.ndim != 2:
            raise ValueError(f"DCT needs an (n, d) matrix; got shape {tuple(arr.shape)}")
        c = dct_matrix(arr.shape[1]).to(arr.device)
        return arr @ c if self.inverse else arr @ c.T


def dct_matrix(d: int) -> torch.Tensor:
    """The orthonormal (d, d) DCT-II matrix C (y = C x), computed in
    float64 and cast to float32: C[k, j] = s_k cos(π (2j + 1) k / 2d),
    s_0 = √(1/d), s_k = √(2/d).  C is orthogonal, so Cᵀ is DCT-III."""
    k = np.arange(d, dtype=np.float64)[:, None]
    j = np.arange(d, dtype=np.float64)[None, :]
    c = np.cos(np.pi * (2.0 * j + 1.0) * k / (2.0 * d)) * np.sqrt(2.0 / d)
    c[0] *= np.sqrt(0.5)
    return torch.from_numpy(c.astype(np.float32))


__all__ = [
    "CountVectorizer", "CountVectorizerModel", "DCT", "HashingTF", "IDF", "IDFModel", "NGram",
    "RegexTokenizer", "StopWordsRemover", "Tokenizer",
]
