"""RankingEvaluator and MultilabelClassificationEvaluator (the JAX
package's ``evaluation/ranking.py``).

Parity with ``pyspark.ml.evaluation.RankingEvaluator`` (RankingMetrics:
meanAveragePrecision[AtK], precisionAtK, ndcgAtK, recallAtK) and
``MultilabelClassificationEvaluator`` (subset accuracy, micro/per-example
precision/recall/F1, Hamming loss).

Inputs are per-row variable-length label sets: a (n, k) prediction matrix
of ranked ids next to per-row ground-truth sets, each padded to a fixed
width with ``-1`` sentinels, so every metric is one vectorized
membership-matrix reduction.  Host numpy, as in the JAX package (these
evaluators consume recommendation lists, not the training-scale feature
matrix), so no ``device=``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


def _pad_sets(rows: Sequence[Sequence], width: int | None = None) -> np.ndarray:
    """List of per-row id sequences → (n, w) float matrix padded with -1."""
    w = width or max((len(r) for r in rows), default=1)
    w = max(w, 1)
    out = np.full((len(rows), w), -1.0)
    for i, r in enumerate(rows):
        vals = np.asarray(list(r), dtype=np.float64)[:w]
        out[i, : len(vals)] = vals
    return out


def _membership(pred: np.ndarray, truth: np.ndarray) -> np.ndarray:
    """(n, k) predictions vs (n, t) truth sets → (n, k) hit mask.
    ``-1`` padding never matches."""
    hit = (pred[:, :, None] == truth[:, None, :]) & (pred[:, :, None] >= 0)
    return hit.any(axis=2)


@dataclass(frozen=True)
class RankingEvaluator:
    """``metric_name``: meanAveragePrecision | meanAveragePrecisionAtK |
    precisionAtK | ndcgAtK | recallAtK (Spark's set); ``k`` applies to the
    AtK variants (Spark default 10)."""

    metric_name: str = "meanAveragePrecision"
    k: int = 10

    _METRICS = (
        "meanAveragePrecision", "meanAveragePrecisionAtK",
        "precisionAtK", "ndcgAtK", "recallAtK",
    )

    @property
    def is_larger_better(self) -> bool:
        return True

    def evaluate(
        self, predictions: Sequence[Sequence], labels: Sequence[Sequence]
    ) -> float:
        """``predictions``: per-row RANKED id lists; ``labels``: per-row
        relevant-id sets."""
        if self.metric_name not in self._METRICS:
            raise ValueError(
                f"metric_name must be one of {self._METRICS}, got "
                f"{self.metric_name!r}"
            )
        if len(predictions) != len(labels):
            raise ValueError(
                f"{len(predictions)} prediction rows vs {len(labels)} label rows"
            )
        if len(predictions) == 0:
            raise ValueError("RankingEvaluator on an empty dataset")
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        pred = _pad_sets(predictions)
        truth = _pad_sets(labels)
        n_rel = (truth >= 0).sum(axis=1)                    # per-row |truth|
        valid_pred = pred >= 0

        name = self.metric_name
        if name in ("meanAveragePrecisionAtK", "precisionAtK", "ndcgAtK", "recallAtK"):
            # re-pad to EXACTLY k columns: Spark's AtK denominators use k
            # (resp. min(|truth|, k)) even when a row predicted fewer than
            # k items — truncating at the ragged max width would silently
            # overestimate short prediction lists
            pred = _pad_sets(predictions, self.k)
            valid_pred = pred >= 0
        hits = _membership(pred, truth)                     # (n, w)

        if name in ("meanAveragePrecision", "meanAveragePrecisionAtK"):
            # Spark's RankingMetrics: mean over rows of
            # (Σ_i hit_i · precision@i) / min(|truth|, [k]) — rows with
            # empty truth contribute 0
            cum = np.cumsum(hits, axis=1)
            ranks = np.arange(1, hits.shape[1] + 1)[None, :]
            prec_at_i = np.where(hits, cum / ranks, 0.0)
            denom = np.maximum(
                np.minimum(n_rel, pred.shape[1]) if name.endswith("AtK") else n_rel,
                1,
            )
            ap = prec_at_i.sum(axis=1) / denom
            return float(np.where(n_rel > 0, ap, 0.0).mean())
        if name == "precisionAtK":
            # Spark divides by k even when fewer items were predicted
            return float((hits.sum(axis=1) / self.k).mean())
        if name == "recallAtK":
            return float(
                np.where(n_rel > 0, hits.sum(axis=1) / np.maximum(n_rel, 1), 0.0).mean()
            )
        # ndcgAtK: binary relevance, log2 discounts (Spark's formula)
        ranks = np.arange(hits.shape[1])
        disc = 1.0 / np.log2(ranks + 2.0)
        dcg = (hits * disc[None, :] * valid_pred).sum(axis=1)
        ideal_len = np.minimum(n_rel, hits.shape[1])
        ideal_cum = np.concatenate([[0.0], np.cumsum(disc)])
        idcg = ideal_cum[ideal_len]
        return float(
            np.where(n_rel > 0, dcg / np.maximum(idcg, 1e-12), 0.0).mean()
        )


@dataclass(frozen=True)
class MultilabelClassificationEvaluator:
    """``metric_name``: subsetAccuracy | accuracy | hammingLoss |
    precision | recall | f1Measure | microPrecision | microRecall |
    microF1Measure (Spark's set).  ``accuracy`` is Spark's per-example
    Jaccard-style intersection/union mean."""

    metric_name: str = "f1Measure"

    _METRICS = (
        "subsetAccuracy", "accuracy", "hammingLoss",
        "precision", "recall", "f1Measure",
        "microPrecision", "microRecall", "microF1Measure",
    )

    @property
    def is_larger_better(self) -> bool:
        return self.metric_name != "hammingLoss"

    def evaluate(
        self, predictions: Sequence[Sequence], labels: Sequence[Sequence]
    ) -> float:
        if self.metric_name not in self._METRICS:
            raise ValueError(
                f"metric_name must be one of {self._METRICS}, got "
                f"{self.metric_name!r}"
            )
        if len(predictions) != len(labels):
            raise ValueError(
                f"{len(predictions)} prediction rows vs {len(labels)} label rows"
            )
        n = len(predictions)
        if n == 0:
            raise ValueError("MultilabelClassificationEvaluator on an empty dataset")
        # Spark's MultilabelMetrics operates on *sets*; dedup each row so
        # duplicate ids can't inflate tp / |pred| / |truth|.
        pred = _pad_sets([set(r) for r in predictions])
        truth = _pad_sets([set(r) for r in labels])
        np_pred = (pred >= 0).sum(axis=1)
        np_true = (truth >= 0).sum(axis=1)
        tp = (_membership(pred, truth)).sum(axis=1)          # |pred ∩ truth|
        union = np_pred + np_true - tp

        name = self.metric_name
        if name == "subsetAccuracy":
            return float((tp == np.maximum(np_pred, np_true)).mean())
        if name == "accuracy":
            # Spark computes intersect/union per row; an empty prediction AND
            # empty truth row is 0/0 = NaN there, and the NaN propagates
            # through the mean — match that rather than scoring such rows 1.0.
            return float(
                np.where(union > 0, tp / np.maximum(union, 1), np.nan).mean()
            )
        if name == "hammingLoss":
            # Spark: Σ(|pred|+|truth|−2·tp) / (n · numLabels) with
            # numLabels = count of distinct GROUND-TRUTH labels (Spark's
            # MultilabelMetrics.numLabels flatMaps the label sets only)
            num_labels = max(len(np.unique(truth[truth >= 0])), 1)
            return float((np_pred + np_true - 2 * tp).sum() / (n * num_labels))
        if name == "precision":
            return float(np.where(np_pred > 0, tp / np.maximum(np_pred, 1), 0.0).mean())
        if name == "recall":
            return float(np.where(np_true > 0, tp / np.maximum(np_true, 1), 0.0).mean())
        if name == "f1Measure":
            denom = np_pred + np_true
            return float(
                np.where(denom > 0, 2.0 * tp / np.maximum(denom, 1), 0.0).mean()
            )
        # micro metrics pool counts over all rows
        TP, P, T = float(tp.sum()), float(np_pred.sum()), float(np_true.sum())
        if name == "microPrecision":
            return TP / max(P, 1.0)
        if name == "microRecall":
            return TP / max(T, 1.0)
        return 2.0 * TP / max(P + T, 1.0)   # microF1Measure


__all__ = ["MultilabelClassificationEvaluator", "RankingEvaluator"]
