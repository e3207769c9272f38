"""BinaryClassificationEvaluator — areaUnderROC / areaUnderPR.

The JAX package's ``evaluation/binary.py`` (``pyspark.ml.evaluation.
BinaryClassificationEvaluator``): each area is one pass of torch ops on
the device the scores lie on — a stable sort, cumulative weights, and a
closed-form area.

- **ROC AUC** is the exact pair form ``P(s⁺ > s⁻) + ½·P(s⁺ = s⁻)`` over
  weighted pairs: ``searchsorted`` (left and right) against the
  cumulative negative weight makes it exact under ties.
- **PR AUC** is the trapezoidal area of the precision-recall curve over
  distinct thresholds, every point of a tie block taking its block-end
  cumulative counts.

The sorts are ``stable=True`` (the reference's ``jnp.argsort`` is
stable; torch's CUDA sort is stable only when asked).  The cumulative
sums are float32 scans whose rounding differs from XLA's in the last
bits, and scores are ranked in float32, so distinct float64 scores that
collide in float32 share a tie block, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device


def _sorted(scores, labels, weights, descending: bool):
    """Scores, labels and weights in float32, sorted by score (stable)."""
    s = scores.to(torch.float32)
    y = labels.to(torch.float32)
    w = weights.to(torch.float32)
    order = torch.argsort(-s if descending else s, stable=True)
    return s[order], y[order], w[order]


def _roc_auc(scores, labels, weights) -> torch.Tensor:
    ss, ys, ws = _sorted(scores, labels, weights, descending=False)
    cw_neg = torch.cumsum(ws * (1.0 - ys), dim=0)          # inclusive, ascending
    total_neg = cw_neg[-1]
    # the negative mass strictly below / equal to each score, tie-exact
    left = torch.searchsorted(ss, ss, side="left")
    right = torch.searchsorted(ss, ss, side="right")
    below = torch.where(left > 0, cw_neg[torch.clamp(left - 1, min=0)],
                        torch.zeros_like(cw_neg))
    equal = cw_neg[right - 1] - below
    pos_mass = ws * ys
    total_pos = pos_mass.sum()
    num = (pos_mass * (below + 0.5 * equal)).sum()
    return num / torch.clamp(total_pos * total_neg, min=1e-30)


def _descending_stats(scores, labels, weights):
    """Descending scores with the cumulative (tp, fp) at each point's
    tie-block edge, and the totals: the pass behind PR AUC and every
    threshold curve."""
    ss, ys, ws = _sorted(scores, labels, weights, descending=True)
    tp = torch.cumsum(ws * ys, dim=0)
    fp = torch.cumsum(ws * (1.0 - ys), dim=0)
    neg = -ss
    edge = torch.searchsorted(neg, neg, side="right") - 1
    return ss, tp[edge], fp[edge], tp[-1], fp[-1]


def _pr_auc(scores, labels, weights) -> torch.Tensor:
    _, tp_e, fp_e, total_pos, _ = _descending_stats(scores, labels, weights)
    recall = tp_e / torch.clamp(total_pos, min=1e-30)
    precision = tp_e / torch.clamp(tp_e + fp_e, min=1e-30)
    # anchored at (recall 0, the highest-score block's precision): Spark's
    # first curve point
    r = torch.cat([torch.zeros((1,), dtype=recall.dtype, device=recall.device), recall])
    p = torch.cat([precision[:1], precision])
    return ((r[1:] - r[:-1]) * 0.5 * (p[1:] + p[:-1])).sum()


def _threshold_stats(scores, labels, weights):
    """→ (descending scores, tp and fp at their block edges, total
    positive and negative weight) as host float32 arrays, in one copy."""
    ss, tp_e, fp_e, tot_p, tot_n = _descending_stats(scores, labels, weights)
    n = ss.shape[0]
    flat = torch.cat([ss, tp_e, fp_e, torch.stack([tot_p, tot_n])]).cpu().numpy()
    return flat[:n], flat[n:2 * n], flat[2 * n:3 * n], flat[3 * n], flat[3 * n + 1]


def _on_device(scores, labels, weights, device):
    """The three columns as tensors: on the scores' device when they are a
    tensor, else on ``device`` (default the card)."""
    dev = scores.device if isinstance(scores, torch.Tensor) else resolve_device(device)

    def put(a):
        return a.to(dev) if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a),
                                                                              device=dev)

    s, y = put(scores), put(labels)
    w = torch.ones(y.shape, dtype=torch.float32, device=dev) if weights is None else put(weights)
    return s, y, w


def binary_curves(scores, labels, weights=None, device=None) -> dict:
    """→ ``thresholds`` (distinct, descending), the cumulative ``tp`` /
    ``fp`` at each (score ≥ threshold predicted positive), and
    ``total_pos`` / ``total_neg``: one device pass, the curve assembled
    on the host."""
    ss, tp_e, fp_e, tot_p, tot_n = _threshold_stats(*_on_device(scores, labels, weights,
                                                                device))
    # one point per distinct threshold: the last index of each tie block
    last = np.r_[ss[1:] != ss[:-1], True]
    thr, tp_b, fp_b = ss[last], tp_e[last], fp_e[last]
    # drop the blocks of no mass: scores seen only on w = 0 rows (pad rows
    # most of all); Spark's curves hold observed thresholds only
    mass = np.diff(np.r_[0.0, tp_b]) + np.diff(np.r_[0.0, fp_b])
    keep = mass > 0
    return {
        "thresholds": thr[keep],
        "tp": tp_b[keep],
        "fp": fp_b[keep],
        "total_pos": float(tot_p),
        "total_neg": float(tot_n),
    }


@dataclass(frozen=True)
class BinaryClassificationEvaluator:
    """``metric_name``: areaUnderROC (default, Spark's) or areaUnderPR.

    ``evaluate`` takes a ``PredictionResult`` whose ``prediction`` holds
    scores (``LogisticRegressionModel.transform_proba``; plain
    ``transform`` gives hard 0/1 labels), or explicit ``(scores, labels[,
    weights])``; host arrays are moved to ``device`` (default the card)."""

    metric_name: str = "areaUnderROC"

    @property
    def is_larger_better(self) -> bool:
        return True

    def evaluate(self, predictions, labels=None, weights=None, device=None) -> float:
        if labels is None:
            s, y, w = predictions.prediction, predictions.label, predictions.weight
        else:
            s, y, w = _on_device(predictions, labels, weights, device)
        if self.metric_name == "areaUnderROC":
            return float(_roc_auc(s, y, w))
        if self.metric_name == "areaUnderPR":
            return float(_pr_auc(s, y, w))
        raise ValueError(f"unknown metric {self.metric_name!r}")


__all__ = ["BinaryClassificationEvaluator", "binary_curves"]
