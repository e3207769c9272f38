"""MulticlassClassificationEvaluator (``pyspark.ml.evaluation.
MulticlassClassificationEvaluator``): a weighted confusion matrix built on
the device the predictions lie on (a shard on its device, then in
ascending shard order, over a mesh), then accuracy or weighted
precision / recall / f1 on the host."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def _onehot_counts(pred: torch.Tensor, label: torch.Tensor, w: torch.Tensor,
                   num_classes: int) -> torch.Tensor:
    """(num_classes²,) weighted counts of one shard, cell ``t·C + p``: a
    one-hot product per chunk of rows (no scatter, so the sum's order is
    fixed)."""
    p = pred.to(torch.int64).clamp(0, num_classes - 1)
    t = label.to(torch.int64).clamp(0, num_classes - 1)
    cells = torch.arange(num_classes * num_classes, device=pred.device)
    cm = torch.zeros(num_classes * num_classes, dtype=torch.float32, device=pred.device)
    step = max(1, (1 << 22) // (num_classes * num_classes))
    for s in range(0, p.shape[0], step):
        idx = t[s:s + step] * num_classes + p[s:s + step]
        oh = (idx[:, None] == cells[None, :]).to(torch.float32)
        cm = cm + w[s:s + step].to(torch.float32) @ oh
    return cm


def confusion(pred, label, w, num_classes: int) -> np.ndarray:
    """(num_classes, num_classes) weighted counts, rows = true class;
    out-of-range ids clip to the nearest class.  Row-sharded MeshArrays
    are counted a shard on its device and summed over the shards in
    ascending order."""
    from ..parallel.collectives import tree_aggregate
    from ..parallel.sharding import MeshArray

    if isinstance(pred, MeshArray):
        cm = tree_aggregate(lambda t: _onehot_counts(*t, num_classes), (pred, label, w))
    else:
        cm = _onehot_counts(pred, label, w, num_classes)
    return cm.reshape(num_classes, num_classes).cpu().numpy()


@dataclass(frozen=True)
class MulticlassClassificationEvaluator:
    metric_name: str = "accuracy"
    label_col: str = "LOS_binary"
    prediction_col: str = "prediction"
    num_classes: int = 2

    @property
    def is_larger_better(self) -> bool:
        return True

    def confusion_matrix(self, pred, label, w=None) -> np.ndarray:
        from ..parallel.sharding import MeshArray

        if isinstance(pred, MeshArray):
            return confusion(pred, label, w, self.num_classes)
        pred = torch.as_tensor(pred)
        label = torch.as_tensor(label, device=pred.device)
        w = (torch.ones(label.shape, dtype=torch.float32, device=pred.device)
             if w is None else torch.as_tensor(w, device=pred.device))
        return confusion(pred, label, w, self.num_classes)

    def evaluate(self, predictions, labels=None, weights=None) -> float:
        if labels is None:
            pred, label, w = predictions.prediction, predictions.label, predictions.weight
        else:
            pred, label, w = predictions, labels, weights
        cm = self.confusion_matrix(pred, label, w)
        total = cm.sum()
        if total == 0:
            return 0.0
        diag = np.diag(cm)
        if self.metric_name == "accuracy":
            return float(diag.sum() / total)
        support = cm.sum(axis=1)
        pred_count = cm.sum(axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            precision = np.where(pred_count > 0, diag / pred_count, 0.0)
            recall = np.where(support > 0, diag / support, 0.0)
            f1 = np.where(
                precision + recall > 0, 2 * precision * recall / (precision + recall), 0.0
            )
        wts = support / total
        if self.metric_name in ("weightedPrecision", "precision"):
            return float((precision * wts).sum())
        if self.metric_name in ("weightedRecall", "recall"):
            return float((recall * wts).sum())
        if self.metric_name == "f1":
            return float((f1 * wts).sum())
        raise ValueError(f"unknown metric {self.metric_name!r}")
