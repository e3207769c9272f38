"""RegressionEvaluator (``pyspark.ml.evaluation.RegressionEvaluator``).

One weighted reduction over the predictions, on the device they lie on
(a shard on its device, then in ascending shard order, over a mesh), then
the metric on the host.  Weights multiply the squared/absolute
error, so the weighted RMSE is ``sqrt(Σw·e² / Σw)`` (Spark's), and pad
rows (w = 0) drop out.  Metrics: rmse, mse, mae, r2, var.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def _stacked(pred: torch.Tensor, label: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    pred = pred.to(torch.float32)
    label = label.to(torch.float32)
    w = w.to(torch.float32)
    err = pred - label
    return torch.stack([
        w.sum(), (err * err * w).sum(), (err.abs() * w).sum(), (label * w).sum(),
        (label * label * w).sum(), (pred * w).sum(), (pred * pred * w).sum(),
    ])


def _sums(pred, label, w) -> dict[str, float]:
    """The metrics' weighted sums on the host.  Row-sharded MeshArrays
    (a sharded ``transform``) are summed a shard on its device, then over
    the shards in ascending order (``collectives.tree_aggregate``)."""
    from ..parallel.collectives import tree_aggregate
    from ..parallel.sharding import MeshArray

    if isinstance(pred, MeshArray):
        s = tree_aggregate(lambda t: _stacked(*t), (pred, label, w))
    else:
        s = _stacked(pred, label, w)
    keys = ("n", "sq_err", "abs_err", "label_sum", "label_sq", "pred_sum", "pred_sq")
    return dict(zip(keys, (float(v) for v in s.cpu().numpy())))


@dataclass(frozen=True)
class RegressionEvaluator:
    metric_name: str = "rmse"
    label_col: str = "length_of_stay"
    prediction_col: str = "prediction"

    @property
    def is_larger_better(self) -> bool:
        return self.metric_name in ("r2", "var")

    def evaluate(self, predictions, labels=None, weights=None) -> float:
        """A :class:`~..models.base.PredictionResult` (or anything with
        ``.prediction``, ``.label``, ``.weight`` tensors), or explicit
        arrays (computed on the CPU)."""
        if labels is None:
            pred, label, w = predictions.prediction, predictions.label, predictions.weight
        else:
            pred = torch.as_tensor(np.asarray(predictions, dtype=np.float32))
            label = torch.as_tensor(np.asarray(labels, dtype=np.float32))
            w = (torch.as_tensor(np.asarray(weights, dtype=np.float32))
                 if weights is not None else torch.ones_like(label))
        return self._finish(_sums(pred, label, w))

    def _finish(self, s) -> float:
        n = max(s["n"], 1.0)
        mse = s["sq_err"] / n
        if self.metric_name == "rmse":
            return float(np.sqrt(mse))
        if self.metric_name == "mse":
            return mse
        if self.metric_name == "mae":
            return s["abs_err"] / n
        if self.metric_name == "r2":
            var = s["label_sq"] / n - (s["label_sum"] / n) ** 2
            return 1.0 - mse / var if var > 0 else 0.0
        if self.metric_name == "var":
            ybar = s["label_sum"] / n
            return s["pred_sq"] / n - 2.0 * ybar * s["pred_sum"] / n + ybar * ybar
        raise ValueError(f"unknown metric {self.metric_name!r}")
