"""Slice 5e's RankingEvaluator and MultilabelClassificationEvaluator in the
port against the JAX package's, on the CPU, on the same seeded inputs.

Every metric is equal (``==``): both packages pad the per-row sets and
reduce the same membership matrices in the same host numpy, Spark's
denominators included (the k padding of the AtK metrics and
min(|truth|, k)).
"""

import numpy as np
import pytest

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P

# the example from Spark's RankingMetrics docs
PRED = [[1, 6, 2, 7, 8, 3, 9, 10, 4, 5], [4, 1, 5, 6, 2, 7, 3, 8, 9, 10], [1, 2, 3, 4, 5]]
TRUTH = [[1, 2, 3, 4, 5], [1, 2, 3], []]

RANKING = ("meanAveragePrecision", "meanAveragePrecisionAtK", "precisionAtK", "ndcgAtK",
           "recallAtK")
MULTILABEL = ("subsetAccuracy", "accuracy", "hammingLoss", "precision", "recall",
              "f1Measure", "microPrecision", "microRecall", "microF1Measure")


def _lists(seed: int, n=40, ids=30, short=False):
    rng = np.random.default_rng(seed)
    pred = [list(rng.permutation(ids)[: int(rng.integers(0 if short else 1, 12))])
            for _ in range(n)]
    truth = [list(rng.choice(ids, int(rng.integers(0, 8)), replace=False)) for _ in range(n)]
    return pred, truth


def _same(a: float, b: float) -> bool:
    return (np.isnan(a) and np.isnan(b)) or a == b


@pytest.mark.parametrize("k", [1, 3, 10, 15])
@pytest.mark.parametrize("metric", RANKING)
def test_ranking_metrics_equal(metric, k):
    for pred, truth in [(PRED, TRUTH), _lists(0), _lists(1, short=True)]:
        got = P.RankingEvaluator(metric, k).evaluate(pred, truth)
        want = J.RankingEvaluator(metric, k).evaluate(pred, truth)
        assert isinstance(got, float) and _same(got, want)


@pytest.mark.parametrize("metric", MULTILABEL)
def test_multilabel_metrics_equal(metric):
    pred, truth = _lists(2, short=True)
    cases = [(pred, truth), (PRED, TRUTH), ([[1, 1, 2], []], [[1, 2], []]),
             ([[0.0, 2.0]], [[2.0]])]
    for p, t in cases:
        got = P.MultilabelClassificationEvaluator(metric).evaluate(p, t)
        want = J.MultilabelClassificationEvaluator(metric).evaluate(p, t)
        assert _same(got, want)
    assert P.MultilabelClassificationEvaluator(metric).is_larger_better == \
        J.MultilabelClassificationEvaluator(metric).is_larger_better


def test_refusals_match_the_reference():
    for pkg in (J, P):
        with pytest.raises(ValueError, match="metric_name"):
            pkg.RankingEvaluator("auc").evaluate(PRED, TRUTH)
        with pytest.raises(ValueError, match="label rows"):
            pkg.RankingEvaluator().evaluate(PRED, TRUTH[:2])
        with pytest.raises(ValueError, match="empty"):
            pkg.RankingEvaluator().evaluate([], [])
        with pytest.raises(ValueError, match="k must be"):
            pkg.RankingEvaluator("precisionAtK", 0).evaluate(PRED, TRUTH)
        with pytest.raises(ValueError, match="metric_name"):
            pkg.MultilabelClassificationEvaluator("auc").evaluate(PRED, TRUTH)
        with pytest.raises(ValueError, match="empty"):
            pkg.MultilabelClassificationEvaluator().evaluate([], [])
