"""The port's BinaryClassificationEvaluator and threshold curves against
the JAX package's ``evaluation/binary.py``, on the CPU.

Tolerances, and why: areas within 2e-6 (float32 cumulative sums, a torch
scan against XLA's, then a float32 sum of the pair terms); curve points
within 1e-6 and thresholds equal (the same float32 scores sorted stably;
the counts are float32 cumulative sums, exact for integer weights below
2**24).  Ties, zero-weight rows and a single class are cases of their own.
"""

import numpy as np
import pytest
import torch

from clustermachinelearningforhospitalnetworks_apache_spark_tpu.evaluation import binary as jb
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.evaluation import binary as pb

torch.set_num_threads(1)
AUC_TOL = 2e-6


def _case(kind: str, n=800, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n).astype(np.float32)
    w = None
    if kind == "continuous":
        s = (y * 0.7 + rng.normal(0, 1.0, n)).astype(np.float32)
    elif kind == "ties":          # integer-valued scores: big tie blocks
        s = (y + rng.integers(0, 4, n)).astype(np.float32)
    elif kind == "weighted":
        s = (y * 0.5 + rng.normal(0, 1.0, n)).astype(np.float32)
        w = rng.uniform(0.1, 3.0, n).astype(np.float32)
    elif kind == "zero_weight":   # w = 0 rows with their own (extreme) scores
        s = (y * 0.5 + rng.integers(0, 6, n)).astype(np.float32)
        w = rng.integers(0, 3, n).astype(np.float32)
        s[w == 0] = 99.0
    elif kind == "single_class":
        y[:] = 1.0
        s = rng.normal(size=n).astype(np.float32)
    elif kind == "all_tied":
        s = np.full(n, 0.25, np.float32)
    else:
        raise ValueError(kind)
    return s, y, w


KINDS = ["continuous", "ties", "weighted", "zero_weight", "single_class", "all_tied"]


@pytest.mark.parametrize("metric", ["areaUnderROC", "areaUnderPR"])
@pytest.mark.parametrize("kind", KINDS)
def test_areas_match_reference(kind, metric):
    s, y, w = _case(kind)
    want = jb.BinaryClassificationEvaluator(metric).evaluate(s, y, w)
    got = P.BinaryClassificationEvaluator(metric).evaluate(s, y, w, device="cpu")
    assert got == pytest.approx(want, abs=AUC_TOL)
    # tensors stay where they are, and a PredictionResult reads the same
    pr = P.PredictionResult(torch.from_numpy(s), torch.from_numpy(y),
                            torch.ones(len(y)) if w is None else torch.from_numpy(w))
    assert P.BinaryClassificationEvaluator(metric).evaluate(pr) == pytest.approx(want,
                                                                                 abs=AUC_TOL)


def test_roc_tie_exactness_by_hand():
    # pairs: (pos, neg@1) a tie → 0.5; (pos, neg@0) a win → 1: AUC = 1.5/2
    s, y = np.array([1.0, 1.0, 0.0]), np.array([1.0, 0.0, 0.0])
    assert P.BinaryClassificationEvaluator().evaluate(s, y, device="cpu") == pytest.approx(0.75)


@pytest.mark.parametrize("kind", KINDS)
def test_binary_curves_match_reference(kind):
    s, y, w = _case(kind, seed=1)
    want = jb.binary_curves(s, y, w)
    got = pb.binary_curves(s, y, w, device="cpu")
    np.testing.assert_array_equal(got["thresholds"], want["thresholds"])
    for key in ("tp", "fp"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
    for key in ("total_pos", "total_neg"):
        assert got[key] == pytest.approx(want[key], rel=1e-6)
    if kind == "zero_weight":       # the w = 0 rows' score is no threshold
        assert 99.0 not in got["thresholds"]


def test_descending_sort_is_stable_and_tie_blocks_collapse():
    s = torch.tensor([0.5, 0.75, 0.5, 0.125, 0.75, 0.5])
    y = torch.tensor([1.0, 0.0, 0.0, 1.0, 1.0, 1.0])
    ss, tp_e, fp_e, tp_tot, fp_tot = pb._descending_stats(s, y, torch.ones(6))
    assert ss.tolist() == [0.75, 0.75, 0.5, 0.5, 0.5, 0.125]
    # every point of a block carries the block's end counts
    assert tp_e.tolist() == [1.0, 1.0, 3.0, 3.0, 3.0, 4.0]
    assert fp_e.tolist() == [1.0, 1.0, 2.0, 2.0, 2.0, 2.0]
    assert float(tp_tot) == 4.0 and float(fp_tot) == 2.0


def test_evaluator_errors_and_host_inputs_need_a_device(monkeypatch):
    s, y, _ = _case("continuous", n=50)
    with pytest.raises(ValueError, match="unknown metric"):
        P.BinaryClassificationEvaluator("auc").evaluate(s, y, device="cpu")
    assert P.BinaryClassificationEvaluator().is_larger_better
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.BinaryClassificationEvaluator().evaluate(s, y)
