"""Slice 5e's FPGrowth and PrefixSpan in the port against the JAX
package's, on the CPU, on the same seeded transactions.

Everything is equal (``==``), in order: the frequent itemsets, the
association rules with their confidence, lift and support, ``transform``
and the sequential patterns come from the same host Python in both
packages.
"""

import numpy as np
import pytest

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P


def _baskets(seed: int, n=120, ints=False):
    """Co-admission baskets: a few departments that travel together."""
    rng = np.random.default_rng(seed)
    items = list(range(12)) if ints else [f"dept{i}" for i in range(12)]
    out = []
    for _ in range(n):
        row = list(rng.choice(items, int(rng.integers(1, 6)), replace=False))
        if rng.random() < 0.4:
            row += [items[0], items[1]]                    # duplicates collapse
        if rng.random() < 0.3:
            row += [items[2], items[3], items[4]]
        out.append(row)
    return out


@pytest.mark.parametrize("ints", [False, True])
@pytest.mark.parametrize("min_support,min_confidence", [(0.3, 0.8), (0.1, 0.5), (0.05, 0.2)])
def test_itemsets_rules_and_transform_equal(min_support, min_confidence, ints):
    rows = _baskets(0, ints=ints)
    jm = J.FPGrowth(min_support, min_confidence).fit(rows)
    pm = P.FPGrowth(min_support, min_confidence).fit(rows)
    assert pm.freq_itemsets == jm.freq_itemsets
    assert pm.n_rows == jm.n_rows
    assert pm.association_rules == jm.association_rules
    probe = _baskets(1, n=30, ints=ints) + [[]]
    assert pm.transform(probe) == jm.transform(probe)
    assert pm._artifacts() == jm._artifacts()


def test_fpgrowth_refusals_match_the_reference():
    for pkg in (J, P):
        with pytest.raises(ValueError, match="empty"):
            pkg.FPGrowth().fit([])
        with pytest.raises(ValueError, match="min_support"):
            pkg.FPGrowth(min_support=0.0).fit([["a"]])


def _sequences(seed: int, n=60):
    rng = np.random.default_rng(seed)
    items = ["adm", "icu", "lab", "ct", "dis", "rehab"]
    out = []
    for _ in range(n):
        seq = [list(rng.choice(items, int(rng.integers(1, 3)), replace=False))
               for _ in range(int(rng.integers(0, 5)))]
        if rng.random() < 0.5:
            seq = [["adm"]] + seq + [["dis"]]
        out.append(seq)
    out.append([[], []])                                   # empty elements drop
    return out


@pytest.mark.parametrize("min_support,max_len", [(0.5, 10), (0.2, 3), (0.1, 2)])
def test_prefixspan_patterns_equal(min_support, max_len):
    seqs = _sequences(2)
    got = P.PrefixSpan(min_support, max_len).find_frequent_sequential_patterns(seqs)
    want = J.PrefixSpan(min_support, max_len).find_frequent_sequential_patterns(seqs)
    assert got == want and len(got) > 0


def test_prefixspan_refusals_match_the_reference():
    for pkg in (J, P):
        with pytest.raises(ValueError, match="empty"):
            pkg.PrefixSpan().find_frequent_sequential_patterns([])
        with pytest.raises(ValueError, match="min_support"):
            pkg.PrefixSpan(min_support=0).find_frequent_sequential_patterns([[["a"]]])
        with pytest.raises(ValueError, match="max_pattern_length"):
            pkg.PrefixSpan(max_pattern_length=0).find_frequent_sequential_patterns([[["a"]]])
        assert pkg.PrefixSpan().find_frequent_sequential_patterns([[], []]) == []
