"""The SQL fuzz harness: the port's ``core/sql_fuzz.py`` against the JAX
package's, on the CPU.

The generators draw from ``numpy.random.default_rng`` in the same order,
so a seed gives the same tables (``==`` column by column, NaN, NaT and
None included) and the same SQL text in both packages; ``compare_tables``
returns the same verdict strings; the shrinker reaches the same minimal
query.  The checkers run the port's compiled executor and views on
``device="cpu"`` and must find no failure, at the harness's own rtol
1e-9 / atol 1e-12 (float64 sums in another order).
"""

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.core import sql_fuzz as JF
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import sql_fuzz as PF

# the suite runs several worker processes on a few cores: one intra-op
# thread per worker keeps torch from oversubscribing them
torch.set_num_threads(1)


def _same_table(a, b):
    assert list(a.columns) == list(b.columns)
    for c in a.columns:
        va, vb = a.column(c), b.column(c)
        assert va.dtype == vb.dtype, c
        if va.dtype == object:
            assert va.tolist() == vb.tolist(), c
        else:
            assert va.tobytes() == vb.tobytes(), c


@pytest.mark.parametrize("seed", range(10))
def test_generators_draw_the_reference_tables_and_sql(seed):
    mine, ref = np.random.default_rng(seed), np.random.default_rng(seed)
    _same_table(PF.random_table(mine), JF.random_table(ref))
    _same_table(PF.random_table(mine, 17), JF.random_table(ref, 17))
    for _ in range(20):
        a, b = PF.random_query(mine), JF.random_query(ref)
        assert a.sql() == b.sql()
        assert (a.kind, a.items, a.where, a.group, a.limit) == \
            (b.kind, b.items, b.where, b.group, b.limit)
    for _ in range(10):
        a, b = PF.mergeable_query(mine), JF.mergeable_query(ref)
        assert a.sql() == b.sql() and a.kind != "window" and a.limit is None
    # and the generators leave both streams in the same place
    assert mine.random() == ref.random()


def _pair(edit):
    base = {"x": np.array([1.0, np.nan, 3.0]), "t": np.array(
        ["2025-03-31T22:00", "NaT", "2025-03-31T23:00"], "datetime64[ns]"),
        "s": np.array(["a", None, "b"], object), "i": np.array([1, 2, 3])}
    other = {k: v.copy() for k, v in base.items()}
    edit(other)
    return base, other


VERDICT_CASES = {
    "equal": lambda o: None,
    "float within rtol": lambda o: o.__setitem__("x", o["x"] * (1 + 1e-12)),
    "float off": lambda o: o.__setitem__("x", o["x"] + 1e-3),
    "null mask": lambda o: o.__setitem__("x", np.array([1.0, 2.0, 3.0])),
    "NaT mask": lambda o: o.__setitem__("t", o["t"][[0, 0, 2]]),
    "timestamp value": lambda o: o.__setitem__("t", o["t"] + np.timedelta64(1, "s")),
    "string": lambda o: o.__setitem__("s", np.array(["a", None, "c"], object)),
    "int": lambda o: o.__setitem__("i", np.array([1, 2, 4])),
    "dtype kind": lambda o: o.__setitem__("i", np.array([1.0, 2.0, 3.0])),
    "column order": lambda o: o.update({"x": o.pop("x")}),
}


@pytest.mark.parametrize("case", sorted(VERDICT_CASES))
def test_compare_tables_gives_the_reference_verdicts(case):
    a, b = _pair(VERDICT_CASES[case])
    mine = PF.compare_tables(P.Table.from_dict(a), P.Table.from_dict(b))
    ref = JF.compare_tables(J.Table.from_dict(a), J.Table.from_dict(b))
    assert mine == ref
    assert (mine is None) == (case in ("equal", "float within rtol"))
    rows = PF.compare_tables(P.Table.from_dict(a), P.Table.from_dict(a).limit(2))
    assert rows == JF.compare_tables(J.Table.from_dict(a), J.Table.from_dict(a).limit(2))


def test_the_shrinker_reaches_the_reference_minimal_query():
    """A check that fails while one predicate leaf and one item survive
    shrinks to the same spec in both packages."""
    rng = np.random.default_rng(4)
    spec = None
    while spec is None or spec.where is None or spec.where[0] != "bool" or len(spec.items) < 2:
        spec = PF.random_query(rng)
    leaf = spec.where[2]
    while leaf[0] != "leaf":
        leaf = leaf[1] if leaf[0] == "not" else leaf[2]
    item = spec.items[-1]

    def failing(s, _ctx):
        return "bad" if item in s.items and s.where is not None and \
            leaf[1] in JF._render_cond(s.where) else None

    mine = PF.shrink(spec, None, check=failing)
    ref = JF.shrink(JF.QuerySpec(spec.kind, spec.items, spec.where, spec.group, spec.limit),
                    None, check=failing)
    assert mine.sql() == ref.sql()
    assert len(mine.sql()) < len(spec.sql())


@pytest.mark.parametrize("seed", range(3))
def test_run_fuzz_finds_no_failure_on_the_cpu(seed):
    assert PF.run_fuzz(n_queries=40, seed=seed, device="cpu") == []


@pytest.mark.parametrize("seed", range(2))
def test_run_fuzz_incremental_finds_no_failure_on_the_cpu(seed):
    assert PF.run_fuzz_incremental(n_queries=10, seed=seed, device="cpu") == []


def test_the_checkers_run_the_specs_the_reference_draws():
    """check_spec / check_view_spec on the JAX generator's specs: the
    port's compiled route (and its views) agree with its interpreter on
    what the JAX harness draws."""
    rng = np.random.default_rng(21)
    table = PF.random_table(np.random.default_rng(21))
    JF.random_table(rng)
    for _ in range(15):
        assert PF.check_spec(JF.random_query(rng), table, device="cpu") is None
    seq = PF.ReplaySeq(tuple(PF.random_table(rng, 40) for _ in range(3)),
                       ((1, PF.random_table(rng, 25)),))
    assert PF.check_view_spec(JF.mergeable_query(rng), seq, device="cpu") is None


def test_the_checkers_default_to_the_card_and_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    table = PF.random_table(rng, 10)
    spec = PF.random_query(rng)
    seq = PF.ReplaySeq((table,))
    for call in (lambda: PF.check_spec(spec, table), lambda: PF.check_view_spec(spec, seq),
                 lambda: PF.run_fuzz(2), lambda: PF.run_fuzz_incremental(1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
