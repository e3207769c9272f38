"""The port's ``tune/`` against the JAX package's, on the CPU.

Every knob's declaration, the trial ids and the store's bytes, the
selector's decisions and explanations, the store's exactly-once commit
under a kill, and the journaled live retuner: each ``==`` the JAX
package's (JSON and Python floats on the host in both).  The migrated
call sites resolve, with no selector installed, to exactly the constants
they replaced; with one installed, to the tuned value; inside a fenced
A/B, to the declared default.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest

from clustermachinelearningforhospitalnetworks_apache_spark_tpu import tune as JT
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.streaming.wal import (
    read_lines as j_read_lines,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import tune as PT
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults as PF

WAIT_KNOB = "serve.microbatch.max_wait_ms"


@pytest.fixture(autouse=True)
def _no_selector():
    PT.clear()
    JT.clear()
    yield
    PT.clear()
    JT.clear()


KNOB_FIELDS = ("name", "default", "domain", "metric", "mode", "py_names")


@pytest.mark.parametrize("name", JT.REGISTRY.names())
def test_every_knob_is_declared_as_in_the_reference(name):
    """Every field but the prose ``description``."""
    got = dataclasses.asdict(PT.REGISTRY.get(name))
    want = dataclasses.asdict(JT.REGISTRY.get(name))
    assert {f: got[f] for f in KNOB_FIELDS} == {f: want[f] for f in KNOB_FIELDS}
    assert set(got) == set(KNOB_FIELDS) | {"description"} and got["description"]
    assert PT.knob(name) == JT.knob(name) == PT.default(name)
    assert type(PT.knob(name)) is type(JT.knob(name))


def test_registry_names_and_validation():
    assert PT.REGISTRY.names() == JT.REGISTRY.names() and len(PT.REGISTRY.names()) == 12
    assert PT.REGISTRY.py_name_map() == JT.REGISTRY.py_name_map()
    reg = PT.KnobRegistry()
    k = PT.Knob(name="x.y", default=4, domain=(2, 4, 8), metric="span:x", py_names=("y",))
    reg.add(k)
    reg.add(k)
    with pytest.raises(ValueError, match="different declaration"):
        reg.add(PT.Knob(name="x.y", default=2, domain=(2, 4, 8)))
    with pytest.raises(ValueError, match="not in domain"):
        PT.Knob(name="bad", default=3, domain=(2, 4))
    with pytest.raises(ValueError, match="mode"):
        PT.Knob(name="bad", default=2, domain=(2,), mode="sideways")
    with pytest.raises(KeyError, match="unregistered"):
        reg.get("nope")


def test_migrated_call_sites_resolve_to_the_constants_they_replaced(tmp_path):
    """Bit-identical, with no selector installed: the batcher's linger,
    the queue bound, the server's two knobs, the source's file cap and
    the retention policy's seal chunks."""
    import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.table_lifecycle import (  # noqa: E501
        RetentionPolicy,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve import (
        DEFAULT_MAX_QUEUE_ROWS,
        DEFAULT_MAX_WAIT_S,
        MicroBatcher,
        RequestQueue,
        ServingModel,
    )

    assert PT.installed() is None
    assert DEFAULT_MAX_WAIT_S == 0.002 and type(DEFAULT_MAX_WAIT_S) is float
    assert DEFAULT_MAX_QUEUE_ROWS == 4096 and RequestQueue().max_rows == 4096
    sm = ServingModel(port.KMeansModel(np.zeros((2, 3), np.float32)), device="cpu")
    b = MicroBatcher(sm)
    assert b.max_wait_s == 0.002 and b.queue.max_rows == 4096
    srv = port.serve.InferenceServer(device="cpu")
    assert (srv.max_wait_s, srv.max_queue_rows) == (0.002, 4096)
    src = port.FileStreamSource(str(tmp_path), port.hospital_event_schema())
    assert src.max_files_per_batch is None and src.files_cap() == 0
    pol = RetentionPolicy()
    assert (pol.min_seal_batches, pol.max_segment_batches) == (4, 64)


TRIALS = [
    dict(knob=WAIT_KNOB, value=0.0, score=9000.0, shape_rows=64, metric="span:serve.request"),
    dict(knob=WAIT_KNOB, value=2.0, score=400.0, shape_rows=64),
    dict(knob=WAIT_KNOB, value=8.0, score=90.0, shape_rows=300, platform="gpu",
         fingerprint="h100", reps=3, source="live", meta={"phase": "midday"}),
    dict(knob="serve.queue.max_rows", value=8192, score=1.5, shape_rows=1),
    dict(knob="table.seal.min_batches", value=16, score=0.25, shape_rows=1 << 20),
]


@pytest.mark.parametrize("i", range(len(TRIALS)))
def test_trial_ids_and_records_equal(i):
    assert PT.make_trial(**TRIALS[i]) == JT.make_trial(**TRIALS[i])
    assert PT.trial_id({"knob": "x"}) == JT.trial_id({"knob": "x"})
    for rows in (0, 1, 2, 3, 64, 65, 1 << 20):
        assert PT.shape_bucket(rows) == JT.shape_bucket(rows)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_trial_file_written_by_one_package_is_read_by_the_other(tmp_path, writer):
    w, r = (PT, JT) if writer == "port" else (JT, PT)
    st = w.TrialStore(str(tmp_path / "trials.json"))
    assert st.add([w.make_trial(**t) for t in TRIALS]) == len(TRIALS)
    assert st.add([w.make_trial(**TRIALS[0])]) == 0          # content-hash merge
    back = r.TrialStore(str(tmp_path / "trials.json"))
    assert back.trials() == st.trials() and len(back) == len(TRIALS)
    for kw in ({"knob": WAIT_KNOB}, {"platform": "gpu"}, {"fingerprint": "default"}):
        assert back.trials(**kw) == st.trials(**kw)
    # both packages write the same bytes for the same trials
    other = r.TrialStore(str(tmp_path / "again.json"))
    other.add([r.make_trial(**t) for t in TRIALS])
    assert (tmp_path / "again.json").read_bytes() == (tmp_path / "trials.json").read_bytes()


def _wait_trials(pkg, scores, bucket_rows=(64,), mode_min=False):
    out = []
    for rows in bucket_rows:
        for v, s in scores:
            out.append(pkg.make_trial(knob=WAIT_KNOB if not mode_min else "sql.rowbucket.min",
                                      value=v, score=s * (1 + rows / 4096), shape_rows=rows))
    return out


SELECTOR_CASES = {
    "no_trials": ([], (), False),
    "thin": ([(2.0, 10.0)], (64,), False),
    "best": ([(0.0, 9000.0), (2.0, 400.0), (8.0, 90.0)], (64,), False),
    "interpolated": ([(0.0, 100.0), (4.0, 300.0)], (16, 1024), False),
    "mode_min": ([(64, 5.0), (512, 1.0), (256, 3.0)], (1, 4096), True),
    "tie": ([(1.0, 7.0), (4.0, 7.0)], (64,), False),
}


@pytest.mark.parametrize("case", sorted(SELECTOR_CASES))
def test_selector_resolve_and_explain_equal(tmp_path, case):
    scores, rows, mode_min = SELECTOR_CASES[case]
    name = "sql.rowbucket.min" if mode_min else WAIT_KNOB
    got = {}
    for tag, pkg in (("port", PT), ("jax", JT)):
        st = pkg.TrialStore(str(tmp_path / f"{tag}.json"))
        if scores:
            st.add(_wait_trials(pkg, scores, rows, mode_min))
        sel = pkg.Selector(st)
        seq = [sel.resolve(pkg.REGISTRY.get(name), shape) for shape in (None, 1, 64, 100, 1000,
                                                                         5000)]
        with pkg.ab_fence():
            seq.append(sel.resolve(pkg.REGISTRY.get(name), 64))
            seq.append(pkg.fence_active())
        seq.append(pkg.fence_active())
        got[tag] = (seq, sel.explain(), sel.explain(name))
    assert got["port"] == got["jax"]


def test_installed_selector_moves_every_migrated_call_site(tmp_path):
    """A selector whose trials favour other values moves the server, the
    batcher, the queue, the source and the retention policy; inside a
    fenced A/B each resolves to the declared default."""
    import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.table_lifecycle import (  # noqa: E501
        RetentionPolicy,
    )

    st = PT.TrialStore(str(tmp_path / "t.json"))
    st.add([PT.make_trial(knob=k, value=v, score=s) for k, pairs in {
        WAIT_KNOB: ((0.5, 2.0), (2.0, 1.0)),
        "serve.queue.max_rows": ((8192, 2.0), (4096, 1.0)),
        "stream.source.max_files_per_batch": ((4, 2.0), (0, 1.0)),
        "table.seal.min_batches": ((2, 1.0), (4, 2.0)),              # mode min
        "table.seal.max_segment_batches": ((16, 2.0), (64, 1.0)),
    }.items() for v, s in pairs])

    def resolved():
        srv = port.serve.InferenceServer(device="cpu")
        src = port.FileStreamSource(str(tmp_path), port.hospital_event_schema())
        pol = RetentionPolicy()
        return (srv.max_wait_s, srv.max_queue_rows, port.serve.RequestQueue().max_rows,
                src.files_cap(), pol.min_seal_batches, pol.max_segment_batches)

    sel = PT.Selector(st)
    with PT.active(sel):
        assert resolved() == (0.0005, 8192, 8192, 4, 2, 16)
        assert sel.explain(WAIT_KNOB)["reason"].startswith(PT.REASON_TUNED_PREFIX)
        with PT.ab_fence():
            fresh = PT.Selector(st)
            PT.install(fresh)
            assert resolved() == (0.002, 4096, 4096, 0, 4, 64)
            assert fresh.explain(WAIT_KNOB)["reason"] == PT.REASON_FROZEN_FENCED
    assert PT.installed() is None and resolved() == (0.002, 4096, 4096, 0, 4, 64)


def test_killed_store_commit_replays_exactly_once(tmp_path):
    """A kill at the port's ``tune.store.commit`` leaves the previous
    document; the replayed add gives the bytes the JAX package writes
    for an uninterrupted run."""
    base = [PT.make_trial(**TRIALS[1])]
    extra = [PT.make_trial(**TRIALS[0])]
    ref = JT.TrialStore(str(tmp_path / "ref.json"))
    ref.add([JT.make_trial(**TRIALS[1])])
    ref.add([JT.make_trial(**TRIALS[0])])
    st = PT.TrialStore(str(tmp_path / "t.json"))
    st.add(base)
    plan = PF.FaultPlan().crash("tune.store.commit")
    with PF.active(plan):
        with pytest.raises(PF.InjectedCrash):
            st.add(extra)
    assert plan.fired("tune.store.commit") == 1
    assert not os.path.exists(str(tmp_path / "t.json.tmp"))
    resumed = PT.TrialStore(str(tmp_path / "t.json"))
    assert len(resumed) == 1
    resumed.add(extra)
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "ref.json").read_bytes()


class _Holder:
    def __init__(self, value):
        self.value = value

    def apply(self, v):
        self.value = v


def _retuner(pkg, tmp_path, holder, journal="retune.journal"):
    st = pkg.TrialStore(str(tmp_path / f"{pkg.__name__.split('.')[0][-5:]}-trials.json"))
    st.add([pkg.make_trial(**t) for t in TRIALS[:2]])
    return pkg.LiveRetuner(WAIT_KNOB, journal_path=str(tmp_path / journal),
                           apply_fn=holder.apply, selector=pkg.Selector(st),
                           convert=lambda ms: ms / 1e3)


def test_live_retune_equal_and_its_journal_resumes_in_the_other_package(tmp_path):
    hp, hj = _Holder(0.002), _Holder(0.002)
    rp = _retuner(PT, tmp_path, hp, "port.journal")
    rj = _retuner(JT, tmp_path, hj, "jax.journal")
    assert rp.retune(shape_rows=64) == rj.retune(shape_rows=64)
    assert hp.value == hj.value == 0.0
    strip = [{k: v for k, v in e.items()} for e in j_read_lines(rp.journal_path)]
    assert strip == j_read_lines(rj.journal_path)
    # the JAX package resumes the port's journal, and the port the JAX one
    h2, h3 = _Holder(0.002), _Holder(0.002)
    j2 = JT.LiveRetuner(WAIT_KNOB, journal_path=rp.journal_path, apply_fn=h2.apply,
                        selector=rj.selector, convert=lambda ms: ms / 1e3)
    p3 = PT.LiveRetuner(WAIT_KNOB, journal_path=rj.journal_path, apply_fn=h3.apply,
                        selector=rp.selector, convert=lambda ms: ms / 1e3)
    assert j2.resume() == p3.resume() == 0.0 and h2.value == h3.value == 0.0
    t = rp.observe(1234.5, shape_rows=128, meta={"phase": "midday"})
    assert t == rj.observe(1234.5, shape_rows=128, meta={"phase": "midday"})


def test_killed_live_retune_leaves_the_previous_value_serving(tmp_path):
    h = _Holder(0.002)
    rt = _retuner(PT, tmp_path, h)
    plan = PF.FaultPlan().crash("tune.select.apply")
    with PF.active(plan):
        with pytest.raises(PF.InjectedCrash):
            rt.retune(shape_rows=64)
    assert h.value == 0.002
    assert [e["kind"] for e in j_read_lines(rt.journal_path)] == ["intent"]
    h2 = _Holder(0.002)
    rt2 = _retuner(PT, tmp_path, h2)
    assert rt2.resume() is None and h2.value == 0.002
    with PT.ab_fence():
        frozen = rt2.retune(shape_rows=64)
    assert not frozen["applied"] and frozen["reason"] == PT.REASON_FROZEN_FENCED
    assert rt2.retune(shape_rows=64)["applied"] and h2.value == 0.0
    assert [e["kind"] for e in j_read_lines(rt.journal_path)] == ["intent", "intent", "commit"]
