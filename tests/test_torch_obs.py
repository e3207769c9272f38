"""The port's observability layer against the JAX package's: the metrics
registry, span tracing through the write-ahead-log helpers, and the
flight recorder that ``utils/faults.py`` feeds — a fired fault rule lands
in the ring, and an injected crash writes a CRC-checked postmortem, in
both packages from the same :class:`FaultPlan` rules, each readable by the
other package."""

import json
import os

import numpy as np
import pytest
import torch

from clustermachinelearningforhospitalnetworks_apache_spark_tpu.obs import (
    flight_recorder as j_flight,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.obs import registry as j_registry
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.obs import trace as j_trace
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.utils import faults as j_faults
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.obs import (
    flight_recorder as p_flight,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.obs import registry as p_registry
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.obs import trace as p_trace
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.streaming import wal as p_wal
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults as p_faults

# the suite runs several worker processes on a few cores: one intra-op
# thread per worker keeps torch from oversubscribing them
torch.set_num_threads(1)

PACKAGES = {"jax": (j_flight, j_faults), "port": (p_flight, p_faults)}


@pytest.fixture
def recorders(tmp_path):
    """A fresh flight recorder per package, dumping under tmp."""
    out, old = {}, {}
    for name, (flight, _) in PACKAGES.items():
        old[name] = flight.recorder()
        out[name] = flight.install(flight.FlightRecorder(dump_dir=str(tmp_path / name)))
    yield out
    for name, (flight, _) in PACKAGES.items():
        flight.install(old[name])


def _events(rec):
    return [(e["kind"], e["name"], e.get("attrs")) for e in rec.events]


def test_fired_rules_land_in_the_ring(recorders):
    """Every fired rule — fail, delay, corrupt, tear, disk_full — is
    noted as ("fault", site, action), in both packages alike; a rule
    that does not fire notes nothing."""
    for name, (_, faults) in PACKAGES.items():
        plan = (faults.FaultPlan(seed=3)
                .fail("io.read", times=1)
                .delay("io.slow", 0.0)
                .corrupt("io.bytes")
                .tear("io.tear", at_byte=2)
                .disk_full("io.full", after_bytes=0)
                .fail("never.fires"))
        with faults.active(plan):
            with pytest.raises(faults.FaultError):
                faults.fault_point("io.read")
            faults.fault_point("io.read")          # times=1: spent
            faults.fault_point("io.slow")
            faults.mangle_bytes("io.bytes", b"abcdef")
            assert faults.torn_point("io.tear", 8) == 2
            assert faults.enospc_point("io.full", 8) == 0
    jax, port = (_events(recorders[n]) for n in PACKAGES)
    assert port == jax
    assert [e[1] for e in port] == ["io.read", "io.slow", "io.bytes", "io.tear", "io.full"]
    assert [e[2] for e in port] == [{"action": a} for a in
                                    ("fail", "delay", "corrupt", "tear", "disk_full")]


def test_injected_crash_writes_a_crc_checked_dump(recorders):
    payloads = {}
    for name, (flight, faults) in PACKAGES.items():
        with faults.active(faults.FaultPlan().crash("obs.test.kill")):
            with pytest.raises(faults.InjectedCrash):
                faults.fault_point("obs.test.kill")
        rec = recorders[name]
        assert rec.dumps == 1 and rec.dump_failures == 0
        path = rec.last_dump_path
        payload = flight.read_dump(path)
        # the other package reads the same record format
        other = p_flight if flight is j_flight else j_flight
        assert other.read_dump(path) == payload
        payloads[name] = payload
    for p in payloads.values():
        assert p["reason"] == "injected_crash" and p["site"] == "obs.test.kill"
        assert p["trigger"] == {"message": "injected crash at obs.test.kill"}
        assert "counters" in p["metrics"]
        kinds = [(e["kind"], e["name"]) for e in p["events"]]
        # the rule's fire, then the crash itself
        assert kinds == [("fault", "obs.test.kill"), ("injected_crash", "obs.test.kill")]
    # a flipped byte inside the payload is loud corruption
    path = recorders["port"].last_dump_path
    with open(path) as f:
        raw = f.read()
    with open(path, "w") as f:
        f.write(raw.replace('"site":"obs.test.kill"', '"site":"obs.test.kilL"'))
    for flight in (p_flight, j_flight):
        with pytest.raises(ValueError, match="crc32c mismatch"):
            flight.read_dump(path)


def test_crash_raised_by_hand_dumps_too(recorders):
    crash = p_faults.InjectedCrash("by hand", site="hand.site")
    assert recorders["port"].dumps == 1
    payload = p_flight.read_dump(recorders["port"].last_dump_path)
    assert (payload["site"], payload["trigger"]) == ("hand.site", {"message": str(crash)})


def test_registry_histograms_merge_like_the_reference():
    rng = np.random.default_rng(0)
    edges = (0.5, 1.0, 2.0, 5.0, 10.0)
    a, b = rng.gamma(2.0, 1.5, 300), rng.gamma(1.0, 3.0, 200)
    out = {}
    for name, reg in (("jax", j_registry), ("port", p_registry)):
        h1, h2 = reg.FixedHistogram(edges), reg.FixedHistogram(edges)
        h1.observe(a)
        h2.observe(b)
        h1.merge(h2)
        out[name] = (h1.to_dict(), [h1.quantile(q) for q in (0.5, 0.9, 0.99)])
    assert out["port"] == out["jax"]


def test_span_log_round_trips_through_the_wal(tmp_path):
    """Spans flushed to a JSONL log through ``streaming/wal.py``; a torn
    tail is skipped, and each package reads the other's log."""
    logs = {}
    for name, trace in (("jax", j_trace), ("port", p_trace)):
        path = str(tmp_path / f"{name}.jsonl")
        with trace.active(trace.Tracer(path, flush_every=2)):
            with trace.span("sql.query") as sp:
                sp.note("route", "compiled")
                with trace.span("stage.window"):
                    pass
        with open(path, "a") as f:
            f.write('{"torn": ')          # a crash mid-append
        logs[name] = path
    for name, path in logs.items():
        spans = p_trace.read_spans(path)
        assert spans == j_trace.read_spans(path)
        assert [s["name"] for s in spans] == ["stage.window", "sql.query"]
        assert spans[1]["attrs"] == {"route": "compiled"}
        assert spans[0]["parent_id"] == spans[1]["span_id"]
        assert p_trace.by_name(spans) == {"stage.window": 1, "sql.query": 1}
    # the next append starts on a fresh line after the torn tail
    p_wal.append_line(logs["port"], {"k": 1})
    assert p_wal.read_lines(logs["port"])[-1] == {"k": 1}


def test_wal_append_tears_at_the_fault_site(tmp_path):
    path = str(tmp_path / "log.jsonl")
    p_wal.append_line(path, {"a": 1})
    with p_faults.active(p_faults.FaultPlan().tear("wal.append", at_byte=3)):
        with pytest.raises(p_faults.InjectedCrash, match="torn write"):
            p_wal.append_line(path, {"b": 2})
    assert p_wal.read_lines(path) == [{"a": 1}]
    p_wal.append_line(path, {"c": 3})
    assert p_wal.read_lines(path) == [{"a": 1}, {"c": 3}]
    with open(path) as f:
        assert json.loads(f.read().splitlines()[-1]) == {"c": 3}
    assert os.path.getsize(path) > 0


def test_span_vocabulary_equals_the_reference():
    assert p_trace.REGISTERED_SPANS == j_trace.REGISTERED_SPANS
    assert p_trace.SITE_COVERAGE == j_trace.SITE_COVERAGE
