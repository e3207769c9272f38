"""The port's ``CircuitBreaker`` against the JAX package's, and the port's
micro-batcher around it, on the CPU.

The same operation script runs through both breakers under the same fake
clock: every return value, state, snapshot and transition callback is
``==`` (host Python in both, no arithmetic to round).  The batcher with an
open breaker answers from the fallback without calling the primary.
"""

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu.serve.breaker as JB
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve.breaker as PB
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve import (
    STATUS_OK,
    STATUS_UNAVAILABLE,
    MicroBatcher,
    ServingMetrics,
    ServingModel,
)

torch.set_num_threads(1)

OPS = ("allow", "success", "failure", "trip", "reset", "tick", "tick_long", "state",
       "snapshot")


@pytest.fixture(autouse=True)
def _flight_dir(tmp_path, monkeypatch):
    # an opening breaker writes a flight-recorder postmortem: keep it here
    monkeypatch.setenv("CMLHN_FLIGHT_DIR", str(tmp_path / "flight"))


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _run(mod, script, **kw):
    clock, moves = Clock(), []
    b = mod.CircuitBreaker(clock=clock, on_transition=lambda o, n: moves.append((o, n)), **kw)
    out = []
    for op in script:
        if op == "allow":
            out.append(b.allow())
        elif op == "success":
            b.record_success()
        elif op == "failure":
            b.record_failure()
        elif op == "trip":
            b.trip("drift")
        elif op == "reset":
            b.reset("swap")
        elif op == "tick":
            clock.t += 0.4
        elif op == "tick_long":
            clock.t += 2.5
        elif op == "state":
            out.append(b.state)
        else:
            out.append(b.snapshot())
    out.append(b.snapshot())
    return out, moves, (b.opened_count, b.short_circuited, b.tripped_count)


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("threshold,half_open", [(1, 1), (3, 1), (2, 2)])
def test_transitions_equal_under_the_same_fake_clock(seed, threshold, half_open):
    rng = np.random.default_rng(seed)
    weights = np.array([6, 3, 4, 1, 1, 2, 1, 2, 1], float)
    script = list(rng.choice(OPS, size=200, p=weights / weights.sum()))
    kw = dict(failure_threshold=threshold, recovery_timeout_s=2.0, half_open_max_calls=half_open)
    got, want = _run(PB, script, **kw), _run(JB, script, **kw)
    assert got == want
    assert got[2][0] >= 1          # the script opened the breaker at least once


def test_the_documented_cycle():
    """closed → open after the threshold → short circuits → half_open
    after the recovery time → a failed probe re-opens → a good probe
    closes; trip and reset force the ends."""
    script = (["failure"] * 3 + ["allow", "state", "tick_long", "state", "allow", "allow",
                                  "failure", "state", "tick_long", "allow", "success", "state",
                                  "trip", "state", "allow", "reset", "state", "allow"])
    got, moves, counts = _run(PB, script, failure_threshold=3, recovery_timeout_s=2.0)
    assert got[:12] == [False, "open", "half_open", True, False, "open", True, "closed", "open",
                        False, "closed", True]
    assert moves == [("closed", "open"), ("open", "half_open"), ("half_open", "open"),
                     ("open", "half_open"), ("half_open", "closed"), ("closed", "open"),
                     ("open", "closed")]
    assert counts == (3, 3, 1)
    assert _run(JB, script, failure_threshold=3, recovery_timeout_s=2.0) == (got, moves, counts)
    with pytest.raises(ValueError, match="failure_threshold"):
        PB.CircuitBreaker(failure_threshold=0)


def _serving(fails: list):
    class Flaky(port.KMeansModel):
        calls = 0

        def predict(self, xt):
            Flaky.calls += 1
            if xt.shape[0] > 1 and fails and fails.pop(0):
                raise RuntimeError("planted failure")
            return super().predict(xt)

    rng = np.random.default_rng(0)
    m = Flaky(rng.normal(size=(4, 3)).astype(np.float32))
    return Flaky, ServingModel(m, buckets=(1, 4), device="cpu")


def test_open_breaker_answers_from_the_fallback_without_the_primary():
    Flaky, sm = _serving([True, True])
    clock = Clock()
    metrics = ServingMetrics()
    breaker = PB.CircuitBreaker(failure_threshold=2, recovery_timeout_s=1.0, clock=clock,
                                on_transition=metrics.record_breaker_transition)
    x = np.random.default_rng(1).normal(size=(3, 3)).astype(np.float32)
    with MicroBatcher(sm, fallback=lambda r: np.full(len(r), -7), metrics=metrics,
                      breaker=breaker) as b:
        answers = [b.predict(x) for _ in range(2)]
        assert breaker.state == PB.STATE_OPEN
        calls = Flaky.calls
        shorted = [b.predict(x) for _ in range(3)]
        assert Flaky.calls == calls                    # the primary saw none of them
        clock.t += 1.0                                 # recovery: a half-open probe
        probe = b.predict(x)
    assert [a.status for a in answers + shorted] == [STATUS_UNAVAILABLE] * 5
    assert all(a.degraded and list(a.value) == [-7, -7, -7] for a in answers + shorted)
    assert [a.detail for a in shorted] == ["circuit open"] * 3
    assert probe.status == STATUS_OK and breaker.state == PB.STATE_CLOSED
    snap = metrics.snapshot()
    assert snap["primary_failures"] == 2 and snap["fallback_answers"] == 5
    assert snap["breaker_transitions"] == 3
    assert metrics.registry.counters["serve.breaker.to_open"] == 1
    assert breaker.snapshot()["short_circuited"] == 3
