"""The port's compressed-production-day soak (``soak/``) against the JAX
package's, on the CPU.

The JAX package's own soak does not complete in this environment (its
per-tenant view reaches a compiled SQL aggregate that imports a name the
installed jax lacks), so no JAX soak report serves as ground truth.  The
port is held instead to the reference's host pieces, which are copies:

* the schedule — configs and chaos plans ``==`` over many seeds and
  config variants, through the JSON round trip the report relies on;
* the report — the same file bytes for the same payload, each package
  reading the other's file, the same tamper errors, and ``check_report``'s
  violation lists ``==`` on the port's smoke payload and on one doctored
  payload per invariant (the mutations of ``tests/test_soak.py``);
* the resource probe's verdict on the same injected samples;
* the data draws — CSV bytes and the day-zero pools ``==``.

Then one port smoke day on ``device="cpu"`` (module-scoped, with CUDA
reported absent so any entry point left on its card default fails the
run) must check clean under both packages' ``check_report``, the JAX one
re-reading the port's flight dumps from disk, and ``--check`` of the
port's CLI must answer as ``tools/soak.py`` does.

Tolerances, each with its reason:

* ``CENTER_TOL`` = 2e-6 (``tests/test_torch_farm.py``): the day-zero farm
  fit's float32 Lloyd sums run in another order than XLA's over the same
  pools (measured 1.2e-7 on the smoke pools, 2.4e-7 on the full day's);
* the costs within 2^-20·Σ w·|x|² a tenant (the same file's bound: the
  reference takes d² in the cross-term form).

Everything else is ``==``: it is host code copied from the reference.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

from clustermachinelearningforhospitalnetworks_apache_spark_tpu import farm as JF
from clustermachinelearningforhospitalnetworks_apache_spark_tpu import soak as JS
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.obs import (
    flight_recorder as jflight,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.obs import (
    registry as jregistry,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.soak import driver as JD
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.soak import report as JR
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.soak import (
    resource_probe as JP,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.soak import schedule as JSC
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import soak as PS
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.farm import (
    FarmKMeans,
    pack_tenants,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.obs import (
    flight_recorder as pflight,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.obs import (
    registry as pregistry,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.soak import driver as PD
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.soak import report as PR
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.soak import (
    resource_probe as PP,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.soak import (
    schedule as PSC,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.soak.__main__ import (
    main as port_main,
)

# the suite runs several worker processes on a few cores: one intra-op
# thread per worker keeps torch from oversubscribing them
torch.set_num_threads(1)

pytestmark = pytest.mark.soak

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
CENTER_TOL = 2e-6

#: the report's keys, as the reference's ``run_soak`` writes them
REPORT_KEYS = {
    "version", "seed", "config", "wall_s", "phases", "unanswered_total",
    "unhandled", "kills", "double_kills", "chaos_schedule", "resources",
    "lifecycle", "trace", "fleet_health", "ingest", "retune",
}


def _events(events) -> list[dict]:
    return [e.to_dict() for e in events]


# ------------------------------------------------------------ the schedule
def test_schedule_constants_equal_the_reference():
    assert PSC.CRASH_SITES == JSC.CRASH_SITES
    for name in ("KIND_KILL", "KIND_REVIVE", "KIND_CRASH", "KIND_DOUBLE_KILL"):
        assert getattr(PS, name) == getattr(JS, name), name
    assert PR.SCHEMA_VERSION == JR.SCHEMA_VERSION
    assert PR.REQUIRED_TRACE_SPANS == JR.REQUIRED_TRACE_SPANS
    assert PD.FEATURES == JD.FEATURES and PD.BUCKETS == JD.BUCKETS
    assert PD.VIEW_QUERY == JD.VIEW_QUERY and PD.SERVING_NAME == JD.SERVING_NAME
    assert vars(PD.RETENTION) == vars(JD.RETENTION)


@pytest.mark.parametrize("seed", [None, 0, 7, 1107, 4242])
def test_configs_equal_the_reference(seed):
    if seed is None:
        assert PS.SMOKE_CONFIG.to_dict() == JS.SMOKE_CONFIG.to_dict()
        mine, ref = PSC.full_config(), JSC.full_config()
    else:
        mine, ref = PSC.full_config(seed), JSC.full_config(seed)
    assert mine.to_dict() == ref.to_dict()
    assert mine.total_s == ref.total_s
    back = PS.SoakConfig.from_dict(json.loads(json.dumps(ref.to_dict())))
    assert back == mine


@pytest.mark.parametrize("seed", range(50))
def test_chaos_schedule_equals_the_reference(seed):
    for base_p, base_j in ((PS.SMOKE_CONFIG, JS.SMOKE_CONFIG),
                           (PSC.full_config(), JSC.full_config())):
        d = json.loads(json.dumps({**base_j.to_dict(), "seed": seed}))
        assert _events(PS.build_chaos_schedule(PS.SoakConfig.from_dict(d))) == _events(
            JS.build_chaos_schedule(JS.SoakConfig.from_dict(d)))
        assert _events(PS.build_chaos_schedule(replace(base_p, seed=seed))) == _events(
            JS.build_chaos_schedule(replace(base_j, seed=seed)))


@pytest.mark.parametrize("field,values", [
    ("replica_kills", (0, 1, 3, 5)),
    ("crashes", (0, 1, 4, 6, 9)),
    ("double_kills", (0, 2, 3)),
    ("n_replicas", (1, 2, 4, 8)),
])
def test_chaos_schedule_variants_equal_the_reference(field, values):
    for v in values:
        for seed in (0, 3, 1107):
            d = json.loads(json.dumps(
                {**JS.SMOKE_CONFIG.to_dict(), field: v, "seed": seed}))
            mine = PS.build_chaos_schedule(PS.SoakConfig.from_dict(d))
            assert _events(mine) == _events(JS.build_chaos_schedule(JS.SoakConfig.from_dict(d)))
            assert sum(e.kind == PS.KIND_DOUBLE_KILL for e in mine) == d["double_kills"]


# -------------------------------------------------------- the resource probe
def _sample(label, rss=1000.0, exact=True, disk=100.0, series=40, ring=10, cap=4096,
            table=50.0):
    return {"label": label, "t_s": 0.0, "rss_kb": rss, "rss_exact": exact,
            "disk_kb": disk, "metric_series": series, "ring_events": ring,
            "ring_capacity": cap, "dump_files": 0, "table_kb": table}


_PROBE_CASES = {
    "bounded": [_sample("start"), _sample("mid", rss=1500.0), _sample("end", rss=2000.0)],
    "one sample": [_sample("start")],
    "no samples": [],
    "rss grew": [_sample("start"), _sample("mid"), _sample("end", rss=2600.0)],
    "rss inexact": [_sample("start", exact=False), _sample("end", rss=9000.0)],
    "disk over cap": [_sample("start"), _sample("end", disk=256.0 * 1024 + 1)],
    "series over cap": [_sample("start", series=4000), _sample("mid", series=4096),
                        _sample("end", series=4097)],
    "series grew": [_sample("start"), _sample("mid", series=40), _sample("end", series=57)],
    "series grew a quarter": [_sample("start"), _sample("mid", series=200),
                              _sample("end", series=251)],
    "ring over capacity": [_sample("start"), _sample("end", ring=9, cap=8)],
    "ring no capacity": [_sample("start"), _sample("end", ring=1, cap=None)],
    "everything": [_sample("start"), _sample("mid"),
                   _sample("end", rss=9e9, disk=1e9, series=9999, ring=99, cap=8)],
}


@pytest.mark.parametrize("case", sorted(_PROBE_CASES))
def test_probe_report_equals_the_reference(case, tmp_path):
    """The verdict on the same samples, at the config's ceilings and at
    tighter ones."""
    for kw in ({}, {"rss_growth_ratio": 1.5, "max_disk_mb": 0.01, "max_metric_series": 41}):
        mine = PP.ResourceProbe(str(tmp_path))
        ref = JP.ResourceProbe(str(tmp_path))
        mine.samples = copy.deepcopy(_PROBE_CASES[case])
        ref.samples = copy.deepcopy(_PROBE_CASES[case])
        assert mine.report(**kw) == ref.report(**kw)
        if not kw:
            assert mine.report()["bounded"] is (case in ("bounded", "rss inexact"))


def test_probe_footprints_equal_the_reference(tmp_path):
    """The disk walk and the series count agree on the same inputs, and a
    live sample carries the reference's keys."""
    (tmp_path / "a" / "b").mkdir(parents=True)
    for i, n in enumerate((0, 10, 4096, 12345)):
        (tmp_path / ("a" if i % 2 else "a/b") / f"f{i}").write_bytes(b"x" * n)
    assert PP._disk_kb(str(tmp_path)) == JP._disk_kb(str(tmp_path))
    assert PP._disk_kb(str(tmp_path / "missing")) == JP._disk_kb(str(tmp_path / "missing"))
    regs = []
    for mod in (pregistry, jregistry):
        r = mod.MetricsRegistry()
        r.inc("a.count")
        r.inc('a.count{tenant="H01"}')
        r.set("b.gauge", 2.0)
        r.observe("c.hist", 0.3)
        regs.append(r)

    class Dying:
        def collect(self):
            raise RuntimeError("gone")

    assert PP._series_count([regs[0], Dying()]) == JP._series_count([regs[1], Dying()])
    assert PP._series_count([regs[0]]) >= 3
    rss, exact = PP._rss_kb()
    assert exact and rss > 0
    keys = set(PP.ResourceProbe(str(tmp_path), table_dir=str(tmp_path)).sample("x"))
    assert keys == set(JP.ResourceProbe(str(tmp_path), table_dir=str(tmp_path)).sample("x"))


# -------------------------------------------------------------- the data
@pytest.mark.parametrize("full", [False, True])
def test_data_draws_equal_the_reference(full, tmp_path):
    """The day-zero pools (a run's first draws) are ``==``; the phase CSVs
    after them (drift off and on, across successive phases: the rng and
    the event clock carry over) are the same bytes; the day-zero farm fit
    is within the farm's bounds of the JAX fit, with equal sizes,
    iterations and profiles."""
    cfg_p = PSC.full_config() if full else PS.SMOKE_CONFIG
    cfg_j = JSC.full_config() if full else JS.SMOKE_CONFIG
    mine = PD._SoakRun(cfg_p, str(tmp_path / "p"), device=CPU)
    ref = JD._SoakRun(cfg_j, str(tmp_path / "j"))
    assert mine.tenants == ref.tenants and mine.drift_set == ref.drift_set
    # the reference's _run_inner draws the pools inline, in this order
    pools = [mine.day_zero_pools(), {
        t: np.column_stack([
            ref._tenant_rows(t, ref.cfg.rows_per_tenant, False)[f].astype(np.float64)
            for f in JD.FEATURES
        ])
        for t in ref.tenants
    }]
    for tag, drift in (("seed", False), ("night", True), ("rush", True), ("chaos", False)):
        a, b = mine._write_phase_csv(tag, drift), ref._write_phase_csv(tag, drift)
        assert os.path.basename(a) == os.path.basename(b)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), tag
    assert list(pools[0]) == list(pools[1])
    assert all(np.array_equal(pools[0][t], pools[1][t]) for t in pools[0])
    kw = dict(k=cfg_p.kmeans_k, max_iter=cfg_p.kmeans_iters, seed=cfg_p.seed,
              feature_names=list(PD.FEATURES))
    pm = FarmKMeans(**kw).fit(pools[0], device=CPU)
    jm = JF.FarmKMeans(**kw).fit(pools[1])
    assert sorted(pm.arrays) == sorted(jm.arrays)
    assert np.abs(pm.arrays["centers"] - np.asarray(jm.arrays["centers"])).max() <= CENTER_TOL
    for name in ("center_valid", "sizes", "n_iter", "tenant_rows", "masked_rows",
                 "profile_counts", "profile_edges", "profile_stats"):
        assert np.array_equal(pm.arrays[name], np.asarray(jm.arrays[name])), name
    batch = pack_tenants(pools[0])
    sq = (batch.w[..., None] * batch.x.astype(np.float64) ** 2).sum(axis=(1, 2))
    gap = np.abs(pm.arrays["costs"][:-1] - np.asarray(jm.arrays["costs"])[:-1])
    assert np.all(gap <= 2.0 ** -20 * sq)


# --------------------------------------------------------- the port's smoke
@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """One port smoke day on the CPU.  CUDA reads as absent throughout,
    so an entry point left on its card default raises and lands in the
    report's ``unhandled`` list."""
    wd = tmp_path_factory.mktemp("torch_soak_smoke")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        payload, path = PS.run_soak(PS.SMOKE_CONFIG, str(wd), device=CPU)
    return payload, path


def test_smoke_checks_clean_under_both_packages(smoke):
    payload, _ = smoke
    assert PS.check_report(payload) == []
    # the JAX package's checker re-reads every postmortem with its own
    # flight_recorder.read_dump
    assert JS.check_report(payload) == []
    assert JS.check_report(payload, verify_postmortems=False) == []
    assert set(payload) == REPORT_KEYS
    assert payload["unhandled"] == []


def test_smoke_every_chaos_kind_ran_and_recovered(smoke):
    payload, _ = smoke
    kills = payload["kills"]
    kinds = {k["kind"] for k in kills}
    assert {PS.KIND_KILL, PS.KIND_REVIVE, PS.KIND_DOUBLE_KILL} <= kinds
    assert all(k["recovered"] for k in kills)
    for k in kills:
        if k["kind"] == PS.KIND_REVIVE:
            continue
        assert k["postmortems"], k["label"]
        for pm in k["postmortems"]:
            # both packages read the port's dump
            assert pflight.read_dump(pm["path"])["site"] == pm["site"]
            assert jflight.read_dump(pm["path"])["site"] == pm["site"]


def test_smoke_double_kill_is_a_crash_inside_recovery(smoke):
    payload, _ = smoke
    dk = [k for k in payload["kills"] if k["kind"] == PS.KIND_DOUBLE_KILL]
    assert len(dk) >= 1
    for k in dk:
        sites = [pm["site"] for pm in k["postmortems"]]
        assert "fit_ckpt.save.commit" in sites
        assert "fit_ckpt.resume" in sites
        assert k["bit_identical"] is True


def test_smoke_phase_slos_and_trace_chain(smoke):
    payload, _ = smoke
    names = [p["name"] for p in payload["phases"]]
    assert names == [p.name for p in PS.SMOKE_CONFIG.phases]
    for p in payload["phases"]:
        assert p["unanswered"] == 0
        assert p["goodput_frac"] >= p["min_goodput_frac"]
    assert payload["unanswered_total"] == 0
    tr = payload["trace"]
    assert tr["trace_id"]
    assert set(PR.REQUIRED_TRACE_SPANS) <= set(tr["span_names"])
    assert tr["csv_file"].endswith(".csv")
    assert tr["promoted_model"]
    assert payload["retune"]["applied"]
    assert payload["retune"]["journal_kinds"][-1] == "commit"


def test_smoke_replays_its_schedule(smoke):
    payload, _ = smoke
    cfg = PS.SoakConfig.from_dict(payload["config"])
    assert cfg == PS.SMOKE_CONFIG
    assert _events(PS.build_chaos_schedule(cfg)) == payload["chaos_schedule"]
    assert _events(JS.build_chaos_schedule(JS.SoakConfig.from_dict(payload["config"]))) == (
        payload["chaos_schedule"])


def test_smoke_report_crc_round_trip(smoke):
    payload, path = smoke
    want = json.loads(json.dumps(payload, default=str))
    assert PS.read_report(path) == want
    assert JS.read_report(path) == want


def test_report_bytes_equal_the_reference(smoke, tmp_path):
    """Both packages write the same bytes for the same payload and read
    each other's file."""
    payload, _ = smoke
    mine, ref = str(tmp_path / "mine.json"), str(tmp_path / "ref.json")
    assert PS.write_report(payload, mine) == mine
    JS.write_report(payload, ref)
    with open(mine, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert PS.read_report(ref) == JS.read_report(mine)
    assert not os.path.exists(mine + ".tmp")


def test_report_tamper_detected_as_the_reference(smoke, tmp_path):
    payload, _ = smoke
    path = str(tmp_path / "r.json")
    PS.write_report(payload, path)
    with open(path) as f:
        record = json.load(f)
    record["payload"]["unanswered_total"] = 0
    record["payload"]["wall_s"] = -1
    with open(path, "w") as f:
        json.dump(record, f)
    errors = []
    for read in (PS.read_report, JS.read_report):
        with pytest.raises(ValueError, match="crc32c mismatch") as e:
            read(path)
        errors.append(str(e.value))
    with open(path, "w") as f:
        json.dump({"not": "a report"}, f)
    for read in (PS.read_report, JS.read_report):
        with pytest.raises(ValueError, match="not a SoakReport") as e:
            read(path)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and errors[2] == errors[3]


def test_report_commit_is_a_fault_site(smoke, tmp_path):
    """A kill at ``soak.report.commit`` leaves no report and no temp file;
    the next write lands it whole."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults

    payload, _ = smoke
    path = str(tmp_path / "r.json")
    with faults.active(faults.FaultPlan().crash("soak.report.commit")):
        with pytest.raises(faults.InjectedCrash):
            PS.write_report(payload, path)
    assert not os.path.exists(path) and not os.path.exists(path + ".tmp")
    PS.write_report(payload, path)
    assert JS.read_report(path) == json.loads(json.dumps(payload, default=str))


# the doctored payloads of tests/test_soak.py, one per invariant
def _unhandled(p):
    p["unhandled"] = ["phase night: RuntimeError('boom')"]


def _unanswered(p):
    p["phases"][0]["unanswered"] = 3


def _goodput(p):
    p["phases"][1]["goodput_frac"] = 0.0


def _kill_unrecovered(p):
    p["kills"][0]["recovered"] = False


def _no_double_kill(p):
    p["kills"] = [k for k in p["kills"] if k["kind"] != PS.KIND_DOUBLE_KILL]


def _second_kill_missing(p):
    for k in p["kills"]:
        if k["kind"] == PS.KIND_DOUBLE_KILL:
            k["postmortems"] = k["postmortems"][:1]


def _not_bit_identical(p):
    for k in p["kills"]:
        if k["kind"] == PS.KIND_DOUBLE_KILL:
            k["bit_identical"] = False


def _unbounded(p):
    p["resources"] = {"bounded": False, "violations": ["rss grew 9x"]}


def _no_lifecycle(p):
    p["lifecycle"]["ticks"] = []


def _lost_segment(p):
    p["lifecycle"]["ticks"][0]["scrub"] = {"checked": 1, "repaired": 0, "quarantined": 1}


def _table_over_budget(p):
    p["resources"]["samples"][1]["table_kb"] = p["config"]["table_budget_mb"] * 1024.0 + 1.0


def _table_unobserved(p):
    p["resources"]["samples"][0].pop("table_kb", None)


def _broken_trace(p):
    p["trace"]["span_names"] = ["stream.batch"]


def _not_replayable(p):
    p["chaos_schedule"] = p["chaos_schedule"][:-1]


def _wrong_version(p):
    p["version"] = PR.SCHEMA_VERSION + 1


def _no_retune(p):
    p["retune"] = None


def _retune_not_applied(p):
    p["retune"]["applied"] = False


def _retune_commitless_journal(p):
    p["retune"]["journal_kinds"] = ["intent"]


def _retune_goodput_regressed(p):
    p["phases"][-1]["goodput_frac"] = 0.6


def _site_tag_mismatch(p):
    victim = next(k for k in p["kills"] if k["postmortems"])
    victim["postmortems"][0]["site"] = "somewhere.else"


def _clean(p):
    pass


DOCTORED = [
    (_clean, None),
    (_unhandled, "unhandled exception"),
    (_unanswered, "unanswered=3"),
    (_goodput, "below the"),
    (_kill_unrecovered, "not recovered"),
    (_no_double_kill, "no double-kill"),
    (_second_kill_missing, "fewer than 2 postmortems"),
    (_not_bit_identical, "NOT bit-identical"),
    (_unbounded, "rss grew 9x"),
    (_no_lifecycle, "seal/retire/scrub never ran"),
    (_lost_segment, "quarantined without rebuild"),
    (_table_over_budget, "over the"),
    (_table_unobserved, "table_kb not recorded"),
    (_broken_trace, "span chain incomplete"),
    (_not_replayable, "not replayable"),
    (_wrong_version, "schema version"),
    (_no_retune, "live-retune leg never ran"),
    (_retune_not_applied, "never moved"),
    (_retune_commitless_journal, "commit last"),
    (_retune_goodput_regressed, "regressed across the retune"),
    (_site_tag_mismatch, "dump tagged"),
]


@pytest.mark.parametrize("mutate,needle", DOCTORED, ids=[m.__name__.strip("_")
                                                         for m, _ in DOCTORED])
def test_check_report_equals_the_reference(smoke, mutate, needle):
    payload, _ = smoke
    p = copy.deepcopy(payload)
    mutate(p)
    for verify in (True, False):
        mine = PS.check_report(copy.deepcopy(p), verify_postmortems=verify)
        assert mine == JS.check_report(copy.deepcopy(p), verify_postmortems=verify)
        if needle is None:
            assert mine == []
        elif verify or needle != "dump tagged":
            assert any(needle in v for v in mine), (needle, mine)
        else:
            assert mine == []  # the site tag is checked against the dump on disk only


# ------------------------------------------------------------ the CLI
def _reference_main():
    spec = importlib.util.spec_from_file_location(
        "reference_soak_cli", os.path.join(REPO, "tools", "soak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.mark.parametrize("kind", ["clean", "tampered", "doctored", "missing", "moved"])
def test_cli_check_answers_as_the_reference(smoke, kind, tmp_path, monkeypatch, capsys):
    payload, path = smoke
    target = str(tmp_path / "report.json")
    if kind == "clean":
        target = path
    elif kind == "tampered":
        with open(path, "rb") as f:
            data = bytearray(f.read())
        i = data.index(b'"wall_s":') + len(b'"wall_s":')
        data[i] = ord("9") if data[i] != ord("9") else ord("8")
        with open(target, "wb") as f:
            f.write(bytes(data))
    elif kind == "doctored":
        p = copy.deepcopy(payload)
        _unanswered(p)
        _broken_trace(p)
        PS.write_report(p, target)
    elif kind == "moved":
        # a report whose postmortems are not on this host: in-payload checks only
        p = copy.deepcopy(payload)
        for k in p["kills"]:
            for pm in k["postmortems"]:
                pm["path"] = "/nonexistent/" + os.path.basename(pm["path"] or "x")
        PS.write_report(p, target)
    ref_main = _reference_main()
    monkeypatch.setattr(sys, "argv", ["soak.py", "--check", target])
    want_rc = ref_main()
    want = capsys.readouterr().out
    got_rc = port_main(["--check", target])
    got = capsys.readouterr().out
    assert (got_rc, got) == (want_rc, want)
    assert got_rc == {"clean": 0, "tampered": 2, "doctored": 1, "missing": 2, "moved": 0}[kind]
    last = [ln for ln in got.splitlines() if ln.startswith(("PASS", "FAIL"))][0]
    assert last.startswith("PASS" if got_rc == 0 else "FAIL")


def test_cli_run_defaults_to_the_card_and_raises_without_one(tmp_path, monkeypatch):
    """With no ``--device`` the CLI's run mode raises before it writes a
    thing when no card is present."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["--workdir", str(tmp_path / "none")])
    assert not (tmp_path / "none" / "soak_report.json").exists()


# ------------------------------------------------------------ the full day
@pytest.mark.slow
def test_full_day_soak_clean(tmp_path):
    payload, _ = PS.run_soak(PSC.full_config(), str(tmp_path), device=CPU)
    assert PS.check_report(payload) == []
    assert JS.check_report(payload) == []
    assert len(payload["phases"]) == 4
