"""Run (or verify) a compressed-production-day soak.

Usage:
    python -m clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.soak \\
        [--full] [--seed N] [--workdir DIR] [--report PATH] [--device DEV]
    python -m clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.soak \\
        --check PATH

The run mode replays the seeded diurnal day + chaos schedule
(``soak/driver.py``) on ``--device`` (default the card; ``cpu`` runs it
on the host) and exits non-zero unless the machine-checked
``SoakReport`` is violation-free.  ``--check`` re-reads an existing
report (CRC-verified) and re-runs every invariant check — host work,
no card needed, and what you run on a report that traveled from
another host (postmortem dump files are only re-verified when they
exist locally).  Exit codes: 0 clean, 1 violations, 2 unreadable
report.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--full", action="store_true",
                    help="the long soak (slow; default is the smoke shape)")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the config seed (replay a failed run)")
    ap.add_argument("--workdir", default=None,
                    help="run directory (default: a fresh temp dir)")
    ap.add_argument("--report", default=None,
                    help="where to write the SoakReport JSON")
    ap.add_argument("--check", metavar="PATH", default=None,
                    help="verify an existing report instead of running")
    ap.add_argument("--device", default=None,
                    help="where the day runs (default the card; 'cpu' "
                         "runs it on the host)")
    args = ap.parse_args(argv)

    from . import SMOKE_CONFIG, check_report, read_report, run_soak

    if args.check:
        try:
            payload = read_report(args.check)
        except (OSError, ValueError) as e:
            print(f"FAIL: report unreadable: {e}")
            return 2
        print(f"report {args.check}: crc32c intact, seed={payload.get('seed')}")
        violations = check_report(
            payload,
            verify_postmortems=_postmortems_present(payload),
        )
        return _verdict(payload, violations)

    if args.full:
        from .schedule import full_config

        cfg = full_config()
    else:
        cfg = SMOKE_CONFIG
    if args.seed is not None:
        from dataclasses import replace

        cfg = replace(cfg, seed=args.seed)

    workdir = args.workdir or tempfile.mkdtemp(prefix="soak-")
    print(f"soak: seed={cfg.seed} phases={[p.name for p in cfg.phases]} "
          f"workdir={workdir}")
    payload, path = run_soak(
        cfg, workdir, report_path=args.report, device=args.device
    )
    print(f"soak: report written to {path}")
    violations = check_report(payload)
    return _verdict(payload, violations)


def _postmortems_present(payload: dict) -> bool:
    """Dump files only re-verify when at least one exists locally."""
    for k in payload.get("kills", []):
        for pm in k.get("postmortems", []):
            if pm.get("path") and os.path.exists(pm["path"]):
                return True
    return False


def _verdict(payload: dict, violations: list) -> int:
    phases = payload.get("phases", [])
    kills = payload.get("kills", [])
    print(json.dumps({
        "phases": {
            p["name"]: {
                "goodput_frac": p.get("goodput_frac"),
                "unanswered": p.get("unanswered"),
            } for p in phases
        },
        "chaos_events": len(kills),
        "recovered": sum(1 for k in kills if k.get("recovered")),
        "double_kills": payload.get("double_kills"),
        "unhandled": len(payload.get("unhandled", [])),
        "resources_bounded": payload.get("resources", {}).get("bounded"),
        "trace_spans": payload.get("trace", {}).get("span_names"),
    }, indent=2))
    if violations:
        print(f"FAIL: {len(violations)} invariant violation(s):")
        for v in violations:
            print(f"  - {v}")
        return 1
    print("PASS: every soak invariant machine-checked clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
