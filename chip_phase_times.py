"""Host seconds of each phase of a checkout's ``chip_smoke.py``, to compare
two commits on one card.

    python3 chip_phase_times.py <checkout dir> <tag>

runs ``chip_smoke.main()`` of the checkout in ``<checkout dir>`` with each
phase function wrapped in a host-clock timer and prints, after the
script's own output, one line ``PHASE_TIMES {...}``: the tag, the script's
exit code, its total seconds and each phase's.  One process a run: the
checkout's package is imported from its own directory.  To
compare a parent with a change, unpack the parent (``git archive``) into a
git-ignored directory and run, in one call to the card, parent, change,
change, parent::

    for t in parent1 change1 change2 parent2; do
      d=.verify_tmp/parent; case $t in change*) d=.;; esac
      python3 chip_phase_times.py $d $t; done
"""
import functools
import json
import os
import sys
import time

PHASES = ["kernel_case", "k2_case", "edge_cases", "k3_phase", "sql_window",
          "stage_on_bundled_csv", "stage_at_scale", "artifacts", "pipeline_phase", "rf20",
          "streaming_phase", "gmm_phase", "bisecting_phase", "outofcore_phase", "gbt_phase",
          "lr_phase", "precision_phase", "bisecting_more", "classification_phase",
          "families_phase", "features_phase", "beyond_phase", "history_phase",
          "front_door_phase"]


def main() -> None:
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    os.chdir(root)
    sys.path.insert(0, root)
    import chip_smoke as cs

    times: dict[str, float] = {}

    def timed(name, fn):
        @functools.wraps(fn)
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                times[name] = times.get(name, 0.0) + time.perf_counter() - t0
        return run

    for name in PHASES:
        if hasattr(cs, name):
            setattr(cs, name, timed(name, getattr(cs, name)))
    t0 = time.perf_counter()
    rc = 0
    try:
        cs.main()
    except SystemExit as e:
        rc = e.code
    result = {"tag": tag, "rc": rc, "total_s": round(time.perf_counter() - t0, 2),
              "phases": {k: round(v, 2) for k, v in times.items()}}
    print("PHASE_TIMES", json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
