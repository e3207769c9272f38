#!/usr/bin/env python3
"""Time builds of K3's CUDA source that differ by compiler flags or text
edits, over the trees a block, at the four main shapes, on one NVIDIA H100.

    python3 k3_variants.py [VARIANTS.json] [--cuts] [--tb 1,2,5,10] [--old OLD_tree_hist.cu]

``--cuts`` times the package's source as it is (``kernel``) beside three
timing-only cuts of it: ``xno_match`` (each lane its own group, no
``__match_any_sync``), ``xno_leader`` (no group sums or bin updates) and
``xno_grouping`` (no warp groups any pair: staging, prologue, barriers and
the output alone).  ``VARIANTS.json`` maps a name to ``{"flags": [...], "edits": [[old, new], ...],
"source": path}`` (all keys optional; ``source`` defaults to the package's
``csrc/tree_hist.cu``; a build must keep the package's shared-memory layout
and block size, since ``hist_plan`` sizes its launches).  Each variant is built with ``nvcc`` beside the others, all started
together; then for each shape and each TB the plan is ``hist_plan``'s with
that TB forced and the build's own occupancy, and the script prints one JSON
line per run: the variant, TB, warps, shared bytes, resident blocks an SM,
row blocks, waves, the mean of two ``gpu_ms`` readings of 10 launches, and
whether the integer-stat output equals the float64 plain version.  A variant
whose name does not start with ``x`` must be exact; an ``x`` variant is a
timing-only cut (a step of the kernel taken out) and may be wrong.  With
``--old`` the earlier one-tree-a-block kernel (``k3_versions.py``) is timed
first at each shape as ``OLD``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import k3_versions as kv  # noqa: E402

CUTS = {
    "kernel": {},
    "xno_match": {"edits": [[
        "peers[u] = key[u] >= 0 ? __match_any_sync(hits, key[u]) : 0u;",
        "peers[u] = key[u] >= 0 && hits ? 1u << lane : 0u;"]]},
    "xno_leader": {"edits": [[
        "if (key[u] < 0 || (peers[u] & below)) continue;",
        "if (key[u] < 0 || (peers[u] & below) || B > 0) continue;"]]},
    "xno_grouping": {"edits": [[
        "for (int pair = warp; pair < tbn * dtt; pair += nwarps) {",
        "for (int pair = warp; pair < tbn * dtt && B < 0; pair += nwarps) {"]]},
}


def main() -> None:
    import torch

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import _build
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import (
        tree_hist as H,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", type=Path, nargs="?")
    ap.add_argument("--cuts", action="store_true", help="the kernel and three timing cuts")
    ap.add_argument("--tb", default="1,2,5,10", help="trees a block to try")
    ap.add_argument("--old", type=Path, help="an earlier csrc/tree_hist.cu to time first")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    variants = dict(CUTS) if args.cuts else {}
    if args.variants:
        variants.update(json.loads(args.variants.read_text()))
    cs.check(bool(variants), "no variants: give VARIANTS.json or --cuts")
    out = _build.build_dir() / "k3_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, v in variants.items():
        text = Path(v.get("source") or _build.CSRC / "tree_hist.cu").read_text()
        for a, b in v.get("edits", []):
            cs.check(a in text, f"variant {name}: edit target not in the source: {a!r}")
            text = text.replace(a, b)
        src, lib = out / f"{name}.cu", out / f"lib{name}.so"
        src.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, *v.get("flags", []), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        cs.check(proc.returncode == 0, f"variant {name} did not build:\n{log[-3000:]}")
        for fn, usage in cs.ptxas_usage(log):
            cs.say(f"  ptxas[{name}] {fn}: {usage}")
        libs[name] = lib
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    cs.say(smi.stdout.strip())
    kv.H, kv._build = H, _build
    old = kv.build_old(args.old)[0] if args.old else None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    geometry, B = H._geometry, 32
    try:
        for i, (tag, n, d, S, T, LN) in enumerate(kv.MAIN):
            ins = cs.k3_inputs(n, d, S, T, LN, B, seed=10 + i)
            ref = H.fused_level_hist_plain(ins[0], ins[1].double(), ins[2].double(), ins[3],
                                           LN, B)
            if old is not None:
                op = kv.old_plan(n, d, S, B, LN, T, sms)
                ms = sum(cs.gpu_ms(lambda: kv.old_launch(old, op, *ins, LN, B), 10)
                         for _ in range(2)) / 2
                cs.say(json.dumps({"shape": tag, "variant": "OLD", "ms": ms}))
            for name, v in variants.items():
                H._LIB = None
                H._OCCUPANCY.clear()
                _build._LOADED["tree_hist"] = ctypes.CDLL(str(libs[name]))
                for tb in (int(x) for x in args.tb.split(",")):
                    if tb > T:
                        continue
                    g = geometry(d, S, B, LN, T)
                    groups = -(-T // tb)
                    tb = -(-T // groups)
                    rounds = -(-tb * g["dt"] // H.MAX_WARPS)
                    g.update(TB=tb, n_tgroups=groups, smem=H.smem_bytes(g["dt"], S, B, g["LNt"], tb),
                             warps=-(-tb * g["dt"] // rounds))
                    if g["smem"] > 227 * 1024:
                        continue
                    H._geometry = lambda *a, g=g: dict(g)
                    try:
                        per_sm = H.occupancy(torch.device("cuda"), d, S, B, LN, T)
                        if per_sm < 1:
                            continue
                        plan = H.hist_plan(n, d, S, B, LN, T, sms, per_sm)
                    finally:
                        H._geometry = geometry
                    run = lambda: H.fused_level_hist_planned(*ins, LN, B, plan)  # noqa: E731
                    exact = bool((run().double() == ref).all())
                    cs.check(exact or name.startswith("x"), f"variant {name} is wrong at {tag}")
                    ms = sum(cs.gpu_ms(run, 10) for _ in range(2)) / 2
                    cs.say(json.dumps({
                        "shape": tag, "variant": name, "TB": tb, "warps": plan["warps"],
                        "smem": plan["smem"], "per_sm": per_sm, "blocks_x": plan["blocks_x"],
                        "waves": plan["waves"], "ms": ms, "exact": exact}))
            del ins, ref
            torch.cuda.empty_cache()
    finally:
        H._LIB = None
        H._OCCUPANCY.clear()
        _build._LOADED.pop("tree_hist", None)


if __name__ == "__main__":
    main()
