#!/usr/bin/env python3
"""Time builds of K2's CUDA source that differ by compiler flags or text
edits, over rows a thread, on one NVIDIA H100.

    python3 k2_variants.py [VARIANTS.json] [--candidates] [--sass] [--reps 20]

The package's ``csrc/lloyd.cu`` as it is (``kernel``) is always built.
``--candidates`` adds the loop changes in ``CANDIDATES``, each a text edit
of that source that keeps K2's bits: the compiler's own register choice
(``lb0``), explicit unrolling of the center loop (``unroll2``,
``unroll4``), eight rows a thread at DP <= 8 (``r8``), the update written
as selects (``sel``), with a pointer walked over the centers
(``sel_ptr``), and every R at every width (``wide_rows``, to read the
registers and spills ``ptxas`` gives R above ``assign_rows_max``).
``VARIANTS.json`` maps a name to ``{"flags": [...], "edits": [[old, new],
...], "source": path, "rows": [1, 2, 4, ...]}`` (all keys optional;
``source`` defaults to the package's ``csrc/lloyd.cu``, ``rows`` to 1, 2
and 4).  A build must keep the C interface of ``lloyd_assign_occupancy``
and ``lloyd_assign_launch``; rows a thread that a build does not take at a
width are skipped.  Each variant is built with ``nvcc`` beside the others,
all started together, and its ``ptxas`` registers and spills are printed.

At each shape every (variant, rows) run launches through the C interface
directly (a precomputed grid: one wave of the build's own resident count,
no more blocks than row tiles), so the times are the card's, not the
wrapper's.  A variant whose name does not start with ``x`` must give the
bits of ``kernel`` at one row a thread; an ``x`` variant is a timing-only
cut and may be wrong.  The runs are timed in turns (each run, then each in
reverse order; ``gpu_ms`` of ``--reps`` launches), while ``nvidia-smi``
samples the SM clock and power draw; the script prints one JSON line per
run: the variant, rows, blocks, resident blocks an SM, the two times,
their mean, the median SM clock over the shape (NaN where the shape's
runs ended before the sampler's first reading), and the scheduler cycles
per warp and (row, center) pair that the mean and that clock give.
``--sass`` also prints, for each build and each ``assign_kernel<DP, R>``
at DP <= 32, the instructions of the loop over the staged centers
(``cuobjdump -sass``: the loop holding the center's ``LDS.128``), by
opcode.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

_LOOP = "  for (int c = 0; c < kh; ++c) {\n    float cross[R];"
_UPDATE = "      if (d2 < best[r]) {\n        best[r] = d2;\n        arg[r] = c0 + c;\n      }"
_SELECT = ("      const bool lt = d2 < best[r];\n      best[r] = lt ? d2 : best[r];\n"
           "      arg[r] = lt ? c0 + c : arg[r];")
_CENTER = "      const float4 v = cs4[c * (DP / 4) + q];\n#pragma unroll\n      for (int r"
_BOUNDS = "__launch_bounds__(kThreads, R > 1 ? 2 : 0)"
_RMAX = "constexpr int assign_rows_max(int dp) { return dp <= 16 ? 4 : dp <= 32 ? 2 : 1; }"
_R4 = "  if constexpr (assign_rows_max(DP) >= 4)\n    if (rows == 4) return assign_kernel<DP, 4>;"
_R8 = _R4 + "\n  if constexpr (assign_rows_max(DP) >= 8)\n    if (rows == 8) return assign_kernel<DP, 8>;"
_SEL = [[_UPDATE, _SELECT]]
CANDIDATES = {
    "lb0": {"edits": [[_BOUNDS, "__launch_bounds__(kThreads)"]], "rows": [2, 4]},
    "unroll2": {"edits": [[_LOOP, "#pragma unroll 2\n" + _LOOP]], "rows": [4]},
    "unroll4": {"edits": [[_LOOP, "#pragma unroll 4\n" + _LOOP]], "rows": [4]},
    "r8": {"edits": [[_RMAX, _RMAX.replace("return dp <= 16", "return dp <= 8 ? 8 : dp <= 16")],
                     [_R4, _R8]], "rows": [8]},
    "sel": {"edits": _SEL, "rows": [2, 4]},
    "sel_ptr": {"edits": _SEL + [
        [_LOOP, "  const float4* p4 = cs4;\n  for (int c = 0; c < kh; ++c, p4 += DP / 4) {\n"
                "    float cross[R];"],
        [_CENTER, _CENTER.replace("cs4[c * (DP / 4) + q]", "p4[q]")]], "rows": [2, 4]},
    "wide_rows": {"edits": [[_RMAX, "constexpr int assign_rows_max(int dp) { return dp <= 8 ? 8 : 4; }"],
                            [_R4, _R8], [_BOUNDS, "__launch_bounds__(kThreads)"]],
                  "rows": [4]},
}

SHAPES = [  # (tag, n, d, k, invalid centers)
    ("predict, n=10M", 10_000_000, 8, 256, 0),
    ("bulk_score chunk", 262_144, 8, 256, 0),
    ("k=16", 1_000_003, 8, 16, 3),
    ("half the centers invalid", 2_000_000, 8, 256, 128),
    ("d=16", 2_000_000, 16, 256, 0),
    ("d=32", 2_000_000, 32, 256, 0),
    ("d=16, center tiles", 1_000_000, 16, 2048, 0),
]


def build(variants: dict, out: Path, _build) -> dict:
    texts = {}
    for name, v in variants.items():  # every edit checked before any build starts
        text = Path(v.get("source") or _build.CSRC / "lloyd.cu").read_text()
        for a, b in v.get("edits", []):
            cs.check(a in text, f"variant {name}: edit target not in the source: {a!r}")
            text = text.replace(a, b)
        texts[name] = text
    procs = {}
    for name, v in variants.items():
        src, lib = out / f"{name}.cu", out / f"lib{name}.so"
        src.write_text(texts[name])
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, *v.get("flags", []), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        cs.check(proc.returncode == 0, f"variant {name} did not build:\n{log[-3000:]}")
        for fn, usage in cs.ptxas_usage(log):
            if fn.startswith("assign_kernel"):
                cs.say(f"  ptxas[{name}] {fn}: {usage}")
        L = ctypes.CDLL(str(lib))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        L.lloyd_assign_occupancy.argtypes = [i, i, i, ctypes.POINTER(i)]
        L.lloyd_assign_occupancy.restype = i
        L.lloyd_assign_launch.argtypes = [p, p, p, ll, i, i, i, i, i, p, p, p]
        L.lloyd_assign_launch.restype = i
        libs[name] = (L, lib)
    return libs


def loop_mix(sass: str) -> list[dict]:
    """The center loop of each ``assign_kernel<DP, R>`` (DP <= 32) in a
    ``cuobjdump -sass`` listing: the first backward branch after the
    kernel's first ``LDS.128`` and the instructions from its target on."""
    out = []
    for fn in re.split(r"\n\s*Function : ", sass):
        m = re.search(r"assign_kernelILi(\d+)ELi(\d+)E", fn.split("\n", 1)[0])
        if not m or int(m.group(1)) > 32:
            continue
        code = [(int(a, 16), b.strip()) for a, b in
                re.findall(r"/\*([0-9a-f]{4})\*/\s*(.*?);", fn)]
        first = next((i for i, (_, op) in enumerate(code) if "LDS.128" in op), None)
        if first is None:
            continue
        for addr, op in code[first:]:
            br = re.search(r"BRA (0x[0-9a-f]+)", op)
            if br and int(br.group(1), 16) < addr:
                body = [o for a, o in code if int(br.group(1), 16) <= a <= addr]
                ops: dict[str, int] = {}
                for o in body:
                    name = re.sub(r"^@!?U?P\w+\s+", "", o).split()[0]
                    ops[name] = ops.get(name, 0) + 1
                out.append({"DP": int(m.group(1)), "R": int(m.group(2)),
                            "loop_instructions": len(body),
                            "ops": dict(sorted(ops.items(), key=lambda kv: -kv[1]))})
                break
    return out


class Clocks:
    """``nvidia-smi`` sampling the SM clock (MHz) and power draw (W) every
    50 ms while the context is open."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
             "-lms", "50"], stdout=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        text = self.proc.communicate()[0]
        rows = [line.split(",") for line in text.splitlines() if line.count(",") == 1]
        self.mhz = statistics.median(float(a) for a, _ in rows) if rows else float("nan")
        self.watts = statistics.median(float(b) for _, b in rows) if rows else float("nan")


def main() -> None:
    import torch

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import _build
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import lloyd as L

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", type=Path, nargs="?")
    ap.add_argument("--candidates", action="store_true", help="add CANDIDATES")
    ap.add_argument("--sass", action="store_true", help="print each center loop's instructions")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    variants = {"kernel": {}}
    if args.candidates:
        variants.update(CANDIDATES)
    if args.variants:
        variants.update(json.loads(args.variants.read_text()))
    out = _build.build_dir() / "k2_variants"
    out.mkdir(parents=True, exist_ok=True)
    libs = build(variants, out, _build)
    if args.sass:
        cuobjdump = str(Path(_build.nvcc()).with_name("cuobjdump"))
        for name, (_, path) in libs.items():
            sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True,
                                  text=True).stdout
            for rec in loop_mix(sass):
                cs.say(json.dumps({"variant": name, **rec}))
    libs = {name: lib for name, (lib, _) in libs.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    cs.say(smi.stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream

    for i, (tag, n, d, k, n_invalid) in enumerate(SHAPES):
        g = torch.Generator(device="cuda").manual_seed(80 + i)
        centers = torch.randn(k, d, device="cuda", generator=g) * 3.0
        x = (centers[torch.randint(0, k, (n,), device="cuda", generator=g)]
             + torch.randn(n, d, device="cuda", generator=g)).contiguous()
        c_valid = torch.ones(k, device="cuda")
        if n_invalid:
            c_valid[-n_invalid:] = 0.0
        geo = L._assign_geometry(d, k)
        a = torch.empty((n,), dtype=torch.int32, device="cuda")
        m = torch.empty((n,), dtype=torch.float32, device="cuda")

        def launcher(lib, rows, blocks):
            args = (x.data_ptr(), centers.data_ptr(), c_valid.data_ptr(), n, d, k, rows,
                    geo["smem"], blocks, a.data_ptr(), m.data_ptr(), stream)

            def run():
                rc = lib.lloyd_assign_launch(*args)
                if rc:
                    cs.fail(f"launch failed: CUDA error {rc}")
            return run

        runs = []
        for name, v in variants.items():
            for rows in v.get("rows", [1, 2, 4]):
                per_sm = ctypes.c_int(0)
                if libs[name].lloyd_assign_occupancy(d, rows, geo["smem"],
                                                     ctypes.byref(per_sm)) or per_sm.value < 1:
                    continue
                blocks = max(1, min(-(-n // (256 * rows)), sms * per_sm.value))
                runs.append((name, rows, blocks, per_sm.value,
                             launcher(libs[name], rows, blocks)))
        ref = None
        for name, rows, _, _, run in runs:
            run()
            torch.cuda.synchronize()
            got = (a.clone(), m.view(torch.int32).clone())
            if ref is None:
                ref = got
            exact = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
            cs.check(exact or name.startswith("x"),
                     f"variant {name} at {rows} rows a thread differs from kernel at {tag}")
        times = {(r[0], r[1]): [] for r in runs}
        with Clocks() as clk:
            for name, rows, _, _, run in runs + runs[::-1]:
                times[(name, rows)].append(cs.gpu_ms(run, args.reps))
        warp_pairs = n * k / 32
        for name, rows, blocks, per_sm, _ in runs:
            t = times[(name, rows)]
            ms = sum(t) / len(t)
            cs.say(json.dumps({
                "shape": tag, "n": n, "d": d, "k": k, "variant": name, "rows": rows,
                "blocks": blocks, "per_sm": per_sm, "turns_ms": t, "ms": ms,
                "sm_mhz": clk.mhz, "power_w": clk.watts,
                "cycles_per_warp_pair": ms * 1e-3 * clk.mhz * 1e6 * 4 * sms / warp_pairs}))
        del x, a, m
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
