"""Build the port's native sources at first use and load them with ctypes.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface — no PyTorch
headers, so a build takes seconds, not minutes.  The host CSV scan
(``native/csv_scan.cpp`` at the repository root, the one source both
packages parse with) is compiled by ``g++`` with the flags of
``native/Makefile``.  Libraries are cached in the build directory under a
name that hashes the source and the flags, so an edited source rebuilds
and an unchanged one loads straight away.

Nothing here runs at import: the CPU-only test machine imports every
module but has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"

#: name -> source file under csrc/
SOURCES = {"lloyd": "lloyd.cu", "tree_hist": "tree_hist.cu"}

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

#: name -> host C++ source (outside the package: shared with the JAX package)
HOST_SOURCES = {"csv_scan": _PKG.parent / "native" / "csv_scan.cpp"}

#: ``native/Makefile``'s flags
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """Where libraries land: ``CMLHN_TORCH_BUILD_DIR`` or ``_build/`` in
    the package (listed in ``.gitignore``)."""
    return Path(os.environ.get("CMLHN_TORCH_BUILD_DIR", _PKG / "_build"))


def nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's kernels are compiled "
        "from csrc/ at first use on a machine with the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    h = hashlib.sha256(src + "\0".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{h}.so"


def build(names=None) -> dict[str, Path]:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` per source, all started together.  Returns name -> path.
    Each compiler log (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside its library as ``<lib>.log``."""
    names = list(SOURCES) if names is None else list(names)
    out = {n: library_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        log = open(p.with_suffix(".log"), "w")
        procs[n] = (
            subprocess.Popen(
                [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])],
                stdout=log, stderr=subprocess.STDOUT,
            ),
            tmp, log,
        )
    failed = []
    for n, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out[n])
        else:
            failed.append(n)
    if failed:
        logs = "\n".join(
            out[n].with_suffix(".log").read_text()[-4000:] for n in failed
        )
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = _LOADED[name] = ctypes.CDLL(str(build([name])[name]))
        return lib


def host_library_path(name: str) -> Path:
    src = HOST_SOURCES[name].read_bytes()
    h = hashlib.sha256(src + "\0".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{h}.so"


def build_host(name: str) -> Path:
    """Compile the host library ``name`` with ``g++`` unless it is built
    already; the compiler's output is kept beside it as ``<lib>.log``.
    Raises ``RuntimeError`` (with that output) when the source or the
    compiler is missing or the build fails."""
    src = HOST_SOURCES[name]
    if not src.is_file():
        raise RuntimeError(f"{src} is missing: the host library {name} cannot be built")
    out = host_library_path(name)
    if out.exists():
        return out
    compiler = os.environ.get("CXX") or shutil.which("g++")
    if not compiler:
        raise RuntimeError(f"g++ not found: the host library {name} cannot be built")
    build_dir().mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        r = subprocess.run([compiler, *GXX_FLAGS, "-o", str(tmp), str(src)],
                           capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"g++ timed out building {name}") from e
    out.with_suffix(".log").write_text(r.stdout + r.stderr)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed for {name}:\n{(r.stdout + r.stderr)[-4000:]}")
    os.replace(tmp, out)
    return out
