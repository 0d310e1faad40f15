"""Build the package's CUDA kernels from `csrc/` at first use and load them.

Each source is compiled by `nvcc` into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds) and loaded with
ctypes. Libraries go to `instascene_tpu_torch/_build/` (listed in
.gitignore), named by a hash of the source and flags, so an unchanged
source is not rebuilt within one checkout. `build_all()` starts one `nvcc`
per source at once and waits for all of them.

Target: Hopper, `sm_90a`. `--fmad=false` keeps every multiply and add
separately rounded, as the plain PyTorch versions round them, so a kernel
and its plain version agree to the last bit where they sum in the same
order.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict = {}
BUILD_LOG: dict = {}      # source name -> nvcc/ptxas output of its build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU")


def _target(name: str) -> Path:
    """The library path of csrc/<name>, keyed by its source, the shared
    headers (csrc/*.cuh) and the flags."""
    src = CSRC / name
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> float:
    """Compile every listed source (default: all of csrc/*.cu) that has no
    up-to-date library yet, one nvcc each, all started together. Returns
    the wall seconds spent; raises with the compiler's output on failure."""
    names = names or sorted(p.name for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib
