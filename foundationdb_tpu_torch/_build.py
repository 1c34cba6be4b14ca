"""Build and load the port's hand-written CUDA kernels.

Each source under csrc/ has a plain C interface and compiles with nvcc
into its own shared library under build/kernels/ (at the checkout root,
listed in .gitignore), at first use, keyed by a hash of the source, the
shared headers (csrc/*.cuh) and the flags. Libraries load with ctypes. A
failed build raises with nvcc's stderr; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = {"probe": _PKG / "csrc" / "probe.cu",
           "phase2": _PKG / "csrc" / "phase2.cu",
           "block": _PKG / "csrc" / "block.cu",
           "compact": _PKG / "csrc" / "compact.cu",
           "read": _PKG / "csrc" / "read.cu",
           "rankfed": _PKG / "csrc" / "rankfed.cu"}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

BUILD_LOG: dict[str, str] = {}   # name -> nvcc/ptxas output of its build
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


def lib_path(name: str) -> Path:
    """The library of one source, keyed by the source, the headers of
    csrc/ it may include, and the flags."""
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted((_PKG / "csrc").glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> float:
    """Compile every named source that has no library yet, one nvcc each,
    all started together. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    todo = [n for n in (names or list(SOURCES)) if not lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        out = lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ), tmp, out)
    failed = []
    for n, (p, tmp, out) in procs.items():
        so, se = p.communicate()
        BUILD_LOG[n] = so + se
        if p.returncode != 0:
            failed.append(f"{SOURCES[n].name}: nvcc exit {p.returncode}\n{se}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def ptxas_summary(log: str) -> str:
    """One entry per compiled kernel in nvcc's -Xptxas=-v output: its
    template argument (or name), registers and spill bytes."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            t = re.search(r"ILi(\d+)E", m.group(1))
            name = f"<{t.group(1)}>" if t else m.group(1)
            spill = "?"
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name} {m.group(1)} regs {spill} B spill")
            name = None
    return "; ".join(out)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return lib
