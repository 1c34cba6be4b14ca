"""Build and load the native durable tier: the DiskQueue and the ssd
engine's B+tree (native/diskqueue.cpp, native/btree_kvs.cpp and
native/crc32c.cpp, the repo's C++ layer, read in place).

The port's counterpart of foundationdb_tpu/storage_engine/_native.py,
which runs `make -C native` at import. Here the sources compile with g++
into one shared library under build/native/ (at the checkout root, listed
in .gitignore), at first use (the first DiskQueue or KeyValueStoreSSD that
needs it, never at import), keyed by a hash of the sources and the flags,
as _build.py does for the CUDA kernels. A failed build raises with g++'s
stderr; nothing falls back to the Python twin.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

_ROOT = Path(__file__).resolve().parents[2]
SOURCES = [_ROOT / "native" / name
           for name in ("diskqueue.cpp", "btree_kvs.cpp", "crc32c.cpp")]
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None


def lib_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libfdbtpu_durable-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path."""
    out = lib_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native durable tier "
                           "(native/diskqueue.cpp, btree_kvs.cpp) needs it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    p = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                        *map(str, SOURCES)],
                       capture_output=True, text=True, timeout=600)
    if p.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native durable tier build failed (g++ exit {p.returncode}):\n"
            f"{p.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib
