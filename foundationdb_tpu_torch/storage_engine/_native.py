"""Build and load the native durable tier: the DiskQueue and the ssd
engine's B+tree (native/diskqueue.cpp, native/btree_kvs.cpp and
native/crc32c.cpp, the repo's C++ layer, read in place); and the C wire
client (native/fdb_c_client.cpp, the bindings/c counterpart), which
speaks the transport's protocol to a served cluster or a txn host with
no Python on its side of the socket.

The port's counterpart of foundationdb_tpu/storage_engine/_native.py,
which runs `make -C native` at import. Here the sources compile with g++
into one shared library under build/native/ (at the checkout root, listed
in .gitignore), at first use (the first DiskQueue or KeyValueStoreSSD that
needs it, never at import), keyed by a hash of the sources and the flags,
as _build.py does for the CUDA kernels. A failed build raises with g++'s
stderr; nothing falls back to the Python twin. The C client builds the
same way into its own library, libfdbtpu_c-<hash>.so, at the first
`load_c_client()`.
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
C_CLIENT_SOURCES = [_ROOT / "native" / "fdb_c_client.cpp"]
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_c_client: Optional[ctypes.CDLL] = None


def _lib_path(stem: str, sources) -> Path:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def _compile(out: Path, sources, what: str) -> Path:
    """Compile `sources` into `out` unless it exists; returns `out`."""
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: the {what} needs it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    p = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                        *map(str, sources)],
                       capture_output=True, text=True, timeout=600)
    if p.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{what} build failed (g++ exit {p.returncode}):\n{p.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
    return out


def lib_path() -> Path:
    return _lib_path("libfdbtpu_durable", SOURCES)


def build() -> Path:
    """Compile the library if it is not built yet; returns its path."""
    return _compile(lib_path(), SOURCES, "native durable tier "
                    "(native/diskqueue.cpp, btree_kvs.cpp)")


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def c_client_path() -> Path:
    return _lib_path("libfdbtpu_c", C_CLIENT_SOURCES)


def load_c_client() -> ctypes.CDLL:
    """The C wire client, built first if needed, with its C ABI declared
    (a pointer argument left undeclared would be truncated to an int)."""
    global _c_client
    if _c_client is not None:
        return _c_client
    lib = ctypes.CDLL(str(_compile(c_client_path(), C_CLIENT_SOURCES,
                                   "C wire client (native/fdb_c_client.cpp)")))
    c = ctypes
    kv = [c.c_void_p, c.c_char_p, c.c_uint32, c.c_char_p, c.c_uint32]
    for name, res, args in (
        ("fdbc_connect", c.c_void_p, [c.c_char_p, c.c_int]),
        ("fdbc_destroy", None, [c.c_void_p]),
        ("fdbc_last_error", c.c_int, [c.c_void_p]),
        ("fdbc_get_read_version", c.c_int64, [c.c_void_p]),
        ("fdbc_get", c.c_int, [c.c_void_p, c.c_char_p, c.c_uint32,
                               c.c_int64, c.POINTER(c.c_void_p),
                               c.POINTER(c.c_uint32)]),
        ("fdbc_tr_set", None, kv),
        ("fdbc_tr_clear_range", None, kv),
        ("fdbc_commit", c.c_int64, [c.c_void_p, c.c_int64, c.c_char_p,
                                    c.c_uint32]),
    ):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    _c_client = lib
    return lib
