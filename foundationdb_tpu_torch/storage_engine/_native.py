"""Build and load the native layer, the repo's C++ sources under native/
read in place:

- the durable tier: the DiskQueue and the ssd engine's B+tree
  (native/diskqueue.cpp, native/btree_kvs.cpp and native/crc32c.cpp);
- the host tier: the C++ conflict detector, the endpoint radix sort of
  the resolver's packer (fdbcs_encode_sort_order) and the wire CRC32C
  (native/conflict_set.cpp and
  native/crc32c.cpp, `load_host()`, libfdbtpu_native-<hash>.so);
- the message envelope codec, a CPython extension (native/envelope.cpp,
  `load_envelope()`, fdbtpu_envelope-<hash>.so, compiled against this
  interpreter's headers);
- the C wire client (native/fdb_c_client.cpp, the bindings/c
  counterpart), which speaks the transport's protocol to a served
  cluster or a txn host with no Python on its side of the socket.

The port's counterpart of foundationdb_tpu/storage_engine/_native.py,
which runs `make -C native` at import. Here the sources compile with g++
into one shared library under build/native/ (at the checkout root, listed
in .gitignore), at first use (the first DiskQueue or KeyValueStoreSSD that
needs it, never at import), keyed by a hash of the sources and the flags,
as _build.py does for the CUDA kernels. A failed build raises with g++'s
stderr; nothing falls back to the Python twin. The host tier, the
envelope and the C client build the same way, each into a library of its
own at its first load. The files under native/ ending in .so are the JAX
package's `make` products and are never loaded here: the envelope keeps
its registries in C statics, so a file shared by both packages in one
process would hand one package's registries to the other.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import time
from pathlib import Path
from typing import Optional

_ROOT = Path(__file__).resolve().parents[2]
SOURCES = [_ROOT / "native" / name
           for name in ("diskqueue.cpp", "btree_kvs.cpp", "crc32c.cpp")]
HOST_SOURCES = [_ROOT / "native" / name
                for name in ("conflict_set.cpp", "crc32c.cpp")]
ENVELOPE_SOURCES = [_ROOT / "native" / "envelope.cpp"]
C_CLIENT_SOURCES = [_ROOT / "native" / "fdb_c_client.cpp"]
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]
# The envelope links against this interpreter's C API: its headers, and
# its version and ABI tag in the library's key.
PY_INCLUDE = sysconfig.get_paths()["include"]
ENVELOPE_FLAGS = [f"-I{PY_INCLUDE}"]
_PY_ABI = [sys.implementation.cache_tag, str(sysconfig.get_config_var("SOABI"))]

_lib: Optional[ctypes.CDLL] = None
_host: Optional[ctypes.CDLL] = None
_envelope = None
_c_client: Optional[ctypes.CDLL] = None


def _lib_path(stem: str, sources, key=()) -> Path:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.read_bytes())
    h.update(" ".join([*CXX_FLAGS, *key]).encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def _compile(out: Path, sources, what: str, extra=()) -> Path:
    """Compile `sources` into `out` unless it exists; returns `out`."""
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: the {what} needs it")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    p = subprocess.run([cxx, *CXX_FLAGS, *extra, "-o", str(tmp),
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


def host_path() -> Path:
    return _lib_path("libfdbtpu_native", HOST_SOURCES)


def load_host() -> ctypes.CDLL:
    """The host tier's library (conflict detector, endpoint sort, CRC32C),
    built first if needed, with its C ABI declared."""
    global _host
    if _host is not None:
        return _host
    lib = ctypes.CDLL(str(_compile(
        host_path(), HOST_SOURCES,
        "native host tier (native/conflict_set.cpp, crc32c.cpp)")))
    c = ctypes
    i64, i32, vp = c.c_int64, c.c_int32, c.c_void_p
    u8p, i64p, i32p = (c.POINTER(c.c_uint8), c.POINTER(c.c_int64),
                       c.POINTER(c.c_int32))
    u32p = c.POINTER(c.c_uint32)
    cols = [i32, i32p, i64p, i32p, i64p, i32p]  # count, txn, b off/len, e
    for name, res, args in (
        ("fdbcs_create", vp, [i64]),
        ("fdbcs_destroy", None, [vp]),
        ("fdbcs_entry_count", i64, [vp]),
        ("fdbcs_oldest", i64, [vp]),
        ("fdbcs_arena_size", i64, [vp]),
        ("fdbcs_entries", i64, [vp, u8p, i64p, i32p, i64p, i64]),
        ("fdbcs_resolve", c.c_int, [vp, i64, i64, i32, i64p, u8p, u8p,
                                    *cols, *cols, u8p]),
        ("fdbcs_encode_sort_order", i32, [i32p, i32, u32p, i32, i32p]),
        ("fdbtpu_crc32c", c.c_uint32, [c.c_char_p, c.c_size_t,
                                       c.c_uint32]),
    ):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    _host = lib
    return lib


def envelope_path() -> Path:
    return _lib_path("fdbtpu_envelope", ENVELOPE_SOURCES,
                     [*ENVELOPE_FLAGS, *_PY_ABI])


def load_envelope():
    """The envelope codec module (native/envelope.cpp), built first if
    needed. Its file is the port's own, under build/native/: the module
    keeps the registries that `setup()` hands it in C statics."""
    global _envelope
    if _envelope is not None:
        return _envelope
    import importlib.util

    path = _compile(envelope_path(), ENVELOPE_SOURCES,
                    "message envelope codec (native/envelope.cpp)",
                    ENVELOPE_FLAGS)
    # The init symbol (PyInit_fdbtpu_envelope) follows the spec's name,
    # not the file's.
    spec = importlib.util.spec_from_file_location("fdbtpu_envelope",
                                                  str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _envelope = mod
    return mod


def build_host_tier() -> dict[str, float]:
    """Build the host tier's library and the envelope if they are not
    built yet, the two g++ runs side by side; returns the seconds each
    library's build took this time (0.0: it was built already)."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(job) -> float:
        t0 = time.perf_counter()
        _compile(*job)
        return time.perf_counter() - t0

    jobs = {"libfdbtpu_native": (host_path(), HOST_SOURCES,
                                 "native host tier"),
            "fdbtpu_envelope": (envelope_path(), ENVELOPE_SOURCES,
                                "message envelope codec", ENVELOPE_FLAGS)}
    todo = {k: v for k, v in jobs.items() if not v[0].exists()}
    with ThreadPoolExecutor(max(len(todo), 1)) as ex:
        running = {k: ex.submit(timed, v) for k, v in todo.items()}
        return {k: running[k].result() if k in running else 0.0
                for k in jobs}


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
