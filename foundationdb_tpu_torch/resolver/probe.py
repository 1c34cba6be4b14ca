"""Two-level rank probe of the block-sparse fast path.

The counterpart of foundationdb_tpu/resolver/pallas_probe.py: for every
endpoint column it gives (bid, lb_loc, eq_loc) — the block id (last fence
<= key), the halving walk's rank in that block, and equality at that rank
— exactly as gpu._fence_rank + gpu._block_probe do, for any column order
and any block contents.

On a CUDA tensor `probe_ranks` launches the hand-written kernel
csrc/probe.cu (built by _build.py) through `probe_ranks_into`, which
counts the launch in LAUNCHES; on a CPU tensor it runs `probe_ranks_ref`,
the plain torch version. The kernel takes a power-of-two B and any W1, NB
and P2: there is no size limit (no counterpart of pallas_probe.fits_vmem),
the operands stay in device memory.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = 0  # kernel launches since the caller last reset it

_c_ptr = ctypes.c_void_p


def probe_ranks_ref(hkeys, fences, smat, *, NB: int, B: int):
    """Plain torch version: gpu._fence_rank + gpu._block_probe."""
    from .gpu import _block_probe, _fence_rank

    bid = _fence_rank(fences, smat)
    start = bid.clamp(0, NB - 1) * B
    lb_loc, eq_loc = _block_probe(hkeys, smat, start, B)
    return bid, lb_loc, eq_loc


def _check(hkeys, fences, smat, NB: int, B: int) -> None:
    for name, t in (("hkeys", hkeys), ("fences", fences), ("smat", smat)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != smat.device:
            raise ValueError(f"{name} is on {t.device}, smat on {smat.device}")
    W1 = smat.shape[0]
    if tuple(fences.shape) != (W1, NB):
        raise ValueError(f"fences shape {tuple(fences.shape)} != {(W1, NB)}")
    if tuple(hkeys.shape) != (W1, NB * B):
        raise ValueError(
            f"hkeys shape {tuple(hkeys.shape)} != {(W1, NB * B)}"
        )


def _lib(build: str = "probe"):
    from .. import _build

    lib = _build.load(build)
    if not getattr(lib, "_fdb_typed", False):
        lib.fdb_probe_ranks.argtypes = [
            _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, _c_ptr,
        ]
        lib.fdb_probe_ranks.restype = ctypes.c_int
        lib.fdb_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fdb_cuda_error_string.restype = ctypes.c_char_p
        lib._fdb_typed = True
    return lib


def probe_ranks(hkeys, fences, smat, *, NB: int, B: int):
    """(bid, lb_loc, eq_loc), each (P2,) int32, of every query column of
    smat (W1, P2) against the fence directory fences (W1, NB) and the
    block key matrix hkeys (W1, NB*B)."""
    _check(hkeys, fences, smat, NB, B)
    if smat.device.type == "cpu":
        return probe_ranks_ref(hkeys, fences, smat, NB=NB, B=B)
    out = torch.empty((3, smat.shape[1]), dtype=torch.int32,
                      device=smat.device)
    probe_ranks_into(out, hkeys, fences, smat, NB=NB, B=B)
    return out[0], out[1], out[2]


def probe_ranks_into(out, hkeys, fences, smat, *, NB: int, B: int,
                     build: str = "probe") -> None:
    """Launch the kernel on CUDA tensors, writing (bid, lb_loc, eq_loc)
    into the rows of the caller's contiguous (3, P2) int32 tensor `out`.
    `build` names the _build source to launch: another source with the
    same C entry point, registered in _build.SOURCES, for comparison."""
    global LAUNCHES
    _check(hkeys, fences, smat, NB, B)
    if smat.device.type != "cuda":
        raise ValueError(f"the probe kernel needs CUDA tensors, got "
                         f"{smat.device}")
    if B < 1 or B & (B - 1):
        raise ValueError(f"the probe kernel takes a power-of-two B, got {B}")
    W1, P2 = smat.shape
    if (out.dtype != torch.int32 or tuple(out.shape) != (3, P2)
            or not out.is_contiguous() or out.device != smat.device):
        raise ValueError("out must be a contiguous (3, P2) int32 tensor on "
                         "the device of smat")
    lib = _lib(build)
    with torch.cuda.device(smat.device):
        stream = torch.cuda.current_stream(smat.device).cuda_stream
        rc = lib.fdb_probe_ranks(
            hkeys.data_ptr(), fences.data_ptr(), smat.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            W1, hkeys.shape[1], NB, B, P2, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"probe kernel launch failed: CUDA error {rc} "
            f"({lib.fdb_cuda_error_string(rc).decode()})"
        )
    LAUNCHES += 1
