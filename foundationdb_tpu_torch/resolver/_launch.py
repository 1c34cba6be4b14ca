"""What the wrappers of the hand-written kernels in csrc/block.cu and
csrc/compact.cu share (the Python side of csrc/grid.cuh): the operand
checks, a stage stamp buffer's pointer, the ctypes typing of a kernel
library's C entry points, and one launching entry point's call on the caller's stream with its error raised
and its launch counted.
"""

from __future__ import annotations

import torch

I32 = torch.int32


def check_operands(ts: dict, dev, flags=()) -> None:
    """Raise on an operand the kernels do not take: int32 (bool for the
    operands named in flags), contiguous, on one device."""
    for name, t in ts.items():
        want = torch.bool if name in flags else I32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")


def check_shapes(ts: dict, want: dict) -> None:
    for name, shape in want.items():
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        if tuple(ts[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(ts[name].shape)}, "
                             f"{shape} expected")


def cuda_device(t: torch.Tensor, kernel: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the {kernel} kernel needs CUDA tensors, got "
                         f"{t.device}")
    return t.device


def stamp_ptr(stamps, n_stages: int, dev) -> int | None:
    """A stage stamp buffer's pointer (None: no stamps): int64
    (n_stages + 1,) on dev (csrc/grid.cuh Stamps: stage k runs from stamp
    k to stamp k + 1)."""
    if stamps is None:
        return None
    if stamps.dtype != torch.int64 or tuple(stamps.shape) != (
            n_stages + 1,) or stamps.device != dev:
        raise ValueError(f"stamps must be int64 ({n_stages + 1},) on {dev}")
    return stamps.data_ptr()


def typed_lib(name: str, entry_points: dict):
    """The loaded library of csrc/<name>.cu (built first if needed), its
    entry points typed for ctypes (entry_points: name -> (restype,
    argtypes))."""
    from .. import _build

    lib = _build.load(name)
    if not getattr(lib, "_fdb_typed", False):
        for fname, (restype, argtypes) in entry_points.items():
            fn = getattr(lib, fname)
            fn.restype, fn.argtypes = restype, argtypes
        lib._fdb_typed = True
    return lib


def run_entry(lib, entry: str, dev, kernel: str, launches: dict, *args,
              shapes: str) -> None:
    """Call one launching entry point on dev's current stream; raise with
    the CUDA error where it returns one, else count the launch in
    launches[kernel]."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(
            f"{kernel} kernel launch failed on {dev} ({shapes}): CUDA error "
            f"{rc} ({lib.fdb_cuda_error_string(rc).decode()})")
    launches[kernel] += 1
