"""Device time of a kernel call on a CUDA card, without the host's time.

An event pair around one call from Python also counts the wrapper's host
work before the launch whenever the device is idle, and a small kernel's
device time can be smaller than that host work. `device_ms` queues a spin
kernel first, so the device is still busy while the host enqueues the
calls, and divides one event pair over n back-to-back calls.
"""

from __future__ import annotations

import time

import numpy as np
import torch

_CYCLES_PER_MS: list[float] = []


def spin_cycles_per_ms() -> float:
    """Clock cycles per ms of torch.cuda._sleep, the device-side spin."""
    if not _CYCLES_PER_MS:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        a.record()
        torch.cuda._sleep(20_000_000)
        b.record()
        b.synchronize()
        _CYCLES_PER_MS.append(20_000_000 / a.elapsed_time(b))
    return _CYCLES_PER_MS[0]


def device_ms(fn, n: int = 1, reps: int = 9, flush=None) -> float:
    """Device ms per call of fn: the median over reps of one CUDA-event
    pair around n back-to-back calls, divided by n, with a spin kernel
    queued ahead of the pair for twice the host's enqueue time. flush, if
    given, runs before each rep, outside the pair (the cold reading, with
    n = 1)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int((2 * host_ms + 1.0) * spin_cycles_per_ms())
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def l2_flusher(device):
    """A callable that writes 256 MB (five times the H100's 50 MB L2), so
    that the next launch finds its operands in device memory."""
    buf = torch.empty(64 << 20, dtype=torch.int32, device=device)
    return lambda: buf.fill_(7)
