"""Root entry points of the PyTorch/CUDA port (foundationdb_tpu_torch).

- entry(device=None): the flagship computation, batched OCC conflict
  detection (replacing fdbserver/SkipList.cpp:1163 detectConflicts), as
  the dense resolve step gpu._resolve_kernel_impl plus example args on a
  tiny ConflictSetGPU.
- dryrun_multichip(n, device=None): one n-shard ShardedConflictSetGPU,
  shard s on card s % (cards on the machine), three sharded resolve
  steps (per-shard kernels and the copy+amax verdict merge: BASELINE
  config 4's multi-resolver key-space partitioning) on tiny shapes,
  checked against the sharded CPU oracle.

Without a card both raise unless the caller passes device="cpu".

    python3 __graft_entry_torch__.py    # entry() on the card, then
                                        # dryrun_multichip(8)
"""

from __future__ import annotations

import struct


def _k8(x: int) -> bytes:
    return struct.pack(">Q", int(x))


def _tiny_txns(seed: int, n_txns: int, version: int, key_space: int = 256):
    import numpy as np

    from foundationdb_tpu_torch.kv.keys import KeyRange
    from foundationdb_tpu_torch.resolver.types import TxnConflictInfo

    rng = np.random.default_rng(seed)
    txns = []
    for _ in range(n_txns):
        rr = [
            KeyRange(_k8(a), _k8(a + int(rng.integers(1, 9))))
            for a in map(int, rng.integers(0, key_space, rng.integers(1, 4)))
        ]
        wr = [
            KeyRange(_k8(a), _k8(a + 1))
            for a in map(int, rng.integers(0, key_space, rng.integers(0, 3)))
        ]
        txns.append(
            TxnConflictInfo(version - int(rng.integers(0, 50)), rr, wr)
        )
    return txns


def entry(device=None):
    """(fn, example_args) for the flagship resolve step: fn(*args) returns
    (hmat_out, new_n, st_aux) on the args' device."""
    from functools import partial

    from foundationdb_tpu_torch.resolver import gpu
    from foundationdb_tpu_torch.resolver.packing import pack_batch

    cs = gpu.ConflictSetGPU(max_key_bytes=8, initial_capacity=64,
                            device=device)
    txns = _tiny_txns(seed=1, n_txns=16, version=100)
    pb = pack_batch(txns, 0, cs.n_words)
    pb.set_scalars(100, 0)
    fn = partial(gpu._resolve_kernel_impl, lay=pb.layout)
    return fn, (cs.hmat, cs.n, gpu.to_device(pb.buf, cs.device))


def dryrun_multichip(n_devices: int, device=None) -> list[list[int]]:
    """Three sharded resolve steps over n_devices shards on tiny shapes,
    each step's statuses equal to ShardedConflictSetCPU's. Shard s goes on
    cuda:{s % device_count} (device=None) or every shard on `device`.
    Runs in the calling process; returns each step's statuses."""
    from collections import Counter

    import torch

    from foundationdb_tpu_torch.device import resolve_device
    from foundationdb_tpu_torch.resolver.sharded import (
        ShardedConflictSetCPU,
        ShardedConflictSetGPU,
    )

    if device is None:
        resolve_device(None)  # raises without a card
        count = torch.cuda.device_count()
        devices = [f"cuda:{s % count}" for s in range(n_devices)]
    else:
        devices = [device] * n_devices

    key_space = 256
    bounds = [
        _k8(key_space * (i + 1) // n_devices) for i in range(n_devices - 1)
    ]
    gpu_set = ShardedConflictSetGPU(
        bounds, max_key_bytes=8, initial_capacity=64, devices=devices
    )
    oracle = ShardedConflictSetCPU(bounds)

    version, steps = 100, []
    for step in range(3):  # insert, conflict-heavy, GC-advancing steps
        txns = _tiny_txns(seed=10 + step, n_txns=24, version=version)
        new_oldest = max(0, version - 120)
        got = gpu_set.resolve(version, new_oldest, txns).statuses
        want = oracle.resolve(version, new_oldest, txns).statuses
        if got != want:
            raise AssertionError(
                f"step {step}: sharded statuses diverge from the oracle:\n"
                f"  port   {got}\n  oracle {want}"
            )
        steps.append(got)
        version += 60
    per_device = Counter(str(d) for d in gpu_set.devices)
    print(f"dryrun_multichip: {n_devices} shards ok, shards per device "
          f"{dict(per_device)}")
    return steps


if __name__ == "__main__":
    import torch

    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print(f"entry(): run OK on {torch.cuda.get_device_name(0)} "
          f"(outputs {[tuple(o.shape) for o in out]})")
    dryrun_multichip(8)
    print("dryrun_multichip(8): OK")
