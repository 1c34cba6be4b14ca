"""Multi-resolver key-space partitioning on one CUDA card (BASELINE config 4).

The torch counterpart of foundationdb_tpu/resolver/sharded.py. The
reference splits the key space across N resolver processes: the proxy's
ResolutionRequestBuilder clips each transaction's conflict ranges per
resolver (fdbserver/MasterProxyServer.actor.cpp:233-312) and a transaction
commits only if EVERY resolver reports it committed (phase-3 verdict merge,
:431-447). Each resolver merges the write ranges of transactions *it*
judged committed, so the conflict history may conservatively hold writes
of globally aborted transactions; the sharded oracle below reproduces that
exactly.

Per-txn status combine is max over shards: COMMITTED=0 < CONFLICT=1 <
TOO_OLD=2, so any-conflict aborts and any-too-old dominates.

`ShardedConflictSetGPU` holds the same block-sparse state per shard as
the JAX package's ShardedConflictSetTPU, each shard's on its own device
(`devices=`, one per shard, the counterpart of the 1-D `resolvers` mesh;
entries may repeat, so one card holds every shard):

  hmat[s]    (n_words+2, NB*B)  key words, key length, version offset
  counts[s]  (NB,)              live entries per block (<= B-1)
  fences[s]  (n_words+1, NB)    each block's minimum live key
  btree[s]   (2*NB,)            the shard's block-max segment tree
  n[s]       ()                 live entries of the shard (superset count)

What differs from the JAX package, and why:

- The per-device body of each shard_map step runs once per shard, on the
  shard's device: gpu._resolve_block_kernel_impl (the fast step, which
  updates hmat/counts/btree in place) or gpu._compact_resolve_impl (the
  compaction, whose fresh outputs replace the shard's tensors). The same
  loop runs whether the devices repeat or not.
- `lax.pmax` over the shard axis becomes a copy of every shard's st_aux
  to devices[0] and a signed int8 amax there: the merged bytes
  (statuses, the 4 LE bytes of n that the max mangles, overflow,
  phase-2 rounds) equal JAX's byte for byte, so last_p2_iters is the max
  over shards. Only the host reads the merged vector, so no collective is
  needed. Its D2H starts at dispatch behind a CUDA event; verdicts() is
  the designated sync.
- Shards on one device share one H2D of their fused buffers per batch,
  and one readback per compaction (_refresh_mirror).
- Block growth stays on the device (a pad block uploaded from pinned
  memory); only _refresh_mirror and _grow_width make a host read on the
  dispatch path. Each shard's phase 2 runs gpu.py's phase-2 kernel
  (resolver/phase2.py, csrc/phase2.cu), which reads nothing on the host,
  so each shard's step is enqueued on its device without waiting and
  shards on separate cards overlap. The handle's p2_syncs counts the
  reads of phase 2's plain version (CPU tensors only; 0 on the card).
- The state's device picks the probe (the CUDA kernel on the card, its
  plain version on the CPU); there is no probe knob.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import Sequence

import numpy as np
import torch

from ..core.knobs import CLIENT_KNOBS, SERVER_KNOBS
from ..device import on_device, resolve_device
from ..kv.keys import KeyRange
from . import gpu
from ._ops import I32
from .cpu import ConflictSetCPU
from .packing import (
    KeyWidthError,
    StickyCaps,
    empty_block_state,
    encode_packed_words,
    flatten_batch,
    next_bucket,
    next_pow2,
    pack_batch,
    pack_keys,
    state_pad_block,
    widen_state,
)
from .types import ConflictBatchResult, TxnConflictInfo


def shard_key_ranges(
    boundaries: Sequence[bytes],
) -> list[tuple[bytes, bytes | None]]:
    """[lo, hi) key range of each shard for the given split points; hi=None
    is +infinity. Single source of truth for both the CPU oracle and the
    device path so a partition tweak can never desynchronize the two."""
    out = []
    n = len(boundaries)
    for i in range(n + 1):
        lo = b"" if i == 0 else boundaries[i - 1]
        hi = boundaries[i] if i < n else None
        out.append((lo, hi))
    return out


def clip_txns_to_shard(
    txns: Sequence[TxnConflictInfo], lo: bytes, hi: bytes | None
) -> list[TxnConflictInfo]:
    """Clip every txn's conflict ranges to the shard range [lo, hi).

    hi=None means +infinity (the last shard). Mirrors the proxy-side range
    split (ResolutionRequestBuilder::addTransaction,
    fdbserver/MasterProxyServer.actor.cpp:245-258): a range is forwarded to
    every resolver it overlaps, clipped to that resolver's key range.
    """

    def clip(r: KeyRange) -> KeyRange | None:
        if r.begin >= lo and (hi is None or r.end <= hi):
            # inside the shard: the range itself (KeyRange is frozen)
            return r if r.begin < r.end else None
        b = max(r.begin, lo)
        e = r.end if hi is None else min(r.end, hi)
        if b >= e:
            return None
        return KeyRange(b, e)

    out = []
    for t in txns:
        rr = [c for c in (clip(r) for r in t.read_ranges) if c is not None]
        wr = [c for c in (clip(w) for w in t.write_ranges) if c is not None]
        out.append(TxnConflictInfo(t.read_snapshot, rr, wr))
    return out


def clip_txns_to_shards(
    txns: Sequence[TxnConflictInfo], boundaries: Sequence[bytes]
) -> list[list[TxnConflictInfo]]:
    """clip_txns_to_shard for every shard of `boundaries` (sorted), in one
    pass over the ranges: each range goes only to the shards it overlaps,
    found by bisection, and one that lies inside its shard is kept as it
    is. Equal, shard by shard, to [clip_txns_to_shard(txns, lo, hi) for
    lo, hi in shard_key_ranges(boundaries)]."""
    if any(a > b for a, b in zip(boundaries, boundaries[1:])):
        return [clip_txns_to_shard(txns, lo, hi)
                for lo, hi in shard_key_ranges(boundaries)]
    S = len(boundaries) + 1
    los = [b""] + list(boundaries)
    his = list(boundaries) + [None]

    def split(ranges):
        out = [[] for _ in range(S)]
        for r in ranges:
            b, e = r.begin, r.end
            if b >= e:
                continue
            i0 = bisect_right(boundaries, b)
            i1 = bisect_left(boundaries, e)
            if i0 == i1:
                out[i0].append(r)
                continue
            for j in range(i0, i1 + 1):
                cb = b if b > los[j] else los[j]
                hi = his[j]
                ce = e if hi is None or e < hi else hi
                if cb < ce:
                    out[j].append(KeyRange(cb, ce))
        return out

    shards = [[] for _ in range(S)]
    for t in txns:
        rr, wr = split(t.read_ranges), split(t.write_ranges)
        for j in range(S):
            shards[j].append(TxnConflictInfo(t.read_snapshot, rr[j], wr[j]))
    return shards


class ShardedConflictSetCPU:
    """Reference-semantics multi-resolver oracle: N independent CPU conflict
    sets over a fixed key-space partition, verdicts combined with max."""

    def __init__(self, boundaries: Sequence[bytes], init_version: int = 0):
        self.boundaries = list(boundaries)
        self.n_shards = len(self.boundaries) + 1
        self.shards = [ConflictSetCPU(init_version) for _ in range(self.n_shards)]

    def resolve(
        self,
        version: int,
        new_oldest_version: int,
        txns: Sequence[TxnConflictInfo],
    ) -> ConflictBatchResult:
        statuses = np.zeros(len(txns), dtype=np.int64)
        ranges = shard_key_ranges(self.boundaries)
        for cs, (lo, hi) in zip(self.shards, ranges):
            local = clip_txns_to_shard(txns, lo, hi)
            st = cs.resolve(version, new_oldest_version, local).statuses
            statuses = np.maximum(statuses, np.asarray(st))
        return ConflictBatchResult([int(s) for s in statuses])

    def shard_entries(self) -> list[list[tuple[bytes, int]]]:
        """Per-shard step functions — the differential target for the
        device path's shard_entries()."""
        return [cs.entries() for cs in self.shards]


class ShardedResolveHandle:
    """One in-flight batch (ShardedConflictSetGPU.submit): the merged
    st_aux on the device, its host copy in flight behind an event, and the
    per-stage timings the resolver role reads. `p2_syncs` counts the host
    reads phase 2 made while this batch was dispatched, all shards: 0 on
    the card, the plain version's group reads on the CPU."""

    __slots__ = ("st", "lay", "n_txns", "version", "pack_ms", "dispatch_ms",
                 "device_ms", "d2h_ms", "depth_at_submit", "consumed",
                 "p2_syncs", "_host", "_event", "_keep")

    def __init__(self, st, lay, n_txns: int, version: int, pack_ms: float,
                 dispatch_ms: float, depth_at_submit: int, p2_syncs: int,
                 keep=None):
        self.st = st
        self.lay = lay
        self.n_txns = n_txns
        self.version = version
        self.pack_ms = pack_ms
        self.dispatch_ms = dispatch_ms
        self.device_ms = None
        self.d2h_ms = None
        self.depth_at_submit = depth_at_submit
        self.consumed = False
        self.p2_syncs = p2_syncs
        self._host, self._event = gpu._start_d2h(st)
        self._keep = keep  # pinned H2D sources, alive until the event


def shard_devices(n_shards: int, device=None,
                  devices=None) -> list[torch.device]:
    """One torch.device per shard: `devices`, exactly n_shards of them
    (repeats allowed: the JAX mesh's counterpart, which needs exactly one
    device per shard), or `device` for every shard (None: the card). A
    card named without an index is the current one, so that equal
    placements compare equal. Passing both raises."""
    if devices is None:
        devs = [resolve_device(device)] * n_shards
    elif device is not None:
        raise ValueError("pass device= (every shard) or devices= (one per "
                         "shard), not both")
    else:
        devs = [resolve_device(d) for d in devices]
        if len(devs) != n_shards:
            raise ValueError(
                f"need exactly {n_shards} devices, one per shard, got "
                f"{len(devs)}"
            )
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]


class ShardedConflictSetGPU:
    """Multi-resolver conflict set with S block-sparse shards, shard s on
    devices[s] (ConflictSetCPU contract per shard, max-merged verdicts).

    submit() clips and packs per shard on the host to one common layout,
    ranks each shard's write endpoints against that shard's fence mirror,
    then runs the touched-block fast kernel on every shard between
    compactions, or the compaction on every shard together (NB stays
    common). `devices` places one shard per entry; `device` places them
    all on one device. With neither, every shard goes on the CUDA card;
    without one it raises unless the caller passes "cpu".
    """

    def __init__(
        self,
        boundaries: Sequence[bytes],
        init_version: int = 0,
        max_key_bytes: int = 32,
        initial_capacity: int = 1024,
        min_capacity: int = 64,
        block_slots: int | None = None,
        device=None,
        devices=None,
    ):
        self.boundaries = list(boundaries)
        self.n_shards = len(self.boundaries) + 1
        self._place(shard_devices(self.n_shards, device, devices))
        self.n_words = max(1, (max_key_bytes + 3) // 4)
        self.max_key_bytes = 4 * self.n_words
        self.B = next_pow2(
            int(block_slots or SERVER_KNOBS.TPU_BLOCK_SLOTS), minimum=8
        )
        self.F = self.B // 2
        self.NB = next_pow2(max(initial_capacity, 1) // self.B, minimum=8)
        self.min_NB = min(
            next_pow2(max(min_capacity, 1) // self.B, minimum=8), self.NB
        )
        if not (0 <= init_version < 2**31):
            raise ValueError("init_version must fit the initial int32 window")
        self.oldest_version = 0  # logical GC horizon (absolute), all shards
        self._base = 0           # device version-offset base (absolute)

        S = self.n_shards
        hmat, counts, fences, btree = empty_block_state(
            self.n_words, self.NB, self.B, init_version
        )
        # Every shard gets the empty-key sentinel: shard-local histories
        # are independent step functions over the full key axis; clipping
        # guarantees only in-shard keys are ever queried or merged.
        self._set_state([hmat] * S, [counts] * S, [fences] * S, [btree] * S,
                        [np.int32(1)] * S)
        w0, l0 = pack_keys([b""], self.n_words)
        enc0 = encode_packed_words(w0, l0)
        self._fences_enc = [enc0.copy() for _ in range(S)]
        self._fills = np.zeros((S, self.NB), dtype=np.int64)
        self._fills[:, 0] = 1
        self._since_compact = 0
        self._init_host_state()

    def _place(self, devices: list[torch.device]) -> None:
        self.devices = devices
        self.device = devices[0]  # where the merged verdicts land
        groups: dict = {}
        for s, d in enumerate(devices):
            groups.setdefault(d, []).append(s)
        self._groups = list(groups.items())  # (device, its shards)

    def _set_state(self, hmat, counts, fences, btree, n) -> None:
        """Each shard's arrays (host data, one per shard) onto its
        device."""
        def put(arrs):
            return [gpu.to_device(a, d) for a, d in zip(arrs, self.devices)]

        self.hmat, self.counts, self.fences, self.btree, self.n = (
            put(x) for x in (hmat, counts, fences, btree, n))

    def _init_host_state(self) -> None:
        self._pending_mirror = None  # (fences, counts) lists after compact
        self._steps: set = set()     # distinct (kind, layout, dims) steps
        self._sticky = StickyCaps()
        self.last_p2_iters = None
        # Pipeline gauges (submit/verdicts), mirroring ConflictSetGPU.
        self.inflight = 0
        self.max_inflight = 0
        # Dispatch counts by path (telemetry).
        self.compactions = 0
        self.fast_resolves = 0
        self.mirror_reads = 0  # fence/count readbacks (one host read each)

    @classmethod
    def from_state(cls, state: dict, device=None,
                   devices=None) -> "ShardedConflictSetGPU":
        """Rebuild a set from another implementation's state (plain numpy
        arrays and ints): the stacked hmat, counts, fences, btree and n
        (leading axis: the shards), the per-shard host mirror _fences_enc
        (a list) and _fills (S, NB), NB, B, n_words, _base,
        oldest_version, _since_compact and boundaries (optional: min_NB),
        split onto the shards' devices. A JAX ShardedConflictSetTPU handed
        over mid-stream (with its mirror refreshed) continues
        identically."""
        cs = cls.__new__(cls)
        cs.boundaries = list(state["boundaries"])
        cs.n_shards = len(cs.boundaries) + 1
        cs._place(shard_devices(cs.n_shards, device, devices))
        cs.n_words = int(state["n_words"])
        cs.max_key_bytes = 4 * cs.n_words
        cs.B = int(state["B"])
        cs.F = cs.B // 2
        cs.NB = int(state["NB"])
        cs.min_NB = int(state.get("min_NB", min(8, cs.NB)))
        cs.oldest_version = int(state["oldest_version"])
        cs._base = int(state["_base"])
        S = cs.n_shards
        hmat = np.asarray(state["hmat"])
        want = (S, cs.n_words + 2, cs.NB * cs.B)
        if hmat.shape != want:
            raise ValueError(f"hmat shape {hmat.shape} does not "
                             f"match (shards, n_words+2, NB*B) = {want}")
        if len(state["_fences_enc"]) != S:
            raise ValueError("one fence mirror per shard is needed")
        cs._set_state(hmat, np.asarray(state["counts"]),
                      np.asarray(state["fences"]),
                      np.asarray(state["btree"]), np.asarray(state["n"]))
        cs._fences_enc = [np.asarray(e).copy() for e in state["_fences_enc"]]
        cs._fills = np.asarray(state["_fills"], dtype=np.int64).copy()
        cs._since_compact = int(state["_since_compact"])
        cs._init_host_state()
        return cs

    # -- introspection --

    @property
    def capacity(self) -> int:
        """Per-shard slot capacity (the whole state is S x this)."""
        return self.NB * self.B

    @property
    def compiled_steps(self) -> int:
        """Count of distinct (kind, layout, K, NB) step shapes dispatched —
        the JAX package's compiled shard_map steps; jittering batches of a
        steady profile must not grow it."""
        return len(self._steps)

    def shard_ranges(self) -> list[tuple[bytes, bytes | None]]:
        return shard_key_ranges(self.boundaries)

    def shard_entries(self) -> list[list[tuple[bytes, int]]]:
        """Per-shard canonicalized step functions (absolute versions) —
        bit-identical to the sharded CPU oracle's shard_entries() at any
        point, compactions pending or not."""
        return [
            gpu.canonical_entries(h.cpu().numpy(), c.cpu().numpy(),
                                  self.n_words, self.B, self._base,
                                  self.oldest_version)
            for h, c in zip(self.hmat, self.counts)
        ]

    # -- host mirror --

    def _refresh_mirror(self) -> None:
        """Materialize a compaction's fence/count readback into the host
        mirrors (ONE small D2H per device per compaction, paid lazily
        here)."""
        if self._pending_mirror is None:
            return
        fences, counts = self._pending_mirror
        self._pending_mirror = None
        W = self.n_words
        nb = counts[0].shape[0]
        fills = np.zeros((self.n_shards, nb), dtype=np.int64)
        for _, shards in self._groups:
            self.mirror_reads += 1
            k = len(shards)
            both = torch.cat(
                [counts[s] for s in shards]
                + [fences[s].reshape(-1) for s in shards]
            ).cpu().numpy()
            cg = both[: k * nb].reshape(k, nb)
            fw = both[k * nb:].reshape(k, W + 1, nb)
            for i, s in enumerate(shards):
                self._fences_enc[s] = gpu.fence_mirror(
                    fw[i], W, int((cg[i] > 0).sum()))
                fills[s] = cg[i]
        self._fills = fills

    # -- growth --

    def _grow_blocks(self, NB_out: int) -> None:
        """Append pad blocks to every shard, on its device (no host read):
        the compaction this growth precedes rebuilds fences and btree."""
        S = self.n_shards
        pad = (NB_out - self.NB) * self.B
        block = state_pad_block(self.n_words, pad)
        pads = {d: gpu.to_device(block, d) for d, _ in self._groups}
        self.hmat = [torch.cat([h, pads[d]], dim=1)
                     for h, d in zip(self.hmat, self.devices)]
        self.counts = [
            torch.cat([c, torch.zeros(NB_out - self.NB, dtype=I32, device=d)])
            for c, d in zip(self.counts, self.devices)
        ]
        self._fills = np.concatenate(
            [self._fills, np.zeros((S, NB_out - self.NB), dtype=np.int64)],
            axis=1,
        )
        self.NB = NB_out

    def _grow_width(self, min_key_bytes: int) -> None:
        """Widen every shard's packed state AND fence directory (a host
        re-pack), capped by the deployment key-size knob."""
        cap = CLIENT_KNOBS.KEY_SIZE_LIMIT + 1
        if min_key_bytes > cap:
            raise KeyWidthError(
                f"key of {min_key_bytes} bytes exceeds the deployment "
                f"key-size limit {cap}"
            )
        self._refresh_mirror()
        new_words = min(
            next_pow2((min_key_bytes + 3) // 4, minimum=self.n_words * 2),
            next_pow2((cap + 3) // 4),
        )
        W = self.n_words
        widened = [widen_state(h.cpu().numpy(), W, new_words)
                   for h in self.hmat]
        fw2 = [gpu.widen_fences(f.cpu().numpy(), W, new_words)
               for f in self.fences]
        counts = [c.cpu().numpy() for c in self.counts]
        self.n_words = new_words
        self.max_key_bytes = 4 * new_words
        self.hmat = [gpu.to_device(h, d)
                     for h, d in zip(widened, self.devices)]
        self.fences = [gpu.to_device(f, d) for f, d in zip(fw2, self.devices)]
        self._fences_enc = [
            gpu.fence_mirror(f, new_words, int((c > 0).sum()))
            for f, c in zip(fw2, counts)
        ]

    # -- transfers --

    def _upload(self, bufs: list):
        """Every shard's fused buffer on its device: ONE H2D per device,
        of its shards' buffers stacked. Returns (per-shard tensors, the
        pinned sources to keep alive until the copies complete)."""
        fused, keep = [None] * self.n_shards, []
        for d, shards in self._groups:
            t, k = gpu.upload(np.stack([bufs[s] for s in shards]), d)
            keep.append(k)
            for i, s in enumerate(shards):
                fused[s] = t[i]
        return fused, keep

    def _merge(self, sts: list) -> torch.Tensor:
        """The proxy-side verdict merge, lax.pmax's counterpart: every
        shard's st_aux copied to devices[0] (no copy where it lies there
        already), then a signed byte max over the whole vector. Any
        shard's CONFLICT/TOO_OLD wins."""
        d0 = self.devices[0]
        return torch.stack(
            [st.to(d0, non_blocking=True) for st in sts]
        ).amax(dim=0)

    # -- resolution --

    def submit(
        self,
        version: int,
        new_oldest_version: int,
        txns: Sequence[TxnConflictInfo],
    ) -> ShardedResolveHandle:
        """Dispatch one batch WITHOUT waiting for its verdicts: clip, pack
        and rank on the host, one H2D per device of its shards' fused
        buffers, then the fast kernel (or the compaction) on every shard,
        each on its own device, and the verdict merge, all enqueued.
        Consume with verdicts()."""
        from .wire import WireBatch

        syncs0 = gpu.P2_SYNCS
        t_sub0 = gpu._pc()
        if isinstance(txns, WireBatch):
            # Clipping per shard needs key objects: decode once here.
            txns = txns.to_txns()
        oldest_eff = max(self.oldest_version, new_oldest_version)
        if not (0 <= version - self._base < 2**31):
            raise ValueError(
                "resolve version outside the int32 window relative to "
                f"device base {self._base}"
            )
        self._refresh_mirror()

        # Host-side proxy work: clip per shard, pack to common shapes. Row
        # counts come from the same flatten_batch that pack_batch uses, so
        # the common caps can never drift from what actually packs.
        per_shard = clip_txns_to_shards(txns, self.boundaries)
        flats = [flatten_batch(local, self.oldest_version) for local in per_shard]
        counts_r = [len(f[1]) for f in flats]
        counts_w = [len(f[5]) for f in flats]
        r_cap, w_cap, t_bucket, er_cap, ew_cap = self._sticky.caps_for(
            len(txns)
        )
        caps = (
            max(max(counts_r), r_cap), max(max(counts_w), w_cap), t_bucket,
            er_cap, ew_cap,
        )

        while True:
            try:
                packed = [
                    pack_batch(local, self.oldest_version, self.n_words, caps,
                               flat=f)
                    for local, f in zip(per_shard, flats)
                ]
                # Shards share ONE layout (one step shape), but
                # explicit-end counts are only known after packing: repack
                # against the widest shard's buckets if they diverged.
                if len({pb.layout.key() for pb in packed}) > 1:
                    caps = (
                        caps[0], caps[1], caps[2],
                        max(pb.layout.Er for pb in packed),
                        max(pb.layout.Ew for pb in packed),
                    )
                    packed = [
                        pack_batch(local, self.oldest_version, self.n_words,
                                   caps, flat=f)
                        for local, f in zip(per_shard, flats)
                    ]
                break
            except KeyWidthError:
                longest = max(
                    len(k)
                    for f in flats
                    for k in (*f[1], *f[2], *f[5], *f[6])
                )
                self._grow_width(longest)
        lay = packed[0].layout
        # Decay/high-water bookkeeping sees the widest shard per dimension.
        self._sticky.update_counts(
            lay, max(p.n_reads for p in packed),
            max(p.n_writes for p in packed),
            max(p.n_expl_r for p in packed),
            max(p.n_expl_w for p in packed),
        )

        # Rank each shard's write endpoints against ITS fence mirror.
        touched_l, inc_l = [], []
        for s, pb in enumerate(packed):
            touched, inc = gpu._touched_blocks(
                self._fences_enc[s], pb.wb_enc, pb.we_enc, pb.n_writes
            )
            touched_l.append(touched)
            inc_l.append(inc)
        max_touched = max(len(t) for t in touched_l)
        S = self.n_shards

        need_slow = gpu.needs_compaction(
            self._since_compact, version - self._base, max_touched,
            self._fills, inc_l, [pb.n_writes for pb in packed], self.NB,
            self.B,
        )
        version_off = version - self._base
        oldest_off = oldest_eff - self._base
        delta = self.oldest_version - self._base  # pb.base -> device base

        if need_slow:
            # Compaction + dense resolve, ALL shards together (NB stays
            # common): NB_out is sized by the widest shard so every
            # shard's canonical set fits at fill F.
            m_pred = max(
                int(self._fills[s].sum()) + 2 * packed[s].n_writes
                for s in range(S)
            )
            NB_out = gpu.compacted_blocks(m_pred, self.F, self.min_NB,
                                          self.NB)
            if NB_out > self.NB:
                self._grow_blocks(NB_out)
            for pb in packed:
                pb.set_scalars(version_off, oldest_off)
                gpu.rebase_snapshots(pb.buf, lay, delta)
            fused, keep = self._upload([pb.buf for pb in packed])
            self._steps.add(("cmp", lay.key(), self.NB, NB_out, self.B))
            t_disp = gpu._pc()
            outs = []
            for s in range(S):
                with on_device(self.devices[s]):
                    outs.append(gpu._compact_resolve_impl(
                        self.hmat[s], self.counts[s], fused[s], lay=lay,
                        NB=self.NB, NB_out=NB_out, B=self.B,
                    ))
            (self.hmat, self.counts, self.btree, self.fences, self.n,
             sts) = (list(x) for x in zip(*outs))
            self.NB = NB_out
            self._base = oldest_eff
            self._since_compact = 0
            self.compactions += 1
            self._pending_mirror = (self.fences, self.counts)
            self._fills = None  # stale until _refresh_mirror
        else:
            k_nat = next_bucket(max(max_touched, 1))
            K = min(max(k_nat, self._sticky.k_cap_for(len(txns), S)),
                    self.NB)
            self._sticky.update_k(len(txns), min(k_nat, self.NB), S)
            # Pad rows of each shard's gather vector are redirected by the
            # kernel to an untouched block of the same shard.
            bufs = [
                gpu.block_step_buf(pb.buf, lay, t, K, self.NB, version_off,
                                   oldest_off, delta)
                for pb, t in zip(packed, touched_l)
            ]
            fused, keep = self._upload(bufs)
            self._steps.add(("blk", lay.key(), K, self.NB, self.B))
            t_disp = gpu._pc()
            sts = []
            for s in range(S):
                # hmat/counts/btree are updated in place.
                with on_device(self.devices[s]):
                    _, _, _, self.n[s], st_s = gpu._resolve_block_kernel_impl(
                        self.hmat[s], self.counts[s], self.btree[s],
                        self.fences[s], self.n[s], fused[s],
                        lay=lay, K=K, NB=self.NB, B=self.B,
                    )
                sts.append(st_s)
            for s in range(S):
                self._fills[s, : len(self._fences_enc[s])] += inc_l[s]
            self._since_compact += 1
            self.fast_resolves += 1

        st = self._merge(sts)
        self.oldest_version = oldest_eff
        self.inflight += 1
        self.max_inflight = max(self.max_inflight, self.inflight)
        t_end = gpu._pc()
        return ShardedResolveHandle(
            st=st, lay=lay, n_txns=len(txns), version=version,
            pack_ms=(t_disp - t_sub0) * 1e3,
            dispatch_ms=(t_end - t_disp) * 1e3,
            depth_at_submit=self.inflight,
            p2_syncs=gpu.P2_SYNCS - syncs0, keep=keep,
        )

    def verdicts(self, handle: ShardedResolveHandle) -> list[int]:
        """Consume one in-flight batch: the designated host-sync site (the
        merged status vector's D2H, started at dispatch). Records the
        device wait and readback split on the handle."""
        if handle.consumed:
            raise RuntimeError("verdicts() consumed twice for one handle")
        t0 = gpu._pc()
        if handle._event is not None:
            handle._event.synchronize()
            handle._keep = None
        t1 = gpu._pc()
        st_h = handle._host.numpy()
        t2 = gpu._pc()
        handle.device_ms = (t1 - t0) * 1e3
        handle.d2h_ms = (t2 - t1) * 1e3
        handle.consumed = True
        self.inflight -= 1
        lay = handle.lay
        if bool(st_h[lay.T + 4]):  # pragma: no cover - host bounds make this dead
            raise RuntimeError(
                "sharded conflict set overflow despite the host headroom "
                "bounds"
            )
        self.last_p2_iters = int(st_h[lay.T + 5])  # max across shards
        return [int(s) for s in st_h[: handle.n_txns]]

    def resolve(
        self,
        version: int,
        new_oldest_version: int,
        txns: Sequence[TxnConflictInfo],
    ) -> ConflictBatchResult:
        """Synchronous resolve = submit + immediate verdicts."""
        return ConflictBatchResult(
            self.verdicts(self.submit(version, new_oldest_version, txns))
        )
