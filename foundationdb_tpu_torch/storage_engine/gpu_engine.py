"""KeyValueStoreGPU: the storage server's MVCC read window on the CUDA card.

The torch counterpart of foundationdb_tpu/storage_engine/tpu_engine.py
(KeyValueStoreTPU), with the same state, attributes, host oracle and
submit/verdicts contract; its module docstring explains the layout.
In short, the window lives on the card as

  base    (W+2, NB*B) int32: NB blocks of B sorted slots, each column one
          MVCC entry [key words | key len | version offset], every block
          filled to F = B/2 after a compaction, so global rank r sits at
          column (r // F) * B + r % F;
  fences  (W+2, NB): each block's first entry, the directory the probe
          walks; slots (NB*B,) ids into the host value table; nextsame
          (NB*B,) 1 where the next rank holds the same key;
  delta   (W+2, D) + dslots/dnext: the dense sorted memtable of every
          write since the last compaction (STORAGE_TPU_DELTA_SLOTS);

and one dispatch answers P point reads and R range reads against base
and delta. A host VersionedMap rides inside as the authoritative oracle.

What differs from the JAX package, and why:

- `_read_kernel_impl` is two hand-written CUDA kernels on the card, so
  there is no per-shape jit cache; P, R (next_bucket) and S (next_pow2 of
  the span cap) are still bucketed, because they define the aux vector's
  layout.
- Its base rank is resolver/probe.probe_ranks over the whole window
  matrix, the version row riding as one more key word: the hand-written
  CUDA kernel on the card, its plain torch version on the CPU, with equal
  results. JAX ran its XLA walk there by default (the Pallas probe behind
  TPU_PROBE_KERNEL); the port has no probe knob. The rest (the delta's
  dense halving walk, as in JAX, the gathers and the aux vector) is
  storage_engine/read.read_gather: csrc/read.cu on the card, its plain
  torch version on the CPU.
- Gathers clamp explicitly where JAX clips (torch faults where JAX clamps).
- Uploads go through pinned memory with non_blocking, and the aux
  vector's D2H starts at dispatch behind a CUDA event, so `submit_reads`
  makes no host sync; `read_verdicts` waits on the event, the one sync
  site. The pinned sources ride on the next handle until its verdicts.
- `register_metrics` waits for the port's metrics registry.

Everything is integer arithmetic, so the aux vector, the read replies and
`entries()` equal the JAX package's and the oracle's bit for bit.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from ..core.knobs import SERVER_KNOBS
from ..core.stats import Counter
from ..device import resolve_device
from ..kv.versioned_map import VersionedMap, canonical_chain
from ..resolver.gpu import _start_d2h
from ..resolver.packing import (
    PAD_WORD,
    KeyWidthError,
    encode_packed_words,
    next_bucket,
    next_pow2,
    pack_keys,
)
from ..resolver.probe import probe_ranks
from .read import read_gather

I32MAX = np.int32(2**31 - 1)
# Version offsets leave headroom for the point probe's v+1 and the +inf
# pad; past this the window recompacts to rebase.
_OFF_LIMIT = 2**31 - 4


def _pc() -> float:
    """Stage-timing read (telemetry only; never enters control flow)."""
    return time.perf_counter()


def _read_kernel_impl(hmat, slots, nextsame, fences, dmat, dslots, dnext,
                      qall, rv, *, P: int, R: int, S: int, F: int,
                      NB: int, B: int):
    """One dispatch answering P point reads + R range reads against base
    blocks AND delta (tpu_engine.py:113): rank-probe all P+2R query
    columns (points carry (key, len, v+1), range begins and ends (key,
    len, -1)), then read.read_gather: the delta walk, point predecessors,
    S-wide range spans with the local visibility test at `rv`, and ONE
    int32 aux vector. On the card two kernel launches (csrc/probe.cu,
    csrc/read.cu) and no torch op."""
    bid, pos, _ = probe_ranks(hmat, fences, qall, NB=NB, B=B)
    return read_gather(hmat, slots, nextsame, dmat, dslots, dnext, qall, rv,
                       bid, pos, P=P, R=R, S=S, F=F, NB=NB, B=B)


class ReadHandle:
    """One submitted read batch in flight: the aux vector's host copy (its
    D2H started at dispatch, behind `_event` on the card), the pinned
    upload sources to hold until then, and the metadata to slice it.
    Nothing synchronizes until read_verdicts. The handle pins the value
    table it was dispatched against (a compaction rebinds the engine's)."""

    __slots__ = ("_aux", "_event", "_keep", "points", "ranges", "P", "R",
                 "S", "values", "dispatch_ms", "consumed")

    def __init__(self, aux, event, keep, points, ranges, P, R, S, values,
                 dispatch_ms):
        self._aux = aux
        self._event = event
        self._keep = keep
        self.points = points    # [(key, version), ...]
        self.ranges = ranges    # [(begin, end, version, limit, reverse), ...]
        self.P, self.R, self.S = P, R, S
        self.values = values
        self.dispatch_ms = dispatch_ms
        self.consumed = False


class KeyValueStoreGPU:
    """VersionedMap-contract MVCC window with a device-resident batched
    read path. Construct via storage_engine.factory.make_mvcc_window.
    `device=None` means the CUDA card; without one it raises unless the
    caller passes device="cpu"."""

    def __init__(self, n_words: int = 4, block_slots: int | None = None,
                 device=None):
        self.device = resolve_device(device)
        self._oracle = VersionedMap()
        self._n_words = next_pow2(max(n_words, 1), minimum=1)
        self.B = next_pow2(
            int(block_slots if block_slots is not None
                else SERVER_KNOBS.TPU_BLOCK_SLOTS), minimum=8)
        self.F = self.B // 2
        # host value table: slot id -> (key, value|None); device columns
        # carry only slot ids. Rebound (not mutated) at compaction so
        # in-flight ReadHandles keep their dispatched-against table.
        self._values: list[tuple[bytes, Optional[bytes]]] = []
        # writes since the last delta fold: (key, version, slot)
        self._pending: list[tuple[bytes, int, int]] = []
        self._force_compact = False
        # host-side delta mirror (entries since last compaction, sorted)
        self._delta_keys: list[bytes] = []
        self._delta_vers = np.zeros(0, np.int64)
        self._delta_slots = np.zeros(0, np.int64)
        self._vbase = 0
        self._n_base = 0
        self._base_abs = np.zeros(0, np.int64)
        self.NB = 0
        self._init_host_state()
        self._compact()

    def _init_host_state(self) -> None:
        self._h2d_keep: list[torch.Tensor] = []  # pinned upload sources
        # -- metrics --
        self.c_point_reads = Counter("GPUEnginePointReads")
        self.c_range_reads = Counter("GPUEngineRangeReads")
        self.c_batches = Counter("GPUEngineReadBatches")
        self.c_span_fallbacks = Counter("GPUEngineSpanFallbacks")
        self.c_compactions = Counter("GPUEngineCompactions")
        self.c_delta_folds = Counter("GPUEngineDeltaFolds")
        self.last_batch_width = 0
        self.last_pack_ms = 0.0
        self.last_dispatch_ms = 0.0
        self.last_d2h_ms = 0.0
        # the last compaction's host rebuild and upload enqueue
        self.last_rebuild_ms = 0.0
        self.last_upload_ms = 0.0

    @classmethod
    def from_state(cls, state: dict, device=None) -> "KeyValueStoreGPU":
        """Rebuild an engine from another implementation's state, given as
        plain numpy arrays, ints and lists: the oracle's `_keys`,
        `_chains`, `oldest_version`, `latest_version`; `_values`,
        `_pending`, `_delta_keys`, `_delta_vers`, `_delta_slots`, `_vbase`,
        `_n_base`, `_base_abs`, `n_words`, `B`, `NB` (optional:
        `_force_compact`); and the device arrays `hmat`, `slots`,
        `nextsame`, `fences`, `dmat`, `dslots`, `dnext`. A KeyValueStoreTPU
        handed over mid-stream continues identically. Everything is
        copied: the engine never aliases the caller's objects. Counters
        start at zero."""
        eng = cls.__new__(cls)
        eng.device = resolve_device(device)
        ora = eng._oracle = VersionedMap()
        ora._keys = list(state["_keys"])
        ora._chains = {k: list(c) for k, c in state["_chains"].items()}
        ora.oldest_version = int(state["oldest_version"])
        ora.latest_version = int(state["latest_version"])
        ora.reindex()
        eng._n_words = int(state["n_words"])
        eng.B = int(state["B"])
        eng.F = eng.B // 2
        eng.NB = int(state["NB"])
        eng._values = list(state["_values"])
        eng._pending = [(k, int(v), int(s)) for k, v, s in state["_pending"]]
        eng._force_compact = bool(state.get("_force_compact", False))
        eng._delta_keys = list(state["_delta_keys"])
        eng._delta_vers = np.array(state["_delta_vers"], dtype=np.int64)
        eng._delta_slots = np.array(state["_delta_slots"], dtype=np.int64)
        eng._vbase = int(state["_vbase"])
        eng._n_base = int(state["_n_base"])
        eng._base_abs = np.array(state["_base_abs"], dtype=np.int64)
        eng._init_host_state()
        W2 = eng._n_words + 2

        def dev(name, shape):
            arr = np.array(state[name], dtype=np.int32)
            if arr.shape != shape:
                raise ValueError(f"{name} shape {arr.shape} != {shape}")
            return eng._upload(arr)

        D = np.shape(state["dslots"])[0]
        NBB = eng.NB * eng.B
        eng._d_hmat = dev("hmat", (W2, NBB))
        eng._d_slots = dev("slots", (NBB,))
        eng._d_next = dev("nextsame", (NBB,))
        eng._d_fences = dev("fences", (W2, eng.NB))
        eng._d_dmat = dev("dmat", (W2, D))
        eng._d_dslots = dev("dslots", (D,))
        eng._d_dnext = dev("dnext", (D,))
        return eng

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """One H2D of a host array without a host sync: on the card through
        pinned memory with non_blocking, the pinned source held until the
        next read batch's verdicts (stream order puts the copy first)."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return src
        src = src.pin_memory()
        self._h2d_keep.append(src)
        return src.to(self.device, non_blocking=True)

    # -- VersionedMap window surface (oracle delegates; device follows) --
    @property
    def oldest_version(self) -> int:
        return self._oracle.oldest_version

    @property
    def latest_version(self) -> int:
        return self._oracle.latest_version

    def __len__(self) -> int:
        return len(self._oracle)

    def _stage(self, key: bytes, version: int, value: Optional[bytes]):
        slot = len(self._values)
        self._values.append((key, value))
        self._pending.append((key, version, slot))

    def set(self, key: bytes, value: bytes, version: int) -> None:
        self._oracle.set(key, value, version)
        self._stage(key, version, value)

    def set_bulk(self, keys, values, version: int) -> None:
        """Columnar apply: N same-version sets in one call (a decoded
        decode_set_columns entry)."""
        for k, v in zip(keys, values):
            self._oracle.set(k, v, version)
            self._stage(k, version, v)

    def clear(self, key: bytes, version: int) -> None:
        self._oracle.clear(key, version)
        self._stage(key, version, None)

    def clear_range(self, begin: bytes, end: bytes, version: int) -> None:
        # a tombstone per indexed key in range, as the oracle does
        for key in self._oracle.keys_in_range(begin, end):
            self.clear(key, version)

    def set_snapshot(self, key: bytes, value: bytes, version: int) -> None:
        # supersedes same-key entries <= version: a removal, which the
        # append-only delta cannot express, so the window rebuilds
        self._oracle.set_snapshot(key, value, version)
        self._force_compact = True

    def rollback_above(self, version: int) -> None:
        self._oracle.rollback_above(version)
        self._force_compact = True

    def forget_before(self, version: int) -> None:
        # logical only on the card: entries the oracle prunes are already
        # read-inert under the visibility test; the next compaction drops
        # them physically
        self._oracle.forget_before(version)

    def get(self, key: bytes, version: int) -> Optional[bytes]:
        # the synchronous single-read surface: the host oracle answers
        return self._oracle.get(key, version)

    def keys_in_range(self, begin: bytes, end: bytes) -> list[bytes]:
        return self._oracle.keys_in_range(begin, end)

    def get_range(self, begin: bytes, end: bytes, version: int,
                  limit: int = 0, reverse: bool = False):
        return self._oracle.get_range(begin, end, version, limit, reverse)

    # -- canonical entries (differential contract with VersionedMap) --
    def entries(self) -> list[tuple[bytes, int, Optional[bytes]]]:
        """Canonical (key, version, value) rows reconstructed from the
        device mirrors (base + delta + pending), normalized exactly like
        VersionedMap.entries()."""
        if self._force_compact:
            self._fold_pending()
        rows: dict[bytes, dict[int, Optional[bytes]]] = {}
        for r in range(self._n_base):
            key, val = self._values[r]  # base slot id == rank
            rows.setdefault(key, {})[int(self._base_abs[r])] = val
        for i in range(len(self._delta_keys)):
            rows.setdefault(self._delta_keys[i], {})[
                int(self._delta_vers[i])
            ] = self._values[int(self._delta_slots[i])][1]
        for key, ver, slot in self._pending:
            rows.setdefault(key, {})[ver] = self._values[slot][1]
        oldest = self._oracle.oldest_version
        out: list[tuple[bytes, int, Optional[bytes]]] = []
        for key in sorted(rows):
            out.extend(
                (key, v, val)
                for v, val in canonical_chain(sorted(rows[key].items()),
                                              oldest)
            )
        return out

    # -- device state maintenance --
    def _compact(self) -> None:
        """Rebuild blocks + fences + slot table from the oracle (delta and
        pending fold in and empty)."""
        t0 = _pc()
        base = self._oracle.oldest_version
        ents = self._oracle.entries()
        n = len(ents)
        while True:
            try:
                words, lens = pack_keys([k for k, _, _ in ents],
                                        self._n_words)
                break
            except KeyWidthError:
                self._n_words = next_pow2(self._n_words + 1, minimum=1)
        vers_abs = np.fromiter((v for _, v, _ in ents), np.int64, count=n)
        offs = np.clip(vers_abs - base, 0, _OFF_LIMIT).astype(np.int32)
        self._values = [(k, val) for k, _, val in ents]
        W = self._n_words
        F, B = self.F, self.B
        # +1: the fence walk saturates at NB-1, so at least one +inf fence
        # pads the directory for past-the-end queries
        self.NB = NB = next_pow2(math.ceil(n / F) + 1, minimum=8)
        NBB = NB * B
        hmat = np.full((W + 2, NBB), PAD_WORD, np.int32)
        hmat[W:] = I32MAX
        slots = np.full(NBB, -1, np.int32)
        nextsame = np.zeros(NBB, np.int32)
        ranks = np.arange(n, dtype=np.int64)
        cols = (ranks // F) * B + ranks % F
        hmat[:W, cols] = words.T
        hmat[W, cols] = lens
        hmat[W + 1, cols] = offs
        slots[cols] = ranks.astype(np.int32)
        if n > 1:
            enc = encode_packed_words(words, lens)
            nextsame[cols[:-1]] = (enc[1:] == enc[:-1]).astype(np.int32)
        fences = np.full((W + 2, NB), PAD_WORD, np.int32)
        fences[W:] = I32MAX
        nb_live = math.ceil(n / F)
        if nb_live:
            fences[:, :nb_live] = hmat[
                :, cols[np.arange(nb_live, dtype=np.int64) * F]
            ]
        self._base_abs = vers_abs  # host mirror for entries()
        self._n_base = n
        self._vbase = base
        t1 = _pc()
        self._d_hmat = self._upload(hmat)
        self._d_slots = self._upload(slots)
        self._d_next = self._upload(nextsame)
        self._d_fences = self._upload(fences)
        self._delta_keys = []
        self._delta_vers = np.zeros(0, np.int64)
        self._delta_slots = np.zeros(0, np.int64)
        self._pending = []
        self._force_compact = False
        self._set_delta_device()
        self.last_rebuild_ms = (t1 - t0) * 1e3
        self.last_upload_ms = (_pc() - t1) * 1e3
        self.c_compactions.add(1)

    def _set_delta_device(self) -> None:
        n = len(self._delta_keys)
        W = self._n_words
        # +1: the dense walk saturates at D-1, so the delta keeps at least
        # one +inf pad column for past-the-end queries
        D = next_pow2(n + 1, minimum=8)
        dmat = np.full((W + 2, D), PAD_WORD, np.int32)
        dmat[W:] = I32MAX
        dslots = np.full(D, -1, np.int32)
        dnext = np.zeros(D, np.int32)
        if n:
            words, lens = pack_keys(self._delta_keys, W)
            dmat[:W, :n] = words.T
            dmat[W, :n] = lens
            dmat[W + 1, :n] = np.clip(
                self._delta_vers - self._vbase, 0, _OFF_LIMIT
            ).astype(np.int32)
            dslots[:n] = self._delta_slots.astype(np.int32)
            if n > 1:
                enc = encode_packed_words(words, lens)
                dnext[: n - 1] = (enc[1:] == enc[:-1]).astype(np.int32)
        self._d_dmat = self._upload(dmat)
        self._d_dslots = self._upload(dslots)
        self._d_dnext = self._upload(dnext)

    def _fold_pending(self) -> None:
        """Merge pending writes into the sorted delta (or compact when the
        delta outgrows its knob, the key width grew, or a structural edit
        forced a rebuild)."""
        if not self._pending and not self._force_compact:
            return
        n_new = len(self._delta_keys) + len(self._pending)
        if (self._force_compact
                or n_new > int(SERVER_KNOBS.STORAGE_TPU_DELTA_SLOTS)
                or self._oracle.latest_version - self._vbase >= _OFF_LIMIT):
            self._compact()
            return
        keys = self._delta_keys + [k for k, _, _ in self._pending]
        vers = np.concatenate([
            self._delta_vers,
            np.fromiter((v for _, v, _ in self._pending), np.int64,
                        count=len(self._pending)),
        ])
        slots = np.concatenate([
            self._delta_slots,
            np.fromiter((s for _, _, s in self._pending), np.int64,
                        count=len(self._pending)),
        ])
        try:
            words, lens = pack_keys(keys, self._n_words)
        except KeyWidthError:
            # a staged key outgrew the packed layout: rebuild wider (the
            # compaction folds pending in)
            self._n_words = next_pow2(self._n_words + 1, minimum=1)
            self._compact()
            return
        enc = encode_packed_words(words, lens)
        # stable by staging order at equal (key, version): the last entry
        # wins, and the visibility test hides the earlier twin
        order = np.lexsort((np.arange(len(keys)), vers, enc))
        self._delta_keys = [keys[i] for i in order]
        self._delta_vers = vers[order]
        self._delta_slots = slots[order]
        self._pending = []
        self._set_delta_device()
        self.c_delta_folds.add(1)

    # -- batched read endpoint (submit/verdicts split) --
    def submit_reads(self, points, ranges) -> ReadHandle:
        """Dispatch one fused device batch for `points` [(key, version)]
        and `ranges` [(begin, end, version, limit, reverse)]. Returns
        without synchronizing: read_verdicts(handle) is the one sync."""
        t0 = _pc()
        self._fold_pending()
        P = next_bucket(max(len(points), 1))
        R = next_bucket(len(ranges)) if ranges else 0
        S = next_pow2(int(SERVER_KNOBS.STORAGE_TPU_SPAN_CAP), minimum=8)
        while True:
            W = self._n_words
            try:
                qall, rv = self._pack_queries(points, ranges, P, R, W)
                break
            except KeyWidthError:
                # a queried key wider than the packed layout: rebuild wider
                # (queries and entries must share the width)
                self._n_words = next_pow2(W + 1, minimum=1)
                self._compact()
        t1 = _pc()
        aux = _read_kernel_impl(
            self._d_hmat, self._d_slots, self._d_next, self._d_fences,
            self._d_dmat, self._d_dslots, self._d_dnext,
            self._upload(qall), self._upload(rv),
            P=P, R=R, S=S, F=self.F, NB=self.NB, B=self.B,
        )
        host, event = _start_d2h(aux)
        keep, self._h2d_keep = self._h2d_keep, []
        t2 = _pc()
        self.last_pack_ms = (t1 - t0) * 1e3
        self.last_dispatch_ms = (t2 - t1) * 1e3
        self.last_batch_width = len(points) + len(ranges)
        self.c_batches.add(1)
        self.c_point_reads.add(len(points))
        self.c_range_reads.add(len(ranges))
        return ReadHandle(host, event, keep, list(points), list(ranges),
                          P, R, S, self._values, (t2 - t1) * 1e3)

    def _pack_queries(self, points, ranges, P, R, W):
        """(W+2, P+2R) probe operand + (R,) span visibility versions.
        Point columns carry (key, len, v_off+1); range begin/end columns
        carry (key, len, -1) so their rank ignores versions."""
        qall = np.full((W + 2, P + 2 * R), PAD_WORD, np.int32)
        qall[W:] = I32MAX
        rv = np.zeros(R, np.int32)

        def voffs(versions):
            return np.clip(
                np.fromiter(versions, np.int64, count=len(versions))
                - self._vbase, 0, _OFF_LIMIT,
            ).astype(np.int32)

        if points:
            n = len(points)
            words, lens = pack_keys([k for k, _ in points], W)
            qall[:W, :n] = words.T
            qall[W, :n] = lens
            # lower_bound at (k, v+1): predecessor = last entry <= v
            qall[W + 1, :n] = voffs([v for _, v in points]) + 1
        if ranges:
            n = len(ranges)
            bw, bl = pack_keys([r[0] for r in ranges], W)
            ew, el = pack_keys([r[1] for r in ranges], W)
            qall[:W, P: P + n] = bw.T
            qall[W, P: P + n] = bl
            qall[:W, P + R: P + R + n] = ew.T
            qall[W, P + R: P + R + n] = el
            qall[W + 1, P: P + 2 * R] = -1
            rv[:n] = voffs([r[2] for r in ranges])
        return qall, rv

    def read_verdicts(self, handle: ReadHandle):
        """The sync site: wait for the aux vector's D2H, then pure-host
        materialization. Returns (point_values, range_rows)."""
        if handle.consumed:
            raise ValueError("read handle already consumed")
        handle.consumed = True
        t0 = _pc()
        if handle._event is not None:
            handle._event.synchronize()
        aux = handle._aux.numpy()
        handle._keep = None
        self.last_d2h_ms = (_pc() - t0) * 1e3
        P, R, S = handle.P, handle.R, handle.S
        values = handle.values
        o = 0

        def take(n, shape=None):
            nonlocal o
            part = aux[o: o + n]
            o += n
            return part.reshape(shape) if shape is not None else part

        pt_found, pt_slot, pt_ver = take(P), take(P), take(P)
        pt_dfound, pt_dslot, pt_dver = take(P), take(P), take(P)
        rb, re = take(R), take(R)
        drb, dre = take(R), take(R)
        vis, sslot, sver = (take(R * S, (R, S)) for _ in range(3))
        dvis, dsslot, dsver = (take(R * S, (R, S)) for _ in range(3))

        out_points: list[Optional[bytes]] = []
        for i in range(len(handle.points)):
            cand = None  # (version offset, value); delta wins ties
            if pt_found[i]:
                cand = (int(pt_ver[i]), values[int(pt_slot[i])][1])
            if pt_dfound[i] and (cand is None or int(pt_dver[i]) >= cand[0]):
                cand = (int(pt_dver[i]), values[int(pt_dslot[i])][1])
            out_points.append(None if cand is None else cand[1])

        out_ranges = []
        for i, (begin, end, ver, limit, reverse) in enumerate(handle.ranges):
            if int(re[i] - rb[i]) > S or int(dre[i] - drb[i]) > S:
                # span wider than the gather cap: the host oracle answers
                self.c_span_fallbacks.add(1)
                out_ranges.append(self._oracle.get_range(
                    begin, end, ver, limit, reverse))
                continue
            merged: dict[bytes, tuple[int, Optional[bytes]]] = {}
            for j in range(S):
                if vis[i, j]:
                    k, val = values[int(sslot[i, j])]
                    merged[k] = (int(sver[i, j]), val)
            for j in range(S):
                if dvis[i, j]:
                    k, val = values[int(dsslot[i, j])]
                    prev = merged.get(k)
                    if prev is None or int(dsver[i, j]) >= prev[0]:
                        merged[k] = (int(dsver[i, j]), val)
            rows = [(k, v) for k, (_, v) in sorted(merged.items())
                    if v is not None]
            if reverse:
                rows.reverse()
            if limit:
                rows = rows[:limit]
            out_ranges.append(rows)
        return out_points, out_ranges

    def register_metrics(self, registry=None, labels=()) -> None:
        """Per-engine read metrics on the process MetricRegistry: batch
        shape, stage samples, cadence counters (StorageServer.
        register_metrics calls this)."""
        from ..core.metrics import global_registry

        reg = registry if registry is not None else global_registry()
        lbl = tuple(labels)
        for name, c in (
            ("storage.gpu.point_reads", self.c_point_reads),
            ("storage.gpu.range_reads", self.c_range_reads),
            ("storage.gpu.batches", self.c_batches),
            ("storage.gpu.span_fallbacks", self.c_span_fallbacks),
            ("storage.gpu.compactions", self.c_compactions),
            ("storage.gpu.delta_folds", self.c_delta_folds),
        ):
            reg.register_counter(name, c, labels=lbl, replace=True)
        for name, fn in (
            ("storage.gpu.entries", lambda: self._n_base),
            ("storage.gpu.delta_fill_entries",
             lambda: len(self._delta_keys)),
            ("storage.gpu.blocks_count", lambda: self.NB),
            ("storage.gpu.last_batch_width_count",
             lambda: self.last_batch_width),
            ("storage.gpu.last_pack_ms", lambda: self.last_pack_ms),
            ("storage.gpu.last_dispatch_ms", lambda: self.last_dispatch_ms),
            ("storage.gpu.last_d2h_ms", lambda: self.last_d2h_ms),
        ):
            reg.register_gauge(name, fn, labels=lbl, replace=True)


def decode_set_columns(batch):
    """Decode a TaggedMutationBatch's SET-only entries into (version, keys,
    values) triples straight off its columns (cumsum offsets over the
    shared blob, no per-mutation objects). Returns None when any row is
    not SET_VALUE (the caller takes the object path)."""
    from ..kv.atomic import MutationType

    if len(batch.m_types) and not bool(
        (batch.m_types == int(MutationType.SET_VALUE)).all()
    ):
        return None
    p1l = batch.p1_len.astype(np.int64)
    p2l = batch.p2_len.astype(np.int64)
    p1_off = np.concatenate([[0], np.cumsum(p1l)])
    p2_off = p1_off[-1] + np.concatenate([[0], np.cumsum(p2l)])
    blob = batch.blob
    out = []
    at = 0
    for e in range(batch.n_entries):
        n = int(batch.row_counts[e])
        keys = [bytes(blob[p1_off[at + j]: p1_off[at + j + 1]])
                for j in range(n)]
        vals = [bytes(blob[p2_off[at + j]: p2_off[at + j + 1]])
                for j in range(n)]
        out.append((int(batch.versions[e]), keys, vals))
        at += n
    return out
