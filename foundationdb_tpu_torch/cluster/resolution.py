"""Multi-resolver resolution: proxy-side range split, verdict merge, and
master-driven boundary rebalancing (ref: ResolutionRequestBuilder,
fdbserver/MasterProxyServer.actor.cpp:233-312 clipping each transaction's
conflict ranges per resolver; the phase-3 verdict merge :431-447; and
resolutionBalancing, fdbserver/masterserver.actor.cpp:896, fed by the
resolvers' key-load samples, Resolver.actor.cpp:148-152).

Design notes (TPU-framework redesign, not a port):

- Boundaries partition the NORMAL keyspace [b"", b"\\xff"); the system
  keyspace [\\xff, \\xff\\xff) always belongs to resolver 0 (the
  reference pins system ranges to the first resolver the same way), so
  metadata conflict ordering has a single home.

- A boundary move is correct WITHOUT state transfer because of
  transition dual-routing: for a full OCC write-life window after the
  move, the moved range's clips go to BOTH the old owner (which holds
  the pre-move write history — it catches conflicts against old writes)
  and the new owner (which accumulates the post-move history). The
  verdict merge is max, so either detector aborts the transaction.
  After MAX_WRITE_TRANSACTION_LIFE_VERSIONS every snapshot old enough to
  conflict with a pre-move write is TOO_OLD anyway, and the transition
  expires by pure version comparison — no coordination.

- Transitions and boundaries live in one shared ResolverConfig object;
  proxies consult it per batch with the batch's commit version, so every
  window is routed under a single consistent view.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from ..core.knobs import SERVER_KNOBS
from ..core.trace import TraceEvent
from ..kv.keys import KeyRange
from ..resolver.types import TxnConflictInfo

NORMAL_KEYSPACE_END = b"\xff"
SYSTEM_KEYSPACE_END = b"\xff\xff"


@dataclass
class Transition:
    """One in-flight boundary move: `range` moved old -> new at
    `move_version`; dual-routed while version <= until_version."""

    lo: bytes
    hi: bytes
    old_idx: int
    new_idx: int
    until_version: int


class ResolverConfig:
    """The partition of the key space over N resolvers, plus in-flight
    transitions. Shared by every proxy of a generation (single view)."""

    def __init__(self, boundaries: Sequence[bytes]):
        self.boundaries = list(boundaries)  # within [b"", \xff)
        self.transitions: list[Transition] = []

    @property
    def n_resolvers(self) -> int:
        return len(self.boundaries) + 1

    def ranges(self) -> list[tuple[bytes, bytes]]:
        """Current (lo, hi) of each resolver index over the normal
        keyspace; resolver 0 additionally owns [\\xff, \\xff\\xff)."""
        edges = [b""] + self.boundaries + [NORMAL_KEYSPACE_END]
        return list(zip(edges, edges[1:]))

    def coverage(self, idx: int, version: int) -> list[tuple[bytes, bytes]]:
        """Every range resolver `idx` must judge at `version`: its
        current range, the system keyspace for resolver 0, and any range
        transitioning AWAY from it that is still inside its dual-routing
        window."""
        segs = [self.ranges()[idx]]
        if idx == 0:
            segs.append((NORMAL_KEYSPACE_END, SYSTEM_KEYSPACE_END))
        for t in self.transitions:
            if t.old_idx == idx and version <= t.until_version:
                segs.append((t.lo, t.hi))
        return segs

    def expire(self, version: int) -> None:
        self.transitions = [
            t for t in self.transitions if version <= t.until_version
        ]

    def move_boundary(self, boundary_idx: int, new_key: bytes,
                      move_version: int) -> None:
        """Move one split point (ref: resolutionBalancing's
        ResolutionSplitRequest): the range between old and new key
        changes owner between the two adjacent resolvers; the loser
        dual-routes it for a write-life window."""
        old_key = self.boundaries[boundary_idx]
        if new_key == old_key:
            return
        lo, hi = min(old_key, new_key), max(old_key, new_key)
        if new_key < old_key:
            # Left neighbor shrinks: [new, old) moves left -> right+1.
            old_idx, new_idx = boundary_idx, boundary_idx + 1
        else:
            # Right neighbor shrinks: [old, new) moves right+1 -> left.
            old_idx, new_idx = boundary_idx + 1, boundary_idx
        until = move_version + SERVER_KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS
        self.boundaries[boundary_idx] = new_key
        self.transitions.append(
            Transition(lo, hi, old_idx, new_idx, until)
        )
        TraceEvent("ResolutionBoundaryMoved").detail(
            "Boundary", boundary_idx
        ).detail("From", repr(old_key)).detail("To", repr(new_key)).detail(
            "DualRouteUntil", until
        ).log()


def clip_txns(txns: Sequence[TxnConflictInfo],
              segs: Sequence[tuple[bytes, bytes]]) -> list[TxnConflictInfo]:
    """Clip every txn's conflict ranges to the union of `segs` (ref:
    ResolutionRequestBuilder::addTransaction forwarding each range,
    clipped, to every resolver it overlaps)."""

    def clips(r: KeyRange):
        for lo, hi in segs:
            if lo <= r.begin and r.end <= hi:
                # inside the segment: the range itself (KeyRange is frozen)
                if r.begin < r.end:
                    yield r
                continue
            b, e = max(r.begin, lo), min(r.end, hi)
            if b < e:
                yield KeyRange(b, e)

    out = []
    for t in txns:
        rr = [c for r in t.read_ranges for c in clips(r)]
        wr = [c for w in t.write_ranges for c in clips(w)]
        out.append(TxnConflictInfo(t.read_snapshot, rr, wr))
    return out


class ResolutionBalancer:
    """Master-side boundary rebalancer (ref: resolutionBalancing,
    masterserver.actor.cpp:896): compares per-resolver load since the
    last tick; when the spread exceeds the threshold, moves the boundary
    between the busiest resolver and a lighter neighbor to the busiest
    one's median sampled key."""

    def __init__(self, config: ResolverConfig, resolvers,
                 ratio_threshold: float = 2.0, min_load: int = 64):
        self.config = config
        self.resolvers = resolvers
        self.ratio = ratio_threshold
        self.min_load = min_load
        self._last = [0] * len(resolvers)
        self.moves = 0

    def step(self, current_version: int) -> bool:
        """One balancing decision; returns True if a boundary moved."""
        self.config.expire(current_version)
        loads = []
        for i, r in enumerate(self.resolvers):
            total = r.keys_resolved
            loads.append(total - self._last[i])
            self._last[i] = total
        if not loads or max(loads) < self.min_load:
            return False
        hi = max(range(len(loads)), key=lambda i: loads[i])
        # Lighter ADJACENT neighbor (boundaries only move between
        # neighbors; repeated ticks diffuse load across the chain).
        neighbors = [i for i in (hi - 1, hi + 1) if 0 <= i < len(loads)]
        lo = min(neighbors, key=lambda i: loads[i])
        if loads[lo] * self.ratio > loads[hi]:
            return False
        sample = self.resolvers[hi].key_sample()
        b_idx = min(hi, lo)  # the boundary between the two
        lo_key, hi_key = self.config.ranges()[hi]
        inside = [k for k in sample if lo_key <= k < hi_key]
        if len(inside) < 4:
            return False
        inside.sort()
        split = inside[len(inside) // 2]
        if lo < hi:
            # Give the LOWER part of the busiest range to the left
            # neighbor: boundary moves UP to the median.
            new_key = split
        else:
            # Give the upper part to the right neighbor.
            new_key = split
        if new_key in (lo_key, hi_key) or new_key == self.config.boundaries[b_idx]:
            return False
        self.config.move_boundary(b_idx, new_key, current_version)
        self.moves += 1
        return True
