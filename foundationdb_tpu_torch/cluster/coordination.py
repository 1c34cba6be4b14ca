"""Coordination: quorum-replicated generation registers + leader election
(ref: fdbserver/Coordination.actor.cpp:125 localGenerationReg,
CoordinatedState.actor.cpp read/write quorum state machine,
LeaderElection.actor.cpp:78 tryBecomeLeaderInternal).

The coordinators are the cluster's root of trust: a small set of register
servers answering two-phase reads/writes with generation numbers, so that
a new master generation can fence out every older one (split-brain safety)
without any single server being trusted. The protocol here is the
reference's (Paxos-flavored, specialized to a single register):

  read(gen):   quorum of coordinators bump their read-generation to `gen`
               and return their (value, write_generation); the reader takes
               the value with the highest write generation.
  write(gen, v): quorum accepts iff `gen` >= their read/write generations;
               any later read(gen') with gen' > gen observes it.

A candidate that reads with a fresh generation and then writes with it is
guaranteed: either its write succeeds at a quorum (it owns the epoch) or a
newer generation has been seen (it must retire). Leader election layers a
lease on top: the elected leader's identity + lease expiry live in the
registers, heartbeats extend the lease, and a candidate may only take over
after the lease lapses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from ..core.errors import OperationFailed
from ..core.runtime import current_loop
from ..core.trace import TraceEvent


@dataclass
class _RegState:
    read_gen: int = 0
    write_gen: int = 0
    value: Any = None


class CoordinatorRegister:
    """One register server hosting KEYED generation registers (ref:
    localGenerationReg serves a keyspace of registers — leader seat,
    cluster state — not one slot). In-memory here; its state durability
    story rides the storage-engine tier the same way the reference's rides
    OnDemandStore."""

    def __init__(self, name: str):
        self.name = name
        self.regs: dict[str, _RegState] = {}
        self.available = True  # fault hook for tests

    def _reg(self, key: str) -> _RegState:
        s = self.regs.get(key)
        if s is None:
            s = self.regs[key] = _RegState()
        return s

    def read(self, key: str, gen: int) -> tuple[Any, int]:
        from ..core.runtime import buggify

        if not self.available or buggify("coordinator_read_blip", 0.05):
            raise OperationFailed(f"coordinator {self.name} unavailable")
        s = self._reg(key)
        s.read_gen = max(s.read_gen, gen)
        return s.value, s.write_gen

    def write(self, key: str, gen: int, value: Any) -> bool:
        from ..core.runtime import buggify

        if not self.available or buggify("coordinator_write_blip", 0.05):
            raise OperationFailed(f"coordinator {self.name} unavailable")
        s = self._reg(key)
        if gen < s.read_gen or gen < s.write_gen:
            return False
        s.write_gen = gen
        s.value = value
        return True


class FileCoordinatorRegister(CoordinatorRegister):
    """Disk-backed register server (ref: the coordinators' OnDemandStore —
    fdbserver/Coordination.actor.cpp persisting generations to disk so a
    restarted coordinator keeps its promises).

    Every accepted read promise and write is persisted (write-to-temp +
    fsync + rename) BEFORE it is acknowledged: a restarted register can
    never accept a write an earlier incarnation promised away, which is
    the whole safety story of the generation protocol. Values that aren't
    JSON-serializable (live endpoint interfaces) are kept in memory only —
    they are meaningless across a restart by construction.
    """

    def __init__(self, name: str, path: str):
        super().__init__(name)
        self.path = path
        self._load()

    def _load(self) -> None:
        import json
        import os

        if not os.path.exists(self.path):
            return
        with open(self.path) as f:
            raw = json.load(f)
        for key, (rg, wg, value) in raw.items():
            self.regs[key] = _RegState(rg, wg, value)

    def _persist(self) -> None:
        import json
        import os

        out = {}
        for key, s in self.regs.items():
            try:
                json.dumps(s.value)
                value = s.value
            except TypeError:
                value = None  # transient (live interfaces): gens still kept
            out[key] = [s.read_gen, s.write_gen, value]
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(out, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def read(self, key: str, gen: int) -> tuple[Any, int]:
        s = self._reg(key)
        bump = gen > s.read_gen
        out = super().read(key, gen)
        if bump:
            self._persist()  # the read PROMISE must survive restart
        return out

    def write(self, key: str, gen: int, value: Any) -> bool:
        ok = super().write(key, gen, value)
        if ok:
            self._persist()
        return ok


class SharedFileCoordinatorRegister(FileCoordinatorRegister):
    """A register server SHARED by several OS processes (multiple
    controller candidates — txn hosts on different machines — arbitrating
    one leader seat; ref: the coordinators being their own processes that
    every candidate talks to). Each read/write re-loads the on-disk state
    under an exclusive advisory lock and persists before releasing it, so
    concurrent candidates observe a single linearizable register: a
    promise one candidate's read installed can never be forgotten when
    another candidate's write arrives. The generation protocol above
    (CoordinatedState.read_modify_write) handles interleavings between
    the two ops of a transition, exactly as it does for remote register
    servers."""

    def _locked(self):
        import contextlib
        import fcntl

        @contextlib.contextmanager
        def ctx():
            with open(self.path + ".lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                self.regs.clear()
                self._load()
                yield

        return ctx()

    def read(self, key: str, gen: int) -> tuple[Any, int]:
        with self._locked():
            return super().read(key, gen)

    def write(self, key: str, gen: int, value: Any) -> bool:
        with self._locked():
            return super().write(key, gen, value)


class CoordinatedState:
    """Client side of the quorum protocol for ONE keyed register (ref:
    CoordinatedState + ReusableCoordinatedState, masterserver.actor.cpp:78)."""

    def __init__(self, coordinators: list[CoordinatorRegister], key: str = "state"):
        self.coordinators = coordinators
        self.key = key
        self.quorum = len(coordinators) // 2 + 1
        # Freshness floor: generations must beat every generation this
        # client has OBSERVED, not just its own clock. Two candidate
        # processes share no clock origin (RealClock is process-relative),
        # so a late-started candidate learns the incumbent's generation
        # height from read replies (and from failed writes, exponentially)
        # instead of never catching up to it.
        self._gen_floor = 0

    def _fresh_gen(self) -> int:
        # Monotone, collision-avoiding generation: sim-time tick + entropy,
        # floored by the highest generation observed from the registers.
        loop = current_loop()
        base = int(loop.now() * 1_000_000) * 64 + loop.random.random_int(0, 64)
        return max(base, self._gen_floor)

    def read(self, gen: int) -> Any:
        """Quorum read at `gen`; returns the value with the highest write
        generation among responders."""
        best, best_gen, ok = None, -1, 0
        for c in self.coordinators:
            try:
                value, wgen = c.read(self.key, gen)
            except OperationFailed:
                continue
            ok += 1
            if wgen > best_gen:
                best, best_gen = value, wgen
        if ok < self.quorum:
            raise OperationFailed("coordination quorum unavailable for read")
        self._gen_floor = max(self._gen_floor, best_gen + 1)
        return best

    def write(self, gen: int, value: Any) -> bool:
        """Quorum write at `gen`. False = fenced by a newer generation."""
        accepted, reachable = 0, 0
        for c in self.coordinators:
            try:
                if c.write(self.key, gen, value):
                    accepted += 1
                reachable += 1
            except OperationFailed:
                continue
        if reachable < self.quorum:
            raise OperationFailed("coordination quorum unavailable for write")
        return accepted >= self.quorum

    def read_modify_write(self, update) -> tuple[int, Any]:
        """One fenced transition: read current, apply `update`, write —
        retrying with a fresher generation when raced. Returns (gen, new)."""
        while True:
            gen = self._fresh_gen()
            current = self.read(gen)
            new = update(current)
            if self.write(gen, new):
                return gen, new
            # Raced by a newer generation (or an orphaned read promise a
            # dead candidate left above every write): re-read with a
            # strictly higher floor so convergence is logarithmic, never
            # a livelock against a promise no reply will ever name.
            self._gen_floor = max(self._gen_floor * 2,
                                  self._gen_floor + 64, gen + 1)


@dataclass
class LeaderLease:
    leader: str
    epoch: int
    expires: float


class LeaderElection:
    """Lease-based election over the coordinated state (ref:
    tryBecomeLeaderInternal's nominee + heartbeat loop).

    The default lease rides the failure-detection horizon
    (FAILURE_TIMEOUT_DELAY, read live): the controller seat and the
    worker leases it arbitrates recruitment by should age on the same
    clock — a takeover faster than failure detection would recruit
    against a registry that still believes the old world."""

    def __init__(self, cstate: CoordinatedState,
                 lease_seconds: Optional[float] = None):
        self.cstate = cstate
        self._lease_seconds = lease_seconds

    @property
    def lease_seconds(self) -> float:
        if self._lease_seconds is not None:
            return self._lease_seconds
        from ..core.knobs import SERVER_KNOBS

        return SERVER_KNOBS.FAILURE_TIMEOUT_DELAY

    def try_become_leader(self, who: str) -> Optional[LeaderLease]:
        """Claim leadership if the seat is free or the lease lapsed.
        Returns the lease when `who` is (now) the leader, else None."""
        loop = current_loop()

        def update(cur):
            if (
                cur is not None
                and cur.leader != who
                and cur.expires > loop.now()
            ):
                return cur  # live leader elsewhere: no change
            if cur is None:
                epoch = 1
            elif cur.leader == who:
                epoch = cur.epoch  # renewing our own seat
            else:
                epoch = cur.epoch + 1  # taking over a lapsed seat
            return LeaderLease(
                leader=who, epoch=epoch,
                expires=loop.now() + self.lease_seconds,
            )

        _, new = self.cstate.read_modify_write(update)
        if new.leader == who:
            TraceEvent("LeaderElected").detail("Leader", who).detail(
                "Epoch", new.epoch
            ).log()
            return new
        return None

    def heartbeat(self, lease: LeaderLease) -> Optional[LeaderLease]:
        """Extend the lease; None = deposed (a newer epoch took over)."""
        loop = current_loop()

        def update(cur):
            if cur is None or cur.leader != lease.leader or cur.epoch != lease.epoch:
                return cur  # deposed: leave the register alone
            return LeaderLease(
                leader=lease.leader, epoch=lease.epoch,
                expires=loop.now() + self.lease_seconds,
            )

        _, new = self.cstate.read_modify_write(update)
        if new is not None and new.leader == lease.leader and new.epoch == lease.epoch:
            return new
        return None
