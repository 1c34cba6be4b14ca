"""ConflictRange: the conflict-detection adversary (ref:
fdbserver/workloads/ConflictRange.actor.cpp — random explicit conflict
ranges whose commit/abort outcomes are cross-checked against an oracle).

Shape: take one GRV; issue a WAVE of transactions all reading at that
snapshot with random explicit read-conflict ranges and random writes,
committed one at a time. Later transactions in the wave conflict with
earlier committed writes iff a read range overlaps one — exactly the
resolver's job, including range/point overlap edge cases and the
conservative multi-resolver clipping. The oracle is the in-repo
ConflictSetCPU fed the same transactions at synthetic versions, so the
REAL pipeline (proxy clipping, multi-resolver merge, TPU kernel if
configured) is differentially tested end to end."""

from __future__ import annotations

from ..client.database import Database
from ..core.runtime import current_loop
from ..kv.keys import KeyRange
from ..resolver.cpu import ConflictSetCPU
from ..resolver.types import TxnConflictInfo


class ConflictRangeWorkload:
    """`oracle_boundaries` — pass the cluster's resolver boundaries to
    get a BIT-EXACT differential against the sharded oracle (which
    reproduces the multi-resolver conservative-abort asymmetry: writes of
    globally-aborted txns enter the shard histories of resolvers that
    judged them committed — extra conflicts, never missed ones). Without
    them the check is one-sided: a cluster COMMIT where the oracle says
    abort is always a bug; a cluster abort where the oracle says commit
    is counted as a conservative abort (legal under multi-resolver or
    in-flight boundary moves)."""

    def __init__(self, db: Database, key_space: int = 48,
                 prefix: bytes = b"cr/", oracle_boundaries=None):
        self.db = db
        self.key_space = key_space
        self.prefix = prefix
        self.oracle_boundaries = (
            list(oracle_boundaries) if oracle_boundaries else None
        )
        self.failures: list[str] = []
        self.waves_done = 0
        self.txns_done = 0
        self.conflicts_seen = 0
        self.conservative_aborts = 0

    def _key(self, rng, i=None) -> bytes:
        i = rng.random_int(0, self.key_space) if i is None else i
        return self.prefix + b"%04d" % i

    def _ranges(self, rng, n_max: int) -> list[KeyRange]:
        out = []
        for _ in range(rng.random_int(1, n_max + 1)):
            a = rng.random_int(0, self.key_space)
            b = a + rng.random_int(1, 6)
            out.append(KeyRange(self._key(rng, a), self._key(rng, b)))
        return out

    async def run(self, waves: int = 12, wave_size: int = 6) -> None:
        rng = current_loop().random
        for _ in range(waves):
            await self._one_wave(rng, wave_size)
            self.waves_done += 1

    async def _one_wave(self, rng, wave_size: int) -> None:
        from ..core.errors import NotCommitted, is_retryable

        # Shared snapshot for the whole wave.
        snap_tr = self.db.create_transaction()
        snapshot = await snap_tr.get_read_version()

        # The oracle mirrors the wave at synthetic versions: snapshot=S,
        # commits at S+1.. in submission order (sequential submission
        # makes the order — and therefore the expected verdicts —
        # deterministic).
        if self.oracle_boundaries is not None:
            from ..resolver.sharded import ShardedConflictSetCPU

            oracle = ShardedConflictSetCPU(self.oracle_boundaries)
        else:
            oracle = ConflictSetCPU(0)
        S = 100
        plans = []
        for _ in range(wave_size):
            plans.append((self._ranges(rng, 3), self._ranges(rng, 2)))

        oracle_version = S
        for i, (reads, writes) in enumerate(plans):
            tr = self.db.create_transaction()
            tr.set_read_version(snapshot)
            for r in reads:
                tr.add_read_conflict_range(r.begin, r.end)
            for w in writes:
                tr.add_write_conflict_range(w.begin, w.end)
            # A data write so committed effects are observable (and so
            # the txn is not read-only).
            tr.set(self.prefix + b"out/%d" % i, b"x")

            committed = True
            try:
                await tr.commit()
            except NotCommitted:
                committed = False
            except BaseException as e:  # noqa: BLE001
                if is_retryable(e):
                    return  # fault window (recovery): drop the wave
                raise

            oracle_version += 1
            want = oracle.resolve(
                oracle_version, 0,
                [TxnConflictInfo(S, tuple(reads), tuple(writes))],
            ).statuses[0]
            want_committed = want == 0
            self.txns_done += 1
            if not committed:
                self.conflicts_seen += 1
            if committed and not want_committed:
                # A missed conflict is ALWAYS a resolver bug.
                self.failures.append(
                    f"wave {self.waves_done} txn {i}: cluster committed "
                    f"where the oracle says abort "
                    f"(reads={reads} writes={writes})"
                )
            elif not committed and want_committed:
                if self.oracle_boundaries is not None:
                    # The sharded oracle reproduces the legal asymmetry:
                    # any remaining divergence is a real bug.
                    self.failures.append(
                        f"wave {self.waves_done} txn {i}: cluster aborted "
                        f"where the matched sharded oracle says commit "
                        f"(reads={reads} writes={writes})"
                    )
                else:
                    self.conservative_aborts += 1

    async def check(self) -> bool:
        # A wave-based adversary that never observes a conflict isn't
        # testing the resolver; the parameters above make conflicts
        # overwhelmingly likely across a run.
        if self.txns_done >= 30 and self.conflicts_seen == 0:
            self.failures.append("no conflicts exercised (degenerate run)")
        return not self.failures
