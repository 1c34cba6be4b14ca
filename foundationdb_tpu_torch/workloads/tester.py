"""Spec-driven compound test runner (ref: fdbserver/tester.actor.cpp —
`runWorkload` drives every workload of a spec through setup/start/check
phases concurrently; specs are flat key=value files like
tests/fast/CycleTest.txt, where a correctness workload runs WHILE fault
workloads clog and kill).

A spec here is a dict:

    {"seed": 7, "buggify": True,
     "cluster": {"kind": "sharded", "n_storage": 4, "n_logs": 2,
                 "replication": "double"},
     "workloads": [
         {"name": "Cycle", "nodes": 20, "clients": 4, "txns": 25},
         {"name": "RandomMoveKeys", "interval": 0.4},
         {"name": "DataDistribution"},
     ]}

run_spec builds the cluster, runs every workload's start phase
concurrently, then every check phase; the result carries per-workload
metrics and the final ConsistencyCheck verdict. Deterministic per seed.

The port's copy of foundationdb_tpu/workloads/tester.py. `run_spec(spec,
device=None)` and `run_restart_spec(spec, device=None)` build every
cluster on `device` (None: the CUDA card, which must be present; "cpu"
runs the device backends' plain torch versions), so the knob-chosen
ConflictSetGPU and KeyValueStoreGPU are recruited on the card, durable
clusters' windows restored there from disk.
"""

from __future__ import annotations

from typing import Any

from ..core import loop_context, sim_loop
from ..core.actors import all_of
from ..core.runtime import spawn
from ..core.trace import TraceEvent, global_sink


class SpecError(ValueError):
    pass


class _AttritionWorkload:
    """Periodic transaction-system kills (ref: workloads/MachineAttrition —
    which also waits for the cluster to heal between kills)."""

    def __init__(self, cluster, interval: float, kills: int,
                 name: str = "attrition-cc"):
        self.cluster = cluster
        self.interval = interval
        self.max_kills = kills
        self.name = name
        self.kills_done = 0
        self._baseline = 0
        self._task = None
        self._stopping = False

    def start(self):
        # Unique controller name per instance: LeaderElection arbitrates
        # BY NAME, so two candidates sharing one name would both believe
        # they hold the lease.
        self.cluster.start_controller(self.name)
        self._baseline = self.cluster.recoveries_done
        self._task = spawn(self._run(), name="attrition")
        return self

    def stop(self):
        self._stopping = True

    async def wait_stopped(self):
        if self._task is not None:
            await self._task.done

    async def _kill_and_await_recovery(self, loop):
        target = self._baseline + self.kills_done + 1
        self.cluster.kill_transaction_system()
        self.kills_done += 1
        # Wait for the recovery before the next kill — killing an
        # already-dead system is a no-op that would desync the count
        # (the reference workload heals between kills too).
        deadline = loop.now() + 60.0
        while self.cluster.recoveries_done < target and loop.now() < deadline:
            await loop.delay(0.1)

    async def _run(self):
        from ..core.runtime import current_loop

        loop = current_loop()
        while not self._stopping and self.kills_done < self.max_kills:
            await loop.delay(self.interval * (0.7 + 0.6 * loop.random.random01()))
            if self._stopping:
                break
            await self._kill_and_await_recovery(loop)
        if self.kills_done == 0 and self.max_kills > 0:
            # The workloads outran the first interval: still exercise at
            # least one kill+recovery (that is the workload's purpose).
            # kills: 0 means "present but disabled" and is honored.
            await self._kill_and_await_recovery(loop)

    async def check(self) -> bool:
        if self.max_kills == 0:
            return self.kills_done == 0
        return (
            self.kills_done >= 1
            and self.cluster.recoveries_done
            >= self._baseline + self.kills_done
        )


async def _run_workloads(cluster, db, spec) -> dict[str, Any]:
    from .conflict_range import ConflictRangeWorkload
    from .consistency_check import ConsistencyCheckWorkload
    from .cycle import CycleWorkload
    from .fuzz_api import FuzzApiWorkload
    from .perf import QueuePushWorkload, ThroughputWorkload
    from .random_move_keys import RandomMoveKeysWorkload
    from .read_write import ReadWriteWorkload
    from .serializability import SerializabilityWorkload
    from .watches import WatchesWorkload
    from .write_during_read import WriteDuringReadWorkload

    results: dict[str, Any] = {}
    starters = []   # (name, coroutine-future) start phases to await
    stoppers = []   # background workloads: (stop, wait_stopped|None)
    checkers = []   # (result_key, async check(), metrics())

    seen_names: dict[str, int] = {}
    for w in spec.get("workloads", []):
        name = w["name"]
        # Duplicate stanzas keep distinct result entries (specs routinely
        # run e.g. two ReadWrite mixes).
        idx = seen_names.get(name, 0)
        seen_names[name] = idx + 1
        rkey = name if idx == 0 else f"{name}#{idx}"
        if name == "Cycle":
            wl = CycleWorkload(db, nodes=w.get("nodes", 16))
            await wl.setup()
            starters.append((rkey, spawn(wl.start(
                clients=w.get("clients", 4),
                txns_per_client=w.get("txns", 25),
            )).done))
            checkers.append((rkey, wl.check,
                             lambda wl=wl: {"txns": wl.txns_done,
                                            "retries": wl.retries}))
        elif name == "Serializability":
            wl = SerializabilityWorkload(db)
            starters.append((rkey, spawn(wl.run(
                clients=w.get("clients", 4),
                txns_per_client=w.get("txns", 20),
            )).done))
            checkers.append((rkey, wl.check,
                             lambda wl=wl: {"txns": wl.txns_done,
                                            "retries": wl.retries}))
        elif name == "ReadWrite":
            wl = ReadWriteWorkload(db, key_space=w.get("key_space", 1000))
            starters.append((rkey, spawn(wl.run(
                clients=w.get("clients", 8),
                duration=w.get("duration", 3.0),
            )).done))
            checkers.append((rkey, None, wl.metrics))
        elif name == "RandomMoveKeys":
            if not hasattr(cluster, "shard_map"):
                raise SpecError("RandomMoveKeys needs a sharded cluster")
            wl = RandomMoveKeysWorkload(
                cluster, interval=w.get("interval", 0.3)
            )
            wl.require_progress = w.get("require_progress", True)
            wl.start()
            stoppers.append((wl.stop, wl.wait_stopped))
            checkers.append((rkey, wl.check,
                             lambda wl=wl: {"moves": wl.moves_done}))
        elif name == "Watches":
            wl = WatchesWorkload(db, pairs=w.get("pairs", 8),
                                 rounds=w.get("rounds", 3))
            starters.append((rkey, spawn(wl.run()).done))
            checkers.append((rkey, wl.check,
                             lambda wl=wl: {"fires": wl.fires,
                                            "wrong": wl.wrong_fires}))
        elif name == "Attrition":
            # Kill the transaction system on an interval; the controller
            # must recover each generation (ref: MachineAttrition.actor.cpp
            # — kills DURING the correctness workloads).
            if not hasattr(cluster, "kill_transaction_system"):
                raise SpecError("Attrition needs a recoverable cluster")
            wl = _AttritionWorkload(
                cluster, interval=w.get("interval", 1.0),
                kills=w.get("kills", 2), name=f"attrition-cc-{rkey}",
            ).start()
            stoppers.append((wl.stop, wl.wait_stopped))
            checkers.append((rkey, wl.check,
                             lambda wl=wl: {"kills": wl.kills_done}))
        elif name == "ConflictRange":
            wl = ConflictRangeWorkload(db, key_space=w.get("key_space", 48))
            starters.append((rkey, spawn(wl.run(
                waves=w.get("waves", 12),
                wave_size=w.get("wave_size", 6),
            )).done))
            checkers.append((rkey, wl.check,
                             lambda wl=wl: {"txns": wl.txns_done,
                                            "conflicts": wl.conflicts_seen,
                                            "failures": wl.failures[:3]}))
        elif name == "WriteDuringRead":
            wl = WriteDuringReadWorkload(
                db, key_space=w.get("key_space", 30)
            )
            starters.append((rkey, spawn(wl.run(
                txns=w.get("txns", 30),
                ops_per_txn=w.get("ops", 12),
            )).done))
            checkers.append((rkey, wl.check,
                             lambda wl=wl: {"ops": wl.ops_done,
                                            "txns": wl.txns_done,
                                            "failures": wl.failures[:3]}))
        elif name == "FuzzApi":
            wl = FuzzApiWorkload(db)
            starters.append((rkey, spawn(wl.run(
                rounds=w.get("rounds", 3),
            )).done))
            checkers.append((rkey, wl.check,
                             lambda wl=wl: {"probes": wl.probes_done,
                                            "failures": wl.failures[:3]}))
        elif name == "Throughput":
            wl = ThroughputWorkload(db, key_space=w.get("key_space", 400))
            starters.append((rkey, spawn(wl.run(
                clients=w.get("clients", 8),
                duration=w.get("duration", 3.0),
            )).done))
            checkers.append((rkey, None, wl.metrics))
        elif name == "QueuePush":
            wl = QueuePushWorkload(
                db, value_bytes=w.get("value_bytes", 512)
            )
            starters.append((rkey, spawn(wl.run(
                clients=w.get("clients", 4),
                duration=w.get("duration", 3.0),
            )).done))
            checkers.append((rkey, None, wl.metrics))
        elif name == "VersionStamp":
            from .more import VersionStampWorkload

            wl = VersionStampWorkload(db)
            starters.append((rkey, spawn(wl.run(
                clients=w.get("clients", 3), txns=w.get("txns", 8),
            )).done))
            checkers.append((rkey, wl.check,
                             lambda wl=wl: {"acked": wl.acked,
                                            "failures": wl.failures[:3]}))
        elif name == "Rollback":
            from .more import RollbackWorkload

            if not hasattr(cluster, "kill_transaction_system"):
                raise SpecError("Rollback needs a recoverable cluster")
            wl = RollbackWorkload(db, cluster)
            starters.append((rkey, spawn(wl.run(
                writes=w.get("writes", 12),
                kill_every=w.get("kill_every", 4),
            )).done))
            checkers.append((rkey, wl.check,
                             lambda wl=wl: {"acked": len(wl.acked),
                                            "failures": wl.failures[:3]}))
        elif name == "BackupRestore":
            from .more import BackupRestoreWorkload

            wl = BackupRestoreWorkload(db)
            starters.append((rkey, spawn(wl.run(
                snapshots=w.get("snapshots", 2),
            )).done))
            checkers.append((rkey, wl.check,
                             lambda wl=wl: {"snapshots": len(wl.images),
                                            "failures": wl.failures[:3]}))
        elif name == "RebootStorage":
            # Machine-level reboot (ref: sim2's machine reboot,
            # fdbrpc/sim2.actor.cpp:1217 — stop a process WITHOUT state
            # loss, then bring it back): a random storage replica stops
            # serving, reads hedge to its teammates, and on restart it
            # catches up from its log cursor. Requires replication >
            # single or reads would stall.
            if not hasattr(cluster, "storages"):
                raise SpecError("RebootStorage needs a sharded cluster")

            async def reboot_loop(n=w.get("reboots", 2),
                                  interval=w.get("interval", 0.6)):
                from ..core import delay
                from ..core.runtime import current_loop

                loop = current_loop()
                done = 0
                for _ in range(n):
                    await delay(interval * (0.5 + loop.random.random01()))
                    s = cluster.storages[
                        loop.random.random_int(0, len(cluster.storages))
                    ]
                    TraceEvent("SimRebootStorage").detail(
                        "Tag", getattr(s, "tag", -1)
                    ).log()
                    s.stop()
                    await delay(0.2 + 0.3 * loop.random.random01())
                    s.start()
                    done += 1
                return done

            starters.append((rkey, spawn(reboot_loop()).done))
            checkers.append((rkey, None, lambda w=w: {
                "reboots": w.get("reboots", 2)
            }))
        elif name == "MachineAttrition":
            # Machine/DC shared-fate kills + swizzled clogs off the
            # topology (sim/topology.py; ref: MachineAttrition.actor.cpp
            # at machine granularity). Needs the cluster spec to carry a
            # "topology" stanza so the roles are placed on machines.
            from .attrition import MachineAttritionWorkload

            topo = getattr(cluster, "sim_topology", None)
            if topo is None:
                raise SpecError(
                    "MachineAttrition needs cluster.topology (e.g. "
                    '"topology": {"n_dcs": 3, "machines_per_dc": 2}) on a '
                    "recoverable_sharded cluster"
                )
            wl = MachineAttritionWorkload(
                topo,
                interval=w.get("interval", 0.8),
                kills=w.get("kills", 2),
                reboots=w.get("reboots", 1),
                swizzles=w.get("swizzles", 1),
                dc_kills=w.get("dc_kills", 0),
                permanent_kills=w.get("permanent_kills", 0),
                permanent_log_kills=w.get("permanent_log_kills", 0),
                permanent_storage_kills=w.get(
                    "permanent_storage_kills", 0),
                outage=w.get("outage", 0.4),
                power_loss=w.get("power_loss", False),
                name=f"machine-attrition-{rkey}",
            ).start()
            starters.append((rkey, wl.done))
            checkers.append((rkey, wl.check, wl.metrics))
        elif name == "RemoveServersSafely":
            # Exclude-then-verify against DD (ref: RemoveServersSafely.
            # actor.cpp): needs the sharded data plane + a distributor.
            from .remove_servers_safely import RemoveServersSafelyWorkload

            if not hasattr(cluster, "storages"):
                raise SpecError("RemoveServersSafely needs a sharded "
                                "cluster")
            wl = RemoveServersSafelyWorkload(
                cluster, db, excludes=w.get("excludes", 1),
                drain_timeout=w.get("drain_timeout", 45.0),
                hold_time=w.get("hold_time", 1.0),
            )
            starters.append((rkey, spawn(wl.run()).done))
            checkers.append((rkey, wl.check, wl.metrics))
        elif name == "TargetedKill":
            # Role-aimed machine kills (ref: TargetedKill.actor.cpp):
            # needs the machine fault topology for role placement.
            from .targeted_kill import TargetedKillWorkload

            topo = getattr(cluster, "sim_topology", None)
            if topo is None:
                raise SpecError(
                    "TargetedKill needs cluster.topology on a "
                    "recoverable_sharded cluster"
                )
            wl = TargetedKillWorkload(
                topo, roles=w.get("roles", ["log", "storage", "txn"]),
                interval=w.get("interval", 0.8),
                outage=w.get("outage", 0.4),
                name=f"targeted-kill-{rkey}",
            ).start()
            starters.append((rkey, wl.done))
            checkers.append((rkey, wl.check, wl.metrics))
        elif name == "RandomClogging":
            # First-class clogging workload over sim/network.py (ref:
            # RandomClogging.actor.cpp incl. the swizzle).
            from .random_clogging import RandomCloggingWorkload

            topo = getattr(cluster, "sim_topology", None)
            if topo is None:
                raise SpecError(
                    "RandomClogging needs cluster.topology on a "
                    "recoverable_sharded cluster"
                )
            wl = RandomCloggingWorkload(
                topo, interval=w.get("interval", 0.5),
                clogs=w.get("clogs", 2), pairs=w.get("pairs", 1),
                swizzles=w.get("swizzles", 1),
                max_clog=w.get("max_clog", 0.8),
            ).start()
            starters.append((rkey, wl.done))
            checkers.append((rkey, wl.check, wl.metrics))
        elif name == "BackupAttrition":
            # TaskBucket lease-takeover soak: mortal backup agents under
            # a killing nemesis must lose no ranges.
            from .backup_attrition import BackupAttritionWorkload

            wl = BackupAttritionWorkload(
                db, keys=w.get("keys", 48), tasks=w.get("tasks", 8),
                agents=w.get("agents", 3), kills=w.get("kills", 3),
                deadline=w.get("deadline", 40.0),
            )
            starters.append((rkey, spawn(wl.run()).done))
            checkers.append((rkey, wl.check, wl.metrics))
        elif name == "StatusWorkload":
            # Status-schema probe mid-chaos (ref: StatusWorkload.actor.cpp
            # — the document must render AND conform while the fault
            # workloads run; see workloads/status_workload.py).
            from .status_workload import StatusWorkload

            wl = StatusWorkload(cluster, interval=w.get("interval", 0.3),
                                fetches=w.get("fetches", 5))
            starters.append((rkey, spawn(wl.run()).done))
            checkers.append((rkey, wl.check,
                             lambda wl=wl: {"fetches": wl.fetches_done,
                                            "violations": wl.failures[:3]}))
        elif name == "Increment":
            # Atomic-add ledger whose grand total must balance exactly
            # (ref: Increment.actor.cpp) — reference-corpus round 3.
            from .increment import IncrementWorkload

            wl = IncrementWorkload(db, key_space=w.get("key_space", 8))
            starters.append((rkey, spawn(wl.run(
                clients=w.get("clients", 3),
                txns_per_client=w.get("txns", 15),
            )).done))
            checkers.append((rkey, wl.check,
                             lambda wl=wl: {"txns": wl.txns_done,
                                            "ambiguous": wl.ambiguous,
                                            "retries": wl.retries}))
        elif name == "LowLatency":
            # Bounded-latency GRV+read canary probing WHILE the spec's
            # nemeses run (ref: LowLatency.actor.cpp); probes that ride
            # through a recovery are exempt from the bound.
            from .low_latency import LowLatencyWorkload

            wl = LowLatencyWorkload(
                db, cluster=cluster, probes=w.get("probes", 10),
                interval=w.get("interval", 0.3),
                max_latency=w.get("max_latency", 5.0),
            )
            starters.append((rkey, spawn(wl.run()).done))
            checkers.append((rkey, wl.check, wl.metrics))
        elif name == "SyntheticFault":
            # Deliberate, deterministic failure injection for the swarm
            # machinery itself (tools/swarm.py + tools/distill.py): the
            # distiller and the regression-corpus replay need a failure
            # that is a pure function of the spec. Modes map onto the
            # three failure classes the sweep distinguishes: "crash"
            # raises out of the spec, "sev_error" emits a SevError trace
            # event, "check_fail" (default) fails its check phase.
            mode = w.get("mode", "check_fail")
            if w.get("arm", True) and mode == "crash":
                raise RuntimeError("SyntheticFault: injected crash")

            async def _synthetic_check(mode=mode, armed=w.get("arm", True)):
                if not armed:
                    return True
                if mode == "sev_error":
                    TraceEvent("SyntheticFault", severity=40).detail(
                        "Mode", mode
                    ).log()
                    return True
                return False

            checkers.append((rkey, _synthetic_check,
                             lambda w=w: {"mode": w.get("mode",
                                                        "check_fail")}))
        elif name == "DataDistribution":
            dd = cluster.start_data_distribution(
                interval=w.get("interval", 0.2)
            )
            checkers.append((rkey, None,
                             lambda dd=dd: {"moves": dd.moves_done,
                                            "splits": dd.splits_done,
                                            "merges": dd.merges_done}))
        else:
            raise SpecError(f"unknown workload {name!r}")

    if starters:
        await all_of([f for _, f in starters])
    # Graceful stop: in-flight moves complete before checks (a cancelled
    # half-move would fail the closing ConsistencyCheck spuriously).
    for stop, _ in stoppers:
        stop()
    for _, wait in stoppers:
        if wait is not None:
            await wait()

    ok = True
    for rkey, check, metrics in checkers:
        entry: dict[str, Any] = {"metrics": metrics()}
        if check is not None:
            entry["ok"] = bool(await check())
            ok = ok and entry["ok"]
        results[rkey] = entry

    # The closing ConsistencyCheck every sharded spec gets for free (ref:
    # the harness appending ConsistencyCheck to -f specs).
    if hasattr(cluster, "storages"):
        from ..core import delay

        await delay(1.0)  # let replicas drain their tags
        dd = getattr(cluster, "dd", None)
        if dd is not None:
            # DD (and the topology's storage tracker feeding it) keeps
            # healing after the nemesis's closing heal — late lease
            # lapses re-seed teams off machines that died near the end.
            # The replica compare below must not race a half-move's
            # union team: quiesce first (mover idle, no unplaceable
            # member left in any team), bounded so a wedged move still
            # surfaces as the check failure it is.
            from ..core.runtime import current_loop

            loop = current_loop()
            deadline = loop.now() + 60.0
            while loop.now() < deadline:
                bad = dd._unplaceable()
                dirty = any(
                    t in bad
                    for _b, _e, team in cluster.shard_map.ranges()
                    for t in team
                )
                if not cluster.move_keys_lock._held and not dirty:
                    break
                await delay(0.25)
        cc = ConsistencyCheckWorkload(cluster)
        results["ConsistencyCheck"] = {"ok": bool(await cc.check()),
                                       "failures": cc.failures}
        ok = ok and results["ConsistencyCheck"]["ok"]
        # Final keyspace fingerprint: same seed ⇒ same kill schedule ⇒
        # same final state — the chaos specs' reproducibility contract
        # is checked by comparing this across reruns.
        results["fingerprint"] = await _keyspace_fingerprint(cluster)
    results["ok"] = ok
    results["coverage"] = _coverage_summary(cluster)
    return results


def _coverage_summary(cluster) -> dict[str, Any]:
    """Structured per-run coverage: the trace event types the run emitted,
    the recovery states the cluster passed through, and the metric names
    registered on this loop's registry — all deterministic per seed, the
    raw material of the swarm's coverage signature
    (sim/config.coverage_facets folds these in alongside the spec's
    shape/knob/workload draws)."""
    from ..core.metrics import global_registry

    return {
        "trace_event_types": sorted(global_sink().type_counts()),
        "recovery_states": sorted(
            getattr(cluster, "recovery_states_seen", ())
        ),
        "metric_names": sorted(global_registry().names()),
    }


async def _keyspace_fingerprint(cluster) -> str:
    """Injective digest of the settled keyspace, read shard-by-shard from
    each team's first replica (the closing ConsistencyCheck has already
    proven the replicas identical)."""
    import hashlib

    from ..kv.keys import KEYSPACE_END

    target = max(s.version.get() for s in cluster.storages)
    for s in cluster.storages:
        await s.version.when_at_least(target)
    h = hashlib.sha256()
    for b, e, team in cluster.shard_map.ranges():
        if not team:
            continue
        e = e if e is not None else KEYSPACE_END
        for k, v in cluster.storages[team[0]].data.get_range(b, e, target):
            h.update(b"%d:%b=%d:%b;" % (len(k), k, len(v), v))
    return h.hexdigest()


def _apply_knobs(overrides: dict):
    """Apply spec knob overrides ("server:NAME" / "client:NAME" -> value);
    returns an undo callable (specs must not leak knobs into later runs —
    the reference's simulated knob randomization is per-process)."""
    from ..core.knobs import CLIENT_KNOBS, SERVER_KNOBS

    regs = {"server": SERVER_KNOBS, "client": CLIENT_KNOBS}
    saved = []

    def undo():
        for reg, name, old in saved:
            setattr(reg, name, old)

    try:
        for key, value in (overrides or {}).items():
            reg_name, _, name = key.partition(":")
            if reg_name not in regs:
                raise SpecError(f"knob key {key!r}: registry must be "
                                "'server' or 'client'")
            reg = regs[reg_name]
            saved.append((reg, name, getattr(reg, name)))
            reg.set_knob(name, str(value))
    except BaseException:
        undo()  # a partial apply must not leak into later runs
        raise
    return undo


def run_restart_spec(spec: dict, device=None) -> dict[str, Any]:
    """tests/restarting/ analogue: phase 1 runs its workloads on a
    DURABLE cluster over a datadir, the incarnation shuts down, and
    phase 2 boots a FRESH incarnation (new loop, new cluster object —
    the restarted-binary seam) from the preserved datadir. The runner
    fingerprints the full keyspace at the end of phase 1 and verifies
    the rebooted cluster serves the identical state before phase 2's
    workloads mutate it.

    Spec: {"seed", "buggify", "cluster": {"kind": "restart", "engine",
    "n_storage", ...}, "datadir": path, "phases": [{"workloads": [...]},
    {"workloads": [...]}]}.

    Upgrade seams (ref: the reference's restart tests booting old-format
    state into new binaries under IncludeVersion, flow/serialize.h:195):

    - a phase may carry "format_version": N — that incarnation runs with
      the DURABLE format lattice at revision N (readers accept N-1), so
      phase 2 at a bumped revision is 'the upgraded binary' reading phase
      1's stamped state bit-for-bit, and a phase at an OLDER revision
      than the stamps on disk refuses cleanly: the phase records
      refused_incompatible instead of corrupting, and later phases are
      skipped (specs/upgrade_cycle.json runs both directions);
    - a phase may carry "power_loss": true — it ends by POWER LOSS over
      a simulated disk (sim/nondurable.py page havoc; fsynced state
      survives, pending state is dropped/kept/corrupted by seeded coin
      flip) instead of a clean shutdown; the coordinator quorum is
      carried across incarnations as a separate protected failure
      domain. Requires the default memory engine.

    Every incarnation's cluster is built on `device` (None: the CUDA card,
    which must be present; "cpu" runs the device backends' plain torch
    versions): its storage windows are restored from disk onto it.
    """
    import hashlib
    import tempfile

    from ..core.errors import IncompatibleProtocolVersion
    from ..core.serialize import durable_format_override
    from ..device import resolve_device

    resolve_device(device)

    ckw = {k: v for k, v in spec.get("cluster", {}).items()
           if k != "kind"}
    if "shard_boundaries" in ckw:
        # JSON specs carry boundaries as strings (same as run_spec).
        ckw["shard_boundaries"] = [
            b.encode() if isinstance(b, str) else b
            for b in ckw["shard_boundaries"]
        ]
    phases = spec.get("phases", [])
    nondurable = any(p.get("power_loss") for p in phases)
    osl = None
    if nondurable:
        if ckw.get("engine", "memory") != "memory":
            raise SpecError("power_loss phases need the memory engine "
                            "(the simulated disk runs the Python tier)")
        from ..core.rand import DeterministicRandom
        from ..sim.nondurable import NonDurableOS

        osl = NonDurableOS(
            DeterministicRandom(spec.get("seed", 1) * 7919 + 13)
        )
        ckw["os_layer"] = osl
    owns_datadir = not spec.get("datadir") and osl is None
    datadir = spec.get("datadir") or tempfile.mkdtemp(prefix="fdbtpu_rs_")
    results: dict[str, Any] = {"datadir": datadir, "phases": []}
    fingerprint: list = [None]
    carried_coords: list = []  # power-loss runs: the protected quorum

    async def _fingerprint(db) -> str:
        async def read_all(tr):
            return await tr.get_range(b"", b"\xff")

        rows = await db.transact(read_all)
        h = hashlib.sha256()
        for k, v in rows:
            # BOTH fields length-prefixed: the encoding must be injective
            # or two different states could fingerprint identically.
            h.update(b"%d:%b=%d:%b;" % (len(k), k, len(v), v))
        return h.hexdigest()

    for phase_idx, phase in enumerate(phases):
        import gc

        from ..core.trace import TraceSink, set_global_sink

        gc.collect()  # same isolation contract as run_spec
        set_global_sink(TraceSink())
        undo_knobs = _apply_knobs(spec.get("knobs"))
        # The per-incarnation 'binary version': durable readers/stampers
        # run at this phase's revision for the phase's whole lifetime.
        undo_format = (durable_format_override(phase["format_version"])
                       if phase.get("format_version") else None)
        power_loss = bool(phase.get("power_loss"))
        loop = sim_loop(seed=spec.get("seed", 1) * 1000 + phase_idx,
                        buggify=spec.get("buggify", False))
        refused = False
        with loop_context(loop):
            async def main():
                from ..cluster.recovery import RecoverableShardedCluster

                kw = dict(ckw)
                if carried_coords:
                    kw["coordinators"] = carried_coords[0]
                cluster = RecoverableShardedCluster(
                    datadir=datadir, device=device, **kw
                ).start()
                if osl is not None and not carried_coords:
                    carried_coords.append(cluster.coordinators)
                db = cluster.database()
                carried_ok = True
                if phase_idx > 0:
                    # The restarted incarnation must serve the previous
                    # incarnation's durable state bit-for-bit BEFORE any
                    # new mutation.
                    carried_ok = (await _fingerprint(db)) == fingerprint[0]
                res = await _run_workloads(
                    cluster, db, {"workloads": phase.get("workloads", [])}
                )
                fingerprint[0] = await _fingerprint(db)
                if not power_loss:
                    # Power loss deliberately SKIPS the clean close: no
                    # final flush, no engine close — the disk keeps only
                    # what fsyncs covered (the havoc lands below, after
                    # the loop is torn down).
                    cluster.stop()
                res["state_carried"] = carried_ok
                return res

            try:
                pres = loop.run(main(), timeout_sim_seconds=3600)
            except IncompatibleProtocolVersion as e:
                # Downgrade refusal IS the contract: the incarnation
                # refuses to decode a newer on-disk format and leaves the
                # state untouched for a correctly-versioned binary.
                refused = True
                pres = {"ok": False, "refused_incompatible": True,
                        "state_carried": False,
                        "error": f"{type(e).__name__}: {e}"}
            finally:
                loop.shutdown()
                if undo_format is not None:
                    undo_format()
                undo_knobs()
        if power_loss and not refused:
            pres["power_loss"] = osl.kill()  # the page havoc, seeded
        pres["sev_errors"] = global_sink().error_count
        pres["sev_error_events"] = list(global_sink().error_events[:50])
        results["phases"].append(pres)
        if refused:
            break  # later phases would boot over state we refused to read

    results["ok"] = all(
        p.get("ok") and p.get("state_carried") and not p.get("sev_errors")
        for p in results["phases"]
    ) and len(results["phases"]) == len(phases)
    results["refused_incompatible"] = any(
        p.get("refused_incompatible") for p in results["phases"]
    )
    results["fingerprint"] = fingerprint[0]  # determinism-sweep contract
    results["sev_errors"] = sum(p["sev_errors"] for p in results["phases"])
    results["sev_error_events"] = [
        e for p in results["phases"] for e in p.get("sev_error_events", [])
    ][:50]
    # Coverage union across incarnations: the restart spec's signature
    # reflects everything ANY phase reached (phases that refused to boot
    # contribute nothing, which is itself signature-visible).
    results["coverage"] = {
        key: sorted({v for p in results["phases"]
                     for v in p.get("coverage", {}).get(key, ())})
        for key in ("trace_event_types", "recovery_states", "metric_names")
    }
    if owns_datadir:
        # Sweep hygiene: a datadir nobody named is a per-run scratch
        # disk (each rerun cold-boots a fresh one by construction).
        import shutil

        shutil.rmtree(datadir, ignore_errors=True)
    return results


def failure_summary(spec: dict, res: dict) -> dict[str, Any]:
    """Classify one spec run into a structured failure summary whose
    `class` string is the distiller's shrink-preserving fingerprint
    (tools/distill.py accepts a shrunken candidate only when the class
    survives; tools/swarm.py and tools/seed_sweep.py gate seeds on it).

    Classes, most- to least-specific:
      crash:<ExcType>   the run raised out of run_spec (res carries an
                        "error" string, "TypeName: message")
      sev:<Types>       SevError events beyond the spec's
                        `sev_error_allowlist` (or any at all when the
                        spec names none); uncaptured overflow past the
                        sink's retention counts as its own pseudo-type
      check:<keys>      workload check phases (or restart-phase
                        state-carry) reported False
      pass              the seed is green under the sweep's gate
    """
    allow = set(spec.get("sev_error_allowlist", ()))
    events = res.get("sev_error_events") or []
    offending = [e for e in events if e.get("Type") not in allow]
    uncaptured = (res.get("sev_errors") or 0) - len(events)
    if uncaptured > 0 and (allow or not events):
        offending.append({"Type": "<uncaptured>", "Count": uncaptured})

    failed_checks = sorted(
        k for k, v in res.items()
        if isinstance(v, dict) and v.get("ok") is False
    )
    for i, phase in enumerate(res.get("phases", [])):
        failed_checks.extend(
            f"phase{i}.{k}" for k, v in sorted(phase.items())
            if isinstance(v, dict) and v.get("ok") is False
        )
        if phase.get("state_carried") is False:
            failed_checks.append(f"phase{i}.state_carried")

    sev_types = sorted({e.get("Type", "?") for e in offending})
    if res.get("error"):
        cls = "crash:" + str(res["error"]).split(":", 1)[0]
    elif sev_types:
        cls = "sev:" + ",".join(sev_types)
    elif failed_checks or not res.get("ok"):
        cls = "check:" + ",".join(failed_checks or ["?"])
    else:
        cls = "pass"
    return {
        "class": cls,
        "ok": cls == "pass",
        "failed_checks": failed_checks,
        "offending_sev_types": sev_types,
        "error": res.get("error"),
    }


def run_spec(spec: dict, device=None) -> dict[str, Any]:
    """Run one spec in a fresh deterministic loop on `device` (None: the
    CUDA card; raises without one unless device="cpu"); returns results
    incl. per-workload metrics, overall ok, and the SevError count."""
    from ..core.trace import TraceSink, set_global_sink
    from ..device import resolve_device

    resolve_device(device)
    if spec.get("cluster", {}).get("kind") == "restart":
        return run_restart_spec(spec, device=device)

    # Flush pending garbage BEFORE the deterministic run starts: suspended
    # coroutines from earlier loops (tests, prior specs) must have their
    # GC close paths run NOW, not at a collector-chosen instant inside
    # this run (shutdown() below keeps this run from polluting the next).
    import gc

    gc.collect()
    # Fresh sink per spec: sev_errors must count THIS run only.
    set_global_sink(TraceSink())
    undo_knobs = _apply_knobs(spec.get("knobs"))
    loop = sim_loop(seed=spec.get("seed", 1),
                    buggify=spec.get("buggify", False))
    auto_datadir = None
    with loop_context(loop):
        async def main():
            nonlocal auto_datadir
            ckind = spec.get("cluster", {}).get("kind", "local")
            ckw = {k: v for k, v in spec.get("cluster", {}).items()
                   if k != "kind"}
            ckw["device"] = device
            if ckw.get("datadir") == "auto":
                # Engine-randomized configs (sim/config.py) run durably
                # over a per-RUN tmpdir: the printed spec stays the
                # repro, and a determinism rerun gets a fresh disk
                # instead of cold-booting the first run's files.
                import tempfile

                auto_datadir = tempfile.mkdtemp(prefix="fdbtpu_sim_")
                ckw["datadir"] = auto_datadir
            if "shard_boundaries" in ckw:
                # JSON specs carry boundaries as strings (same contract as
                # the multiprocess cluster file, _spec_kw).
                ckw["shard_boundaries"] = [
                    b.encode() if isinstance(b, str) else b
                    for b in ckw["shard_boundaries"]
                ]
            if ckind == "sharded":
                from ..cluster.sharded_cluster import ShardedKVCluster

                cluster = ShardedKVCluster(**ckw).start()
            elif ckind == "recoverable_sharded":
                from ..cluster.recovery import RecoverableShardedCluster

                cluster = RecoverableShardedCluster(**ckw).start()
                if ckw.get("topology") is not None:
                    # Machine/DC fault topology: role placement over
                    # SimMachines + a client database whose hops cross
                    # the simulated network (sim/topology.py).
                    from ..sim.topology import MachineTopology

                    cluster.sim_topology = MachineTopology(
                        cluster, **ckw["topology"]
                    )
            elif ckind == "local":
                from ..cluster.cluster import LocalCluster

                cluster = LocalCluster(**ckw).start()
            else:
                raise SpecError(f"unknown cluster kind {ckind!r}")
            topo = getattr(cluster, "sim_topology", None)
            db = topo.database() if topo is not None else cluster.database()
            try:
                return await _run_workloads(cluster, db, spec)
            finally:
                cluster.stop()

        try:
            results = loop.run(main(), timeout_sim_seconds=3600)
        finally:
            loop.shutdown()
            undo_knobs()
            if auto_datadir is not None:
                import shutil

                shutil.rmtree(auto_datadir, ignore_errors=True)
    # EXACT SevError accounting (TraceSink keeps a trim-immune record):
    # the count can no longer silently shrink on long runs whose event
    # window trimmed, and the events themselves ride the result so
    # tools/seed_sweep.py can allowlist expected types and PRINT the
    # offenders in its repro block.
    results["sev_errors"] = global_sink().error_count
    results["sev_error_events"] = list(global_sink().error_events[:50])
    return results
