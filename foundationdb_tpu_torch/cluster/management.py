"""Management API: operator actions as ordinary transactions on the
system keyspace (ref: fdbclient/ManagementAPI.actor.cpp — configure,
exclude/include, coordinators; everything is \\xff key writes that the
proxy's metadata-apply path interprets)."""

from __future__ import annotations

from typing import Iterable

from .system_data import (
    config_key,
    decode_excluded_server_key,
    excluded_server_key,
    excluded_servers_range,
)


async def exclude_servers(db, tags: Iterable[int]) -> None:
    """Mark storage servers excluded: DD drains their data and stops
    placing new shards on them (ref: excludeServers,
    ManagementAPI.actor.cpp:908 — writes excludedServersPrefix keys)."""
    tags = list(tags)

    async def body(tr):
        tr.options.set_access_system_keys()
        for t in tags:
            tr.set(excluded_server_key(t), b"")

    await db.transact(body)


async def include_servers(db, tags: Iterable[int] = None) -> None:
    """Clear exclusions (all of them when tags is None), re-admitting the
    servers for placement (ref: includeServers :1006)."""
    tags = None if tags is None else list(tags)

    async def body(tr):
        tr.options.set_access_system_keys()
        if tags is None:
            r = excluded_servers_range()
            tr.clear_range(r.begin, r.end)
        else:
            for t in tags:
                tr.clear(excluded_server_key(t))

    await db.transact(body)


async def get_excluded_servers(db) -> set[int]:
    async def body(tr):
        tr.options.set_read_system_keys()
        r = excluded_servers_range()
        rows = await tr.get_range(r.begin, r.end)
        return {decode_excluded_server_key(k) for k, _ in rows}

    return await db.transact(body)


async def move_machine(db, cluster, machine_id: str,
                       timeout_s: float = 120.0) -> dict:
    """Drain one machine end-to-end and retire it (ref: the fdbcli
    exclude-then-remove operator flow, generalized to every role a
    machine hosts — the `moveMachine` verb the ROADMAP's self-healing
    item owed):

      1. EXCLUDE its storage replicas (ordinary \\xff writes): data
         distribution re-seeds every team off them through move_keys —
         the excluded servers stay live and donate during the drain.
      2. DEMOTE its logs: mark the machine draining and force a
         recovery; the recovery hook re-recruits each log slot onto a
         ranked replacement machine and re-replicates the tail with the
         RETIRING copy itself as a donor (zero acked-write loss at any
         log replication mode — this is what distinguishes a drain from
         a death).
      3. Re-place the transaction bundle if it lives here (the ordinary
         recovery ranker, which now skips the draining machine).
      4. RETIRE: role-free, forgotten by the registry, never placed or
         restored again.

    Returns a summary dict. Needs the machine fault topology
    (cluster.sim_topology) and, when the machine hosts storage, a
    running data distributor."""
    from ..core.errors import OperationFailed
    from ..core.runtime import current_loop
    from ..core.trace import TraceEvent

    topo = getattr(cluster, "sim_topology", None)
    if topo is None:
        raise OperationFailed(
            "move_machine needs the machine fault topology "
            "(cluster.sim_topology)"
        )
    m = next((mm for mm in topo.machines if mm.name == machine_id), None)
    if m is None:
        raise OperationFailed(
            f"unknown machine {machine_id!r} "
            f"(have: {[mm.name for mm in topo.machines]})"
        )
    if m.protected:
        raise OperationFailed(
            f"machine {machine_id} hosts coordinators; move the "
            "coordination quorum first"
        )
    if not m.alive or m.retired:
        raise OperationFailed(f"machine {machine_id} is not live")
    loop = current_loop()
    deadline = loop.now() + timeout_s
    summary = {"machine": machine_id,
               "excluded_storage": sorted(m.storage_tags),
               "demoted_logs": sorted(m.log_ids)}
    m.draining = True
    try:
        # -- 1. storage: exclude + wait for DD to re-seed every team --
        if m.storage_tags:
            if getattr(cluster, "dd", None) is None:
                raise OperationFailed(
                    "machine hosts storage but data distribution is not "
                    "running (start_data_distribution first)"
                )
            await exclude_servers(db, sorted(m.storage_tags))
            while loop.now() < deadline:
                held = {t for t in m.storage_tags
                        if any(t in team
                               for team in cluster.shard_map.teams())}
                if not held:
                    break
                await loop.delay(0.25)
            else:
                raise OperationFailed(
                    f"storage drain of {machine_id} did not finish "
                    f"within {timeout_s}s (teams still reference "
                    f"{sorted(held)})"
                )
            # Decommission the drained replicas: excluded, team-free and
            # data-free — the machine no longer hosts them (the reference
            # removes excluded storage processes the same way; the
            # standing exclusion keeps DD from ever re-teaming the tags).
            for t in sorted(m.storage_tags):
                cluster.storages[t].stop()
            m.storage_tags.clear()
        # -- 2 + 3. logs + txn bundle: one forced recovery re-recruits
        #    both (the hook replaces draining-machine logs with the live
        #    copy as donor; the ranker skips draining machines) --
        if m.log_ids or m.has_txn:
            cluster.kill_transaction_system()
            while loop.now() < deadline:
                try:
                    cluster._recover()
                except BaseException as e:  # noqa: BLE001 — stalled
                    TraceEvent("MoveMachineRecoveryRetry",
                               severity=20).error(e).log()
                if not m.log_ids and not m.has_txn \
                        and cluster.proxy is not None:
                    break
                await loop.delay(0.5)
            else:
                raise OperationFailed(
                    f"log/txn demotion of {machine_id} did not finish "
                    f"within {timeout_s}s"
                )
    finally:
        m.draining = False
    topo.retire_machine(m)
    summary["retired"] = True
    TraceEvent("MachineMoved").detail("Machine", machine_id).detail(
        "Storage", len(summary["excluded_storage"])
    ).detail("Logs", len(summary["demoted_logs"])).log()
    return summary


async def configure(db, **settings) -> None:
    """Set replicated configuration values, e.g.
    configure(db, redundancy_mode="triple", logs=4) (ref: changeConfig,
    ManagementAPI.actor.cpp:62 — writes \\xff/conf/ keys)."""

    async def body(tr):
        tr.options.set_access_system_keys()
        for name, value in settings.items():
            tr.set(config_key(name), str(value).encode())

    await db.transact(body)


async def get_configuration(db) -> dict:
    from .system_data import CONF_PREFIX, EXCLUDED_PREFIX, decode_config_key

    async def body(tr):
        tr.options.set_read_system_keys()
        rows = await tr.get_range(CONF_PREFIX, CONF_PREFIX + b"\xff")
        out = {}
        for k, v in rows:
            if k.startswith(EXCLUDED_PREFIX):
                continue
            out[decode_config_key(k)] = v.decode()
        return out

    return await db.transact(body)
