"""Machine-readable cluster status (ref: fdbserver/Status.actor.cpp — the
status JSON assembled by the cluster controller and served to fdbcli /
operators; schema documented in mr-status.rst).

A subset of the reference schema covering what this cluster has: role
breakdown with per-role counters, version state, workload totals, and the
simulator/fault context when present."""

from __future__ import annotations

from typing import Any

from ..core.runtime import current_loop


def cluster_status(cluster) -> dict[str, Any]:
    if hasattr(cluster, "storages"):
        return _sharded_status(cluster)
    return _local_status(cluster)


def _metrics_block() -> dict[str, Any]:
    """The `metrics` block (both tiers): a registry summary plus the
    process-health gauges (SystemMonitor ProcessMetrics surfaced through
    the registry) — the per-process half every scrape also sees."""
    from ..core.metrics import global_registry
    from ..core.system_monitor import process_metrics_status

    block = global_registry().status_block()
    block["process"] = process_metrics_status()
    return block


def _base_status(master, proxy) -> dict[str, Any]:
    """Shared scaffolding of both tiers' status (client block, version
    state, workload totals) — one place to evolve the schema."""
    loop = current_loop()
    committed = proxy.txns_committed
    conflicted = proxy.txns_conflicted + proxy.txns_too_old
    return {
        "client": {
            "database_status": {"available": True},
            "cluster_file": {"up_to_date": True},
        },
        "cluster": {
            "latest_version": master.version,
            "committed_version": master.committed.get(),
            "recovery_state": {"name": "fully_recovered"},
            "machine_time": loop.now(),
            "simulated": loop.is_simulated(),
            "workload": {
                "transactions": {
                    "committed": committed,
                    "conflicted": conflicted,
                    "started": committed + conflicted,
                }
            },
            "metrics": _metrics_block(),
        },
    }


def _proxy_role_status(proxy) -> dict[str, Any]:
    """One proxy's status block, shared by both tiers: commit counters
    plus the commit-plane pipeline breakdown (CommitProxy.
    commit_pipeline_status — grv/form/resolve/tlog stage p50+p99 and the
    live/measured in-flight commit-version depth, mirroring the resolver
    block PR 7 added)."""
    d: dict[str, Any] = {
        "role": "proxy",
        "txns_committed": proxy.txns_committed,
        "txns_conflicted": proxy.txns_conflicted,
        "txns_too_old": proxy.txns_too_old,
    }
    if hasattr(proxy, "commit_pipeline_status"):
        d["commit_pipeline"] = proxy.commit_pipeline_status()
    return d


def _resolver_role_status(resolver, idx: int | None = None) -> dict[str, Any]:
    """One resolver's status block, shared by both tiers: counters plus
    the per-stage pipeline timing breakdown (ResolverRole.pipeline_status)."""
    d: dict[str, Any] = {
        "role": "resolver",
        "version": resolver.version.get(),
        "conflict_batches": resolver.conflict_batches,
        "total_transactions": resolver.total_transactions,
        "conflict_transactions": resolver.conflict_transactions,
        "conflict_set": type(resolver.cs).__name__,
    }
    if idx is not None:
        d["id"] = idx
    if hasattr(resolver, "pipeline_status"):
        d["pipeline"] = resolver.pipeline_status()
    return d


def _sharded_status(cluster) -> dict[str, Any]:
    """Status for the sharded/replicated tier: per-server storage roles,
    per-log queues, the shard map, DD progress, and replicated config
    (ref: the data-distribution and configuration sections of
    mr-status.rst)."""
    master = cluster.master
    proxy = cluster.proxy
    ls = cluster.log_system

    roles: list[dict[str, Any]] = [
        {
            "role": "master",
            "latest_version": master.version,
            "committed_version": master.committed.get(),
        },
        _proxy_role_status(proxy),
    ]
    # Resolver fleet with the pipeline observability block: per-stage
    # pack/h2d/device/d2h p50+p99 and the live/measured in-flight depth —
    # the ROADMAP bar "h2d+pack < 20% of batch latency" read off a
    # running cluster instead of a bench.
    for i, r in enumerate(getattr(cluster, "resolvers", None)
                          or [cluster.resolver]):
        if not hasattr(r, "conflict_batches"):
            continue  # remote handle: stats live on the resolver host
        roles.append(_resolver_role_status(r, idx=i))
    # Per-log-set roles: the serving set plus (two-region clusters) the
    # remote set, each log with its durable-version LAG behind the
    # highest version the set has received — the number an operator
    # watches to see a wiped/behind replica catching back up.
    log_sets = getattr(ls, "log_sets", None) or [ls.logs]
    for set_idx, log_set in enumerate(log_sets):
        set_top = max((log.version.get() for log in log_set), default=0)
        for i, log in enumerate(log_set):
            roles.append({
                "role": "log",
                "id": i,
                "log_set": set_idx,
                "serving": set_idx == getattr(ls, "active_set", 0),
                "version": log.version.get(),
                "durable_version": log.durable.get(),
                "durable_lag_versions": set_top - log.quorum_durable(),
                "reachable": getattr(log, "reachable", True),
                "queue_entries": len(log._entries)
                + getattr(log, "spilled_entries", 0),
            })
    durable = ls.durable_version()
    for s in cluster.storages:
        role = {
            "role": "storage",
            "tag": s.tag,
            "data_version": s.version.get(),
            "keys": len(s.data),
            "durability_lag_versions": durable - s.version.get(),
            "excluded": s.tag in cluster.excluded,
            "stored_bytes_estimate": int(s.metrics.byte_sample.total),
        }
        if hasattr(s, "read_bands"):
            role["read_latency_bands"] = s.read_bands.status()
        roles.append(role)

    from ..kv.keys import KEYSPACE_END

    shards = [
        {"begin": b.hex(), "end": (e if e is not None else KEYSPACE_END).hex(),
         "team": list(team)}
        for b, e, team in cluster.shard_map.ranges()
        if team
    ]
    dd = getattr(cluster, "dd", None)
    data_distribution = {
        "shards": len(shards),
        "teams": [list(t) for t in sorted(cluster.shard_map.teams())],
        "moves_done": dd.moves_done if dd else 0,
        "splits_done": dd.splits_done if dd else 0,
        "merges_done": dd.merges_done if dd else 0,
        "unplaceable_servers": sorted(dd._unplaceable()) if dd else
        sorted(cluster.excluded),
    }

    st = _base_status(master, proxy)
    state = getattr(cluster, "recovery_state", None)
    if state:
        st["cluster"]["recovery_state"] = {"name": state}
    topo = getattr(cluster, "sim_topology", None)
    if topo is not None:
        # The recruitment lifecycle over the machine topology: registry
        # workers (per-machine heartbeat leases) + any active stalls —
        # an active stall IS the recovery state (recovery is parked in
        # recruiting_<role> until a worker registers).
        st["cluster"]["recruitment"] = topo.registry.status()
        # Per-machine placement + lifecycle (drain/retire state, re-homed
        # slots): what `cli.py move-machine` is verified against.
        st["cluster"]["machines"] = topo.machines_status()
        stalls = sorted(topo.registry.stalls)
        if stalls:
            st["cluster"]["recovery_state"] = {
                "name": f"recruiting_{stalls[0]}"
            }
    st["cluster"].update({
        "configuration": {
            "redundancy_mode": cluster.policy.describe(),
            "logs": len(ls.logs),
            # k-way log replication (per log set): mode + the policy's
            # replica count, so `status json` shows what a destroyed
            # datadir is allowed to cost (nothing, for k >= 2).
            "log_replication": getattr(ls, "log_replication", "single"),
            "log_replication_factor": getattr(ls, "rep_factor", 1),
            "regions": len(log_sets) > 1,
            "storage_servers": len(cluster.storages),
            "values": dict(cluster.config_values),
            "excluded_servers": sorted(cluster.excluded),
        },
        "data_distribution": data_distribution,
        "shards": shards,
        "roles": roles,
    })
    if len(log_sets) > 1:
        # Remote-DC shipping observability: how far the LogRouters'
        # shipped floor trails what committers have been acked — the
        # failover gate (lock refuses to fail over while lag > 0, or an
        # acked write would be stranded on the dark primary).
        shipped = ls.shipped_version()
        st["cluster"]["regions"] = {
            "failed_over": bool(getattr(ls, "failed_over", False)),
            "active_set": getattr(ls, "active_set", 0),
            "shipped_version": shipped,
            "remote_pull_lag_versions": max(
                0, getattr(ls, "_acked_floor", 0) - shipped
            ),
            "routers": [
                {"index": r.index, "shipped": r.shipped,
                 "batches_shipped": r.batches_shipped}
                for r in getattr(cluster, "log_routers", [])
            ],
        }
    return st


def multiprocess_status(host) -> dict[str, Any]:
    """Status JSON of a DEPLOYED multiprocess cluster, assembled by the
    controller (txn host) and served over ClusterStatusRequest — what an
    operator shell attached via `cli.py --cluster-file` renders (ref:
    the cluster controller assembling status for fdbcli,
    Status.actor.cpp). Mid-stall there is no proxy/master: the document
    still answers, recovery_state names the parked recruitment, and the
    recruitment block shows the registry the stall is waiting on."""
    loop = current_loop()
    p = host.proxy
    m = host.master
    committed = p.txns_committed if p is not None else 0
    conflicted = ((p.txns_conflicted + p.txns_too_old)
                  if p is not None else 0)
    roles: list[dict[str, Any]] = []
    if m is not None:
        roles.append({
            "role": "master",
            "latest_version": m.version,
            "committed_version": m.committed.get(),
        })
    if p is not None:
        roles.append(_proxy_role_status(p))
    return {
        "client": {
            "database_status": {"available": p is not None},
            "cluster_file": {"up_to_date": True},
        },
        "cluster": {
            "generation": host.generation,
            "recoveries_done": host.recoveries_done,
            "recovery_state": {"name": host.recovery_state},
            "latest_version": m.version if m is not None else 0,
            "machine_time": loop.now(),
            "simulated": loop.is_simulated(),
            "workload": {
                "transactions": {
                    "committed": committed,
                    "conflicted": conflicted,
                    "started": committed + conflicted,
                }
            },
            "recruitment": host._recruitment_status(),
            "metrics": _metrics_block(),
            # Protocol-skew visibility (the typed 1109 path): a mixed-
            # version fleet shows up HERE instead of as a silent
            # reconnect loop in the logs.
            "incompatible_connections": getattr(
                host.transport, "incompatible_connections", 0
            ),
            "incompatible_peers": dict(getattr(
                host.transport, "incompatible_peers", {}
            )),
            "configuration": {
                "logs": host.n_logs,
                "storage_servers": host.n_storage,
                "resolvers": host.n_resolvers,
                "values": dict(host.config_values),
                "excluded_servers": sorted(host.excluded),
            },
            "roles": roles,
        },
    }


def _local_status(cluster) -> dict[str, Any]:
    master = cluster.master
    resolver = cluster.resolver
    proxy = cluster.proxy
    storage = cluster.storage
    tlog = cluster.tlog

    roles = [
        {
            "role": "master",
            "latest_version": master.version,
            "committed_version": master.committed.get(),
        },
        dict(_proxy_role_status(proxy),
             commit_batches_in_flight=len(proxy.commit_stream)),
        _resolver_role_status(resolver),
        {
            "role": "log",
            "version": tlog.version.get(),
            "durable_version": tlog.durable.get(),
            "popped_version": tlog.popped,
            "queue_entries": len(tlog._entries)
            + getattr(tlog, "spilled_entries", 0),
        },
        {
            "role": "storage",
            "data_version": storage.version.get(),
            "oldest_version": storage.oldest_version,
            "keys": len(storage.data),
            "durability_lag_versions": (
                tlog.durable.get() - storage.version.get()
            ),
            "active_watches": len(storage._watches),
            "read_latency_bands": storage.read_bands.status(),
        },
    ]

    st = _base_status(master, proxy)
    st["cluster"]["generation"] = 1  # recovery generations are the
    # RecoverableCluster tier; the one-process cluster has a single epoch
    st["cluster"]["roles"] = roles
    return st
