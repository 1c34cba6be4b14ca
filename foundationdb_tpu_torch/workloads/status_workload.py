"""StatusWorkload: fetch `status json` mid-chaos and validate its shape
(ref: fdbserver/workloads/StatusWorkload.actor.cpp — the reference
fetches status against its checked-in schema WHILE the other workloads
run, because a status document that only renders on a healthy cluster is
useless exactly when an operator needs it).

The schema below is the checked-in contract of this repo's status
document (cluster/status.py both tiers' shared scaffolding plus the
observability blocks the flight recorder added: the proxy's
commit_pipeline latency bands and the resolver's pipeline block). The
validator is deliberately structural — required keys + types, lists
validated element-wise — so a field silently dropped or retyped by a
status refactor fails the workload, not an operator's dashboard.
"""

from __future__ import annotations

from typing import Any

from ..core.runtime import current_loop
from ..core.trace import TraceEvent

# -- the checked-in schema ---------------------------------------------------
# A schema node is: a type / tuple of types (isinstance check), a dict
# (required keys, each validated recursively — extra keys are allowed:
# the schema is a floor, not a ceiling), or ("list_of", node) validating
# every element.

_NUM = (int, float)

LATENCY_BANDS_SCHEMA = {"bands_ms": dict, "total": int}

# The cluster-wide `metrics` block (cluster/status._metrics_block): the
# MetricRegistry summary plus the SystemMonitor ProcessMetrics surfaced
# through it — validated mid-chaos so a status refactor cannot silently
# drop the process-health gauges the scrape plane also serves.
METRICS_SCHEMA = {
    "registered_count": int,
    "kinds": dict,
    "series_ticks": int,
    "process": {
        "resident_bytes": int,
        "open_fds": int,
        "user_cpu_seconds": _NUM,
        "system_cpu_seconds": _NUM,
        "loop_tasks": int,
        "slow_tasks": int,
    },
}

PROXY_ROLE_SCHEMA = {
    "role": str,
    "txns_committed": int,
    "txns_conflicted": int,
    "txns_too_old": int,
    "commit_pipeline": {
        "depth_configured": int,
        "in_flight": int,
        "max_in_flight_measured": int,
        "stages": dict,
        "latency_bands": {
            "grv": LATENCY_BANDS_SCHEMA,
            "commit": LATENCY_BANDS_SCHEMA,
        },
        "batch_interval_ms": _NUM,
        "grv_cache": {"staleness_ms": _NUM, "served_cached": int,
                      "served_confirmed": int},
    },
}

RESOLVER_ROLE_SCHEMA = {
    "role": str,
    "version": int,
    "conflict_batches": int,
    "total_transactions": int,
    "conflict_transactions": int,
    "pipeline": {
        "depth_configured": int,
        "in_flight": int,
        "max_in_flight_measured": int,
        "stages": dict,
        "latency_bands": LATENCY_BANDS_SCHEMA,
    },
}

STATUS_SCHEMA = {
    "client": {
        "database_status": {"available": bool},
        "cluster_file": {"up_to_date": bool},
    },
    "cluster": {
        "latest_version": int,
        "committed_version": int,
        "recovery_state": {"name": str},
        "machine_time": _NUM,
        "simulated": bool,
        "workload": {
            "transactions": {"committed": int, "conflicted": int,
                             "started": int},
        },
        "metrics": METRICS_SCHEMA,
        "roles": ("list_of", {"role": str}),
    },
}


def validate_status(doc: Any, schema: Any = STATUS_SCHEMA,
                    path: str = "$") -> list[str]:
    """Structural validation; returns human-readable violations (empty ==
    conforming). Per-role schemas apply by the element's `role` tag."""
    errs: list[str] = []
    if isinstance(schema, dict):
        if not isinstance(doc, dict):
            return [f"{path}: expected object, got {type(doc).__name__}"]
        for key, sub in schema.items():
            if key not in doc:
                errs.append(f"{path}.{key}: missing")
                continue
            errs.extend(validate_status(doc[key], sub, f"{path}.{key}"))
        return errs
    if isinstance(schema, tuple) and len(schema) == 2 \
            and schema[0] == "list_of":
        if not isinstance(doc, list):
            return [f"{path}: expected list, got {type(doc).__name__}"]
        for i, item in enumerate(doc):
            errs.extend(validate_status(item, schema[1], f"{path}[{i}]"))
        return errs
    if not isinstance(doc, schema):
        ty = (schema.__name__ if isinstance(schema, type)
              else "/".join(t.__name__ for t in schema))
        return [f"{path}: expected {ty}, got {type(doc).__name__}"]
    return []


def validate_roles(doc: dict) -> list[str]:
    """Role-tagged deep checks: every proxy role must carry the full
    commit-pipeline + latency-band block, every (local) resolver role its
    pipeline block — the observability surfaces the next perf PRs read."""
    errs: list[str] = []
    roles = (doc.get("cluster") or {}).get("roles")
    if not isinstance(roles, list):
        return ["$.cluster.roles: missing"]
    by_role: dict[str, int] = {}
    for i, r in enumerate(roles):
        name = r.get("role") if isinstance(r, dict) else None
        if not name:
            errs.append(f"$.cluster.roles[{i}]: missing role tag")
            continue
        by_role[name] = by_role.get(name, 0) + 1
        path = f"$.cluster.roles[{i}]"
        if name == "proxy":
            errs.extend(validate_status(r, PROXY_ROLE_SCHEMA, path))
        elif name == "resolver":
            errs.extend(validate_status(r, RESOLVER_ROLE_SCHEMA, path))
    for must in ("master", "proxy"):
        if not by_role.get(must):
            errs.append(f"$.cluster.roles: no {must} role")
    return errs


class StatusWorkload:
    """Fetch + validate status on an interval while the spec's other
    workloads (and nemeses) run. Fetch ERRORS mid-recovery are retried —
    a kill racing the fetch is the point of running mid-chaos — but a
    document that renders with a broken shape is a hard failure."""

    def __init__(self, cluster, interval: float = 0.3, fetches: int = 5):
        self.cluster = cluster
        self.interval = interval
        self.target_fetches = fetches
        self.fetches_done = 0
        self.failures: list[str] = []

    async def run(self) -> None:
        from ..cluster.status import cluster_status

        loop = current_loop()
        for _ in range(self.target_fetches):
            await loop.delay(
                self.interval * (0.5 + loop.random.random01())
            )
            doc = None
            for _attempt in range(5):
                try:
                    doc = cluster_status(self.cluster)
                    break
                except BaseException as e:  # noqa: BLE001 — mid-recovery
                    from ..core.errors import ActorCancelled

                    if isinstance(e, (ActorCancelled, GeneratorExit)):
                        raise
                    await loop.delay(0.2)
            if doc is None:
                continue  # cluster never settled this round; not a schema bug
            errs = validate_status(doc) + validate_roles(doc)
            if errs:
                self.failures.extend(errs[:10])
                TraceEvent("StatusSchemaViolation", severity=40).detail(
                    "Violations", "; ".join(errs[:5])
                ).log()
            self.fetches_done += 1

    async def check(self) -> bool:
        return self.fetches_done >= 1 and not self.failures
