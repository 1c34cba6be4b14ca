"""Per-seed randomized simulation configuration.

The reference derives a SimulationConfig from the test's random seed —
redundancy mode, storage-engine choice, process/machine counts and a raft
of knob randomizations (fdbserver/SimulatedCluster.actor.cpp:696 setupAndRun
-> SimulationConfig; flow/Knobs randomize under BUGGIFY) — so every seed
exercises a different cluster shape with the same workload semantics.

generate_config(seed) is the equivalent: a deterministic function from
seed to a tester spec (workloads/tester.run_spec input), covering

  - cluster kind + role counts (storage 3-6, logs 1-3),
  - replication mode, constrained by the fleet size,
  - a machine/DC topology (sim/topology.py) about half the time —
    DC count, machines per DC — which upgrades the attrition draw to
    the machine-level nemesis (shared-fate kills, swizzles, DC kills),
  - a randomized subset of knob overrides (batch sizing, shard
    thresholds, lease/heartbeat timing — knobs the repo actually uses),
  - a workload mix: one correctness core (Cycle) plus fault/adversary
    workloads drawn per seed, under BUGGIFY.

Every generated spec is a plain printable dict: CI prints it per run, so
any failure reproduces from the seed alone (run_spec is deterministic).

The port's copy of foundationdb_tpu/sim/config.py. Its draw stream is the
JAX package's, draw for draw: the choice tuples keep their lengths and
weights, and only the backend names of the two device knobs are the
port's (CONFLICT_SET_IMPL: the JAX package's "native" and "tpu" draw
"gpu"; STORAGE_ENGINE_IMPL: "tpu" draws "gpu"), so seed N yields the JAX
package's spec N with those two names mapped. `run_randomized` runs every
seed on `device`.
"""

from __future__ import annotations

import hashlib
import random
from typing import Any, Optional

# (knob name, which registry, (lo, hi)) — randomization ranges for knobs
# governing behavior the repo actually has. Ints randomize inclusive.
_KNOB_RANGES = [
    ("COMMIT_TRANSACTION_BATCH_COUNT_MAX", "server", (2, 64)),
    ("COMMIT_TRANSACTION_BATCH_INTERVAL_MIN", "server", (0.0005, 0.02)),
    ("GRV_BATCH_INTERVAL", "client", (0.0005, 0.02)),
    ("MAX_BATCH_SIZE", "client", (4, 64)),
    ("MIN_SHARD_BYTES", "server", (64, 4096)),
    ("RATEKEEPER_UPDATE_INTERVAL", "server", (0.05, 0.5)),
    ("DEFAULT_BACKOFF", "client", (0.005, 0.1)),
    ("TPU_STICKY_DECAY_BATCHES", "server", (4, 128)),
    # Hoisted in r6 (VERDICT r5 weak #7 — poll/batch windows the repo
    # grew in r4/r5 but never perturbed): long-poll peeks, spill reads,
    # backup ship retries, HTTP deadlines, and the block-sparse conflict
    # set's compaction cadence.
    ("TLOG_PEEK_LONG_POLL_WINDOW", "server", (0.5, 10.0)),
    ("TLOG_SPILL_PEEK_BATCH", "server", (4, 1024)),
    ("BACKUP_SHIP_RETRY_INTERVAL", "server", (0.05, 1.0)),
    ("HTTP_REQUEST_TIMEOUT", "client", (5.0, 60.0)),
    ("TPU_COMPACT_EVERY_BATCHES", "server", (2, 32)),
    # r7: touched-block gather cap — low draws force the block-sparse
    # resolvers (single-chip AND mesh-sharded) onto the compaction
    # fallback mid-workload, the shape-churn path a fixed default never
    # exercises.
    ("TPU_MAX_TOUCHED_BLOCKS", "server", (8, 64)),
    # k-way log push retry/backoff + the two-DC log router's dark-peer
    # backoff (log_system.push / LogRouter.run): perturbed so the
    # log_push_drop buggify's retry path and router stalls are exercised
    # at different cadences.
    ("LOG_PUSH_RETRIES", "server", (1, 4)),
    ("LOG_PUSH_RETRY_DELAY", "server", (0.01, 0.2)),
    ("LOG_ROUTER_RETRY_INTERVAL", "server", (0.02, 0.5)),
    # r8: resolver pipeline depth — depth 1 pins the synchronous path,
    # depth >1 runs the submit/verdicts overlap with its dual version
    # chains (dispatch vs consumption) under the seed's chaos mix.
    ("TPU_PIPELINE_DEPTH", "server", (1, 4)),
    # r9: the commit-plane pipeline (proxy.py dual chains) — depth 1 pins
    # the strictly serial plane (bit-identical to the pre-pipeline path),
    # depth >1 keeps several commit versions in flight across
    # proxy->resolver->tlog under chaos, with replies still released in
    # commit-version order.
    ("PROXY_PIPELINE_DEPTH", "server", (1, 4)),
    # r9: GRV fast path — 0 pins the strict per-batch confirm; positive
    # draws serve read versions from the committed cache between epoch
    # confirms, so chaos seeds exercise the amortized-liveness window
    # against recoveries (the bound is ms-scale vs second-scale leases).
    ("GRV_CACHE_STALENESS_MS", "server", (0.0, 20.0)),
    # r9: adaptive commit coalescing — byte target + deadline ceiling of
    # the floating batch-close controller (proxy._AdaptiveBatchInterval).
    ("COMMIT_BATCH_BYTES_TARGET", "server", (1 << 12, 1 << 20)),
    ("COMMIT_TRANSACTION_BATCH_INTERVAL_MAX", "server", (0.001, 0.02)),
    # r10: worker recruitment (cluster/recruitment.py) — the registry's
    # heartbeat cadence vs lease horizon (draws where heartbeat > lease
    # make leases flap, exercising the ranker's stale-lease demotion),
    # and the parked-recruitment retry delay of stalled recoveries.
    ("WORKER_HEARTBEAT_INTERVAL", "server", (0.1, 1.0)),
    ("WORKER_LEASE_TIMEOUT", "server", (0.5, 4.0)),
    ("RECRUITMENT_STALL_RETRY_DELAY", "server", (0.05, 1.0)),
    # r11: recovery's storage-rollback confirm backoff (durable-role
    # re-recruitment tier) — draws near the lease horizon race the
    # rollback retry against the park-and-recruit path.
    ("STORAGE_ROLLBACK_RETRY_DELAY", "server", (0.05, 0.5)),
    # r10: flight-recorder sampling — 0 pins the unsampled commit path
    # (no per-commit RNG draw at all); positive draws thread debug IDs
    # through GRV/commit/resolve/tlog under the seed's chaos mix, so the
    # micro-event emission points and the wire debug columns run inside
    # the determinism contract (same seed => bit-identical event chain).
    ("COMMIT_SAMPLE_RATE", "client", (0.0, 1.0)),
    # r13: MetricLogger retention — low draws prune \xff/metrics/ time
    # buckets aggressively mid-workload, so the clear_range prune path
    # runs inside the chaos mix instead of only at operator horizons.
    ("METRICS_RETENTION_SECONDS", "server", (5.0, 120.0)),
    # r20 (knob-unrandomized sweep): storage fsync cadence and the read
    # batcher's coalescing window — 0.0 pins the no-coalesce path, the
    # upper end widens the park a read-batcher regression once lived in.
    ("STORAGE_COMMIT_INTERVAL", "server", (0.05, 1.0)),
    ("STORAGE_READ_BATCH_INTERVAL", "server", (0.0, 0.005)),
    # r20: failure-detector horizon vs heartbeat cadence — draws near
    # WORKER_HEARTBEAT_INTERVAL make liveness flap under chaos.
    ("FAILURE_TIMEOUT_DELAY", "server", (0.5, 4.0)),
    # r20: the deployed default (1.5 GB) never spills in a sim-sized
    # run; low draws push durable tlog entries through the spill store
    # and its peek-from-spill read path mid-workload.
    ("TLOG_SPILL_THRESHOLD", "server", (65536.0, 4194304.0)),
    # r20: client commit-wire coalescing window/size — 0.0 disables the
    # interval (every request ships alone), small COUNT_MAX forces
    # mid-burst flushes.
    ("COMMIT_WIRE_BATCH_INTERVAL", "client", (0.0, 0.005)),
    ("COMMIT_WIRE_BATCH_COUNT_MAX", "client", (4, 512)),
]

# Categorical knob draws (same subset-randomization policy as the ranges).
# CONFLICT_SET_IMPL swaps the resolver backend recruited at every tier
# (resolver/factory.py) under the seed's workload mix — the gpu draw runs
# Cycle+Attrition specs through the block-sparse kernel (and, with the
# randomized TPU_MAX_TOUCHED_BLOCKS above, through its compaction
# fallback). The JAX package's weights are kept, its "native" and "tpu"
# both draw the port's gpu backend, so most seeds run on the card (the
# port's own "native" set is never drawn: the seed lists stay as they are).
_KNOB_CHOICES = [
    ("CONFLICT_SET_IMPL", "server", ("gpu", "gpu", "oracle", "gpu")),
    # r8: proxies ship resolve batches as columnar wire bytes (or not) —
    # both the vectorized wire pack and the legacy object path must
    # produce seed-identical runs.
    ("RESOLVER_WIRE_BATCH", "server", ("true", "false")),
    # r18: log->storage peeks round-trip the columnar TaggedMutationBatch
    # codec (or not) — both peek formats must produce seed-identical
    # runs (commit_wire.maybe_wire_peek is the in-process gate).
    ("TLOG_PEEK_WIRE", "server", ("true", "false")),
    # r19: storage servers answer reads from the device-resident MVCC
    # window (gpu) or the host VersionedMap (memory). The read batcher
    # runs identically for both, so every seed must produce the same
    # keyspace fingerprint under either draw — the swarm holds that
    # differential live. Weighted toward the host default.
    ("STORAGE_ENGINE_IMPL", "server", ("memory", "memory", "gpu")),
    # r20 (knob-unrandomized sweep): client GRV batching and the commit
    # wire batcher on/off — the "false" draws pin the unbatched legacy
    # paths, which no fixed default exercised since they landed.
    ("GRV_COALESCE", "client", ("true", "false")),
    ("COMMIT_WIRE_BATCH", "client", ("true", "false")),
]

_REPLICATION_FOR = {3: ["single", "double", "triple"],
                    2: ["single", "double"], 1: ["single"]}

# Dimensions a DrawBias may steer, with the option set each one draws
# over (tools/swarm.py ranks these by coverage-facet saturation and
# prefers the least-seen value). `bias_facet` maps a (dim, option) to
# the facet string `coverage_facets` emits for it, so the swarm's
# corpus arithmetic and the signature stay keyed identically.
BIAS_DIMS: dict[str, tuple] = {
    "kind": ("recoverable_sharded", "sharded"),
    "engine": (None, "memory", "ssd"),
    "replication": ("single", "double", "triple"),
    "topology_dcs": (None, 1, 2, 3),
    "regions": (False, True),
}

_BUCKETS = ("lo", "mid", "hi")

# The shape-agnostic optional pool a DrawBias "workload" preference can
# force-include (kept in sync with the `optional` list below; the
# gated stanzas — attrition/topology/backup nemeses — stay draw-only).
OPTIONAL_WORKLOAD_NAMES = (
    "Serializability", "Watches", "ConflictRange", "WriteDuringRead",
    "FuzzApi", "VersionStamp", "BackupRestore", "StatusWorkload",
    "Increment", "LowLatency",
)


def bias_facet(dim: str, value) -> str:
    """The coverage facet a biasable dimension's option lands in."""
    if dim == "topology_dcs":
        return f"shape.n_dcs={'none' if value is None else value}"
    if dim == "engine":
        return f"shape.engine={value or 'none'}"
    return f"shape.{dim}={value}"


class DrawBias:
    """Coverage-guided preferences for `generate_config` draws.

    The swarm (tools/swarm.py) builds one per seed from its corpus of
    seen coverage facets and passes it in; the generator then steers a
    draw toward the preferred value with probability `strength`, leaving
    the rest of the seed's draw stream untouched. The OUTPUT spec is
    still the full repro on its own — `run_spec` never sees the bias.

    prefer        dim (BIAS_DIMS key, or "workload") -> preferred value.
    strength      probability a preference overrides the unbiased draw.
    force_knobs   knob keys ("server:NAME") whose override is always
                  drawn (the unbiased path includes each with p=0.5).
    knob_buckets  knob key -> "lo"|"mid"|"hi" (range knobs: the drawn
                  value lands in that third of the range) or a literal
                  categorical choice.
    allow_engine_topology
                  historically opened the durable-engine x machine-
                  topology joint space while it was swarm-only; the
                  space graduated into the unbiased draw (the pinned
                  WriteDuringRead GRV-coalescing regression it surfaced
                  is fixed), so this flag is now a compat no-op.
    """

    def __init__(self, prefer: Optional[dict] = None,
                 strength: float = 0.75,
                 force_knobs=(), knob_buckets: Optional[dict] = None,
                 allow_engine_topology: bool = False):
        self.prefer = dict(prefer or {})
        self.strength = strength
        self.force_knobs = set(force_knobs)
        self.knob_buckets = dict(knob_buckets or {})
        self.allow_engine_topology = allow_engine_topology


_MISS = object()


def _steer(rng: random.Random, bias: Optional[DrawBias], dim: str,
           drawn, options) -> Any:
    """Return the unbiased `drawn` value, or — when the bias prefers a
    feasible option for `dim` — that option with p=strength. Consumes
    one extra rng draw ONLY on biased dims, so bias=None reproduces the
    historical draw stream bit-for-bit."""
    if bias is None:
        return drawn
    pref = bias.prefer.get(dim, _MISS)
    if pref is _MISS or pref not in options:
        return drawn
    return pref if rng.random() < bias.strength else drawn


def knob_bucket(key: str, value) -> str:
    """Coverage bucket of a knob override: lo/mid/hi third of its draw
    range, or the literal value for categorical knobs (unknown keys
    bucket by raw value — hand-written specs may override anything)."""
    reg, _, name = key.partition(":")
    for n, r, (lo, hi) in _KNOB_RANGES:
        if n == name and r == reg:
            try:
                frac = (float(value) - lo) / ((hi - lo) or 1)
            except (TypeError, ValueError):
                return str(value)
            return _BUCKETS[min(2, max(0, int(frac * 3)))]
    return str(value)


def _bucket_span(lo, hi, bucket: str):
    """The [blo, bhi] sub-range of a knob's draw range that `knob_bucket`
    maps back to `bucket` (used by biased draws to land inside it)."""
    b = _BUCKETS.index(bucket)
    if isinstance(lo, int):
        span = hi - lo + 1
        blo = lo + span * b // 3
        bhi = min(hi, lo + span * (b + 1) // 3 - 1)
        return blo, max(blo, bhi)
    width = (hi - lo) / 3
    return lo + width * b, lo + width * (b + 1)


def coverage_facets(spec: dict, result: Optional[dict] = None) -> list[str]:
    """The per-seed coverage signature's bucket set: cluster-shape draw,
    knob buckets, workload mix, and — when a run result is supplied —
    the trace event types, recovery states, and metric-snapshot names
    the run actually reached (workloads/tester.py emits all three
    deterministically in results["coverage"]). Sorted, printable, and
    stable across reruns of the same seed: signature divergence between
    two runs of one spec is a determinism bug."""
    facets: set[str] = set()
    cluster = spec.get("cluster", {})
    topo = cluster.get("topology")
    facets.add(f"shape.kind={cluster.get('kind', 'local')}")
    facets.add(f"shape.engine={cluster.get('engine') or 'none'}")
    facets.add(f"shape.replication={cluster.get('replication', 'single')}")
    facets.add("shape.log_replication="
               f"{cluster.get('log_replication', 'single')}")
    facets.add(f"shape.regions={bool(cluster.get('regions'))}")
    facets.add("shape.n_dcs="
               f"{topo['n_dcs'] if topo else 'none'}")
    facets.add("shape.topology=" + (
        f"{topo['n_dcs']}x{topo['machines_per_dc']}" if topo else "none"))
    facets.add("shape.engine_topology="
               f"{cluster.get('engine') is not None and topo is not None}")
    facets.add(f"shape.n_storage={cluster.get('n_storage', 1)}")
    facets.add(f"shape.n_logs={cluster.get('n_logs', 1)}")
    for key in sorted(spec.get("knobs") or {}):
        facets.add(f"knob.{key}={knob_bucket(key, spec['knobs'][key])}")
    stanzas = list(spec.get("workloads", []))
    for phase in spec.get("phases", []):
        stanzas.extend(phase.get("workloads", []))
    for w in stanzas:
        facets.add(f"wl.{w.get('name', '?')}")
    cov = (result or {}).get("coverage") or {}
    for t in cov.get("trace_event_types", ()):
        facets.add(f"ev.{t}")
    for s in cov.get("recovery_states", ()):
        facets.add(f"rs.{s}")
    for m in cov.get("metric_names", ()):
        facets.add(f"metric.{m}")
    return sorted(facets)


def coverage_signature(spec: dict, result: Optional[dict] = None) -> str:
    """Stable digest of `coverage_facets` — the corpus key one run
    occupies. Same seed (and binary) => same signature; tools/swarm.py's
    --check-determinism compares it alongside the keyspace fingerprint."""
    facets = coverage_facets(spec, result)
    return hashlib.sha256("\n".join(facets).encode()).hexdigest()[:16]


def generate_config(seed: int, bias: Optional[DrawBias] = None
                    ) -> dict[str, Any]:
    rng = random.Random(seed)
    n_storage = rng.randint(3, 6)
    n_logs = rng.randint(1, 3)
    replication = rng.choice(_REPLICATION_FOR[min(n_storage, 3)])
    replication = _steer(rng, bias, "replication", replication,
                         _REPLICATION_FOR[min(n_storage, 3)])
    # Cluster KIND is a per-seed draw too (ref: SimulatedCluster's
    # simple/fearless/with-resolvers configuration draws): most seeds
    # run the recoverable tier (attrition-capable), a minority pin the
    # plain sharded data plane where the generation machinery is absent
    # by construction.
    kind = "recoverable_sharded" if rng.random() < 0.75 else "sharded"
    kind = _steer(rng, bias, "kind", kind, BIAS_DIMS["kind"])
    # Storage ENGINE + durability draw (ref: SimulationConfig's
    # storage-engine randomization, SimulatedCluster.actor.cpp:696):
    # some seeds run the whole chaos mix over a durable datadir — tlogs
    # on the DiskQueue, engines behind the storage seam — so every
    # preset exercises the durable formats, not just restart specs.
    # "auto" datadirs materialize per RUN (fresh tmpdir), keeping the
    # printed spec reproducible and the determinism rerun independent.
    engine = None
    if rng.random() < 0.25:
        engine = rng.choice(["memory", "memory", "ssd"])
    engine = _steer(rng, bias, "engine", engine, BIAS_DIMS["engine"])

    # Machine/DC topology (sim/topology.py), drawn per seed like the
    # reference's machine/datacenter counts (SimulatedCluster's
    # datacenters/machineCount randomization): zone==machine localities,
    # so teams spread across machines and machine kills stay survivable.
    # Needs at least as many machines as the replication factor or the
    # policy is unsatisfiable by construction.
    topology = None
    # The durable-engine x machine-topology joint space GRADUATED into
    # the unbiased draw once the swarm-pinned WriteDuringRead regression
    # (a GRV-coalescing external-consistency hole the joint space
    # surfaced) was fixed: machine kills/reboots on a durable fleet run
    # WITHOUT power_loss, so the datadir survives. DrawBias's
    # allow_engine_topology is kept as a no-op for swarm-corpus compat
    # (older biases still deserialize and steer).
    topo_ok = kind == "recoverable_sharded"
    want_topo = rng.random() < 0.5 and topo_ok
    pref_dcs = bias.prefer.get("topology_dcs", _MISS) if bias else _MISS
    forced_dcs = None
    if pref_dcs is not _MISS and rng.random() < bias.strength:
        if pref_dcs is None:
            want_topo = False
        elif topo_ok:
            want_topo, forced_dcs = True, pref_dcs
    if want_topo:
        # The machine nemesis needs the recoverable tier (sim_topology
        # only attaches there).
        n_dcs = forced_dcs or rng.choice([1, 1, 2, 3])
        machines_per_dc = rng.randint(2, 4)
        need = {"single": 1, "double": 2, "triple": 3}[replication]
        while n_dcs * machines_per_dc < need:
            machines_per_dc += 1
        topology = {"n_dcs": n_dcs, "machines_per_dc": machines_per_dc}

    # Two-region log shipping (log_system.LogRouter): a remote log set in
    # DC1 fed asynchronously, with recovery failing over to it after a
    # primary-DC loss. Needs >= 2 DCs; storage teams switch to the
    # DC-spanning mode so a whole-DC kill stays inside what the team
    # policy survives (and the MachineAttrition dc_kill draw can land).
    regions = False
    if topology is not None and topology["n_dcs"] >= 2:
        regions = rng.random() < 0.4
        regions = _steer(rng, bias, "regions", regions, (False, True))
    if regions:
        replication = "two_datacenter"

    # k-way log replication, constrained by how many distinct failure
    # domains actually host logs: without a machine topology every log
    # has its own zone; with one, logs collapse onto machines (DC0's
    # machines only, under regions) and the policy needs k distinct.
    if topology is None:
        log_domains = n_logs
    elif regions:
        log_domains = min(n_logs, topology["machines_per_dc"])
    else:
        log_domains = min(
            n_logs, topology["n_dcs"] * topology["machines_per_dc"]
        )
    log_modes = [m for m, k in
                 (("single", 1), ("double", 2), ("triple", 3))
                 if k <= log_domains]
    log_replication = rng.choice(log_modes)

    knobs: dict[str, Any] = {}
    for name, reg, (lo, hi) in _KNOB_RANGES:
        key = f"{reg}:{name}"
        skip = rng.random() < 0.5  # leave at default (the reference
        #                            randomizes subsets)
        if skip and not (bias is not None and key in bias.force_knobs):
            continue
        bucket = bias.knob_buckets.get(key) if bias is not None else None
        blo, bhi = (_bucket_span(lo, hi, bucket)
                    if bucket in _BUCKETS else (lo, hi))
        if isinstance(lo, int):
            knobs[key] = rng.randint(blo, bhi)
        else:
            knobs[key] = round(blo + rng.random() * (bhi - blo), 5)
    for name, reg, choices in _KNOB_CHOICES:
        key = f"{reg}:{name}"
        skip = rng.random() < 0.5
        if skip and not (bias is not None and key in bias.force_knobs):
            continue
        bucket = bias.knob_buckets.get(key) if bias is not None else None
        knobs[key] = bucket if bucket in choices else rng.choice(choices)

    workloads: list[dict[str, Any]] = [
        {"name": "Cycle", "nodes": rng.randint(8, 24),
         "clients": rng.randint(2, 5), "txns": rng.randint(10, 30)},
    ]
    optional = [
        {"name": "Serializability", "clients": 3,
         "txns": rng.randint(8, 20)},
        {"name": "Watches", "pairs": rng.randint(4, 10), "rounds": 2},
        {"name": "ConflictRange", "key_space": rng.randint(32, 160)},
        {"name": "WriteDuringRead", "key_space": rng.randint(20, 80),
         "txns": rng.randint(15, 40)},
        {"name": "FuzzApi", "rounds": 2},
        {"name": "VersionStamp", "clients": rng.randint(2, 4),
         "txns": rng.randint(5, 12)},
        {"name": "BackupRestore", "snapshots": 2},
        {"name": "StatusWorkload", "fetches": rng.randint(3, 8),
         "interval": round(0.1 + 0.4 * rng.random(), 2)},
        # Reference-corpus round 3 (ROADMAP scenario diversity (a)):
        # Increment's atomic-add ledger and LowLatency's bounded-GRV
        # probe loop, both shape-agnostic.
        {"name": "Increment", "clients": rng.randint(2, 4),
         "txns": rng.randint(8, 20), "key_space": rng.randint(4, 12)},
        {"name": "LowLatency", "probes": rng.randint(6, 14),
         "interval": round(0.1 + 0.3 * rng.random(), 2),
         "max_latency": 5.0},
    ]
    rng.shuffle(optional)
    chosen = optional[: rng.randint(1, 3)]
    pref_wl = bias.prefer.get("workload", _MISS) if bias else _MISS
    if pref_wl is not _MISS and rng.random() < bias.strength \
            and pref_wl not in {w["name"] for w in chosen}:
        chosen.extend(w for w in optional if w["name"] == pref_wl)
    workloads.extend(chosen)
    # TaskBucket lease-takeover soak: mortal backup agents + a killing
    # nemesis, any cluster kind.
    if rng.random() < 0.25:
        workloads.append({
            "name": "BackupAttrition",
            "keys": rng.randint(24, 56),
            "tasks": rng.randint(4, 10),
            "agents": rng.randint(2, 4),
            "kills": rng.randint(1, 4),
        })
    # Topology-scoped adversaries: role-aimed kills + first-class
    # clogging over the machine processes.
    if topology is not None:
        if rng.random() < 0.4:
            workloads.append({
                "name": "RandomClogging",
                "clogs": rng.randint(1, 3),
                "pairs": rng.randint(0, 2),
                "swizzles": rng.randint(0, 1),
                "max_clog": round(0.3 + 0.6 * rng.random(), 2),
                "interval": round(0.3 + 0.5 * rng.random(), 2),
            })
        if replication not in ("single", "two_datacenter") \
                and rng.random() < 0.4:
            roles = [r for r in ("log", "storage", "txn")
                     if rng.random() < 0.7] or ["txn"]
            workloads.append({
                "name": "TargetedKill", "roles": roles,
                "interval": round(0.5 + rng.random(), 2),
            })
    # Movement + distribution faults only where shards exist.
    movers = rng.random() < 0.7
    attrition = kind == "recoverable_sharded" and rng.random() < 0.7
    if movers:
        # With n_storage == replicas there is exactly ONE policy-valid
        # team: no move can ever complete, so progress cannot be
        # required (exposed by the sharded-kind draw, where attrition —
        # which also waives progress — is never present).
        can_move = n_storage > {"single": 1, "double": 2,
                                "triple": 3}.get(replication, n_storage)
        workloads.append({
            "name": "RandomMoveKeys",
            "interval": round(0.2 + rng.random(), 2),
            # Under attrition every move can lose its race with a
            # recovery; progress becomes best-effort, correctness is
            # carried by the concurrent workloads + ConsistencyCheck.
            "require_progress": not attrition and can_move,
        })
        workloads.append({"name": "DataDistribution"})
    if attrition:
        if topology is not None and replication != "single":
            # With a machine topology, attrition upgrades to the
            # machine/DC nemesis: shared-fate kills, swizzled clogs, and
            # (multi-DC shapes only) a whole-datacenter kill, all gated
            # by the quorum-safety check.
            workloads.append({
                "name": "MachineAttrition",
                "interval": round(0.5 + rng.random(), 2),
                "kills": rng.randint(1, 2),
                "reboots": rng.randint(0, 1),
                "swizzles": rng.randint(0, 1),
                "dc_kills": 1 if (topology["n_dcs"] > 1
                                  and rng.random() < 0.5) else 0,
                "outage": round(0.2 + 0.4 * rng.random(), 2),
            })
        else:
            workloads.append({"name": "Attrition",
                              "interval": round(0.5 + rng.random(), 2),
                              "kills": rng.randint(1, 3)})
    if rng.random() < 0.5 and replication != "single":
        workloads.append({"name": "RebootStorage",
                          "reboots": rng.randint(1, 3),
                          "interval": round(0.4 + rng.random(), 2)})
    # Exclude-then-verify against DD: needs a distributor (movers draw)
    # and spare capacity beyond the replication mode's floor.
    spare = n_storage - {"single": 1, "double": 2,
                         "triple": 3}.get(replication, n_storage)
    if movers and not regions and spare >= 1 and rng.random() < 0.3:
        workloads.append({"name": "RemoveServersSafely",
                          "excludes": 1,
                          "hold_time": round(0.5 + rng.random(), 2)})

    cluster: dict[str, Any] = {
        "kind": kind,
        "n_storage": n_storage,
        "n_logs": n_logs,
        "replication": replication,
    }
    if engine is not None:
        cluster["engine"] = engine
        cluster["datadir"] = "auto"
    if log_replication != "single":
        cluster["log_replication"] = log_replication
    if regions:
        cluster["regions"] = True
    if topology is not None:
        cluster["topology"] = topology
    return {
        "seed": seed,
        "buggify": True,
        "knobs": knobs,
        "cluster": cluster,
        "workloads": workloads,
    }


def run_randomized(seeds, log=print, device=None,
                   limit: Optional[float] = None,
                   on_result=None) -> list[dict[str, Any]]:
    """Run generate_config(seed) on `device` (None: the CUDA card) for
    every seed, each under a wall-clock `limit` in seconds (None: none;
    an overrun fails the seed); print each config (the reproduction
    recipe) and collect results. `on_result(seed, spec,
    result)` sees each result as it comes. Raises on the first failed
    seed AFTER running all of them, so CI reports every bad seed."""
    import json

    from ..device import resolve_device
    from .sweep import run_seed, seed_passed

    resolve_device(device)
    results = []
    failures = []
    for seed in seeds:
        spec = generate_config(seed)
        log(f"[sim seed {seed}] config: {json.dumps(spec, sort_keys=True)}")
        res = run_seed(spec, device=device, limit=limit)
        ok = seed_passed(res)
        log(f"[sim seed {seed}] ok={res.get('ok')} "
            f"sev_errors={res.get('sev_errors')} "
            + (f"error={res.get('error')}" if res.get("error") else ""))
        results.append(res)
        if on_result is not None:
            on_result(seed, spec, res)
        if not ok:
            failures.append(seed)
    if failures:
        raise AssertionError(
            f"randomized simulation failed for seeds {failures} "
            "(re-run generate_config(seed) to reproduce)"
        )
    return results
