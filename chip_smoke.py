#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits nonzero):

1. device and build: the card's name and power limit, the kernel build
   (nvcc, from foundationdb_tpu_torch/csrc) side by side with the native
   host tier's and the envelope's (g++, from native/, into build/native/),
   the seconds of each and the Python include path;
2. probe kernel vs its plain torch version on the same CUDA tensors, bit
   exact, at edge shapes that take every branch of the kernel (unsorted
   queries, permuted blocks) and at the resolver's full-width shapes
   (W1 = 4, NB = 65,536 blocks of 32, P2 = 917,504 sorted endpoints),
   with the device time of both (foundationdb_tpu_torch/timing.py: warm
   over 50 launches per event pair, cold after an L2 flush); then
   `[phase2]`: phase 2's kernel (csrc/phase2.cu, the fixed point's seed
   and rounds on the device) through a ConflictSetGPU and a
   ConflictSetRankFed on a pure abort chain of 15 and of 16 txns,
   statuses alternating, and each call's operands held bit-exact against
   the plain version (conflict vector and round counter) under both
   tiers, also with the round cap cut to 5;
3. narrow slice: ConflictSetGPU on the card against the CPU oracle
   ConflictSetCPU, 40 batches of 256 txns at pipeline depth 4 (GC horizon,
   tooOld txns, a 40-byte key mid-run, compaction every 4 dispatches):
   statuses and entries() equal;
4. full width, BASELINE config 5 (sliding MVCC window): uniform 8-byte
   keys over 2^20, 5 point reads + 2 point writes per txn, 65,536 txns per
   batch, version step 65,536, GC horizon version - 131,072, a 2^21-slot
   state. 8 batches (FULL_BATCHES; 24, 16, then 12, before) through
   submit/verdicts at depth 4; the first 2 also through
   ConflictSetGPU(device="cpu"), statuses and entries() equal. The
   probe's, phase 2's and the block kernels' launch counts are reset
   just before and read just after this run: the probe's must be
   positive, phase 2's one per resolved chunk, the block kernels' decode
   one per chunk and phase 1 and phase 3 one per fast chunk, and no
   submit may read the host in phase 2. Prints txns/s, p50/p90 batch
   latency and more, and the profiled batch's device ops split by chunk
   (fast step or compaction);
   then 2 batches (FULL_64K_BATCHES; 6, then 3, before) at 64K-txn
   chunks. The
   main run's batches stay for phases 19-21.
5. storage read window, one memory-engine storage process: 1,000,000 YCSB
   records (hashed keys of 5-23 bytes, 1,000-byte values) in
   KeyValueStoreGPU through make_mvcc_window("gpu"), then YCSB workload B
   (95% Zipfian point reads, 5% updates) and E (95% scans of 1-100
   records, 5% inserts), 720 batches of 128 operations each, at pipeline
   depth 2, the version 10,000 on per batch, forget_before once per 100
   batches. Every reply and each leg's entries() equal an independent
   VersionedMap fed the same writes; the probe and the read gather
   (csrc/read.cu) launch once each per submit; submit_reads makes no
   host sync (plain, delta fold, compaction).
6. the transaction system: the port's LocalCluster under its sim_loop,
   ConflictSetGPU (2^21 slots) behind the resolver role and
   KeyValueStoreGPU behind the storage server's read batcher, knobs at
   their defaults. Cycle over 1,000 nodes (64 clients x 25 txns), then
   BASELINE config 1: 2^18 keys of ReadWrite's space of 2^20 loaded
   through the client in 1,000-key transactions (cut from 2^20 to keep
   the whole run inside its time: phase 9 loads the full 2^20), then
   ReadWriteWorkload (5 reads, 2 writes per txn, uniform keys over 2^20)
   from 1,024 clients until 2,500 txns have committed (CONFIG1_CHIP_TARGET;
   10,000 before the backup phases joined the run, then 5,000). Every
   resolve
   batch's verdicts are replayed through a fresh ConflictSetCPU in a
   process of its own, fed while the cluster runs (and entries()
   compared),
   every read reply is held against an independent VersionedMap fed the
   same mutations, the window's entries() too; submit makes no host sync
   beyond phase 2's and the mirror's; the probe launches on both paths.
   Prints committed txns per wall second, batch sizes and latencies,
   the pipeline stages, profiled batches and the idle share.
7. BASELINE config 4 standalone, `[sharded]`: ShardedConflictSetGPU with
   4 shards, one per device (`devices=`, shard s on card s % the
   machine's cards: all four on one card here), over uniform 8-byte keys
   in 2^20 (boundaries at the quarters), 5 point reads + 2 point writes
   per txn and on every 7th txn one read range drawn over the whole
   space, snapshots lagging U[0, 100,000), the GC horizon version -
   131,072, 2^19 slots per shard: 40 batches of 8,192 txns through
   submit/verdicts at depth 4 (the version 8,192 on per batch) and one
   profiled, then 6 batches of 65,536. ShardedConflictSetCPU's four
   shards replay every batch in four processes; every batch's statuses
   and each leg's shard_entries() must equal theirs; the probe launches
   4 times per fast-path batch; every submit's syncs are audited.
8. `[cluster-sharded]`: the port's LocalCluster with a 4-shard
   ShardedConflictSetGPU (placed as in phase 7) as its resolver, split at
   the Cycle keys of nodes 250, 500 and 750; Cycle over 1,000 nodes (64
   clients x 25 txns); every resolve batch replayed through
   ShardedConflictSetCPU's four shards (four processes), every read
   reply checked, every submit's syncs audited.
9. `[sharded-cluster]`: ShardedKVCluster(n_storage=4, n_logs=2,
   replication="double", n_resolvers=4), storage shards and resolvers
   split at rw_key(2^18), rw_key(2^19) and rw_key(3 * 2^18), under
   config 1 (a 2^18-key load, SHARDED_CLUSTER_LOAD_KEYS, 2^20 until PR
   9, then ReadWrite from 1,024 clients until 2,500 txns commit, 10,000
   before the backup phases joined the run, then 5,000); each role's
   submits replayed
   through its own ConflictSetCPU (four processes), every read reply held
   against an independent VersionedMap per storage server, every
   submit's syncs audited.

10. `[rankfed]`: BASELINE config 5 as in phase 4 through
   ConflictSetRankFed (keys in a sorted host mirror, one int32 version
   vector of 2^23 slots on the card, phases 1 and 3 in csrc/rankfed.cu
   around phase 2, one launch each a batch): 4 batches
   (RANKFED_BATCHES; 24, 12, 8, then 6, before) of 65,536 txns (converted to
   TxnConflictInfo lists first) through
   prepare/pack/resolve_async at depth 4, one GC round on the cadence;
   the first 2 also through ConflictSetRankFed(device="cpu"), statuses
   and the version vector equal; a ConflictSetCPU replays every batch,
   statuses and entries() equal. Prints txns/s beside phase 4's, the
   stage times, one profiled batch, and `[rankfed-sync-audit]`:
   resolve_async makes no host sync (phase 2 runs on the card), a GC
   round one.
11. `[recovery]`: the port's RecoverableCluster, two controllers, its
   resolver recruited each generation through CONFLICT_SET_IMPL ("gpu"),
   its storage window KeyValueStoreGPU: Cycle over 1,000 nodes (64 x 25)
   with the transaction system killed after 25%, 50% and 75% of the
   commits, then BASELINE config 1 as in phase 6 after a 2^16-key load
   (2^18 before the backup phases joined the run, then 2^17) with kills
   at 25%, 50% and 75% of 5,000 commits (RECOVERY_CHIP_TARGET; 10,000
   before).
   Each generation's submits replay through a
   fresh ConflictSetCPU at its start version; every read reply is held
   against an independent VersionedMap; the probe launches in every
   generation on both paths; no dead generation's conflict set outlives
   its recovery. Prints the time to recover of each kill.
12. `[sharded-recovery]`: RecoverableShardedCluster(n_storage=4,
   n_logs=2, replication="double", n_resolvers=4) split at the Cycle
   keys of nodes 250, 500 and 750; Cycle over 1,000 nodes with 2 kills;
   each generation's four roles replayed per role, every team member of
   every shard answering the same get_range after the run.
13. `[sim]`: the deterministic simulator (sim/, workloads/tester.py):
   the 4 seeds of SIM_CHIP_SEEDS (the first 4 of SIM_SEEDS; 24, 12,
   then 6, before) from sim/config.generate_config as drawn
   (cluster shape, knobs, workload mix, buggify) through run_randomized
   on the card, ConflictSetGPU and KeyValueStoreGPU recruited wherever a
   seed draws them or keeps their "gpu" default; every seed replayed in
   a CPU worker process with the host backends pinned (ok, checks,
   metrics and fingerprint equal), 1 seed rerun (fingerprint and
   coverage signature equal), specs/chaos_topology.json at seed 7 with
   both device backends forced, one seed profiled; each seed's device
   objects collected and device memory back in a band after it.
14. `[durable]`: the durable tier, BASELINE config 4's cluster shape
   (RecoverableShardedCluster, 4 storage, 2 logs, double log and storage
   replication, 4 resolvers) over a temporary datadir: on the memory
   engine, 2^15 of config 1's keys loaded (DURABLE_CHIP_LOAD_KEYS; cut
   from 2^18, then 2^16, PERF.md),
   ReadWrite to 500 commits (DURABLE_CHIP_TARGET; 2,000, then 1,000,
   before), a clean stop and a cold boot; a crash leg (125 commits; 500,
   then 250, before; the incarnation abandoned without close) and a cold
   boot; then the crash leg on the ssd engine. Every cold boot: each
   restored KeyValueStoreGPU window's entries() equal a VersionedMap
   restored from its engine's rows, one compaction per window, every key
   read back through the client equal to an independent record of the
   acknowledged writes; prints the boot's times to fully_recovered and
   to the first commit, rows restored, bytes on disk and device bytes.
15. `[sim-durable]`: as [sim], the 3 seeds of SIM_DURABLE_CHIP_SEEDS
   (of SIM_DURABLE_SEEDS' 17; all 17, 8, 5, then 4, before; memory
   and ssd engines on temporary datadirs, regions, both sharded kinds)
   and three restart specs (specs/restart_cycle.json, specs/
   upgrade_cycle.json, a power-loss restart over the simulated disk),
   each against its CPU replay, 1 seed rerun and profiled.
16. `[multiprocess]`: the deployed tier (cluster/multiprocess.py over
   net/), BASELINE config 4's cluster shape as `configure double ssd`
   (4 storage, double replication, ssd engine; 2 logs on 2 log hosts,
   double log replication; 4 resolvers; shards and resolvers split at
   rw_key(2^18), rw_key(2^19), rw_key(3 * 2^18)), every role host a
   process of its own started as `server.py -r fdbd -c <class>` with its
   own CUDA context, this script the client over multiprocess.connect.
   Leg A: a 2^16-key load (MP_CHIP_LOAD_KEYS; 2^18 before), config
   1's ReadWrite from 256 clients to 1,000 acknowledged commits
   (MP_CHIP_TARGET; 2,000 before), a
   stale-snapshot pair, the C wire client; every key read back against a
   VersionedMap of the acknowledged writes; each process's device memory
   (nvidia-smi) and probe launches (scraped over the metrics plane); the
   operator shell attached by cluster file (`server.py -r cli -C <cf>
   status json`, then a get of a loaded key). Leg B: the resolver host's process
   group SIGKILLed under traffic and a fresh one started, then the
   storage host, whose windows cold-boot onto the card from the ssd
   engine; every acknowledged write read back after each. Leg C: the
   storage and resolver hosts in this process (the launch tap captures
   the probe's operands), the logs and txn host as processes. Leg D: no
   resolver class, the txn host's own conflict set on the card.
17. `[backup]`: the backup tier (backup.py, dr.py) on config 4's cluster
   shape, every cluster on the card. Leg A: a 2^18-key load
   (BACKUP_LOAD_KEYS), backup_to_container(file://) under the
   invariant-pair writer and restore_from_container into a fresh cluster
   (its rows equal to the record at the snapshot version, the pair
   untorn); legs B and C, on a second source loaded with 2^14 keys
   (BACKUP_STREAM_LOAD_KEYS): ContinuousBackupAgent and DRAgent
   under config 1's ReadWrite (256 clients, 1,000 commits,
   BACKUP_CHIP_TARGET; 2,000 before), a
   point-in-time restore into another fresh cluster equal to the record
   at the median commit version, the DR destination equal to the source;
   leg D: `server.py -r cli` on the card with a piped script (data,
   status json and backup verbs). The probe's launches and last
   operands per cluster; device memory back after the clusters stop.
18. `[sim-backup]`: as [sim], the 3 seeds of SIM_BACKUP_CHIP_SEEDS (8 in
   memory, 2 and 9 durable; BackupRestore and BackupAttrition; 13 and 20
   too before [swarm] joined the run, then 4), each against its
   CPU replay, 1 rerun and profiled.
19. `[native]`: the C++ conflict detector (ConflictSetNativeCPU,
   native/conflict_set.cpp built with g++) on phase 4's batches at
   phase 4's versions and GC horizon: statuses equal to ConflictSetGPU's
   batch for batch and entries() equal after the last; txns/s and p50
   batch ms beside the host's CPU model.
20. `[native-sort]`: the endpoint sort of phase 4's last batch packed
   whole (917,504 endpoints): the native radix sort's permutation equal
   to the numpy path's (np.lexsort), both timed.
21. `[native-envelope]`: every message registered in the port's
   serializer encoded by the C envelope (native/envelope.cpp) and by the
   Python codec, byte for byte, and decoded back into its class; encode
   and decode microseconds of a 1,024-verdict ResolveBatchReply by both.
   From here on [multiprocess] frames and checksums in C.
22. `[swarm]`: `python -m foundationdb_tpu_torch.sim.swarm` on the card,
   4 guided seeds (SWARM_BUDGET; 8 before) from 2 spawned workers,
   each with its
   own CUDA context, every seed run twice (--check-determinism: the
   fingerprint and coverage signature repeat), every seed passing; the
   probe's launches summed over the workers and each worker's peak
   device memory; then specs/regressions/check_SyntheticFault_seed42.json
   replayed on the card twice, to its recorded class with an equal
   fingerprint and signature. The corpus goes to a temporary directory.

23. `[multichip]`: the root entry points of __graft_entry_torch__.py:
   entry()'s fn(*args) on the card equal to the same call on the CPU,
   every output element for element; dryrun_multichip(8) (8 shards, shard
   s on card s % count, three steps each equal to ShardedConflictSetCPU)
   under the launch tap; a 4-shard set placed with devices= and one with
   device= on the same 6 config-4 batches of 8,192 txns: statuses,
   shard_entries() and the merged st_aux bytes equal. It draws its data
   from a seed of its own.

Phases 19-21 run right after phase 4, 22 after phase 13 and 23 after
phase 8.

Every run drives every phase, and logs each one's wall time
(`[phase-wall]`). The oracle replays of phases 6-12 share one mechanism,
StreamingReplays: spawned processes fed through queues while the card
runs, one per resolver or one per shard (each clipping every batch to
its shard with clip_txns_to_shard), their statuses max-merged over the
shards by check_replays.

Phase 2 reads the host nowhere on the card: every sync audit fails a
submit that made a phase-2 read, and [full], [sharded] and [rankfed]
count the phase-2 kernel's launches (at least one per chunk, shard step
or batch). [full], [sharded] and [cluster] count the block kernels'
launches (csrc/block.cu: decode one per dispatch, phase 1 and phase 3
one per fast step or shard step) and keep their last operands, on which
each is held bit-exact against its plain version and timed. They also
count the compaction kernels' launches (csrc/compact.cu: densify, ranks,
dense_phase3 and redistribute, one each per compaction or shard step of
one) and keep their last compaction's operands, on which each is held
bit-exact against its plain version, timed and bounded
(`[compact-<kernel>-<path>]`). Phase 2's geometry runs inside the
phase-2 kernel on those paths; on each one's last operands that form is
held against the operand form, its prologue timed as their difference
(`[phase2-geometry-<path>]`). [storage] and [cluster] count the read
gather's launches (one per probe launch on the window) and hold its last
batch bit-exact (`[read-<path>]`); [rankfed] counts phases 1 and 3 (one
each per batch) and holds its last batch (`[rankfed-phase1]`,
`[rankfed-phase3]`). Every profiled batch is led by PROFILE_PAD spin
kernels that its counts leave out (profile_batch).

Then one JSON line with the kernel table (the probe on each path: resolver,
storage-B, storage-E, cluster-resolver, cluster-storage, sharded,
cluster-sharded, multichip, sharded-cluster-resolver, sharded-cluster-storage,
recovery-resolver, recovery-storage, sharded-recovery-resolver,
sim-resolver, sim-storage, durable-resolver, durable-storage,
sim-durable-resolver, sim-durable-storage, multiprocess-resolver,
multiprocess-storage,
backup-{source,restore,stream,dr,pitr}-{resolver,storage},
sim-backup-resolver, sim-backup-storage; phase 2's kernel on
[full]'s last chunk (resolver), [sharded]'s last shard step (sharded),
[rankfed]'s last batch (rankfed) and [cluster]'s largest batch under
each tier the rule picked there, one both tiers can run where there is
one (cluster-resolver-block, cluster-resolver-grid), each with its tier and the other tier's time
where the shape fits it (ab_ms); the block kernels decode_fused, phase1
and phase3 on [full]'s (resolver), [sharded]'s and [cluster]'s
(cluster-resolver) last operands; the compaction kernels densify, ranks,
dense_phase3 and redistribute on the same three paths' last compactions;
phase 2's geometry on the same three paths; the read gather on
storage-B, storage-E and cluster-storage; and the rank-fed phases 1 and
3 on [rankfed]'s last batch), the card's name and power limit,
and as the last line {"ok": true, "device": {...}}. Without a CUDA card it
exits nonzero and prints no result.
"""

from __future__ import annotations

import gc
import json
import os
import struct
import subprocess
import sys
import time
import weakref
from pathlib import Path

import numpy as np

SEED = 20261016
PAD_WORD = 2**31 - 1
INT32_MIN = -(2**31)
# The collector's thresholds for this process and its replay processes:
# the defaults are sized for small heaps, while these hold tens of millions
# of objects (1M-record windows, 2^20-key maps and their oracles), over
# which full collections took about a sixth of a cluster phase's wall time
# (the CPU at a 2^17-key load). Young cycles are still collected.
GC_THRESHOLDS = (100_000, 50, 100)
# The [sim] phase's seeds: the first 24 in-memory seeds of
# sim/config.generate_config that draw no backup workload (those run in
# [sim-backup]) and that the JAX package passes
# on the CPU with the host backends pinned; 5 and 25 fail there
# (ROADMAP Queue 3). tests/test_torch_sim_differential*.py hold each of
# these seeds' port run equal to the JAX package's on the CPU.
SIM_SEEDS = (3, 11, 14, 17, 19, 21, 26, 29, 30, 33, 34, 38, 43, 46, 51, 53,
             54, 55, 62, 63, 66, 67, 69, 71)
# The seeds the card runs since [backup] joined the smoke: the first 4
# (24, then 12, before; the CPU tests still hold all 24), one of them
# rerun.
SIM_CHIP_SEEDS = SIM_SEEDS[:4]
SIM_CHIP_DETERMINISM_SEEDS = (17,)
# The [sim-durable] phase's seeds: the first 16 of generate_config that
# draw the durable tier (a memory or ssd storage engine on a datadir, or
# regions), draw no backup workload and pass on the JAX package on the CPU
# with the host backends pinned (0, 60 and 70 fail there: ROADMAP Queue
# 3), and 168, the first that draws the memory engine with regions.
# tests/test_torch_sim_durable*.py hold each seed's port run equal to the
# JAX package's on the CPU.
SIM_DURABLE_SEEDS = (1, 6, 10, 12, 15, 18, 27, 35, 39, 42, 44, 45, 50, 58,
                     59, 65, 168)
# The card's durable seeds since [swarm] joined the smoke (cut from 17
# for the run's time, to 8, to 4 and then 3; the CPU tests still hold all
# 17): an ssd seed (6), a sharded memory-engine one (27) and one with
# regions (58, rerun; 168, regions on the memory engine, ran until
# [swarm] joined); tests/test_torch_sim_durable.py checks that it keeps
# both engines, regions and both sharded kinds.
SIM_DURABLE_CHIP_SEEDS = (6, 27, 58)
SIM_DURABLE_CHIP_DETERMINISM_SEEDS = (58,)
# The [sim-backup] phase's seeds, which draw BackupRestore or
# BackupAttrition and pass on the JAX package on the CPU with the host
# backends pinned: the first four in-memory seeds that draw one (4 and 13
# BackupRestore, 20 BackupAttrition, 8 both) and two durable ones (2, the
# first durable BackupRestore, and 9, the first durable
# BackupAttrition). tests/test_torch_sim_backup*.py hold each seed's port
# run equal to the JAX package's on the CPU. The card reruns and profiles
# seed 2, the shortest (seed 8 under the profiler took 76.30 s on an H100
# 80GB HBM3 at 700 W, PERF.md). Since [swarm] joined the run the card
# ran 4 of the 6 and now runs 3 (8 draws both workloads, 2 and 9
# are the durable ones); the CPU tests still hold all 6.
SIM_BACKUP_SEEDS = (4, 8, 13, 20, 2, 9)
SIM_BACKUP_CHIP_SEEDS = (8, 2, 9)
SIM_BACKUP_CHIP_DETERMINISM_SEEDS = (2,)
# Depth cuts since [multiprocess] joined the smoke, deepened when
# [backup] and [sim-backup] joined it: before them the whole run took
# 865.85-886.42 s on one H100 80GB HBM3 at 700 W and 1,144.58 s, of its
# 1,200 s limit, on another of the same card whose host ran every phase
# slower (PERF.md). [full] ran 16 batches, then 12; [rankfed] 12, then 8;
# [durable] ran config 1 to 2,000 commits and its crash legs to 500;
# [sharded-cluster] loaded 2^20 keys; [cluster], [sharded-cluster] and
# [recovery] ran config 1 to 10,000 commits, [recovery] after a 2^18
# load; [multiprocess] leg A loaded 2^18 keys. Deepened again when the
# native phases and [swarm] joined: [rankfed] 6 batches, then 4; [full]'s
# 64K-chunk leg 6, then 3; [recovery]'s load 2^17, then 2^16; [durable]
# 1,000 commits and crash legs of 250, then 500 and 125. Deepened again
# when a run took 1,244.42 s on a host whose CPU ran every host-bound
# phase 25-45% slower (995.53 s on the faster host, PERF.md):
# [swarm] 4 seeds, [cluster] and [sharded-cluster] config 1 to 2,500
# commits ([recovery] keeps 5,000: its three kills need the commits that
# 1,024 clients bring a batch at a time), [multiprocess] leg A and
# [backup] legs B-C to 1,000, [full]'s 64K-chunk leg 2, [sim-backup] 3 seeds, [durable]'s load 2^15, the C
# client's sets in [multiprocess] 50.
FULL_BATCHES = 8
FULL_64K_BATCHES = 2
RANKFED_BATCHES = 4
SHARDED_CLUSTER_LOAD_KEYS = 1 << 18
CONFIG1_CHIP_TARGET = 2_500
RECOVERY_CHIP_TARGET = 5_000
RECOVERY_CHIP_LOAD_KEYS = 1 << 16
MP_CHIP_LOAD_KEYS = 1 << 16
DURABLE_CHIP_LOAD_KEYS = 1 << 15
DURABLE_CHIP_TARGET = 500
DURABLE_CHIP_CRASH_TARGET = 125
MP_CHIP_TARGET = 1000
BACKUP_CHIP_TARGET = 1000
# Device ops of one profiled [full] batch while phase 2's seed still ran
# as torch ops around the kernel (NVIDIA H100 80GB HBM3, 700 W; PERF.md
# section 5): [full-profile-ops] prints the count beside it.
SEED_AS_TORCH_OPS_DEVICE_OPS = 12_880
# [full-profile] device ops with the block kernel's decode, phase 1 and
# phase 3 as torch ops (H100 80GB HBM3, 700 W; PERF.md)
TORCH_BLOCK_DEVICE_OPS = 8_344
CHUNK_RANGE = "fdb-chunk-"  # profiler range around one chunk's dispatch
# Spin kernels (torch.cuda._sleep) that lead every profiled window, and
# their kernel's name in the trace (profile_batch).
PROFILE_PAD = 256
PAD_KERNEL = "spin_kernel"
# The hand-written kernels' names as a trace shows them (csrc/*.cu).
HAND_KERNELS = ("probe_kernel", "read_kernel", "grid_kernel", "block_kernel",
                "decode_kernel", "rankfed_phase1_kernel",
                "rankfed_phase3_kernel", "phase1_kernel", "phase3_kernel",
                "densify_kernel", "ranks_kernel", "redist_kernel")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
INT_OPS_PER_S = 67e12      # H100 non-tensor 32-bit peak (fp32 column)


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------- phase 2


def probe_case(rng, W1: int, NB: int, B: int, P2: int, permute: bool = False,
               lead: int = 0):
    """A valid block state (sorted unique keys; 3/4 of the NB blocks hold
    a live prefix of 1..B-1 keys, the rest are +inf pad; fences = each
    block's first key) and P2 unsorted queries: random keys, copies of
    stored keys and fences, keys below every stored key, +inf pads. With
    permute, each block's B slots are shuffled afterwards: no longer a
    valid state, but the probe must still give exactly what the halving
    walk gives (where a count of smaller slots would differ). With lead,
    the first `lead` words of every key are one constant, as the high
    words of short keys are (config 5's 8-byte keys under 2^32 pack to
    INT32_MIN, value, 0, length), so compares are decided past word 0."""
    if lead:
        h, f, q = probe_case(rng, W1 - lead, NB, B, P2, permute)
        return tuple(
            np.concatenate([np.tile(np.where(a[:1] == PAD_WORD, PAD_WORD,
                                             INT32_MIN), (lead, 1)), a])
            .astype(np.int32) for a in (h, f, q))
    W = W1 - 1
    n_live = max(1, NB * 3 // 4)
    counts = rng.integers(1, B, size=n_live)
    need = int(counts.sum())

    def keys(n):
        k = rng.integers(-3, 4, size=(n, W1)).astype(np.int32)
        k[:, 0] = rng.integers(-4 * need, 4 * need, size=n)
        k[:, W] = rng.integers(0, 40, size=n)
        return k

    uniq = np.unique(keys(2 * need + 16), axis=0)  # lexicographic rows
    live = uniq[np.sort(rng.choice(len(uniq), need, replace=False))]
    pad = np.full(W1, PAD_WORD, dtype=np.int32)
    hkeys = np.tile(pad[:, None], (1, NB * B))
    fences = np.tile(pad[:, None], (1, NB))
    at = 0
    for b, c in enumerate(counts):
        hkeys[:, b * B: b * B + c] = live[at: at + c].T
        fences[:, b] = live[at]
        at += c
    q = keys(P2).T.copy()
    n4 = P2 // 4
    q[:, :n4] = live[rng.integers(0, need, size=n4)].T
    q[:, n4: n4 + n4 // 2] = fences[:, rng.integers(0, n_live, size=n4 // 2)]
    q[:, n4 + n4 // 2: n4 + n4 // 2 + 2] = INT32_MIN
    q[:, -2:] = pad[:, None]
    if permute:
        perm = np.argsort(rng.random((NB, B)), axis=1)
        hkeys = np.take_along_axis(hkeys.reshape(W1, NB, B), perm[None],
                                   axis=2).reshape(W1, NB * B)
    return hkeys, fences, q


def probe_bound(W1: int, NB: int, B: int, P2: int, bid) -> tuple[float, str]:
    """Least time for the probe's work on this card: bytes (fences, the
    slots of every touched block, queries read once; outputs written
    once) vs int32 compares, whichever is larger."""
    touched = int(np.unique(np.clip(bid, 0, NB - 1)).size)
    nbytes = 4 * W1 * NB + 4 * W1 * B * touched + 4 * W1 * P2 + 12 * P2
    ops = P2 * W1 * ((NB.bit_length() - 1) + (B.bit_length() - 1) + 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_probe(hkeys, fences, q, NB: int, B: int, timed: bool = False):
    """Kernel vs plain version on the same CUDA tensors: max |diff| and,
    if timed, {"ms": warm kernel, "ms_cold": kernel after an L2 flush,
    "plain_ms": warm plain version}, device ms per call by device_ms."""
    import torch
    from foundationdb_tpu_torch.resolver import probe
    from foundationdb_tpu_torch.timing import device_ms, l2_flusher

    got = probe.probe_ranks(hkeys, fences, q, NB=NB, B=B)
    want = probe.probe_ranks_ref(hkeys, fences, q, NB=NB, B=B)
    torch.cuda.synchronize()
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              for g, w in zip(got, want))
    if err:
        fail(f"probe kernel disagrees with its plain version (NB={NB} "
             f"B={B} W1={q.shape[0]} P2={q.shape[1]}): max |diff| {err}")
    if not timed:
        return err, None
    out = torch.empty((3, q.shape[1]), dtype=torch.int32, device=q.device)

    def kernel():
        probe.probe_ranks_into(out, hkeys, fences, q, NB=NB, B=B)

    def plain():
        probe.probe_ranks_ref(hkeys, fences, q, NB=NB, B=B)

    return err, {
        "ms": device_ms(kernel, n=50),
        "ms_cold": device_ms(kernel, flush=l2_flusher(q.device)),
        "plain_ms": device_ms(plain),
    }


def fmt_times(t) -> dict:
    return {k: f"{v:.5f}" for k, v in t.items()}


def phase_probe(rng):
    import torch
    from foundationdb_tpu_torch.resolver import probe

    dev = torch.device("cuda")
    # (W1, NB, B, P2, kind), unsorted queries unless "sorted"; "perm"
    # shuffles each block's slots, "odd" places hkeys and fences 4 bytes
    # off 16-byte alignment. Between them they take every path of the
    # kernel: W1 in registers (2-8) and in global memory (9, 17, and 2,503
    # = the widest key, 10,001 bytes, whose staged directory takes more
    # than 48 KB of shared memory); the closing window on both walks, on
    # the block's only (NB = 4 below it; NB = 24, not a power of two, which
    # also stages nothing), on the fences' only (B = 4 below it) and on
    # neither (misaligned); B from 4 to 64, NB from 4 to 65,536, P2 from 1
    # to 4,099.
    cases = [
        (2, 8, 8, 1, ""), (4, 8, 16, 31, "perm"), (8, 64, 32, 33, ""),
        (9, 64, 64, 4099, "perm"), (17, 8, 8, 4099, ""),
        (17, 64, 16, 33, "perm"), (8, 8, 64, 31, "perm"),
        (3, 24, 8, 700, "perm"), (2, 4, 16, 33, ""), (3, 64, 4, 700, "perm"),
        (4, 64, 32, 700, "odd"), (8, 1024, 64, 4099, "odd"),
        (4, 1024, 32, 4099, "sorted"), (2, 65536, 8, 4099, "perm"),
        (5, 65536, 64, 4099, "sorted"), (4, 1024, 32, 4099, "perm"),
        (9, 65536, 32, 4099, ""), (2503, 64, 8, 33, "perm"),
    ]
    for W1, NB, B, P2, kind in cases:
        h, f, q = probe_case(rng, W1, NB, B, P2, permute=kind == "perm")
        if kind == "sorted":
            q = np.ascontiguousarray(q[:, np.lexsort(q[::-1])])
        h, f, q = (torch.as_tensor(a, device=dev) for a in (h, f, q))
        if kind == "odd":
            h, f = (torch.empty(a.numel() + 1, dtype=a.dtype, device=dev)[1:]
                    .view(a.shape).copy_(a) for a in (h, f))
        err, _ = check_probe(h, f, q, NB, B)
        log("probe-edge", W1=W1, NB=NB, B=B, P2=P2, kind=kind or "valid",
            max_abs_err=err)
    W1, NB, B, P2 = 4, 65536, 32, 917504
    h, f, q = probe_case(rng, W1, NB, B, P2)
    q = q[:, np.lexsort(q[::-1])]  # sorted columns, as the resolver's smat
    h, f, q = (torch.as_tensor(np.ascontiguousarray(a), device=dev)
               for a in (h, f, q))
    err, t = check_probe(h, f, q, NB, B, timed=True)
    bid = probe.probe_ranks_ref(h, f, q, NB=NB, B=B)[0].cpu().numpy()
    bound_ms, _ = probe_bound(W1, NB, B, P2, bid)
    log("probe-slice", W1=W1, NB=NB, B=B, P2=P2, max_abs_err=err,
        bound_ms=f"{bound_ms:.5f}", **fmt_times(t))


# ------------------------------------------------------- phase-2 kernel


class Phase2Tap:
    """Phase 2's rounds (resolver/phase2.py, the CUDA kernel on the card)
    while the block is open: the calls on the card counted, and the last
    one's operands kept by reference (the callers build them fresh per
    chunk, shard step or batch, and neither they nor the kernel write to
    them afterwards), held against the plain version afterwards by
    phase2_check; also the launches under each tier phase2.choose_tier
    picks and, for its A/B, that tier's largest operands (the most reads,
    writes or txns, among those both tiers can run where there are such;
    the last of equals) (by_tier: {tier: operands, launches, key})."""

    def __init__(self):
        self.calls = 0
        self.captured = {}
        self.by_tier = {}

    def __enter__(self) -> "Phase2Tap":
        from foundationdb_tpu_torch.resolver import phase2

        real = self._real = phase2.phase2_rounds

        def rounds(base_conf, conflict0, it0, cap, **kw):
            n0 = phase2.LAUNCHES
            out = real(base_conf, conflict0, it0, cap, **kw)
            if base_conf.is_cuda:
                self.calls += 1
                self.captured = dict(
                    base_conf=base_conf, conflict0=conflict0, it0=it0,
                    cap=cap, **{k: v for k, v in kw.items()
                                if k != "groups"})
                shape = (base_conf.shape[0], kw["rtxn"].shape[0],
                         kw["wtxn"].shape[0], kw["n_leaves"])
                geo = kw.get("q_end") is not None
                lim = phase2.device_limits(base_conf.device)
                tier = phase2.choose_tier(*shape, lim, geo=geo)[0]
                # both tiers can run it, then its most items a thread
                key = (phase2.block_bytes(*shape, geo)
                       <= lim["smem_per_block"], max(shape[:3]))
                kept = self.by_tier.setdefault(tier, {"launches": 0})
                kept["launches"] += phase2.LAUNCHES - n0
                if key >= kept.get("key", (False, -1)):
                    kept.update(self.captured, key=key)
            return out

        phase2.phase2_rounds = rounds
        return self

    def __exit__(self, *exc) -> None:
        from foundationdb_tpu_torch.resolver import phase2

        phase2.phase2_rounds = self._real


def phase2_bound(cap: dict, rounds: int) -> tuple[float, str]:
    """Least ms for the kernel's work on this card, and what bounds it:
    the larger of its bytes, every operand it reads read once (base_conf
    4 T, and conflict0 4 T where there is no seed: a seeded call does
    not read it; rtxn, lo, hi and leaf 16 R, perm, seg_lo, seg_hi and
    wtxn 16 Wr, w_valid Wr; in the geometry form q_end in place of lo and
    hi, 12 R, and no perm, 12 Wr) and the output written once (4 T + 4),
    over the memory rate, and its operations over the 32-bit integer
    peak: per round, per read a min over its leaf's ancestors, a
    range-min, a compare and a max (log2 n_leaves + 4), per write a
    gather, a compare and a select (3), per txn a max and a compare (2);
    with the seed, one more such round and n_jump jumps of 3 gathers per
    txn and the sentinel (3 (T + 1)); with the geometry, a bit and a rank
    a write (2), two ranks a read (2) and a clear and a count a slot word
    (n_leaves / 16). The rounds re-read operands that
    fit in L2 (under 12 MB of the card's 50 MB at the smoke's sizes), so
    only the first read crosses HBM."""
    from foundationdb_tpu_torch.resolver.phase2 import n_jump

    T, R, Wr = (cap[k].shape[0] for k in ("base_conf", "rtxn", "wtxn"))
    seeded = bool(cap.get("seed"))
    geo = cap.get("q_end") is not None
    t_bytes = ((12 - 4 * seeded) * T + 4 + (16 - 4 * geo) * R
               + (17 - 4 * geo) * Wr) / HBM_BYTES_PER_S * 1e3
    ops = (rounds + seeded) * (R * (cap["n_leaves"].bit_length() + 4)
                               + 3 * Wr + 2 * T)
    ops += seeded * n_jump(T) * 3 * (T + 1)
    ops += geo * (2 * Wr + 2 * R + -(-cap["n_leaves"] // 16))
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase2_tiers(cap: dict) -> dict:
    """{tier: its size} for each tier that can run these operands: the
    one phase2.choose_tier picks first, then the other where it fits."""
    from foundationdb_tpu_torch.resolver import phase2

    T, R, Wr = (cap[k].shape[0] for k in ("base_conf", "rtxn", "wtxn"))
    L = cap["n_leaves"]
    geo = cap.get("q_end") is not None
    lim = phase2.device_limits(cap["base_conf"].device)
    name, size, _ = phase2.choose_tier(T, R, Wr, L, lim, geo=geo)
    tiers = {name: size}
    if name == "block":
        tiers["grid"] = phase2.choose_tier(T, R, Wr, L, lim, "grid",
                                           geo=geo)[1]
    elif phase2.block_bytes(T, R, Wr, L, geo) <= lim["smem_per_block"]:
        tiers["block"] = 1
    return tiers


def phase2_check(cap: dict, name: str, timed: bool = False,
                 tier: str | None = None):
    """The kernel (under `tier`, else the rule's) against its plain
    version on the same CUDA tensors: conflict vector and round counter
    bit for bit (fails otherwise). Returns (max |diff|, rounds, times):
    times, if timed, {"ms": warm, "ms_cold": after an L2 flush,
    "plain_ms": the plain version's grouped loop, host reads included},
    device ms per call by device_ms."""
    import torch
    from foundationdb_tpu_torch.resolver import phase2
    from foundationdb_tpu_torch.timing import device_ms, l2_flusher

    args = (cap["base_conf"], cap["conflict0"], cap["it0"], cap["cap"])
    kw = {k: v for k, v in cap.items() if k not in (
        "base_conf", "conflict0", "it0", "cap", "launches", "key")}
    n0 = phase2.LAUNCHES
    got = phase2.phase2_rounds_launch(*args, tier=tier, **kw)
    want = phase2.phase2_rounds_ref(*args, **kw)[:2]
    torch.cuda.synchronize()
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              for g, w in zip(got, want))
    rounds = int(got[1]) - cap["it0"]
    if err:
        fail(f"{name}: the phase-2 kernel ({tier or 'rule'} tier) disagrees "
             f"with its plain version (T={cap['base_conf'].shape[0]} "
             f"R={cap['rtxn'].shape[0]} Wr={cap['wtxn'].shape[0]} "
             f"n_leaves={cap['n_leaves']} seed={bool(kw.get('seed'))}): "
             f"max |diff| {err}")
    times = None
    if timed:
        def kernel():
            phase2.phase2_rounds_launch(*args, tier=tier, **kw)

        times = {"ms": device_ms(kernel, n=50),
                 "ms_cold": device_ms(
                     kernel, flush=l2_flusher(cap["base_conf"].device)),
                 "plain_ms": device_ms(
                     lambda: phase2.phase2_rounds_ref(*args, **kw))}
    phase2.LAUNCHES = n0   # comparison launches do not count
    return err, rounds, times


def phase2_entry(path: str, cap: dict, launches: int, smi: str,
                 replaces: str) -> dict:
    """The kernel on one path's last operands: checked under each tier
    that fits (the rule's first), timed, bounded, logged, as one
    kernel-table entry; the tiers' A/B is timed in turns (rule, other,
    other, rule), 50 launches a reading."""
    from foundationdb_tpu_torch.resolver import phase2
    from foundationdb_tpu_torch.timing import device_ms

    tiers = phase2_tiers(cap)
    rule = next(iter(tiers))
    err, rounds, t = phase2_check(cap, f"phase2-{path}", timed=True)
    for other in list(tiers)[1:]:
        err = max(err, phase2_check(cap, f"phase2-{path}-{other}",
                                    tier=other)[0])
    args = (cap["base_conf"], cap["conflict0"], cap["it0"], cap["cap"])
    kw = {k: v for k, v in cap.items() if k not in (
        "base_conf", "conflict0", "it0", "cap", "launches", "key")}
    n0 = phase2.LAUNCHES
    ab = {k: [] for k in tiers}
    for k in [*tiers, *reversed(tiers)]:
        ab[k].append(device_ms(lambda: phase2.phase2_rounds_launch(
            *args, tier=k, **kw), n=50))
    phase2.LAUNCHES = n0
    bound_ms, bound_by = phase2_bound(cap, rounds)
    T, R, Wr = (cap[k].shape[0] for k in ("base_conf", "rtxn", "wtxn"))
    size = {"grid_blocks": tiers["grid"]} if "grid" in tiers else {}
    seeded = bool(cap.get("seed"))
    geo = cap.get("q_end") is not None
    log(f"phase2-{path}", smi=json.dumps(smi), T=T, R=R, Wr=Wr,
        n_leaves=cap["n_leaves"], rounds=rounds, seed=seeded, geometry=geo,
        tier=rule,
        **size, max_abs_err=err, **fmt_times(t),
        ab_ms=json.dumps(ab), bound_ms=f"{bound_ms:.7f}",
        bound_by=bound_by, launches=launches)
    return {"name": "phase2_rounds", "route": "cuda",
            "source": "foundationdb_tpu_torch/csrc/phase2.cu",
            "replaces": replaces, "path": path, "launches": launches,
            "max_abs_err": err, "ms": t["ms"], "ms_cold": t["ms_cold"],
            "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "rounds": rounds,
            "tier": rule, **size, "seed": seeded, "geometry": geo,
            "ab_ms": ab}


def geometry_bound(cap: dict) -> tuple[float, str]:
    """Least ms for phase 2's geometry as a function (tpu.py:358-365):
    its inputs read once (s_begin 4 Wr, q_begin and q_end 8 R) and its
    outputs written once (perm 4 Wr, lo and hi 8 R) over the memory rate,
    against its operations (a clear and a count a slot, a bit and a rank
    a write, two ranks a read) over the integer rate."""
    R, Wr = cap["rtxn"].shape[0], cap["wtxn"].shape[0]
    t_bytes = 4 * (2 * Wr + 4 * R) / HBM_BYTES_PER_S * 1e3
    t_ops = (2 * cap["n_leaves"] + 2 * Wr + 2 * R) / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def geometry_entry(path: str, cap: dict, launches: int, smi: str) -> dict:
    """Phase 2's geometry, inside the kernel's geometry form, on one
    path's last operands: the geometry form held bit for bit against the
    operand form given geometry_ref's perm, lo and hi (the plain version
    of the prologue) on the card; the prologue's time as the geometry
    form's minus the operand form's, both under the rule's tier, warm in
    turns (geometry, operands, operands, geometry, 50 launches a reading)
    and cold; geometry_ref's time as the plain version's; its bound."""
    import torch
    from foundationdb_tpu_torch.resolver import phase2
    from foundationdb_tpu_torch.timing import device_ms, l2_flusher

    args = (cap["base_conf"], cap["conflict0"], cap["it0"], cap["cap"])
    kw = {k: v for k, v in cap.items() if k not in (
        "base_conf", "conflict0", "it0", "cap", "launches", "key")}
    ref = (kw["seg_lo"], kw["leaf"], kw["q_end"], kw["n_leaves"])
    perm, lo, hi = phase2.geometry_ref(*ref)
    ops = {k: v for k, v in kw.items() if k != "q_end"}
    ops.update(perm=perm, lo=lo, hi=hi)
    tier = next(iter(phase2_tiers(cap)))
    n0 = phase2.LAUNCHES
    got = phase2.phase2_rounds_launch(*args, tier=tier, **kw)
    via = phase2.phase2_rounds_launch(*args, tier=tier, **ops)
    torch.cuda.synchronize()
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              for g, w in zip(got, via))
    if err:
        fail(f"phase2-geometry-{path}: the geometry form disagrees with the "
             f"operand form: max |diff| {err}")
    forms = {"geometry": kw, "operands": ops}

    def run(form):
        return lambda: phase2.phase2_rounds_launch(*args, tier=tier,
                                                   **forms[form])

    ab = {k: [] for k in forms}
    for k in ("geometry", "operands", "operands", "geometry"):
        ab[k].append(device_ms(run(k), n=50))
    flush = l2_flusher(cap["base_conf"].device)
    cold = {k: device_ms(run(k), flush=flush) for k in forms}
    phase2.LAUNCHES = n0   # comparison launches do not count
    t = {"ms": float(np.mean(ab["geometry"]) - np.mean(ab["operands"])),
         "ms_cold": cold["geometry"] - cold["operands"],
         "plain_ms": device_ms(lambda: phase2.geometry_ref(*ref))}
    bound_ms, bound_by = geometry_bound(cap)
    R, Wr = cap["rtxn"].shape[0], cap["wtxn"].shape[0]
    log(f"phase2-geometry-{path}", smi=json.dumps(smi), R=R, Wr=Wr,
        P2=cap["n_leaves"], tier=tier, max_abs_err=err, **fmt_times(t),
        ab_ms=json.dumps(ab), cold_ms=json.dumps(cold),
        bound_ms=f"{bound_ms:.7f}", bound_by=bound_by, launches=launches)
    return {"name": "phase2_geometry", "route": "cuda",
            "source": "foundationdb_tpu_torch/csrc/phase2.cu",
            "replaces": "foundationdb_tpu/resolver/tpu.py:358", "path": path,
            "launches": launches, "max_abs_err": err, "ms": t["ms"],
            "ms_cold": t["ms_cold"], "plain_ms": t["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "tier": tier, "ab_ms": ab, "cold_ms": cold}


def phase2_entries(path: str, cap: dict, launches: int, smi: str,
                   replaces: str) -> list:
    """phase2_entry, and geometry_entry where the path's calls take the
    geometry form."""
    out = [phase2_entry(path, cap, launches, smi, replaces)]
    if cap.get("q_end") is not None:
        out.append(geometry_entry(path, cap, launches, smi))
    return out


P2_REPLACES = {"gpu": "foundationdb_tpu/resolver/tpu.py:435",
               "rankfed": "foundationdb_tpu/resolver/rankfed.py:251"}


def phase_phase2(device=None) -> None:
    """The kernel's first calls, through both callers on the card, at the
    cases where the fixed point is slowest: a pure abort chain (txn i
    reads what txn i-1 writes) of 15 and of 16 txns through a
    ConflictSetGPU (its pointer-jumping seed resolves a chain at once:
    one verification round) and through a ConflictSetRankFed (no seed:
    one round a link, n rounds for n txns in T = 16, across the plain
    version's round groups). Statuses alternate; each call's operands
    hold the kernel bit-exact against the plain version, conflict vector
    and round counter, under each tier (block and grid), and again with
    the cap cut to 5 rounds, where both stop mid-chain."""
    from foundationdb_tpu_torch.kv.keys import KeyRange
    from foundationdb_tpu_torch.resolver.gpu import ConflictSetGPU
    from foundationdb_tpu_torch.resolver.rankfed import ConflictSetRankFed
    from foundationdb_tpu_torch.resolver.types import TxnConflictInfo

    def chain(n):
        pt = lambda a: KeyRange(k8(a), k8(a) + b"\x00")  # noqa: E731
        return [TxnConflictInfo(9, [pt(i - 1)] if i else [], [pt(i)])
                for i in range(n)]

    for kind, make in (("gpu", lambda: ConflictSetGPU(
                           max_key_bytes=9, initial_capacity=64,
                           device=device)),
                       ("rankfed", lambda: ConflictSetRankFed(
                           max_key_bytes=12, initial_capacity=64,
                           device=device))):
        for n in (15, 16):
            with Phase2Tap() as tap:
                st = list(make().resolve(10, 0, chain(n)).statuses)
            if st != [i % 2 for i in range(n)]:
                fail(f"phase2: {kind} chain of {n}: statuses {st}")
            if tap.calls != 1:
                fail(f"phase2: {kind} chain of {n}: {tap.calls} kernel "
                     "calls, 1 expected")
            cap = tap.captured
            T = cap["base_conf"].shape[0]
            want = 1 if kind == "gpu" else n
            errs, cuts = [], []
            for tier in ("block", "grid"):
                err, rounds, _ = phase2_check(cap, f"phase2-{kind}-{n}",
                                              tier=tier)
                if rounds != want:
                    fail(f"phase2: {kind} chain of {n} in T = {T} ({tier} "
                         f"tier): {rounds} rounds, {want} expected")
                err_cap, cut, _ = phase2_check(
                    dict(cap, cap=cap["it0"] + 5), f"phase2-{kind}-{n}-cap",
                    tier=tier)
                if cut != min(want, 5):
                    fail(f"phase2: {kind} chain of {n} with the cap at 5 "
                         f"rounds ({tier} tier): {cut} rounds")
                errs += [err, err_cap]
                cuts.append(cut)
            log("phase2", caller=kind, chain=n, T=T, rounds=want,
                seed=bool(cap.get("seed")), tiers="block,grid",
                max_abs_err=max(errs), statuses_alternate=True,
                capped_rounds=cuts[0])


# ------------------------------------------------- block kernels (decode,
# phase 1, phase 3)

BLOCK_REPLACES = {"decode": "foundationdb_tpu/resolver/tpu.py:215",
                  "phase1": "foundationdb_tpu/resolver/tpu.py:729",
                  "phase3": "foundationdb_tpu/resolver/tpu.py:768"}
BLOCK_NAMES = {"decode": "decode_fused", "phase1": "phase1",
               "phase3": "phase3"}


class BlockTap:
    """The block kernel's decode, phase 1 and phase 3 (resolver/block.py,
    the kernels of csrc/block.cu on the card) while the block is open:
    their launches counted by the wrappers (block.LAUNCHES, reset on
    entry), and the operands of the last fast step on the card kept for
    block_entries (its decode's, held until its phase 1 shows the step
    is a fast one and not a compaction): the decode's and phase 1's by
    reference (fresh per chunk, never written after), phase 1's version
    row and tree and phase 3's state cloned before the call (phase 3
    updates them in place)."""

    device_types = ("cuda",)   # where a call's operands are kept

    def __init__(self):
        self.captured = {}

    def __enter__(self) -> "BlockTap":
        from foundationdb_tpu_torch.resolver import block

        self._real = real = (block.decode_fused, block.phase1, block.phase3)
        for k in block.LAUNCHES:
            block.LAUNCHES[k] = 0

        def dec(fused, *, lay):
            if fused.device.type in self.device_types:
                self._decode = dict(fused=fused, lay=lay)
            return real[0](fused, lay=lay)

        def p1(hv, btree, *args, NB, B):
            if hv.device.type in self.device_types:
                self.captured["decode"] = self._decode
                self.captured["phase1"] = dict(
                    args=(hv.clone(), btree.clone(), *args), NB=NB, B=B)
            return real[1](hv, btree, *args, NB=NB, B=B)

        def p3(hmat, counts, btree, n, **kw):
            if hmat.device.type in self.device_types:
                self.captured["phase3"] = dict(
                    state=(hmat.clone(), counts.clone(), btree.clone(), n),
                    kw=kw)
            return real[2](hmat, counts, btree, n, **kw)

        block.decode_fused, block.phase1, block.phase3 = dec, p1, p3
        return self

    def __exit__(self, *exc) -> None:
        from foundationdb_tpu_torch.resolver import block

        self.launches = dict(block.LAUNCHES)
        block.decode_fused, block.phase1, block.phase3 = self._real

    def check_launches(self, name: str, fast: int, dispatches: int) -> None:
        """One decode per dispatch (fast step or compaction), one phase 1
        and one phase 3 per fast step, or fail."""
        n = self.launches
        want = {"decode": dispatches, "phase1": fast, "phase3": fast}
        if n != want:
            fail(f"{name}: block kernel launches {n}, {want} expected "
                 f"({fast} fast steps in {dispatches} dispatches)")


def block_run(kernel: str, cap: dict, plain: bool = False, stamps=None,
              launch=None):
    """One call of a block kernel (or its plain version) on the captured
    operands, the in-place state of phase 3 on copies. Returns its
    outputs, phase 3's state after it included. stamps: the kernel's
    stage stamp buffer (block.py's *_STAGES), for decode and phase 3 only;
    launch: another build's launch of decode or phase 3, called as
    block.decode_fused_launch(fused, lay=) or block.phase3_launch(ts, K=,
    NB=, B=) are (without stamps)."""
    from foundationdb_tpu_torch.resolver import block

    st = {} if stamps is None else {"stamps": stamps}
    if kernel == "decode":
        if plain:
            return block.decode_fused_ref(cap["fused"], lay=cap["lay"])
        fn = launch or block.decode_fused_launch
        return fn(cap["fused"], lay=cap["lay"], **st)
    if kernel == "phase1":
        if plain:
            return (block.phase1_ref(*cap["args"], NB=cap["NB"],
                                     B=cap["B"]),)
        names = ("hv", "btree", "bid", "lb_loc", "eq_loc", "q_begin",
                 "q_end", "rsnap", "rtxn", "too_old")
        return (block.phase1_launch(dict(zip(names, cap["args"])),
                                    NB=cap["NB"], B=cap["B"]),)
    hmat, counts, btree, n = cap["state"]
    state = (hmat.clone(), counts.clone(), btree.clone())
    kw = cap["kw"]
    if plain:
        out = block.phase3_ref(*state, n, **kw)
    else:
        ts = dict(zip(block.PHASE3_OPERANDS, (*state, n, *(
            kw[k] for k in block.PHASE3_OPERANDS[4:]))))
        out = (launch or block.phase3_launch)(ts, K=kw["K"], NB=kw["NB"],
                                              B=kw["B"], **st)
    return (*out, *state)


def block_timer(kernel: str, cap: dict, plain: bool = False, launch=None):
    """(fn, restore): one call of the kernel (or its plain version, or
    `launch` as block_run takes it) on the captured operands for
    device_ms, and for phase 3 the restore of the state it rewrites (the
    touched blocks' columns, counts and the tree), which fn runs first;
    its own time is taken apart and subtracted."""
    import torch
    from foundationdb_tpu_torch.resolver import block

    if kernel != "phase3":
        def fn():
            block_run(kernel, cap, plain, launch=launch)
        return fn, None
    hmat0, counts0, btree0, n = cap["state"]
    kw = cap["kw"]
    hmat, counts, btree = hmat0.clone(), counts0.clone(), btree0.clone()
    B, NB = kw["B"], kw["NB"]
    g = kw["g_ids"][: int(kw["n_g"])].clamp(0, NB - 1).to(torch.int64)
    cols = (g[:, None] * B + torch.arange(B, device=g.device)).reshape(-1)
    saved = hmat0[:, cols]

    def restore():
        hmat.index_copy_(1, cols, saved)
        counts.copy_(counts0)
        btree.copy_(btree0)

    ts = dict(zip(block.PHASE3_OPERANDS, (hmat, counts, btree, n, *(
        kw[k] for k in block.PHASE3_OPERANDS[4:]))))
    run = launch or block.phase3_launch

    def fn():
        restore()
        if plain:
            block.phase3_ref(hmat, counts, btree, n, **kw)
        else:
            run(ts, K=kw["K"], NB=NB, B=B)
    return fn, restore


def block_bound(kernel: str, cap: dict) -> tuple[float, str]:
    """Least ms for the kernel's work on this card: the bytes it must
    move, each input read once and each output written once, counted for
    this run's data, over the memory rate (its integer operations, a few
    per byte, are far below the card's rate). decode: the fused buffer in;
    the endpoint matrix, rtxn, rsnap, wtxn (4 bytes a row), w_valid and
    too_old (a byte a row) out (q_begin and q_end are views of the
    buffer). phase 1: per read its two positions,
    snapshot and txn (16), the probe's ranks there (20), the version rows
    of the distinct blocks its head and tail read (4 B a block), the
    distinct tree nodes of its interior (4 a node), too_old in and
    base_conf out (5 T). phase 3: per write its two positions, txn and
    validity (13 Wr), per endpoint its key column and ranks (4 W1 + 12),
    the conflict and too_old vectors (5 T), the touched ids (4 K), the
    touched blocks' state in and out (2 x 4 (W + 2) B a block, their
    counts, leaves and ancestors' distinct nodes), st_aux out (T + 6)."""
    import torch
    from foundationdb_tpu_torch.resolver._ops import _canonical_nodes_flat

    if kernel == "decode":
        lay = cap["lay"]
        W1 = lay.n_words + 1
        nbytes = (4 * lay.total + 4 * W1 * lay.P2 + 8 * lay.R + 5 * lay.Wr
                  + lay.T)
    elif kernel == "phase1":
        hv, btree, bid, lb, eq, qb, qe, rsnap, rtxn, too_old = cap["args"]
        NB, B = cap["NB"], cap["B"]
        R, T = qb.shape[0], too_old.shape[0]
        rb, re = bid[qb.long()], bid[qe.long()]
        blocks = torch.unique(torch.cat([rb, re])).numel()
        nodes, _ = _canonical_nodes_flat(torch.minimum(rb + 1, re), re, NB)
        n_nodes = torch.unique(nodes[nodes > 0]).numel()
        nbytes = 36 * R + 4 * B * blocks + 4 * n_nodes + 5 * T
    else:
        hmat, counts, btree, n = cap["state"]
        kw = cap["kw"]
        W1, Wr = kw["smat"].shape[0], kw["s_begin"].shape[0]
        T, K, NB, B = (kw["conflict"].shape[0], kw["K"], kw["NB"],
                       kw["B"])
        ng = int(kw["n_g"])
        leaves = kw["g_ids"][:ng].long() + NB
        anc = torch.unique(torch.cat([leaves >> i for i in range(
            NB.bit_length())]))
        nbytes = (13 * Wr + 2 * Wr * (4 * W1 + 12) + 5 * T + 4 * K
                  + ng * 8 * (W1 + 1) * B + 8 * ng + 8 * anc.numel()
                  + T + 6)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return t_bytes, "bytes"


def block_entries(path: str, cap: dict, launches: dict, smi: str) -> list:
    """Each block kernel held against its plain version on one path's last
    operands on the card, bit for bit (fails otherwise), timed warm (50
    launches an event pair) and cold (after an L2 flush), its plain
    version timed, bounded, logged: one kernel-table entry each."""
    import torch
    from foundationdb_tpu_torch.resolver import block
    from foundationdb_tpu_torch.timing import device_ms, l2_flusher

    out = []
    n0 = dict(block.LAUNCHES)
    for kernel in ("decode", "phase1", "phase3"):
        c = cap.get(kernel)
        if not c:
            fail(f"{path}: the {kernel} kernel was never called on the card")
        got = block_run(kernel, c)
        want = block_run(kernel, c, plain=True)
        torch.cuda.synchronize()
        err = 0
        for g, w in zip(got, want):
            if g.dtype != w.dtype or g.shape != w.shape:
                fail(f"{path}: {kernel} output {tuple(g.shape)} {g.dtype} "
                     f"vs plain {tuple(w.shape)} {w.dtype}")
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()) if g.numel() else 0)
        if err:
            fail(f"{path}: the {kernel} kernel disagrees with its plain "
                 f"version: max |diff| {err}")
        fn, restore = block_timer(kernel, c)
        pfn, _ = block_timer(kernel, c, plain=True)
        dev = got[0].device
        flush = l2_flusher(dev)
        base_w = device_ms(restore, n=50) if restore else 0.0
        base_c = device_ms(restore, flush=flush) if restore else 0.0
        t = {"ms": device_ms(fn, n=50) - base_w,
             "ms_cold": device_ms(fn, flush=flush) - base_c,
             "plain_ms": device_ms(pfn) - (device_ms(restore) if restore
                                           else 0.0)}
        if kernel == "phase3":
            t.update(phase3_levels(path, c, flush))
        bound_ms, bound_by = block_bound(kernel, c)
        shape = _block_shape(kernel, c)
        log(f"block-{kernel}-{path}", smi=json.dumps(smi), **shape,
            max_abs_err=err, **fmt_times(t), bound_ms=f"{bound_ms:.7f}",
            bound_by=bound_by, launches=launches[kernel])
        out.append({"name": BLOCK_NAMES[kernel], "route": "cuda",
                    "source": "foundationdb_tpu_torch/csrc/block.cu",
                    "replaces": BLOCK_REPLACES[kernel], "path": path,
                    "launches": launches[kernel], "max_abs_err": err,
                    "ms": t["ms"], "ms_cold": t["ms_cold"],
                    "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None, **shape,
                    **{k: t[k] for k in ("levels_ms", "levels_ms_cold")
                       if k in t}})
    log_block_stages(path, cap, smi)
    for k, v in n0.items():   # comparison launches do not count
        block.LAUNCHES[k] = v
    return out


def log_block_stages(path: str, cap: dict, smi: str) -> None:
    """[block-stages-<kernel>-<path>] for decode and phase 3: each stage's
    median ns and share of 21 stamped launches on the path's last
    operands, the previous design's (PREV_STAGES) beside them."""
    from foundationdb_tpu_torch.resolver import block

    for kernel, stages in (("decode", block.DECODE_STAGES),
                           ("phase3", block.PHASE3_STAGES)):
        c = cap[kernel]
        dev = (c["fused"] if kernel == "decode" else c["state"][0]).device
        ns = stamped_ns(lambda buf: block_run(kernel, c, stamps=buf),
                        len(stages), dev)
        log_stages(f"block-stages-{kernel}-{path}", stages, ns,
                   PREV_STAGES.get((kernel, path), {}), smi)


def phase3_levels(path: str, cap: dict, flush) -> dict:
    """Phase 3's tree update both ways on one path's operands: the same
    call with the first touched block's stored leaf raised to INT32_MAX,
    so that the leaf falls and the kernel takes its level-by-level loop
    instead of the atomicMax walk. Held bit for bit against the plain
    version (fails otherwise), timed warm and cold like the kernel."""
    import torch
    from foundationdb_tpu_torch.timing import device_ms

    hmat, counts, btree, n = cap["state"]
    kw = cap["kw"]
    NB = kw["NB"]
    if int(kw["n_g"]) < 1:
        return {}
    leaf = NB + kw["g_ids"][:1].clamp(0, NB - 1).long()
    raised = btree.clone()
    raised[leaf] = torch.iinfo(torch.int32).max
    c = dict(cap, state=(hmat, counts, raised, n))
    got, want = block_run("phase3", c), block_run("phase3", c, plain=True)
    if int(want[-1][leaf]) == torch.iinfo(torch.int32).max:
        fail(f"{path}: the raised leaf did not fall in phase 3")
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            fail(f"{path}: phase 3's level loop disagrees with its plain "
                 "version")
    fn, restore = block_timer("phase3", c)
    return {"levels_ms": device_ms(fn, n=50) - device_ms(restore, n=50),
            "levels_ms_cold": (device_ms(fn, flush=flush)
                               - device_ms(restore, flush=flush))}


def _block_shape(kernel: str, cap: dict) -> dict:
    if kernel == "decode":
        lay = cap["lay"]
        return {"W1": lay.n_words + 1, "P2": lay.P2, "R": lay.R,
                "Wr": lay.Wr, "T": lay.T}
    if kernel == "phase1":
        a = cap["args"]
        return {"NB": cap["NB"], "B": cap["B"], "R": a[5].shape[0],
                "T": a[9].shape[0]}
    kw = cap["kw"]
    return {"K": kw["K"], "n_g": int(kw["n_g"]), "NB": kw["NB"],
            "B": kw["B"], "Wr": kw["s_begin"].shape[0],
            "W1": kw["smat"].shape[0]}


# The compaction kernels (csrc/compact.cu): what each replaces in tpu.py.
COMPACT_REPLACES = {
    "densify": "foundationdb_tpu/resolver/tpu.py:947",
    "ranks": "foundationdb_tpu/resolver/tpu.py:457",
    "dense_phase3": "foundationdb_tpu/resolver/tpu.py:481",
    "redistribute": "foundationdb_tpu/resolver/tpu.py:978",
}
# A [full-profile] batch's device ops, and one compaction's, with the
# compaction as torch ops around the decode and phase 2 (H100 80GB
# HBM3, 700 W; PERF.md)
TORCH_COMPACTION_DEVICE_OPS = 3_520
TORCH_COMPACTION_OPS_PER_COMPACTION = "836-840"


class CompactTap:
    """The compaction kernels (resolver/compact.py, csrc/compact.cu on the
    card) while the block is open: their launches counted by the wrappers
    (compact.LAUNCHES, reset on entry), and the operands of the last
    compaction on the card kept for compact_entries, by reference (every
    operand is fresh per compaction and never written after) but
    redistribute's st_aux, which it raises in place: cloned before the
    call. Every compaction's counts and dense live count n are kept too
    (`live_m`, `live_n`), read only after the run: the live shares."""

    device_types = ("cuda",)   # where a call's operands are kept
    KERNELS = ("densify", "ranks", "dense_phase3", "redistribute")

    def __init__(self):
        self.captured = {}

    def __enter__(self) -> "CompactTap":
        from foundationdb_tpu_torch.resolver import compact

        self._real = real = tuple(getattr(compact, k) for k in self.KERNELS)
        for k in compact.LAUNCHES:
            compact.LAUNCHES[k] = 0
        keep = self.device_types

        def densify(hmat, counts, *, B):
            if hmat.device.type in keep:
                self.captured["densify"] = dict(args=(hmat, counts), B=B)
                self.captured.setdefault("live_m", []).append(counts)
            return real[0](hmat, counts, B=B)

        def ranks(*args):
            if args[0].device.type in keep:
                self.captured["ranks"] = dict(args=args)
            return real[1](*args)

        def dense_phase3(hmat, n, **kw):
            if hmat.device.type in keep:
                self.captured["dense_phase3"] = dict(args=(hmat, n), kw=kw)
                self.captured.setdefault("live_n", []).append(
                    (n, hmat.shape[1]))
            return real[2](hmat, n, **kw)

        def redistribute(hmat_d, new_n, st_aux, *, NB_out, B):
            if hmat_d.device.type in keep:
                self.captured["redistribute"] = dict(
                    args=(hmat_d, new_n, st_aux.clone()), NB_out=NB_out, B=B)
            return real[3](hmat_d, new_n, st_aux, NB_out=NB_out, B=B)

        for k, f in zip(self.KERNELS, (densify, ranks, dense_phase3,
                                       redistribute)):
            setattr(compact, k, f)
        return self

    def __exit__(self, *exc) -> None:
        from foundationdb_tpu_torch.resolver import compact

        self.launches = dict(compact.LAUNCHES)
        for k, f in zip(self.KERNELS, self._real):
            setattr(compact, k, f)

    def check_launches(self, name: str, compactions: int) -> None:
        """One launch of each compaction kernel per compaction (per shard
        step of one), or fail."""
        want = {k: compactions for k in self.KERNELS}
        if self.launches != want:
            fail(f"{name}: compaction kernel launches {self.launches}, "
                 f"{want} expected ({compactions} compactions)")


def compact_run(kernel: str, cap: dict, plain: bool = False, stamps=None):
    """One call of a compaction kernel (or its plain version) on the
    captured operands; redistribute on a copy of its st_aux, which it
    returns after its outputs. stamps: the kernel's stage stamp buffer
    (compact.py's *_STAGES), for the kernels only."""
    from foundationdb_tpu_torch.resolver import compact

    if kernel == "densify":
        if plain:
            return compact.densify_ref(*cap["args"], B=cap["B"])
        return compact.densify_launch(*cap["args"], B=cap["B"],
                                      stamps=stamps)
    if kernel == "ranks":
        if plain:
            return compact.ranks_ref(*cap["args"])
        return compact.ranks_launch(dict(zip(compact.RANKS_OPERANDS,
                                             cap["args"])), stamps=stamps)
    if kernel == "dense_phase3":
        hmat, n = cap["args"]
        if plain:
            return compact.dense_phase3_ref(hmat, n, **cap["kw"])
        return compact.dense_phase3_launch(dict(zip(
            compact.DENSE_PHASE3_OPERANDS,
            (hmat, n, *(cap["kw"][k]
                        for k in compact.DENSE_PHASE3_OPERANDS[2:])))),
            stamps=stamps)
    hmat_d, new_n, st_aux = cap["args"]
    st = st_aux.clone()
    if plain:
        return (*compact.redistribute_ref(hmat_d, new_n, st,
                                          NB_out=cap["NB_out"], B=cap["B"]),
                st)
    return (*compact.redistribute_launch(hmat_d, new_n, st,
                                         NB_out=cap["NB_out"], B=cap["B"],
                                         stamps=stamps), st)


def compact_timer(kernel: str, cap: dict, plain: bool = False):
    """One call of the kernel (or its plain version) on the captured
    operands for device_ms. redistribute raises one byte of st_aux in
    place, which is the same after every call: it runs on one copy made
    here, outside the timed calls."""
    if kernel != "redistribute":
        return lambda: compact_run(kernel, cap, plain)
    from foundationdb_tpu_torch.resolver import compact

    hmat_d, new_n, st_aux = cap["args"]
    st = st_aux.clone()
    fn = compact.redistribute_ref if plain else compact.redistribute_launch
    return lambda: fn(hmat_d, new_n, st, NB_out=cap["NB_out"], B=cap["B"])


def compact_bound(kernel: str, cap: dict) -> tuple[float, str]:
    """Least ms for the kernel's work on this card, the larger of its
    bytes over the memory rate and its integer operations over the
    card's 32-bit rate, each counted for this run's data (each input
    read once, each output written once). densify: the live columns in
    (W + 2 rows a column) and the counts, the dense state out; ops one
    compare a key word of each live column. ranks: the endpoint matrix,
    the reads' four operands and too_old in, ub, eq and base_conf out,
    the distinct history columns at the endpoints' lower ranks (W + 1
    words each) and the distinct version slots of the reads' windows;
    ops the walk's compares (W + 1 words a step, log2 C steps an
    endpoint). dense_phase3: the n live columns, the write endpoints'
    key columns, positions, txns, validity, ranks and eq, the conflict
    and too_old vectors in, the dense state and st_aux out; ops five
    counts per merged slot that can hold a valid run (n + 2 Wr).
    redistribute: the min(new_n, C)
    live columns in, the block state, counts, tree and fences out; ops a
    word per output column row."""
    import torch
    from foundationdb_tpu_torch.resolver._ops import _lower_rank

    if kernel == "densify":
        hmat, counts = cap["args"]
        W2, C = hmat.shape
        m = int(counts.sum())
        nbytes = 4 * W2 * m + 4 * counts.shape[0] + 4 * W2 * C + 4
        ops = (W2 - 1) * m
    elif kernel == "ranks":
        hmat, _, smat, qb, qe, rsnap, rtxn, too_old = cap["args"]
        W1, P2 = smat.shape
        C = hmat.shape[1]
        R, T = qb.shape[0], too_old.shape[0]
        lb = _lower_rank(hmat[:W1], smat)
        cols = torch.unique(torch.clamp(lb, 0, C - 1)).numel()
        ub = compact_run("ranks", cap, plain=True)[0]
        lo = torch.clamp(ub[qb.long()] - 1, 0, C).long()
        hi = torch.clamp(lb[qe.long()], 0, C).long()
        cover = torch.zeros(C + 1, dtype=torch.int64, device=lo.device)
        live = hi > lo
        cover.index_add_(0, lo[live], torch.ones_like(lo[live]))
        cover.index_add_(0, hi[live], -torch.ones_like(hi[live]))
        slots = int((torch.cumsum(cover, 0)[:C] > 0).sum())
        nbytes = (4 * W1 * P2 + 16 * R + T + 5 * P2 + 4 * T
                  + 4 * W1 * cols + 4 * slots)
        ops = 2 * W1 * P2 * max(C.bit_length() - 1, 1)
    elif kernel == "dense_phase3":
        hmat, n = cap["args"]
        kw = cap["kw"]
        W2, C = hmat.shape
        W1 = W2 - 1
        Wr, T = kw["s_begin"].shape[0], kw["conflict"].shape[0]
        M = 2 * Wr
        nbytes = (4 * W2 * int(n) + M * (4 * W1 + 4 + 5) + 9 * Wr + 5 * T
                  + 4 * W2 * C + T + 6 + 4)
        ops = 5 * (int(n) + M)
    else:
        hmat_d, new_n, _ = cap["args"]
        W2, C = hmat_d.shape
        NB, B = cap["NB_out"], cap["B"]
        nbytes = (4 * W2 * min(int(new_n), C) + 4 * W2 * NB * B + 4 * NB
                  + 8 * NB + 4 * (W2 - 1) * NB + 1)
        ops = W2 * NB * B
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compact_shape(kernel: str, cap: dict) -> dict:
    if kernel == "densify":
        hmat, counts = cap["args"]
        return {"W2": hmat.shape[0], "C": hmat.shape[1],
                "NB": counts.shape[0], "B": cap["B"]}
    if kernel == "ranks":
        hmat, n, smat, qb, *_, too_old = cap["args"]
        return {"W1": smat.shape[0], "C": hmat.shape[1], "n": int(n),
                "P2": smat.shape[1], "R": qb.shape[0], "T": too_old.shape[0]}
    if kernel == "dense_phase3":
        hmat, n = cap["args"]
        kw = cap["kw"]
        return {"C": hmat.shape[1], "n": int(n), "P2": kw["smat"].shape[1],
                "Wr": kw["s_begin"].shape[0], "T": kw["conflict"].shape[0]}
    hmat_d, new_n, _ = cap["args"]
    return {"C": hmat_d.shape[1], "new_n": int(new_n),
            "NB_out": cap["NB_out"], "B": cap["B"]}


# The previous design of each compaction and block kernel by stage on
# each path's last operands, which [compact-stages-*] and
# [block-stages-*] print beside the current kernels' stages: median ns
# of stamped launches on an H100 80GB HBM3 at 700.00 W (PERF.md; 21
# launches, the block kernels 11). densify and dense_phase3 before their
# redesign (three-stage TupleScans over the capacity C, 5 and 17 grid
# barriers); ranks and redistribute before theirs (a halving walk a
# thread over C and a grid barrier a maximum level; a thread a word of
# the block state and a grid barrier a tree pass); the block kernel's
# decode and phase 3 before theirs (three-stage scans, 3 and 10 grid
# barriers, a binary search a row over the txn starts, a merge of one
# row a round trip, a chain of atomics a leaf); the stamps added for
# the reading.
PREV_STAGES = {
    ("decode", "resolver"): {
        "fill_tiles": 3744, "tile_sums": 2208, "scan_apply": 3264,
        "rows": 18528,
    },
    ("decode", "cluster-resolver"): {
        "fill_tiles": 2368, "tile_sums": 1792, "scan_apply": 2080,
        "rows": 3520,
    },
    ("decode", "sharded"): {
        "fill_tiles": 3264, "tile_sums": 2016, "scan_apply": 3040,
        "rows": 13504,
    },
    ("phase3", "resolver"): {
        "clear": 5120, "mark": 3008, "rank_tiles": 2496, "rank_sums": 2496,
        "rank_apply": 2720, "compact": 3744, "info_depth_tiles": 8512,
        "depth_sums": 2112, "depth_apply": 2400, "merge": 42016,
        "tree": 3808,
    },
    ("phase3", "cluster-resolver"): {
        "clear": 3392, "mark": 1664, "rank_tiles": 1760, "rank_sums": 1856,
        "rank_apply": 1760, "compact": 2240, "info_depth_tiles": 5568,
        "depth_sums": 1888, "depth_apply": 1792, "merge": 12288,
        "tree": 7520,
    },
    ("phase3", "sharded"): {
        "clear": 3648, "mark": 2560, "rank_tiles": 2208, "rank_sums": 1888,
        "rank_apply": 2144, "compact": 3328, "info_depth_tiles": 5856,
        "depth_sums": 1888, "depth_apply": 2176, "merge": 13344,
        "tree": 6112,
    },
    ("ranks", "resolver"): {
        "walk_level1": 30464, "level2": 5984, "level3": 4704,
        "level4": 3904, "query": 4224,
    },
    ("ranks", "cluster-resolver"): {
        "walk_level1": 20672, "level2": 5888, "level3": 4608,
        "level4": 3520, "query": 1856,
    },
    ("ranks", "sharded"): {
        "walk_level1": 52768, "level2": 5984, "level3": 4192,
        "query": 86880,
    },
    ("redistribute", "resolver"): {
        "copy_leaves": 54368, "tree1": 3808, "tree2": 2464, "end": 2048,
    },
    ("redistribute", "cluster-resolver"): {
        "copy_leaves": 64384, "tree1": 3872, "tree2": 2464, "end": 2016,
    },
    ("redistribute", "sharded"): {
        "copy_leaves": 15904, "tree1": 3616, "tree2": 2400, "end": 2016,
    },
    ("densify", "resolver"): {
        "counts_tiles": 3648, "counts_sums": 2464, "counts_apply": 3136,
        "keep_tiles": 42080, "keep_sums": 17408, "keep_apply_pads": 39264,
    },
    ("dense_phase3", "resolver"): {
        "clear": 8544, "mark": 3360, "rank_tiles": 2720, "rank_sums": 2464,
        "rank_apply": 2624, "endpoints": 4064, "endpoint_bits": 5312,
        "merge": 101280, "runs_tiles": 16480, "runs_sums": 17824,
        "runs_apply": 26208, "valid_tiles": 10464, "valid_sums": 17824,
        "valid_apply": 13344, "keep_tiles": 9120, "keep_sums": 17824,
        "keep_apply": 12000, "gather": 32608,
    },
    ("densify", "cluster-resolver"): {
        "counts_tiles": 3648, "counts_sums": 2528, "counts_apply": 3296,
        "keep_tiles": 43296, "keep_sums": 17376, "keep_apply_pads": 42976,
    },
    ("dense_phase3", "cluster-resolver"): {
        "clear": 7584, "mark": 2464, "rank_tiles": 2400, "rank_sums": 2368,
        "rank_apply": 2368, "endpoints": 2816, "endpoint_bits": 4832,
        "merge": 109280, "runs_tiles": 16352, "runs_sums": 17824,
        "runs_apply": 26112, "valid_tiles": 9888, "valid_sums": 17728,
        "valid_apply": 13280, "keep_tiles": 9152, "keep_sums": 17888,
        "keep_apply": 12160, "gather": 42016,
    },
    ("densify", "sharded"): {
        "counts_tiles": 3104, "counts_sums": 2400, "counts_apply": 2592,
        "keep_tiles": 13056, "keep_sums": 5632, "keep_apply_pads": 10752,
    },
    ("dense_phase3", "sharded"): {
        "clear": 5376, "mark": 4064, "rank_tiles": 3456, "rank_sums": 3168,
        "rank_apply": 3744, "endpoints": 4832, "endpoint_bits": 4544,
        "merge": 36736, "runs_tiles": 6400, "runs_sums": 6528,
        "runs_apply": 9376, "valid_tiles": 4320, "valid_sums": 6400,
        "valid_apply": 5696, "keep_tiles": 4544, "keep_sums": 6720,
        "keep_apply": 5216, "gather": 9536,
    },
}


def stamped_ns(run, n_stages: int, dev, reps: int = 21) -> list:
    """Median ns of each of a kernel's n_stages stages over reps stamped
    launches (csrc/grid.cuh Stamps); run(buf) launches it with the stamp
    buffer buf."""
    import torch

    buf = torch.zeros(n_stages + 1, dtype=torch.int64, device=dev)
    rows = []
    for _ in range(reps):
        run(buf)
        torch.cuda.synchronize(dev)
        rows.append(buf.cpu().numpy().copy())
    ns = np.median(np.diff(np.array(rows), axis=1), axis=0)
    return [float(x) for x in ns]


def compact_stages(kernel: str, cap: dict, reps: int = 21) -> tuple:
    """(stage names, median ns of each stage) of the kernel over reps
    stamped launches on the captured operands (csrc/grid.cuh Stamps)."""
    from foundationdb_tpu_torch.resolver import compact

    stages = {"densify": compact.DENSIFY_STAGES,
              "ranks": compact.RANKS_STAGES,
              "dense_phase3": compact.PHASE3_STAGES,
              "redistribute": compact.REDIST_STAGES}[kernel]
    return stages, stamped_ns(
        lambda buf: compact_run(kernel, cap, stamps=buf), len(stages),
        cap["args"][0].device, reps)


def log_stages(tag: str, stages, ns, before: dict, smi: str) -> None:
    """[<tag>]: each stage's median ns and share of the stamped kernel,
    the previous design's (before: stage -> ns) beside them."""
    total = sum(ns) or 1.0
    b_total = sum(before.values()) or 1.0
    log(tag, smi=json.dumps(smi), stages=json.dumps(list(stages)),
        ns=json.dumps([round(x, 1) for x in ns]),
        share=json.dumps([round(x / total, 4) for x in ns]),
        total_ns=f"{total:.1f}", barriers=len(stages) - 1,
        prev_stages=json.dumps(list(before)),
        prev_ns=json.dumps(list(before.values())),
        prev_share=json.dumps([round(x / b_total, 4)
                               for x in before.values()]),
        prev_total_ns=f"{sum(before.values()):.1f}",
        prev_barriers=max(len(before) - 1, 0))


def log_compact_stages(path: str, cap: dict, smi: str) -> None:
    """[compact-stages-<kernel>-<path>] for each compaction kernel: each
    stage's median ns and share of the stamped kernel, the previous
    design's (PREV_STAGES) beside them; [compact-live-<path>]: every
    compaction's live shares, m / C (densify's live entries) and n / C
    (dense_phase3's); [compact-ranks-tiers-<path>]: the tiers of ranks'
    runs on the last compaction (compact.RANKS_TIERS)."""
    from foundationdb_tpu_torch.resolver import compact

    for kernel in CompactTap.KERNELS:
        stages, ns = compact_stages(kernel, cap[kernel])
        log_stages(f"compact-stages-{kernel}-{path}", stages, ns,
                   PREV_STAGES.get((kernel, path), {}), smi)
    m = [int(c.sum()) / c.numel() / cap["densify"]["B"]
         for c in cap.get("live_m", [])]
    n = [int(x) / C for x, C in cap.get("live_n", [])]
    log(f"compact-live-{path}", compactions=len(n),
        m_share=json.dumps([round(x, 4) for x in m]),
        n_share=json.dumps([round(x, 4) for x in n]))
    r = cap["ranks"]
    C, P2 = r["args"][0].shape[1], r["args"][2].shape[1]
    scratch = compact.ranks_scratch(C, P2, r["args"][0].device)
    compact.ranks_launch(dict(zip(compact.RANKS_OPERANDS, r["args"])),
                         scratch=scratch)
    tiers = compact.ranks_tiers(
        compact.ranks_tier_words(scratch, P2).tolist())
    log(f"compact-ranks-tiers-{path}", runs=len(tiers),
        tiers=json.dumps({t: tiers.count(t) for t in sorted(set(tiers))}))


def compact_entries(path: str, cap: dict, launches: dict, smi: str) -> list:
    """Each compaction kernel held against its plain version on one path's
    last compaction on the card, bit for bit (fails otherwise), timed warm
    (50 launches an event pair) and cold (after an L2 flush), its plain
    version timed, bounded, logged: one kernel-table entry each."""
    import torch
    from foundationdb_tpu_torch.resolver import compact
    from foundationdb_tpu_torch.timing import device_ms, l2_flusher

    out = []
    n0 = dict(compact.LAUNCHES)
    for kernel in CompactTap.KERNELS:
        c = cap.get(kernel)
        if not c:
            fail(f"{path}: the {kernel} kernel was never called on the card")
        got = compact_run(kernel, c)
        want = compact_run(kernel, c, plain=True)
        torch.cuda.synchronize()
        err = 0
        for g, w in zip(got, want):
            if g.dtype != w.dtype or g.shape != w.shape:
                fail(f"{path}: {kernel} output {tuple(g.shape)} {g.dtype} "
                     f"vs plain {tuple(w.shape)} {w.dtype}")
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()) if g.numel() else 0)
        if err:
            fail(f"{path}: the {kernel} kernel disagrees with its plain "
                 f"version: max |diff| {err}")
        fn, pfn = compact_timer(kernel, c), compact_timer(kernel, c, True)
        flush = l2_flusher(got[0].device)
        t = {"ms": device_ms(fn, n=50), "ms_cold": device_ms(fn, flush=flush),
             "plain_ms": device_ms(pfn)}
        bound_ms, bound_by = compact_bound(kernel, c)
        shape = compact_shape(kernel, c)
        extra = {}
        if kernel == "ranks":   # its design's own floor: every live key row
            extra["design_floor_ms"] = (
                f"{4 * shape['W1'] * shape['n'] / HBM_BYTES_PER_S * 1e3:.7f}")
        log(f"compact-{kernel}-{path}", smi=json.dumps(smi), **shape,
            max_abs_err=err, **fmt_times(t), bound_ms=f"{bound_ms:.7f}",
            bound_by=bound_by, launches=launches[kernel], **extra)
        out.append({"name": kernel, "route": "cuda",
                    "source": "foundationdb_tpu_torch/csrc/compact.cu",
                    "replaces": COMPACT_REPLACES[kernel], "path": path,
                    "launches": launches[kernel], "max_abs_err": err,
                    "ms": t["ms"], "ms_cold": t["ms_cold"],
                    "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None, **shape})
    log_compact_stages(path, cap, smi)
    # the whole compaction around the decode and phase 2: what tpu.py's
    # dense and compaction kernels did there as torch ops
    log(f"compact-total-{path}", smi=json.dumps(smi),
        ms=f"{sum(e['ms'] for e in out):.5f}",
        bound_ms=f"{sum(e['bound_ms'] for e in out):.7f}",
        plain_ms=f"{sum(e['plain_ms'] for e in out):.5f}")
    for k, v in n0.items():   # comparison launches do not count
        compact.LAUNCHES[k] = v
    return out


# ---------------------------------------------------------------- phase 3


def k8(x: int) -> bytes:
    return struct.pack(">Q", int(x))


def phase_narrow(rng, device=None):
    from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS
    from foundationdb_tpu_torch.kv.keys import KeyRange
    from foundationdb_tpu_torch.resolver.cpu import ConflictSetCPU
    from foundationdb_tpu_torch.resolver.gpu import ConflictSetGPU
    from foundationdb_tpu_torch.resolver.types import TxnConflictInfo

    SERVER_KNOBS.TPU_COMPACT_EVERY_BATCHES = 4
    ora = ConflictSetCPU()
    gpu = ConflictSetGPU(max_key_bytes=8, initial_capacity=256, device=device)
    v, want, got, handles = 10_000, [], [], []
    for b in range(40):
        v += 100
        txns = []
        for _ in range(256):
            key = (lambda a: b"x" * 32 + k8(a)) if b == 20 else k8
            rr = [KeyRange(key(a), key(a + int(rng.integers(1, 6))))
                  for a in rng.integers(0, 2000, rng.integers(0, 4))]
            wr = [KeyRange(key(a), key(a) + b"\x00")
                  for a in rng.integers(0, 2000, rng.integers(0, 3))]
            txns.append(TxnConflictInfo(v - int(rng.integers(0, 900)), rr, wr))
        want.append(ora.resolve(v, v - 700, txns).statuses)
        if len(handles) >= 4:
            got.append(gpu.verdicts(handles.pop(0)))
        handles.append(gpu.submit(v, v - 700, txns))
    got.extend(gpu.verdicts(h) for h in handles)
    SERVER_KNOBS.TPU_COMPACT_EVERY_BATCHES = 16
    if got != want:
        bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
        fail(f"narrow slice: statuses differ from the oracle at batch {bad}")
    if gpu.entries() != ora.entries():
        fail("narrow slice: entries() differ from the oracle")
    n_old = sum(s.count(2) for s in want)
    log("narrow", batches=40, txns_per_batch=256, statuses_equal=True,
        entries_equal=True, entries=len(ora.entries()), too_old=n_old,
        key_bytes=gpu.max_key_bytes, compactions=gpu.compactions,
        fast_resolves=gpu.fast_resolves)


# ---------------------------------------------------------------- phase 4


def count_syncs(fn, settle: bool = True, sites=None):
    """(fn(), the host syncs it made): torch's sync debug mode flags every
    blocking CUDA call. `settle` drains the card first (off where the
    caller's pipeline must keep running); `sites`, a list, gets the
    file:line of each."""
    import warnings

    import torch

    if settle:
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    hits = [w for w in caught if "synchroniz" in str(w.message).lower()
            and "prototype" not in str(w.message)]
    if sites is not None:
        sites.extend(f"{w.filename.rsplit('/', 2)[-1]}:{w.lineno}"
                     for w in hits)
    return out, len(hits)


def audit_syncs(cs, wb, version: int, window: int) -> None:
    """Count the host syncs one submit() makes and fail on any beyond the
    known one, the lazy fence/count mirror readback after a compaction
    (one read). Phase 2 runs on the card: any read of its plain version
    fails the run."""
    from foundationdb_tpu_torch.resolver import gpu as gpu_mod

    p0, m0 = gpu_mod.P2_SYNCS, cs.mirror_reads
    h, syncs = count_syncs(
        lambda: cs.submit(version, max(0, version - window), wb))
    cs.verdicts(h)
    known = cs.mirror_reads - m0
    log("sync-audit", host_syncs_in_submit=syncs,
        phase2_reads=gpu_mod.P2_SYNCS - p0, mirror_reads=known)
    if gpu_mod.P2_SYNCS != p0:
        fail(f"submit made {gpu_mod.P2_SYNCS - p0} phase-2 host reads")
    if syncs > known:
        fail(f"submit made {syncs} host syncs, {known} expected")


def profile_batch(run, batch_ms: float, phase: str = "full-profile",
                  smi: str = "", host_ops: bool = True, on_trace=None):
    """One synchronous batch, run(), under torch.profiler: device busy
    time, kernel launches and the kernels that take the most device time;
    the idle share is against the pipelined run's mean batch time
    `batch_ms`. `host_ops=False` traces the device only (a run of
    seconds of host work records too many host ops to sum quickly);
    `on_trace`, if given, receives the profiler after the run.
    PROFILE_PAD spin kernels lead the window and are left out of every
    count: the trace drops the first device records of a window, more of
    them the older the process (PERF.md §6), and a batch of a few
    launches would otherwise lose them; the line logs how many of the
    pad the trace kept. Returns (device busy ms, device ops), or None
    when the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    if on_trace is not None:
        on_trace(prof)
    # Device-side events only (kernels, copies): the CPU ops that launched
    # them report the same device time again, and a chunk's profiler range
    # (CHUNK_RANGE) spans its kernels' time on the device once more.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0
              and not e.key.startswith(CHUNK_RANGE)]
    dev = [e for e in events if PAD_KERNEL not in e.key]
    pad_kept = sum(e.count for e in events if PAD_KERNEL in e.key)
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    launches = sum(e.count for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    pk = [e for e in dev if "probe_kernel" in e.key]
    pk_ms = sum(e.self_device_time_total for e in pk) / 1e3
    # every event naming the probe, host or device, as the trace has it
    probe_events = [(e.key[:40], str(e.device_type).split(".")[-1], e.count,
                     e.self_device_time_total) for e in prof.key_averages()
                    if "probe" in e.key.lower()]
    # the hand-written kernels' device events: count and device ms by name
    hand = {}
    for e in dev:
        name = next((k for k in HAND_KERNELS if k in e.key), None)
        if name:
            n, us = hand.get(name, (0, 0.0))
            hand[name] = (n + e.count, us + e.self_device_time_total)
    log(phase, smi=json.dumps(smi),
        device_busy_ms=f"{busy_ms:.3f}" if dev else "not measured",
        device_ops=launches, batch_ms=f"{batch_ms:.3f}",
        idle_share=f"{1 - busy_ms / batch_ms:.4f}" if dev else "not measured",
        probe_kernel_ms=f"{pk_ms:.4f}" if pk else "not measured",
        probe_kernel_count=sum(e.count for e in pk),
        probe_share=f"{pk_ms / busy_ms:.4f}" if pk and busy_ms else "not measured",
        probe_events=json.dumps(probe_events),
        pad_kept=f"{pad_kept}/{PROFILE_PAD}",
        hand_kernels=json.dumps({k: (n, round(us / 1e3, 4))
                                 for k, (n, us) in sorted(hand.items())}),
        top=json.dumps([(e.key[:48], round(e.self_device_time_total / 1e3, 4),
                         e.count) for e in top]))
    return (busy_ms, launches) if dev else None


def chunk_device_ops(prof) -> dict:
    """{i: (device ops, their device us)} of the kernels and copies that
    ran inside the profiler range CHUNK_RANGE + i. Each chunk's dispatch
    ends in a device synchronize inside its range, so a device event is
    the chunk's when it starts within the range's host interval. (Linking
    a device event to the host call that launched it misses every kernel
    launched through ctypes: no torch op stands above it.)"""
    ranges = [(int(e.name[len(CHUNK_RANGE):]), e.time_range.start,
               e.time_range.end) for e in prof.events()
              if e.name.startswith(CHUNK_RANGE)
              and e.device_type.name == "CPU"]
    out = {i: (0, 0.0) for i, _, _ in ranges}
    for e in prof.events():
        if (e.device_type.name != "CUDA" or e.name.startswith(CHUNK_RANGE)
                or e.time_range.elapsed_us() <= 0):
            continue
        for i, a, b in ranges:
            if a <= e.time_range.start <= b:
                n, us = out[i]
                out[i] = (n + 1, us + e.time_range.elapsed_us())
                break
    return out


def config5_batch(rng, n: int, version: int, space: int = 1 << 20,
                  n_reads: int = 5, n_writes: int = 2, lag: int = 100_000):
    """One config-5 batch as a WireBatch, built column-wise: point ranges
    [k8(k), k8(k) + b"\\x00") over uniform keys, snapshots version - U[0,
    lag)."""
    from foundationdb_tpu_torch.resolver.wire import WireBatch

    snaps = (version - rng.integers(0, lag, size=n)).astype(np.int64)
    rk = rng.integers(0, space, size=n * n_reads).astype(">u8")
    wk = rng.integers(0, space, size=n * n_writes).astype(">u8")

    def begins(k):
        return k.view(np.uint8).reshape(-1, 8)

    def ends(k):
        e = np.zeros((len(k), 9), dtype=np.uint8)
        e[:, :8] = begins(k)
        return e

    parts = [begins(rk), ends(rk), begins(wk), ends(wk)]
    blob = np.concatenate([p.reshape(-1) for p in parts])
    base = np.cumsum([0] + [p.size for p in parts[:-1]])
    cols = []
    for p, b0 in zip(parts, base):
        w = p.shape[1]
        cols += [b0 + np.arange(len(p), dtype=np.int64) * w,
                 np.full(len(p), w, dtype=np.int32)]
    return WireBatch(
        n_txns=n, snaps=snaps,
        r_counts=np.full(n, n_reads, dtype=np.int32),
        w_counts=np.full(n, n_writes, dtype=np.int32),
        rb_off=cols[0], rb_len=cols[1], re_off=cols[2], re_len=cols[3],
        wb_off=cols[4], wb_len=cols[5], we_off=cols[6], we_len=cols[7],
        blob=blob,
    )


def phase_full(rng, card: str, smi: str = "", device=None, n_txn: int = 65536,
               n_batches: int = 16, capacity: int = 1 << 21,
               chunk: int = 8192, keep: dict | None = None):
    """BASELINE config 5 through ConflictSetGPU (phase 4). With `keep`, it
    receives the main run's batches, their versions, the card's statuses
    and entries() after them, for [native] and [native-sort]."""
    from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS
    from foundationdb_tpu_torch.resolver import gpu as gpu_mod
    from foundationdb_tpu_torch.resolver import phase2, probe
    from foundationdb_tpu_torch.resolver.gpu import ConflictSetGPU

    step, window, depth = 65536, 131072, 4
    # Chunks of 8,192 txns. A 64K-txn chunk writes up to 262,144 endpoint
    # keys while the state holds about two batches of writes at fill
    # B/2 = 16 per block, so the host's pessimistic headroom proof (fill +
    # new keys <= B-1 in every touched block) fails somewhere on every
    # dispatch and every batch would take the compaction pass; the last
    # leg below measures that. Chunks at one version resolve exactly like
    # one chunk.
    SERVER_KNOBS.TPU_MAX_CHUNK_TXNS = chunk
    kw = dict(max_key_bytes=9, initial_capacity=capacity)
    v0 = 1_000_000
    batches = [config5_batch(rng, n_txn, v0 + i * step) for i in range(n_batches)]

    # Capture the probe's inputs on the main path (last call wins) so the
    # kernel is held against its plain version at exactly those shapes.
    captured = {}
    real_probe = gpu_mod.probe_ranks

    def recording_probe(hkeys, fences, smat, *, NB, B):
        captured.update(hkeys=hkeys.clone(), fences=fences.clone(),
                        smat=smat.clone(), NB=NB, B=B)
        return real_probe(hkeys, fences, smat, NB=NB, B=B)

    gpu_mod.probe_ranks = recording_probe
    cs = ConflictSetGPU(device=device, **kw)
    ref = ConflictSetGPU(device="cpu", **kw)
    p2_tap = Phase2Tap().__enter__()
    b_tap = BlockTap().__enter__()
    c_tap = CompactTap().__enter__()
    probe.LAUNCHES = 0
    phase2.LAUNCHES = 0
    sync(cs.device)
    lat, statuses, handles, p2, p2_reads = [], [], [], [], []
    n_chunks = [0]

    stages = {"pack_ms": [], "dispatch_ms": [], "wait_ms": []}

    def consume():
        t_sub, h = handles.pop(0)
        statuses.append(cs.verdicts(h))
        lat.append(time.perf_counter() - t_sub)
        p2.append(cs.last_p2_iters)
        p2_reads.append(h.p2_syncs)
        n_chunks[0] += len(h.chunks)
        for k, x in (("pack_ms", h.pack_ms), ("dispatch_ms", h.dispatch_ms),
                     ("wait_ms", h.device_ms)):
            stages[k].append(x)

    for i, wb in enumerate(batches):
        v = v0 + i * step
        if i == 2:
            # Batches 0-1 consumed, then held against the CPU twin.
            while handles:
                consume()
            for j in range(2):
                rv = v0 + j * step
                want = ref.resolve(rv, max(0, rv - window), batches[j]).statuses
                if want != statuses[j]:
                    fail(f"full width: card statuses differ from the CPU "
                         f"twin at batch {j}")
            if cs.entries() != ref.entries():
                fail("full width: card entries() differ from the CPU twin "
                     "after batch 2")
            t_steady = time.perf_counter()
        elif len(handles) >= depth:
            consume()
        handles.append((time.perf_counter(),
                        cs.submit(v, max(0, v - window), wb)))
    while handles:
        consume()
    sync(cs.device)
    t_end = time.perf_counter()
    launches = probe.LAUNCHES
    p2_launches = phase2.LAUNCHES
    p2_tap.__exit__()
    b_tap.__exit__()
    c_tap.__exit__()
    gpu_mod.probe_ranks = real_probe
    if launches <= 0:
        fail("full width: the probe kernel was not launched on the main path")
    on_card = cs.device.type == "cuda"
    if on_card and p2_launches != n_chunks[0]:
        fail(f"full width: {p2_launches} phase-2 kernel launches for "
             f"{n_chunks[0]} resolved chunks (one each expected)")
    if on_card and any(p2_reads):
        fail(f"full width: phase 2 read the host in a submit: {p2_reads}")
    if on_card:
        b_tap.check_launches("full width", cs.fast_resolves, n_chunks[0])
        c_tap.check_launches("full width", cs.compactions)
    st = np.concatenate([np.asarray(s) for s in statuses])
    if st.size != n_txn * n_batches or not np.isin(st, (0, 1, 2)).all():
        fail("full width: malformed statuses")
    steady = (n_batches - 2) * n_txn / (t_end - t_steady)
    lat_ms = np.asarray(lat) * 1e3
    entries = cs.entries()
    n_entries = len(entries)
    if keep is not None:
        keep.update(batches=batches, statuses=statuses, entries=entries,
                    versions=[v0 + i * step for i in range(n_batches)],
                    window=window, n_words=cs.n_words)
    del entries
    log("full", card=json.dumps(card), smi=json.dumps(smi), batches=n_batches, txns_per_batch=n_txn,
        txns_per_s=f"{steady:.1f}",
        p50_batch_ms=f"{np.percentile(lat_ms, 50):.2f}",
        p90_batch_ms=f"{np.percentile(lat_ms, 90):.2f}",
        conflict_rate=f"{float((st == 1).mean()):.4f}",
        last_p2_iters=p2[-1],
        p2_syncs_per_batch=f"{sum(p2_reads) / n_batches:.2f}",
        entries=n_entries, compactions=cs.compactions,
        fast_resolves=cs.fast_resolves, probe_launches=launches,
        probe_launches_per_batch=f"{launches / n_batches:.2f}",
        phase2_launches=p2_launches, chunks=n_chunks[0],
        block_launches=json.dumps(b_tap.launches),
        compact_launches=json.dumps(c_tap.launches), cpu_twin_batches=2)
    log("full-stages", **{f"p50_{k}": f"{np.percentile(x, 50):.2f}"
                          for k, x in stages.items()})
    if cs.device.type == "cuda":
        vp = v0 + n_batches * step
        wb = config5_batch(rng, n_txn, vp)
        paths, chunk_ops = [], {}
        real_async = cs.resolve_async

        def tagged(*a, **k):
            # each chunk's dispatch in a profiler range, its path recorded
            import torch
            f0 = cs.fast_resolves
            with torch.profiler.record_function(
                    f"{CHUNK_RANGE}{len(paths)}"):
                h = real_async(*a, **k)
                torch.cuda.synchronize()   # its device work inside it
            paths.append("fast" if cs.fast_resolves > f0 else "compaction")
            return h

        cs.resolve_async = tagged
        try:
            prof = profile_batch(
                lambda: cs.resolve(vp, max(0, vp - window), wb),
                batch_ms=1e3 * n_txn / steady,
                on_trace=lambda p: chunk_ops.update(chunk_device_ops(p)))
        finally:
            del cs.resolve_async
        if prof:
            by_path = {}
            for i, path in enumerate(paths):
                by_path.setdefault(path, []).append(chunk_ops.get(i, (0, 0)))
            log("full-profile-ops", smi=json.dumps(smi), device_ops=prof[1],
                torch_block_device_ops=TORCH_BLOCK_DEVICE_OPS,
                fifth_of_torch_block=TORCH_BLOCK_DEVICE_OPS // 5,
                fewer=TORCH_BLOCK_DEVICE_OPS - prof[1],
                torch_compaction_device_ops=TORCH_COMPACTION_DEVICE_OPS,
                torch_compaction_ops_per_compaction=json.dumps(
                    TORCH_COMPACTION_OPS_PER_COMPACTION),
                seed_as_torch_ops_device_ops=SEED_AS_TORCH_OPS_DEVICE_OPS,
                chunks=json.dumps(paths),
                ops_per_fast_chunk=json.dumps(
                    [n for n, _ in by_path.get("fast", [])]),
                ops_per_compaction=json.dumps(
                    [n for n, _ in by_path.get("compaction", [])]),
                device_ms_per_fast_chunk=json.dumps(
                    [round(us / 1e3, 4) for _, us in by_path.get("fast", [])]),
                device_ms_per_compaction=json.dumps(
                    [round(us / 1e3, 4)
                     for _, us in by_path.get("compaction", [])]),
                attributed_ops=sum(n for n, _ in chunk_ops.values()))
        n_batches += 1
        audit_syncs(cs, config5_batch(rng, n_txn, v0 + n_batches * step),
                    v0 + n_batches * step, window)
        n_batches += 1

    # Last leg, after the counts were read: the same set and traffic with
    # 64K-txn chunks (the knob's default), to see which path it takes.
    SERVER_KNOBS.TPU_MAX_CHUNK_TXNS = 65536
    n_more = FULL_64K_BATCHES
    comp0, fast0 = cs.compactions, cs.fast_resolves
    more = [config5_batch(rng, n_txn, v0 + (n_batches + i) * step)
            for i in range(n_more)]
    t0 = time.perf_counter()
    for i, wb in enumerate(more):
        v = v0 + (n_batches + i) * step
        if len(handles) >= depth:
            consume()
        handles.append((time.perf_counter(),
                        cs.submit(v, max(0, v - window), wb)))
    while handles:
        consume()
    sync(cs.device)
    log("full-64k-chunks", batches=n_more,
        txns_per_s=f"{n_more * n_txn / (time.perf_counter() - t0):.1f}",
        compactions=cs.compactions - comp0,
        fast_resolves=cs.fast_resolves - fast0)
    return launches, captured, steady, dict(p2_tap.captured,
                                            launches=p2_launches), \
        (b_tap.captured, b_tap.launches), (c_tap.captured, c_tap.launches)


# ---------------------------------------------------------------- phase 5

FNV_OFFSET_64 = 0xCBF29CE484222325
FNV_PRIME_64 = 1099511628211
ZIPF_ITEMS = 10_000_000_000     # YCSB ScrambledZipfianGenerator.ITEM_COUNT
ZIPF_ZETAN = 26.46902820178302  # its precomputed zeta(ITEM_COUNT, 0.99)
ZIPF_THETA = 0.99


def fnv64(x) -> np.ndarray:
    """YCSB Utils.fnvhash64 of each int64: FNV-1 over the 8 low-first
    bytes, then Math.abs of the signed result."""
    x = np.asarray(x, dtype=np.int64).view(np.uint64).copy()
    h = np.full(x.shape, FNV_OFFSET_64, dtype=np.uint64)
    for _ in range(8):
        h ^= x & np.uint64(0xFF)
        h *= np.uint64(FNV_PRIME_64)
        x >>= np.uint64(8)
    return np.abs(h.view(np.int64))


def ycsb_keys(keynums) -> list[bytes]:
    """CoreWorkload.buildKeyName with insertorder=hashed: "user" + the
    decimal FNV-64 hash of the record number (5 to 23 bytes)."""
    return [b"user%d" % h for h in fnv64(keynums).tolist()]


def zipf_scrambled(rng, n: int, count: int) -> np.ndarray:
    """n record numbers in [0, count) from YCSB's ScrambledZipfianGenerator
    (Zipfian constant 0.99 over ITEM_COUNT items, hashed with fnv64 and
    taken mod count)."""
    zeta2 = 1.0 + 0.5**ZIPF_THETA
    alpha = 1.0 / (1.0 - ZIPF_THETA)
    eta = ((1.0 - (2.0 / ZIPF_ITEMS) ** (1.0 - ZIPF_THETA))
           / (1.0 - zeta2 / ZIPF_ZETAN))
    u = rng.random(n)
    uz = u * ZIPF_ZETAN
    r = (ZIPF_ITEMS * (eta * u - eta + 1.0) ** alpha).astype(np.int64)
    r = np.where(uz < 1.0 + 0.5**ZIPF_THETA, 1, r)
    r = np.where(uz < 1.0, 0, r)
    return fnv64(r) % count


class ReadTap:
    """The storage read gather (storage_engine/read.py, csrc/read.cu on the
    card) while the block is open, as gpu_engine calls it: its launches
    (read.LAUNCHES) and the last call's operands, kept by reference (the
    window replaces its tensors and builds the queries fresh per batch)."""

    def __init__(self):
        self.launches = 0
        self.captured = {}

    def __enter__(self) -> "ReadTap":
        from foundationdb_tpu_torch.storage_engine import gpu_engine, read

        real = self._real = gpu_engine.read_gather

        def read_gather(*args, **meta):
            n0 = read.LAUNCHES["read_gather"]
            out = real(*args, **meta)
            self.launches += read.LAUNCHES["read_gather"] - n0
            self.captured = dict(zip(read.OPERANDS, args), **meta)
            return out

        gpu_engine.read_gather = read_gather
        return self

    def __exit__(self, *exc) -> None:
        from foundationdb_tpu_torch.storage_engine import gpu_engine

        gpu_engine.read_gather = self._real


def read_kernel_bound(cap: dict) -> tuple[float, str]:
    """Least time for the read gather (csrc/read.cu) on one batch, counted
    from what the kernel must move: the probe's bid and pos and the
    queries read once, the delta columns its walks read (W2 words each),
    each point's base and delta predecessor column (W2 words and a slot
    each), each range's read version and its base and delta spans (S
    slots of version, next flag and slot, and the lookahead's version),
    and the aux vector written once, over the memory rate; against its
    compares (W2 words a walk step and an equality test) over the
    integer rate."""
    q = cap["qall"]
    W2, Q = q.shape
    P, R, S = cap["P"], cap["R"], cap["S"]
    D = cap["dmat"].shape[1]
    _, _, cols, _ = walk_columns(cap["dmat"].cpu().numpy(), q.cpu().numpy(),
                                 0, D, with_eq=False)
    walked = len(cols)
    nbytes = (8 * Q + 4 * W2 * Q + 4 * W2 * walked
              + 2 * P * (4 * W2 + 4) + R * (4 + 2 * (12 * S + 4))
              + 4 * (6 * P + 4 * R + 6 * R * S))
    ops = Q * W2 * (D.bit_length() - 1) + 2 * P * W2 + 2 * R * S * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def read_entry(path: str, cap: dict, launches: int, smi: str) -> dict:
    """The read gather's kernel held against its plain version on one
    path's last operands on the card, bit for bit (fails otherwise),
    timed warm (50 launches an event pair) and cold (after an L2 flush),
    its plain version timed, bounded, logged with its launch floor (the
    kernel on one point read) and its launches' time over that floor:
    one kernel-table entry."""
    import torch
    from foundationdb_tpu_torch.storage_engine import read
    from foundationdb_tpu_torch.timing import device_ms, l2_flusher

    if not cap:
        fail(f"{path}: the read kernel was never called on the card")
    ts = {k: cap[k] for k in read.OPERANDS}
    meta = {k: cap[k] for k in ("P", "R", "S", "F", "NB", "B")}
    n0 = dict(read.LAUNCHES)
    got = read.read_gather_launch(ts, **meta)
    want = read.read_gather_ref(*ts.values(), **meta)
    torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f"{path}: read kernel aux {tuple(got.shape)} vs plain "
             f"{tuple(want.shape)}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err:
        fail(f"{path}: the read kernel disagrees with its plain version: "
             f"max |diff| {err}")
    flush = l2_flusher(got.device)
    t = {"ms": device_ms(lambda: read.read_gather_launch(ts, **meta), n=50),
         "ms_cold": device_ms(lambda: read.read_gather_launch(ts, **meta),
                              flush=flush),
         "plain_ms": device_ms(lambda: read.read_gather_ref(*ts.values(),
                                                            **meta))}
    # A launch's floor: the same kernel on the same window for one point
    # read (what its launches cost before any work; its byte bound is
    # nanoseconds).
    one = dict(ts, qall=ts["qall"][:, :1].contiguous(), rv=ts["rv"][:0],
               bid=ts["bid"][:1], pos=ts["pos"][:1])
    floor_ms = device_ms(lambda: read.read_gather_launch(
        one, **dict(meta, P=1, R=0)), n=50)
    for k, v in n0.items():   # comparison launches do not count
        read.LAUNCHES[k] = v
    bound_ms, bound_by = read_kernel_bound(cap)
    shape = dict(W2=cap["qall"].shape[0], **meta, D=cap["dmat"].shape[1])
    log(f"read-{path}", smi=json.dumps(smi), **shape, max_abs_err=err,
        **fmt_times(t), bound_ms=f"{bound_ms:.7f}", bound_by=bound_by,
        launches=launches, launch_floor_ms=f"{floor_ms:.5f}",
        over_floor_ms=f"{launches * (t['ms'] - floor_ms):.5f}")
    return {"name": "read_gather", "route": "cuda",
            "source": "foundationdb_tpu_torch/csrc/read.cu",
            "replaces": "foundationdb_tpu/storage_engine/tpu_engine.py:113",
            "path": path, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "ms_cold": t["ms_cold"], "plain_ms": t["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            **shape}


def probe_walk_bound(hkeys, fences, q, NB: int, B: int) -> tuple[float, str]:
    """Least time for the probe on these queries, counted as the walks
    need it: every fence column and block slot the two halving walks read
    (each once, with the equality reads), the queries read and the
    outputs written, in bytes over the memory rate, against the int32
    compares over the integer rate; whichever is larger. The directory
    and blocks no walk reaches are not counted."""
    W1, P2 = q.shape
    lb, eq, fcols, fsteps = walk_columns(fences, q, 0, NB)
    bid = lb + eq - 1
    _, _, hcols, hsteps = walk_columns(hkeys, q, np.clip(bid, 0, NB - 1) * B,
                                       B)
    nbytes = 4 * W1 * (len(fcols) + len(hcols) + P2) + 12 * P2
    ops = P2 * W1 * (fsteps + hsteps)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def walk_columns(mat, q, start, width, with_eq: bool = True):
    """The halving walk of queries q (W1, P2) over `width` columns of mat
    from `start` (tpu.py's `_lower_rank` and block probe), numpy: (rank,
    equality at it, the columns read, the steps taken); with_eq=False
    leaves the equality step out (the rank alone)."""
    pos = np.zeros(q.shape[1], dtype=np.int64)
    seen, steps = set(), 0
    s = width // 2
    while s >= 1:
        col = np.clip(start + pos + s - 1, 0, mat.shape[1] - 1)
        seen.update(col.tolist())
        lt, _ = lex_lt_eq(mat[:, col], q)
        pos += lt * s
        s //= 2
        steps += 1
    if not with_eq:
        return pos, None, seen, steps
    col = np.clip(start + pos, 0, mat.shape[1] - 1)
    seen.update(col.tolist())
    _, eq = lex_lt_eq(mat[:, col], q)
    return pos, eq, seen, steps + 1


def lex_lt_eq(h, q):
    """Lexicographic h < q and h == q over the word rows (numpy)."""
    lt = np.zeros(q.shape[1], dtype=bool)
    eq = np.ones(q.shape[1], dtype=bool)
    for j in range(q.shape[0]):
        lt |= eq & (h[j] < q[j])
        eq &= h[j] == q[j]
    return lt, eq


class StorageLoad:
    """YCSB traffic against one storage window and an independent
    VersionedMap fed the same writes. Every reply is kept with its request
    and checked against that oracle before the window moves and at the
    end of each leg."""

    def __init__(self, rng, eng, ora, n_records: int, version: int):
        from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS

        self.rng, self.eng, self.ora = rng, eng, ora
        self.count = n_records
        self.v = version
        self.k = SERVER_KNOBS
        self.unchecked = []
        self.side_s = 0.0  # host time of the harness's own work
        self.eng_s = 0.0   # host time of the engine's writes

    def value(self) -> bytes:
        return self.rng.bytes(1000)  # 10 fields of 100 bytes

    def read_version(self) -> int:
        life = self.k.MAX_READ_TRANSACTION_LIFE_VERSIONS
        return max(self.eng.oldest_version,
                   self.v - int(self.rng.integers(0, life + 1)))

    def write(self, keys) -> None:
        for k in keys:
            val = self.value()
            t0 = time.perf_counter()
            self.eng.set(k, val, self.v)
            self.eng_s += time.perf_counter() - t0
            self.ora.set(k, val, self.v)

    def writes(self, scans: bool, n: int) -> None:
        """Workload B: updates of Zipfian records; E: inserts of new
        records, at the current version."""
        if scans:
            self.write(ycsb_keys(np.arange(self.count, self.count + n)))
            self.count += n
        else:
            self.write(ycsb_keys(zipf_scrambled(self.rng, n, self.count)))

    def reads(self, scans: bool, n: int):
        """(points, ranges): B, point reads of Zipfian records; E, scans
        from a Zipfian record over 1 to 100 records (end = the record that
        many keys on, limit = that count)."""
        from bisect import bisect_left

        keys = ycsb_keys(zipf_scrambled(self.rng, n, self.count))
        if not scans:
            return [(k, self.read_version()) for k in keys], []
        index = self.ora._keys
        ranges = []
        for k, ln in zip(keys, self.rng.integers(1, 101, n).tolist()):
            at = bisect_left(index, k) + ln
            end = index[at] if at < len(index) else b"\xff"
            ranges.append((k, end, self.read_version(), ln, False))
        return [], ranges

    def batch(self, scans: bool):
        """One batch of STORAGE_READ_BATCH_MAX operations at the next
        version: the 5% writes applied, then the 95% reads returned. The
        time spent here outside the engine's own calls (drawing requests,
        the independent oracle) counts as the harness's (side_s)."""
        t0 = time.perf_counter()
        eng0 = self.eng_s
        self.v += self.k.VERSIONS_PER_SECOND // 100
        n = self.k.STORAGE_READ_BATCH_MAX
        n_w = int((self.rng.random(n) < 0.05).sum())
        self.writes(scans, n_w)
        out = self.reads(scans, n - n_w)
        self.side_s += time.perf_counter() - t0 - (self.eng_s - eng0)
        return out

    def check(self) -> None:
        """Every kept reply against the independent oracle."""
        t0 = time.perf_counter()
        for points, ranges, pv, rr in self.unchecked:
            if pv != [self.ora.get(k, v) for k, v in points]:
                fail("storage: a point read differs from the oracle")
            if rr != [self.ora.get_range(*r) for r in ranges]:
                fail("storage: a range read differs from the oracle")
        self.unchecked.clear()
        self.side_s += time.perf_counter() - t0

    def forget(self) -> None:
        """Move the window: forget_before(v - MAX_READ_TRANSACTION_LIFE)."""
        floor = self.v - self.k.MAX_READ_TRANSACTION_LIFE_VERSIONS
        self.eng.forget_before(floor)
        t0 = time.perf_counter()
        self.ora.forget_before(floor)
        self.side_s += time.perf_counter() - t0


def storage_leg(load: StorageLoad, leg: str, n_batches: int, smi: str):
    """One YCSB leg through submit_reads/read_verdicts at pipeline depth
    STORAGE_READ_PIPELINE_DEPTH; forget_before once per simulated second
    (100 batches), after draining the pipeline. Returns the probe's
    launches in the leg and the mean host ms per batch."""
    from collections import deque

    from foundationdb_tpu_torch.resolver import probe

    eng = load.eng
    depth = load.k.STORAGE_READ_PIPELINE_DEPTH
    c0 = {c: getattr(eng, c).total for c in (
        "c_compactions", "c_delta_folds", "c_span_fallbacks", "c_batches")}
    handles = deque()
    lat, pack, disp, d2h, comp = [], [], [], [], []
    n_reads = 0

    def consume():
        t_sub, h, points, ranges = handles.popleft()
        pv, rr = eng.read_verdicts(h)
        lat.append((time.perf_counter() - t_sub) * 1e3)
        d2h.append(eng.last_d2h_ms)
        load.unchecked.append((points, ranges, pv, rr))

    sync(eng.device)
    probe.LAUNCHES = 0
    side0 = load.side_s
    t0 = time.perf_counter()
    for b in range(n_batches):
        if b and b % 100 == 0:
            while handles:
                consume()
            load.check()
            load.forget()
        points, ranges = load.batch(scans=leg == "E")
        n_reads += len(points) + len(ranges)
        if len(handles) >= depth:
            consume()
        n_comp = eng.c_compactions.total
        t_sub = time.perf_counter()
        handles.append((t_sub, eng.submit_reads(points, ranges), points,
                        ranges))
        pack.append(eng.last_pack_ms)
        disp.append(eng.last_dispatch_ms)
        if eng.c_compactions.total > n_comp:
            comp.append((eng.last_rebuild_ms, eng.last_upload_ms))
    while handles:
        consume()
    sync(eng.device)
    wall = time.perf_counter() - t0 - (load.side_s - side0)
    launches = probe.LAUNCHES
    load.check()
    if eng.entries() != load.ora.entries():
        fail(f"storage leg {leg}: entries() differ from the oracle")
    d = {c: getattr(eng, c).total - c0[c] for c in c0}
    if d["c_compactions"] < 2:
        fail(f"storage leg {leg}: {d['c_compactions']} compactions, "
             "at least 2 wanted")
    if eng.device.type == "cuda" and launches != d["c_batches"]:
        fail(f"storage leg {leg}: {launches} probe launches in "
             f"{d['c_batches']} submits, one each wanted")

    def p(x, q):
        return f"{np.percentile(x, q):.3f}"

    log(f"storage-{leg}", smi=json.dumps(smi), batches=n_batches,
        reads=n_reads, reads_per_s=f"{n_reads / wall:.1f}",
        p50_batch_ms=p(lat, 50), p90_batch_ms=p(lat, 90), depth=depth,
        p50_pack_ms=p(pack, 50), p50_dispatch_ms=p(disp, 50),
        p50_d2h_ms=p(d2h, 50), compactions=d["c_compactions"],
        compaction_rebuild_ms=json.dumps([round(r, 1) for r, _ in comp]),
        compaction_upload_ms=json.dumps([round(u, 1) for _, u in comp]),
        delta_folds=d["c_delta_folds"],
        span_fallbacks=d["c_span_fallbacks"], probe_launches=launches,
        probe_launches_per_batch=f"{launches / n_batches:.2f}",
        entries=eng._n_base, version=load.v, replies_equal=True,
        entries_equal=True)
    return launches, 1e3 * wall / n_batches


def phase_storage(rng, smi: str = "", device=None,
                  n_records: int = 1_000_000, n_batches: int = 720):
    """The storage read window at one memory-engine storage process's size:
    n_records YCSB records of 1,000 bytes, loaded in key order at one
    version, then leg B (95% Zipfian point reads, 5% updates) and leg E
    (95% scans, 5% inserts), n_batches batches each, every reply and the
    final entries() of each leg against an independent VersionedMap."""
    import torch
    from foundationdb_tpu_torch.kv.versioned_map import VersionedMap
    from foundationdb_tpu_torch.storage_engine import gpu_engine
    from foundationdb_tpu_torch.storage_engine.factory import make_mvcc_window

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        log("storage-memory", smi=json.dumps(smi), allocated_before_mb=(
            f"{torch.cuda.memory_allocated() / 1e6:.1f}"))
    t0 = time.perf_counter()
    # The records in key order; the values are the same bytes as
    # n_records draws of rng.bytes(1000), drawn at once.
    keys = ycsb_keys(np.arange(n_records))
    blob = rng.bytes(1000 * n_records)
    order = sorted(range(n_records), key=keys.__getitem__)
    keys = [keys[i] for i in order]
    vals = [blob[1000 * i: 1000 * i + 1000] for i in order]
    del blob, order
    t_gen = time.perf_counter() - t0
    v0 = 10_000_000
    eng = make_mvcc_window("gpu", device=device)
    ora = VersionedMap()
    t0 = time.perf_counter()
    eng.set_bulk(keys, vals, v0)
    t_set = time.perf_counter() - t0
    for k, val in zip(keys, vals):
        ora.set(k, val, v0)
    t0 = time.perf_counter()
    h = eng.submit_reads([(keys[0], v0)], [(keys[0], keys[-1], v0, 3, False)])
    t_sub = time.perf_counter() - t0
    pv, rr = eng.read_verdicts(h)
    sync(eng.device)
    t_load = time.perf_counter() - t0
    if pv != [vals[0]] or rr != [ora.get_range(keys[0], keys[-1], v0, 3)]:
        fail("storage: the first read after the load differs from the oracle")
    log("storage-load", records=n_records, key_bytes=f"{min(map(len, keys))}-"
        f"{max(map(len, keys))}", value_bytes=1000, gen_s=f"{t_gen:.2f}",
        set_bulk_s=f"{t_set:.2f}", first_submit_s=f"{t_sub:.2f}",
        rebuild_ms=f"{eng.last_rebuild_ms:.1f}",
        upload_enqueue_ms=f"{eng.last_upload_ms:.1f}",
        first_read_s=f"{t_load:.2f}", n_words=eng._n_words, NB=eng.NB, B=eng.B,
        F=eng.F, hmat_mb=f"{eng._d_hmat.numel() * 4 / 1e6:.1f}")
    del keys, vals

    captured = {}
    real_probe = gpu_engine.probe_ranks

    def recording_probe(hkeys, fences, smat, *, NB, B):
        # the engine replaces these tensors at a compaction and never
        # writes them in place, so references suffice
        captured.update(hkeys=hkeys, fences=fences, smat=smat, NB=NB, B=B)
        return real_probe(hkeys, fences, smat, NB=NB, B=B)

    load = StorageLoad(rng, eng, ora, n_records, v0)
    out = {}
    gpu_engine.probe_ranks = recording_probe
    r_tap = ReadTap().__enter__()
    try:
        for leg in ("B", "E"):
            r_tap.launches = 0
            launches, batch_ms = storage_leg(load, leg, n_batches, smi)
            if eng.device.type == "cuda" and r_tap.launches != launches:
                fail(f"storage leg {leg}: {r_tap.launches} read-kernel "
                     f"launches for {launches} probe launches, one each "
                     "wanted")
            out[leg] = dict(captured, launches=launches,
                            read=(dict(r_tap.captured), r_tap.launches))
            if eng.device.type == "cuda":
                points, ranges = load.batch(scans=leg == "E")
                shape = []

                def one_batch():
                    h = eng.submit_reads(points, ranges)
                    shape.append((h.P, h.R, h.S))
                    load.unchecked.append((points, ranges,
                                           *eng.read_verdicts(h)))

                profile_batch(one_batch, batch_ms, f"storage-{leg}-profile",
                              smi)
                load.check()
                P, R, S = shape[0]
                log(f"storage-{leg}-d2h", P=P, R=R, S=S,
                    aux_bytes_per_batch=4 * (6 * P + 4 * R + 6 * R * S))
                # the dispatch's least time: the probe's walks, then
                # the read gather
                t_probe, by_p = probe_walk_bound(
                    captured["hkeys"].cpu().numpy(),
                    captured["fences"].cpu().numpy(),
                    captured["smat"].cpu().numpy(), captured["NB"],
                    captured["B"])
                t_read, by_r = read_kernel_bound(r_tap.captured)
                log(f"storage-{leg}-read-bound", smi=json.dumps(smi),
                    P=P, R=R, S=S, bound_ms=f"{t_probe + t_read:.7f}",
                    probe_bound_ms=f"{t_probe:.7f}", probe_bound_by=by_p,
                    read_bound_ms=f"{t_read:.7f}", read_bound_by=by_r)
    finally:
        gpu_engine.probe_ranks = real_probe
        r_tap.__exit__()
    if eng.device.type == "cuda":
        # one compaction alone, to the end of its upload
        sync(eng.device)
        t0 = time.perf_counter()
        eng._compact()
        t1 = time.perf_counter()
        sync(eng.device)
        log("storage-compaction", smi=json.dumps(smi), entries=eng._n_base,
            rebuild_ms=f"{eng.last_rebuild_ms:.1f}",
            upload_enqueue_ms=f"{eng.last_upload_ms:.1f}",
            upload_wait_ms=f"{(time.perf_counter() - t1) * 1e3:.1f}",
            total_ms=f"{(time.perf_counter() - t0) * 1e3:.1f}")
        storage_sync_audit(load)
        log("storage-memory", smi=json.dumps(smi),
            max_memory_allocated_mb=f"{torch.cuda.max_memory_allocated() / 1e6:.1f}")
    return out


def storage_sync_audit(load: StorageLoad) -> None:
    """Host syncs inside submit_reads: a plain submit, one that folds
    writes into the delta, one that compacts. 0 expected in each."""
    eng = load.eng
    for kind in ("plain", "compact", "fold"):
        load.v += load.k.VERSIONS_PER_SECOND // 100
        if kind == "compact":
            room = load.k.STORAGE_TPU_DELTA_SLOTS - len(eng._delta_keys)
            load.writes(False, room + 1)
        elif kind == "fold":
            load.writes(False, 8)
        points, ranges = load.reads(False, load.k.STORAGE_READ_BATCH_MAX)
        folds, comps = eng.c_delta_folds.total, eng.c_compactions.total
        h, syncs = count_syncs(lambda: eng.submit_reads(points, ranges))
        load.unchecked.append((points, ranges, *eng.read_verdicts(h)))
        load.check()
        log("storage-sync-audit", submit=kind, host_syncs_in_submit=syncs,
            delta_folds=eng.c_delta_folds.total - folds,
            compactions=eng.c_compactions.total - comps)
        if syncs:
            fail(f"storage: submit_reads ({kind}) made {syncs} host syncs")


# ---------------------------------------------------------------- phase 6


class RecordingConflictSet:
    """The resolver role's conflict set (ConflictSetGPU), recording every
    submit (version, new oldest version, batch) with its verdicts for the
    CPU replay, the batch's size, its wall latency from submit to
    verdicts, and the host syncs inside submit: torch's count on the card
    and the ones the set knows of (mirror reads; phase 2 runs on the card
    and reads nothing: a phase-2 read there fails the run). With a
    `sink`, each recorded batch goes to it, in submit order, as soon as
    its verdicts are in (a replay that runs while the cluster does)."""

    def __init__(self, cs, sink=None):
        self.cs = cs
        self.log = []       # [version, new_oldest, batch, verdicts]
        self._open = {}     # id(handle) -> (log index, submit time, handle)
        self.lat_ms, self.n_txns = [], []
        self.syncs, self.known, self.sites, self.p2 = [], [], [], []
        self.sink, self._sent = sink, 0

    def submit(self, version, new_oldest, batch):
        from foundationdb_tpu_torch.resolver import gpu as gpu_mod

        p0, m0 = gpu_mod.P2_SYNCS, self.cs.mirror_reads
        t0 = time.perf_counter()
        if self.cs.device.type == "cuda":
            sites = []
            h, syncs = count_syncs(
                lambda: self.cs.submit(version, new_oldest, batch),
                settle=False, sites=sites)
            self.syncs.append(syncs)
            self.sites.append(sites)
        else:
            h = self.cs.submit(version, new_oldest, batch)
        p2 = gpu_mod.P2_SYNCS - p0
        if p2 and self.cs.device.type == "cuda":
            fail(f"a resolver submit on the card made {p2} phase-2 host "
                 "reads")
        self.p2.append(p2)
        self.known.append(p2 + self.cs.mirror_reads - m0)
        self.log.append([version, new_oldest, batch, None])
        self.n_txns.append(h.n_txns)
        self._open[id(h)] = (len(self.log) - 1, t0, h)
        return h

    def drain(self) -> None:
        """Read the verdicts of every submit still open, in submit order
        (a killed generation's in-flight batches: its roles will not)."""
        for _, _, h in sorted(self._open.values(), key=lambda e: e[0]):
            self.verdicts(h)

    def verdicts(self, handle):
        st = self.cs.verdicts(handle)
        i, t0, _ = self._open.pop(id(handle))
        self.lat_ms.append((time.perf_counter() - t0) * 1e3)
        self.log[i][3] = [int(x) for x in st]
        while (self.sink is not None and self._sent < len(self.log)
               and self.log[self._sent][3] is not None):
            self.sink(tuple(self.log[self._sent][:3]))
            self._sent += 1
        return st

    def __getattr__(self, name):
        return getattr(self.cs, name)


class CheckedWindow:
    """The storage server's window (KeyValueStoreGPU): every mutation also
    goes to an independent VersionedMap, and every read reply the batcher
    consumes is held against it (replies for versions the window has
    since forgotten are discarded by the batcher, and skipped here)."""

    def __init__(self, eng, name: str = "cluster"):
        from foundationdb_tpu_torch.kv.versioned_map import VersionedMap

        self.name = name
        self.eng = eng
        self.ora = VersionedMap()
        self.replies = 0
        self.reads = []     # reads per batch
        self._open = {}     # id(handle) -> (points, ranges, submit time)
        self.lat_ms = []
        self.compaction_ms = []  # host rebuild of each compaction

    def __len__(self):
        return len(self.eng)

    def __getattr__(self, name):
        return getattr(self.eng, name)

    def set(self, key, value, version):
        self.eng.set(key, value, version)
        self.ora.set(key, value, version)

    def set_bulk(self, keys, values, version):
        self.eng.set_bulk(keys, values, version)
        for k, v in zip(keys, values):
            self.ora.set(k, v, version)

    def clear(self, key, version):
        self.eng.clear(key, version)
        self.ora.clear(key, version)

    def clear_range(self, begin, end, version):
        self.eng.clear_range(begin, end, version)
        self.ora.clear_range(begin, end, version)

    def forget_before(self, version):
        self.eng.forget_before(version)
        self.ora.forget_before(version)

    def rollback_above(self, version):
        self.eng.rollback_above(version)
        self.ora.rollback_above(version)

    def submit_reads(self, points, ranges):
        n = self.eng.c_compactions.total
        t0 = time.perf_counter()
        h = self.eng.submit_reads(points, ranges)
        self._open[id(h)] = (points, ranges, t0)
        self.reads.append(len(points) + len(ranges))
        if self.eng.c_compactions.total > n:
            self.compaction_ms.append(self.eng.last_rebuild_ms)
        return h

    def read_verdicts(self, handle):
        pv, rv = self.eng.read_verdicts(handle)
        points, ranges, t0 = self._open.pop(id(handle))
        self.lat_ms.append((time.perf_counter() - t0) * 1e3)
        old = self.ora.oldest_version
        for (k, v), got in zip(points, pv):
            if v >= old:
                if got != self.ora.get(k, v):
                    fail(f"{self.name}: a point read of {k!r} at {v} "
                         "differs from the independent VersionedMap")
                self.replies += 1
        for r, got in zip(ranges, rv):
            if r[2] >= old:
                if got != self.ora.get_range(*r):
                    fail(f"{self.name}: a range read {r[:3]!r} differs "
                         "from the independent VersionedMap")
                self.replies += 1
        return pv, rv


def rw_key(i: int) -> bytes:
    """ReadWriteWorkload's key for record i (workloads/read_write.py)."""
    return b"rw/" + b"%06d" % i


def default_knobs() -> None:
    """Every server knob back to its default (earlier phases set some)."""
    from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS, ServerKnobs

    for name, value in ServerKnobs().all().items():
        setattr(SERVER_KNOBS, name, value)


class ProbeTap:
    """The probe on each path while the block is open: launches counted by
    the kernel's wrapper (probe.LAUNCHES), split by caller (the resolver
    kernels of resolver/gpu.py, which the sharded set runs too, and the
    storage window of storage_engine/gpu_engine.py), and each path's last
    operands, held against the plain version afterwards."""

    def __init__(self):
        self.launches = {"resolver": 0, "storage": 0}
        self.captured = {"resolver": {}, "storage": {}}

    def _key(self, path: str):
        """Where a launch from `path` ("resolver" or "storage") counts."""
        return path

    def _recording(self, path: str, clone: bool):
        from foundationdb_tpu_torch.resolver import probe

        real = self._real

        def probe_ranks(hkeys, fences, smat, *, NB, B):
            n0 = probe.LAUNCHES
            out = real(hkeys, fences, smat, NB=NB, B=B)
            key = self._key(path)
            self.launches[key] += probe.LAUNCHES - n0
            # the resolver updates its state in place: copy its operands;
            # the storage window replaces its tensors, so references do
            if clone:
                hkeys, fences, smat = (t.clone() for t in (hkeys, fences,
                                                           smat))
            self.captured[key].update(hkeys=hkeys, fences=fences,
                                      smat=smat, NB=NB, B=B)
            return out

        return probe_ranks

    def __enter__(self) -> "ProbeTap":
        from foundationdb_tpu_torch.resolver import gpu as gpu_mod
        from foundationdb_tpu_torch.resolver import probe
        from foundationdb_tpu_torch.storage_engine import gpu_engine

        self._real = probe.probe_ranks
        gpu_mod.probe_ranks = self._recording("resolver", True)
        gpu_engine.probe_ranks = self._recording("storage", False)
        return self

    def __exit__(self, *exc) -> None:
        from foundationdb_tpu_torch.resolver import gpu as gpu_mod
        from foundationdb_tpu_torch.storage_engine import gpu_engine

        gpu_mod.probe_ranks = self._real
        gpu_engine.probe_ranks = self._real

    def paths(self, **names) -> dict:
        """{entry name: last operands and launches} for the named paths."""
        return {name: dict(self.captured[path],
                           launches=self.launches[path])
                for name, path in names.items()}

    def to_host(self) -> None:
        """Move the operands captured so far to host memory, so that the
        tap holds no device memory when a reading of it is taken."""
        import torch

        for cap in self.captured.values():
            for k, t in cap.items():
                if isinstance(t, torch.Tensor):
                    cap[k] = t.cpu()


def load_key_set(key_space: int, load_keys: int) -> list[bytes]:
    """`load_keys` of ReadWrite's keys spread evenly over `key_space`,
    sorted."""
    return sorted(rw_key(i) for i in np.linspace(
        0, key_space, load_keys, endpoint=False).astype(np.int64))


def stamper(stamps: dict):
    """mark(name): the wall and simulated clocks at a point of the run."""
    from foundationdb_tpu_torch.core.runtime import current_loop

    loop = current_loop()

    def mark(name):
        stamps[name] = (time.perf_counter(), loop.now())

    return mark


async def load_through_client(db, keys, loaders: int) -> None:
    """The keys through the client in 1,000-key transactions, in rounds of
    `loaders` concurrent transactions in key order: each round commits in
    about one proxy batch and appends to the sorted maps behind the
    windows and the oracles."""
    from foundationdb_tpu_torch.core.runtime import spawn

    async def load(chunk):
        async def body(tr):
            for k in chunk:
                tr.set(k, b"v%d" % len(k))

        await db.transact(body)

    chunks = [keys[i:i + 1000] for i in range(0, len(keys), 1000)]
    for r in range(0, len(chunks), loaders):
        tasks = [spawn(load(c), name=f"load_{r + j}")
                 for j, c in enumerate(chunks[r:r + loaders])]
        for t in tasks:
            await t.done


async def read_write_until(db, key_space: int, clients: int, target: int,
                           cls=None):
    """BASELINE config 1's traffic: ReadWriteWorkload (or its subclass
    `cls`; 5 reads, 2 writes per transaction, uniform keys) from `clients`
    concurrent clients until `target` transactions have committed.
    Returns the workload."""
    from foundationdb_tpu_torch.core.runtime import spawn
    from foundationdb_tpu_torch.workloads.read_write import ReadWriteWorkload

    rw = (cls or ReadWriteWorkload)(db, key_space=key_space, reads_per_txn=5,
                                    writes_per_txn=2)

    async def client():
        while rw.txns_done < target:
            await rw._one()

    tasks = [spawn(client(), name=f"rw_client_{i}") for i in range(clients)]
    for t in tasks:
        await t.done
    return rw


def phase_cluster(rng, smi: str = "", device=None, nodes: int = 1000,
                  cycle_clients: int = 64, cycle_txns: int = 25,
                  key_space: int = 1 << 20, load_keys: int = 1 << 18,
                  loaders: int = 32, clients: int = 1024,
                  target: int = 10_000, capacity: int = 1 << 21):
    """The transaction system on the card: the port's LocalCluster with
    ConflictSetGPU as its resolver and KeyValueStoreGPU as its storage
    window, under the port's sim_loop, knobs at their defaults. Cycle
    (`nodes` nodes, cycle_clients x cycle_txns), then BASELINE config 1:
    `load_keys` keys of ReadWrite's `key_space`, spread evenly, loaded
    through the client in 1,000-key transactions (`loaders` at a time),
    then ReadWriteWorkload (5 reads, 2 writes per transaction) from
    `clients` concurrent clients until `target` transactions have
    committed. Every verdict is replayed through a
    fresh ConflictSetCPU and every read reply is held against an
    independent VersionedMap. Returns the probe's operands and launches
    on each path, and the resolver's phase-2 launches under each tier
    phase2.choose_tier picked with that tier's largest operands."""
    import torch
    from foundationdb_tpu_torch.cluster import LocalCluster
    from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS
    from foundationdb_tpu_torch.core.runtime import loop_context, sim_loop
    from foundationdb_tpu_torch.resolver.gpu import ConflictSetGPU
    from foundationdb_tpu_torch.workloads.cycle import CycleWorkload

    t_phase = time.perf_counter()
    default_knobs()
    log("cluster-knobs", knobs=json.dumps(SERVER_KNOBS.all()))
    dev = torch.device("cuda" if device is None else device)
    card = dev.type == "cuda"

    loop = sim_loop(seed=SEED)
    # The oracle replays every resolve batch in a process of its own while
    # the cluster runs; results() below ends it (a failure before that
    # leaves it to end with this process: it is a daemon).
    replays = StreamingReplays()
    cs = RecordingConflictSet(ConflictSetGPU(
        0, max_key_bytes=16, initial_capacity=capacity, device=device),
        replays.send)
    with ProbeTap() as tap, Phase2Tap() as p2_tap, BlockTap() as b_tap, \
            CompactTap() as c_tap, ReadTap() as r_tap:
        with loop_context(loop):
            cluster = LocalCluster(conflict_set=cs, device=device)
            win = CheckedWindow(cluster.storage.data)
            cluster.storage.data = win
            cluster.start()
            db = cluster.database()
            keys = load_key_set(key_space, load_keys)
            stamps = {}

            async def main():
                mark = stamper(stamps)
                mark("cycle")
                cyc = CycleWorkload(db, nodes=nodes)
                await cyc.setup()
                await cyc.start(clients=cycle_clients,
                                txns_per_client=cycle_txns)
                ok = await cyc.check()
                mark("load")
                await load_through_client(db, keys, loaders)
                mark("rw")
                c0 = (win.eng.c_compactions.total, cs.compactions,
                      cs.fast_resolves, len(cs.log), len(win.reads))
                rw = await read_write_until(db, key_space, clients, target)
                mark("end")
                st = cluster.resolver.pipeline_status()
                cluster.stop()
                return ok, cyc, rw, c0, st

            ok, cyc, rw, c0, pipe = loop.run(main(), timeout_sim_seconds=1e6)
        loop.shutdown()
    if card:
        b_tap.check_launches("cluster", cs.cs.fast_resolves,
                             cs.cs.fast_resolves + cs.cs.compactions)
        c_tap.check_launches("cluster", cs.cs.compactions)
    launches = tap.launches
    sync(dev)
    conflicts = cluster.resolver.conflict_transactions
    if not ok:
        fail("cluster: the Cycle invariant does not hold")
    if cyc.retries <= 0 or conflicts <= 0:
        fail(f"cluster: no conflicts detected (retries {cyc.retries}, "
             f"conflicts {conflicts})")
    if rw.txns_done < target:
        fail(f"cluster: {rw.txns_done} config-1 transactions, {target} wanted")

    def span(a, b):
        return (stamps[b][0] - stamps[a][0], stamps[b][1] - stamps[a][1])

    wall_cyc, sim_cyc = span("cycle", "load")
    wall_load, sim_load = span("load", "rw")
    wall_rw, sim_rw = span("rw", "end")
    n_res = len(cs.log) - c0[3]
    n_read = len(win.reads) - c0[4]
    log("cluster-cycle", smi=json.dumps(smi), nodes=nodes,
        clients=cycle_clients, txns=cyc.txns_done, retries=cyc.retries,
        check=ok, wall_s=f"{wall_cyc:.2f}", sim_s=f"{sim_cyc:.3f}",
        txns_per_wall_s=f"{cyc.txns_done / wall_cyc:.1f}")
    log("cluster-load", keys=len(keys), key_space=key_space,
        txn_keys=1000, txns=(len(keys) + 999) // 1000, loaders=loaders,
        wall_s=f"{wall_load:.2f}", sim_s=f"{sim_load:.3f}",
        keys_per_wall_s=f"{len(keys) / wall_load:.1f}")
    log("cluster-config1", smi=json.dumps(smi), clients=clients,
        committed=rw.txns_done, retries=rw.retries,
        wall_s=f"{wall_rw:.2f}", sim_s=f"{sim_rw:.3f}",
        committed_per_wall_s=f"{rw.txns_done / wall_rw:.1f}",
        resolve_batches=n_res, read_batches=n_read,
        compactions_window=win.eng.c_compactions.total - c0[0],
        resolver_compactions=cs.compactions - c0[1],
        resolver_fast=cs.fast_resolves - c0[2])

    syncs = f"{sum(cs.syncs) / len(cs.syncs):.2f}" if cs.syncs else \
        "not measured"
    log("cluster-resolve", smi=json.dumps(smi), batches=len(cs.log),
        txns_per_batch_p50=pct(cs.n_txns, 50),
        txns_per_batch_max=max(cs.n_txns),
        config1_txns_per_batch_p50=pct(cs.n_txns[c0[3]:], 50),
        config1_txns_per_batch_max=max(cs.n_txns[c0[3]:]),
        latency_ms_p50=pct(cs.lat_ms, 50), latency_ms_p90=pct(cs.lat_ms, 90),
        config1_latency_ms_p50=pct(cs.lat_ms[c0[3]:], 50),
        config1_latency_ms_p90=pct(cs.lat_ms[c0[3]:], 90),
        host_syncs_per_submit=syncs,
        known_syncs_per_submit=f"{sum(cs.known) / len(cs.known):.2f}",
        fast_resolves=cs.fast_resolves, compactions=cs.compactions,
        conflicts=conflicts,
        probe_launches=launches["resolver"],
        probe_launches_per_batch=f"{launches['resolver'] / len(cs.log):.2f}")
    log("cluster-pipeline", stages=json.dumps(pipe["stages"]),
        depth=pipe["depth_configured"],
        max_in_flight=pipe["max_in_flight_measured"])
    log("cluster-reads", smi=json.dumps(smi), batches=len(win.reads),
        reads=sum(win.reads), reads_per_batch_p50=pct(win.reads, 50),
        reads_per_batch_max=max(win.reads),
        config1_reads_per_batch_p50=pct(win.reads[c0[4]:], 50),
        config1_latency_ms_p50=pct(win.lat_ms[c0[4]:], 50),
        replies_checked=win.replies,
        latency_ms_p50=pct(win.lat_ms, 50), latency_ms_p90=pct(win.lat_ms, 90),
        compactions=win.eng.c_compactions.total,
        compaction_rebuild_ms=json.dumps([round(x, 1)
                                          for x in win.compaction_ms]),
        delta_folds=win.eng.c_delta_folds.total,
        span_fallbacks=win.eng.c_span_fallbacks.total,
        probe_launches=launches["storage"],
        probe_launches_per_batch=f"{launches['storage'] / len(win.reads):.2f}",
        read_launches=r_tap.launches)
    if card:
        for path in ("resolver", "storage"):
            if launches[path] <= 0:
                fail(f"cluster: the probe kernel was not launched on the "
                     f"{path} path")
        if r_tap.launches != launches["storage"]:
            fail(f"cluster: {r_tap.launches} read-kernel launches for "
                 f"{launches['storage']} storage probe launches")
        if not p2_tap.by_tier:
            fail("cluster: the phase-2 kernel was not launched")

    extra = []  # (version, statuses) of the profiled resolves
    if card:
        # One resolve batch and one read batch under the profiler, each of
        # config 1's median size; the idle share is against the config-1
        # run's wall time per batch of its kind. The resolve batch takes
        # the fast path, as nearly all of config 1's do: a batch due for
        # the cadence's compaction goes first, outside the profile.
        med = sorted(cs.log[c0[3]:], key=lambda e: len(e[3]))
        batch = med[len(med) // 2][2]
        v, oldest = cs.log[-1][:2]
        for vp in range(v + 1, v + 3):
            if (cs.cs._since_compact + 1
                    < SERVER_KNOBS.TPU_COMPACT_EVERY_BATCHES):
                break
            extra.append((vp, cs.cs.resolve(vp, oldest, batch).statuses))
        fast0 = cs.cs.fast_resolves
        busy_r = profile_batch(
            lambda: extra.append((vp, cs.cs.resolve(vp, oldest,
                                                    batch).statuses)),
            batch_ms=1e3 * wall_rw / max(n_res, 1),
            phase="cluster-resolve-profile", smi=smi)
        for vp, _ in extra:
            # The oracle replays these too, after the cluster's batches.
            replays.send((vp, oldest, batch))
        n_pts = max(1, int(np.median(win.reads[c0[4]:])))
        pts = [(rw_key(int(i)), win.ora.latest_version)
               for i in rng.integers(0, key_space, n_pts)]
        busy_s = profile_batch(
            lambda: win.read_verdicts(win.submit_reads(pts, [])),
            batch_ms=1e3 * wall_rw / max(n_read, 1),
            phase="cluster-read-profile", smi=smi)
        log("cluster-profiled-batches",
            resolve_path="fast" if cs.cs.fast_resolves > fast0
            else "compaction",
            resolve_txns=batch.n_txns if hasattr(batch, "n_txns")
            else len(batch), reads=n_pts)
        if busy_r is not None and busy_s is not None:
            busy = busy_r[0] * n_res + busy_s[0] * n_read
            log("cluster-idle", smi=json.dumps(smi),
                device_busy_ms_estimate=f"{busy:.1f}",
                config1_wall_ms=f"{wall_rw * 1e3:.1f}",
                idle_share=f"{1 - busy / (wall_rw * 1e3):.4f}")
    # Every verdict, the profiled ones last, against the oracle's replay
    # in submit order.
    t0 = time.perf_counter()
    results = replays.results()
    check_replays("cluster", [e[3] for e in cs.log] + [st for _, st in extra],
                  results)
    if cs.entries() != results[0][1][-1]:
        fail("cluster: the resolver's entries() differ from the replay")
    t_replay = time.perf_counter() - t0
    t0 = time.perf_counter()
    if win.eng.entries() != win.ora.entries():
        fail("cluster: the storage window's entries() differ from the "
             "independent VersionedMap")
    log("cluster-check", smi=json.dumps(smi), verdicts_equal=True,
        resolve_batches=len(cs.log), entries_equal=True,
        resolver_entries=len(results[0][1][-1]), replies_equal=True,
        replies=win.replies, window_entries_equal=True,
        window_entries=win.eng._n_base, replay_wait_s=f"{t_replay:.2f}",
        window_check_s=f"{time.perf_counter() - t0:.2f}")
    if card:
        sync_audit("cluster", cs.syncs, cs.known, cs.sites)
    log("cluster-phase", wall_s=f"{time.perf_counter() - t_phase:.2f}")
    paths = tap.paths(**{"cluster-resolver": "resolver",
                         "cluster-storage": "storage"})
    # phase 2 under each tier the rule picked, on its largest batch
    paths["cluster-resolver"]["phase2"] = {
        f"cluster-resolver-{t}": c for t, c in p2_tap.by_tier.items()}
    paths["cluster-resolver"]["block"] = (b_tap.captured, b_tap.launches)
    paths["cluster-resolver"]["compact"] = (c_tap.captured, c_tap.launches)
    paths["cluster-storage"]["read"] = (r_tap.captured, r_tap.launches)
    return paths


# ---------------------------------------------------------------- phase 7


def config4_arrays(rng, n: int, version: int, space: int = 1 << 20,
                   lag: int = 100_000):
    """One BASELINE config-4 batch as arrays (the generator of
    tests/test_kernel_baseline_sizes.py:103-157): snapshots version - U[0,
    lag), 5 point-read and 2 point-write keys per txn uniform over
    `space`, and for every 7th txn one read range [lo, hi) drawn uniformly
    over the space, which crosses shard boundaries (range stitching)."""
    snaps = (version - rng.integers(0, lag, n)).astype(np.int64)
    rk = rng.integers(0, space, (n, 5))
    wk = rng.integers(0, space, (n, 2))
    lo = rng.integers(0, space - 1, (n + 6) // 7)
    hi = rng.integers(lo + 1, space)
    return snaps, rk, wk, lo, hi


def config4_txns(arrays):
    """The batch's TxnConflictInfo list: point ranges [k8(k), k8(k) +
    b"\\x00"), the wide read last in its txn."""
    from foundationdb_tpu_torch.kv.keys import KeyRange
    from foundationdb_tpu_torch.resolver.types import TxnConflictInfo

    snaps, rk, wk, lo, hi = arrays

    def keys(a):
        b = np.ascontiguousarray(a.reshape(-1), dtype=">u8").tobytes()
        return [b[i:i + 8] for i in range(0, len(b), 8)]

    rkb, wkb, lob, hib = keys(rk), keys(wk), keys(lo), keys(hi)
    out = []
    for i, snap in enumerate(snaps.tolist()):
        rr = [KeyRange(k, k + b"\x00") for k in rkb[5 * i: 5 * i + 5]]
        if i % 7 == 0:
            rr.append(KeyRange(lob[i // 7], hib[i // 7]))
        wr = [KeyRange(k, k + b"\x00") for k in wkb[2 * i: 2 * i + 2]]
        out.append(TxnConflictInfo(snap, rr, wr))
    return out


class Config4Batch:
    """A config-4 batch as its arrays, cheap to send to a replay process;
    to_txns() builds its TxnConflictInfo list."""

    def __init__(self, arrays):
        self.arrays = arrays

    def to_txns(self):
        return config4_txns(self.arrays)


def replay(items, shard=None):
    """A resolver's submits, items (version, new oldest version, batch,
    ...), replayed in order through a fresh ConflictSetCPU; with `shard`,
    a key range (lo, hi), every batch is clipped to it first, as one shard
    of ShardedConflictSetCPU does. The item "entries" takes the oracle's
    entries() there; an int item starts a fresh ConflictSetCPU at that
    version (a recovered generation's resolver). Returns (each batch's
    statuses as int8 arrays, the entries() taken and those at the end)."""
    from foundationdb_tpu_torch.resolver.cpu import ConflictSetCPU
    from foundationdb_tpu_torch.resolver.sharded import clip_txns_to_shard

    ora = ConflictSetCPU(0)
    statuses, entries = [], []
    for item in items:
        if isinstance(item, str):
            entries.append(ora.entries())
            continue
        if isinstance(item, int):
            ora = ConflictSetCPU(item)
            continue
        v, oldest, batch = item[:3]
        txns = batch.to_txns() if hasattr(batch, "to_txns") else batch
        if shard is not None:
            txns = clip_txns_to_shard(txns, *shard)
        statuses.append(np.asarray(ora.resolve(v, oldest, txns).statuses,
                                   dtype=np.int8))
    entries.append(ora.entries())
    return statuses, entries


def replay_worker(inq, outq, shard):
    """replay() in a process of its own, fed through `inq` until a None;
    its result goes back through `outq`."""
    gc.set_threshold(*GC_THRESHOLDS)
    outq.put(replay(iter(inq.get, None), shard))


class StreamingReplays:
    """Replay processes (spawned: the card stays with this process), fed
    while the card runs so that little is left to replay at its end: `n`
    of them, or one per shard of `boundaries`, each clipping every batch
    to its shard. sink(i) feeds process i and send() feeds them all, in
    the background (queues). results() ends them and returns their
    replay() results in order; leaving the block ends any still running."""

    def __init__(self, n: int = 1, boundaries=None):
        import multiprocessing

        from foundationdb_tpu_torch.resolver.sharded import shard_key_ranges

        ctx = multiprocessing.get_context("spawn")
        shards = ([None] * n if boundaries is None
                  else shard_key_ranges(boundaries))
        self.inqs = [ctx.Queue() for _ in shards]
        self.outqs = [ctx.Queue() for _ in shards]
        self.procs = [ctx.Process(target=replay_worker, args=(i, o, sh),
                                  daemon=True)
                      for i, o, sh in zip(self.inqs, self.outqs, shards)]
        for proc in self.procs:
            proc.start()

    def sink(self, i: int):
        return self.inqs[i].put

    def send(self, item) -> None:
        for q in self.inqs:
            q.put(item)

    def results(self) -> list:
        self.send(None)
        out = [q.get() for q in self.outqs]
        for p in self.procs:
            p.join(timeout=60)
        return out

    def __enter__(self) -> "StreamingReplays":
        return self

    def __exit__(self, *exc) -> None:
        for p in self.procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)
        for q in self.inqs + self.outqs:
            q.cancel_join_thread()
            q.close()


def check_replays(name: str, verdicts, results) -> None:
    """Every batch's verdicts against the replays' statuses, max-merged
    over the replays (one per shard; a lone replay is its own max)."""
    n = len(results[0][0])
    if n != len(verdicts):
        fail(f"{name}: {n} batches replayed, {len(verdicts)} resolved")
    for i, got in enumerate(verdicts):
        want = np.max(np.stack([r[0][i] for r in results]), axis=0)
        if not np.array_equal(np.asarray(got, dtype=np.int8), want):
            fail(f"{name}: resolve batch {i} differs from its oracle replay")


def shard_placement(device, n_shards: int) -> list[str]:
    """One device per shard, the JAX mesh's counterpart: shard s on card
    s % (the machine's cards), so one card holds every shard and four
    cards one each; every shard on the CPU for a CPU rehearsal."""
    import torch

    if device is not None and torch.device(device).type == "cpu":
        return ["cpu"] * n_shards
    count = torch.cuda.device_count()
    return [f"cuda:{s % count}" for s in range(n_shards)]


def allocated_mib(devices) -> float:
    """Device memory this process has allocated, MiB, summed over the
    distinct cards among `devices` (0 on the CPU)."""
    import torch

    cards = {torch.device(d) for d in devices if torch.device(d).type
             == "cuda"}
    return sum(torch.cuda.memory_allocated(d) for d in cards) / 2**20


def log_placement(name: str, cs) -> None:
    """Where a sharded set's shards lie, beside the machine's card count."""
    from collections import Counter

    import torch

    log(f"{name}-placement", devices=json.dumps([str(d) for d in cs.devices]),
        shards_per_device=json.dumps(Counter(str(d) for d in cs.devices)),
        device_count=(torch.cuda.device_count()
                      if torch.cuda.is_available() else 0))


def phase_sharded(rng, smi: str = "", device=None, n_txn: int = 8192,
                  n_batches: int = 40, big_txn: int = 65536,
                  big_batches: int = 6, space: int = 1 << 20,
                  window: int = 131072, lag: int = 100_000,
                  capacity: int = 1 << 19):
    """BASELINE config 4 standalone: ShardedConflictSetGPU with 4 shards
    over uniform 8-byte keys in `space`, boundaries at its quarters.
    Leg A: n_batches of n_txn txns through submit/verdicts at depth 4, the
    version n_txn on per batch, the GC horizon version - window, then one
    profiled batch; leg B: big_batches of big_txn txns (the BASELINE
    batch), the version big_txn on per batch. ShardedConflictSetCPU's four
    shards replay every batch in four processes meanwhile; every batch's
    statuses and each leg's shard_entries() must equal theirs. The probe
    must launch once per shard per fast-path batch. Returns the probe's
    last operands and launches."""
    import torch
    from foundationdb_tpu_torch.resolver import phase2
    from foundationdb_tpu_torch.resolver.sharded import ShardedConflictSetGPU

    t_phase = time.perf_counter()
    default_knobs()
    dev = torch.device("cuda" if device is None else device)
    card = dev.type == "cuda"
    depth, S = 4, 4
    bounds = [k8(space // 4), k8(space // 2), k8(3 * space // 4)]
    v0 = 1_000_000
    legs, v = [], v0
    for n, count in ((n_txn, n_batches + 1), (big_txn, big_batches)):
        leg = []
        for _ in range(count):
            v += n
            leg.append((v, max(0, v - window),
                        config4_arrays(rng, n, v, space, lag)))
        legs.append(leg)

    devices = shard_placement(device, S)
    cs = ShardedConflictSetGPU(bounds, max_key_bytes=9,
                               initial_capacity=capacity, devices=devices)
    log_placement("sharded", cs)
    with StreamingReplays(boundaries=bounds) as replays, \
            ProbeTap() as tap, Phase2Tap() as p2_tap, BlockTap() as b_tap, \
            CompactTap() as c_tap:
        got, entries, runs = [], [], []
        for li, leg in enumerate(legs):
            for v, oldest, arrays in leg:
                replays.send((v, oldest, Config4Batch(arrays)))
            replays.send("entries")
            timed = leg[:-1] if li == 0 else leg  # leg A: last is profiled
            batches = [config4_txns(a) for _, _, a in timed]
            f0, c0, l0, p0 = (cs.fast_resolves, cs.compactions,
                              tap.launches["resolver"], len(got))
            q0 = phase2.LAUNCHES
            handles, lat, stages, syncs, known, sites = [], [], [], [], [], []

            def consume():
                t_sub, h = handles.pop(0)
                got.append(cs.verdicts(h))
                lat.append((time.perf_counter() - t_sub) * 1e3)
                stages.append((h.pack_ms, h.dispatch_ms, h.device_ms,
                               h.p2_syncs))

            sync(dev)
            t0 = time.perf_counter()
            for (v, oldest, _), txns in zip(timed, batches):
                if len(handles) >= depth:
                    consume()
                t_sub, m0 = time.perf_counter(), cs.mirror_reads
                if card:
                    site = []
                    h, n_s = count_syncs(lambda: cs.submit(v, oldest, txns),
                                         settle=False, sites=site)
                    syncs.append(n_s)
                    sites.append(site)
                else:
                    h = cs.submit(v, oldest, txns)
                if card and h.p2_syncs:
                    fail(f"sharded: a submit made {h.p2_syncs} phase-2 "
                         "host reads on the card")
                known.append(h.p2_syncs + cs.mirror_reads - m0)
                handles.append((t_sub, h))
            while handles:
                consume()
            sync(dev)
            wall = time.perf_counter() - t0
            runs.append(dict(
                wall=wall, txns=len(timed) * len(batches[0]), lat=lat,
                stages=np.asarray(stages), syncs=syncs, known=known,
                sites=sites, fast=cs.fast_resolves - f0,
                compactions=cs.compactions - c0,
                launches=tap.launches["resolver"] - l0,
                p2_launches=phase2.LAUNCHES - q0,
                statuses=np.concatenate([np.asarray(g, dtype=np.int8)
                                         for g in got[p0:]])))
            del batches
            p2_cap = p2_tap.captured   # leg B's last shard step wins
            if li == 0:
                # one more batch of leg A, alone, under the profiler
                v, oldest, arrays = leg[-1]
                txns = config4_txns(arrays)
                f1 = cs.fast_resolves
                if card:
                    profile_batch(
                        lambda: got.append(cs.resolve(v, oldest,
                                                      txns).statuses),
                        batch_ms=wall * 1e3 / len(timed),
                        phase="sharded-profile", smi=smi)
                else:
                    got.append(cs.resolve(v, oldest, txns).statuses)
                runs[0]["profiled_path"] = ("fast" if cs.fast_resolves > f1
                                            else "compaction")
            entries.append(cs.shard_entries())
        launches = tap.launches["resolver"]
        t_wait = time.perf_counter()
        results = replays.results()
        t_wait = time.perf_counter() - t_wait

    for li, (leg_name, run) in enumerate(zip(("sharded", "sharded-64k"),
                                             runs)):
        lat_ms = np.asarray(run["lat"])
        st = run["statuses"]
        log(leg_name, smi=json.dumps(smi), shards=S,
            batches=len(lat_ms), txns_per_batch=run["txns"] // len(lat_ms),
            txns_per_s=f"{run['txns'] / run['wall']:.1f}",
            p50_batch_ms=f"{np.percentile(lat_ms, 50):.2f}",
            p90_batch_ms=f"{np.percentile(lat_ms, 90):.2f}",
            conflict_rate=f"{float((st == 1).mean()):.4f}",
            too_old_rate=f"{float((st == 2).mean()):.4f}",
            p2_syncs_per_batch=f"{run['stages'][:, 3].mean():.2f}",
            fast_resolves=run["fast"], compactions=run["compactions"],
            probe_launches=run["launches"], phase2_launches=run["p2_launches"],
            p50_pack_ms=f"{np.percentile(run['stages'][:, 0], 50):.2f}",
            p50_dispatch_ms=f"{np.percentile(run['stages'][:, 1], 50):.2f}",
            p50_wait_ms=f"{np.percentile(run['stages'][:, 2], 50):.2f}",
            NB=cs.NB, entries=json.dumps([len(e) for e in entries[li]]))
        if card and run["launches"] != S * run["fast"]:
            fail(f"{leg_name}: {run['launches']} probe launches for "
                 f"{run['fast']} fast-path batches of {S} shards")
        if card and run["p2_launches"] < S * len(lat_ms):
            fail(f"{leg_name}: {run['p2_launches']} phase-2 kernel launches "
                 f"for {len(lat_ms)} batches of {S} shard steps")
        if card:
            sync_audit(leg_name, run["syncs"], run["known"], run["sites"])
    if runs[0]["fast"] <= 0:
        fail("sharded: the fast path never ran at the 8,192-txn batch")
    if card:
        b_tap.check_launches("sharded", S * cs.fast_resolves,
                             S * (cs.fast_resolves + cs.compactions))
        c_tap.check_launches("sharded", S * cs.compactions)
    if runs[0].get("profiled_path"):
        log("sharded-profiled-batch", path=runs[0]["profiled_path"],
            txns=n_txn)

    # Every batch against the oracle's shards, max-merged (leg A's
    # batches first, then leg B's).
    check_replays("sharded", got, results)
    for li in range(len(legs)):
        if entries[li] != [r[1][li] for r in results]:
            fail(f"sharded: shard_entries() differ from ShardedConflictSetCPU "
                 f"after leg {'AB'[li]}")
    log("sharded-check", smi=json.dumps(smi), batches=len(got),
        statuses_equal=True, entries_equal=True, oracle_processes=S,
        oracle_wait_s=f"{t_wait:.2f}",
        allocated_mib=f"{allocated_mib(cs.devices):.1f}",
        phase_s=f"{time.perf_counter() - t_phase:.2f}")
    if card and launches <= 0:
        fail("sharded: the probe kernel was not launched on the main path")
    paths = tap.paths(sharded="resolver")
    paths["sharded"]["phase2"] = {"sharded": dict(
        p2_cap, launches=sum(r["p2_launches"] for r in runs))}
    paths["sharded"]["block"] = (b_tap.captured, b_tap.launches)
    paths["sharded"]["compact"] = (c_tap.captured, c_tap.launches)
    paths["sharded"]["shards"] = S
    return paths


def cycle_key(i: int) -> bytes:
    """CycleWorkload's key of node i (workloads/cycle.py)."""
    return b"cycle/" + struct.pack(">I", i)


def sync_audit(name: str, syncs, known, sites) -> None:
    """Host syncs of every audited submit (torch's count on the card, and
    the file:line of each) against the ones the sets know of: mirror
    reads (phase 2 runs on the card; its callers fail the run on any
    phase-2 read there)."""
    bad = [(i, n, k, sites[i]) for i, (n, k) in enumerate(zip(syncs, known))
           if n > k]
    log(f"{name}-sync-audit", submits=len(syncs), host_syncs=sum(syncs),
        mirror_reads=sum(known), submits_over=len(bad),
        first_over=json.dumps(bad[:5]))
    if bad:
        fail(f"{name}: submit made more host syncs than the mirror reads "
             "account for")


def pct(x, q):
    return f"{np.percentile(x, q):.3f}" if len(x) else "none"


def phase_cluster_sharded(rng, smi: str = "", device=None, nodes: int = 1000,
                          clients: int = 64, txns: int = 25,
                          capacity: int = 1 << 12):
    """Path A of config 4: the port's LocalCluster with a 4-shard
    ShardedConflictSetGPU (max_key_bytes 16) as its resolver, split at the
    Cycle keys of nodes nodes/4, nodes/2 and 3*nodes/4; Cycle over `nodes`
    nodes from `clients` clients x `txns` txns. Every resolve batch is
    replayed through ShardedConflictSetCPU and shard_entries() compared;
    every read reply is held against an independent VersionedMap; every
    submit's syncs are audited."""
    import torch
    from foundationdb_tpu_torch.cluster import LocalCluster
    from foundationdb_tpu_torch.core.runtime import loop_context, sim_loop
    from foundationdb_tpu_torch.resolver.sharded import ShardedConflictSetGPU
    from foundationdb_tpu_torch.workloads.cycle import CycleWorkload

    t_phase = time.perf_counter()
    default_knobs()
    card = torch.device("cuda" if device is None else device).type == "cuda"
    bounds = [cycle_key(nodes * i // 4) for i in (1, 2, 3)]
    loop = sim_loop(seed=SEED + 1)
    with StreamingReplays(boundaries=bounds) as replays, \
            ProbeTap() as tap:
        cs = RecordingConflictSet(ShardedConflictSetGPU(
            bounds, max_key_bytes=16, initial_capacity=capacity,
            devices=shard_placement(device, 4)), replays.send)
        log_placement("cluster-sharded", cs.cs)
        with loop_context(loop):
            cluster = LocalCluster(conflict_set=cs, device=device)
            win = CheckedWindow(cluster.storage.data, "cluster-sharded")
            cluster.storage.data = win
            cluster.start()
            db = cluster.database()

            async def main():
                cyc = CycleWorkload(db, nodes=nodes)
                await cyc.setup()
                await cyc.start(clients=clients, txns_per_client=txns)
                ok = await cyc.check()
                cluster.stop()
                return ok, cyc

            t0 = time.perf_counter()
            ok, cyc = loop.run(main(), timeout_sim_seconds=1e6)
            wall = time.perf_counter() - t0
        loop.shutdown()
        t0 = time.perf_counter()
        results = replays.results()
    conflicts = cluster.resolver.conflict_transactions
    if not ok:
        fail("cluster-sharded: the Cycle invariant does not hold")
    if cyc.retries <= 0 or conflicts <= 0:
        fail(f"cluster-sharded: no conflicts detected (retries "
             f"{cyc.retries}, conflicts {conflicts})")
    log("cluster-sharded", smi=json.dumps(smi), shards=4, nodes=nodes,
        clients=clients, txns=cyc.txns_done, retries=cyc.retries,
        conflicts=conflicts, check=ok, wall_s=f"{wall:.2f}",
        txns_per_wall_s=f"{cyc.txns_done / wall:.1f}",
        resolve_batches=len(cs.log),
        txns_per_batch_p50=pct(cs.n_txns, 50),
        txns_per_batch_max=max(cs.n_txns),
        latency_ms_p50=pct(cs.lat_ms, 50), latency_ms_p90=pct(cs.lat_ms, 90),
        fast_resolves=cs.fast_resolves, compactions=cs.compactions,
        p2_syncs_per_batch=f"{sum(cs.p2) / len(cs.p2):.2f}",
        probe_launches=tap.launches["resolver"],
        probe_launches_per_fast_batch=(
            f"{tap.launches['resolver'] / cs.fast_resolves:.2f}"
            if cs.fast_resolves else "none"),
        read_batches=len(win.reads), replies_checked=win.replies)
    if card and tap.launches["resolver"] != 4 * cs.fast_resolves:
        fail(f"cluster-sharded: {tap.launches['resolver']} probe launches "
             f"for {cs.fast_resolves} fast-path batches of 4 shards")
    if card and tap.launches["resolver"] <= 0:
        fail("cluster-sharded: the probe kernel was not launched")
    check_replays("cluster-sharded", [e[3] for e in cs.log], results)
    want = [r[1][-1] for r in results]
    if cs.shard_entries() != want:
        fail("cluster-sharded: shard_entries() differ from the replay")
    if win.eng.entries() != win.ora.entries():
        fail("cluster-sharded: the storage window's entries() differ from "
             "the independent VersionedMap")
    log("cluster-sharded-check", verdicts_equal=True, entries_equal=True,
        shard_entries=json.dumps([len(e) for e in want]),
        replies_equal=True, window_entries_equal=True,
        replay_s=f"{time.perf_counter() - t0:.2f}")
    if card:
        sync_audit("cluster-sharded", cs.syncs, cs.known, cs.sites)
    log("cluster-sharded-phase", wall_s=f"{time.perf_counter() - t_phase:.2f}")
    return tap.paths(**{"cluster-sharded": "resolver"})


def phase_multichip(rng, smi: str = "", device=None, n_txn: int = 8192,
                    n_batches: int = 6, space: int = 1 << 20,
                    window: int = 131072, lag: int = 100_000,
                    capacity: int = 1 << 19):
    """The root entry points of __graft_entry_torch__.py and the
    per-device placement: entry()'s fn(*args) on the card equal to the
    same call with device="cpu", every output element for element;
    dryrun_multichip(8) (shard s on card s % count) under the launch tap;
    then a 4-shard set placed with devices= and one placed with device=
    on the same n_batches config-4 batches of n_txn txns: statuses,
    shard_entries() and the merged st_aux bytes equal. Returns the
    probe's operands and launches in the dry run."""
    import torch

    import __graft_entry_torch__ as graft
    from foundationdb_tpu_torch.resolver.sharded import ShardedConflictSetGPU

    t_phase = time.perf_counter()
    default_knobs()
    dev = torch.device("cuda" if device is None else device)
    fn, args = graft.entry(device=device)
    out = [o.cpu() for o in fn(*args)]
    fn_c, args_c = graft.entry(device="cpu")
    want = fn_c(*args_c)
    for i, (a, b) in enumerate(zip(out, want)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"multichip: entry() output {i} on {dev} differs from "
                 "the CPU's")
    log("multichip-entry", outputs=json.dumps([list(o.shape) for o in out]),
        device=json.dumps(str(args[0].device)), equal_to_cpu=True)

    with ProbeTap() as tap:
        t0 = time.perf_counter()
        steps = graft.dryrun_multichip(8, device=device)
        dry_s = time.perf_counter() - t0
    launches = tap.launches["resolver"]
    log("multichip-dryrun", smi=json.dumps(smi), shards=8, steps=len(steps),
        statuses_equal=True, probe_launches=launches,
        wall_s=f"{dry_s:.2f}")
    if dev.type == "cuda" and (launches <= 0 or launches % 8):
        fail(f"multichip: {launches} probe launches in the dry run, not a "
             "positive multiple of its 8 shards")

    bounds = [k8(space // 4), k8(space // 2), k8(3 * space // 4)]
    kw = dict(max_key_bytes=9, initial_capacity=capacity)
    by_devices = ShardedConflictSetGPU(bounds, devices=shard_placement(
        device, 4), **kw)
    by_device = ShardedConflictSetGPU(bounds, device=device, **kw)
    log_placement("multichip", by_devices)
    v = 2_000_000
    for b in range(n_batches):
        v += n_txn
        txns = config4_txns(config4_arrays(rng, n_txn, v, space, lag))
        oldest = max(0, v - window)
        ha = by_devices.submit(v, oldest, txns)
        hb = by_device.submit(v, oldest, txns)
        st_a, st_b = ha.st.cpu(), hb.st.cpu()
        if st_a.dtype != torch.int8 or not torch.equal(st_a, st_b):
            fail(f"multichip: batch {b}: merged st_aux bytes differ between "
                 "devices= and device=")
        if by_devices.verdicts(ha) != by_device.verdicts(hb):
            fail(f"multichip: batch {b}: statuses differ between devices= "
                 "and device=")
    if by_devices.shard_entries() != by_device.shard_entries():
        fail("multichip: shard_entries() differ between devices= and "
             "device=")
    log("multichip-placements", batches=n_batches, txns_per_batch=n_txn,
        statuses_equal=True, st_aux_bytes_equal=True, entries_equal=True,
        fast_resolves=by_devices.fast_resolves,
        compactions=by_devices.compactions,
        allocated_mib=f"{allocated_mib(by_devices.devices):.1f}",
        phase_s=f"{time.perf_counter() - t_phase:.2f}")
    return tap.paths(multichip="resolver")


def phase_sharded_cluster(rng, smi: str = "", device=None,
                          key_space: int = 1 << 20, load_keys: int = 1 << 20,
                          loaders: int = 32, clients: int = 1024,
                          target: int = 10_000):
    """Path B of config 4, the reference's own layout at full width:
    ShardedKVCluster(n_storage=4, n_logs=2, replication="double",
    n_resolvers=4), both the storage shards and the resolvers split at
    rw_key of key_space/4, /2 and 3/4; each resolver role holds a
    ConflictSetGPU, each storage server a KeyValueStoreGPU window, knobs at
    their defaults. BASELINE config 1's traffic as in [cluster]: a
    `load_keys` load through the client, then ReadWrite until `target`
    txns commit. Each role's submits are replayed through its own
    ConflictSetCPU (four processes fed while the cluster runs), every read
    reply is held against an
    independent VersionedMap per storage server, every submit's syncs are
    audited."""
    import torch
    from foundationdb_tpu_torch.cluster.sharded_cluster import ShardedKVCluster
    from foundationdb_tpu_torch.core.runtime import loop_context, sim_loop

    t_phase = time.perf_counter()
    default_knobs()
    card = torch.device("cuda" if device is None else device).type == "cuda"
    bounds = [rw_key(key_space * i // 4) for i in (1, 2, 3)]
    loop = sim_loop(seed=SEED + 2)
    with StreamingReplays(4) as replays, ProbeTap() as tap:
        with loop_context(loop):
            cluster = ShardedKVCluster(
                n_storage=4, n_logs=2, replication="double",
                shard_boundaries=bounds, n_resolvers=4,
                resolver_boundaries=bounds, device=device)
            recs = []
            for i, role in enumerate(cluster.resolvers):
                role.cs = RecordingConflictSet(role.cs, replays.sink(i))
                recs.append(role.cs)
            wins = []
            for s in cluster.storages:
                s.data = CheckedWindow(s.data, "sharded-cluster")
                wins.append(s.data)
            cluster.start()
            db = cluster.database()
            keys = load_key_set(key_space, load_keys)
            stamps = {}

            async def main():
                mark = stamper(stamps)
                mark("load")
                await load_through_client(db, keys, loaders)
                mark("rw")
                c0 = ([len(r.log) for r in recs], [len(w.reads) for w in wins],
                      [len(w.compaction_ms) for w in wins])
                rw = await read_write_until(db, key_space, clients, target)
                mark("end")
                cluster.stop()
                return rw, c0

            rw, c0 = loop.run(main(), timeout_sim_seconds=1e6)
        loop.shutdown()
        # Every role's verdicts, replayed through its own ConflictSetCPU
        # while the cluster ran; the windows against their VersionedMaps.
        t0 = time.perf_counter()
        for i, w in enumerate(wins):
            if w.eng.entries() != w.ora.entries():
                fail(f"sharded-cluster: storage {i}'s entries() differ "
                     "from the independent VersionedMap")
        results = replays.results()
        t_check = time.perf_counter() - t0
    if rw.txns_done < target:
        fail(f"sharded-cluster: {rw.txns_done} config-1 transactions, "
             f"{target} wanted")
    wall_load = stamps["rw"][0] - stamps["load"][0]
    wall_rw = stamps["end"][0] - stamps["rw"][0]
    rebuild_ms = sum(sum(w.compaction_ms[n:]) for w, n in zip(wins, c0[2]))
    load_ms = sum(sum(w.compaction_ms[:n]) for w, n in zip(wins, c0[2]))
    log("sharded-cluster-load", keys=len(keys), key_space=key_space,
        txns=(len(keys) + 999) // 1000, loaders=loaders,
        wall_s=f"{wall_load:.2f}",
        keys_per_wall_s=f"{len(keys) / wall_load:.1f}",
        window_compactions=sum(c0[2]),
        compaction_rebuild_s=f"{load_ms / 1e3:.2f}")
    log("sharded-cluster-config1", smi=json.dumps(smi), clients=clients,
        committed=rw.txns_done, retries=rw.retries, wall_s=f"{wall_rw:.2f}",
        sim_s=f"{stamps['end'][1] - stamps['rw'][1]:.3f}",
        committed_per_wall_s=f"{rw.txns_done / wall_rw:.1f}",
        window_compactions=sum(len(w.compaction_ms) - n
                               for w, n in zip(wins, c0[2])),
        compaction_rebuild_s=f"{rebuild_ms / 1e3:.2f}",
        compaction_wall_share=f"{rebuild_ms / 1e3 / wall_rw:.4f}")
    for i, (rec, n0) in enumerate(zip(recs, c0[0])):
        log("sharded-cluster-resolver", smi=json.dumps(smi), role=i,
            batches=len(rec.log), config1_batches=len(rec.log) - n0,
            txns_per_batch_p50=pct(rec.n_txns[n0:], 50),
            txns_per_batch_max=max(rec.n_txns[n0:]),
            latency_ms_p50=pct(rec.lat_ms[n0:], 50),
            latency_ms_p90=pct(rec.lat_ms[n0:], 90),
            all_latency_ms_p50=pct(rec.lat_ms, 50),
            fast_resolves=rec.fast_resolves, compactions=rec.compactions,
            capacity=rec.capacity, conflicts=cluster.resolvers[i]
            .conflict_transactions,
            known_syncs_per_submit=f"{sum(rec.known) / len(rec.known):.2f}")
    reads = [x for w, n in zip(wins, c0[1]) for x in w.lat_ms[n:]]
    log("sharded-cluster-reads", smi=json.dumps(smi),
        batches=sum(len(w.reads) for w in wins),
        config1_batches=sum(len(w.reads) - n for w, n in zip(wins, c0[1])),
        config1_reads_per_batch_p50=pct(
            [x for w, n in zip(wins, c0[1]) for x in w.reads[n:]], 50),
        config1_latency_ms_p50=pct(reads, 50),
        config1_latency_ms_p90=pct(reads, 90),
        replies_checked=sum(w.replies for w in wins),
        probe_launches=tap.launches["storage"])
    if card:
        for path in ("resolver", "storage"):
            if tap.launches[path] <= 0:
                fail(f"sharded-cluster: the probe kernel was not launched "
                     f"on the {path} path")

    for i, (rec, res) in enumerate(zip(recs, results)):
        check_replays(f"sharded-cluster resolver {i}",
                      [e[3] for e in rec.log], [res])
        if rec.entries() != res[1][-1]:
            fail(f"sharded-cluster: resolver {i}'s entries() differ from "
                 "the replay")
    log("sharded-cluster-check", smi=json.dumps(smi), verdicts_equal=True,
        resolve_batches=sum(len(r.log) for r in recs),
        resolver_entries=json.dumps([len(r[1][-1]) for r in results]),
        entries_equal=True, replies_equal=True, window_entries_equal=True,
        window_entries=json.dumps([w.eng._n_base for w in wins]),
        check_s=f"{t_check:.2f}")
    if card:
        syncs, known, sites = ([x for r in recs for x in getattr(r, f)]
                               for f in ("syncs", "known", "sites"))
        sync_audit("sharded-cluster", syncs, known, sites)
    log("sharded-cluster-phase",
        wall_s=f"{time.perf_counter() - t_phase:.2f}")
    return tap.paths(**{"sharded-cluster-resolver": "resolver",
                        "sharded-cluster-storage": "storage"})


# ---------------------------------------------------------------- phase 10


class RankTap:
    """The rank-fed resolve (resolver/rankfed.py `_rank_kernel_impl`:
    phase 1, phase 2 and phase 3, a kernel each on the card) while the
    block is open: its calls on the card counted (`launches`) and the last
    call's operands kept (it replaces the version vector and the fused
    buffer is fresh per batch, so references do)."""

    def __init__(self):
        self.launches = 0
        self.captured = {}

    def __enter__(self) -> "RankTap":
        from foundationdb_tpu_torch.resolver import rankfed

        real = self._real = rankfed._rank_kernel_impl

        def kernel(hv, fused, *, lay):
            if hv.is_cuda:
                self.launches += 1
            self.captured.update(hv=hv, fused=fused, lay=lay)
            return real(hv, fused, lay=lay)

        rankfed._rank_kernel_impl = kernel
        return self

    def __exit__(self, *exc) -> None:
        from foundationdb_tpu_torch.resolver import rankfed

        rankfed._rank_kernel_impl = self._real


def rankfed_bounds(lay) -> dict:
    """Least ms of each rank-fed kernel on its inputs, bytes over the
    memory rate (each reads hv once; their other operands and outputs
    once): phase 1 hv 4 C, rank_b, rank_e, rsnap, rtxn, qb2 and the leaf
    out 24 R, too_old and base_conf 8 T, w_valid in and out 5 Wr; phase 3
    hv in and hv_new out 8 C, conflict, too_old and the statuses 12 T,
    wtxn and w_valid 8 Wr, ub_c and wsrc 8 M, the scalars 12. Their
    operations (a few a slot) are far below the integer rate."""
    p1 = 4 * lay.C + 24 * lay.R + 8 * lay.T + 5 * lay.Wr
    p3 = 8 * lay.C + 12 * lay.T + 8 * lay.Wr + 8 * lay.M + 12
    return {k: (b / HBM_BYTES_PER_S * 1e3, "bytes")
            for k, b in (("phase1", p1), ("phase3", p3))}


def rank_kernel_entries(tap: RankTap, launches: dict, busy,
                        smi: str) -> list:
    """The rank-fed resolve on its last main-path operands: the whole of
    it (phases 1-3 on the card) against the same call on the CPU, the
    profiled batch's device busy ms and op count, the wall of one
    synchronized call; then each of its two csrc/rankfed.cu kernels held
    against its plain version on the card bit for bit, timed warm and
    cold, its plain version timed, bounded: one kernel-table entry each
    (phase 2's is phase2_entry's)."""
    import torch
    from foundationdb_tpu_torch.resolver import rankfed, rankfed_ops
    from foundationdb_tpu_torch.timing import device_ms, l2_flusher

    hv, fused, lay = (tap.captured[k] for k in ("hv", "fused", "lay"))
    real = tap._real
    n0 = dict(rankfed_ops.LAUNCHES)
    p0 = rankfed.phase2.LAUNCHES
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = real(hv, fused, lay=lay)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    want = real(hv.cpu(), fused.cpu(), lay=lay)
    err = max(int((g.cpu().to(torch.int64) - w.to(torch.int64)).abs().max())
              for g, w in zip(got, want))
    if err:
        fail(f"rankfed: the resolve on the card differs from the CPU by {err}")
    ms = busy[0] if busy else None
    log("rankfed-kernel", smi=json.dumps(smi), C=lay.C, R=lay.R, Wr=lay.Wr,
        T=lay.T, max_abs_err=err,
        device_busy_ms=f"{ms:.4f}" if ms else "not measured",
        device_ops=busy[1] if busy else "not measured",
        call_wall_ms=f"{sorted(walls)[1]:.4f}",
        bound_ms=f"{sum(b for b, _ in rankfed_bounds(lay).values()):.6f}",
        launches=json.dumps(launches))

    def sl(name, size):
        off = getattr(lay, "off_" + name)
        return fused[off:off + size]

    R, Wr, T, M = lay.R, lay.Wr, lay.T, lay.M
    kw1 = dict(rank_b=sl("rank_b", R), rank_e=sl("rank_e", R),
               rsnap=sl("rsnap", R), rtxn=sl("rtxn", R),
               too_old=sl("too_old", T), qb2=sl("qb2", R),
               w_valid=sl("w_valid", Wr))
    ts1 = dict(hv=hv, **kw1)
    base_conf, leaf, valid = rankfed_ops.phase1(hv, **kw1, M=M)
    conflict = rankfed._phase2_fixed_point(
        base_conf, wb2=sl("wb2", Wr), we2=sl("we2", Wr), leaf=leaf,
        loA=sl("loA", R), hiA=sl("hiA", R), perm=sl("perm", Wr),
        rtxn=sl("rtxn", R), wtxn=sl("wtxn", Wr), w_valid=valid, T=T, M=M)
    kw3 = dict(wtxn=sl("wtxn", Wr), w_valid=sl("w_valid", Wr),
               ub_c=sl("ub_c", M), wsrc=sl("wsrc", M),
               too_old=sl("too_old", T),
               scalars=fused[lay.off_scalars:lay.off_scalars + 3])
    ts3 = dict(hv=hv, conflict=conflict, **kw3)
    runs = {
        "phase1": (lambda: rankfed_ops.phase1_launch(ts1, M=M),
                   lambda: rankfed_ops.phase1_ref(hv, **kw1, M=M)),
        "phase3": (lambda: rankfed_ops.phase3_launch(ts3),
                   lambda: rankfed_ops.phase3_ref(hv, conflict, **kw3)),
    }
    replaces = {"phase1": "foundationdb_tpu/resolver/rankfed.py:210",
                "phase3": "foundationdb_tpu/resolver/rankfed.py:255"}
    bounds = rankfed_bounds(lay)
    flush = l2_flusher(hv.device)
    out = []
    for kernel, (fn, pfn) in runs.items():
        g, w = fn(), pfn()
        torch.cuda.synchronize()
        e = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                for a, b in zip(g, w))
        if e:
            fail(f"rankfed: the {kernel} kernel disagrees with its plain "
                 f"version: max |diff| {e}")
        del g, w
        t = {"ms": device_ms(fn, n=50), "ms_cold": device_ms(fn, flush=flush),
             "plain_ms": device_ms(pfn)}
        bound_ms, bound_by = bounds[kernel]
        log(f"rankfed-{kernel}", smi=json.dumps(smi), C=lay.C, R=R, Wr=Wr,
            T=T, M=M, max_abs_err=e, **fmt_times(t),
            bound_ms=f"{bound_ms:.7f}", bound_by=bound_by,
            launches=launches[kernel])
        out.append({"name": f"rankfed_{kernel}", "route": "cuda",
                    "source": "foundationdb_tpu_torch/csrc/rankfed.cu",
                    "replaces": replaces[kernel], "path": "rankfed",
                    "launches": launches[kernel], "max_abs_err": e,
                    "ms": t["ms"], "ms_cold": t["ms_cold"],
                    "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None,
                    "resolve_busy_ms": ms,
                    "resolve_ops": busy[1] if busy else None})
    rankfed_ops.LAUNCHES.update(n0)   # comparison launches do not count
    rankfed.phase2.LAUNCHES = p0
    return out


def phase_rankfed(rng, smi: str = "", device=None, n_txn: int = 65536,
                  n_batches: int = 12, capacity: int = 1 << 23,
                  full_txns_per_s=None):
    """BASELINE config 5 through the rank-fed set: ConflictSetRankFed
    (max_key_bytes 12: the 9-byte end keys fit without a width growth;
    `capacity` slots) on the card, n_batches of n_txn txns from
    config5_batch (converted to TxnConflictInfo lists beforehand) through
    prepare/pack/resolve_async at depth 4, the version 65,536 on per batch
    and the GC horizon version - 131,072; then one profiled batch and the
    sync audit's batches. The first 2 batches also run through
    ConflictSetRankFed(device="cpu"): statuses and the version vector equal
    bit for bit. A ConflictSetCPU replays every batch in a process of its
    own: every batch's statuses and the final entries() must equal its.
    Returns the kernel-table entries of the rank-fed kernel and of the
    phase-2 kernel on this path (none on the CPU) and the check against
    the replay, to call once it may wait for it."""
    import torch
    from foundationdb_tpu_torch.resolver import phase2, rankfed_ops
    from foundationdb_tpu_torch.resolver.rankfed import ConflictSetRankFed

    t_phase = time.perf_counter()
    default_knobs()
    step, window, depth, v0 = 65536, 131072, 4, 1_000_000
    dev = torch.device("cuda" if device is None else device)
    card = dev.type == "cuda"
    n_audit = 3
    n_all = n_batches + 1 + n_audit
    versions = [v0 + i * step for i in range(n_all)]
    wires = [config5_batch(rng, n_txn, v) for v in versions]
    # The oracle has every batch at once: it replays while the batches are
    # converted and the card runs, and on while the next phases run (the
    # returned check waits for it).
    replays = StreamingReplays()
    with RankTap() as tap, Phase2Tap() as p2_tap:
        for v, wb in zip(versions, wires):
            replays.send((v, max(0, v - window), wb))
        t0 = time.perf_counter()
        batches = [wb.to_txns() for wb in wires]
        convert_s = time.perf_counter() - t0
        del wires
        kw = dict(max_key_bytes=12, initial_capacity=capacity)
        rf = ConflictSetRankFed(device=device, **kw)
        statuses, lat, handles, p2 = [], [], [], []
        stages = {"prepare_ms": [], "pack_ms": [], "dispatch_ms": []}

        def dispatch(i):
            v = versions[i]
            t0 = time.perf_counter()
            rf.prepare(batches[i])
            t1 = time.perf_counter()
            pb = rf.pack(batches[i])
            t2 = time.perf_counter()
            h = rf.resolve_async(v, max(0, v - window), pb)
            t3 = time.perf_counter()
            for k, x in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
                stages[k].append(x * 1e3)
            p2.append(h.p2_syncs)
            return t0, h

        def consume():
            t0, h = handles.pop(0)
            statuses.append(h.result())
            lat.append((time.perf_counter() - t0) * 1e3)

        tap.launches = 0
        phase2.LAUNCHES = 0
        rankfed_ops.LAUNCHES.update(phase1=0, phase3=0)
        gc0 = rf.gc_rounds
        sync(dev)
        for i in range(n_batches):
            if i == 2:
                while handles:
                    consume()
                twin = ConflictSetRankFed(device="cpu", **kw)
                for j in range(2):
                    twin.prepare(batches[j])
                    st = twin.resolve_packed(
                        versions[j], max(0, versions[j] - window),
                        twin.pack(batches[j]))
                    if not np.array_equal(st, statuses[j]):
                        fail(f"rankfed: card statuses differ from the CPU "
                             f"twin at batch {j}")
                if not (torch.equal(rf.hv.cpu(), twin.hv)
                        and np.array_equal(rf.mirror, twin.mirror)):
                    fail("rankfed: the card's version vector or mirror "
                         "differs from the CPU twin after batch 2")
                del twin
                t_steady = time.perf_counter()
            elif len(handles) >= depth:
                consume()
            handles.append(dispatch(i))
        while handles:
            consume()
        sync(dev)
        t_end = time.perf_counter()
        launches = tap.launches
        p2_launches = phase2.LAUNCHES
        p2_cap = dict(p2_tap.captured, launches=p2_launches)
        k_launches = dict(rankfed_ops.LAUNCHES)
        gc_rounds = rf.gc_rounds - gc0
        if card and launches != n_batches:
            fail(f"rankfed: {launches} resolves on the card for "
                 f"{n_batches} batches")
        if card and k_launches != {"phase1": n_batches,
                                   "phase3": n_batches}:
            fail(f"rankfed: kernel launches {k_launches} for {n_batches} "
                 "batches (one of each a batch)")
        if card and p2_launches < n_batches:
            fail(f"rankfed: {p2_launches} phase-2 kernel launches for "
                 f"{n_batches} batches")
        if card and any(p2):
            fail(f"rankfed: phase 2 read the host in resolve_async: {p2}")
        steady = (n_batches - 2) * n_txn / (t_end - t_steady)
        st = np.concatenate(statuses)
        if st.size != n_txn * n_batches or not np.isin(st, (0, 1, 2)).all():
            fail("rankfed: malformed statuses")
        log("rankfed", smi=json.dumps(smi), batches=n_batches,
            txns_per_batch=n_txn, txns_per_s=f"{steady:.1f}",
            full_txns_per_s=(f"{full_txns_per_s:.1f}" if full_txns_per_s
                             else "not measured"),
            p50_batch_ms=f"{np.percentile(lat, 50):.2f}",
            p90_batch_ms=f"{np.percentile(lat, 90):.2f}",
            conflict_rate=f"{float((st == 1).mean()):.4f}",
            gc_rounds=gc_rounds, capacity=rf.capacity, history=rf.n,
            key_bytes=rf.max_key_bytes,
            p2_reads_per_batch=f"{sum(p2) / len(p2):.2f}",
            launches=launches, phase2_launches=p2_launches,
            kernel_launches=json.dumps(k_launches), cpu_twin_batches=2,
            convert_s=f"{convert_s:.2f}")
        log("rankfed-stages", **{
            f"p50_{k}": f"{np.percentile(x, 50):.2f}"
            for k, x in stages.items()},
            max_prepare_ms=f"{max(stages['prepare_ms']):.2f}")

        def run_one(i):
            statuses.append(dispatch(i)[1].result())

        busy = None
        if card:
            busy = profile_batch(lambda: run_one(n_batches),
                                 batch_ms=1e3 * n_txn / steady,
                                 phase="rankfed-profile", smi=smi)
        else:
            run_one(n_batches)
        # The sync audit: resolve_async makes no host sync (phase 2 runs
        # on the card); a GC round makes one read.
        audit = []
        for i in range(n_batches + 1, n_all):
            v = versions[i]
            rf.prepare(batches[i])
            pb = rf.pack(batches[i])
            if card:
                sites = []
                h, n = count_syncs(
                    lambda: rf.resolve_async(v, max(0, v - window), pb),
                    sites=sites)
                audit.append((n, h.p2_syncs, sites))
            else:
                h = rf.resolve_async(v, max(0, v - window), pb)
            statuses.append(h.result())
        if card:
            _, gc_syncs = count_syncs(rf.gc_round)
            log("rankfed-sync-audit", dispatches=len(audit),
                host_syncs=json.dumps([a[0] for a in audit]),
                phase2_reads=json.dumps([a[1] for a in audit]),
                gc_round_syncs=gc_syncs)
            if any(n or k for n, k, _ in audit):
                fail(f"rankfed: resolve_async made host syncs or phase-2 "
                     f"reads: {audit}")
            if gc_syncs != 1:
                fail(f"rankfed: a GC round made {gc_syncs} host syncs, 1 "
                     "expected")
        entries = rf.entries()
    table = ([*rank_kernel_entries(tap, k_launches, busy, smi),
              phase2_entry("rankfed", p2_cap, p2_launches, smi,
                           P2_REPLACES["rankfed"])] if card else [])
    del p2_cap
    log("rankfed-phase", wall_s=f"{time.perf_counter() - t_phase:.2f}")

    def check():
        """Every batch's statuses and the final entries() against the
        oracle's replay, once it has finished."""
        with replays:
            t0 = time.perf_counter()
            results = replays.results()
        check_replays("rankfed", statuses, results)
        if entries != results[0][1][-1]:
            fail("rankfed: entries() differ from the oracle's replay")
        log("rankfed-check", verdicts_equal=True, batches=len(statuses),
            entries_equal=True, entries=len(entries),
            replay_wait_s=f"{time.perf_counter() - t0:.2f}")

    return table, check


# ---------------------------------------------------------------- phase 11


def watched(cls, on_commit):
    """A workload class whose commit counter (txns_done) calls
    on_commit(n) at every commit."""

    class Watched(cls):
        @property
        def txns_done(self):
            return self.__dict__.get("_txns_done", 0)

        @txns_done.setter
        def txns_done(self, n):
            self.__dict__["_txns_done"] = n
            if n:
                on_commit(n)

    return Watched


class GenerationWatch:
    """A recoverable cluster's generations as they come and go.

    - factory(v) is the cluster's conflict_set_factory: make_conflict_set
      (the CONFLICT_SET_IMPL knob's set) in a RecordingConflictSet that
      streams role i's batches to replay process i, which starts a fresh
      ConflictSetCPU(v) for the generation;
    - the cluster's _recover is wrapped to stamp each recovery's end and
      the probe launches so far;
    - kill() kills the transaction system, reads the dead generation's
      open verdicts and its entries(), then stamps the time;
    - committed(n), the workload's commit counter, kills at the counts in
      `kill_at` and stamps the first commit acknowledged after each
      recovery; then it collects and checks that no dead generation's
      conflict set is left.

    Only the records' lists are kept past a generation's end: the sets
    themselves must become unreachable."""

    def __init__(self, cluster, replays, roles: int, tap, device=None):
        from foundationdb_tpu_torch.core.runtime import current_loop

        self.cluster, self.replays, self.roles = cluster, replays, roles
        self.tap, self.device = tap, device
        self.loop = current_loop()
        self.gens = []          # one dict per generation
        self.kills = []         # one dict per kill
        self.recoveries = []    # one dict per recovery
        self.kill_at = []
        self.gc_s, self.collections = 0.0, 0
        self._live = []         # the live generation's records
        real = cluster._recover

        def recover():
            t0 = time.perf_counter()
            real()
            self.recoveries.append(dict(
                gen=cluster.generation, start=t0, end=time.perf_counter(),
                sim=self.loop.now(), launches=dict(tap.launches)))

        cluster._recover = recover

    def factory(self, v: int):
        from foundationdb_tpu_torch.resolver.factory import make_conflict_set

        if len(self._live) == self.roles:
            # A recovery no kill asked for (the controller found the
            # commit path unhealthy): the roles were stopped just now.
            self.end_generation()
        i = len(self._live)
        if i == 0:
            self.gens.append(dict(start=v, logs=[], refs=[], entries=None,
                                  syncs=[], known=[], sites=[], cs=[]))
        gen = self.gens[-1]
        cs = (make_conflict_set(v) if self.device is None
              else make_conflict_set(v, device=self.device))
        self.replays.sink(i)(v)
        rec = RecordingConflictSet(cs, self.replays.sink(i))
        self._live.append(rec)
        gen["logs"].append(rec.log)
        gen["refs"].append(weakref.ref(cs))
        gen["cs"].append(type(cs).__name__)
        for k in ("syncs", "known", "sites"):
            gen[k].append(getattr(rec, k))
        return rec

    def end_generation(self, last: bool = False) -> None:
        """The live generation's last verdicts and entries(), taken after
        its roles were stopped (the replays take theirs at a marker, or at
        their end after the `last` one)."""
        for rec in self._live:
            rec.drain()
        self.gens[-1]["entries"] = [rec.entries() for rec in self._live]
        self.gens[-1]["stats"] = [(rec.fast_resolves, rec.compactions)
                                  if hasattr(rec.cs, "fast_resolves")
                                  else (None, None) for rec in self._live]
        if not last:
            for i in range(self.roles):
                self.replays.sink(i)("entries")
        self._live = []

    def kill(self) -> None:
        self.cluster.kill_transaction_system()
        self.end_generation()
        # The clock starts after this watch's own reads of the dead
        # generation (its verdicts and entries()): no simulated time
        # passes in them, and they are the check's work, not recovery's.
        self.kills.append(dict(gen=self.cluster.generation,
                               wall=time.perf_counter(), sim=self.loop.now()))

    def committed(self, n: int) -> None:
        if self.kill_at and n >= self.kill_at[0]:
            self.kill_at.pop(0)
            self.kill()
            return
        k = self.kills[-1] if self.kills else None
        if (k is not None and "first_commit" not in k
                and self.recoveries[-1]["gen"] > k["gen"]):
            k["first_commit"] = time.perf_counter()
            k["first_commit_sim"] = self.loop.now()
            rec = next(r for r in self.recoveries if r["gen"] > k["gen"])
            k["recovered"], k["recovered_sim"] = rec["end"], rec["sim"]
            self.check_collected()

    def check_collected(self) -> None:
        """No dead generation's conflict set is left: a full collection
        (seconds over this heap) runs only when one is still referenced."""
        def alive():
            return [g + 1 for g, gen in enumerate(self.gens[:-1])
                    if any(r() is not None for r in gen["refs"])]

        if alive():
            t0 = time.perf_counter()
            gc.collect()
            self.gc_s += time.perf_counter() - t0
            self.collections += 1
        if alive():
            fail(f"generations {alive()}: conflict sets still alive after "
                 "recovery")

    def recover_times(self) -> list:
        """Per kill: (generation killed, ms to recovered, ms to the first
        commit acknowledged after it, the same in simulated s)."""
        out = []
        for k in self.kills:
            if "first_commit" not in k:
                fail(f"no commit acknowledged after the kill of generation "
                     f"{k['gen']}")
            out.append((k["gen"],
                        round((k["recovered"] - k["wall"]) * 1e3, 2),
                        round((k["first_commit"] - k["wall"]) * 1e3, 2),
                        round(k["recovered_sim"] - k["sim"], 4),
                        round(k["first_commit_sim"] - k["sim"], 4)))
        return out

    def launches(self) -> list:
        """Probe launches on each path in each generation: between its
        recovery and the next one (the last: to now)."""
        snaps = [r["launches"] for r in self.recoveries]
        snaps.append(dict(self.tap.launches))
        return [{p: b[p] - a[p] for p in a} for a, b in zip(snaps, snaps[1:])]

    def check(self, name: str, results) -> None:
        """Each role's verdicts over every generation against its replay,
        and each generation's entries() against the replay's at its end."""
        for i, res in enumerate(results):
            check_replays(f"{name} role {i}",
                          [e[3] for gen in self.gens for e in gen["logs"][i]],
                          [res])
            if len(res[1]) != len(self.gens):
                fail(f"{name}: role {i} replayed {len(res[1])} generations "
                     f"of {len(self.gens)}")
            for g, (gen, want) in enumerate(zip(self.gens, res[1])):
                if gen["entries"][i] != want:
                    fail(f"{name}: generation {g + 1} role {i}'s entries() "
                         "differ from its replay")

    def audit(self, name: str) -> None:
        syncs, known, sites = ([x for gen in self.gens for r in gen[k]
                                for x in r]
                               for k in ("syncs", "known", "sites"))
        sync_audit(name, syncs, known, sites)


def recovery_summary(name: str, watch: GenerationWatch, smi: str,
                     card: bool) -> None:
    ttr = watch.recover_times()
    launches = watch.launches()
    log(f"{name}-ttr", smi=json.dumps(smi), kills=len(ttr),
        to_recovered_ms=json.dumps([t[1] for t in ttr]),
        to_first_commit_ms=json.dumps([t[2] for t in ttr]),
        to_recovered_sim_s=json.dumps([t[3] for t in ttr]),
        to_first_commit_sim_s=json.dumps([t[4] for t in ttr]),
        p50_to_recovered_ms=f"{np.percentile([t[1] for t in ttr], 50):.2f}",
        p50_to_first_commit_ms=f"{np.percentile([t[2] for t in ttr], 50):.2f}",
        recover_call_ms=json.dumps([round((r["end"] - r["start"]) * 1e3, 2)
                                    for r in watch.recoveries]))
    log(f"{name}-generations", generations=len(watch.gens),
        start_versions=json.dumps([g["start"] for g in watch.gens]),
        conflict_sets=json.dumps(sorted({c for g in watch.gens
                                         for c in g["cs"]})),
        batches=json.dumps([[len(x) for x in g["logs"]] for g in watch.gens]),
        fast_compactions=json.dumps([g["stats"] for g in watch.gens]),
        probe_launches=json.dumps(launches),
        dead_sets_collected=True, collections=watch.collections,
        gc_s=f"{watch.gc_s:.2f}")
    if card:
        for g, gl in enumerate(launches):
            for path, n in gl.items():
                if n <= 0:
                    fail(f"{name}: the probe kernel was not launched on the "
                         f"{path} path in generation {g + 1}")


def phase_recovery(rng, smi: str = "", device=None, nodes: int = 1000,
                   cycle_clients: int = 64, cycle_txns: int = 25,
                   key_space: int = 1 << 20, load_keys: int = 1 << 18,
                   loaders: int = 32, clients: int = 1024,
                   target: int = 10_000):
    """The recovery tier on the card: the port's RecoverableCluster, two
    controllers, its resolver recruited every generation through the
    CONFLICT_SET_IMPL knob ("gpu": ConflictSetGPU at its default size) and
    its long-lived storage window KeyValueStoreGPU, knobs at their
    defaults. Cycle (`nodes` nodes, cycle_clients x cycle_txns) with the
    transaction system killed after 25%, 50% and 75% of the commits; then
    BASELINE config 1 as in [cluster] (a `load_keys` load, ReadWrite from
    `clients` clients until `target` commits) with kills at 25%, 50% and
    75% of `target`. Each generation's submits replay through a fresh
    ConflictSetCPU at its start version (one process, fed while the
    cluster runs): statuses and entries() equal; every read reply is held
    against an independent VersionedMap; after each recovery no dead
    generation's conflict set is left. Prints the time to recover. Returns
    the probe's operands and launches on each path."""
    import torch
    from foundationdb_tpu_torch.cluster.recovery import RecoverableCluster
    from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS
    from foundationdb_tpu_torch.core.runtime import loop_context, sim_loop
    from foundationdb_tpu_torch.workloads.cycle import CycleWorkload
    from foundationdb_tpu_torch.workloads.read_write import ReadWriteWorkload

    t_phase = time.perf_counter()
    default_knobs()
    card = torch.device("cuda" if device is None else device).type == "cuda"
    loop = sim_loop(seed=SEED + 3)
    with StreamingReplays() as replays, ProbeTap() as tap:
        with loop_context(loop):
            rc = RecoverableCluster(device=device)
            watch = GenerationWatch(rc, replays, 1, tap, device)
            rc.conflict_set_factory = watch.factory
            win = CheckedWindow(rc.storage.data, "recovery")
            rc.storage.data = win
            rc.start()
            rc.start_controller("cc0")
            rc.start_controller("cc1")
            db = rc.database()
            keys = load_key_set(key_space, load_keys)
            stamps = {}

            async def main():
                mark = stamper(stamps)
                total = cycle_clients * cycle_txns
                watch.kill_at = [total // 4, total // 2, 3 * total // 4]
                cyc = watched(CycleWorkload, watch.committed)(db, nodes=nodes)
                await cyc.setup()
                mark("cycle")
                await cyc.start(clients=cycle_clients,
                                txns_per_client=cycle_txns)
                mark("cycle-end")
                ok = await cyc.check()
                gen_cycle = rc.generation
                await load_through_client(db, keys, loaders)
                mark("rw")
                watch.kill_at = [target // 4, target // 2, 3 * target // 4]
                rw = await read_write_until(
                    db, key_space, clients, target,
                    cls=watched(ReadWriteWorkload, watch.committed))
                mark("end")
                rc.stop()
                return ok, cyc, rw, gen_cycle

            ok, cyc, rw, gen_cycle = loop.run(main(), timeout_sim_seconds=1e6)
            watch.end_generation(last=True)
        loop.shutdown()
        t0 = time.perf_counter()
        results = replays.results()
        t_replay = time.perf_counter() - t0
    if not ok:
        fail("recovery: the Cycle invariant does not hold")
    if gen_cycle < 4 or rc.generation < 7:
        fail(f"recovery: generation {gen_cycle} after Cycle and "
             f"{rc.generation} at the end, 4 and 7 wanted")
    if rw.txns_done < target:
        fail(f"recovery: {rw.txns_done} config-1 transactions, {target} "
             "wanted")
    wall_cyc = stamps["cycle-end"][0] - stamps["cycle"][0]
    wall_rw = stamps["end"][0] - stamps["rw"][0]
    log("recovery-cycle", smi=json.dumps(smi), nodes=nodes,
        clients=cycle_clients, txns=cyc.txns_done, retries=cyc.retries,
        check=ok, generation=gen_cycle, wall_s=f"{wall_cyc:.2f}",
        committed_per_wall_s=f"{cyc.txns_done / wall_cyc:.1f}")
    log("recovery-config1", smi=json.dumps(smi), clients=clients,
        committed=rw.txns_done, retries=rw.retries,
        generation=rc.generation, wall_s=f"{wall_rw:.2f}",
        committed_per_wall_s=f"{rw.txns_done / wall_rw:.1f}",
        read_batches=len(win.reads), replies_checked=win.replies,
        knob=SERVER_KNOBS.CONFLICT_SET_IMPL)
    recovery_summary("recovery", watch, smi, card)
    watch.check("recovery", results)
    if win.eng.entries() != win.ora.entries():
        fail("recovery: the storage window's entries() differ from the "
             "independent VersionedMap")
    log("recovery-check", smi=json.dumps(smi), verdicts_equal=True,
        entries_equal=True, generations=len(watch.gens),
        resolve_batches=sum(len(g["logs"][0]) for g in watch.gens),
        replies_equal=True, replies=win.replies, window_entries_equal=True,
        replay_wait_s=f"{t_replay:.2f}")
    if card:
        watch.audit("recovery")
    log("recovery-phase", wall_s=f"{time.perf_counter() - t_phase:.2f}")
    return tap.paths(**{"recovery-resolver": "resolver",
                        "recovery-storage": "storage"})


# ---------------------------------------------------------------- phase 12


def phase_sharded_recovery(rng, smi: str = "", device=None, nodes: int = 1000,
                           clients: int = 64, txns: int = 25):
    """The sharded recovery tier on the card: the port's
    RecoverableShardedCluster(n_storage=4, n_logs=2, replication="double",
    n_resolvers=4), the storage shards and the resolvers split at the
    Cycle keys of nodes/4, nodes/2 and 3*nodes/4, each generation's four
    resolvers recruited through the knob. Cycle over `nodes` nodes
    (clients x txns) with the transaction system killed after a third and
    two thirds of the commits. Each generation's four roles replay through
    their own ConflictSetCPU (four processes); every read reply is held
    against an independent VersionedMap per storage server; after the run
    every team member of every shard answers the same get_range. Returns
    the probe's operands and launches on the resolver path."""
    import torch
    from foundationdb_tpu_torch.cluster.interfaces import GetRangeRequest
    from foundationdb_tpu_torch.cluster.recovery import (
        RecoverableShardedCluster,
    )
    from foundationdb_tpu_torch.core.runtime import loop_context, sim_loop
    from foundationdb_tpu_torch.kv.keys import KEYSPACE_END
    from foundationdb_tpu_torch.workloads.cycle import CycleWorkload

    t_phase = time.perf_counter()
    default_knobs()
    card = torch.device("cuda" if device is None else device).type == "cuda"
    bounds = [cycle_key(nodes * i // 4) for i in (1, 2, 3)]
    loop = sim_loop(seed=SEED + 4)
    with StreamingReplays(4) as replays, ProbeTap() as tap:
        with loop_context(loop):
            c = RecoverableShardedCluster(
                n_storage=4, n_logs=2, replication="double",
                shard_boundaries=bounds, n_resolvers=4,
                resolver_boundaries=bounds, device=device)
            watch = GenerationWatch(c, replays, 4, tap, device)
            c.conflict_set_factory = watch.factory
            wins = []
            for s in c.inner.storages:
                s.data = CheckedWindow(s.data, "sharded-recovery")
                wins.append(s.data)
            c.start()
            c.start_controller("cc0")
            c.start_controller("cc1")
            db = c.database()

            async def main():
                total = clients * txns
                watch.kill_at = [total // 3, 2 * total // 3]
                cyc = watched(CycleWorkload, watch.committed)(db, nodes=nodes)
                await cyc.setup()
                t0 = time.perf_counter()
                await cyc.start(clients=clients, txns_per_client=txns)
                wall = time.perf_counter() - t0
                ok = await cyc.check()
                # every team member of every shard, through its read path
                v = max(s.version.get() for s in c.inner.storages)
                diverged = []
                for b, e, team in c.shard_map.ranges():
                    if not team:
                        continue
                    e = e if e is not None else KEYSPACE_END
                    rows = [await c.inner.storages[t].get_range(
                        GetRangeRequest(begin=b, end=e, version=v))
                        for t in team]
                    if any(r != rows[0] for r in rows[1:]):
                        diverged.append((b, e, team))
                c.stop()
                return ok, cyc, wall, diverged

            ok, cyc, wall, diverged = loop.run(main(),
                                               timeout_sim_seconds=1e6)
            watch.end_generation(last=True)
        loop.shutdown()
        for i, w in enumerate(wins):
            if w.eng.entries() != w.ora.entries():
                fail(f"sharded-recovery: storage {i}'s entries() differ "
                     "from the independent VersionedMap")
        results = replays.results()
    if not ok:
        fail("sharded-recovery: the Cycle invariant does not hold")
    if diverged:
        fail(f"sharded-recovery: team members diverge on {diverged}")
    if c.generation < 3:
        fail(f"sharded-recovery: generation {c.generation}, 3 wanted")
    log("sharded-recovery", smi=json.dumps(smi), roles=4, nodes=nodes,
        clients=clients, txns=cyc.txns_done, retries=cyc.retries, check=ok,
        generation=c.generation, wall_s=f"{wall:.2f}",
        committed_per_wall_s=f"{cyc.txns_done / wall:.1f}",
        replies_checked=sum(w.replies for w in wins),
        shards_equal_across_teams=True)
    recovery_summary("sharded-recovery", watch, smi, card)
    watch.check("sharded-recovery", results)
    log("sharded-recovery-check", verdicts_equal=True, entries_equal=True,
        replies_equal=True, window_entries_equal=True)
    if card:
        watch.audit("sharded-recovery")
    log("sharded-recovery-phase",
        wall_s=f"{time.perf_counter() - t_phase:.2f}")
    return tap.paths(**{"sharded-recovery-resolver": "resolver"})



# ---------------------------------------------------------------- phase 14

# [durable]: the keys loaded (of config 1's 2^20), the ReadWrite commits
# before the clean stop, and those of the incarnation a crash abandons.
# The load is cut from the 2^18 of [cluster] to 2^16: on an H100 80GB
# HBM3 at 700 W the memory engine's leg took ~145 s at 2^18 (a boot's
# construction 34-37 s, ~64 us per restored row, its files 4.4 GB) and
# the phase 258 s; at 2^16, 86 s (PERF.md §4).
DURABLE_LOAD_KEYS = 1 << 16
DURABLE_TARGET = 2000
DURABLE_CRASH_TARGET = 500


def acked_read_write(writes: list, timing: dict | None = None,
                     maybe: list | None = None):
    """ReadWriteWorkload (config 1's mix) whose every committed write is
    also appended to `writes` as (commit version, order, key, value): the
    independent record of the acknowledged writes. It draws from the
    loop's random stream exactly as ReadWriteWorkload does. With `timing`
    ({"grv_ms": [], "commit_ms": [], "starts": [], "acks": []}) each
    committed transaction's GRV and commit wall ms, and the wall instants
    of its last attempt's start and of its acknowledgement, are recorded;
    with `maybe`, the writes of an attempt whose commit ended in any error
    but not_committed (1020) are appended as (key, value): such a commit
    may or may not have committed, as when a killed process took its
    reply (commit_unknown_result, 1021)."""
    from foundationdb_tpu_torch.core.runtime import current_loop
    from foundationdb_tpu_torch.workloads.read_write import ReadWriteWorkload

    class AckedReadWrite(ReadWriteWorkload):
        async def _one(self) -> None:
            loop = current_loop()
            rng = loop.random
            t0 = loop.now()
            tr = self.db.create_transaction()
            while True:
                sets = []
                committing = False
                try:
                    if timing is not None:
                        g0 = time.perf_counter()
                        await tr.get_read_version()
                        g1 = time.perf_counter()
                    for _ in range(self.reads_per_txn):
                        await tr.get(self._key(rng))
                    for _ in range(self.writes_per_txn):
                        k = self._key(rng)
                        v = b"v%d" % rng.random_int(0, 1 << 20)
                        tr.set(k, v)
                        sets.append((k, v))
                    c0 = time.perf_counter()
                    committing = True
                    version = await tr.commit()
                    break
                except BaseException as e:  # noqa: BLE001 - as the base
                    if (maybe is not None and committing
                            and getattr(e, "code", 0) != 1020):
                        maybe.extend(sets)
                    self.retries += 1
                    await tr.on_error(e)
            writes.extend((version, len(writes) + i, k, v)
                          for i, (k, v) in enumerate(sets))
            if timing is not None:
                c1 = time.perf_counter()
                timing["grv_ms"].append((g1 - g0) * 1e3)
                timing["commit_ms"].append((c1 - c0) * 1e3)
                timing["starts"].append(g0)
                timing["acks"].append(c1)
            self.txns_done += 1
            self.latency.add_sample(loop.now() - t0)

    return AckedReadWrite


def acked_state(loaded: list, writes: list, at: int | None = None) -> dict:
    """The state the acknowledged writes leave, through an independent
    VersionedMap: the loaded keys, then every acknowledged write at its
    commit version, read at version `at` (None: the last)."""
    from foundationdb_tpu_torch.kv.versioned_map import VersionedMap

    writes = [w for w in writes if at is None or w[0] <= at]
    vm = VersionedMap()
    for k in loaded:
        vm.set(k, b"v%d" % len(k), 1)
    top = 1
    for version, _, k, v in sorted(writes):
        vm.set(k, v, version)
        top = max(top, version)
    keys = set(loaded) | {k for _, _, k, _ in writes}
    return {k: vm.get(k, top) for k in sorted(keys)}


def window_bytes(w) -> int:
    """Device bytes of a KeyValueStoreGPU window's tensors."""
    return sum(t.numel() * t.element_size() for t in (
        w._d_hmat, w._d_slots, w._d_next, w._d_fences, w._d_dmat,
        w._d_dslots, w._d_dnext))


def dir_bytes(path: str) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def phase_durable(rng, smi: str = "", device=None,
                  key_space: int = 1 << 20,
                  load_keys: int = DURABLE_LOAD_KEYS,
                  loaders: int = 32, clients: int = 1024,
                  target: int = DURABLE_TARGET,
                  crash_target: int = DURABLE_CRASH_TARGET):
    """The durable tier on the card: BASELINE config 4's cluster shape,
    RecoverableShardedCluster(n_storage=4, n_logs=2, log_replication=
    "double", replication="double", n_resolvers=4, storage shards and
    resolvers split at rw_key of key_space/4, /2 and 3/4) over a datadir
    (a temporary directory, removed at the end), its storage windows
    KeyValueStoreGPU on `device`, knobs at their defaults.

    - memory engine: load `load_keys` of config 1's keys through the
      client, ReadWrite (5 reads, 2 writes) until `target` commits, stop
      cleanly; cold boot a fresh incarnation from the datadir;
    - crash leg: an incarnation runs `crash_target` more commits and is
      abandoned without stop or close (as a killed process), then a cold
      boot;
    - engine="ssd": its own load and `target` commits with a clean stop,
      then the crash leg.

    Every cold boot: each storage window's entries() equal a VersionedMap
    restored from the same engine rows (taken before the cluster starts:
    the window rebuilds once, not once per row), then start, one commit,
    and every key read back through the client in 64 range reads, equal
    to the state the acknowledged writes (an independent record) leave.
    Prints each boot's times (construction: the engines' recovery and the
    windows' restore; the windows' one rebuild; start to fully_recovered
    and to the first acknowledged commit), rows restored, compactions,
    bytes on disk and the windows' device bytes. Dead incarnations'
    windows must be collected. Returns the probe's paths over the cold
    boots."""
    import shutil
    import tempfile

    import torch
    from foundationdb_tpu_torch.cluster.recovery import (
        RecoverableShardedCluster,
    )
    from foundationdb_tpu_torch.core.runtime import loop_context, sim_loop
    from foundationdb_tpu_torch.kv.versioned_map import VersionedMap
    from foundationdb_tpu_torch.storage_engine.gpu_engine import (
        KeyValueStoreGPU,
    )

    t_phase = time.perf_counter()
    default_knobs()
    dev = torch.device("cuda" if device is None else device)
    card = dev.type == "cuda"
    bounds = [rw_key(key_space * i // 4) for i in (1, 2, 3)]
    keys = load_key_set(key_space, load_keys)
    refs = []          # weak references to every incarnation's windows
    boot_launches = {"resolver": 0, "storage": 0}
    seeds = iter(range(SEED + 10, SEED + 100))

    def cluster(datadir, engine):
        c = RecoverableShardedCluster(
            n_storage=4, n_logs=2, log_replication="double",
            replication="double", shard_boundaries=bounds, n_resolvers=4,
            resolver_boundaries=bounds, datadir=datadir, engine=engine,
            device=device)
        refs.extend(weakref.ref(s.data) for s in c.inner.storages)
        return c

    def load_and_write(datadir, engine, n, writes, stop: bool):
        """An incarnation on `datadir`: the load (when `writes` is empty,
        the datadir being new), ReadWrite until n commits, then a clean
        stop or an abandoned process."""
        loop = sim_loop(seed=next(seeds))
        with loop_context(loop):
            c = cluster(datadir, engine).start()
            db = c.database()

            async def main():
                t0 = time.perf_counter()
                if not writes:
                    await load_through_client(db, keys, loaders)
                t1 = time.perf_counter()
                rw = await read_write_until(db, key_space, clients, n,
                                            cls=acked_read_write(writes))
                if stop:
                    c.stop()
                return t1 - t0, time.perf_counter() - t1, rw.txns_done

            out = loop.run(main(), timeout_sim_seconds=1e6)
        loop.shutdown()
        return out

    def cold_boot(datadir, engine, writes, tap, leg):
        """A fresh incarnation on `datadir`: the restored windows checked,
        the boot timed, every key read back; then a clean stop."""
        want = acked_state(keys, writes)
        loop = sim_loop(seed=next(seeds))
        launches0 = dict(tap.launches)
        with loop_context(loop):
            mem0 = torch.cuda.memory_allocated(dev) if card else 0
            t0 = time.perf_counter()
            c = cluster(datadir, engine)
            t1 = time.perf_counter()
            rows, comps, rebuild_ms, wbytes = [], [], 0.0, 0
            for i, s in enumerate(c.inner.storages):
                w = s.data
                if card and not isinstance(w, KeyValueStoreGPU):
                    fail(f"durable: storage {i}'s window is {type(w)}")
                restored = VersionedMap()
                dv = s.engine_durable
                n = 0
                for k, v in s.engine.get_range(b"", b"\xff\xff"):
                    restored.set_snapshot(k, v, dv)
                    n += 1
                n0 = w.c_compactions.total
                if w.entries() != restored.entries():
                    fail(f"durable {leg}: storage {i}'s window differs from "
                         "a VersionedMap restored from its engine's rows")
                comps.append(w.c_compactions.total - n0)
                if comps[-1] != (1 if n else 0):
                    fail(f"durable {leg}: storage {i} compacted "
                         f"{comps[-1]} times restoring {n} rows")
                if comps[-1]:
                    rebuild_ms += w.last_rebuild_ms + w.last_upload_ms
                rows.append(n)
                wbytes += window_bytes(w)
            mem_windows = (torch.cuda.memory_allocated(dev) - mem0
                           if card else 0)
            t2 = time.perf_counter()
            c.start()
            t3 = time.perf_counter()
            if c.recovery_state != "fully_recovered":
                fail(f"durable {leg}: {c.recovery_state} after start")
            db = c.database()

            async def main():
                await db.set(b"durable/boot", leg.encode())
                t4 = time.perf_counter()
                got = []
                ks = sorted(want)
                edges = [b"rw/"] + ks[len(ks) // 64::len(ks) // 64][:63] + [
                    b"rw0"]
                for b, e in zip(edges, edges[1:]):
                    async def body(tr, b=b, e=e):
                        return await tr.get_range(b, e)

                    got += await db.transact(body)
                t5 = time.perf_counter()
                c.stop()
                return t4, t5, got

            t4, t5, got = loop.run(main(), timeout_sim_seconds=1e6)
        loop.shutdown()
        if got != sorted(want.items()):
            bad = sum(1 for k, v in got if want.get(k) != v)
            fail(f"durable {leg}: the read-back differs from the "
                 f"acknowledged writes ({len(got)} rows read, "
                 f"{len(want)} wanted, {bad} values differ)")
        for p in boot_launches:
            boot_launches[p] += tap.launches[p] - launches0[p]
        construct_ms = (t1 - t0) * 1e3
        log("durable-boot", smi=json.dumps(smi), leg=leg, engine=engine,
            rows_restored=json.dumps(rows),
            compactions_per_window=json.dumps(comps),
            construct_ms=f"{construct_ms:.2f}",
            rebuild_ms=f"{rebuild_ms:.2f}",
            start_to_recovered_ms=f"{(t3 - t2) * 1e3:.2f}",
            start_to_first_commit_ms=f"{(t4 - t2) * 1e3:.2f}",
            to_recovered_ms=f"{construct_ms + rebuild_ms + (t3 - t2) * 1e3:.2f}",
            to_first_commit_ms=f"{construct_ms + rebuild_ms + (t4 - t2) * 1e3:.2f}",
            check_ms=f"{(t2 - t1) * 1e3 - rebuild_ms:.2f}",
            read_back_rows=len(got), read_back_s=f"{t5 - t4:.2f}",
            read_back_equal=True, windows_entries_equal=True,
            disk_bytes=dir_bytes(datadir), window_device_bytes=wbytes,
            memory_allocated_delta=mem_windows,
            probe_storage=tap.launches["storage"] - launches0["storage"],
            probe_resolver=tap.launches["resolver"] - launches0["resolver"])
        if card and tap.launches["storage"] == launches0["storage"]:
            fail(f"durable {leg}: the probe never launched on the restored "
                 "windows")

    dirs = []
    try:
        with ProbeTap() as tap:
            for engine in ("memory", "ssd"):
                d = tempfile.mkdtemp(prefix=f"fdbtpu_durable_{engine}_")
                dirs.append(d)
                writes = []
                load_s, rw_s, n = load_and_write(d, engine, target, writes,
                                                 stop=True)
                log("durable-load", smi=json.dumps(smi), engine=engine,
                    keys=len(keys), load_s=f"{load_s:.2f}",
                    keys_per_wall_s=f"{len(keys) / load_s:.1f}",
                    committed=n, rw_s=f"{rw_s:.2f}",
                    committed_per_wall_s=f"{n / rw_s:.1f}",
                    disk_bytes=dir_bytes(d))
                if engine == "memory":
                    cold_boot(d, engine, writes, tap, "clean")
                _, rw_s, n = load_and_write(d, engine, crash_target, writes,
                                            stop=False)
                gc.collect()
                log("durable-crash", smi=json.dumps(smi), engine=engine,
                    committed=n, rw_s=f"{rw_s:.2f}", disk_bytes=dir_bytes(d),
                    abandoned=True)
                cold_boot(d, engine, writes, tap,
                          "crash" if engine == "memory" else "ssd-crash")
            paths = tap.paths(**{"durable-resolver": "resolver",
                                 "durable-storage": "storage"})
            tap.to_host()
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    live = sum(r() is not None for r in refs)
    if live:
        fail(f"durable: {live} windows of ended incarnations outlived them")
    for path, cap in paths.items():
        cap["launches"] = boot_launches[path.split("-")[1]]
        if card and cap["launches"] <= 0:
            fail(f"durable: the probe never launched on the {path} path of "
                 "the cold boots")
        for k, t in cap.items():
            if isinstance(t, torch.Tensor):
                cap[k] = t.to(dev)
    log("durable", smi=json.dumps(smi), load_keys=load_keys,
        key_space=key_space, windows_collected=len(refs),
        memory_allocated=torch.cuda.memory_allocated(dev) if card else 0,
        phase_s=f"{time.perf_counter() - t_phase:.2f}")
    return paths


# ---------------------------------------------------------------- phase 13

# [sim]: seeds rerun on the card for the determinism check (each draws the
# device backends: the recoverable tier with and without a machine
# topology, Attrition and MachineAttrition, and the sharded tier), the
# wall-clock limit of one seed's run, and the band device memory must stay
# in after each seed.
SIM_DETERMINISM_SEEDS = (17, 38, 46, 71)
SIM_WALL_LIMIT = 120.0
SIM_MEM_BAND = 1 << 20


class RecruitTap:
    """Counts the ConflictSetGPU and KeyValueStoreGPU built while the block
    is open (each backend recruited by a seed's clusters: per resolver per
    generation, per storage server, per re-home) and keeps a weak
    reference to each, so a seed's device objects can be shown collected
    once it ends."""

    def __init__(self):
        self.built = {"ConflictSetGPU": 0, "KeyValueStoreGPU": 0}
        self.refs = []

    def _counting(self, cls):
        real = cls.__init__

        def init(obj, *a, **kw):
            real(obj, *a, **kw)
            self.built[cls.__name__] += 1
            self.refs.append(weakref.ref(obj))

        return real, init

    def __enter__(self) -> "RecruitTap":
        from foundationdb_tpu_torch.resolver.gpu import ConflictSetGPU
        from foundationdb_tpu_torch.storage_engine.gpu_engine import (
            KeyValueStoreGPU,
        )

        self._classes = (ConflictSetGPU, KeyValueStoreGPU)
        self._real = []
        for cls in self._classes:
            real, init = self._counting(cls)
            self._real.append(real)
            cls.__init__ = init
        return self

    def __exit__(self, *exc) -> None:
        for cls, real in zip(self._classes, self._real):
            cls.__init__ = real

    def live(self) -> int:
        return sum(r() is not None for r in self.refs)


def phase_sim(rng, smi: str = "", device=None, seeds=SIM_SEEDS,
              det_seeds=SIM_DETERMINISM_SEEDS,
              limit: float = SIM_WALL_LIMIT, extras=None,
              name: str = "sim"):
    """The deterministic simulator on the card: every seed of `seeds`
    through sim/config.run_randomized(device=device), as drawn (cluster
    shape, knobs, workload mix, buggify) — ConflictSetGPU and
    KeyValueStoreGPU recruited through CONFLICT_SET_IMPL and
    STORAGE_ENGINE_IMPL wherever the seed draws them or leaves them at
    their "gpu" default — each under a wall-clock limit. A CPU worker
    process (sim/sweep.CpuReplays) replays every seed with the host
    backends pinned while the card runs: ok, the error, the SevError
    count, every workload's check result and metrics and the fingerprint
    must be equal. Then `det_seeds` rerun on the card (the fingerprint and
    the coverage signature must repeat), one seed runs under the profiler
    (device busy against its wall), and each spec of `extras` ({name:
    spec}; by default specs/chaos_topology.json at seed 7, MachineAttrition
    over 3 x 2 machines, with both device backends forced) runs against
    its own CPU replay. `name` prefixes the phase's lines and its probe
    paths. After each seed its device
    objects must be collected and device memory back in a band of
    SIM_MEM_BAND above the phase's start (the probe tap's operands are
    moved to the host before each reading).
    Returns the probe's paths for probe_entries: its launches over the
    sweep and its last operands in the sweep (taken before the reruns and
    the chaos spec)."""
    import torch
    from foundationdb_tpu_torch.sim.config import (
        coverage_signature,
        generate_config,
        run_randomized,
    )
    from foundationdb_tpu_torch.sim.sweep import (
        CpuReplays,
        determinism_mismatch,
        mismatches,
        outcome,
        pin_knobs,
        run_seed,
        seed_passed,
    )

    t_phase = time.perf_counter()
    default_knobs()
    dev = torch.device("cuda" if device is None else device)
    card = dev.type == "cuda"
    specs = {seed: generate_config(seed) for seed in seeds}
    if extras is None:
        with open(Path(__file__).resolve().parent / "specs"
                  / "chaos_topology.json") as f:
            chaos = json.load(f)
        extras = {"chaos": pin_knobs(dict(chaos, seed=7), {
            "server:CONFLICT_SET_IMPL": "gpu",
            "server:STORAGE_ENGINE_IMPL": "gpu"})}
    replays = CpuReplays(limit)
    for seed in seeds:
        replays.send(seed, specs[seed])
    for key, spec in extras.items():
        replays.send(key, spec)

    def memory() -> int:
        gc.collect()
        return torch.cuda.memory_allocated(dev) if card else 0

    mem0 = memory()
    results, mems, walls, cpu_walls = {}, [], [], []

    runs = []   # (name, the card's outcome and wall, its counts)

    def settle(run, res, tap, rec, seen) -> None:
        """The card-side checks after one run: it passed, its device
        objects are collected and memory is back in the band. Its outcome
        is held against its CPU replay by compare(), once the phase's card
        work is done (the worker is never waited on in between)."""
        tap.to_host()
        mem = memory()
        mems.append(mem)
        counts = [rec.built["ConflictSetGPU"], rec.built["KeyValueStoreGPU"],
                  tap.launches["resolver"], tap.launches["storage"]]
        live = rec.live()
        runs.append((run, outcome(res), res["wall_s"], mem, live,
                     [c - s0 for c, s0 in zip(counts, seen)]))
        seen[:] = counts
        if run in specs:
            walls.append(res["wall_s"])
        if not seed_passed(res):
            fail(f"{name}: seed {run} failed on the card: "
                 f"{res.get('error') or res.get('sev_error_events')}")
        if live:
            fail(f"{name}: {live} device objects outlived seed {run}")
        if card and mem > mem0 + SIM_MEM_BAND:
            fail(f"{name}: device memory {mem} after seed {run}, over "
                 f"{mem0} + {SIM_MEM_BAND}")

    def compare() -> None:
        """Each card run against its CPU replay: ok, the error, the
        SevError count, every workload's check and metrics, and the
        fingerprint equal."""
        for run, out, wall, mem, live, counts in runs:
            cpu, cpu_wall = replays.result(run, timeout=4 * limit)
            bad = mismatches(out, cpu)
            spec = specs[run] if run in specs else extras[run]
            knobs = spec.get("knobs", {})
            cluster = spec["cluster"]
            log(f"{name}-seed", seed=run, kind=cluster["kind"],
                engine=cluster.get("engine"),
                regions=bool(cluster.get("regions")),
                conflict_set=knobs.get("server:CONFLICT_SET_IMPL", "gpu"),
                storage=knobs.get("server:STORAGE_ENGINE_IMPL", "gpu"),
                ok=out["ok"], sev_errors=out["sev_errors"],
                fingerprint=str(out["fingerprint"])[:16],
                conflict_sets_gpu=counts[0], windows_gpu=counts[1],
                probe_resolver=counts[2], probe_storage=counts[3],
                memory_allocated=mem, live_device_objects=live,
                wall_s=f"{wall:.2f}", cpu_wall_s=f"{cpu_wall:.2f}",
                equal_to_cpu=not bad)
            if run in specs:
                cpu_walls.append(cpu_wall)
            if bad:
                fail(f"{name}: seed {run} on the card differs from its CPU "
                     f"replay in {bad}")

    try:
        with ProbeTap() as tap, RecruitTap() as rec:
            seen = [0, 0, 0, 0]

            def on_result(seed, spec, res):
                results[seed] = res
                settle(seed, res, tap, rec, seen)

            t0 = time.perf_counter()
            run_randomized(seeds, log=lambda m: None, device=device,
                           limit=limit, on_result=on_result)
            sweep_s = time.perf_counter() - t0
            launches = dict(tap.launches)
            built = dict(rec.built)
            # the last operands of the sweep, on the host since its last
            # seed's reading
            paths = tap.paths(**{f"{name}-resolver": "resolver",
                                 f"{name}-storage": "storage"})
            t0 = time.perf_counter()
            for seed in det_seeds:
                again = run_seed(specs[seed], device=device, limit=limit)
                why = (determinism_mismatch(specs[seed], results[seed], again)
                       if seed_passed(again) else "the rerun failed")
                log(f"{name}-determinism", seed=seed,
                    fingerprint=str(again.get("fingerprint"))[:16],
                    coverage_signature=coverage_signature(specs[seed], again),
                    equal=why is None, wall_s=f"{again['wall_s']:.2f}")
                if why:
                    fail(f"{name}: seed {seed} on the card: {why}")
                del again
            det_s = time.perf_counter() - t0
            for key, spec in extras.items():
                seen[:] = [rec.built["ConflictSetGPU"],
                           rec.built["KeyValueStoreGPU"],
                           tap.launches["resolver"], tap.launches["storage"]]
                res = run_seed(spec, device=device, limit=limit)
                settle(key, res, tap, rec, seen)
                del res
        compare()
        sweep_cpu_s = sum(cpu_walls)
    except AssertionError as e:
        fail(f"{name}: {e}")
    finally:
        replays.close()
    if card:
        for path in ("resolver", "storage"):
            if launches[path] == 0:
                fail(f"{name}: the probe never launched on the {path} path "
                     "over the sweep")
    # One seed under the profiler: the device's busy time against the
    # seed's wall (the simulator drives the card from one host thread).
    prof_seed = det_seeds[0]
    busy = None
    t0 = time.perf_counter()
    if card:
        busy = profile_batch(
            lambda: run_seed(specs[prof_seed], device=device, limit=limit),
            batch_ms=1e3 * walls[seeds.index(prof_seed)],
            phase=f"{name}-profile", smi=smi, host_ops=False)
    RATES[name] = 60 * len(seeds) / sweep_s
    log(name, smi=json.dumps(smi), seeds=len(seeds), specs=len(extras),
        seeds_per_min=f"{60 * len(seeds) / sweep_s:.3f}",
        cpu_seeds_per_min=f"{60 * len(seeds) / sweep_cpu_s:.3f}",
        sweep_s=f"{sweep_s:.2f}", cpu_replay_s=f"{sweep_cpu_s:.2f}",
        conflict_sets_gpu=built["ConflictSetGPU"],
        windows_gpu=built["KeyValueStoreGPU"],
        probe_resolver=launches["resolver"],
        probe_storage=launches["storage"],
        determinism_reruns=len(det_seeds), memory_start=mem0,
        memory_max=max(mems), memory_min=min(mems),
        memory_band=SIM_MEM_BAND,
        profiled_seed=prof_seed,
        device_busy_ms=f"{busy[0]:.3f}" if busy else "not measured",
        determinism_s=f"{det_s:.2f}",
        profile_s=f"{time.perf_counter() - t0:.2f}",
        phase_s=f"{time.perf_counter() - t_phase:.2f}")
    for cap in paths.values():
        for k, t in cap.items():
            if isinstance(t, torch.Tensor):
                cap[k] = t.to(dev)
    return paths


# ---------------------------------------------------------------- phase 15

# [sim-durable]: the seeds rerun on the card for the determinism check
# (regions, and the ssd engine on the recoverable tier); the first is also
# profiled.
SIM_DURABLE_DETERMINISM_SEEDS = (58, 6)


def restart_specs() -> dict:
    """[sim-durable]'s restart specs: the two checked in
    (specs/restart_cycle.json on the ssd engine, specs/upgrade_cycle.json
    on the memory engine from durable format 2 to 3) and a power-loss
    restart on the memory engine over the simulated disk (the first
    incarnation ends by power loss, seeded spec.seed * 7919 + 13)."""
    root = Path(__file__).resolve().parent / "specs"
    out = {}
    for name in ("restart_cycle", "upgrade_cycle"):
        with open(root / f"{name}.json") as f:
            out[name] = json.load(f)
    cycle = {"name": "Cycle", "nodes": 8, "clients": 2, "txns": 8}
    out["power_loss"] = {
        "seed": 31, "buggify": True,
        "cluster": {"kind": "restart", "n_storage": 4, "n_logs": 2,
                    "replication": "double", "engine": "memory"},
        "datadir": "ndsim",
        "phases": [{"workloads": [cycle], "power_loss": True},
                   {"workloads": [cycle]}],
    }
    return out


def phase_sim_durable(rng, smi: str = "", device=None,
                      seeds=SIM_DURABLE_SEEDS,
                      det_seeds=SIM_DURABLE_DETERMINISM_SEEDS,
                      limit: float = SIM_WALL_LIMIT):
    """The simulator's durable tier on the card, as [sim] runs: every seed
    of SIM_DURABLE_SEEDS (the memory and ssd engines on a temporary
    datadir each, regions, the sharded and recoverable_sharded kinds) and
    the restart specs of restart_specs(), each against its CPU replay on
    the host backends (ok, checks, metrics, each phase's, fingerprint),
    device objects collected and device memory back in the band after
    each, `det_seeds` rerun. Returns the probe's paths."""
    return phase_sim(rng, smi, device, seeds=seeds, det_seeds=det_seeds,
                     limit=limit, extras=restart_specs(),
                     name="sim-durable")


# ---------------------------------------------------------------- phase 16

# [multiprocess]: the leg sizes. Leg A loads 2^18 of config 1's keys (as
# [cluster]) in 1,000-key transactions, MP_LOADERS at a time, and runs
# config 1's traffic from 256 clients to 2,000 acknowledged commits; each
# leg-B run kills its class at MP_KILL_AT of MP_KILL_TARGET commits. The
# load runs 4 transactions at a time: a batch of more makes the
# controller's 0.6 s health probe (cluster/recovery.py) time out and
# recover, and each recovery holds the load's in-flight commits for
# COMMIT_TIMEOUT (20 s); multiprocess_load_bench.py measures the load by
# concurrency (its times on an H100 are in PERF.md).
MP_LOAD_KEYS = 1 << 18
MP_LOADERS = 4
MP_CLIENTS = 256
MP_TARGET = 2000
MP_KILL_TARGET = 500
MP_KILL_AT = 150
MP_C_LOAD_KEYS = 1 << 16
MP_C_TARGET = 500
MP_D_LOAD_KEYS = 1 << 14
MP_D_TARGET = 300
MP_C_CLIENT_SETS = 50
MP_BOOT_S = 300.0
MP_CLASSES = ("log0", "log1", "storage", "resolver", "txn")


def mp_spec(key_space: int, ports: dict) -> dict:
    """BASELINE config 4's cluster shape deployed as FoundationDB documents
    a production cluster, `configure double ssd` (redundancy and storage
    engine, documentation/sphinx/source/configuration.rst): 4 storage
    servers in double replication on the ssd engine, 2 logs on 2 log hosts
    with double log replication, 4 resolvers; storage shards and resolvers
    split at rw_key of key_space/4, /2 and 3/4."""
    bounds = [rw_key(key_space * q // 4).decode() for q in (1, 2, 3)]
    return {"n_storage": 4, "replication": "double", "engine": "ssd",
            "n_logs": 2, "n_log_hosts": 2, "log_replication": "double",
            "n_resolvers": 4, "shard_boundaries": bounds,
            "resolver_boundaries": bounds, "seed": 1, "ports": ports}


def mp_free_ports(n: int) -> list:
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


class RoleHosts:
    """The role hosts of one deployment as OS processes: `python -m
    foundationdb_tpu_torch.server -r fdbd -c <class> --device <dev>`, each
    in a session of its own (its process group is its machine: a kill
    takes the group), its output in <root>/<class>.log."""

    def __init__(self, root: Path, spec: dict, device):
        from foundationdb_tpu_torch.cluster.multiprocess import (
            write_cluster_file,
        )

        self.root = root
        self.cf = str(root / "cluster.json")
        self.device = "cuda" if device is None else str(device)
        self.procs: dict = {}
        write_cluster_file(self.cf, {"spec": spec})

    def start(self, cls: str):
        with open(self.root / f"{cls}.log", "ab") as out:
            self.procs[cls] = subprocess.Popen(
                [sys.executable, "-m", "foundationdb_tpu_torch.server",
                 "-r", "fdbd", "-c", cls, "-C", self.cf,
                 "-d", str(self.root / "data" / cls),
                 "--device", self.device],
                cwd=str(Path(__file__).resolve().parent), stdout=out,
                stderr=subprocess.STDOUT, start_new_session=True)
        return self.procs[cls]

    def tail(self, cls: str) -> str:
        return (self.root / f"{cls}.log").read_text(errors="replace")[-3000:]

    def info(self) -> dict:
        from foundationdb_tpu_torch.cluster.multiprocess import (
            read_cluster_file,
        )

        return read_cluster_file(self.cf) or {}

    def wait_for(self, keys, timeout_s: float = MP_BOOT_S) -> dict:
        """The cluster file once every key in `keys` is there; fails if a
        host exits first or the deadline passes."""
        deadline = time.perf_counter() + timeout_s
        while True:
            info = self.info()
            if all(k in info for k in keys):
                return info
            for cls, p in self.procs.items():
                if p.poll() is not None:
                    fail(f"multiprocess: the {cls} host exited "
                         f"rc={p.returncode}:\n{self.tail(cls)}")
            if time.perf_counter() > deadline:
                fail(f"multiprocess: {sorted(set(keys) - set(info))} not "
                     f"up after {timeout_s:.0f} s")
            time.sleep(0.1)

    def kill(self, cls: str) -> None:
        """SIGKILL of the class's process group: the machine dies."""
        import signal

        p = self.procs[cls]
        os.killpg(p.pid, signal.SIGKILL)
        p.wait(timeout=60)

    def stop(self) -> None:
        import signal

        for p in self.procs.values():
            try:
                os.killpg(p.pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
        for p in self.procs.values():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait(timeout=30)


def device_used_mib() -> float:
    """The card's memory in use, MiB, over every process (nvidia-smi
    --query-gpu=memory.used); 0 where there is no card."""
    import shutil

    if shutil.which("nvidia-smi") is None:
        return 0.0
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60).stdout.split()
    return float(out[0]) if out else 0.0


def await_device_freed(before: float, least_mib: float,
                       timeout_s: float = 10.0) -> float:
    """The card's memory in use once it is `least_mib` below `before`
    (a killed process's context released), or at the deadline."""
    deadline = time.perf_counter() + timeout_s
    while True:
        now = device_used_mib()
        if before - now >= least_mib or time.perf_counter() > deadline:
            return now
        time.sleep(0.05)


async def mp_rpc(transport, addr: str, token: int, req,
                 timeout_s: float = 30.0):
    """One request to a role host's well-known endpoint."""
    from foundationdb_tpu_torch.core.actors import timeout_error

    transport.remote_stream(addr, token).send(req)
    return await timeout_error(req.reply.future, timeout_s)


async def mp_metric(transport, addrs: dict, name: str) -> dict:
    """{class: [(labels, value)]} of the metric `name` in each host's
    MetricRegistry, scraped over WLTOKEN_METRICS."""
    from foundationdb_tpu_torch.cluster.multiprocess import (
        WLTOKEN_METRICS,
        MetricsRequest,
    )

    out = {}
    for cls, addr in addrs.items():
        rep = await mp_rpc(transport, addr, WLTOKEN_METRICS,
                           MetricsRequest(pattern=name))
        out[cls] = [(m["labels"], m["value"]) for m in rep["metrics"]
                    if m["name"] == name]
    return out


async def mp_device(transport, addrs: dict) -> dict:
    """{class: (CUDA contexts, caching-allocator bytes reserved)} of each
    host's process, from its device gauges."""
    ctx = await mp_metric(transport, addrs, "device.contexts_count")
    res = await mp_metric(transport, addrs, "device.memory_reserved_bytes")
    return {cls: (int(sum(v for _, v in ctx[cls])),
                  int(sum(v for _, v in res[cls]))) for cls in addrs}


async def mp_launches(transport, addrs: dict) -> dict:
    """The probe's launches in each host's process (its gauge
    probe.launches_total, the kernel wrapper's count)."""
    got = await mp_metric(transport, addrs, "probe.launches_total")
    return {cls: int(sum(v for _, v in vals)) for cls, vals in got.items()}


async def mp_traffic(db, key_space: int, clients: int, target: int,
                     writes: list, timing: dict, maybe: list, during=None):
    """Config 1's ReadWrite from `clients` clients until `target`
    acknowledged commits, acknowledged writes into `writes`; `during(rw)`
    runs beside it; a transaction that cannot reach a host is run again
    (counted in rw.connection_failures). Returns (workload, wall s)."""
    from foundationdb_tpu_torch.core.errors import ConnectionFailed
    from foundationdb_tpu_torch.core.runtime import current_loop, spawn

    rw = acked_read_write(writes, timing, maybe)(
        db, key_space=key_space, reads_per_txn=5, writes_per_txn=2)

    async def client():
        while rw.txns_done < target:
            try:
                await rw._one()
            except ConnectionFailed:
                # the client library does not retry a host it cannot
                # reach (a killed storage host): the application does
                rw.connection_failures += 1
                await current_loop().delay(0.05)

    t0 = time.perf_counter()
    rw.connection_failures = 0
    tasks = [spawn(client(), name=f"mp_client_{i}") for i in range(clients)]
    if during is not None:
        tasks.append(spawn(during(rw), name="mp_during"))
    for t in tasks:
        await t.done
    return rw, time.perf_counter() - t0


async def mp_read_back(db, want: dict, maybe: list, leg: str,
                       parts: int = 64) -> tuple:
    """Every key of `want` read over the wire in `parts` range reads
    (plus the C client's keys) and held against it; a key a
    commit_unknown_result attempt wrote may also hold that attempt's
    value. Returns (rows, seconds, keys a maybe-write touched)."""
    t0 = time.perf_counter()
    ks = sorted(want)
    step = max(1, len(ks) // parts)
    edges = sorted({b"" , *ks[step::step]}) + [b"\xff"]
    got = []
    for b, e in zip(edges, edges[1:]):
        async def body(tr, b=b, e=e):
            return await tr.get_range(b, e)

        got += await db.transact(body)
    secs = time.perf_counter() - t0
    alt: dict = {}
    for k, v in maybe:
        alt.setdefault(k, set()).add(v)
    have = dict(got)
    bad = [k for k in set(have) | set(want)
           if have.get(k) != want.get(k)
           and not (k in alt and have.get(k) in alt[k])]
    if bad:
        k = sorted(bad)[0]
        fail(f"multiprocess {leg}: {len(bad)} keys differ from the "
             f"acknowledged writes ({len(got)} rows read, {len(want)} "
             f"wanted; first {k!r}: read {have.get(k)!r}, acked "
             f"{want.get(k)!r})")
    return len(got), secs, len(set(alt) & set(have))


def phase_multiprocess(rng, smi: str = "", device=None,
                       key_space: int = 1 << 20,
                       load_keys: int = MP_LOAD_KEYS,
                       loaders: int = MP_LOADERS,
                       clients: int = MP_CLIENTS, target: int = MP_TARGET,
                       kill_target: int = MP_KILL_TARGET,
                       kill_at: int = MP_KILL_AT,
                       c_load_keys: int = MP_C_LOAD_KEYS,
                       c_target: int = MP_C_TARGET,
                       d_load_keys: int = MP_D_LOAD_KEYS,
                       d_target: int = MP_D_TARGET):
    """The deployed multi-process tier (cluster/multiprocess.py over
    net/): mp_spec's deployment, every role host a CUDA context of its own
    on the card, the smoke the client over multiprocess.connect on a
    real-clock loop of its own. Datadirs under a temporary directory,
    removed at the end; every host process stopped.

    - leg A: log0, log1, storage, resolver and txn as OS processes.
      `load_keys` of config 1's keys loaded in 1,000-key transactions,
      ReadWrite from `clients` clients to `target` acknowledged commits, a
      stale-snapshot pair (the second must conflict), then the C wire
      client against the txn host (MP_C_CLIENT_SETS sets committed, then
      read back).
      Every loaded and acknowledged key read back over the wire against a
      VersionedMap of the acknowledged writes. Prints commits per wall
      second, client-side commit and GRV latency p50/p99, the proxy's
      stages (TxnStatusRequest), each remote resolver's pipeline
      (ResolverStatusRequest), and each process's device use from its
      gauges over the metrics plane: its CUDA context and caching-
      allocator bytes (the storage, resolver and txn processes hold
      some, the logs none) and its probe launches (probe.launches_total,
      before and after the traffic); and the card's memory in use before
      and after the hosts start (nvidia-smi inside a container does not
      map memory to processes).
    - leg B, the same cluster: ReadWrite to `kill_target` commits with the
      resolver host's process group SIGKILLed at `kill_at` and a fresh
      one started (ms from the kill to the first acknowledged commit of
      a transaction begun after it; the card's memory the kill returned);
      then again with the storage host killed and restarted on its
      datadir, its four windows cold-booted from the ssd engine onto the
      card (ms to its first served read, rows restored, compactions per
      window). Every acknowledged write read back after each.
    - leg C, a new cluster: log0, log1 and txn as OS processes, the
      storage and resolver hosts in this process on its loop and
      transport, registered and published as run_role_host does;
      `c_load_keys` loaded, `c_target` commits, read back. The launch tap
      captures the probe's last operands on both.
    - leg D, a new cluster with no resolver class (log0, log1, storage,
      txn): the txn host recruits its conflict set in its own process;
      `d_load_keys`, `d_target` commits, read back; the txn process's
      probe launches during the traffic must be positive.

    Returns the probe's paths (multiprocess-resolver, multiprocess-
    storage), with leg A's launches in the resolver and storage processes
    during the traffic."""
    import shutil
    import tempfile

    import torch
    from foundationdb_tpu_torch.cluster import multiprocess as mp
    from foundationdb_tpu_torch.core.errors import NotCommitted
    from foundationdb_tpu_torch.core.runtime import current_loop, loop_context
    from foundationdb_tpu_torch.net.transport import real_loop_with_transport
    from foundationdb_tpu_torch.storage_engine import _native

    t_phase = time.perf_counter()
    default_knobs()
    dev = torch.device("cuda" if device is None else device)
    card = dev.type == "cuda"
    keys = load_key_set(key_space, load_keys)
    tmp = Path(tempfile.mkdtemp(prefix="fdbtpu_multiprocess_"))
    hosts_all = []

    def new_hosts(name: str, classes, extra_ports=None) -> RoleHosts:
        root = tmp / name
        root.mkdir()
        ports = dict(zip(classes, mp_free_ports(len(classes))))
        ports.update(extra_ports or {})
        h = RoleHosts(root, mp_spec(key_space, ports), device)
        hosts_all.append(h)
        return h

    try:
        # ---------------------------------------------------- leg A
        hosts = new_hosts("a", MP_CLASSES)
        used0 = device_used_mib()
        t0 = time.perf_counter()
        for cls in MP_CLASSES:
            hosts.start(cls)
        info = hosts.wait_for(MP_CLASSES)
        boot_s = time.perf_counter() - t0
        used_up = device_used_mib()
        addrs = {c: info[c] for c in MP_CLASSES}
        writes, maybe = [], []
        timing = {"grv_ms": [], "commit_ms": [], "starts": [],
                  "acks": []}
        loop, transport = real_loop_with_transport()
        with loop_context(loop):
            db = mp.connect(transport, hosts.cf)

            async def leg_a():
                t0 = time.perf_counter()
                await load_through_client(db, keys, loaders)
                load_s = time.perf_counter() - t0
                l0 = await mp_launches(transport, addrs)
                rw, rw_s = await mp_traffic(db, key_space, clients, target,
                                            writes, timing, maybe)
                l1 = await mp_launches(transport, addrs)
                k = rw_key(key_space // 2 + 1)
                tr1, tr2 = db.create_transaction(), db.create_transaction()
                await tr1.get(k)
                await tr2.get(k)
                tr1.set(k, b"stale/1")
                v = await tr1.commit()
                writes.append((v, len(writes), k, b"stale/1"))
                tr2.set(k, b"stale/2")
                try:
                    await tr2.commit()
                    fail("multiprocess: a stale-snapshot commit committed")
                except NotCommitted:
                    pass
                pipes = [
                    (await mp_rpc(transport, addrs["resolver"],
                                  mp.WLTOKEN_RESOLVER_BASE,
                                  mp.ResolverStatusRequest(i)))[2]
                    for i in range(4)
                ]
                st = await mp_rpc(transport, addrs["txn"],
                                  mp.WLTOKEN_TXN_STATUS,
                                  mp.TxnStatusRequest())
                devs = await mp_device(transport, addrs)
                health = {}
                for c, a in addrs.items():
                    evs = (await mp_rpc(transport, a, mp.WLTOKEN_TRACE,
                                        mp.TraceEventsRequest(
                                            min_severity=30)))["events"]
                    health[c] = {
                        "sev40": sum(e.get("Severity", 0) >= 40
                                     for e in evs),
                        "slow_tasks": sum(e["Type"] == "SlowTask"
                                          for e in evs),
                        "sev30": len(evs)}
                return load_s, rw, rw_s, l0, l1, pipes, st, devs, health

            load_s, rw, rw_s, l0, l1, pipes, st, devs, health = loop.run(
                leg_a(), timeout_sim_seconds=1800)
            # The C wire client: no Python on its side of the socket.
            lib = _native.load_c_client()
            host, port = addrs["txn"].rsplit(":", 1)
            h = lib.fdbc_connect(host.encode(), int(port))
            if not h:
                fail("multiprocess: the C client could not connect")
            import ctypes

            t_c = time.perf_counter()
            try:
                for i in range(MP_C_CLIENT_SETS):
                    ck, cval = b"cc/%03d" % i, b"c%d" % (i * 7)
                    rv = lib.fdbc_get_read_version(h)
                    lib.fdbc_tr_set(h, ck, len(ck), cval, len(cval))
                    cv = lib.fdbc_commit(h, rv, None, 0)
                    if rv < 0 or cv <= 0:
                        fail(f"multiprocess: C client commit {i}: rv {rv} "
                             f"cv {cv} error {lib.fdbc_last_error(h)}")
                    writes.append((cv, len(writes), ck, cval))
                rv = lib.fdbc_get_read_version(h)
                out, ln = ctypes.c_void_p(), ctypes.c_uint32()
                for i in range(MP_C_CLIENT_SETS):
                    ck = b"cc/%03d" % i
                    st_c = lib.fdbc_get(h, ck, len(ck), rv,
                                        ctypes.byref(out), ctypes.byref(ln))
                    if st_c != 1 or ctypes.string_at(out, ln.value) != \
                            b"c%d" % (i * 7):
                        fail(f"multiprocess: C client read {i}: {st_c}")
            finally:
                lib.fdbc_destroy(h)
            c_s = time.perf_counter() - t_c
            want = acked_state(keys, writes)
            n_rows, rb_s, n_maybe = loop.run(
                mp_read_back(db, want, maybe, "A"), timeout_sim_seconds=600)
        pids = {c: hosts.procs[c].pid for c in MP_CLASSES}
        launches = {c: l1[c] - l0[c] for c in MP_CLASSES}
        stages = (st.get("proxy") or {}).get("commit_pipeline", {})
        log("multiprocess-a", smi=json.dumps(smi), boot_s=f"{boot_s:.2f}",
            keys=len(keys), load_s=f"{load_s:.2f}",
            keys_per_wall_s=f"{len(keys) / load_s:.1f}",
            committed=rw.txns_done, retries=rw.retries, rw_s=f"{rw_s:.2f}",
            committed_per_wall_s=f"{rw.txns_done / rw_s:.1f}",
            commit_ms_p50=pct(timing["commit_ms"], 50),
            commit_ms_p99=pct(timing["commit_ms"], 99),
            grv_ms_p50=pct(timing["grv_ms"], 50),
            grv_ms_p99=pct(timing["grv_ms"], 99),
            c_client_sets=MP_C_CLIENT_SETS, c_client_s=f"{c_s:.2f}",
            read_back_rows=n_rows, read_back_s=f"{rb_s:.2f}",
            read_back_equal=True, maybe_committed_keys=n_maybe)
        # SIGPROF (the role hosts' sampling profiler, every 20 ms) inside
        # processes that hold a CUDA context: errors and slow tasks per
        # host, and interrupted system calls in their output
        interrupted = {
            c: (hosts.root / f"{c}.log").read_text(errors="replace").count(
                "Interrupted system call") for c in MP_CLASSES}
        log("multiprocess-a-health", smi=json.dumps(smi),
            trace=json.dumps(health), eintr=json.dumps(interrupted))
        log("multiprocess-a-proxy", smi=json.dumps(smi),
            stages=json.dumps(stages.get("stages")),
            max_in_flight=stages.get("max_in_flight_measured"))
        for i, pipe in enumerate(pipes):
            log("multiprocess-a-resolver", smi=json.dumps(smi), idx=i,
                stages=json.dumps(pipe.get("stages")),
                max_in_flight=pipe.get("max_in_flight_measured"))
        log("multiprocess-a-processes", smi=json.dumps(smi),
            pids=json.dumps(pids),
            cuda_contexts=json.dumps({c: d[0] for c, d in devs.items()}),
            reserved_mib=json.dumps({c: round(d[1] / 2**20, 3)
                                     for c, d in devs.items()}),
            hosts_device_mib=f"{used_up - used0:.0f}",
            device_used_mib=f"{used_up:.0f}",
            probe_launches=json.dumps(launches))
        if card:
            for c in ("storage", "resolver", "txn"):
                if devs[c][0] != 1 or devs[c][1] <= 0:
                    fail(f"multiprocess: the {c} process holds no device "
                         f"memory: {devs[c]}")
            for c in ("log0", "log1"):
                if devs[c] != (0, 0):
                    fail(f"multiprocess: the {c} process holds device "
                         f"memory: {devs[c]}")
            if used_up - used0 < 3 * 100:
                fail(f"multiprocess: the hosts hold {used_up - used0} MiB "
                     "of the card")
            for c in ("storage", "resolver"):
                if launches[c] <= 0:
                    fail(f"multiprocess: the probe never launched in the {c}"
                         " process during the traffic")

        # The operator shell attached to leg A's deployment (one-shot
        # verbs; the shell's process holds no device): status json from
        # the controller, then a get of a loaded key over the wire.
        t_att = time.perf_counter()
        st_att = json.loads(shell_once(hosts.cf, "status json"))
        att_status_s = time.perf_counter() - t_att
        k_att = keys[len(keys) // 3]
        got_att = shell_once(hosts.cf, f"get {k_att.decode()}").strip()
        want_att = f"`{k_att.decode()}' is `{want[k_att].decode()}'"
        recovery = st_att["cluster"]["recovery_state"]["name"]
        log("multiprocess-a-attach", smi=json.dumps(smi),
            recovery_state=recovery, status_s=f"{att_status_s:.2f}",
            get_s=f"{time.perf_counter() - t_att - att_status_s:.2f}",
            get_equal=got_att == want_att)
        if recovery != "fully_recovered" or got_att != want_att:
            fail(f"multiprocess: the attached shell read {recovery!r} and "
                 f"{got_att!r}, not fully_recovered and {want_att!r}")

        # ---------------------------------------------------- leg B
        def leg_b(kill_cls: str):
            stamps = {}
            timing_b = {"grv_ms": [], "commit_ms": [], "starts": [],
                  "acks": []}

            async def during(rw):
                while rw.txns_done < kill_at:
                    await current_loop().delay(0.01)
                stamps["used_before"] = device_used_mib()
                stamps["kill"] = time.perf_counter()
                stamps["kill_wall"] = time.time()
                hosts.kill(kill_cls)
                stamps["used_killed"] = (await_device_freed(
                    stamps["used_before"], 100.0) if card else 0.0)
                hosts.start(kill_cls)
                stamps["spawn"] = time.perf_counter()
                if kill_cls == "storage":
                    from foundationdb_tpu_torch.core.errors import (
                        ConnectionFailed,
                    )

                    while True:
                        try:
                            await db.get(keys[0])
                            break
                        except ConnectionFailed:
                            await current_loop().delay(0.01)
                    stamps["first_read"] = time.perf_counter()

            loop, transport = real_loop_with_transport()
            with loop_context(loop):
                db = mp.connect(transport, hosts.cf)
                n0 = len(writes)
                rw, rw_s = loop.run(mp_traffic(
                    db, key_space, clients, kill_target, writes, timing_b,
                    maybe, during), timeout_sim_seconds=1800)
                want = acked_state(keys, writes)
                n_rows, rb_s, n_maybe = loop.run(
                    mp_read_back(db, want, maybe, f"B-{kill_cls}"),
                    timeout_sim_seconds=600)
                extra = {}
                if kill_cls == "storage":
                    saddr = {"storage": addrs["storage"]}
                    restored = loop.run(mp_rpc(
                        transport, addrs["storage"], mp.WLTOKEN_TRACE,
                        mp.TraceEventsRequest(
                            event_type="StorageDurableRestored")),
                        timeout_sim_seconds=60)["events"]
                    comps = loop.run(mp_metric(
                        transport, saddr, "storage.gpu.compactions"),
                        timeout_sim_seconds=60)["storage"]
                    rows = {e["Tag"]: e["Rows"] for e in restored}
                    # the window's first compaction is its construction's
                    per_window = {lbl.get("tag"): int(v) - 1
                                  for lbl, v in comps}
                    extra = dict(
                        kill_to_first_read_ms=f"{(stamps['first_read'] - stamps['kill']) * 1e3:.2f}",
                        spawn_to_first_read_ms=f"{(stamps['first_read'] - stamps['spawn']) * 1e3:.2f}",
                        rows_restored=json.dumps(rows),
                        compactions_per_window=json.dumps(per_window))
                    if len(rows) != 4 or sum(rows.values()) == 0:
                        fail(f"multiprocess: storage restored {rows}")
                    if card and any(c < 1 for c in per_window.values()):
                        fail("multiprocess: a restored window never "
                             f"rebuilt: {per_window}")
                # the first commit of a transaction begun after the kill
                devs_b = loop.run(mp_device(transport, addrs),
                                  timeout_sim_seconds=60)
                # the txn host's first recovery completed after the kill
                # (trace times are wall-clock UNIX times on real loops)
                recovered = [e["Time"] for e in loop.run(mp_rpc(
                    transport, addrs["txn"], mp.WLTOKEN_TRACE,
                    mp.TraceEventsRequest(event_type="RecoveryComplete")),
                    timeout_sim_seconds=60)["events"]
                    if e["Time"] > stamps["kill_wall"]]
                acks = sorted(a for g, a in zip(timing_b["starts"],
                                                timing_b["acks"])
                              if g > stamps["kill"])
                if not acks:
                    fail(f"multiprocess: no commit after the {kill_cls} "
                         "kill")
            freed = stamps["used_before"] - stamps["used_killed"]
            log("multiprocess-b", smi=json.dumps(smi), killed=kill_cls,
                committed=rw.txns_done, retries=rw.retries,
                connection_failures=rw.connection_failures,
                rw_s=f"{rw_s:.2f}",
                kill_to_recovered_ms=(
                    f"{(min(recovered) - stamps['kill_wall']) * 1e3:.2f}"
                    if recovered else "none"),
                kill_to_next_commit_ms=f"{(acks[0] - stamps['kill']) * 1e3:.2f}",
                spawn_to_next_commit_ms=f"{(acks[0] - stamps['spawn']) * 1e3:.2f}",
                writes_acked=len(writes) - n0, read_back_rows=n_rows,
                read_back_s=f"{rb_s:.2f}", read_back_equal=True,
                maybe_committed_keys=n_maybe, **extra,
                device_used_before_kill_mib=f"{stamps['used_before']:.0f}",
                device_freed_by_kill_mib=f"{freed:.0f}",
                device_used_after_mib=f"{device_used_mib():.0f}",
                new_process=json.dumps(devs_b[kill_cls]))
            if card and freed < 100:
                fail(f"multiprocess: the {kill_cls} kill returned {freed} "
                     "MiB to the card")
            if card and (devs_b[kill_cls][0] != 1
                         or devs_b[kill_cls][1] <= 0):
                fail(f"multiprocess: the new {kill_cls} process holds no "
                     f"device memory: {devs_b[kill_cls]}")

        leg_b("resolver")
        leg_b("storage")
        hosts.stop()

        # ---------------------------------------------------- leg C
        loop, transport = real_loop_with_transport()
        port_c = int(transport.local_address.rsplit(":", 1)[1])
        hosts = new_hosts("c", ("log0", "log1", "txn"),
                          {"storage": port_c, "resolver": port_c})
        spec = hosts.info()["spec"]
        for cls in ("log0", "log1", "txn"):
            hosts.start(cls)
        info = hosts.wait_for(("log0", "log1"))
        c_keys = load_key_set(key_space, c_load_keys)
        writes_c, maybe_c = [], []
        timing_c = {"grv_ms": [], "commit_ms": [], "starts": [],
                  "acks": []}
        with loop_context(loop), ProbeTap() as tap:
            stopped = []
            storage = mp.StorageHost(
                transport, str(hosts.root / "data" / "storage"), spec,
                [info["log0"], info["log1"]], cluster_file=hosts.cf,
                device=device)
            resolver = mp.ResolverHost(transport, spec, device=device)
            regs = [mp.start_worker_registration(
                transport, hosts.cf, cls, cls, lambda: bool(stopped))
                for cls in ("storage", "resolver")]
            mp.write_cluster_file(hosts.cf, {
                "storage": transport.local_address,
                "resolver": transport.local_address})

            async def leg_c():
                deadline = time.perf_counter() + MP_BOOT_S
                while "txn" not in hosts.info():
                    if time.perf_counter() > deadline:
                        fail("multiprocess C: the txn host never recovered")
                    await current_loop().delay(0.1)
                db = mp.connect(transport, hosts.cf)
                await load_through_client(db, c_keys, loaders)
                rw, rw_s = await mp_traffic(db, key_space, clients,
                                            c_target, writes_c, timing_c,
                                            maybe_c)
                got = await mp_read_back(
                    db, acked_state(c_keys, writes_c), maybe_c, "C")
                return rw, rw_s, got

            rw, rw_s, (n_rows, rb_s, n_maybe) = loop.run(
                leg_c(), timeout_sim_seconds=1800)
            stopped.append(True)
            for r in regs:
                r.cancel()
            storage.stop()
            resolver.stop()
            paths = tap.paths(**{"multiprocess-resolver": "resolver",
                                 "multiprocess-storage": "storage"})
            tap.to_host()
            tap_launches = dict(tap.launches)
        transport.close()
        loop.shutdown()
        log("multiprocess-c", smi=json.dumps(smi), keys=len(c_keys),
            committed=rw.txns_done, rw_s=f"{rw_s:.2f}",
            committed_per_wall_s=f"{rw.txns_done / rw_s:.1f}",
            read_back_rows=n_rows, read_back_equal=True,
            maybe_committed_keys=n_maybe,
            probe_resolver=tap_launches["resolver"],
            probe_storage=tap_launches["storage"])
        if card and min(tap_launches.values()) <= 0:
            fail(f"multiprocess C: the probe launches {tap_launches}")
        hosts.stop()

        # ---------------------------------------------------- leg D
        classes_d = ("log0", "log1", "storage", "txn")
        hosts = new_hosts("d", classes_d)
        for cls in classes_d:
            hosts.start(cls)
        info = hosts.wait_for(classes_d)
        d_keys = load_key_set(key_space, d_load_keys)
        writes_d, maybe_d = [], []
        timing_d = {"grv_ms": [], "commit_ms": [], "starts": [],
                  "acks": []}
        addrs_d = {c: info[c] for c in classes_d}
        loop, transport = real_loop_with_transport()
        with loop_context(loop):
            db = mp.connect(transport, hosts.cf)

            async def leg_d():
                await load_through_client(db, d_keys, loaders)
                l0 = await mp_launches(transport, addrs_d)
                rw, rw_s = await mp_traffic(db, key_space, clients,
                                            d_target, writes_d, timing_d,
                                            maybe_d)
                l1 = await mp_launches(transport, addrs_d)
                got = await mp_read_back(
                    db, acked_state(d_keys, writes_d), maybe_d, "D")
                return rw, rw_s, l0, l1, got

            rw, rw_s, l0, l1, (n_rows, _, _) = loop.run(
                leg_d(), timeout_sim_seconds=1800)
        transport.close()
        loop.shutdown()
        launches_d = {c: l1[c] - l0[c] for c in classes_d}
        log("multiprocess-d", smi=json.dumps(smi),
            committed=rw.txns_done, rw_s=f"{rw_s:.2f}",
            committed_per_wall_s=f"{rw.txns_done / rw_s:.1f}",
            read_back_rows=n_rows, read_back_equal=True,
            probe_launches=json.dumps(launches_d))
        if card and launches_d["txn"] <= 0:
            fail("multiprocess D: the probe never launched in the txn "
                 "process's own conflict set")
        hosts.stop()
    finally:
        for h in hosts_all:
            h.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    for name, cls in (("multiprocess-resolver", "resolver"),
                      ("multiprocess-storage", "storage")):
        paths[name]["launches"] = launches[cls]
        for k, t in paths[name].items():
            if isinstance(t, torch.Tensor):
                paths[name][k] = t.to(dev)
    log("multiprocess", smi=json.dumps(smi), load_keys=load_keys,
        key_space=key_space, phase_s=f"{time.perf_counter() - t_phase:.2f}")
    return paths


# ---------------------------------------------------------------- phase 17

# [backup]: leg A's source is config 4's cluster after a 2^18-key load of
# config 1's keys (as [sharded-cluster]); legs B and C share one run of
# config 1's ReadWrite from 256 clients to 2,000 acknowledged commits on a
# second source of that shape loaded with 2^14 keys: their point-in-time
# restore and DR copy are two more whole-database restores, ~60 s each at
# 2^18 on an H100 80GB HBM3 at 700 W (PERF.md), while what they add to
# leg A's, the shipped log and its lag, does not grow with the load.
BACKUP_LOAD_KEYS = 1 << 18
BACKUP_STREAM_LOAD_KEYS = 1 << 14
BACKUP_CLIENTS = 256
BACKUP_TARGET = 2000
BACKUP_PAIR = (b"bk/a", b"bk/b")
BACKUP_MEM_BAND = 1 << 20
SHELL_KEY = b"bk_shell/a"


class ClusterTap(ProbeTap):
    """ProbeTap split by cluster: each watched cluster's resolver roles'
    conflict sets and storage servers' windows are wrapped so that a
    probe launched inside their submit, resolve or submit_reads counts
    against (cluster, path)."""

    ENTRY = ("submit", "resolve", "submit_reads")

    def __init__(self):
        self.launches, self.captured = {}, {}
        self.owner = None

    def _key(self, path: str):
        if self.owner is None:
            fail("backup: a probe launch outside every watched cluster")
        return self.owner

    def _owned(self, obj, key):
        tap = self

        class Owned:
            def __getattr__(self, name):
                attr = getattr(obj, name)
                if name not in ClusterTap.ENTRY:
                    return attr

                def call(*a, **kw):
                    prev, tap.owner = tap.owner, key
                    try:
                        return attr(*a, **kw)
                    finally:
                        tap.owner = prev

                return call

            def __len__(self):
                return len(obj)

        return Owned()

    def watch(self, cluster, name: str):
        """Wrap `cluster`'s conflict sets and windows (before start)."""
        for path in ("resolver", "storage"):
            self.launches[(name, path)] = 0
            self.captured[(name, path)] = {}
        for role in cluster.resolvers:
            role.cs = self._owned(role.cs, (name, "resolver"))
        for s in cluster.storages:
            s.data = self._owned(s.data, (name, "storage"))
        return cluster

    def paths(self) -> dict:
        return {f"backup-{n}-{p}": dict(cap, launches=self.launches[(n, p)])
                for (n, p), cap in self.captured.items()}


async def read_rows(db, chunk: int = 10_000) -> dict:
    """Every row of the normal keyspace, in `chunk`-row transactions (the
    cluster is quiet while it reads)."""
    from foundationdb_tpu_torch.kv.keys import key_after

    out, cursor = {}, b""
    while True:
        async def body(tr, cursor=cursor):
            return await tr.get_range(cursor, b"\xff", limit=chunk)

        rows = await db.transact(body)
        out.update(rows)
        if len(rows) < chunk:
            return out
        cursor = key_after(rows[-1][0])


def diff_rows(got: dict, want: dict) -> str:
    missing = [k for k in want if k not in got][:3]
    extra = [k for k in got if k not in want][:3]
    wrong = [k for k in want if k in got and got[k] != want[k]][:3]
    return (f"{len(got)} rows, {len(want)} wanted; missing {missing}, "
            f"extra {extra}, different {wrong}")


def run_shell(script: list, device=None, timeout: float = 300):
    """`server.py -r cli` as an operator runs it, the script piped in:
    (each reply, seconds from the start to the first reply). Its output
    is drained on threads, so a shell that hangs or fills its stderr
    fails here after `timeout` s with what it printed."""
    import threading

    cmd = [sys.executable, "-m", "foundationdb_tpu_torch.server", "-r",
           "cli"]
    if device is not None:
        cmd += ["--device", str(device)]
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent,
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    out, err, first = [], [], []

    def drain(stream, lines, replies):
        for line in stream:
            if replies and not first and "fdbtpu> " in line \
                    and line.split("fdbtpu> ")[-1].strip():
                first.append(time.perf_counter() - t0)
            lines.append(line)

    readers = [threading.Thread(target=drain, args=(p.stdout, out, True),
                                daemon=True),
               threading.Thread(target=drain, args=(p.stderr, err, False),
                                daemon=True)]
    for r in readers:
        r.start()
    rc = None
    try:
        p.stdin.write("".join(line + "\n" for line in script))
        p.stdin.close()
        rc = p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        if p.poll() is None:
            os.killpg(p.pid, 9)
            p.wait()
        for r in readers:
            r.join(timeout=10)
    tail = "".join(out)[-2000:] + "".join(err)[-2000:]
    if rc is None:
        fail(f"shell: still running after {timeout} s: {tail}")
    if rc != 0:
        fail(f"shell: exit {rc}: {tail}")
    if not first:
        fail(f"shell: no reply: {tail}")
    return "".join(out).split("fdbtpu> ")[1:], first[0]


def shell_once(cluster_file: str, command: str,
               timeout: float = 120) -> str:
    """One verb of `server.py -r cli` attached to a deployment through its
    cluster file; its standard output."""
    p = subprocess.run(
        [sys.executable, "-m", "foundationdb_tpu_torch.server", "-r", "cli",
         "-C", str(cluster_file), *command.split()],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=timeout)
    if p.returncode != 0:
        fail(f"shell: `{command}' exited {p.returncode}: {p.stderr[-2000:]}")
    return p.stdout


def check_shell(device, tmp: Path) -> dict:
    """[backup] leg D: the operator shell on the card, the backup verbs
    of fdbbackup and fdbrestore among its data verbs."""
    url = f"file://{tmp}/shell"
    k = SHELL_KEY.decode()
    script = ["writemode on", f"set {k} 1", f"get {k}",
              "getrange bk_shell/ bk_shell0", "status json", f"backup {url}",
              f"backups {url}", f"clear {k}", f"get {k}", f"restore {url}",
              f"get {k}", "exit"]
    t0 = time.perf_counter()
    replies, first = run_shell(script, device)
    wall = time.perf_counter() - t0
    replies = [r.strip() for r in replies]
    if len(replies) < len(script) - 1:
        fail(f"shell: {len(replies)} replies to {len(script) - 1} commands:"
             f" {replies}")
    if not replies[5].startswith("backup complete at version "):
        fail(f"shell: backup replied {replies[5]!r}")
    version = replies[5].rsplit(" ", 1)[1]
    want = {0: "writemode on", 1: "Committed", 2: f"`{k}' is `1'",
            3: f"`{k}' is `1'", 6: version, 7: "Committed",
            8: f"`{k}': not found", 9: "restored 1 rows",
            10: f"`{k}' is `1'"}
    for i, w in want.items():
        if replies[i] != w:
            fail(f"shell: `{script[i]}' replied {replies[i]!r}, not {w!r}")
    status = json.loads(replies[4])
    if "workload" not in status.get("cluster", {}):
        fail(f"shell: status json has no cluster workload: {list(status)}")
    return {"first_reply_s": first, "wall_s": wall, "version": version,
            "replies": len(replies)}


def phase_backup(rng, smi: str = "", device=None, key_space: int = 1 << 20,
                 load_keys: int = BACKUP_LOAD_KEYS,
                 stream_keys: int = BACKUP_STREAM_LOAD_KEYS,
                 loaders: int = 32, clients: int = BACKUP_CLIENTS,
                 target: int = BACKUP_TARGET):
    """The backup tier on the card, the deployment of FoundationDB's
    documentation/sphinx/source/backups.rst (`fdbbackup start -d
    file://...`, `fdbrestore start`, a continuous backup, `fdbdr start`
    between two clusters). Every cluster here is config 4's
    (ShardedKVCluster, 4 storage, 2 logs, double replication, 4
    resolvers, split at rw_key of key_space/4, /2, 3/4), on `device`,
    under one sim_loop, each counted by ClusterTap. Leg A's source holds a
    `load_keys` load, legs B and C's ("stream") a `stream_keys` load.

    - leg A: backup_to_container(file://) while BackupRestoreWorkload's
      invariant pair is written, each acknowledged pair write recorded
      with its commit version; restore_from_container into a fresh
      cluster, whose rows must equal the loaded keys plus the pair writes
      at or below the snapshot version, the pair untorn.
    - legs B and C: ContinuousBackupAgent and DRAgent (into another
      cluster) started on the stream source, then config 1's ReadWrite from
      `clients` clients to `target` commits, each client recording
      (commit version, writes); wait_until at the end version and
      wait_drained; restore_to_version at the median acknowledged version
      into another cluster must equal the record replayed up to it, and
      the DR destination's rows the source's and the whole record.
    - leg D: `server.py -r cli` on `device` with a piped script of data,
      status and backup verbs; each reply checked.

    Device memory back in a band once the clusters are stopped. Returns
    the probe's paths per cluster."""
    import shutil
    import tempfile

    import torch
    from foundationdb_tpu_torch import backup as bk
    from foundationdb_tpu_torch.cluster.sharded_cluster import ShardedKVCluster
    from foundationdb_tpu_torch.core.runtime import (
        current_loop,
        loop_context,
        sim_loop,
        spawn,
    )
    from foundationdb_tpu_torch.dr import DRAgent

    t_phase = time.perf_counter()
    default_knobs()
    dev = torch.device("cuda" if device is None else device)
    card = dev.type == "cuda"
    bounds = [rw_key(key_space * i // 4) for i in (1, 2, 3)]
    tmp = Path(tempfile.mkdtemp(prefix="fdbtpu_backup_"))

    def memory() -> int:
        gc.collect()
        return torch.cuda.memory_allocated(dev) if card else 0

    mem0 = memory()
    keys = load_key_set(key_space, load_keys)
    keys_bc = load_key_set(key_space, stream_keys)
    # every acknowledged write, (commit version, order, key, value): the
    # pair writer's on leg A's source, config 1's on the stream source
    pair_writes, writes = [], []
    loop = sim_loop(seed=SEED + 17)
    stamps, out = {}, {}
    try:
        with ClusterTap() as tap:
            with loop_context(loop):
                def config4(name):
                    return tap.watch(ShardedKVCluster(
                        n_storage=4, n_logs=2, replication="double",
                        shard_boundaries=bounds, n_resolvers=4,
                        resolver_boundaries=bounds, device=device), name)

                src = config4("source").start()
                db = src.database()

                async def main():
                    mark = stamper(stamps)
                    mark("load")
                    await load_through_client(db, keys, loaders)
                    mark("loaded")
                    # ---- leg A: a snapshot under the invariant writer
                    pair, stop = [], [False]  # the pair's commit versions

                    async def writer():
                        n = 0
                        while not stop[0]:
                            n += 1
                            tr = db.create_transaction()
                            while True:
                                try:
                                    for k in BACKUP_PAIR:
                                        tr.set(k, b"%d" % n)
                                    v = await tr.commit()
                                    break
                                except BaseException as e:  # noqa: BLE001
                                    await tr.on_error(e)
                            pair.append(v)
                            pair_writes.extend(
                                (v, len(pair_writes), k, b"%d" % n)
                                for k in BACKUP_PAIR)

                    w = spawn(writer(), name="bkWriter")
                    # some pair writes land before the snapshot's version
                    # (each is a commit of the whole cluster's path, ~0.1 s
                    # of wall time on the card)
                    await current_loop().delay(0.02)
                    url_a = f"file://{tmp}/snapshots"
                    mark("snapshot")
                    snap_v = await bk.backup_to_container(db, url_a)
                    mark("snapshot_end")
                    stop[0] = True
                    await w.done
                    dst = config4("restore").start()
                    mark("restore")
                    n_rest = await bk.restore_from_container(
                        dst.database(), url_a)
                    mark("restore_end")
                    got = await read_rows(dst.database())
                    dst.stop()
                    src.stop()
                    out["a"] = (snap_v, n_rest, got,
                                acked_state(keys, pair_writes, snap_v),
                                len(pair), sum(v <= snap_v for v in pair))
                    # ---- legs B and C: continuous backup and DR
                    src_bc = config4("stream").start()
                    db_bc = src_bc.database()
                    mark("stream_load")
                    await load_through_client(db_bc, keys_bc, loaders)
                    mark("stream_loaded")
                    url_b = f"file://{tmp}/continuous"
                    agent = bk.ContinuousBackupAgent(src_bc, url_b)
                    mark("cont")
                    await agent.start()
                    mark("cont_end")
                    dr_dst = config4("dr").start()
                    dr = DRAgent(src_bc, dr_dst.database())
                    mark("dr")
                    await dr.start()
                    mark("dr_end")
                    rw = await read_write_until(
                        db_bc, key_space, clients, target,
                        cls=acked_read_write(writes))
                    mark("rw_end")
                    end_v = src_bc.master.get_live_committed_version()
                    lag = (end_v - agent.shipped_version,
                           end_v - dr.applied_version)
                    async def until(wait, name):
                        await wait
                        mark(name)

                    caught = [spawn(until(agent.wait_until(end_v),
                                          "shipped")),
                              spawn(until(dr.wait_drained(), "drained"))]
                    for t in caught:
                        await t.done
                    agent.stop()
                    versions = sorted(v for v, *_ in writes)
                    mid = versions[len(versions) // 2]
                    pitr = config4("pitr").start()
                    mark("pitr")
                    n_pitr = await bk.restore_to_version(
                        pitr.database(), url_b, mid)
                    mark("pitr_end")
                    got_b = await read_rows(pitr.database())
                    pitr.stop()
                    src_rows = await read_rows(db_bc)
                    dr_rows = await read_rows(dr_dst.database())
                    dr.stop()
                    dr_dst.stop()
                    src_bc.stop()
                    out["b"] = ((rw.txns_done, rw.retries), len(writes),
                                mid, n_pitr, got_b,
                                acked_state(keys_bc, writes, mid), lag,
                                agent.snapshot_version)
                    out["c"] = (src_rows, dr_rows,
                                acked_state(keys_bc, writes))

                loop.run(main(), timeout_sim_seconds=1e6)
            loop.shutdown()
            # the loop's metrics registry holds the windows' gauges
            del src, db, loop
            tap.to_host()
        mem1 = memory()
        shell_out = check_shell(device, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def wall(a, b):
        return stamps[b][0] - stamps[a][0]

    def sim(a, b):
        return stamps[b][1] - stamps[a][1]

    snap_v, n_rest, got, want, n_pair, n_below = out["a"]
    if got != want:
        fail(f"backup: the restored snapshot differs from the record: "
             f"{diff_rows(got, want)}")
    if got.get(BACKUP_PAIR[0]) != got.get(BACKUP_PAIR[1]):
        fail(f"backup: the restored pair is torn: "
             f"{[got.get(k) for k in BACKUP_PAIR]}")
    if not n_below or n_below == n_pair:
        fail(f"backup: {n_below} of {n_pair} pair writes at or below the "
             "snapshot: the snapshot did not run under the writer")
    n_bytes = sum(len(k) + len(v) for k, v in got.items())
    log("backup-a", smi=json.dumps(smi), rows=n_rest, bytes=n_bytes,
        snapshot_version=snap_v, pair_writes=n_pair,
        pair_writes_in_snapshot=n_below,
        snapshot_wall_s=f"{wall('snapshot', 'snapshot_end'):.2f}",
        snapshot_sim_s=f"{sim('snapshot', 'snapshot_end'):.4f}",
        restore_wall_s=f"{wall('restore', 'restore_end'):.2f}",
        restore_rows_per_wall_s=f"{n_rest / wall('restore', 'restore_end'):.1f}",
        load_wall_s=f"{wall('load', 'loaded'):.2f}",
        writer_before_snapshot_wall_s=f"{wall('loaded', 'snapshot'):.2f}",
        restored_equal=True, pair_untorn=True)
    (done, retries), n_writes, mid, n_pitr, got_b, want_b, lag, cont_v = \
        out["b"]
    if done < target:
        fail(f"backup: {done} config-1 transactions, {target} wanted")
    if got_b != want_b:
        fail(f"backup: restore_to_version({mid}) differs from the record: "
             f"{diff_rows(got_b, want_b)}")
    log("backup-b", smi=json.dumps(smi), load_keys=len(keys_bc),
        load_wall_s=f"{wall('stream_load', 'stream_loaded'):.2f}",
        committed=done, retries=retries, writes=n_writes,
        snapshot_version=cont_v, restore_version=mid,
        snapshot_wall_s=f"{wall('cont', 'cont_end'):.2f}",
        ship_lag_versions=lag[0],
        ship_lag_wall_ms=f"{1e3 * wall('rw_end', 'shipped'):.2f}",
        ship_lag_sim_ms=f"{1e3 * sim('rw_end', 'shipped'):.2f}",
        traffic_wall_s=f"{wall('dr_end', 'rw_end'):.2f}",
        committed_per_wall_s=f"{done / wall('dr_end', 'rw_end'):.1f}",
        restored_rows=n_pitr, restored_keys=len(got_b),
        restore_wall_s=f"{wall('pitr', 'pitr_end'):.2f}",
        restore_equal=True)
    src_rows, dr_rows, want_c = out["c"]
    if dr_rows != src_rows:
        fail(f"backup: the DR destination differs from the source: "
             f"{diff_rows(dr_rows, src_rows)}")
    if src_rows != want_c:
        fail(f"backup: the source differs from the record: "
             f"{diff_rows(src_rows, want_c)}")
    n_dr = len(keys_bc)
    log("backup-c", smi=json.dumps(smi), rows=len(dr_rows),
        snapshot_rows=n_dr, snapshot_wall_s=f"{wall('dr', 'dr_end'):.2f}",
        snapshot_rows_per_wall_s=f"{n_dr / wall('dr', 'dr_end'):.1f}",
        apply_lag_versions=lag[1],
        apply_lag_wall_ms=f"{1e3 * wall('rw_end', 'drained'):.2f}",
        apply_lag_sim_ms=f"{1e3 * sim('rw_end', 'drained'):.2f}",
        equal_to_source=True)
    log("backup-d", smi=json.dumps(smi),
        first_reply_s=f"{shell_out['first_reply_s']:.2f}",
        wall_s=f"{shell_out['wall_s']:.2f}",
        backup_version=shell_out["version"],
        replies=shell_out["replies"], replies_equal=True)
    paths = tap.paths()
    log("backup-launches", smi=json.dumps(smi),
        launches=json.dumps({p: c["launches"] for p, c in paths.items()}),
        memory_start=mem0, memory_end=mem1)
    if card:
        for p, c in paths.items():
            if c["launches"] <= 0:
                fail(f"backup: the probe never launched on {p}")
        if mem1 > mem0 + BACKUP_MEM_BAND:
            fail(f"backup: device memory {mem1} after the clusters "
                 f"stopped, over {mem0} + {BACKUP_MEM_BAND}")
    log("backup-phase", wall_s=f"{time.perf_counter() - t_phase:.2f}")
    for cap in paths.values():
        for k, t in cap.items():
            if isinstance(t, torch.Tensor):
                cap[k] = t.to(dev)
    return paths


# ---------------------------------------------------------------- phases 19-22

# [swarm]: the coverage-guided swarm's seeds on the card (sim/swarm.py,
# guided from an empty corpus, each seed run twice), the workers, and the
# regression-corpus entry replayed on the card.
SWARM_BUDGET = 4
SWARM_JOBS = 2
SWARM_SEED_BASE = 0
CORPUS_ENTRY = "specs/regressions/check_SyntheticFault_seed42.json"
RATES: dict = {}  # phase name -> seeds per wall minute (phase_sim)


def host_cpu() -> str:
    """The host's CPU from /proc/cpuinfo: its model name, vendor, family
    and model numbers and the count of logical CPUs this process sees."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                key, _, value = ln.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        return "not readable"
    return (f"{fields.get('model name', '?')} ({fields.get('vendor_id', '?')}"
            f" family {fields.get('cpu family', '?')} model "
            f"{fields.get('model', '?')}, {len(os.sched_getaffinity(0))} "
            "cpus)")


def wire_columns(wb, oldest: int) -> tuple:
    """A config-5 WireBatch as ConflictSetNativeCPU.resolve_columnar's
    arguments after the snapshots count: rows in txn order, a tooOld
    txn's ranges dropped (flatten_batch's admission rule). Its ranges are
    [k, k + b"\\x00"), never empty, so no row drops for emptiness."""
    if not ((wb.re_len == wb.rb_len + 1).all()
            and (wb.we_len == wb.wb_len + 1).all()):
        fail("native: the batch is not config 5's point ranges")
    n = wb.n_txns
    has_reads = wb.r_counts > 0
    too_old = has_reads & (wb.snaps < oldest)
    r_txn = np.repeat(np.arange(n, dtype=np.int32), wb.r_counts)
    w_txn = np.repeat(np.arange(n, dtype=np.int32), wb.w_counts)
    kr, kw = ~too_old[r_txn], ~too_old[w_txn]
    return (np.ascontiguousarray(wb.snaps, np.int64),
            has_reads.astype(np.uint8),
            np.ascontiguousarray(wb.blob, np.uint8),
            r_txn[kr], wb.rb_off[kr], wb.rb_len[kr], wb.re_off[kr],
            wb.re_len[kr],
            w_txn[kw], wb.wb_off[kw], wb.wb_len[kw], wb.we_off[kw],
            wb.we_len[kw])


def phase_native(full: dict, smi: str, card: str) -> None:
    """[native]: the C++ conflict detector (ConflictSetNativeCPU, the
    benchmark's CPU baseline) on [full]'s batches, at [full]'s versions
    and GC horizon: statuses equal to ConflictSetGPU's batch for batch,
    entries() equal after the last."""
    from foundationdb_tpu_torch.resolver.native_cpu import (
        ConflictSetNativeCPU,
    )

    cs = ConflictSetNativeCPU()
    lat = []
    n_txn = 0
    for i, (v, wb) in enumerate(zip(full["versions"], full["batches"])):
        t0 = time.perf_counter()
        cols = wire_columns(wb, cs.oldest_version)
        got = cs.resolve_columnar(v, max(0, v - full["window"]), wb.n_txns,
                                  *cols).statuses
        lat.append(time.perf_counter() - t0)
        n_txn += wb.n_txns
        if not np.array_equal(np.asarray(got, np.int64),
                              np.asarray(full["statuses"][i], np.int64)):
            fail(f"native: statuses differ from the card's at batch {i}")
    entries = cs.entries()
    if entries != full["entries"]:
        fail("native: entries() differ from the card's after the last batch")
    lat_ms = np.asarray(lat) * 1e3
    log("native", smi=json.dumps(smi), card=json.dumps(card),
        host_cpu=json.dumps(host_cpu()), batches=len(lat),
        txns_per_batch=full["batches"][0].n_txns,
        txns_per_s=f"{n_txn / sum(lat):.1f}",
        p50_batch_ms=f"{np.percentile(lat_ms, 50):.2f}",
        p90_batch_ms=f"{np.percentile(lat_ms, 90):.2f}",
        entries=len(entries), equal=True)


def phase_native_sort(full: dict, smi: str) -> None:
    """[native-sort]: the endpoint sort of [full]'s last batch packed
    whole (pack_batch_wire), once natively (fdbcs_encode_sort_order) and
    once by the numpy path (u64 pair keys and np.lexsort): the same
    permutation; both timed (median of 3)."""
    from foundationdb_tpu_torch.resolver import packing
    from foundationdb_tpu_torch.resolver.wire import pack_batch_wire

    got = {}
    real = packing._encode_sort_order

    def recording(words, lt, n):
        got.update(words=words.copy(), lt=lt.copy(), n=n)
        return real(words, lt, n)

    v, wb = full["versions"][-1], full["batches"][-1]
    packing._encode_sort_order = recording
    try:
        pack_batch_wire(wb, max(0, v - full["window"]), full["n_words"])
    finally:
        packing._encode_sort_order = real
    words, lt, n = got["words"], got["lt"], got["n"]

    def timed(fn):
        walls, out = [], None
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            walls.append(time.perf_counter() - t0)
        return out, 1e3 * float(np.median(walls))

    native_order, native_ms = timed(lambda: real(words, lt, n))
    saved = packing._NATIVE_SORT_MIN
    packing._NATIVE_SORT_MIN = 10**9
    try:
        numpy_order, numpy_ms = timed(lambda: real(words, lt, n))
    finally:
        packing._NATIVE_SORT_MIN = saved
    if n <= packing._NATIVE_SORT_MIN:
        fail(f"native-sort: {n} endpoints do not reach the native sort")
    if not np.array_equal(np.asarray(native_order), np.asarray(numpy_order)):
        fail("native-sort: the native permutation differs from np.lexsort's")
    log("native-sort", smi=json.dumps(smi), host_cpu=json.dumps(host_cpu()),
        endpoints=n, key_words=words.shape[1],
        native_ms=f"{native_ms:.2f}", lexsort_ms=f"{numpy_ms:.2f}",
        speedup=f"{numpy_ms / native_ms:.2f}", equal=True)


def wire_instance(cls):
    """A registered message with its declared defaults and, elsewhere,
    plausible wire-type values drawn from its name (None if the
    constructor refuses)."""
    import dataclasses
    import random
    import zlib

    rng = random.Random(zlib.crc32(cls.__name__.encode()))
    pool = [0, -1, 2**40, 1.5, b"key", b"", "s", None, True,
            [1, b"x"], (2, 3), {"a": 1}]
    try:
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.default is not dataclasses.MISSING:
                kwargs[f.name] = f.default
            elif f.default_factory is not dataclasses.MISSING:
                kwargs[f.name] = f.default_factory()
            else:
                kwargs[f.name] = rng.choice(pool)
        return cls(**kwargs)
    except Exception:
        return None


def phase_native_envelope(full: dict, smi: str) -> None:
    """[native-envelope]: every message registered in the port's
    serializer encoded by the C envelope and by the Python oracle, byte
    for byte, and decoded back into its class; the encode and decode
    microseconds of a ResolveBatchReply of [full]'s first 1,024 verdicts
    by both."""
    import foundationdb_tpu_torch.cluster.commit_wire  # noqa: F401
    from foundationdb_tpu_torch.cluster.multiprocess import ResolveBatchReply
    from foundationdb_tpu_torch.core import serialize as S

    env = S._env_init()

    def py_encode(v) -> bytes:
        w = S.BinaryWriter()
        S._encode_value_py(w, v)
        return w.to_bytes()

    covered = 0
    for name in sorted(S._MESSAGES):
        inst = wire_instance(S._MESSAGES[name])
        if inst is None:
            continue
        blob = py_encode(inst)
        if env.encode_value(inst) != blob:
            fail(f"native-envelope: {name} encodes differently in C")
        back, pos = env.decode_value(blob, 0)
        if pos != len(blob) or type(back) is not S._MESSAGES[name] \
                or py_encode(back) != blob:
            fail(f"native-envelope: {name} does not decode back in C")
        covered += 1
    if covered < 0.8 * len(S._MESSAGES):
        fail(f"native-envelope: only {covered} of {len(S._MESSAGES)} "
             "messages built")
    reply = ResolveBatchReply(statuses=tuple(
        int(x) for x in np.asarray(full["statuses"][0])[:1024]))
    frame = S.encode_message(reply)
    reps = 500

    def us(fn) -> float:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e6 * (time.perf_counter() - t0) / reps

    enc_c = us(lambda: S.encode_message(reply))
    dec_c = us(lambda: S.decode_message(frame))
    enc_py = us(lambda: py_encode(reply))
    dec_py = us(lambda: S._decode_value_py(S.BinaryReader(frame[8:])))
    if py_encode(reply) != frame[8:] or S.decode_message(frame) != reply:
        fail("native-envelope: the ResolveBatchReply frame differs")
    log("native-envelope", smi=json.dumps(smi),
        host_cpu=json.dumps(host_cpu()), messages=covered,
        registered=len(S._MESSAGES), equal=True, reply_txns=1024,
        frame_bytes=len(frame), encode_us=f"{enc_c:.2f}",
        decode_us=f"{dec_c:.2f}", py_encode_us=f"{enc_py:.2f}",
        py_decode_us=f"{dec_py:.2f}")


def phase_swarm(smi: str, budget: int = SWARM_BUDGET,
                jobs: int = SWARM_JOBS, seed_base: int = SWARM_SEED_BASE,
                device=None) -> None:
    """[swarm]: `python -m foundationdb_tpu_torch.sim.swarm` on the card,
    guided, with --check-determinism (every seed run twice: its
    fingerprint and coverage signature must repeat) from `jobs` spawned
    workers, each with a CUDA context of its own, the corpus into a
    temporary directory. Every seed passes; the probe launched in the
    workers. Then the regression-corpus entry replays on the card in
    this process twice, to its recorded class with an equal fingerprint
    and signature."""
    import shutil
    import tempfile

    from foundationdb_tpu_torch.sim.config import coverage_signature
    from foundationdb_tpu_torch.sim.distill import run_and_classify

    root = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="fdbtpu_swarm_"))
    report_path = tmp / "report.json"
    cmd = [sys.executable, "-m", "foundationdb_tpu_torch.sim.swarm",
           "--budget", str(budget), "--jobs", str(jobs),
           "--seed-base", str(seed_base), "--check-determinism",
           "--corpus", str(tmp / "corpus"), "--report", str(report_path)]
    if device is not None:
        cmd += ["--device", str(device)]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                           timeout=900, env=dict(os.environ,
                                                 PYTHONHASHSEED="0"))
        wall = time.perf_counter() - t0
        if p.returncode != 0 or not report_path.exists():
            fail(f"swarm: exit {p.returncode}\n{p.stdout[-3000:]}\n"
                 f"{p.stderr[-3000:]}")
        report = json.loads(report_path.read_text())
        bad = [r for r in report["records"] if r["class"] != "pass"]
        if report["seeds_run"] != budget or bad:
            fail(f"swarm: {len(bad)} of {report['seeds_run']} seeds did not "
                 f"pass: {bad}")
        if (tmp / "corpus").exists():
            fail("swarm: a corpus entry was written for a green swarm")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = report["probe_launches"]
    if device is None and launches <= 0:
        fail("swarm: the probe never launched in the swarm's workers")
    with open(root / CORPUS_ENTRY, encoding="utf-8") as f:
        entry = json.load(f)
    t1 = time.perf_counter()
    res1, cls1 = run_and_classify(entry["spec"], device)
    res2, cls2 = run_and_classify(entry["spec"], device)
    replay_s = time.perf_counter() - t1
    if not cls1 == cls2 == entry["expect"]:
        fail(f"swarm: the corpus entry replayed to {cls1}, {cls2}, not "
             f"{entry['expect']}")
    if res1.get("fingerprint") != res2.get("fingerprint") or \
            coverage_signature(entry["spec"], res1) \
            != coverage_signature(entry["spec"], res2):
        fail("swarm: the corpus entry's replays differ")
    peaks = [round(b / 2**20, 1)
             for b in report["device_peak_bytes_by_worker"]]
    log("swarm", smi=json.dumps(smi), seeds=budget, jobs=jobs,
        seed_base=seed_base, runs=2 * budget, wall_s=f"{wall:.2f}",
        seeds_per_min=f"{60 * budget / wall:.3f}",
        sim_seeds_per_min=(f"{RATES['sim']:.3f}" if "sim" in RATES
                           else "not measured"),
        distinct_buckets=report["distinct_buckets"],
        distinct_signatures=report["distinct_signatures"],
        probe_launches=launches, peak_reserved_mib_per_worker=peaks,
        corpus_entry=json.dumps(CORPUS_ENTRY), corpus_class=cls1,
        corpus_replays=2, corpus_replay_s=f"{replay_s:.2f}",
        fingerprint_equal=True, signature_equal=True)


def probe_entries(paths: dict, smi: str, base: dict) -> list:
    """The probe held against its plain version on each path's last
    operands, timed, with its bound: one kernel-table entry each. The
    bound counts the touched blocks for a resolver's sorted endpoints and
    the walks' reads for a storage window's unsorted queries."""
    from foundationdb_tpu_torch.resolver import probe

    out = []
    for path, cap in paths.items():
        if "hkeys" not in cap:
            fail(f"{path}: the probe was never called on this path")
        h, f, q, NB, B = (cap[k] for k in ("hkeys", "fences", "smat", "NB",
                                            "B"))
        err, t = check_probe(h, f, q, NB, B, timed=True)
        if path.endswith("storage"):
            bound_ms, bound_by = probe_walk_bound(
                h.cpu().numpy(), f.cpu().numpy(), q.cpu().numpy(), NB, B)
        else:
            bid = probe.probe_ranks_ref(h, f, q, NB=NB, B=B)[0].cpu().numpy()
            bound_ms, bound_by = probe_bound(q.shape[0], NB, B, q.shape[1],
                                             bid)
        log(f"probe-{path}", smi=json.dumps(smi), W1=q.shape[0],
            NB=NB, B=B, P2=q.shape[1], max_abs_err=err, **fmt_times(t),
            bound_ms=f"{bound_ms:.6f}", bound_by=bound_by,
            launches=cap["launches"])
        out.append(dict(base, path=path, launches=cap["launches"],
                        max_abs_err=err, ms=t["ms"], ms_cold=t["ms_cold"],
                        plain_ms=t["plain_ms"], bound_ms=bound_ms,
                        bound_by=bound_by))
    return out


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from foundationdb_tpu_torch import _build
    from foundationdb_tpu_torch.resolver import probe

    gc.set_threshold(*GC_THRESHOLDS)
    torch.manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi = smi[0] if smi else "not readable"
    # The kernel (nvcc) and the native host tier and envelope (g++) build
    # side by side; then the envelope is set up before anything
    # serializes.
    from concurrent.futures import ThreadPoolExecutor

    from foundationdb_tpu_torch import native
    from foundationdb_tpu_torch.storage_engine import _native

    with ThreadPoolExecutor(1) as ex:
        host_build = ex.submit(_native.build_host_tier)
        build_s = _build.build_all()
        native_s = host_build.result()
    native.prepare()
    build_wall = time.perf_counter() - t_start
    ptxas = _build.ptxas_summary(_build.BUILD_LOG.get("probe", ""))
    log("device", name=json.dumps(card), smi=json.dumps(smi),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, build_s=f"{build_s:.2f}",
        ptxas=json.dumps(ptxas), ptxas_phase2=json.dumps(
            _build.ptxas_summary(_build.BUILD_LOG.get("phase2", ""))),
        ptxas_block=json.dumps(
            _build.ptxas_summary(_build.BUILD_LOG.get("block", ""))),
        ptxas_compact=json.dumps(
            _build.ptxas_summary(_build.BUILD_LOG.get("compact", ""))),
        ptxas_read=json.dumps(
            _build.ptxas_summary(_build.BUILD_LOG.get("read", ""))),
        ptxas_rankfed=json.dumps(
            _build.ptxas_summary(_build.BUILD_LOG.get("rankfed", ""))))
    log("build", kernels=json.dumps(sorted(_build.SOURCES)),
        probe_nvcc_s=f"{build_s:.2f}",
        host_tier_gxx_s=f"{native_s['libfdbtpu_native']:.2f}",
        envelope_gxx_s=f"{native_s['fdbtpu_envelope']:.2f}",
        wall_s=f"{build_wall:.2f}", py_include=json.dumps(_native.PY_INCLUDE),
        host_tier=json.dumps(_native.host_path().name),
        envelope=json.dumps(_native.envelope_path().name),
        host_cpu=json.dumps(host_cpu()))

    base = {
        "name": "probe_ranks",
        "route": "cuda",
        "source": "foundationdb_tpu_torch/csrc/probe.cu",
        "replaces": "foundationdb_tpu/resolver/pallas_probe.py:61",
        "library_ms": None,
    }
    kernels = []
    t_mark = [t_start]

    def phase_wall(name: str) -> None:
        now = time.perf_counter()
        log("phase-wall", name=name, wall_s=f"{now - t_mark[0]:.2f}")
        t_mark[0] = now

    phase_wall("build")
    phase_probe(rng)
    phase_wall("probe")
    phase_phase2()
    phase_wall("phase2")
    phase_narrow(rng)
    phase_wall("narrow")
    full_keep = {}
    (launches, cap, full_rate, p2_cap, (b_cap, b_launches),
     (c_cap, c_launches)) = phase_full(rng, card, smi,
                                       n_batches=FULL_BATCHES, keep=full_keep)
    # The probe held against its plain version on the main path's
    # inputs.
    h, f, q, NB, B = (cap[k] for k in ("hkeys", "fences", "smat", "NB",
                                        "B"))
    err, t = check_probe(h, f, q, NB, B, timed=True)
    bid = probe.probe_ranks_ref(h, f, q, NB=NB, B=B)[0].cpu().numpy()
    bound_ms, bound_by = probe_bound(q.shape[0], NB, B, q.shape[1], bid)
    log("probe-main", W1=q.shape[0], NB=NB, B=B, P2=q.shape[1],
        max_abs_err=err, **fmt_times(t), bound_ms=f"{bound_ms:.5f}",
        bound_by=bound_by)
    kernels.append(dict(base, path="resolver", launches=launches,
                        max_abs_err=err, ms=t["ms"],
                        ms_cold=t["ms_cold"], plain_ms=t["plain_ms"],
                        bound_ms=bound_ms, bound_by=bound_by))
    # Phase 2's kernel on [full]'s last chunk.
    kernels += phase2_entries("resolver", p2_cap, p2_cap["launches"], smi,
                              P2_REPLACES["gpu"])
    # The block kernels on [full]'s last chunks.
    kernels += block_entries("resolver", b_cap, b_launches, smi)
    # The compaction kernels on [full]'s last compaction.
    kernels += compact_entries("resolver", c_cap, c_launches, smi)
    del cap, h, f, q, p2_cap, b_cap, c_cap
    phase_wall("full")
    phase_native(full_keep, smi, card)
    phase_wall("native")
    phase_native_sort(full_keep, smi)
    phase_wall("native-sort")
    phase_native_envelope(full_keep, smi)
    phase_wall("native-envelope")
    del full_keep
    # The storage path, and the probe held against its plain version on
    # each leg's last operands (W1 = n_words + 2, queries in request
    # order).
    legs = phase_storage(rng, smi)
    for leg, cap in legs.items():
        h, f, q, NB, B = (cap[k] for k in ("hkeys", "fences", "smat",
                                            "NB", "B"))
        err, t = check_probe(h, f, q, NB, B, timed=True)
        bound_ms, bound_by = probe_walk_bound(
            h.cpu().numpy(), f.cpu().numpy(), q.cpu().numpy(), NB, B)
        log(f"probe-storage-{leg}", smi=json.dumps(smi), W1=q.shape[0],
            NB=NB, B=B, P2=q.shape[1], max_abs_err=err, **fmt_times(t),
            bound_ms=f"{bound_ms:.6f}", bound_by=bound_by)
        kernels.append(dict(base, path=f"storage-{leg}",
                            launches=cap["launches"], max_abs_err=err,
                            ms=t["ms"], ms_cold=t["ms_cold"],
                            plain_ms=t["plain_ms"], bound_ms=bound_ms,
                            bound_by=bound_by))
        kernels.append(read_entry(f"storage-{leg}", *cap["read"], smi))
    del legs, cap, h, f, q
    phase_wall("storage")
    for name, phase in (("cluster", lambda rng, smi: phase_cluster(
                            rng, smi, target=CONFIG1_CHIP_TARGET)),
                        ("sharded", phase_sharded),
                        ("cluster-sharded", phase_cluster_sharded),
                        ("multichip", lambda rng, smi: phase_multichip(
                            np.random.default_rng(SEED + 12), smi)),
                        ("sharded-cluster", lambda rng, smi:
                         phase_sharded_cluster(
                             rng, smi, load_keys=SHARDED_CLUSTER_LOAD_KEYS,
                             target=CONFIG1_CHIP_TARGET))):
        paths = phase(rng, smi)
        p2_caps = {k: v for c in paths.values()
                   for k, v in c.pop("phase2", {}).items()}
        b_caps = {k: c.pop("block") for k, c in paths.items()
                  if "block" in c}
        c_caps = {k: c.pop("compact") for k, c in paths.items()
                  if "compact" in c}
        shards = {k: c.pop("shards") for k, c in paths.items()
                  if "shards" in c}
        r_caps = {k: c.pop("read") for k, c in paths.items() if "read" in c}
        kernels += probe_entries(paths, smi, base)
        # the read kernel on [cluster]'s storage window's last batch
        for path, (rc, rl) in r_caps.items():
            kernels.append(read_entry(path, rc, rl, smi))
        # [cluster]'s last batch under each tier, [sharded]'s last step
        for path, c in p2_caps.items():
            kernels += phase2_entries(path, c, c["launches"], smi,
                                      P2_REPLACES["gpu"])
        # the block kernels on [cluster]'s and [sharded]'s last fast step
        for path, (bc, bl) in b_caps.items():
            kernels += block_entries(path, bc, bl, smi)
        # the compaction kernels on their last compaction
        for path, (cc, cl) in c_caps.items():
            kernels += compact_entries(path, cc, cl, smi)
        for path, n_shards in shards.items():
            # a fast batch's least device time: each shard step's kernels
            # (probe, decode, phase 1, phase 2, phase 3) at the last
            # step's shapes, times the shards
            step = [k for k in kernels if k.get("path") == path
                    and k["name"] in ("probe_ranks", "phase2_rounds",
                                      "decode_fused", "phase1", "phase3")]
            bound = n_shards * sum(k["bound_ms"] for k in step)
            log(f"{path}-step-bound", smi=json.dumps(smi),
                kernels=len(step), shards=n_shards, bound_ms=f"{bound:.7f}",
                bound_by="+".join(sorted({k["bound_by"] for k in step})))
        del paths, p2_caps, b_caps, c_caps, shards, r_caps
        phase_wall(name)
    entries, rankfed_check = phase_rankfed(
        rng, smi, full_txns_per_s=full_rate, n_batches=RANKFED_BATCHES)
    kernels += entries
    phase_wall("rankfed")
    for name, phase in (("recovery", lambda rng, smi: phase_recovery(
                            rng, smi, load_keys=RECOVERY_CHIP_LOAD_KEYS,
                            target=RECOVERY_CHIP_TARGET)),
                        ("sharded-recovery", phase_sharded_recovery)):
        kernels += probe_entries(phase(rng, smi), smi, base)
        phase_wall(name)
    rankfed_check()
    phase_wall("rankfed-check")
    kernels += probe_entries(phase_sim(
        rng, smi, seeds=SIM_CHIP_SEEDS,
        det_seeds=SIM_CHIP_DETERMINISM_SEEDS), smi, base)
    phase_wall("sim")
    phase_swarm(smi)
    phase_wall("swarm")
    kernels += probe_entries(phase_durable(
        rng, smi, load_keys=DURABLE_CHIP_LOAD_KEYS,
        target=DURABLE_CHIP_TARGET, crash_target=DURABLE_CHIP_CRASH_TARGET),
        smi, base)
    phase_wall("durable")
    kernels += probe_entries(phase_sim_durable(
        rng, smi, seeds=SIM_DURABLE_CHIP_SEEDS,
        det_seeds=SIM_DURABLE_CHIP_DETERMINISM_SEEDS), smi, base)
    phase_wall("sim-durable")
    kernels += probe_entries(phase_multiprocess(
        rng, smi, load_keys=MP_CHIP_LOAD_KEYS, target=MP_CHIP_TARGET),
        smi, base)
    phase_wall("multiprocess")
    kernels += probe_entries(phase_backup(rng, smi, target=BACKUP_CHIP_TARGET),
                             smi, base)
    phase_wall("backup")
    kernels += probe_entries(phase_sim(
        rng, smi, seeds=SIM_BACKUP_CHIP_SEEDS,
        det_seeds=SIM_BACKUP_CHIP_DETERMINISM_SEEDS, extras={},
        name="sim-backup"), smi, base)
    phase_wall("sim-backup")
    log("smoke", wall_s=f"{time.perf_counter() - t_start:.2f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
