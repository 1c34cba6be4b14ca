"""Single-process transaction-system roles wired on the deterministic loop.

This is SURVEY.md §7 step 3 — the minimum end-to-end slice: a version
authority (master), a batching commit proxy, a resolver role over the
ConflictSet kernel, an in-memory tag log, and an MVCC storage node, all as
actors on the port's `core` event loop, with the port's `client` API
driving them (the port's copy of foundationdb_tpu/cluster; LocalCluster
runs the resolver's conflict set and the storage window on the CUDA
card). Role boundaries and message types
mirror the reference's interfaces (fdbclient/MasterProxyInterface.h,
StorageServerInterface.h, fdbserver/ResolverInterface.h) so that the
networked/multi-process tier can later swap PromiseStream endpoints for
real RPC without touching role logic. The recovery tier
(recovery.RecoverableCluster, RecoverableShardedCluster) re-recruits the
transaction system, its resolvers on the card, every generation.
"""

from .cluster import LocalCluster  # noqa: F401
