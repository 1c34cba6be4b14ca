"""Role interfaces: request/reply message types + in-process endpoints.

Mirrors the reference's interface headers (fdbclient/MasterProxyInterface.h:
33-36 commit/getConsistentReadVersion, fdbclient/StorageServerInterface.h:31
getValue/getKeyValues/watchValue, fdbserver/ResolverInterface.h:27
resolve). An endpoint here is a PromiseStream of requests carrying a reply
Promise — the exact shape FlowTransport serializes over TCP
(fdbrpc/fdbrpc.h:212 RequestStream / ReplyPromise); the networked tier
replaces the stream transport, not the message types.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..core.runtime import Promise
from ..kv.atomic import MutationType
from ..kv.keys import KeyRange


@dataclass
class Mutation:
    """(ref: MutationRef, fdbclient/CommitTransaction.h:89)."""

    type: MutationType
    param1: bytes  # key, or range begin for CLEAR_RANGE
    param2: bytes  # value / atomic operand, or range end for CLEAR_RANGE


@dataclass
class GetReadVersionRequest:
    """(ref: GetReadVersionRequest, MasterProxyInterface.h:122; priorities
    :122 PRIORITY_SYSTEM_IMMEDIATE/DEFAULT/BATCH — immediate bypasses
    ratekeeper throttling, batch yields to everything else)."""

    PRIORITY_BATCH = 0
    PRIORITY_DEFAULT = 1
    PRIORITY_IMMEDIATE = 2

    priority: int = 1
    # Flight recorder (CLIENT_KNOBS.COMMIT_SAMPLE_RATE): a sampled
    # transaction's debug ID — the proxy emits a GRV.Reply micro event
    # carrying it when the batch answers.
    debug_id: Optional[str] = None
    reply: Promise = field(default_factory=Promise)


@dataclass
class ConfirmEpochLiveRequest:
    """Proxy -> tlog liveness check backing every GRV batch (ref:
    confirmEpochLive, TagPartitionedLogSystem.actor.cpp:553). The reply
    resolves iff the log still serves `epoch`; a log fenced by a newer
    generation answers with TLogStopped."""

    epoch: int
    reply: Promise = field(default_factory=Promise)


@dataclass
class CommitTransactionRequest:
    """(ref: CommitTransactionRequest, MasterProxyInterface.h:76; the
    payload is CommitTransactionRef, CommitTransaction.h:89-105)."""

    read_snapshot: int
    read_conflict_ranges: Sequence[KeyRange]
    write_conflict_ranges: Sequence[KeyRange]
    mutations: Sequence[Mutation]
    # Flight recorder (CLIENT_KNOBS.COMMIT_SAMPLE_RATE): client-drawn
    # debug ID of a sampled transaction. The proxy attaches it to its
    # commit batch's ID (trace_txn_attach) and the batch ID rides every
    # downstream hop, so `cli.py trace <id>` stitches the full timeline.
    debug_id: Optional[str] = None
    reply: Promise = field(default_factory=Promise)


@dataclass
class CommitID:
    """(ref: CommitID, MasterProxyInterface.h:60; the versionstamp is the
    10-byte (version, batch_index) stamp spliced into this transaction's
    versionstamped operations)."""

    version: int
    versionstamp: bytes = b""


@dataclass
class GetValueRequest:
    """(ref: GetValueRequest, StorageServerInterface.h:87)."""

    key: bytes
    version: int
    reply: Promise = field(default_factory=Promise)


@dataclass
class GetRangeRequest:
    """(ref: GetKeyValuesRequest, StorageServerInterface.h:128)."""

    begin: bytes
    end: bytes
    version: int
    limit: int = 0
    reverse: bool = False
    reply: Promise = field(default_factory=Promise)


@dataclass
class WatchValueRequest:
    """(ref: WatchValueRequest, StorageServerInterface.h:110). Fires when
    the key's value is observed to differ from `value` at some version >
    `version`."""

    key: bytes
    value: Optional[bytes]
    version: int
    reply: Promise = field(default_factory=Promise)


@dataclass
class TLogCommitRequest:
    """(ref: TLogCommitRequest, fdbserver/TLogInterface.h).

    `wire` optionally carries the mutation payload as ONE columnar buffer
    (commit_wire.pack_tagged_mutations, SERVER_KNOBS.TLOG_WIRE_BATCH):
    cross-process pushes ship it INSTEAD of the object list, so the
    commit path never walks per-mutation dataclasses through the
    recursive wire encoder."""

    prev_version: int
    version: int
    mutations: Sequence[Mutation]
    epoch: int = 0
    wire: Optional[bytes] = None
    # Flight recorder: the proxy batch's debug ID when the batch holds a
    # sampled transaction — the log host emits TLog.Durable with it once
    # its fsync lands, from its own process (cross-process stitching).
    debug_id: Optional[str] = None
    reply: Promise = field(default_factory=Promise)


@dataclass
class RegisterWorkerRequest:
    """Worker -> controller registration (ref: RegisterWorkerRequest,
    fdbserver/WorkerInterface.actor.h; worker.actor.cpp:481
    registrationClient). Re-sent forever on the heartbeat interval —
    registration IS the liveness lease beat. The reply carries the
    interval (seconds) the controller leases against."""

    worker_id: str
    process_class: str
    address: str = ""
    machine_id: str = ""
    reply: Promise = field(default_factory=Promise)


@dataclass
class RecruitmentStatusRequest:
    """Operator shell -> controller: the worker registry + any active
    recruitment stalls (the `recruitment` verb of cli.py)."""

    reply: Promise = field(default_factory=Promise)


@dataclass
class ClusterStatusRequest:
    """Operator shell -> controller: the full status-json document of a
    DEPLOYED cluster over the control RPCs — what `cli.py
    --cluster-file` renders (ref: the cluster controller assembling
    status for fdbcli, Status.actor.cpp)."""

    reply: Promise = field(default_factory=Promise)


@dataclass
class ResolveTransactionBatchRequest:
    """(ref: ResolveTransactionBatchRequest, ResolverInterface.h:70).

    `system_mutations` carries this batch's \\xff-keyspace mutations as
    (txn_index, Mutation) pairs for retention at resolver 0 (the
    reference's txnStateTransactions); `committed_feedback` reports the
    MERGED verdicts of earlier windows back to the resolver — a resolver
    judges only its clip, so it cannot know global outcomes itself
    (ref: Resolver.actor.cpp:171-190 state-transaction retention)."""

    prev_version: int
    version: int
    last_receive_version: int
    transactions: list  # list[TxnConflictInfo]
    system_mutations: tuple = ()
    committed_feedback: tuple = ()
    # Columnar wire form of `transactions` (resolver/wire.py WireBatch
    # bytes, SERVER_KNOBS.RESOLVER_WIRE_BATCH): device-backed resolvers
    # pack it with the vectorized encoder instead of walking txn objects;
    # cross-process requests ship ONLY the wire form (transactions empty)
    # so the commit path never serializes per-range Python objects.
    wire: bytes | None = None
    # Generation fence for resolver HOSTS serving multiple generations
    # over reused endpoints (multiprocess tier): a deposed proxy's
    # in-flight batch must not merge into the successor's conflict state.
    # In-process roles (one per generation by construction) ignore it.
    epoch: int = 0
    # Flight recorder: the proxy batch's debug ID when the batch holds a
    # sampled transaction; the resolver emits Resolver.Submit/Verdict
    # micro events with it (per-txn IDs ride the wire batch's sparse
    # debug column, resolver/wire.py).
    debug_id: Optional[str] = None
    reply: Promise = field(default_factory=Promise)


# -- wire registration: every interface message is serializable, so the
#    same role code runs over the in-process streams, the sim network, and
#    the real FlowTransport (ref: the serializer specializations each
#    *Interface.h declares for its request structs). --

def _register_wire_types() -> None:
    from ..core.serialize import register_enum, register_message
    from ..resolver.types import TxnConflictInfo

    for cls in (
        Mutation,
        GetReadVersionRequest,
        CommitTransactionRequest,
        CommitID,
        GetValueRequest,
        GetRangeRequest,
        WatchValueRequest,
        TLogCommitRequest,
        ResolveTransactionBatchRequest,
        RegisterWorkerRequest,
        RecruitmentStatusRequest,
        ClusterStatusRequest,
        KeyRange,
        TxnConflictInfo,
    ):
        register_message(cls)
    register_enum(MutationType)


_register_wire_types()
