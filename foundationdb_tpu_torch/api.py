"""The user-facing binding surface (ref: bindings/python/fdb — the shape
every FoundationDB app uses: fdb.open(), @fdb.transactional, fdb.tuple,
fdb.directory, fdb.Subspace, option constants).

This framework IS Python, so the "binding" is a thin idiomatic facade
over the client core rather than a ctypes shim over a C ABI; the surface
mirrors the reference binding so application code ports directly:

    import foundationdb_tpu_torch.api as fdb

    db = fdb.open()                      # in-process cluster on the card

    @fdb.transactional
    async def add_user(tr, uid, name):
        tr.set(fdb.tuple.pack(("users", uid)), name)

    await add_user(db, 42, b"alice")

The port's copy of foundationdb_tpu/api.py: `open(device=None)` starts
its embedded cluster's conflict sets and storage windows on `device`
(None: the CUDA card, which must be present; "cpu" runs their plain
torch versions).
"""

from __future__ import annotations

import functools
from typing import Optional

from .client.database import Database
from .client.transaction import Transaction
from .kv.atomic import MutationType
from .layers import subspace as _subspace_mod
from .layers import tuple as tuple  # noqa: A001 — mirrors fdb.tuple
from .layers.directory import DirectoryLayer
from .layers.subspace import Subspace

#: Default directory layer instance (ref: fdb.directory).
directory = DirectoryLayer()


def open(cluster=None, sharded: bool = False, device=None,  # noqa: A001
         **kw) -> Database:
    """Open a database handle (ref: fdb.open). With no arguments, starts
    an in-process cluster on the current event loop, its device backends
    on `device` (None: the CUDA card) — the embedded equivalent of the
    reference's local cluster file default. Pass an existing
    LocalCluster/ShardedKVCluster/RecoverableCluster (started or not) to
    connect to it instead."""
    if cluster is None:
        if sharded:
            from .cluster.sharded_cluster import ShardedKVCluster

            cluster = ShardedKVCluster(device=device, **kw)
        else:
            from .cluster.cluster import LocalCluster

            cluster = LocalCluster(device=device, **kw)
    if not getattr(cluster, "_started", True):
        cluster.start()
    return cluster.database()


def transactional(fn):
    """(ref: @fdb.transactional, bindings/python/fdb/impl.py) — wraps an
    `async def fn(tr, ...)`: called with a Database first argument it
    runs the full retry loop; called with a Transaction it joins the
    caller's transaction (no commit of its own)."""

    @functools.wraps(fn)
    async def wrapper(db_or_tr, *args, **kwargs):
        if isinstance(db_or_tr, Transaction):
            return await fn(db_or_tr, *args, **kwargs)
        return await db_or_tr.transact(
            lambda tr: fn(tr, *args, **kwargs)
        )

    return wrapper


# Option constants (ref: fdb.options — generated by the vexillographer).
from .options import DatabaseOptions, TransactionOptions  # noqa: E402

__all__ = [
    "open",
    "transactional",
    "tuple",
    "Subspace",
    "directory",
    "DirectoryLayer",
    "Database",
    "Transaction",
    "MutationType",
    "TransactionOptions",
    "DatabaseOptions",
]
