"""Client API: Database / Transaction with read-your-writes semantics.

The idiomatic-Python face of the reference's client core
(fdbclient/NativeAPI.actor.cpp Transaction + fdbclient/ReadYourWrites):
snapshot reads at a GRV-acquired version, locally buffered writes with RYW
merge, atomic ops, conflict-range bookkeeping, commit through the proxy
pipeline, and the on_error retry loop every binding exposes.
"""

from .database import Database  # noqa: F401
from .transaction import Transaction  # noqa: F401
