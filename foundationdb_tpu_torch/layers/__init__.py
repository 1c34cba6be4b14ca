"""Client-side layers (ref: the tuple/subspace layers every binding ships,
fdbclient/Tuple.cpp + bindings/python/fdb/tuple.py, spec design/tuple.md).

The port's copy of foundationdb_tpu/layers/: the tuple, subspace,
directory and TaskBucket layers."""

from .tuple import pack, range_of, unpack  # noqa: F401
from .subspace import Subspace  # noqa: F401
