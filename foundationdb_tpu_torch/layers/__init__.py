"""Client-side layers (ref: the tuple/subspace layers every binding ships,
fdbclient/Tuple.cpp + bindings/python/fdb/tuple.py, spec design/tuple.md).

The port's copy of foundationdb_tpu/layers/, its tuple layer only (the
metrics keys of cluster/metric_logger.py); the other layers wait for
ROADMAP Queue 1 item 9."""

from .tuple import pack, range_of, unpack  # noqa: F401
