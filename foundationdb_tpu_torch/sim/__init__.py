"""Deterministic simulation beyond the virtual clock: simulated processes,
a lossy/laggy in-memory network with clogs and partitions, and the fault
arsenal that drives workload tests (ref: fdbrpc/sim2.actor.cpp +
fdbrpc/simulator.h; SURVEY §4 tier 2 — "the backbone").

The port's copy of foundationdb_tpu/sim/ (network, harness, topology,
config, nondurable): the simulated clusters recruit the port's device
backends on the CUDA card unless the caller passes device="cpu";
nondurable.py is the simulated disk and its power loss.
"""

from .network import RemoteStream, SimNetwork, SimProcess  # noqa: F401
from .harness import SimulatedCluster  # noqa: F401
from .topology import (  # noqa: F401
    MachineTopology,
    SimDatacenter,
    SimMachine,
)
