"""Invariant-checking workloads (ref: fdbserver/workloads/ — 76 workloads
driven by the tester framework, fdbserver/tester.actor.cpp:626). Each
workload follows the reference's TestWorkload phases: setup() -> start()
(concurrent clients) -> check() (invariant validation)
(fdbserver/workloads/workloads.h:55-74)."""

from .cycle import CycleWorkload  # noqa: F401
