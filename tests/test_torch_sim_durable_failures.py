"""The durable seeds the JAX package itself fails on the CPU with the host
backends pinned (tests/_torch_sim_cases.REFERENCE_SIDE_FAILURES, ROADMAP
Queue 3): each fails the same way on the port, with the host backends
(the whole result equal: the same exception and message, or the same
failed check beside every other entry) and with the device backends
(device="cpu"). Seeds 60, 93 and 100 push a memory-engine record larger
than a DiskQueue page (4,080 payload bytes) through the native queue,
which raises OSError in both packages; 149 loses the coordinators'
write quorum at start; 163 reads a Cycle key that is not there; 0, 70
and 137 end with a failed Serializability, ConsistencyCheck or LowLatency
check. The slow device runs of 60, 93 and 100 are in
tests/test_torch_sim_durable_failures_more.py."""

import pytest

from _torch_sim_cases import (  # noqa: F401 - one_torch_thread: autouse
    assert_fails_the_same_way,
    one_torch_thread,
)


@pytest.mark.parametrize("seed", [0, 70, 137, 149, 163])
def test_fails_the_same_way_on_both_packages(seed):
    assert_fails_the_same_way(seed)
