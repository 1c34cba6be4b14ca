"""The backup seeds the JAX package itself fails on the CPU with the host
backends pinned (tests/_torch_sim_cases.REFERENCE_SIDE_FAILURES, ROADMAP
Queue 3): each fails the same way on the port, with the host backends
(the whole result equal: the same exception and message, or the same
failed check beside every other entry) and with the device backends
(device="cpu"). 16 and 28 read a Cycle key that is not there (as 163);
31, 99 and 103 push a memory-engine record larger than a DiskQueue page (as
60); 169 ends with its Attrition check failed; 180 loses the
coordinators' read quorum at start (as 149 its write quorum)."""

import pytest

from _torch_sim_cases import (  # noqa: F401 - one_torch_thread: autouse
    assert_fails_the_same_way,
    one_torch_thread,
)


@pytest.mark.parametrize("seed", [16, 28, 31, 99, 103, 169, 180])
def test_fails_the_same_way_on_both_packages(seed):
    assert_fails_the_same_way(seed)
