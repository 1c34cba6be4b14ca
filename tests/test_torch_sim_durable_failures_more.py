"""The oversized-record seeds of the reference-side failures (see
tests/test_torch_sim_durable_failures.py): 60, 93 and 100 raise the
native DiskQueue's OSError in both packages, on the port with the host
and with the device backends."""

import pytest

from _torch_sim_cases import (  # noqa: F401 - one_torch_thread: autouse
    assert_fails_the_same_way,
    one_torch_thread,
)


@pytest.mark.parametrize("seed", [60, 93, 100])
def test_fails_the_same_way_on_both_packages(seed):
    assert_fails_the_same_way(seed)
