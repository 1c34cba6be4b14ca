"""The second half of the simulator's durable seeds
(chip_smoke.SIM_DURABLE_SEEDS, see tests/test_torch_sim_durable.py):
each gives the same whole run_spec result in the JAX package and the port
on the CPU with the host backends pinned on both sides, and the port's
device backends (device="cpu") give its host backends' outcome."""

import pytest

from _torch_sim_cases import (  # noqa: F401 - one_torch_thread: autouse
    SIM_DURABLE_SEEDS,
    assert_device_equals_host,
    assert_jax_equals_port,
    one_torch_thread,
)

SECOND = SIM_DURABLE_SEEDS[8:]


@pytest.mark.parametrize("seed", SECOND)
def test_jax_package_equals_the_port(seed):
    assert_jax_equals_port(seed)


@pytest.mark.parametrize("seed", SECOND)
def test_device_backends_equal_the_host_backends(seed):
    assert_device_equals_host(seed)
