"""The second half of the [sim] seeds (chip_smoke.SIM_SEEDS) and the long
seed 26: each gives the same whole run_spec result in the JAX package and
the port on the CPU, with the host backends pinned on both sides (see
tests/test_torch_sim_differential.py, which runs the first half)."""

import pytest

from _torch_sim_cases import (  # noqa: F401 - one_torch_thread: autouse
    SIM_SEEDS,
    assert_jax_equals_port,
    one_torch_thread,
)


@pytest.mark.parametrize("seed", [26] + list(SIM_SEEDS[12:]))
def test_jax_package_equals_the_port(seed):
    assert_jax_equals_port(seed)
