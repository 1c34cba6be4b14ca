"""The simulator's durable seeds on the port against the JAX package, on
the CPU: the first half of chip_smoke.SIM_DURABLE_SEEDS (the [sim-durable]
seeds: the memory and ssd engines on a temporary datadir, regions, the
sharded and the recoverable_sharded tier; the second half in
tests/test_torch_sim_durable_more.py). Each seed gives the same whole
run_spec result in both packages with the host backends pinned on both
sides, and the port's device backends (ConflictSetGPU and
KeyValueStoreGPU, device="cpu", every window of a cold boot, re-home or
power loss restored onto it) give its host backends' ok, checks, metrics
and fingerprint."""

import pytest

from _torch_sim_cases import (  # noqa: F401 - one_torch_thread: autouse
    REFERENCE_SIDE_FAILURES,
    SIM_DURABLE_SEEDS,
    assert_device_equals_host,
    assert_jax_equals_port,
    draws_backup,
    is_durable,
    one_torch_thread,
)

FIRST = SIM_DURABLE_SEEDS[:8]


def test_sim_durable_seeds_are_the_first_durable_seeds_the_reference_passes():
    from foundationdb_tpu_torch.sim.config import generate_config

    specs = {s: generate_config(s) for s in range(200)}
    durable = [s for s in range(200) if not draws_backup(specs[s])
               and is_durable(specs[s])]
    passing = [s for s in durable if s not in REFERENCE_SIDE_FAILURES]
    assert list(SIM_DURABLE_SEEDS) == passing[:16] + [168]
    # 168: the first passing durable seed that draws the memory engine
    # AND regions (137 before it fails on the JAX package)
    both = [s for s in passing[:passing.index(168) + 1]
            if specs[s]["cluster"].get("engine") == "memory"
            and specs[s]["cluster"].get("regions")]
    assert both == [168]
    # the seeds cover both engines, regions and both cluster kinds
    drawn = [specs[s]["cluster"] for s in SIM_DURABLE_SEEDS]
    assert {c.get("engine") for c in drawn} == {None, "memory", "ssd"}
    assert any(c.get("regions") for c in drawn)
    assert {c["kind"] for c in drawn} == {"sharded", "recoverable_sharded"}


def test_sim_durable_chip_seeds_cover_both_engines_regions_and_kinds():
    """The card's cut of the list keeps an ssd seed, a memory-engine
    seed, regions and both sharded cluster kinds."""
    from chip_smoke import SIM_DURABLE_CHIP_DETERMINISM_SEEDS
    from chip_smoke import SIM_DURABLE_CHIP_SEEDS as chip
    from foundationdb_tpu_torch.sim.config import generate_config

    assert set(chip) <= set(SIM_DURABLE_SEEDS)
    assert set(SIM_DURABLE_CHIP_DETERMINISM_SEEDS) <= set(chip)
    drawn = [generate_config(s)["cluster"] for s in chip]
    assert {"memory", "ssd"} <= {c.get("engine") for c in drawn}
    assert any(c.get("regions") for c in drawn)
    assert {c["kind"] for c in drawn} == {"sharded", "recoverable_sharded"}


@pytest.mark.parametrize("seed", FIRST)
def test_jax_package_equals_the_port(seed):
    assert_jax_equals_port(seed)


@pytest.mark.parametrize("seed", FIRST)
def test_device_backends_equal_the_host_backends(seed):
    assert_device_equals_host(seed)
