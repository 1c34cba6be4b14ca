"""The simulator's backup seeds on the port against the JAX package, on
the CPU: chip_smoke.SIM_BACKUP_SEEDS (the [sim-backup] seeds: 4, 8, 13 and
20 in memory, 2 and 9 on the durable tier; BackupRestore, BackupAttrition
and both) each give the same whole run_spec result in both packages with
the host backends pinned on both sides, and the port's device backends
(ConflictSetGPU and KeyValueStoreGPU, device="cpu") give its host
backends' ok, checks, metrics and fingerprint. Seeds 32 and 61 run past
256 pipelined batches in one resolver role: they hold the role's stage
reservoirs off the loop's random stream (a draw there moved every later
simulated decision of a device run off the host run's)."""

import pytest

from _torch_sim_cases import (  # noqa: F401 - one_torch_thread: autouse
    REFERENCE_SIDE_FAILURES,
    SIM_BACKUP_SEEDS,
    assert_device_equals_host,
    assert_jax_equals_port,
    draws_backup,
    is_durable,
    one_torch_thread,
)


def test_sim_backup_seeds_are_the_first_backup_seeds_the_reference_passes():
    from foundationdb_tpu_torch.sim.config import generate_config

    specs = {s: generate_config(s) for s in range(200)}
    passing = [s for s in range(200) if draws_backup(specs[s])
               and s not in REFERENCE_SIDE_FAILURES]
    in_memory = [s for s in passing if not is_durable(specs[s])]
    durable = [s for s in passing if is_durable(specs[s])]
    assert list(SIM_BACKUP_SEEDS[:4]) == in_memory[:4]

    def first(seeds, name):
        return next(s for s in seeds
                    if name in {w["name"] for w in specs[s]["workloads"]})

    assert list(SIM_BACKUP_SEEDS[4:]) == [first(durable, "BackupRestore"),
                                          first(durable, "BackupAttrition")]
    drawn = {w["name"] for s in SIM_BACKUP_SEEDS
             for w in specs[s]["workloads"]}
    assert {"BackupRestore", "BackupAttrition"} <= drawn


@pytest.mark.parametrize("seed", SIM_BACKUP_SEEDS)
def test_jax_package_equals_the_port(seed):
    assert_jax_equals_port(seed)


@pytest.mark.parametrize("seed", SIM_BACKUP_SEEDS + (32, 61))
def test_device_backends_equal_the_host_backends(seed):
    assert_device_equals_host(seed)
