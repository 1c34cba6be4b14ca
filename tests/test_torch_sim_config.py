"""The port's randomized SimulationConfig against the JAX package's.

foundationdb_tpu_torch/sim/config.py keeps the JAX package's draw stream
draw for draw; only the two device knobs' backend names are the port's
(CONFLICT_SET_IMPL: "native" and "tpu" draw "gpu"; STORAGE_ENGINE_IMPL:
"tpu" draws "gpu"). So for every seed, with or without a DrawBias, the
port's spec is the JAX package's with those names mapped, and both
packages' coverage facets, signatures and knob buckets agree on either
spec. Every draw of seeds 0-199 applies on the port's knob registry as
drawn (the port refuses none since the backup tier is ported), and the
smoke's seed lists are taken from the draws as before: [sim] and
[sim-durable] from the seeds that draw no backup workload.
"""

import pytest

from foundationdb_tpu.sim import config as jcfg
from foundationdb_tpu_torch.sim import config as pcfg

NAME_MAP = {
    "server:CONFLICT_SET_IMPL": {"native": "gpu", "tpu": "gpu"},
    "server:STORAGE_ENGINE_IMPL": {"tpu": "gpu"},
}
SEEDS = range(200)


def mapped(spec: dict) -> dict:
    knobs = {
        k: NAME_MAP.get(k, {}).get(v, v) for k, v in spec["knobs"].items()
    }
    return dict(spec, knobs=knobs)


def biases():
    """20 DrawBias arguments that steer every biasable dimension, force
    knob draws and bucket them (each valid in both packages)."""
    out = []
    for i in range(20):
        dims = sorted(jcfg.BIAS_DIMS)
        prefer = {d: jcfg.BIAS_DIMS[d][i % len(jcfg.BIAS_DIMS[d])]
                  for d in dims[: 1 + i % len(dims)]}
        prefer["workload"] = jcfg.OPTIONAL_WORKLOAD_NAMES[
            i % len(jcfg.OPTIONAL_WORKLOAD_NAMES)]
        ranges = [f"{reg}:{name}" for name, reg, _ in jcfg._KNOB_RANGES]
        force = ranges[i % len(ranges):][:4] + ["server:CONFLICT_SET_IMPL"]
        buckets = {k: ("lo", "mid", "hi")[(i + j) % 3]
                   for j, k in enumerate(force[:3])}
        buckets["server:CONFLICT_SET_IMPL"] = "oracle"
        out.append(dict(prefer=prefer, strength=0.3 + 0.035 * i,
                        force_knobs=force, knob_buckets=buckets))
    return out


@pytest.mark.parametrize("chunk", range(4))
def test_generate_config_equals_the_jax_package(chunk):
    for seed in SEEDS[chunk::4]:
        assert pcfg.generate_config(seed) == mapped(
            jcfg.generate_config(seed)), seed


@pytest.mark.parametrize("i", range(20))
def test_biased_draws_equal_the_jax_package(i):
    kw = biases()[i]
    for seed in (1000 + i, 2000 + 7 * i):
        got = pcfg.generate_config(seed, pcfg.DrawBias(**kw))
        want = jcfg.generate_config(seed, jcfg.DrawBias(**kw))
        assert got == mapped(want), (i, seed)


def test_choice_tables_keep_lengths_and_weights():
    j = {name: (reg, choices) for name, reg, choices in jcfg._KNOB_CHOICES}
    p = {name: (reg, choices) for name, reg, choices in pcfg._KNOB_CHOICES}
    assert list(j) == list(p)
    for name, (reg, choices) in j.items():
        key = f"{reg}:{name}"
        assert p[name] == (reg, tuple(
            NAME_MAP.get(key, {}).get(c, c) for c in choices)), name
    assert pcfg._KNOB_RANGES == jcfg._KNOB_RANGES
    assert pcfg.BIAS_DIMS == jcfg.BIAS_DIMS
    assert pcfg.OPTIONAL_WORKLOAD_NAMES == jcfg.OPTIONAL_WORKLOAD_NAMES


@pytest.mark.parametrize("chunk", range(2))
def test_coverage_facets_signature_and_buckets_agree(chunk):
    result = {"coverage": {"trace_event_types": ["Cycle", "SimClogPair"],
                           "recovery_states": ["fully_recovered"],
                           "metric_names": ["proxy.commits"]}}
    for seed in SEEDS[chunk::2]:
        jspec = jcfg.generate_config(seed)
        for spec in (jspec, mapped(jspec)):
            for res in (None, result):
                assert pcfg.coverage_facets(spec, res) == \
                    jcfg.coverage_facets(spec, res), seed
                assert pcfg.coverage_signature(spec, res) == \
                    jcfg.coverage_signature(spec, res), seed
            for key, value in spec["knobs"].items():
                assert pcfg.knob_bucket(key, value) == \
                    jcfg.knob_bucket(key, value), (seed, key)


def draws_backup(spec: dict) -> bool:
    names = {w["name"] for w in spec["workloads"]}
    return bool(names & {"BackupRestore", "BackupAttrition"})


def test_unported_needs_flags_exactly_engine_regions_and_backups():
    """Nothing is flagged any more: `unported_needs` is gone with the
    last refusal, and the seeds that draw no backup workload, in order,
    are the ones the [sim] and [sim-durable] lists were taken from
    (unchanged); 81 of the 200 draw a backup workload, 25 of them on the
    durable tier."""
    assert not hasattr(pcfg, "unported_needs")
    plain, durable, backup, backup_durable = [], [], [], []
    for seed in SEEDS:
        spec = pcfg.generate_config(seed)
        cluster = spec["cluster"]
        is_durable = bool(cluster.get("engine") or cluster.get("regions"))
        if draws_backup(spec):
            backup.append(seed)
            backup_durable += [seed] if is_durable else []
            continue
        plain.append(seed)
        if is_durable:
            durable.append(seed)
    assert plain[:12] == [0, 1, 3, 5, 6, 10, 11, 12, 14, 15, 17, 18]
    assert durable[:8] == [0, 1, 6, 10, 12, 15, 18, 27]
    assert 100 <= len(plain) <= 140, len(plain)
    assert (len(backup), len(backup_durable)) == (81, 25)
    assert backup[:12] == [2, 4, 7, 8, 9, 13, 16, 20, 22, 23, 24, 28]


def test_unported_needs_of_hand_written_specs(tmp_path):
    """A hand-written restart spec whose second incarnation draws
    BackupRestore runs on the port (nothing is refused) and gives the
    JAX package's whole result, host backends pinned on both sides."""
    from foundationdb_tpu.workloads.tester import run_spec as jax_run
    from foundationdb_tpu_torch.workloads.tester import run_spec

    cycle = {"name": "Cycle", "nodes": 8, "clients": 2, "txns": 8}
    spec = {"seed": 11, "buggify": True,
            "cluster": {"kind": "restart", "n_storage": 3, "n_logs": 1,
                        "replication": "single", "engine": "memory"},
            "knobs": {"server:CONFLICT_SET_IMPL": "oracle",
                      "server:STORAGE_ENGINE_IMPL": "memory"},
            "phases": [{"workloads": [cycle]},
                       {"workloads": [cycle, {"name": "BackupRestore"}]}]}
    want = jax_run(dict(spec, datadir=str(tmp_path / "jax")))
    got = run_spec(dict(spec, datadir=str(tmp_path / "port")),
                   device="cpu")
    assert want["ok"], want
    assert [p["BackupRestore"]["ok"] for p in want["phases"][1:]] == [True]
    assert dict(got, datadir=None) == dict(want, datadir=None)


@pytest.mark.parametrize("chunk", range(2))
def test_runnable_draws_apply_on_the_port_knobs(chunk):
    """Every knob any seed draws exists in the port's registry and
    takes the drawn value (the backend names included); the undo puts
    every knob back."""
    from foundationdb_tpu_torch.core.knobs import CLIENT_KNOBS, SERVER_KNOBS
    from foundationdb_tpu_torch.workloads.tester import _apply_knobs

    before = (SERVER_KNOBS.all(), CLIENT_KNOBS.all())
    for seed in SEEDS[chunk::2]:
        spec = pcfg.generate_config(seed)
        undo = _apply_knobs(spec["knobs"])
        try:
            from foundationdb_tpu_torch.resolver.factory import (
                validate_conflict_set_impl,
            )
            from foundationdb_tpu_torch.storage_engine.factory import (
                validate_storage_engine_impl,
            )

            validate_conflict_set_impl()
            validate_storage_engine_impl()
        finally:
            undo()
        assert (SERVER_KNOBS.all(), CLIENT_KNOBS.all()) == before, seed


def test_run_randomized_logs_every_seed_it_does_not_run():
    """Seeds 2, 4 and 7 draw BackupRestore (2 and 7 on the durable tier):
    each runs on the device backends (device="cpu") and passes, its
    config and result logged, and none is left out."""
    lines = []
    results = pcfg.run_randomized([2, 4, 7], log=lines.append,
                                  device="cpu")
    assert [r["ok"] for r in results] == [True] * 3
    assert [r["BackupRestore"]["ok"] for r in results] == [True] * 3
    for seed in (2, 4, 7):
        assert f"[sim seed {seed}] ok=True sev_errors=0 " in lines
    assert not [ln for ln in lines if "not run" in ln]
