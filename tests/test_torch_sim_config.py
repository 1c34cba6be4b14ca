"""The port's randomized SimulationConfig against the JAX package's.

foundationdb_tpu_torch/sim/config.py keeps the JAX package's draw stream
draw for draw; only the two device knobs' backend names are the port's
(CONFLICT_SET_IMPL: "native" and "tpu" draw "gpu"; STORAGE_ENGINE_IMPL:
"tpu" draws "gpu"). So for every seed, with or without a DrawBias, the
port's spec is the JAX package's with those names mapped, and both
packages' coverage facets, signatures and knob buckets agree on either
spec. `unported_needs` flags exactly the draws that need the durable
tier (an engine, regions) or the backup tier (a backup workload), and a
seed it clears runs on the port's knob registry as drawn.
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


def expected_needs(spec: dict) -> bool:
    names = {w["name"] for w in spec["workloads"]}
    return bool(names & {"BackupRestore", "BackupAttrition"})


def test_unported_needs_flags_exactly_engine_regions_and_backups():
    """Since the durable tier is ported, only the backup workloads are
    flagged: a durable engine, a datadir and regions run."""
    runnable, durable = [], []
    for seed in SEEDS:
        spec = pcfg.generate_config(seed)
        needs = pcfg.unported_needs(spec)
        assert bool(needs) == expected_needs(spec), (seed, needs)
        cluster = spec["cluster"]
        item9 = [n for n in needs if "Queue 1 item 9" in n]
        assert len(item9) == sum(
            w["name"] in ("BackupRestore", "BackupAttrition")
            for w in spec["workloads"]), seed
        assert len(item9) == len(needs)
        assert not any("Queue 1 item 7" in n for n in needs), seed
        if not needs:
            runnable.append(seed)
            if cluster.get("engine") or cluster.get("regions"):
                durable.append(seed)
    # The seeds the port runs, in order (the smoke's [sim] list is taken
    # from the in-memory ones, its [sim-durable] list from the durable).
    assert runnable[:12] == [0, 1, 3, 5, 6, 10, 11, 12, 14, 15, 17, 18]
    assert durable[:8] == [0, 1, 6, 10, 12, 15, 18, 27]
    assert 100 <= len(runnable) <= 140, len(runnable)


def test_unported_needs_of_hand_written_specs():
    assert pcfg.unported_needs({"cluster": {"kind": "local"},
                                "workloads": [{"name": "Cycle"}]}) == []
    (need,) = pcfg.unported_needs(
        {"cluster": {"kind": "restart"}, "phases": [
            {"workloads": [{"name": "BackupRestore"}]}]})
    assert "ROADMAP Queue 1 item 9" in need
    for option in ("engine", "datadir", "os_layer", "regions"):
        assert pcfg.unported_needs(
            {"cluster": {"kind": "recoverable_sharded", option: "x"}}) == []


@pytest.mark.parametrize("chunk", range(2))
def test_runnable_draws_apply_on_the_port_knobs(chunk):
    """Every knob a runnable seed draws exists in the port's registry and
    takes the drawn value (the backend names included); the undo puts
    every knob back."""
    from foundationdb_tpu_torch.core.knobs import CLIENT_KNOBS, SERVER_KNOBS
    from foundationdb_tpu_torch.workloads.tester import _apply_knobs

    before = (SERVER_KNOBS.all(), CLIENT_KNOBS.all())
    for seed in SEEDS[chunk::2]:
        spec = pcfg.generate_config(seed)
        if pcfg.unported_needs(spec):
            continue
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
    lines = []
    # Seeds 2, 4 and 7 all need an unported tier (the backup workloads):
    # nothing runs, each is logged with its reason, and no device is
    # touched.
    assert pcfg.run_randomized([2, 4, 7], log=lines.append,
                               device="cpu") == []
    skipped = [ln for ln in lines if "not run: needs" in ln]
    assert len(skipped) == 3
    assert all("ROADMAP Queue 1 item 9" in ln for ln in skipped)
