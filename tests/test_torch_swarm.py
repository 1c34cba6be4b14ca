"""The port's coverage-guided swarm and failure distiller
(foundationdb_tpu_torch/sim/swarm.py and sim/distill.py) on the CPU.

The swarm and distiller cases of tests/test_swarm.py, run on the port
with device="cpu" (the device backends' plain torch versions): run and
classify, determinism of class, fingerprint and signature, the distiller
shrinking to the bare fault stanza, corpus entries (into tmp_path only),
the corpus bias, and the runner's report with an inline pool. Against the
JAX package: the same failure classes, the same distilled spec and shrink
steps, and the same preferred shape in the corpus bias. One case runs a
real spawn pool.
"""

from __future__ import annotations

import copy
import json
import os

import pytest

from foundationdb_tpu_torch.sim import swarm as swarm_mod
from foundationdb_tpu_torch.sim.config import (
    BIAS_DIMS,
    OPTIONAL_WORKLOAD_NAMES,
    bias_facet,
    coverage_facets,
    coverage_signature,
    generate_config,
)
from foundationdb_tpu_torch.sim.distill import (
    distill,
    run_and_classify,
    write_corpus_entry,
)
from foundationdb_tpu_torch.sim.swarm import (
    EXIT_CAP,
    CoverageCorpus,
    _distill_failures,
    run_swarm,
)

# tests/test_swarm.py's deliberately failing spec: plain sharded data
# plane, a small Cycle, a knob override and an armed SyntheticFault — the
# distiller must strip everything but the fault.
FAILING_SPEC = {
    "seed": 7,
    "cluster": {"kind": "sharded", "n_storage": 3, "n_logs": 1,
                "replication": "single"},
    "knobs": {"server:COMMIT_TRANSACTION_BATCH_COUNT_MAX": 8,
              "client:MAX_BATCH_SIZE": 16},
    "workloads": [
        {"name": "Cycle", "nodes": 6, "clients": 2, "txns": 4},
        {"name": "Watches", "pairs": 2, "rounds": 1},
        {"name": "SyntheticFault", "mode": "check_fail", "arm": True},
    ],
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def classify(spec):
    return run_and_classify(spec, device="cpu")


# -- run + classification ----------------------------------------------

def test_run_and_classify_the_failing_spec():
    res, cls = classify(FAILING_SPEC)
    assert cls == "check:SyntheticFault"
    assert res["ok"] is False
    # Coverage summary rides every tester result.
    cov = res["coverage"]
    assert cov["trace_event_types"] and cov["metric_names"]


def test_run_and_classify_pass_and_crash():
    passing = copy.deepcopy(FAILING_SPEC)
    passing["workloads"] = [w for w in passing["workloads"]
                            if w["name"] != "SyntheticFault"]
    _, cls = classify(passing)
    assert cls == "pass"
    crashing = copy.deepcopy(FAILING_SPEC)
    crashing["workloads"][-1]["mode"] = "crash"
    _, cls = classify(crashing)
    assert cls == "crash:RuntimeError"


def test_classes_equal_the_jax_packages():
    from tools.distill import run_and_classify as jax_classify

    crashing = copy.deepcopy(FAILING_SPEC)
    crashing["workloads"][-1]["mode"] = "crash"
    for spec in (FAILING_SPEC, crashing):
        assert classify(spec)[1] == jax_classify(spec)[1]


def test_replay_is_deterministic_fingerprint_and_signature():
    res1, _ = classify(FAILING_SPEC)
    res2, _ = classify(FAILING_SPEC)
    assert res1.get("fingerprint") == res2.get("fingerprint")
    assert coverage_signature(FAILING_SPEC, res1) \
        == coverage_signature(FAILING_SPEC, res2)


def test_run_without_a_card_raises_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res, cls = run_and_classify(FAILING_SPEC)  # device None: the card
    assert cls.startswith("crash:") and "CUDA" in res["error"]


# -- distiller ----------------------------------------------------------

def test_distiller_shrinks_to_minimal_failing_repro():
    out = distill(FAILING_SPEC, budget=60, device="cpu")
    minimal = out["spec"]
    # Still fails, with the same class.
    _, cls = classify(minimal)
    assert cls == "check:SyntheticFault" == out["class"]
    # Everything not load-bearing is gone: the fault stanza alone
    # remains, and both knob overrides dropped.
    assert [w["name"] for w in minimal["workloads"]] == ["SyntheticFault"]
    assert "knobs" not in minimal
    # The input spec is never mutated.
    assert [w["name"] for w in FAILING_SPEC["workloads"]] \
        == ["Cycle", "Watches", "SyntheticFault"]


def test_distiller_takes_the_jax_packages_steps():
    """With the class known up front the shrink is the same walk in both
    packages: the same accepted steps to the same minimal spec."""
    from tools.distill import distill as jax_distill

    want = jax_distill(FAILING_SPEC, target_class="check:SyntheticFault",
                       budget=12)
    got = distill(FAILING_SPEC, target_class="check:SyntheticFault",
                  budget=12, device="cpu")
    assert got["steps"] == want["steps"] and got["runs"] == want["runs"]
    assert got["spec"] == want["spec"]


def test_distiller_rejects_passing_spec():
    passing = copy.deepcopy(FAILING_SPEC)
    passing["workloads"] = [w for w in passing["workloads"]
                            if w["name"] != "SyntheticFault"]
    with pytest.raises(ValueError):
        distill(passing, budget=10, device="cpu")


def test_distiller_respects_budget():
    out = distill(FAILING_SPEC, budget=3, device="cpu")
    assert out["runs"] <= 3
    _, cls = classify(out["spec"])
    assert cls == "check:SyntheticFault"


def test_write_corpus_entry_fields(tmp_path):
    path = write_corpus_entry(str(tmp_path), FAILING_SPEC,
                              "check:SyntheticFault", "unit test")
    assert os.path.dirname(path) == str(tmp_path)
    with open(path, encoding="utf-8") as f:
        entry = json.load(f)
    assert entry["seed"] == 7
    assert entry["origin"] == "unit test"
    assert entry["expect"] == "check:SyntheticFault"
    assert entry["spec"] == FAILING_SPEC
    assert entry["signature"] == coverage_signature(FAILING_SPEC)


# -- corpus-driven bias --------------------------------------------------

def _record(spec, facets):
    return {"seed": spec.get("seed", 0), "spec": spec, "class": "pass",
            "ok": True, "facets": list(facets),
            "signature": coverage_signature(spec)}


def test_corpus_bias_is_deterministic_per_seed_and_state():
    c1, c2 = CoverageCorpus(), CoverageCorpus()
    spec = generate_config(1)
    for c in (c1, c2):
        c.add(_record(spec, coverage_facets(spec)))
    b1, b2 = c1.bias_for(9), c2.bias_for(9)
    assert b1.prefer == b2.prefer
    assert b1.force_knobs == b2.force_knobs
    assert b1.knob_buckets == b2.knob_buckets
    assert b1.allow_engine_topology


def test_corpus_bias_equals_the_jax_packages():
    """Same corpus state, same seed: the same preferred shape and
    workload. (The forced knob buckets may differ: CONFLICT_SET_IMPL's
    choices carry the port's names, gpu and oracle, where the JAX
    package has native, oracle and tpu, so the two rank different
    bucket lists.)"""
    from foundationdb_tpu.sim.config import generate_config as jax_generate
    from tools.swarm import CoverageCorpus as JaxCorpus

    port, jax = CoverageCorpus(), JaxCorpus()
    for seed in (1, 2):
        spec = jax_generate(seed)
        rec = _record(spec, coverage_facets(spec))
        port.add(rec)
        jax.add(rec)
    for seed in (3, 9, 40):
        b, jb = port.bias_for(seed), jax.bias_for(seed)
        assert b.prefer == jb.prefer
        assert len(b.force_knobs) == len(jb.force_knobs) == 3


def test_corpus_bias_prefers_uncovered_options():
    corpus = CoverageCorpus()
    # Saturate every kind/engine option except the sharded kind and the
    # ssd engine; the bias must then prefer exactly those.
    for dim, covered in (("kind", ("recoverable_sharded",)),
                        ("engine", (None, "memory"))):
        for value in covered:
            corpus.facet_counts[bias_facet(dim, value)] = 50
    for seed in range(10):
        bias = corpus.bias_for(seed)
        assert bias.prefer["kind"] == "sharded"
        assert bias.prefer["engine"] == "ssd"
        assert bias.prefer["workload"] in OPTIONAL_WORKLOAD_NAMES
        assert set(bias.prefer) >= set(BIAS_DIMS)


def test_corpus_bias_tiebreak_varies_by_seed():
    corpus = CoverageCorpus()  # empty: every option ties at zero
    drawn = {corpus.bias_for(seed).prefer["workload"]
             for seed in range(40)}
    assert len(drawn) > 1  # not every seed chases the same bucket


# -- swarm runner (inline pool: no worker processes) --------------------

class _InlinePool:
    def imap(self, fn, items):
        return [fn(i) for i in items]


def _fake_run_one(item):
    seed, spec, _check, device = item
    assert device == "cpu"
    # Seed 13 "fails"; facets vary per seed so buckets accumulate.
    ok = seed != 13
    return {"seed": seed, "spec": spec,
            "class": "pass" if ok else "check:Synthetic",
            "ok": ok, "facets": [f"shape.kind=k{seed % 3}",
                                 f"knob.server:X={seed % 2}"],
            "signature": f"sig{seed}", "sev_error_events": [],
            "error": None, "fingerprint": f"fp{seed}",
            "worker": seed % 2, "launches": seed,
            "device_peak_bytes": seed << 20}


def test_run_swarm_report_and_failures(monkeypatch):
    monkeypatch.setattr(swarm_mod, "_run_one", _fake_run_one)
    lines = []
    report = run_swarm(budget=16, jobs=2, seed_base=8, guided=True,
                       pool=_InlinePool(), log=lines.append, device="cpu")
    assert report["seeds_run"] == 16
    assert report["ok"] == 15
    assert [f["seed"] for f in report["failures"]] == [13]
    # The failing line prints the repro spec verbatim.
    fail_lines = [ln for ln in lines if "FAIL" in ln]
    assert len(fail_lines) == 1
    assert json.loads(fail_lines[0].split("repro spec: ", 1)[1]) \
        == report["failures"][0]["spec"]
    assert report["distinct_signatures"] == 16
    assert report["distinct_buckets"] == 5  # 3 kinds + 2 knob buckets
    assert report["buckets_by_batch"][-1] == 5
    assert report["mode"] == "guided"
    # the device use: launches summed, the peak per worker
    assert report["probe_launches"] == sum(range(8, 24))
    assert report["device_peak_bytes_by_worker"] == [22 << 20, 23 << 20]
    assert [r["fingerprint"] for r in report["records"]] == [
        f"fp{s}" for s in range(8, 24)]


def test_swarm_auto_distills_failures_into_corpus(tmp_path):
    report = {"failures": [
        # Nondet failures cannot anchor a replayed corpus entry.
        {"seed": 3, "class": "nondet:fingerprint", "spec": {}},
        {"seed": 7, "class": "check:SyntheticFault",
         "spec": copy.deepcopy(FAILING_SPEC)},
        # Same class again: deduped, not distilled twice.
        {"seed": 8, "class": "check:SyntheticFault",
         "spec": copy.deepcopy(FAILING_SPEC)},
    ]}
    paths = _distill_failures(report, str(tmp_path), cap=2,
                              origin_prefix="unit swarm",
                              log=lambda s: None, device="cpu")
    assert len(paths) == 1
    assert os.listdir(tmp_path) == [os.path.basename(paths[0])]
    with open(paths[0], encoding="utf-8") as f:
        entry = json.load(f)
    assert entry["expect"] == "check:SyntheticFault"
    assert entry["seed"] == 7
    assert "unit swarm seed 7" in entry["origin"]
    # The written spec is the DISTILLED minimum, not the input.
    assert [w["name"] for w in entry["spec"]["workloads"]] \
        == ["SyntheticFault"]


def test_run_swarm_unguided_passes_no_bias(monkeypatch):
    import foundationdb_tpu_torch.sim.config as config_mod

    seen_bias = []
    real_generate = generate_config

    def spy(seed, bias=None):
        seen_bias.append(bias)
        return real_generate(seed)

    monkeypatch.setattr(swarm_mod, "_run_one", _fake_run_one)
    monkeypatch.setattr(config_mod, "generate_config", spy)
    run_swarm(budget=4, jobs=2, guided=False, pool=_InlinePool(),
              log=lambda s: None, device="cpu")
    assert seen_bias == [None] * 4
    seen_bias.clear()
    run_swarm(budget=4, jobs=2, guided=True, pool=_InlinePool(),
              log=lambda s: None, device="cpu")
    assert all(b is not None for b in seen_bias)
    assert all(b.allow_engine_topology for b in seen_bias)


# -- the real spawn pool -------------------------------------------------

def test_run_swarm_in_a_spawn_pool_checks_determinism():
    """Two guided seeds on one spawned worker, each run twice: both pass
    with their rerun's fingerprint and signature equal, in another
    process than this one."""
    lines = []
    report = run_swarm(budget=2, jobs=1, seed_base=5, guided=True,
                       check_determinism=True, log=lines.append,
                       device="cpu")
    assert report["seeds_run"] == 2 and report["ok"] == 2, lines
    assert all(r["class"] == "pass" for r in report["records"])
    assert len(report["device_peak_bytes_by_worker"]) == 1
    assert report["device_peak_bytes_by_worker"] == [0]  # no card here


def test_exit_status_is_capped():
    assert EXIT_CAP == 125
