"""The regression corpus (specs/regressions/) replayed on the port.

Every checked-in distilled failure spec runs through the port's run_spec
with device="cpu" (sim/distill.run_and_classify) twice: both runs give
the entry's recorded `expect` class, with equal keyspace fingerprints and
coverage signatures, and the class equals the JAX package's replay of the
same spec (tools/distill.run_and_classify).
"""

from __future__ import annotations

import json
import os

import pytest

from foundationdb_tpu_torch.sim.config import coverage_signature
from foundationdb_tpu_torch.sim.distill import run_and_classify

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS_DIR = os.path.join(REPO_ROOT, "specs", "regressions")


def _entries():
    if not os.path.isdir(CORPUS_DIR):
        return []
    return sorted(f for f in os.listdir(CORPUS_DIR) if f.endswith(".json"))


def test_corpus_is_not_empty():
    assert _entries(), f"no corpus entries under {CORPUS_DIR}"


@pytest.mark.parametrize("name", _entries())
def test_corpus_entry_replays_on_the_port(name):
    import torch

    from tools.distill import run_and_classify as jax_classify

    with open(os.path.join(CORPUS_DIR, name), encoding="utf-8") as f:
        entry = json.load(f)
    spec = entry["spec"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res1, cls1 = run_and_classify(spec, device="cpu")
        res2, cls2 = run_and_classify(spec, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert cls1 == entry["expect"], (
        f"{name}: got {cls1!r}, expected {entry['expect']!r} "
        f"(origin: {entry['origin']})")
    assert cls2 == cls1, f"{name}: failure class is nondeterministic"
    assert res2.get("fingerprint") == res1.get("fingerprint"), \
        f"{name}: keyspace fingerprints diverge across replays"
    assert coverage_signature(spec, res2) == coverage_signature(spec, res1), \
        f"{name}: coverage signatures diverge across replays"
    _, jax_cls = jax_classify(spec)
    assert jax_cls == cls1, f"{name}: the JAX package's replay gives {jax_cls}"
