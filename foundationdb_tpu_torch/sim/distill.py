"""Failure distiller: shrink a failing tester spec to a minimal repro
(ref: the reference project's practice of hand-minimizing a failing
simulation seed before filing it; this automates the loop in the spirit
of delta debugging / fuzzer testcase minimization).

Given a spec whose run fails with some failure CLASS
(workloads/tester.failure_summary — crash:Type / sev:Types /
check:keys), the distiller greedily applies shrink transformations —
drop a workload stanza, drop a knob override, drop a topology/cluster
dimension, halve a numeric workload parameter — re-running the spec
after each and keeping only candidates that preserve the class. The
fixpoint is the minimal spec: every remaining element is load-bearing
for THIS failure, which is exactly what a regression-corpus entry
should pin.

    python -m foundationdb_tpu_torch.sim.distill failing_spec.json
    python -m foundationdb_tpu_torch.sim.distill failing_spec.json \
        --corpus /tmp/corpus --origin "swarm --budget 200 seed 17" \
        --device cpu

Corpus entries carry the minimal spec plus `seed`, `origin`, the failure
`expect` class and the coverage `signature`; the replay of
specs/regressions/ holds every entry to its recorded class, twice
(tests/test_torch_regression_corpus.py). Entries are written only into
the directory the caller names.

The port's copy of tools/distill.py: every run goes through the port's
run_spec on `device` (None: the CUDA card; "cpu" runs the device
backends' plain torch versions).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import re
import sys
from typing import Any, Callable, Iterator, Optional

# Workload parameters that are COUNTS a shrink may halve toward 1
# (never to 0 — several stanzas treat 0 as "present but disabled",
# which changes semantics rather than shrinking them).
_SHRINKABLE_MIN = 1


def run_and_classify(spec: dict, device=None) -> tuple[dict, str]:
    """One deterministic run of `spec` on `device` -> (result, failure
    class). A raised exception is a failed run with class
    crash:<ExcType>, same contract as the sweep runners."""
    from ..workloads.tester import failure_summary, run_spec

    try:
        res = run_spec(spec, device=device)
    except BaseException as e:  # noqa: BLE001 - a crashed candidate is
        # itself a classifiable outcome the distiller must keep going past
        res = {"ok": False, "error": f"{type(e).__name__}: {e}"}
    return res, failure_summary(spec, res)["class"]


def _workload_lists(spec: dict) -> list[list[dict]]:
    """Every workload list in the spec (top-level, plus per-phase for
    restart specs) — the distiller shrinks them all the same way."""
    lists = []
    if isinstance(spec.get("workloads"), list):
        lists.append(spec["workloads"])
    for phase in spec.get("phases", []):
        if isinstance(phase.get("workloads"), list):
            lists.append(phase["workloads"])
    return lists


def _candidates(spec: dict) -> Iterator[tuple[str, dict]]:
    """Yield (description, candidate-spec) shrink steps, most aggressive
    first: whole workload stanzas, then knob overrides, then cluster
    dimensions, then numeric workload parameters."""
    # 1. Drop one workload stanza.
    for li, wl_list in enumerate(_workload_lists(spec)):
        for wi in range(len(wl_list)):
            cand = copy.deepcopy(spec)
            dropped = _workload_lists(cand)[li].pop(wi)
            yield f"drop workload[{li}] {dropped.get('name', '?')}", cand
    # 2. Drop one knob override.
    for key in sorted(spec.get("knobs") or {}):
        cand = copy.deepcopy(spec)
        del cand["knobs"][key]
        if not cand["knobs"]:
            del cand["knobs"]
        yield f"drop knob {key}", cand
    # 3. Drop topology / cluster dimensions (each with its coupled
    # fields, so the candidate stays a well-formed spec: topology-scoped
    # workloads need the topology stanza; regions imply two_datacenter).
    cluster = spec.get("cluster", {})
    if "topology" in cluster:
        cand = copy.deepcopy(spec)
        del cand["cluster"]["topology"]
        cand["cluster"].pop("regions", None)
        if cand["cluster"].get("replication") == "two_datacenter":
            cand["cluster"]["replication"] = "double"
        for wl_list in _workload_lists(cand):
            wl_list[:] = [w for w in wl_list if w.get("name") not in
                          ("MachineAttrition", "TargetedKill",
                           "RandomClogging")]
        yield "drop topology", cand
    if cluster.get("regions"):
        cand = copy.deepcopy(spec)
        del cand["cluster"]["regions"]
        if cand["cluster"].get("replication") == "two_datacenter":
            cand["cluster"]["replication"] = "double"
        yield "drop regions", cand
    if "engine" in cluster:
        cand = copy.deepcopy(spec)
        del cand["cluster"]["engine"]
        cand["cluster"].pop("datadir", None)
        yield "drop engine", cand
    if "log_replication" in cluster:
        cand = copy.deepcopy(spec)
        del cand["cluster"]["log_replication"]
        yield "drop log_replication", cand
    if spec.get("buggify"):
        cand = copy.deepcopy(spec)
        cand["buggify"] = False
        yield "drop buggify", cand
    for dim, floor in (("n_storage", 3), ("n_logs", 1)):
        if isinstance(cluster.get(dim), int) and cluster[dim] > floor:
            cand = copy.deepcopy(spec)
            cand["cluster"][dim] = floor
            yield f"shrink {dim} -> {floor}", cand
    # 4. Halve numeric workload parameters toward 1.
    for li, wl_list in enumerate(_workload_lists(spec)):
        for wi, w in enumerate(wl_list):
            for param, value in sorted(w.items()):
                if param == "name" or not isinstance(value, int) \
                        or isinstance(value, bool) \
                        or value <= _SHRINKABLE_MIN:
                    continue
                cand = copy.deepcopy(spec)
                _workload_lists(cand)[li][wi][param] = max(
                    _SHRINKABLE_MIN, value // 2
                )
                yield (f"halve {w.get('name', '?')}.{param} "
                       f"{value}->{max(_SHRINKABLE_MIN, value // 2)}"), cand


def distill(spec: dict, target_class: Optional[str] = None,
            budget: int = 150,
            log: Callable[[str], None] = lambda s: None,
            device=None) -> dict[str, Any]:
    """Shrink `spec` while its failure class is preserved.

    Returns {"spec": minimal, "class": cls, "runs": n, "steps": [...]}.
    `budget` caps total run_spec invocations (the initial classification
    included); greedy passes repeat until one full pass accepts nothing.
    """
    runs = 0
    if target_class is None:
        _, target_class = run_and_classify(spec, device)
        runs += 1
    if target_class == "pass":
        raise ValueError("distill: spec does not fail (class 'pass')")
    log(f"distill: target class {target_class!r}")

    current = copy.deepcopy(spec)
    steps: list[str] = []
    changed = True
    while changed and runs < budget:
        changed = False
        # One greedy pass. Acceptance restarts candidate enumeration
        # over the smaller spec, but candidates that failed THIS pass
        # are memoized by description and skipped on restart — without
        # this, every acceptance re-runs the full futile prefix and a
        # knob-heavy spec exhausts the budget before reaching workload
        # parameters. The memo resets between passes: a drop that was
        # class-changing alone can become safe after another shrink.
        failed: set[str] = set()
        progress = True
        while progress and runs < budget:
            progress = False
            for desc, cand in _candidates(current):
                if desc in failed:
                    continue
                if runs >= budget:
                    log(f"distill: run budget {budget} exhausted")
                    break
                _, cls = run_and_classify(cand, device)
                runs += 1
                if cls == target_class:
                    log(f"distill: accepted [{desc}] ({runs} runs)")
                    current = cand
                    steps.append(desc)
                    changed = progress = True
                    break  # re-enumerate over the smaller spec
                failed.add(desc)
    return {"spec": current, "class": target_class, "runs": runs,
            "steps": steps}


def _slug(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", s).strip("_")[:60]


def write_corpus_entry(corpus_dir: str, spec: dict, cls: str,
                       origin: str, result: Optional[dict] = None) -> str:
    """Write one regression-corpus entry into `corpus_dir`; returns its
    path. The replay contract: running `spec` must reproduce `expect`
    with a stable fingerprint + coverage signature. `seed` and `origin`
    are mandatory (fdblint spec-regression-fields).
    """
    from .config import coverage_signature

    os.makedirs(corpus_dir, exist_ok=True)
    entry = {
        "seed": spec.get("seed", 0),
        "origin": origin,
        "expect": cls,
        "signature": coverage_signature(spec, result),
        "spec": spec,
    }
    name = f"{_slug(cls)}_seed{entry['seed']}.json"
    path = os.path.join(corpus_dir, name)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(entry, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("spec", help="failing spec JSON to distill")
    ap.add_argument("--budget", type=int, default=150,
                    help="max run_spec invocations (default 150)")
    ap.add_argument("--corpus",
                    help="write the minimal spec as a regression-corpus "
                         "entry under this directory")
    ap.add_argument("--origin", default="",
                    help="provenance string for the corpus entry "
                         "(default: the distill command line)")
    ap.add_argument("--out", help="also write the bare minimal spec here")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the CUDA card)")
    args = ap.parse_args()

    with open(args.spec) as f:
        spec = json.load(f)
    out = distill(spec, budget=args.budget,
                  log=lambda s: print(s, flush=True), device=args.device)
    minimal, cls = out["spec"], out["class"]
    res, final_cls = run_and_classify(minimal, args.device)
    print(f"minimal spec ({out['runs']} runs, {len(out['steps'])} shrink "
          f"steps, class {cls}):")
    print(json.dumps(minimal, sort_keys=True))
    if final_cls != cls:  # pragma: no cover - distill() guarantees this
        print(f"WARNING: final verification got {final_cls!r}")
        return 2
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(minimal, f, indent=2, sort_keys=True)
            f.write("\n")
    if args.corpus:
        origin = args.origin or ("distill " + os.path.basename(args.spec))
        path = write_corpus_entry(args.corpus, minimal, cls, origin, res)
        print(f"corpus entry: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
