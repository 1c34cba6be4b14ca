"""Coverage-guided simulation swarm: parallel randomized-config sweeps at
O(1000)-seed scale (ref: the reference's nightly correctness fleet —
thousands of seeds through SimulatedCluster.actor.cpp:696, each failure
reproducible from its seed; coverage GUIDANCE is this repo's step beyond
that blind fleet, in the spirit of coverage-guided fuzzing).

    python -m foundationdb_tpu_torch.sim.swarm --budget 200 --jobs 4
    python -m foundationdb_tpu_torch.sim.swarm --budget 200 --jobs 4 --unguided
    python -m foundationdb_tpu_torch.sim.swarm --budget 200 --jobs 4 \
        --compare-unguided --report swarm_report.json
    python -m foundationdb_tpu_torch.sim.swarm --budget 100 --check-determinism
    python -m foundationdb_tpu_torch.sim.swarm --budget 500 --corpus /tmp/c
    python -m foundationdb_tpu_torch.sim.swarm --budget 8 --jobs 2 --device cpu

Every seed's spec is fully materialized BEFORE dispatch
(sim/config.generate_config, optionally steered by a DrawBias built
from the corpus of coverage facets seen so far) and printed on failure:
the printed spec alone reproduces the failure, bias-free. Each run's
coverage signature — cluster-shape draw x knob buckets x workload mix x
trace event types x recovery states x metric-snapshot names — feeds a
corpus; guidance biases the next batch's draws toward the least-covered
buckets (engine x topology joint space included, gated off in unbiased
draws). With --corpus, failures are auto-distilled (sim/distill.py) to
minimal repro specs written as regression-corpus entries into that
directory (the checked-in corpus, specs/regressions/, is replayed by
tests/test_torch_regression_corpus.py).

--check-determinism reruns every green seed and compares BOTH the final
keyspace fingerprint AND the coverage signature: identical seeds must
re-walk the identical trace/recovery/metric surface, so signature
divergence is a determinism bug even when the final keyspace agrees.

Exit status: number of failing seeds, capped at 125 so the true count
can never wrap mod 256 to a false green (the count prints either way).

The port's copy of tools/swarm.py. Every seed runs through the port's
run_spec on --device (default the CUDA card; "cpu" runs the device
backends' plain torch versions) under sim/sweep.py's wall-clock limit
(DEFAULT_WALL_LIMIT seconds a run). Workers come from a spawn pool: each
opens a CUDA context of its own (a forked context is dead), and the
report gives each worker's peak device memory, against which --jobs is
sized, and the probe launches summed over the workers.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import random
import sys

EXIT_CAP = 125  # os.exit truncates to a byte; 125 keeps 126/127/128+n
#                 (shell/-signal conventions) and mod-256 wraps unreachable

_FORCE_KNOBS = 3  # least-covered knob buckets force-drawn per guided seed


def _gate_signature() -> str:
    """Static-gate stamp for repro blocks: which fdblint generation the
    tree passed when this failure was found (tools/fdblint, which imports
    no package of the repo; absent outside a checkout)."""
    try:
        from tools.fdblint import gate_signature
        return gate_signature()
    except Exception:  # noqa: BLE001 — a sweep must not die on lint tooling
        return "fdblint unavailable"


def _pool_init(device=None):
    """Worker bootstrap (spawn context): one torch thread when the seeds
    run on the CPU (the device backends' ops are tiny, and a thread pool
    per worker only contends)."""
    if device is not None and str(device).startswith("cpu"):
        import torch

        torch.set_num_threads(1)


def _device_use() -> tuple:
    """(probe launches so far, peak device bytes reserved) in this
    process; the bytes are 0 without a CUDA context."""
    import torch

    from ..resolver import probe

    peak = (torch.cuda.max_memory_reserved()
            if torch.cuda.is_initialized() else 0)
    return probe.LAUNCHES, peak


def _run_one(item: tuple) -> dict:
    """Run one fully-materialized spec; returns the seed's swarm record.
    Deterministic per spec — any failure reproduces from spec alone."""
    seed, spec, check_det, device = item
    from ..workloads.tester import failure_summary
    from .config import coverage_facets, coverage_signature
    from .sweep import run_seed

    # run_seed turns a crash or a run past DEFAULT_WALL_LIMIT into a
    # failed result: the swarm keeps going and reports it.
    launches0, _ = _device_use()
    res = run_seed(spec, device=device)
    summary = failure_summary(spec, res)
    cls = summary["class"]
    signature = coverage_signature(spec, res)
    if check_det and cls == "pass":
        res2 = run_seed(spec, device=device)
        if res2.get("fingerprint") != res.get("fingerprint"):
            cls = "nondet:fingerprint"
        elif coverage_signature(spec, res2) != signature:
            # Same seed, same keyspace, different coverage surface: the
            # run took a different path — a determinism bug the keyspace
            # fingerprint alone cannot see.
            cls = "nondet:coverage-signature"
    launches, peak = _device_use()
    return {
        "seed": seed,
        "spec": spec,
        "class": cls,
        "ok": cls == "pass",
        "facets": coverage_facets(spec, res),
        "signature": signature,
        "sev_error_events": (res.get("sev_error_events") or [])[:5],
        "error": res.get("error"),
        "fingerprint": res.get("fingerprint"),
        "worker": os.getpid(),
        "launches": launches - launches0,
        "device_peak_bytes": peak,
    }


class CoverageCorpus:
    """Facet-count corpus of everything the swarm has seen, and the
    bias builder that steers the next seed toward the least-covered
    buckets of every biasable dimension."""

    def __init__(self):
        self.facet_counts: dict[str, int] = {}
        self.signatures: set[str] = set()

    def add(self, record: dict) -> None:
        self.signatures.add(record["signature"])
        for f in record["facets"]:
            self.facet_counts[f] = self.facet_counts.get(f, 0) + 1

    def _least_covered(self, rng: random.Random, pairs) -> object:
        """pairs: [(value, facet)] -> a uniformly-drawn value among the
        least-seen facets (random tie-break keeps one batch's seeds from
        all piling onto the same preference)."""
        counts = [(self.facet_counts.get(facet, 0), value)
                  for value, facet in pairs]
        m = min(c for c, _ in counts)
        return rng.choice([value for c, value in counts if c == m])

    def bias_for(self, seed: int):
        from .config import (
            _KNOB_CHOICES,
            _KNOB_RANGES,
            BIAS_DIMS,
            OPTIONAL_WORKLOAD_NAMES,
            DrawBias,
            bias_facet,
        )

        # Deterministic per (seed, corpus state at batch start): the
        # batch barrier in run_swarm updates the corpus only between
        # batches, so a swarm rerun rebuilds the identical bias stream.
        rng = random.Random((seed << 1) ^ 0x5EED)
        prefer = {
            dim: self._least_covered(
                rng, [(o, bias_facet(dim, o)) for o in options]
            )
            for dim, options in BIAS_DIMS.items()
        }
        prefer["workload"] = self._least_covered(
            rng, [(n, f"wl.{n}") for n in OPTIONAL_WORKLOAD_NAMES]
        )
        # Rank every knob bucket facet; force-draw the rarest few.
        bucket_pairs = [
            ((f"{reg}:{name}", b), f"knob.{reg}:{name}={b}")
            for name, reg, _span in _KNOB_RANGES
            for b in ("lo", "mid", "hi")
        ] + [
            ((f"{reg}:{name}", c), f"knob.{reg}:{name}={c}")
            for name, reg, choices in _KNOB_CHOICES
            for c in sorted(set(choices))
        ]
        force_knobs, knob_buckets = set(), {}
        for _ in range(_FORCE_KNOBS):
            remaining = [(v, f) for v, f in bucket_pairs
                         if v[0] not in force_knobs]
            key, bucket = self._least_covered(rng, remaining)
            force_knobs.add(key)
            knob_buckets[key] = bucket
        return DrawBias(prefer=prefer, strength=0.7,
                        force_knobs=force_knobs,
                        knob_buckets=knob_buckets,
                        allow_engine_topology=True)


def _shape_line(spec: dict) -> str:
    shape = spec.get("cluster", {})
    topo = shape.get("topology")
    return (f" kind={shape.get('kind', 'local')}"
            f" engine={shape.get('engine', '-')}"
            f" replication={shape.get('replication', '-')}"
            + (f" topology={topo['n_dcs']}x{topo['machines_per_dc']}"
               if topo else ""))


def run_swarm(budget: int, jobs: int, seed_base: int = 0,
              guided: bool = True, check_determinism: bool = False,
              pool=None, log=print, device=None) -> dict:
    """One swarm sweep on `device` (None: the CUDA card); returns the
    report dict. `pool` may be shared across sweeps (--compare-unguided)
    — corpus state never is."""
    from . import config

    corpus = CoverageCorpus()
    records: list[dict] = []
    buckets_by_batch: list[int] = []
    batch_size = max(2 * jobs, 8)
    seeds = list(range(seed_base, seed_base + budget))
    own_pool = pool is None
    if own_pool:
        pool = _make_pool(jobs, device)
    try:
        for start in range(0, len(seeds), batch_size):
            batch = seeds[start:start + batch_size]
            items = []
            for seed in batch:
                bias = corpus.bias_for(seed) if guided else None
                items.append((seed, config.generate_config(seed, bias),
                              check_determinism, device))
            for rec in pool.imap(_run_one, items):
                corpus.add(rec)
                records.append(rec)
                line = (f"[seed {rec['seed']}] "
                        f"{'ok' if rec['ok'] else 'FAIL ' + rec['class']}"
                        f"{_shape_line(rec['spec'])}")
                if not rec["ok"]:
                    if rec.get("error"):
                        line += "\n  error: " + str(rec["error"])
                    for e in rec.get("sev_error_events", [])[:5]:
                        line += "\n  sev-error event: " + json.dumps(
                            e, sort_keys=True, default=str)
                    # gate line BEFORE the spec: the spec stays the
                    # line's tail so `split("repro spec: ")[1]` is pure
                    # JSON (the replay tooling and tests parse it).
                    line += "\n  static gate: " + _gate_signature()
                    line += "\n  repro spec: " + json.dumps(
                        rec["spec"], sort_keys=True, default=str)
                log(line)
            buckets_by_batch.append(len(corpus.facet_counts))
    finally:
        if own_pool:
            pool.close()
            pool.join()

    failures = [r for r in records if not r["ok"]]
    peaks: dict[int, int] = {}
    for r in records:
        w = r.get("worker", 0)
        peaks[w] = max(peaks.get(w, 0), r.get("device_peak_bytes", 0))
    return {
        "mode": "guided" if guided else "unguided",
        "budget": budget,
        "jobs": jobs,
        "seed_base": seed_base,
        "check_determinism": check_determinism,
        "seeds_run": len(records),
        "ok": len(records) - len(failures),
        "failures": [{"seed": r["seed"], "class": r["class"],
                      "spec": r["spec"]} for r in failures],
        "distinct_signatures": len(corpus.signatures),
        "distinct_buckets": len(corpus.facet_counts),
        "buckets_by_batch": buckets_by_batch,
        "records": [{"seed": r["seed"], "class": r["class"],
                     "fingerprint": r.get("fingerprint"),
                     "signature": r["signature"]} for r in records],
        "probe_launches": sum(r.get("launches", 0) for r in records),
        "device_peak_bytes_by_worker": sorted(peaks.values()),
    }


def _make_pool(jobs: int, device=None):
    # Spawned (not forked) workers: a forked CUDA context is dead, so each
    # worker opens its own; spawn costs one import per worker once.
    return mp.get_context("spawn").Pool(jobs, initializer=_pool_init,
                                        initargs=(device,))


def _distill_failures(report: dict, corpus_dir: str, cap: int,
                      origin_prefix: str, log=print,
                      device=None) -> list[str]:
    """Distill up to `cap` failures — one per distinct failure class
    (nondet classes excluded: a non-reproducible failure cannot anchor a
    replayed corpus entry) — and write them as corpus entries into
    `corpus_dir`."""
    from .distill import distill, run_and_classify, write_corpus_entry

    paths: list[str] = []
    seen_classes: set[str] = set()
    for failure in report["failures"]:
        cls = failure["class"]
        if cls.startswith("nondet") or cls in seen_classes:
            continue
        seen_classes.add(cls)
        if len(paths) >= cap:
            log(f"distill cap {cap} reached; "
                f"remaining classes left undistilled")
            break
        log(f"distilling seed {failure['seed']} ({cls}) ...")
        try:
            out = distill(failure["spec"], target_class=cls,
                          log=lambda s: log("  " + s), device=device)
        except ValueError as e:
            # The failure did not reproduce in-process (e.g. an
            # environment-sensitive crash): report, don't write.
            log(f"  distill skipped: {e}")
            continue
        res, _cls = run_and_classify(out["spec"], device)
        path = write_corpus_entry(
            corpus_dir, out["spec"], cls,
            f"{origin_prefix} seed {failure['seed']} "
            f"({out['runs']} shrink runs)", res)
        log(f"  corpus entry: {path}")
        paths.append(path)
    return paths


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--budget", type=int, default=200,
                    help="seeds to run (default 200)")
    ap.add_argument("--jobs", type=int, default=4,
                    help="parallel workers (default 4)")
    ap.add_argument("--seed-base", type=int, default=0,
                    help="first seed (default 0)")
    ap.add_argument("--unguided", action="store_true",
                    help="disable coverage guidance (blind sweep, the "
                         "reference fleet's mode)")
    ap.add_argument("--compare-unguided", action="store_true",
                    help="run the SAME seed range unguided first, then "
                         "guided, and report both bucket counts")
    ap.add_argument("--check-determinism", action="store_true",
                    help="rerun every green seed; keyspace fingerprint "
                         "AND coverage signature must both match")
    ap.add_argument("--report", help="write the JSON report here")
    ap.add_argument("--corpus",
                    help="auto-distill failures into regression-corpus "
                         "entries under this directory")
    ap.add_argument("--distill-cap", type=int, default=3,
                    help="max corpus entries per run (default 3)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="where the seeds run (default: the CUDA card)")
    args = ap.parse_args()

    if sys.flags.hash_randomization:
        print("note: run under PYTHONHASHSEED=0 for cross-process "
              "reproducibility", file=sys.stderr)
    from ..device import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: raise now
    run = dict(check_determinism=args.check_determinism,
               device=args.device)
    pool = _make_pool(args.jobs, args.device)
    try:
        reports = []
        if args.compare_unguided:
            print(f"--- unguided sweep: {args.budget} seeds ---")
            reports.append(run_swarm(
                args.budget, args.jobs, args.seed_base, guided=False,
                pool=pool, **run))
        print(f"--- {'unguided' if args.unguided else 'guided'} sweep: "
              f"{args.budget} seeds ---")
        report = run_swarm(
            args.budget, args.jobs, args.seed_base,
            guided=not args.unguided, pool=pool, **run)
        reports.append(report)
    finally:
        pool.close()
        pool.join()

    if args.corpus and report["failures"]:
        report["corpus_entries"] = _distill_failures(
            report, args.corpus, args.distill_cap,
            f"swarm --budget {args.budget} --seed-base {args.seed_base}",
            device=args.device)

    print("\n=== swarm coverage report ===")
    for r in reports:
        print(f"{r['mode']:>9}: {r['seeds_run']} seeds, {r['ok']} ok, "
              f"{len(r['failures'])} failing | "
              f"{r['distinct_signatures']} distinct signatures, "
              f"{r['distinct_buckets']} distinct coverage buckets | "
              f"{r['probe_launches']} probe launches, peak device MiB "
              f"per worker {[round(b / 2**20, 1) for b in r['device_peak_bytes_by_worker']]}")
    if args.compare_unguided:
        un, gu = reports[0], reports[1]
        delta = gu["distinct_buckets"] - un["distinct_buckets"]
        print(f"guidance delta: {delta:+d} coverage buckets "
              f"({un['distinct_buckets']} -> {gu['distinct_buckets']})")
    failures = report["failures"]
    if failures:
        print(f"{len(failures)} failing seed(s): "
              f"{[f['seed'] for f in failures]}")
        print("re-run one with: python -c \"import json,sys; "
              "from foundationdb_tpu_torch.workloads.tester import "
              "run_spec; print(run_spec(json.load(open(sys.argv[1]))))\" "
              "<spec.json>")
    else:
        print("swarm green")
    if args.report:
        payload = reports[0] if len(reports) == 1 else {
            "unguided": reports[0], "guided": reports[1]}
        with open(args.report, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"report: {args.report}")
    if len(failures) > EXIT_CAP:
        print(f"exit status capped at {EXIT_CAP} "
              f"(true failure count {len(failures)})")
    return min(len(failures), EXIT_CAP)


if __name__ == "__main__":
    sys.exit(main())
