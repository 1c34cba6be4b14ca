"""The port's seed sweeper: run the randomized SimulationConfig (or one
spec) across seeds on the CUDA card and print the REPRODUCING spec for
every failure (ref: the reference's correctness sweep — thousands of
seeds nightly, each failure reproducible from its seed alone).

    python -m foundationdb_tpu_torch.sim.sweep --randomized --seeds 0:40
    python -m foundationdb_tpu_torch.sim.sweep --randomized --seeds 0:40 \\
        --against-cpu --check-determinism
    python -m foundationdb_tpu_torch.sim.sweep --spec specs/chaos_topology.json \\
        --seeds 7,99 --device cpu

--seeds takes "lo:hi" (half-open), a comma list, or a count N (== 0:N).
Every seed is held to a wall-clock limit (--wall-limit seconds): an overrun fails the seed, as
a crash, a SevError or a failed check does.

--check-determinism runs every seed twice: the keyspace fingerprint and
the coverage signature (sim/config.coverage_signature) must match.
--against-cpu also replays every seed in a CPU worker process of its own
with CONFLICT_SET_IMPL=oracle and STORAGE_ENGINE_IMPL=memory pinned (the
host backends; knobs never cross the process boundary), while the card
runs: `ok`, the error, the SevError count, every workload's check result
and metrics (commit and retry counts among them) and the fingerprint must
equal the card's run of the same seed.

Exit status: the number of failing seeds, capped at 125 (a raw count
would wrap mod 256 in the exit byte; the true count always prints).
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Optional

DEFAULT_WALL_LIMIT = 300.0
# The host backends a CPU replay pins (the port's knob names).
HOST_BACKENDS = {
    "server:CONFLICT_SET_IMPL": "oracle",
    "server:STORAGE_ENGINE_IMPL": "memory",
}


def parse_seeds(text: str) -> list[int]:
    if ":" in text:
        lo, hi = text.split(":", 1)
        return list(range(int(lo), int(hi)))
    if "," in text:
        return [int(s) for s in text.split(",") if s]
    return list(range(int(text)))


def pin_knobs(spec: dict, knobs: dict) -> dict:
    """A copy of `spec` whose knob overrides include `knobs` (they win
    over the drawn ones; the draw stream itself is untouched)."""
    return dict(spec, knobs={**(spec.get("knobs") or {}), **knobs})


def seed_spec(seed: int, base: Optional[dict] = None) -> dict:
    """generate_config(seed), or `base` with its seed replaced."""
    if base is None:
        from .config import generate_config

        return generate_config(seed)
    return {**base, "seed": seed}


class SeedTimeout(BaseException):
    """A seed ran past its wall-clock limit (a BaseException, so the
    simulated roles' `except Exception` handlers do not absorb it)."""


@contextmanager
def wall_limit(seconds: Optional[float]):
    """Raise SeedTimeout inside the block once `seconds` of wall time
    have passed, and again every second until the block is left (a role
    that catches BaseException and carries on cannot absorb it). SIGALRM:
    the main thread only. None: no limit."""
    if seconds is None:
        yield
        return
    if threading.current_thread() is not threading.main_thread():
        raise RuntimeError("wall_limit needs the main thread (SIGALRM)")

    def expire(signum, frame):
        raise SeedTimeout(f"ran past its wall-clock limit of {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds, 1.0)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def run_seed(spec: dict, device=None,
             limit: Optional[float] = DEFAULT_WALL_LIMIT) -> dict[str, Any]:
    """run_spec(spec, device) under a wall-clock limit. A crash or an
    overrun is a result, {"ok": False, "error": "Type: message"}; every
    result carries its "wall_s"."""
    from ..workloads.tester import run_spec

    t0 = time.perf_counter()
    try:
        with wall_limit(limit):
            res = run_spec(spec, device=device)
    except (Exception, SeedTimeout) as e:  # noqa: BLE001 — a crashed or
        # overrun seed is a failed seed
        res = {"ok": False, "error": f"{type(e).__name__}: {e}"}
    res["wall_s"] = time.perf_counter() - t0
    return res


def seed_passed(res: dict) -> bool:
    """The sweep's gate: the checks passed and no SevError was logged."""
    return bool(res.get("ok")) and not res.get("sev_errors")


def outcome(res: dict) -> dict[str, Any]:
    """What two backends must agree on for one seed: ok, the error, the
    SevError count, the fingerprint, and every workload's entry (its
    check result and metrics: commit, retry and move counts); for a
    restart spec, each phase's workload entries, power-loss havoc and
    carried state, as "phase<i>.<name>". Coverage is left out: the device
    backends register metrics of their own."""
    out = {key: res.get(key)
           for key in ("ok", "error", "sev_errors", "fingerprint")}
    out["workloads"] = {
        key: value for key, value in res.items()
        if isinstance(value, dict) and key != "coverage"
    }
    for i, phase in enumerate(res.get("phases") or []):
        for key, value in phase.items():
            if isinstance(value, dict) and key != "coverage":
                out["workloads"][f"phase{i}.{key}"] = value
        out["workloads"][f"phase{i}.state"] = {
            key: phase.get(key) for key in ("ok", "state_carried",
                                            "refused_incompatible",
                                            "sev_errors")}
    # One JSON form for both sides of a process boundary.
    return json.loads(json.dumps(out, sort_keys=True, default=str))


def mismatches(a: dict, b: dict) -> list[str]:
    """The keys (workload names for per-workload entries) on which two
    outcomes differ."""
    bad = [k for k in ("ok", "error", "sev_errors", "fingerprint")
           if a[k] != b[k]]
    wa, wb = a["workloads"], b["workloads"]
    bad += sorted(k for k in set(wa) | set(wb) if wa.get(k) != wb.get(k))
    return bad


def determinism_mismatch(spec: dict, a: dict, b: dict) -> Optional[str]:
    """Why two runs of one spec are not the same replay, or None."""
    from .config import coverage_signature

    if a.get("fingerprint") != b.get("fingerprint"):
        return "fingerprints differ"
    if coverage_signature(spec, a) != coverage_signature(spec, b):
        return "coverage signatures differ"
    return None


def _cpu_worker(inq, outq, limit) -> None:
    """Replay each (key, spec) on the CPU with the host backends pinned;
    put back (key, outcome, wall_s). None ends the worker."""
    while True:
        item = inq.get()
        if item is None:
            return
        key, spec = item
        res = run_seed(pin_knobs(spec, HOST_BACKENDS), device="cpu",
                       limit=limit)
        outq.put((key, outcome(res), res["wall_s"]))


class CpuReplays:
    """A CPU worker process fed specs while the card runs (the pattern of
    the smoke's StreamingReplays): its own knobs, its own loop, the host
    backends pinned. `send` queues a spec under a key; `result(key)`
    waits for that key's (outcome, wall_s)."""

    def __init__(self, limit: Optional[float] = DEFAULT_WALL_LIMIT):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.inq, self.outq = ctx.Queue(), ctx.Queue()
        self.proc = ctx.Process(target=_cpu_worker,
                                args=(self.inq, self.outq, limit),
                                daemon=True)
        self.proc.start()
        self._done: dict = {}

    def send(self, key, spec: dict) -> None:
        self.inq.put((key, spec))

    def result(self, key, timeout: Optional[float] = None):
        """(outcome, wall_s) of `key`; raises TimeoutError past
        `timeout` seconds or when the worker died."""
        import queue

        deadline = None if timeout is None else time.monotonic() + timeout
        while key not in self._done:
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                raise TimeoutError(f"no CPU replay of {key!r} in time")
            try:
                k, out, wall = self.outq.get(
                    timeout=5.0 if left is None else min(5.0, left))
            except queue.Empty:
                if not self.proc.is_alive():
                    raise TimeoutError(
                        f"the CPU replay worker died before {key!r}")
                continue
            self._done[k] = (out, wall)
        return self._done.pop(key)

    def close(self) -> None:
        if self.proc.is_alive():
            self.inq.put(None)
            self.proc.join(timeout=30)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join()

    def __enter__(self) -> "CpuReplays":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def sweep(seeds, base: Optional[dict] = None, device=None,
          check_determinism: bool = False, against_cpu: bool = False,
          limit: Optional[float] = DEFAULT_WALL_LIMIT,
          log=print) -> list[dict[str, Any]]:
    """Run every seed; one record per seed: {"seed", "ok", "detail",
    "wall_s", ...}. Logs a line per seed and the repro spec of a
    failure."""
    from ..device import resolve_device

    resolve_device(device)
    specs = {seed: seed_spec(seed, base) for seed in seeds}
    replays = CpuReplays(limit) if against_cpu else None
    records = []
    try:
        if replays is not None:
            for seed in seeds:
                replays.send(seed, specs[seed])
        for seed in seeds:
            spec = specs[seed]
            res = run_seed(spec, device=device, limit=limit)
            ok, detail = seed_passed(res), []
            rec = {"seed": seed, "wall_s": res["wall_s"]}
            if ok and check_determinism:
                res2 = run_seed(spec, device=device, limit=limit)
                why = (determinism_mismatch(spec, res, res2)
                       if seed_passed(res2) else "the rerun failed")
                if why:
                    ok = False
                    detail.append(f"NON-DETERMINISTIC: {why}")
            if replays is not None:
                cpu, cpu_wall = replays.result(seed)
                rec["cpu_wall_s"] = cpu_wall
                bad = mismatches(outcome(res), cpu)
                if bad:
                    ok = False
                    detail.append("differs from its CPU replay in "
                                  + ",".join(bad))
            rec.update(ok=ok, detail=detail, error=res.get("error"),
                       fingerprint=res.get("fingerprint"))
            records.append(rec)
            impl = spec.get("knobs", {})
            shape = spec.get("cluster", {})
            line = (f"[seed {seed}] {'ok' if ok else 'FAIL'}"
                    + (f" ({'; '.join(detail)})" if detail else "")
                    + f" kind={shape.get('kind', 'local')}"
                    f" conflict_set="
                    f"{impl.get('server:CONFLICT_SET_IMPL', 'default')}"
                    f" storage="
                    f"{impl.get('server:STORAGE_ENGINE_IMPL', 'default')}"
                    f" wall_s={res['wall_s']:.2f}"
                    + (f" cpu_wall_s={rec['cpu_wall_s']:.2f}"
                       if "cpu_wall_s" in rec else ""))
            if not ok:
                if res.get("error"):
                    line += "\n  error: " + str(res["error"])
                for e in (res.get("sev_error_events") or [])[:10]:
                    line += "\n  sev-error event: " + json.dumps(
                        e, sort_keys=True, default=str)
                line += "\n  repro spec: " + json.dumps(
                    spec, sort_keys=True, default=str)
            log(line)
    finally:
        if replays is not None:
            replays.close()
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="foundationdb_tpu_torch.sim.sweep",
        description=__doc__.split("\n")[0])
    ap.add_argument("--spec", help="spec JSON (workloads/tester format); "
                                   "its 'seed' field is overridden per run")
    ap.add_argument("--randomized", action="store_true",
                    help="derive each seed's spec via sim.config."
                         "generate_config instead of --spec")
    ap.add_argument("--seeds", default="20",
                    help='"lo:hi", "a,b,c", or a count N (default 20)')
    ap.add_argument("--check-determinism", action="store_true",
                    help="run every seed twice; fingerprints and "
                         "coverage signatures must match")
    ap.add_argument("--against-cpu", action="store_true",
                    help="replay every seed in a CPU worker with the host "
                         "backends pinned; outcomes must match")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the device backends run (default: the "
                         "CUDA card, which must be present)")
    ap.add_argument("--wall-limit", type=float, default=DEFAULT_WALL_LIMIT,
                    help="seconds of wall time per seed run "
                         f"(default {DEFAULT_WALL_LIMIT:g})")
    args = ap.parse_args(argv)
    if bool(args.spec) == bool(args.randomized):
        ap.error("exactly one of --spec / --randomized is required")
    base = None
    if args.spec:
        from ..server import _spec_from_file

        base = _spec_from_file(args.spec)
    records = sweep(parse_seeds(args.seeds), base=base, device=args.device,
                    check_determinism=args.check_determinism,
                    against_cpu=args.against_cpu, limit=args.wall_limit,
                    log=lambda m: print(m, flush=True))
    failures = [r["seed"] for r in records if not r["ok"]]
    print(f"\n{len(records)} seed(s) run, {len(failures)} failing: "
          f"{failures}")
    if len(failures) > 125:
        print(f"exit status capped at 125 "
              f"(true failure count {len(failures)})")
    return min(len(failures), 125)


if __name__ == "__main__":
    sys.exit(main())
