"""The server entrypoint (ref: fdbserver/fdbserver.actor.cpp — one binary
hosting every role, selected by `-r`; knobs set via --knob NAME=VALUE).

    python -m foundationdb_tpu_torch.server -r simulation -f spec.json \\
        [--knob NAME=VALUE] [--device cpu]

The port's copy of foundationdb_tpu/server.py, its simulation role only:

  simulation   run a spec file (the workloads/tester format, JSON) under
               the deterministic simulator on the CUDA card (or on the CPU
               with --device cpu) and print the result JSON, or
               {"ok": ..., "seeds": ...} for a randomized spec — exit 0
               iff every seed it ran checked out. A spec the port cannot
               run yet (sim/config.unported_needs) exits 1 with the
               NotImplementedError naming its ROADMAP item.
  fdbd, cli    the deployed multi-process tier, not ported (ROADMAP
               Queue 1 item 8): exit 2 with that message.
"""

from __future__ import annotations

import argparse
import json
import sys

DEPLOYED_TIER_MISSING = (
    "-r {role}: the deployed multi-process tier (cluster/multiprocess.py, "
    "net/, cli.py) is not ported, see ROADMAP Queue 1 item 8; the port "
    "runs -r simulation"
)


def _apply_knobs(knob_args: list[str]) -> None:
    from .core.knobs import CLIENT_KNOBS, SERVER_KNOBS

    for ka in knob_args:
        name, _, value = ka.partition("=")
        if not value:
            raise SystemExit(f"--knob {ka!r}: expected NAME=VALUE")
        name = name.upper()
        for knobs in (SERVER_KNOBS, CLIENT_KNOBS):
            try:
                knobs.set_knob(name, value)
                break
            except KeyError:
                continue
            except (TypeError, ValueError) as e:
                raise SystemExit(
                    f"bad value for knob {name}: {value!r} ({e})"
                )
        else:
            raise SystemExit(f"unknown knob {name}")
    # Value-level validation of enum-shaped knobs, EAGERLY at startup: a
    # typo'd CONFLICT_SET_IMPL (or the JAX package's "native"/"tpu") must
    # fail the process here with the known-impl list, not deep inside a
    # resolver's recruitment.
    from .resolver.factory import validate_conflict_set_impl
    from .storage_engine.factory import validate_storage_engine_impl

    try:
        validate_conflict_set_impl()
        validate_storage_engine_impl()
    except ValueError as e:
        raise SystemExit(str(e))


def _spec_from_file(path: str) -> dict:
    with open(path) as f:
        spec = json.load(f)
    # Byte-ish fields arrive as strings in JSON; shard boundaries are the
    # only ones the spec format needs.
    ckw = spec.get("cluster", {})
    if "shard_boundaries" in ckw:
        ckw["shard_boundaries"] = [
            b.encode() if isinstance(b, str) else b
            for b in ckw["shard_boundaries"]
        ]
    return spec


def run_simulation(path: str, device=None) -> int:
    from .workloads.tester import run_spec

    spec = _spec_from_file(path)
    if spec.get("randomized"):
        # Per-seed randomized SimulationConfig (sim/config.py): each seed
        # derives cluster shape + knobs + workload mix deterministically;
        # the printed config IS the reproduction recipe, and every seed
        # the port cannot run yet is printed with its reason. Always
        # emits the one-line JSON contract, even on malformed specs.
        from .sim.config import run_randomized

        try:
            seeds = spec["seeds"]
            run_randomized(seeds, log=lambda m: print(m, file=sys.stderr),
                           device=device)
        except BaseException as e:  # noqa: BLE001 - CI parses stdout
            print(json.dumps(
                {"ok": False, "error": f"{type(e).__name__}: {e}"}
            ))
            return 1
        print(json.dumps({"ok": True, "seeds": seeds}))
        return 0
    try:
        result = run_spec(spec, device=device)
    except NotImplementedError as e:
        print(json.dumps({"ok": False,
                          "error": f"{type(e).__name__}: {e}"}))
        print(f"NotImplementedError: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result, default=str, indent=2))
    return 0 if result.get("ok") and result.get("sev_errors", 0) == 0 else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="foundationdb_tpu_torch.server")
    ap.add_argument("-r", "--role", default="fdbd",
                    choices=["fdbd", "simulation", "cli"])
    ap.add_argument("-f", "--testfile", help="spec file for -r simulation")
    ap.add_argument("--knob", action="append", default=[],
                    metavar="NAME=VALUE", help="set a knob (repeatable)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the device backends run (default: the "
                         "CUDA card, which must be present)")
    args = ap.parse_args(argv)
    _apply_knobs(args.knob)

    if args.role != "simulation":
        print(DEPLOYED_TIER_MISSING.format(role=args.role), file=sys.stderr)
        return 2
    if not args.testfile:
        ap.error("-r simulation requires -f <spec.json>")
    from .device import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 2
    return run_simulation(args.testfile, device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())
