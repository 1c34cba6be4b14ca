"""Restart specs on the port (workloads/tester.run_restart_spec): a durable
cluster runs workloads, its incarnation ends (a clean stop, or a power
loss over the simulated disk), and a fresh incarnation on the preserved
datadir must serve the identical state and keep passing workloads; a
phase at an older durable format than the files on disk refuses.

Each spec runs through both packages' run_spec on the CPU with the host
back ends pinned on both sides, and the whole result must be equal (but
the datadir's path): specs/restart_cycle.json (ssd), specs/upgrade_cycle.json
(memory, format versions 2 -> 3), the two-engine restart of
tests/test_restart_spec.py, the upgrade, downgrade and power-loss restarts
of tests/test_upgrade_formats.py. The port's device back ends
(ConflictSetGPU and KeyValueStoreGPU, device="cpu", every window restored
from its engine) give its host back ends' phases and fingerprint.
"""

import json
import os

import pytest

from foundationdb_tpu.workloads.tester import run_spec as jax_run_spec
from foundationdb_tpu_torch.workloads.tester import SpecError, run_spec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = {"server:CONFLICT_SET_IMPL": "oracle",
        "server:STORAGE_ENGINE_IMPL": "memory"}
DEVICE = {"server:CONFLICT_SET_IMPL": "gpu",
          "server:STORAGE_ENGINE_IMPL": "gpu"}


def _pinned(spec, knobs):
    return dict(json.loads(json.dumps(spec)),
                knobs={**spec.get("knobs", {}), **knobs})


def _checked_in(name):
    with open(os.path.join(ROOT, "specs", name)) as f:
        return json.load(f)


def _mini_phases(fmt1=None, fmt2=None, power_loss=False):
    p1 = {"workloads": [
        {"name": "Cycle", "nodes": 8, "clients": 2, "txns": 8},
    ]}
    p2 = {"workloads": [
        {"name": "Cycle", "nodes": 8, "clients": 2, "txns": 8},
    ]}
    if fmt1:
        p1["format_version"] = fmt1
    if fmt2:
        p2["format_version"] = fmt2
    if power_loss:
        p1["power_loss"] = True
    return [p1, p2]


def _two_engine_spec(engine):
    return {
        "seed": 31, "buggify": True,
        "cluster": {"kind": "restart", "n_storage": 4, "n_logs": 2,
                    "replication": "double", "engine": engine},
        "phases": [
            {"workloads": [
                {"name": "Cycle", "nodes": 12, "clients": 2, "txns": 12},
            ]},
            {"workloads": [
                {"name": "Cycle", "nodes": 12, "clients": 2, "txns": 12},
            ]},
        ],
    }


def _format_spec(fmt1, fmt2):
    return {
        "seed": 19, "buggify": True,
        "cluster": {"kind": "restart", "n_storage": 3, "n_logs": 2,
                    "replication": "double", "engine": "memory"},
        "phases": _mini_phases(fmt1=fmt1, fmt2=fmt2),
    }


SPECS = {
    "restart_cycle": lambda: _checked_in("restart_cycle.json"),
    "upgrade_cycle": lambda: _checked_in("upgrade_cycle.json"),
    "carries_state_memory": lambda: _two_engine_spec("memory"),
    "carries_state_ssd": lambda: _two_engine_spec("ssd"),
    "upgrade_2_to_3": lambda: _format_spec(2, 3),
    "power_loss": lambda: {
        "seed": 31, "buggify": True,
        "cluster": {"kind": "restart", "n_storage": 4, "n_logs": 2,
                    "replication": "double", "engine": "memory"},
        "datadir": "ndsim",  # virtual: lives in the NonDurableOS
        "phases": _mini_phases(power_loss=True),
    },
}


def _run_both(spec, tmp_path):
    """The JAX package's result and the port's, each on its own datadir
    (a real one under tmp_path unless the spec's is virtual)."""
    out = []
    for tag, run in (("jax", jax_run_spec),
                     ("port", lambda s: run_spec(s, device="cpu"))):
        s = _pinned(spec, HOST)
        if s.get("datadir") != "ndsim":
            s["datadir"] = str(tmp_path / tag)
        res = run(s)
        res.pop("datadir")
        out.append(res)
    return out


def _phases(res):
    """What the device and host back ends must agree on per phase: every
    entry but the coverage (the device back ends register metrics of
    their own)."""
    return [{k: v for k, v in p.items() if k != "coverage"}
            for p in res["phases"]]


@pytest.mark.parametrize("name", sorted(SPECS))
def test_restart_spec_equals_the_jax_package(name, tmp_path):
    spec = SPECS[name]()
    want, got = _run_both(spec, tmp_path)
    assert want["ok"], json.dumps(want, default=str)[:1500]
    assert all(p["state_carried"] for p in want["phases"][1:])
    assert got == want
    if name == "power_loss":
        assert "power_loss" in got["phases"][0]   # the havoc ran
    if spec.get("datadir") != "ndsim":
        spec["datadir"] = str(tmp_path / "device")
    device = run_spec(_pinned(spec, DEVICE), device="cpu")
    assert device["ok"] and device["fingerprint"] == got["fingerprint"]
    assert _phases(device) == _phases(got)


def test_downgrade_refusal_equals_the_jax_package(tmp_path):
    """Format 3 then 2: the second incarnation refuses with the typed
    error in both packages, and the refused datadir still boots at 3."""
    want, got = _run_both(_format_spec(3, 2), tmp_path)
    assert not want["ok"] and want["refused_incompatible"]
    assert "IncompatibleProtocolVersion" in want["phases"][-1]["error"]
    assert got == want
    again = _pinned(_format_spec(3, 3), HOST)
    again["datadir"] = str(tmp_path / "port")
    res = run_spec(again, device="cpu")
    assert res["ok"], json.dumps(res, default=str)[:1500]


def test_power_loss_restart_refuses_ssd_engine():
    with pytest.raises(SpecError):
        run_spec({
            "seed": 1,
            "cluster": {"kind": "restart", "n_storage": 3, "n_logs": 1,
                        "replication": "single", "engine": "ssd"},
            "phases": _mini_phases(power_loss=True),
        }, device="cpu")


def test_owned_datadir_is_removed(tmp_path, monkeypatch):
    """A restart spec without a datadir runs on a temporary directory of
    its own, removed after the run."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    res = run_spec(_pinned(_two_engine_spec("memory"), HOST), device="cpu")
    assert res["ok"]
    assert not os.path.exists(res["datadir"])
    assert list(tmp_path.iterdir()) == []
