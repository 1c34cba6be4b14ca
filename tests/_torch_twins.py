"""Run one scenario under both packages, on the CPU, and hand back each
run's result for the test to compare (tests/test_torch_layers.py,
test_torch_backup*.py, test_torch_dr.py, test_torch_api_surface.py).

A scenario is `async def scenario(pkg)`; `pkg` reaches its package's
modules (`pkg.mod("layers.directory")`) and builds its clusters
(`pkg.local()`, `pkg.sharded(...)`), the port's on device="cpu". Each run
has a sim_loop of its own at the same seed, with the package's
CONFLICT_SET_IMPL and STORAGE_ENGINE_IMPL pinned for the run:

- ("jax", "host"): the JAX package, ConflictSetCPU and VersionedMap;
- ("port", "host"): the port with the same host backends;
- ("port", "device"): the port's ConflictSetGPU and KeyValueStoreGPU,
  their plain torch versions on the CPU.
"""

from __future__ import annotations

import importlib

PINS = {
    "host": {"CONFLICT_SET_IMPL": "oracle", "STORAGE_ENGINE_IMPL": "memory"},
    "device": {"CONFLICT_SET_IMPL": "gpu", "STORAGE_ENGINE_IMPL": "gpu"},
}
RUNS = (("jax", "host"), ("port", "host"), ("port", "device"))


class Pkg:
    def __init__(self, which: str, backends: str):
        self.which, self.backends = which, backends
        self.root = ("foundationdb_tpu" if which == "jax"
                     else "foundationdb_tpu_torch")

    def mod(self, name: str):
        return importlib.import_module(f"{self.root}.{name}")

    @property
    def kw(self) -> dict:
        return {"device": "cpu"} if self.which == "port" else {}

    def local(self):
        """A started LocalCluster on this run's backends."""
        cs = None
        if self.backends == "host":
            cs = self.mod("resolver.cpu").ConflictSetCPU()
        return self.mod("cluster.cluster").LocalCluster(cs, **self.kw).start()

    def sharded(self, **kw):
        """A started ShardedKVCluster (its conflict sets and windows from
        the pinned knobs)."""
        return self.mod("cluster.sharded_cluster").ShardedKVCluster(
            **kw, **self.kw).start()


def run_twins(scenario, seed: int = 12345, runs=RUNS,
              timeout: float = 1e5) -> dict:
    """{(package, backends): the scenario's result} over `runs`."""
    out = {}
    for which, backends in runs:
        pkg = Pkg(which, backends)
        knobs = pkg.mod("core.knobs").SERVER_KNOBS
        rt = pkg.mod("core.runtime")
        saved = {k: getattr(knobs, k) for k in PINS[backends]}
        for k, v in PINS[backends].items():
            setattr(knobs, k, v)
        loop = rt.sim_loop(seed=seed)
        try:
            with rt.loop_context(loop):
                out[(which, backends)] = loop.run(
                    scenario(pkg), timeout_sim_seconds=timeout)
        finally:
            loop.shutdown()
            for k, v in saved.items():
                setattr(knobs, k, v)
    return out


def assert_all_equal(out: dict):
    """Every run's result equals the JAX package's; returns it."""
    want = out[RUNS[0]]
    for key, got in out.items():
        assert got == want, (key, got, want)
    return want
