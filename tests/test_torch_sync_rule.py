"""The port's pipeline-sync rule, checked on the source (AST).

The submit/verdicts contract: a dispatch (ConflictSetGPU.submit /
resolve_async, ShardedConflictSetGPU.submit, KeyValueStoreGPU.submit_reads,
ConflictSetRankFed.resolve_async) enqueues device work and returns without
waiting for the card; the consumption call (verdicts / read_verdicts /
result) is where the host waits. So in resolver/gpu.py, resolver/sharded.py,
storage_engine/gpu_engine.py and resolver/rankfed.py a host-sync call
(`.item()`, `.cpu()`, `.tolist()`, `torch.cuda.synchronize()`, an event's
`.synchronize()`, a handle's `.wait()`, or `torch.tensor(host data,
device=...)`, a copy from pageable memory) may stand only in

- the consumption calls and the functions they call;
- a function no dispatch reaches (host inspection such as entries(),
  hand-over, warm-up);
- the recorded departures (ROADMAP Queue 3): `_refresh_mirror`'s one
  fence/count readback per compaction, and `_grow_width`'s host re-pack
  when a longer key arrives (sharded.py has its own `_refresh_mirror` and
  `_grow_width`); in rankfed.py `_canonical`'s one read of the version
  vector, which a GC round makes (resolve() runs the GC rule before it
  packs, so it is analysed as a dispatch too); and in all three resolver
  modules phase 2's plain version, `phase2_rounds_ref` (one `.item()` per
  round group), which only a CPU tensor reaches: on a CUDA tensor
  phase2.phase2_rounds launches the kernel (phase2_rounds_launch), whose
  path makes no host read and never reaches the plain version.

sharded.py calls the kernels of gpu.py, so its analysis sees gpu.py's
functions too, its own taking precedence where a name is in both; the
three resolver modules see resolver/phase2.py, where phase 2's rounds
are, and gpu.py and sharded.py see resolver/block.py, where the block
kernel's decode, phase 1 and phase 3 are, and resolver/compact.py, where
the compaction's densify, ranks, phase 3 and redistribution are, and
resolver/_launch.py, whose run_entry makes each launch: on a CUDA tensor
each launches its kernel with no host sync and never reaches its plain
version. The storage window sees resolver/probe.py and
storage_engine/read.py (the probe and the read gather) and the rank-fed
set resolver/rankfed_ops.py (its phases 1 and 3), under the same rule.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1] / "foundationdb_tpu_torch"
SYNC_METHODS = {"item", "cpu", "tolist", "synchronize", "wait"}
MODULES = {
    "resolver/gpu.py": {
        "dispatch": {"submit", "resolve_async"},
        "consume": {"verdicts"},
        "departures": {"phase2_rounds_ref", "_refresh_mirror",
                       "_grow_width"},
        "sees": ("resolver/phase2.py", "resolver/block.py",
                 "resolver/compact.py", "resolver/_launch.py"),
    },
    "resolver/sharded.py": {
        "dispatch": {"submit"},
        "consume": {"verdicts"},
        "departures": {"phase2_rounds_ref", "_refresh_mirror",
                       "_grow_width"},
        "sees": ("resolver/phase2.py", "resolver/block.py",
                 "resolver/compact.py", "resolver/_launch.py",
                 "resolver/gpu.py"),
    },
    "storage_engine/gpu_engine.py": {
        "dispatch": {"submit_reads"},
        "consume": {"read_verdicts"},
        "departures": set(),
        "sees": ("resolver/probe.py", "storage_engine/read.py",
                 "resolver/_launch.py"),
    },
    "resolver/rankfed.py": {
        "dispatch": {"resolve_async", "resolve"},
        "consume": {"result"},
        "departures": {"phase2_rounds_ref", "_canonical"},
        "sees": ("resolver/phase2.py", "resolver/rankfed_ops.py",
                 "resolver/_launch.py"),
    },
}


def functions(tree):
    """name -> [FunctionDef] for every function and method (nested
    functions belong to their enclosing function)."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, []).append(node)
    return out


def own_nodes(fn):
    """The nodes of `fn`, nested functions included."""
    return list(ast.walk(fn))


def callees(fn, names):
    """Names of this module's functions that `fn` calls, by bare name or
    as an attribute (`self.x()`, `h.wait()`): an over-approximation."""
    out = set()
    for node in own_nodes(fn):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.id if isinstance(f, ast.Name) else (
                f.attr if isinstance(f, ast.Attribute) else None)
            if name in names:
                out.add(name)
    return out


def closure(roots, fns):
    seen, stack = set(), [r for r in roots if r in fns]
    while stack:
        name = stack.pop()
        if name in seen:
            continue
        seen.add(name)
        for fn in fns[name]:
            stack.extend(callees(fn, fns) - seen)
    return seen


def sync_calls(fn):
    """(line, text) of every host-sync call in `fn`: the methods above,
    and a tensor built from host data straight on a device
    (`torch.tensor(x, device=d)` copies from pageable memory, which
    blocks the host)."""
    out = []
    for node in own_nodes(fn):
        if not isinstance(node, ast.Call) or not isinstance(
                node.func, ast.Attribute):
            continue
        if node.func.attr in SYNC_METHODS and not node.args:
            out.append((node.lineno, ast.unparse(node)))
        elif (node.func.attr in ("tensor", "as_tensor")
              and any(k.arg == "device" for k in node.keywords)):
            out.append((node.lineno, ast.unparse(node)))
    return out


def analyse(rel):
    spec = MODULES[rel]
    fns = {}
    for other in spec.get("sees", ()):
        seen = functions(ast.parse((ROOT / other).read_text(), other))
        for name, defs in seen.items():
            fns.setdefault(name, []).extend(defs)
    fns.update(functions(ast.parse((ROOT / rel).read_text(), rel)))
    reach = closure(spec["dispatch"], fns)
    sinks = closure(spec["consume"], fns)
    return spec, fns, reach, sinks


@pytest.mark.parametrize("rel", sorted(MODULES))
def test_dispatch_path_makes_no_host_sync(rel):
    spec, fns, reach, sinks = analyse(rel)
    assert spec["dispatch"] <= reach and spec["consume"] <= sinks
    bad = []
    for name in sorted(reach - sinks - spec["departures"]):
        for fn in fns[name]:
            bad += [f"{rel}:{line} in {name}: {text}"
                    for line, text in sync_calls(fn)]
    assert not bad, "host syncs on the dispatch path:\n" + "\n".join(bad)


@pytest.mark.parametrize("rel", sorted(MODULES))
def test_recorded_departures_are_on_the_path_and_sync(rel):
    """Each recorded departure is reached by a dispatch and does sync:
    the list names exactly the places where the contract bends."""
    spec, fns, reach, sinks = analyse(rel)
    for name in spec["departures"]:
        assert name in reach, f"{name} is not on the dispatch path"
        assert any(sync_calls(fn) for fn in fns[name]), name


def one_read_per_group(rel):
    _, fns, reach, _ = analyse(rel)
    assert "_phase2_fixed_point" in reach
    (fn,) = fns["phase2_rounds_ref"]
    calls = sync_calls(fn)
    assert [t for _, t in calls if t.endswith(".item()")] == [
        "active.item()"]
    assert len(calls) == 1
    # the read sits inside the round-group loop
    loops = [n for n in ast.walk(fn) if isinstance(n, (ast.For, ast.While))]
    assert any(calls[0][0] in {getattr(m, "lineno", None)
                               for m in ast.walk(loop)} for loop in loops)


def test_phase2_makes_one_item_per_round_group():
    one_read_per_group("resolver/gpu.py")


def test_rankfed_phase2_makes_one_item_per_round_group():
    one_read_per_group("resolver/rankfed.py")


@pytest.mark.parametrize("rel", ["resolver/gpu.py", "resolver/sharded.py",
                                 "resolver/rankfed.py"])
def test_phase2_cuda_branch_never_reaches_the_plain_version(rel):
    """On a CUDA tensor phase2_rounds launches the kernel: the launch's
    path makes no host sync and never calls the plain version, and
    phase2_rounds calls the plain version only under its CPU test."""
    _, fns, reach, _ = analyse(rel)
    assert {"phase2_rounds", "phase2_rounds_launch"} <= reach
    cuda = closure({"phase2_rounds_launch"}, fns)
    assert "phase2_rounds_ref" not in cuda
    assert not [t for name in cuda for fn in fns[name]
                for _, t in sync_calls(fn)]
    (fn,) = fns["phase2_rounds"]
    guarded = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.If) and any(
                isinstance(c, ast.Constant) and c.value == "cpu"
                for c in ast.walk(node.test)):
            guarded |= {id(n) for stmt in node.body for n in ast.walk(stmt)}
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name)
             and n.func.id == "phase2_rounds_ref"]
    assert calls and all(id(c) in guarded for c in calls)


def cpu_guarded_calls(fn, callee):
    """(every call of `callee` in fn, those under an `if` whose test
    names "cpu")."""
    guarded = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.If) and any(
                isinstance(c, ast.Constant) and c.value == "cpu"
                for c in ast.walk(node.test)):
            guarded |= {id(n) for stmt in node.body for n in ast.walk(stmt)}
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == callee]
    return calls, [c for c in calls if id(c) in guarded]


@pytest.mark.parametrize("rel", ["resolver/gpu.py", "resolver/sharded.py"])
@pytest.mark.parametrize("kernel", ["decode_fused", "phase1", "phase3"])
def test_block_cuda_branch_never_reaches_the_plain_version(rel, kernel):
    """On a CUDA tensor block.py's dispatcher launches the kernel: the
    launch's path makes no host sync and never calls a plain version
    (`*_ref`), and the dispatcher calls its plain version only under its
    CPU test."""
    _, fns, reach, _ = analyse(rel)
    launch = f"{kernel}_launch"
    assert {kernel, launch} <= reach
    cuda = closure({launch}, fns)
    assert "run_entry" in cuda
    assert not [name for name in cuda if name.endswith("_ref")]
    assert not [t for name in cuda for fn in fns[name]
                for _, t in sync_calls(fn)]
    (fn,) = fns[kernel]
    calls, guarded = cpu_guarded_calls(fn, f"{kernel}_ref")
    assert calls and calls == guarded


@pytest.mark.parametrize("rel", ["resolver/gpu.py", "resolver/sharded.py"])
@pytest.mark.parametrize("kernel", ["densify", "ranks", "dense_phase3",
                                    "redistribute"])
def test_compact_cuda_branch_never_reaches_the_plain_version(rel, kernel):
    """On a CUDA tensor compact.py's dispatcher launches the kernel: the
    launch's path makes no host sync and never calls a plain version
    (`*_ref`), and the dispatcher calls its plain version only under its
    CPU test."""
    _, fns, reach, _ = analyse(rel)
    launch = f"{kernel}_launch"
    assert {kernel, launch} <= reach
    cuda = closure({launch}, fns)
    assert "run_entry" in cuda
    assert not [name for name in cuda if name.endswith("_ref")]
    assert not [t for name in cuda for fn in fns[name]
                for _, t in sync_calls(fn)]
    (fn,) = fns[kernel]
    calls, guarded = cpu_guarded_calls(fn, f"{kernel}_ref")
    assert calls and calls == guarded


def test_compact_plain_versions_make_no_host_sync():
    """compact.py holds to the no-host-read rule as a whole: submit on a
    CPU set runs its plain versions, so neither they nor the launches
    read the device."""
    fns = functions(ast.parse((ROOT / "resolver/compact.py").read_text()))
    bad = [f"{name}:{line}: {text}" for name, defs in fns.items()
           for fn in defs for line, text in sync_calls(fn)]
    assert not bad, bad


@pytest.mark.parametrize("rel,kernel", [
    ("storage_engine/gpu_engine.py", "read_gather"),
    ("resolver/rankfed.py", "phase1"),
    ("resolver/rankfed.py", "phase3"),
])
def test_read_and_rankfed_cuda_branches_never_reach_the_plain_version(
        rel, kernel):
    """On a CUDA tensor the read gather's (read.py) and the rank-fed
    phases' (rankfed_ops.py) dispatchers launch their kernels: the
    launch's path makes no host sync and never calls a plain version
    (`*_ref`), and the dispatcher calls its plain version only under its
    CPU test."""
    _, fns, reach, _ = analyse(rel)
    launch = f"{kernel}_launch"
    assert {kernel, launch} <= reach
    cuda = closure({launch}, fns)
    assert "run_entry" in cuda
    assert not [name for name in cuda if name.endswith("_ref")]
    assert not [t for name in cuda for fn in fns[name]
                for _, t in sync_calls(fn)]
    (fn,) = fns[kernel]
    calls, guarded = cpu_guarded_calls(fn, f"{kernel}_ref")
    assert calls and calls == guarded


@pytest.mark.parametrize("rel", ["storage_engine/read.py",
                                 "resolver/rankfed_ops.py",
                                 "resolver/probe.py"])
def test_read_and_rankfed_modules_make_no_host_sync(rel):
    """read.py, rankfed_ops.py and probe.py hold to the no-host-read rule
    as a whole: a dispatch on CPU tensors runs their plain versions, so
    neither those nor the launches read the device."""
    fns = functions(ast.parse((ROOT / rel).read_text()))
    bad = [f"{name}:{line}: {text}" for name, defs in fns.items()
           for fn in defs for line, text in sync_calls(fn)]
    assert not bad, bad


def test_rankfed_gc_round_reads_the_version_vector_once():
    """A GC round reads the device once, through `_canonical`; the
    dispatch reads nothing else but phase 2's groups."""
    spec, fns, reach, _ = analyse("resolver/rankfed.py")
    (canon,) = fns["_canonical"]
    assert [t for _, t in sync_calls(canon)] == [
        "self.hv[:self.n].cpu()"]
    (gc_round,) = fns["gc_round"]
    assert callees(gc_round, fns) >= {"_canonical"}
    assert not sync_calls(gc_round)
    (dispatch,) = fns["resolve_async"]
    assert "_canonical" not in closure({"resolve_async"}, fns)
    assert not sync_calls(dispatch)


@pytest.mark.parametrize("stray", [
    "self._d_hmat.sum().item()",
    "torch.tensor(np.zeros(4, np.int32), device=self.device)",
])
def test_the_rule_catches_a_stray_sync(stray):
    """A sync added to a dispatch-path function is flagged."""
    src = (ROOT / "storage_engine/gpu_engine.py").read_text()
    marker = "        self._fold_pending()\n"
    assert marker in src
    bad = src.replace(marker, marker + f"        {stray}\n", 1)
    tree = ast.parse(bad)
    fns = functions(tree)
    reach = closure({"submit_reads"}, fns)
    sinks = closure({"read_verdicts"}, fns)
    found = [t for name in reach - sinks for fn in fns[name]
             for _, t in sync_calls(fn)]
    assert found == [stray]


@pytest.mark.parametrize("stray", [
    "self.n.sum().item()",
    "torch.tensor(np.zeros(4, np.int32), device=self.device)",
])
def test_the_rule_catches_a_stray_sync_in_the_sharded_set(stray):
    """A sync added to the sharded set's block growth (on the dispatch
    path, not a departure) is flagged, with gpu.py's functions in view."""
    src = (ROOT / "resolver/sharded.py").read_text()
    marker = "        S = self.n_shards\n        pad = (NB_out - self.NB) * self.B\n"
    assert marker in src
    bad = src.replace(marker, marker + f"        {stray}\n", 1)
    fns = functions(ast.parse((ROOT / "resolver/gpu.py").read_text()))
    fns.update(functions(ast.parse(bad)))
    reach = closure({"submit"}, fns)
    sinks = closure({"verdicts"}, fns)
    departures = MODULES["resolver/sharded.py"]["departures"]
    found = [t for name in reach - sinks - departures for fn in fns[name]
             for _, t in sync_calls(fn)]
    assert found == [stray]
