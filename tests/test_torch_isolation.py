"""The port stands alone: nothing under foundationdb_tpu_torch/ and nothing
in its scripts chip_smoke.py, probe_bench.py and multiprocess_load_bench.py
imports jax, jaxlib or the JAX package foundationdb_tpu (not even its
pure-numpy modules), and importing every module of the port loads none
of them."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "foundationdb_tpu"}


def port_sources():
    return sorted((ROOT / "foundationdb_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "probe_bench.py",
        ROOT / "multiprocess_load_bench.py",
    ]


def absolute_imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: p.name)
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in absolute_imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    import foundationdb_tpu_torch

    mods = [m.name for m in pkgutil.walk_packages(
        foundationdb_tpu_torch.__path__, "foundationdb_tpu_torch.")]
    assert "foundationdb_tpu_torch.resolver.gpu" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke, probe_bench, multiprocess_load_bench\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_the_port_loads_no_library_under_native():
    """The port builds its own libraries into build/native/ and never
    loads the JAX package's `make` products (native/*.so): after the
    host tier, the envelope, the durable tier and the C client are loaded
    in a fresh process, no file under native/ is mapped."""
    code = (
        "from foundationdb_tpu_torch import native\n"
        "from foundationdb_tpu_torch.resolver.native_cpu import "
        "ConflictSetNativeCPU\n"
        "from foundationdb_tpu_torch.storage_engine import _native\n"
        "native.prepare()\n"
        "ConflictSetNativeCPU(0)\n"
        "_native.load(); _native.load_c_client()\n"
        "maps = open('/proc/self/maps').read()\n"
        "print('\\n'.join(sorted({ln.split()[-1] for ln in maps.splitlines()"
        " if ln.rstrip().endswith('.so')})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    mapped = out.stdout.split()
    ours = [p for p in mapped if p.startswith(str(ROOT / "build" / "native"))]
    assert len(ours) == 4, mapped
    assert not [p for p in mapped if p.startswith(str(ROOT / "native"))]
