"""fgnn_tpu_torch must never import jax, flax or optax, nor the JAX package
fgnn_tpu itself (not even its JAX-free modules): it runs on machines that
have none of them and keeps its own copies of what it needs. The same holds
for chip_smoke.py, the port's check on the card, and for the port's
benchmark, bench_torch/, which neither imports the reference's experiment
and tool scripts (``exp.``, ``tools.``)."""
import ast
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "fgnn_tpu_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")
BENCH = os.path.join(REPO, "bench_torch")
FORBIDDEN = ("jax", "flax", "optax", "fgnn_tpu")
# the reference's scripts at the repository's root
SCRIPTS = ("exp", "tools")


def _run(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout


def test_importing_every_module_loads_no_jax():
    out = _run(
        "import importlib, pkgutil, sys\n"
        "import fgnn_tpu_torch\n"
        "for m in pkgutil.walk_packages(fgnn_tpu_torch.__path__, "
        "'fgnn_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('imported', len([m for m in sys.modules "
        "if m.startswith('fgnn_tpu_torch')]))\n"
    )
    assert int(out.split()[-1]) >= 25


def test_chip_smoke_imports_no_jax_package():
    """chip_smoke.py's module and every port module it names load neither
    jax nor fgnn_tpu (its phases import inside functions: collected here
    from its source)."""
    with open(SMOKE) as fh:
        tree = ast.parse(fh.read(), SMOKE)
    mods = sorted({n.module for n in ast.walk(tree)
                   if isinstance(n, ast.ImportFrom) and n.module
                   and n.module.startswith("fgnn_tpu_torch")})
    assert "fgnn_tpu_torch.engine" in mods
    out = _run(
        "import importlib, runpy, sys\n"
        f"runpy.run_path({SMOKE!r}, run_name='chip_smoke_import_check')\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    assert out.split()[0] == "ok"


def _forbidden_imports(path, forbidden=FORBIDDEN):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    found = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names = [node.module]
        found += [(path, n) for n in names if n.split(".")[0] in forbidden]
    return found


def _port_sources(top=PKG):
    for root, _, files in os.walk(top):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_source_file_imports_jax():
    found = []
    for path in _port_sources():
        found += _forbidden_imports(path)
    assert not found, found


def test_chip_smoke_source_imports_no_jax_package(tmp_path):
    """No import statement of chip_smoke.py, at any depth, names a
    forbidden root module; the check itself finds one where it is."""
    assert not _forbidden_imports(SMOKE)
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from fgnn_tpu.config import RunConfig\n")
    assert _forbidden_imports(str(probe)) == [(str(probe), "fgnn_tpu.config")]


@pytest.mark.parametrize("module", [
    "parallel/shuffler.py", "parallel/mesh.py", "parallel/factored.py",
    "parallel/switcher.py", "parallel/async_dp.py", "session.py",
    "examples/train_gnn.py", "tools/factored_epochs.py",
    "parallel/multihost.py", "parallel/factored_multihost.py",
    "examples/train_multihost.py", "examples/train_factored_multihost.py",
    "tools/multiprocess_epochs.py", "exp/fig13.py", "exp/fig14.py",
    "exp/fig15.py", "exp/fig16a.py", "exp/fig17a.py", "exp/table4.py",
    "exp/table5.py", "tools/multichip.py"])
def test_multi_device_modules_import_no_jax(module):
    """The multi-device engines and what drives them are among the scanned
    sources, and none of their imports, at any depth, names a forbidden
    root module."""
    path = os.path.join(PKG, module)
    assert path in set(_port_sources())
    assert not _forbidden_imports(path)


@pytest.mark.parametrize("module", [
    "tools/papers100m_rehearsal.py", "exp/table1_papers100m.py",
    "tools/ukunion_rehearsal.py", "tools/scale_runs.py"])
def test_scale_tools_import_no_jax(module):
    """The papers100M- and uk-union-scale tools are among the scanned
    sources, and none of their imports names a forbidden root module."""
    path = os.path.join(PKG, module)
    assert path in set(_port_sources())
    assert not _forbidden_imports(path)


def test_bench_sources_import_no_jax_package_or_scripts():
    """No import statement of bench_torch/ or of the port names jax, the
    JAX package, or the reference's ``exp`` and ``tools`` scripts; the
    scan finds one where it is."""
    sources = list(_port_sources(BENCH))
    assert os.path.join(BENCH, "run.py") in sources
    found = []
    for path in sources + list(_port_sources()):
        found += _forbidden_imports(path, FORBIDDEN + SCRIPTS)
    assert not found, found
    probe = os.path.join(BENCH, "run.py")
    assert _forbidden_imports(probe, ("bench_torch", "fgnn_tpu_torch"))


def test_importing_the_bench_loads_no_jax_package_or_scripts():
    out = _run(
        "import importlib, pkgutil, sys\n"
        "import bench_torch\n"
        "for m in pkgutil.walk_packages(bench_torch.__path__, "
        "'bench_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + SCRIPTS!r}]\n"
        "assert not bad, bad\n"
        "print('imported', len([m for m in sys.modules "
        "if m.startswith('bench_torch')]))\n"
    )
    assert int(out.split()[-1]) >= 4
