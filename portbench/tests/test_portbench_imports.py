"""Nothing that runs on the card loads JAX or the JAX package: the check is
by each module's top-level name (the part before the first dot) compared
whole, since the port's name ``na_dd_tpu_torch`` begins with the JAX
package's ``na_dd_tpu``.  The plain reference also imports nothing of the
program."""

import ast
import json
import subprocess
import sys

from portbench import harness
from portbench.harness import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "na_dd_tpu"}


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def test_whole_name_compare_tells_the_port_from_the_jax_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "na_dd_tpu_torch_fake_probe", sys)
    assert "na_dd_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "na_dd_tpu.fake_probe", sys)
    assert harness.forbidden_loaded() == ["na_dd_tpu"]


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for path in (ROOT / "portbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not top_level_imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        names = top_level_imports(path)
        assert "na_dd_tpu_torch" not in names and not names & FORBIDDEN, path


def test_a_run_loads_no_jax(tmp_path):
    """A whole (CPU, tiny) run in a process of its own, then the loaded
    modules by their top-level names."""
    code = (
        "import sys, time, json; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "harness.run_cell('expsin3d-n128-level', 3, 60.0, False, t_process=time.perf_counter(),"
        " device='cpu', overrides={'N': 8, 'dt': 0.005}, units=1)\n"
        "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "na_dd_tpu_torch" in loaded
    assert not loaded & FORBIDDEN
