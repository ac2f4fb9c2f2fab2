"""What the benchmark loads: never JAX, jaxlib, Flax or the JAX package
(top-level module names compared whole: the measured program's name begins
with the JAX package's), and the reference nothing of the measured
program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

FOLDER = Path(__file__).resolve().parents[1]
ROOT = FOLDER.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "misonet_tpu"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax_or_the_jax_package():
    for path in FOLDER.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (FOLDER / "reference").rglob("*.py"):
        assert "misonet_tpu_torch" not in _imports(path), path


def _loaded_after(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    mods = _loaded_after("import benchmark.reference.nets, "
                         "benchmark.reference.serving, benchmark.reference.training, "
                         "benchmark.reference.weights, benchmark.reference.dsp")
    assert not mods & (FORBIDDEN | {"misonet_tpu_torch"})


def test_a_whole_cpu_run_loads_no_jax():
    code = ("import tempfile, pathlib, torch\n"
            "torch.set_num_threads(2)\n"
            "from benchmark import harness\n"
            "from benchmark.tests import tiny\n"
            "root = tiny.make_root(pathlib.Path(tempfile.mkdtemp()))\n"
            "r = harness.run_cell(harness.Bench(root, root / 'benchmark'), "
            "'tiny.css', 1, 0.3, False, 'cpu', 0.0)\n"
            "assert r['correct'], r\n"
            "assert not harness.forbidden_modules()\n")
    mods = _loaded_after(code)
    assert "misonet_tpu_torch" in mods and not mods & FORBIDDEN
