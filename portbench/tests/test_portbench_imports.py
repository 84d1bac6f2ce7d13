"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from portbench import harness

REF = harness.ROOT / "reference"


def test_no_forbidden_module_after_imports_and_a_rehearsal():
    code = (
        "import sys\n"
        "from portbench import harness, run\n"
        "from portbench.tests.tiny import run_tiny\n"
        "run_tiny('v24_backlog', seconds=2.0)\n"
        "run_tiny('v24_offline', seconds=1.0)\n"
        "print(harness.forbidden_modules())\n"
        "assert 'birdnet_go_tpu_torch' in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code],
                         cwd=harness.ROOT.parent, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "birdnet_go_tpu_torch_x", sys)
    assert "birdnet_go_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.forbidden_modules()


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_nothing_of_the_program():
    files = sorted(REF.glob("*.py"))
    assert files
    for f in files:
        mods = _imports(f)
        assert not mods & {"birdnet_go_tpu_torch", "birdnet_go_tpu",
                           "jax", "jaxlib", "flax"}, (f, mods)
        assert mods <= {"__future__", "contextlib", "math", "numpy",
                        "torch", "portbench"}, (f, mods)


def test_benchmark_sources_never_import_jax():
    for f in harness.ROOT.rglob("*.py"):
        assert not _imports(f) & {"jax", "jaxlib", "flax",
                                  "birdnet_go_tpu"}, f
