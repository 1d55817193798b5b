"""Nothing the benchmark runs loads JAX or the JAX package: top-level
module names are compared whole (``repro_torch`` is not ``repro``), and
nothing reads the old ``benchmarks/`` folder."""
import ast
import subprocess
import sys

import pytest

from perfbench import harness, spec

OLD = "bench" + "marks"          # the JAX package's old benchmark folder
SOURCES = sorted(p for p in spec.HERE.rglob("*.py")
                 if "__pycache__" not in p.parts)


@pytest.mark.parametrize("names,bad", [
    (["repro_torch", "repro_torch.core"], []),
    (["repro", "repro.core"], ["repro", "repro.core"]),
    (["jaxlib.xla_client", "jaxtyping", "flax"], ["flax",
                                                  "jaxlib.xla_client"]),
    (["reprox", "jax_bench"], []),
])
def test_whole_top_level_names(monkeypatch, names, bad):
    for n in names:
        monkeypatch.setitem(sys.modules, n, object())
    got = harness.forbidden_modules()
    assert [n for n in got if n in names] == sorted(bad)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_source_imports_jax_or_reads_benchmarks(path):
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            assert OLD not in node.value, (path, node.value)
        mods = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods = [node.module]
        for m in mods:
            assert m.split(".")[0] not in harness.FORBIDDEN, (path, m)
            assert m.split(".")[0] != OLD, (path, m)


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run in a fresh process, every reader and reference
    loaded: no module of JAX or of the JAX package in ``sys.modules``."""
    code = (
        "import sys, time, torch\n"
        "from pathlib import Path\n"
        "torch.set_num_threads(2)\n"
        "from perfbench import control, harness, spec, tiny\n"
        "b = spec.load()\n"
        "for m in b['end_to_end'] + b['per_layer']:\n"
        "    spec.reader(m['name'])\n"
        "c = spec.cell(b, 'smollm2-1.7b.train-restart')\n"
        "harness.run_cell(b, c, 3, 1.0, True, torch.device('cpu'),\n"
        "                 time.time(), workdir=Path(sys.argv[1]),\n"
        "                 shrink=tiny.shrink)\n"
        "print(harness.forbidden_modules())\n")
    got = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, timeout=240,
                         cwd=str(spec.ROOT))
    assert got.returncode == 0, got.stderr[-3000:]
    assert got.stdout.strip().splitlines()[-1] == "[]"
