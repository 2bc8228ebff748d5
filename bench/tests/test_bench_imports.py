"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: ``repro_torch`` begins with ``repro`` and is
not it), and the references import nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from bench.harness import layout

ROOT = layout.ROOT
FILES = sorted(p for p in (ROOT / "bench").rglob("*.py") if "__pycache__" not in p.parts)
STDLIB_AND_NUMERICS = set(sys.stdlib_module_names) | {"torch", "numpy", "__future__"}


def top_level_imports(path) -> set[str]:
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((ROOT / "bench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert top_level_imports(path) <= STDLIB_AND_NUMERICS, top_level_imports(path)


def test_a_cells_modules_load_without_jax():
    """Loading the harness, every entry, reader and reference and the
    program's public API in a fresh process leaves no JAX module loaded."""
    code = (
        "import sys; sys.path[:0] = ['src', '.']\n"
        "from bench.harness import layout, runner, trace\n"
        "b = layout.load_benchmark()\n"
        "[layout.reader(m['name']) for m in b['end_to_end'] + b['per_layer']]\n"
        "[layout.entry(layout.cell(w['name']).traffic['entry']) for w in b['workloads']]\n"
        "[layout.reference(layout.cell(w['name']).config['kernel']) for w in b['workloads']]\n"
        "from bench.harness import program; program.tuning(); program.telemetry('x')\n"
        "bad = sorted(n for n in sys.modules if n.split('.', 1)[0] in "
        "('jax', 'jaxlib', 'flax', 'repro'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
