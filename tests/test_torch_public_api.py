"""The port's public names against the reference's, read from both source
trees (an AST walk: nothing of either package is imported for it).

* every reference module has a counterpart at the same path under
  ``src/repro_torch/``, or one named in ``COUNTERPARTS``, or is listed in
  ``NOT_PORTED`` (with the reason it has no counterpart) or in
  ``NOT_YET_PORTED`` (empty: every other module is ported);
* each pair of modules (every subpackage's ``__init__`` among them) has the
  same ``__all__``, but for the reference's names in ``ALL_GAPS`` and the
  port's in ``PORT_EXTRAS``;
* each module at the same path defines (``def``, ``class`` or module-level
  assignment) every public name the reference's defines, but for those in
  ``NAME_GAPS``; the same holds for the reference's drivers against the
  port's (``DRIVERS``);
* the port's ``__all__`` names resolve, and ``repro_torch.core`` exports
  ``Config`` and the ``Measurement`` protocol with the reference's methods.

When a listed module is ported, take it off ``NOT_YET_PORTED`` and its
names off the gap lists.
"""

from __future__ import annotations

import ast
import importlib
import inspect
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_ROOT = os.path.join(REPO, "src", "repro")
PORT_ROOT = os.path.join(REPO, "src", "repro_torch")

#: reference modules with no counterpart yet
NOT_YET_PORTED: frozenset = frozenset()

#: reference modules deliberately not ported, each with its reason
NOT_PORTED = {
    "pallas_bench/compile_cache.py": "the card has no compile step: one nvcc library "
                                     "serves every config, so no compile outcome is kept",
}

#: reference modules ported under another path (Pallas kernels are CUDA
#: sources; the Pallas benchmark backend is the CUDA one); their names are
#: the backend's own, so they are not compared
COUNTERPARTS = {
    "kernels/add/kernel.py": "kernels/csrc/add.cu",
    "kernels/harris/kernel.py": "kernels/csrc/harris.cu",
    "kernels/mandelbrot/kernel.py": "kernels/csrc/mandelbrot.cu",
    "pallas_bench/__init__.py": "cuda_bench/__init__.py",
    "pallas_bench/measure.py": "cuda_bench/measure.py",
    "pallas_bench/validity.py": "cuda_bench/validity.py",
    "pallas_bench/workloads.py": "cuda_bench/workloads.py",
}

#: reference names a ported module deliberately lacks
NAME_GAPS = {
    # the reference parses XLA's HLO text into computations and their while
    # trip counts; the port counts the ops one rank runs, so it has no HLO,
    # no computations and no loops to correct for
    "launch/hlo_analysis.py": {"Computation", "parse_computations", "computation_multipliers"},
    # Pallas interpret mode has no CUDA counterpart
    "kernels/common.py": {"use_interpret"},
    # a jax.tree helper; the port's trees are nested dicts (tree.py)
    "models/param.py": {"is_leaf"},
    # the filter taps are private tuples of the port's plain harris
    "kernels/harris/ref.py": {"SOBEL_X", "SOBEL_Y", "BOX"},
}

#: reference ``__all__`` names a ported package deliberately lacks
ALL_GAPS = {
    # the persistent compile cache is not ported (NOT_PORTED)
    "pallas_bench/__init__.py": {"CompileCache"},
}

#: names the port's ``__all__`` adds to the reference's
PORT_EXTRAS = {
    # the facade also exports the matrix layer's types
    "__init__.py": {"CellResult", "EXTRA_ALGORITHMS", "ExperimentDesign", "ExperimentUnit",
                    "MatrixResults", "PAPER_ALGORITHMS", "SampleDataset", "UnitJournal",
                    "UnitResult", "build_units", "merge_unit_results"},
    # the fence inside a timed region; the measurement protocol
    "core/__init__.py": {"fence", "Measurement"},
    # the cards a process/device executor pins
    "core/executors.py": {"cuda_devices"},
    # each wrapper's launch count
    "kernels/__init__.py": {"LAUNCHES"},
    # a cuda winner is keyed by the card's name
    "serving/__init__.py": {"device_label"},
}

#: the reference's drivers outside ``src/`` and their ports, with the names
#: a port lacks: ``ROOT`` / ``REPO`` put ``src`` on a script's path (the
#: port's drivers are modules of the package), ``table_pallas_backend``
#: is ``table_cuda_backend``, and ``table_pipeline_overlap`` times a
#: compile pipeline the port does not have
DRIVERS = {
    "benchmarks/paper_matrix.py": ("benchmarks/paper_matrix.py", set()),
    "benchmarks/run.py": ("benchmarks/run.py", {"ROOT", "table_pallas_backend",
                                                "table_pipeline_overlap"}),
    "tools/compare_stores.py": ("tools/compare_stores.py", {"REPO"}),
    "examples/quickstart.py": ("examples/quickstart.py", set()),
    "examples/tune_kernel_interpret.py": ("examples/tune_kernel.py", set()),
    "examples/train_lm.py": ("examples/train_lm.py", set()),
    "benchmarks/hillclimb.py": ("benchmarks/hillclimb.py", set()),
    "benchmarks/make_experiments_md.py": ("benchmarks/make_experiments_md.py", set()),
    "examples/tune_sharding.py": ("examples/tune_sharding.py", set()),
}


def modules(root: str) -> set[str]:
    found = set()
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d not in ("__pycache__", "build"))
        for f in filenames:
            if f.endswith(".py"):
                found.add(os.path.relpath(os.path.join(dirpath, f), root).replace(os.sep, "/"))
    return found


def public_names(path: str) -> tuple[set[str], set[str] | None]:
    """The public names a module binds by ``def``, ``class`` or assignment
    at module level, and its ``__all__`` (None without one)."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    names, exported = set(), None
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    names.add(target.id)
                    if target.id == "__all__":
                        exported = set(ast.literal_eval(node.value))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}, exported


REF_MODULES = modules(REF_ROOT)
PORT_MODULES = modules(PORT_ROOT)
SHARED = sorted(REF_MODULES & PORT_MODULES)
PACKAGES = sorted(m for m in SHARED if m.endswith("__init__.py"))


def test_every_reference_module_is_ported_or_listed():
    missing = REF_MODULES - PORT_MODULES
    assert missing == NOT_YET_PORTED | set(COUNTERPARTS) | set(NOT_PORTED)
    assert not NOT_YET_PORTED and not set(NOT_PORTED) & set(COUNTERPARTS)
    assert all(NOT_PORTED.values())
    for ref_path, port_path in COUNTERPARTS.items():
        assert os.path.exists(os.path.join(PORT_ROOT, port_path)), (ref_path, port_path)
    # the gap lists name only modules that exist on both sides, or (for a
    # package's __all__) a package ported under another path
    assert set(NAME_GAPS) | set(PORT_EXTRAS) <= set(SHARED)
    assert set(ALL_GAPS) <= set(SHARED) | set(COUNTERPARTS)
    for module in sorted(set(ALL_GAPS) - set(SHARED)):
        _, ref = public_names(os.path.join(REF_ROOT, module))
        _, ours = public_names(os.path.join(PORT_ROOT, COUNTERPARTS[module]))
        assert ALL_GAPS[module] <= ref and not ALL_GAPS[module] & ours, module


@pytest.mark.parametrize("module", SHARED)
def test_ported_module_defines_the_reference_names(module):
    ref, _ = public_names(os.path.join(REF_ROOT, module))
    ours, _ = public_names(os.path.join(PORT_ROOT, module))
    gaps = NAME_GAPS.get(module, set())
    assert gaps <= ref, f"{module}: listed gaps the reference does not define"
    assert ref - ours == gaps


@pytest.mark.parametrize("module", SHARED)
def test_all_equals_the_reference(module):
    _, ref = public_names(os.path.join(REF_ROOT, module))
    _, ours = public_names(os.path.join(PORT_ROOT, module))
    assert (ref is None) == (ours is None), module
    ref, ours = ref or set(), ours or set()
    assert ref - ours == ALL_GAPS.get(module, set())
    assert ours - ref == PORT_EXTRAS.get(module, set())


@pytest.mark.parametrize("package", PACKAGES)
def test_port_all_names_resolve(package):
    name = "repro_torch" + "".join(
        "." + part for part in package[: -len("__init__.py")].strip("/").split("/") if part)
    mod = importlib.import_module(name)
    missing = [n for n in getattr(mod, "__all__", ()) if not hasattr(mod, n)]
    assert not missing, (name, missing)


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_driver_defines_the_reference_names(driver):
    port_path, renamed = DRIVERS[driver]
    ref, _ = public_names(os.path.join(REPO, driver))
    ours, _ = public_names(os.path.join(PORT_ROOT, port_path))
    assert ref - ours == renamed


def test_core_exports_config_and_the_measurement_protocol():
    from repro.core.measurement import Measurement as RefMeasurement
    from repro_torch.core import Config, Measurement
    from repro_torch.core.space import Config as SpaceConfig

    assert Config is SpaceConfig

    def methods(cls) -> dict:
        return {n: list(inspect.signature(f).parameters)
                for n, f in vars(cls).items() if not n.startswith("_") and callable(f)}

    assert methods(Measurement) == methods(RefMeasurement)
    assert set(methods(Measurement)) == {"measure", "measure_batch", "measure_final"}
