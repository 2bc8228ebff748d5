"""The port's static gate (``repro_torch.staticcheck``) against the
reference's (``repro.staticcheck``), on the CPU.

* the fixture corpus ``tests/fixtures/staticcheck/``, with its PROV
  fixtures' knob ``pipeline_workers`` (the reference's measurement's, which
  the port does not have) spelled ``scheduler`` (a knob of both), gives the
  same findings through both gates — path, line, column, rule, severity
  and message — except that DET001 names the port's clock seam,
  ``repro_torch.core.clock.monotonic()``;
* each rule family's bad fixture is caught and its suppressed twin is
  clean, in both gates;
* the port's own tree is clean under its gate, registries included;
* a copy of the port's tree seeded with one violation per family gives the
  same AST findings through both gates;
* a copy of the port's ``core/api.py`` that threads the ``scheduler`` knob
  into ``backend_kwargs``, with no filter in ``default_cache_key`` or in a
  ``journal_namespace`` that reads ``backend_kwargs``, makes PROV001 fire
  on that sink;
* REG001-003, SER001 and SER002 catch broken entries patched into the
  port's registries, and are clean on the real ones;
* the spec pre-flight gives the reference's messages on the reference's
  tiny-space cases, on the paper matrix, and for a ``cuda`` spec at 64x128
  against the reference's ``pallas`` spec at the same size;
* the CLI's exit codes, formats and rule list, in a process that imports
  neither jax nor the reference.

Tolerance is exact everywhere.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import repro.staticcheck as ref_gate
from repro.core.api import TuningSpec as RefSpec
from repro.core.experiment import ExperimentDesign as RefDesign
from repro.core.space import Param as RefParam
from repro.core.space import SearchSpace as RefSpace
from repro.kernels import TUNABLE_KERNELS as REF_TUNABLE_KERNELS
from repro.staticcheck.catalog import RULES as REF_RULES
from repro.staticcheck.spec_rules import (
    check_cache_key_namespaces as ref_check_cache_key_namespaces,
)
from repro.staticcheck.spec_rules import preflight_design as ref_preflight_design
from repro_torch.core.api import TuningSpec
from repro_torch.core.experiment import ExperimentDesign
from repro_torch.core.space import Param, SearchSpace
from repro_torch.staticcheck import (
    Finding,
    check_paths,
    format_finding,
    preflight_paper,
    preflight_spec,
    reg,
)
from repro_torch.staticcheck.catalog import FAMILIES, RULES, resolve_select
from repro_torch.staticcheck.findings import apply_suppressions, suppressions_for
from repro_torch.staticcheck.spec_rules import (
    check_cache_key_namespaces,
    preflight_design,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
PORT_SRC = os.path.join(SRC, "repro_torch")
FIXTURES = os.path.join(REPO, "tests", "fixtures", "staticcheck")
REF_SEAM = "use repro.core.clock.monotonic()"
PORT_SEAM = "use repro_torch.core.clock.monotonic()"


def fixture(*parts: str) -> str:
    return os.path.join(FIXTURES, *parts)


#: the corpus's speed knob, which only the reference's measurement has, and
#: the knob of both gates that stands in for it
CORPUS_KNOB, PORT_KNOB = "pipeline_workers", "scheduler"


def port_corpus(tmp_path) -> str:
    """A copy of the fixture corpus with the PROV fixtures' knob spelled
    :data:`PORT_KNOB`; lines and columns of every finding stay."""
    root = tmp_path / "staticcheck"
    shutil.copytree(FIXTURES, root, ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("prov_bad", "prov_good"):
        for path in sorted((root / name).glob("*.py")):
            path.write_text(path.read_text().replace(CORPUS_KNOB, PORT_KNOB))
    return str(root)


def key(f) -> tuple:
    """A finding of either gate as comparable fields, with the port's clock
    seam mapped onto the reference's (the one message that differs)."""
    message = f.message.replace(PORT_SEAM, REF_SEAM) if f.rule == "DET001" else f.message
    return (f.path, f.line, f.col, f.rule, f.severity, message)


def both(paths: list[str]) -> tuple[list, list]:
    """Both gates' findings over ``paths`` (AST rules only)."""
    ours = check_paths(paths, registry=False)
    ref = ref_gate.check_paths(paths, registry=False)
    return ours, ref


# ------------------------------------------------------------------ catalog


def test_catalog_has_the_reference_ids_families_and_severities():
    assert list(RULES) == list(REF_RULES)
    for rid, rule in RULES.items():
        ref = REF_RULES[rid]
        assert (rule.family, rule.severity) == (ref.family, ref.severity)
    changed = sorted(rid for rid in RULES if RULES[rid].summary != REF_RULES[rid].summary)
    assert changed == ["DET001", "PROV001", "REG003"]
    assert "repro_torch.core.clock" in RULES["DET001"].summary
    assert "repro_torch" in RULES["PROV001"].summary
    assert "repro_torch.kernels" in RULES["REG003"].summary
    assert FAMILIES == ("DET", "LIB", "OBS", "PROV", "REG", "SER", "SPEC")


def test_select_expands_families():
    assert resolve_select("DET") == frozenset({"DET001", "DET002", "DET003"})
    assert resolve_select("DET001,PROV") == frozenset({"DET001", "PROV001"})
    assert resolve_select(None) is None
    with pytest.raises(KeyError):
        resolve_select("NOPE")


# ------------------------------------------------------------------- corpus


def test_corpus_findings_equal_the_references(tmp_path):
    ours, ref = both([port_corpus(tmp_path)])
    assert [key(f) for f in ours] == [key(f) for f in ref]
    det001 = [f for f in ours if f.rule == "DET001"]
    assert len(det001) == 3 and all(PORT_SEAM in f.message for f in det001)


def test_corpus_matches_expected_bad_with_the_ports_seam(tmp_path):
    corpus = port_corpus(tmp_path)
    got = [format_finding(f).replace(corpus + os.sep, "")
           for f in check_paths([corpus], registry=False)]
    with open(fixture("expected_bad.txt"), encoding="utf-8") as fh:
        expected = [
            line.replace(REF_SEAM, PORT_SEAM) if " DET001 " in line
            else line.replace(f"'{CORPUS_KNOB}'", f"'{PORT_KNOB}'") if " PROV001 " in line
            else line
            for line in fh.read().splitlines()
        ]
    assert got == expected


@pytest.mark.parametrize(
    "family,bad,suppressed,expected_rules",
    [
        ("DET", "det_bad.py", "det_suppressed.py", {"DET001", "DET002", "DET003"}),
        ("LIB", "lib_bad.py", "lib_suppressed.py", {"LIB001"}),
        ("SER", "ser_bad.py", "ser_suppressed.py", {"SER003"}),
        ("OBS", "obs_bad.py", "obs_suppressed.py", {"OBS001"}),
    ],
)
def test_violation_caught_and_suppression_honored(family, bad, suppressed, expected_rules):
    ours, ref = both([fixture(bad)])
    assert {f.rule for f in ours} == expected_rules
    assert all(f.path.endswith(bad) for f in ours)
    assert [key(f) for f in ours] == [key(f) for f in ref]
    assert check_paths([fixture(suppressed)], registry=False) == []


@pytest.mark.parametrize(
    "path,critical",
    [
        ("src/repro_torch/core/api.py", True),
        ("src/repro_torch/core/searchers/ga.py", True),
        ("src/repro_torch/cuda_bench/measure.py", True),
        ("src\\repro_torch\\cuda_bench\\workloads.py", True),
        ("src/repro_torch/analysis/report.py", False),
        ("src/repro_torch/telemetry/tracer.py", False),
        ("src/repro_torch/serving/fleet.py", False),
        ("src/repro_torch/staticcheck/det.py", False),
        ("tests/fixtures/staticcheck/det_bad.py", True),
        ("scratch.py", True),
    ],
)
def test_det_scope_is_the_ports_core_and_cuda_bench(path, critical):
    from repro_torch.staticcheck.det import is_det_critical

    assert is_det_critical(path) is critical


def test_prov_violation_caught_and_clean_sink_passes(tmp_path):
    corpus = port_corpus(tmp_path)
    bad = check_paths([os.path.join(corpus, "prov_bad")], registry=False)
    assert {f.rule for f in bad} == {"PROV001"}
    assert PORT_KNOB in bad[0].message
    assert "injector.py" in bad[0].message     # names the injection site
    assert check_paths([os.path.join(corpus, "prov_good")], registry=False) == []
    assert check_paths([fixture("det_good.py")], registry=False) == []
    # the reference's measurement knob is no knob of the port's gate
    assert check_paths([fixture("prov_bad")], registry=False) == []


def test_prov_suppression_honored(tmp_path):
    prov_bad = os.path.join(port_corpus(tmp_path), "prov_bad")
    assert {f.rule for f in check_paths([prov_bad], registry=False)} == {"PROV001"}
    path = os.path.join(prov_bad, "sink.py")
    with open(path, encoding="utf-8") as fh:
        sink = fh.read()
    sink = sink.replace(
        "def default_cache_key(self) -> str:",
        "def default_cache_key(self) -> str:  # repro: allow[PROV001]",
    )
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(sink)
    assert check_paths([prov_bad], registry=False) == []


def test_suppression_parsing_rules_and_families():
    src = "x = 1  # repro: allow[DET001, SER]\ny = 2\n"
    assert suppressions_for(src) == {1: frozenset({"DET001", "SER"})}
    f_exact = Finding("p.py", 1, "DET001", "m")
    f_family = Finding("p.py", 1, "SER003", "m")
    f_other = Finding("p.py", 1, "LIB001", "m")
    kept, n = apply_suppressions([f_exact, f_family, f_other], {"p.py": src})
    assert kept == [f_other] and n == 2


def test_github_format_annotations():
    f = Finding("src/x.py", 12, "DET001", "msg here", col=4)
    assert format_finding(f, "github") == \
        "::error file=src/x.py,line=12,col=4,title=DET001::msg here"
    info = Finding("<spec>", 0, "SPEC001", "space: 8", severity="info")
    assert format_finding(info, "github") == "::notice file=<spec>,title=SPEC001::space: 8"
    assert format_finding(info) == "<spec>:0:0: SPEC001 [info] space: 8"


# ----------------------------------------------------------- the port's tree


def test_port_tree_is_clean_with_registries():
    findings = check_paths([PORT_SRC], registry=True)
    errors = [format_finding(f) for f in findings if f.severity == "error"]
    assert errors == []
    assert findings == []          # no warning or info either


SEEDED = '''\
"""One violation per rule family, for the gates to find."""

import time


def seeded(spec_cls, items):
    t0 = time.perf_counter()
    for item in {1, 2, 3}:
        t0 += item
    assert items
    return spec_cls(kernel="k", searcher_kwargs={"score_fn": lambda c: 0.0}), t0


def static_schedule(spec):
    return spec.replace(backend_kwargs={**spec.backend_kwargs, "scheduler": "static"})


class Leaky:
    def default_cache_key(self) -> str:
        return f"{self.backend_kwargs}|{self.trace_dir}"
'''


def test_seeded_copy_of_the_port_gives_the_references_findings(tmp_path):
    tree = tmp_path / "repro_torch"
    shutil.copytree(PORT_SRC, tree, ignore=shutil.ignore_patterns("__pycache__", "build"))
    (tree / "core" / "_seeded.py").write_text(SEEDED)
    ours, ref = both([str(tree)])
    assert [key(f) for f in ours] == [key(f) for f in ref]
    assert {f.rule for f in ours} == {"DET001", "DET003", "LIB001", "SER003", "OBS001",
                                      "PROV001"}
    assert all(f.path.endswith("_seeded.py") for f in ours if f.rule != "PROV001")
    # the port injects no knob of its own: the seeded one is the live one,
    # and every sink that reads backend_kwargs must exclude it
    prov = [f for f in ours if f.rule == "PROV001"]
    assert all("'scheduler'" in f.message and "_seeded.py:" in f.message for f in prov)
    sinks = sorted((os.path.relpath(f.path, tree).replace(os.sep, "/"),
                    f.message.split(" but ")[1].split("(")[0]) for f in prov)
    assert sinks == [("analysis/report.py", "_spec_fingerprint"),
                     ("core/_seeded.py", "default_cache_key"),
                     ("core/api.py", "default_cache_key")]


# ------------------------------------------------------------ PROV regression


#: the cache-key bug: a speed knob rebound into the session's spec
INJECT_OLD = """        cells = self.cells()
        name = executor
"""
INJECT_NEW = """        self.spec = self.spec.replace(
            backend_kwargs={**self.spec.backend_kwargs, "scheduler": scheduler})
        cells = self.cells()
        name = executor
"""
#: a journal namespace that reads backend_kwargs and filters no knob
JOURNAL_OLD = """        for k in ("store", "store_path"):
            d.pop(k, None)
"""
JOURNAL_NEW = JOURNAL_OLD + """        d["backend_kwargs"] = dict(d.get("backend_kwargs") or {})
"""


@pytest.mark.parametrize(
    "sink,patches",
    [
        ("default_cache_key", [(INJECT_OLD, INJECT_NEW)]),
        ("journal_namespace", [(INJECT_OLD, INJECT_NEW), (JOURNAL_OLD, JOURNAL_NEW)]),
    ],
)
def test_reintroducing_the_cache_key_bug_fails_prov(tmp_path, sink, patches):
    with open(os.path.join(PORT_SRC, "core", "api.py"), encoding="utf-8") as fh:
        api = fh.read()
    path = tmp_path / "api.py"
    path.write_text(api)
    assert check_paths([str(path)], registry=False) == []
    for old, new in patches:
        assert api.count(old) == 1, "patch site moved? update this test"
        api = api.replace(old, new)
    path.write_text(api)
    ours, ref = both([str(path)])
    prov = [f for f in ours if f.rule == "PROV001" and f"{sink}()" in f.message]
    assert [f.message.split("'")[1] for f in prov] == ["scheduler"]
    assert {f.rule for f in ours} == {"PROV001"}
    assert [key(f) for f in ours] == [key(f) for f in ref]


# -------------------------------------------------------------- registries


def test_tunable_kernels_match_benches_and_the_reference():
    from repro_torch import kernels

    assert "TUNABLE_KERNELS" in kernels.__all__
    assert sorted(kernels.TUNABLE_KERNELS) == sorted(kernels.KERNEL_BENCHES) \
        == sorted(REF_TUNABLE_KERNELS)
    for name, fn in kernels.TUNABLE_KERNELS.items():
        assert fn is getattr(kernels, name)


def test_registry_checks_clean_on_real_registries():
    assert reg.check_registries() == []


def _hollow_searcher():
    from repro_torch.core.searchers.base import Searcher

    class Hollow(Searcher):
        name = "_hollow"

    return Hollow


def _executor_without_run():
    from repro_torch.core.executors import Executor

    return Executor(name="_norun", run=None)


class _NotAStore:
    pass


def _stub_bench():
    from repro_torch.kernels.common import KernelBenchSpec

    return KernelBenchSpec(name="_stub", n_inputs=1)


def _misnamed_bench():
    from repro_torch.kernels import KERNEL_BENCHES

    return dataclasses.replace(KERNEL_BENCHES["add"], name="_other")


def _backend_with(default):
    from repro_torch.core.backends import Backend

    def make(kernel="k", seed=0, hook=default):
        raise NotImplementedError

    return Backend(name="_bad", make=make)


@pytest.mark.parametrize(
    "registry,name,entry,check,rule,needle",
    [
        ("repro_torch.core.searchers.SEARCHERS", "_hollow", _hollow_searcher,
         "check_searchers", "REG001", "_propose"),
        ("repro_torch.core.searchers.SEARCHERS", "_notcls", lambda: print,
         "check_searchers", "REG001", "not a Searcher subclass"),
        ("repro_torch.core.stores.STORES", "_broken", lambda: _NotAStore,
         "check_executors_and_stores", "REG002", "_broken"),
        ("repro_torch.core.executors.EXECUTORS", "_norun", _executor_without_run,
         "check_executors_and_stores", "REG002", "_norun"),
        ("repro_torch.kernels.KERNEL_BENCHES", "_stub", _stub_bench,
         "check_kernels", "REG003", "make_inputs"),
        ("repro_torch.kernels.KERNEL_BENCHES", "_misnamed", _misnamed_bench,
         "check_kernels", "REG003", "disagree"),
        ("repro_torch.kernels.TUNABLE_KERNELS", "_orphan", lambda: print,
         "check_kernels", "REG003", "no KERNEL_BENCHES descriptor"),
        ("repro_torch.core.backends.BACKENDS", "_bad", lambda: _backend_with(print),
         "check_backends", "SER002", "hook="),
        ("repro_torch.core.backends.BACKENDS", "_bad",
         lambda: _backend_with(torch.float32), "check_backends", "SER002", "torch.float32"),
        ("repro_torch.core.backends.BACKENDS", "_bad",
         lambda: _backend_with(torch.device("cpu")), "check_backends", "SER002", "device"),
    ],
)
def test_registry_check_catches_a_broken_entry(monkeypatch, registry, name, entry,
                                               check, rule, needle):
    import importlib

    module, attr = registry.rsplit(".", 1)
    table = getattr(importlib.import_module(module), attr)
    monkeypatch.setitem(table, name, entry())
    findings = getattr(reg, check)()
    hits = [f for f in findings if f.rule == rule and needle in f.message]
    assert hits, [format_finding(f) for f in findings]
    assert all(f.severity == "error" for f in hits)


def test_ser001_catches_a_non_json_spec_default(monkeypatch):
    fields = dataclasses.fields(TuningSpec)
    seed = next(f for f in fields if f.name == "seed")
    monkeypatch.setattr(seed, "default", torch.float32)
    findings = reg.check_spec_roundtrip()
    assert [f.rule for f in findings] == ["SER001"]
    assert "TuningSpec.seed default" in findings[0].message


def test_broken_registry_module_is_a_finding_not_a_crash(monkeypatch):
    def broken():
        raise ImportError("no module")

    monkeypatch.setattr(reg, "check_kernels", broken)
    findings = reg.check_registries()
    assert [(f.path, f.rule) for f in findings] == [("<registry>", "REG002")]
    assert "broken could not run: ImportError: no module" in findings[0].message


# -------------------------------------------------------------- pre-flight


def tiny_specs(**kw):
    """The same tiny-space spec in both packages."""
    kw.setdefault("kernel", "k")
    kw.setdefault("backend", "callable")
    constraint = kw.pop("constraint", None)
    ours = TuningSpec(space=SearchSpace([Param("a", (1, 2, 4)), Param("b", (1, 2))],
                                        constraint=constraint), **kw)
    ref = RefSpec(space=RefSpace([RefParam("a", (1, 2, 4)), RefParam("b", (1, 2))],
                                 constraint=constraint), **kw)
    return ours, ref


@pytest.mark.parametrize(
    "kw,rules",
    [
        ({}, {"SPEC001"}),
        ({"constraint": lambda cfg: False}, {"SPEC001", "SPEC002"}),
        ({"constraint": lambda cfg: cfg["a"] > 1}, {"SPEC001"}),
        ({"design": {"sample_sizes": [25], "n_experiments": [5]}}, {"SPEC001", "SPEC005"}),
    ],
)
def test_preflight_spec_gives_the_references_messages(kw, rules):
    ours, ref = tiny_specs(**kw)
    got, want = preflight_spec(ours), ref_gate.preflight_spec(ref)
    assert [key(f) for f in got] == [key(f) for f in want]
    assert {f.rule for f in got} == rules


@pytest.mark.parametrize(
    "design,algorithms,rules",
    [
        ("paper", ("rs", "rf", "ga", "bo_gp", "bo_tpe"), {"SPEC004"}),
        ("paper", ("rs", "rf", "ga"), {"SPEC004"}),
        ({"sample_sizes": (25,), "n_experiments": (5,)}, ("rs", "ga"), {"SPEC005"}),
    ],
)
def test_preflight_design_gives_the_references_messages(design, algorithms, rules):
    if design == "paper":
        ours, ref = ExperimentDesign.paper(), RefDesign.paper()
    else:
        ours, ref = ExperimentDesign(**design), RefDesign(**design)
    got = preflight_design(ours, algorithms=algorithms)
    want = ref_preflight_design(ref, algorithms=algorithms)
    assert [key(f) for f in got] == [key(f) for f in want]
    assert {f.rule for f in got} == rules      # no seed collision either
    assert all(f.severity == "warning" for f in got if f.rule == "SPEC004")


def test_cache_key_namespace_collision_detected():
    a, ra = tiny_specs(store="json", store_path="cache.json", seed=0)
    b, rb = tiny_specs(store="json", store_path="cache.json", seed=1)
    got = check_cache_key_namespaces([a, b])
    assert [key(f) for f in got] == [key(f) for f in ref_check_cache_key_namespaces([ra, rb])]
    assert {f.rule for f in got} == {"SPEC003"}
    # identical specs sharing a store are fine (that IS the resume path)
    assert check_cache_key_namespaces([a, a]) == []


def test_preflight_paper_equals_the_references():
    got, want = preflight_paper(), ref_gate.preflight_paper()
    assert [key(f) for f in got] == [key(f) for f in want]
    assert len(got) == 9 and {f.rule for f in got} == {"SPEC001"}


@pytest.mark.parametrize("kernel", ["add", "harris", "mandelbrot"])
def test_cuda_spec_preflights_like_the_references_pallas_spec(kernel):
    ours = preflight_spec(TuningSpec(kernel=kernel, backend="cuda",
                                     backend_kwargs={"x": 64, "y": 128, "device": "cpu"}))
    ref = ref_gate.preflight_spec(RefSpec(kernel=kernel, backend="pallas",
                                          backend_kwargs={"x": 64, "y": 128}))
    assert [key(f) for f in ours] == [key(f) for f in ref]
    assert [f.message for f in ours] == [
        "space: 2,097,152 configs across 6 params; constrained fraction ~0.7%"]


def test_full_size_cuda_spec_preflights_without_building_or_drawing(monkeypatch):
    from repro_torch.cuda_bench import workloads
    from repro_torch.kernels import _build

    def refuse(*_a, **_k):
        raise AssertionError("the pre-flight must build and draw nothing")

    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(workloads.CudaWorkload, "arrays", refuse)
    for kernel in ("add", "harris", "mandelbrot"):
        findings = preflight_spec(TuningSpec(kernel=kernel, backend="cuda",
                                             backend_kwargs={"x": 8192, "y": 8192}))
        assert [f.rule for f in findings] == ["SPEC001"]
        assert findings[0].message.startswith("space: 2,097,152 configs across 6 params")


# --------------------------------------------------------------------- CLI


def run_cli(*args: str) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": SRC}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.staticcheck", *args],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300,
    )


def test_cli_exit_codes():
    bad = run_cli(fixture("det_bad.py"), "--no-registry")
    assert bad.returncode == 1 and "DET001" in bad.stdout and PORT_SEAM in bad.stdout
    assert run_cli().returncode == 2


def cli(capsys, *args: str) -> tuple[int, str]:
    """The CLI's ``main`` in this process: its exit code and output."""
    from repro_torch.staticcheck.__main__ import main

    rc = main(list(args))
    return rc, capsys.readouterr().out


def test_cli_formats_select_and_preflight(capsys, tmp_path):
    rc, out = cli(capsys, fixture("det_good.py"), "--no-registry")
    assert rc == 0 and out.strip() == "staticcheck: clean"
    rc, out = cli(capsys, fixture("det_bad.py"), "--no-registry", "--format", "github")
    assert rc == 1 and "::error file=" in out
    rc, out = cli(capsys, fixture("det_bad.py"), "--no-registry", "--select", "LIB")
    assert rc == 0                           # DET findings filtered out
    assert cli(capsys, fixture("det_bad.py"), "--select", "NOPE")[0] == 2
    spec = tmp_path / "spec.json"
    spec.write_text(TuningSpec(kernel="harris", backend="cuda",
                               backend_kwargs={"x": 64, "y": 128}).to_json())
    rc, out = cli(capsys, "--preflight", str(spec))
    assert rc == 0 and "SPEC001 [info]" in out
    assert out.splitlines()[-1] == "staticcheck: 0 error finding(s), 1 advisory"


def test_cli_list_rules_covers_catalog():
    out = run_cli("--list-rules")
    assert out.returncode == 0
    listed = [line.split()[0] for line in out.stdout.splitlines()]
    assert listed == sorted(r for r in RULES if r != "PARSE")


def test_cli_gate_over_the_port_imports_neither_jax_nor_the_reference():
    code = (
        "import json, sys\n"
        "from repro_torch.staticcheck.__main__ import main\n"
        f"rc = main([{PORT_SRC!r}, '--preflight-paper'])\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "print(json.dumps({'rc': rc, 'bad': bad,\n"
        "                  'registries': 'repro_torch.core.stores' in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env={**os.environ, "PYTHONPATH": SRC}, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert json.loads(lines[-1]) == {"rc": 0, "bad": [], "registries": True}
    assert lines[-2] == "staticcheck: 0 error finding(s), 9 advisory"
