"""The port's hill-climb, experiments page and sharding tuner against the
reference's drivers, on the CPU.

* ``repro_torch.benchmarks.hillclimb``: ``VARIANTS``, ``DEFAULT_CELLS`` and
  the skip rules equal the reference's; with ``run_variant`` replaced by one
  fake in both modules, both ``main``s print the same text (and the port
  adds one line naming the variants whose numbers equal another's); one
  real ``run_variant`` on a cheap cell writes the reference's keys, and the
  flags are reset when the dry run raises.
* ``repro_torch.benchmarks.make_experiments_md``: §Validation and §Figures
  on one smoke cost-model matrix equal the reference's text; §Dry-run rows
  and the §Perf tables from the same records equal the reference's (the fit
  line is the card's); over a ``cuda`` matrix the page has every section
  and no TPU figure.
* ``repro_torch.examples.tune_sharding``: with ``step_time_model`` replaced
  by one deterministic function in both packages, the same history and best
  config; the real model on a cheap cell gives equal values with
  ``seq_parallel`` on and off (the models bound ``constrain_residual`` at
  import, as the reference's do).

The reference's drivers set ``XLA_FLAGS`` when imported; ``os.environ`` is
restored after each import.
"""

from __future__ import annotations

import ast
import contextlib
import importlib
import importlib.util
import io
import json
import os
import re
import sys

import pytest

from repro_torch.benchmarks import hillclimb, make_experiments_md, paper_matrix
from repro_torch.core import ExperimentDesign
from repro_torch.examples import tune_sharding
from repro_torch.models import moe as moe_mod
from repro_torch.sharding import constrain as constrain_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: a cell whose dry run takes seconds on a CPU core
CHEAP = ("olmoe-1b-7b", "decode_32k")


@contextlib.contextmanager
def saved_environ():
    env = dict(os.environ)
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(env)


def ref_module(name: str):
    """A reference driver (``benchmarks.<x>`` or ``examples/<x>.py``),
    imported with ``os.environ`` restored afterwards."""
    with saved_environ():
        if name.startswith("examples/"):
            path = os.path.join(REPO, name)
            spec = importlib.util.spec_from_file_location(
                "ref_" + os.path.basename(name)[:-3], path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
        return importlib.import_module(name)


@pytest.fixture(scope="module")
def ref_hillclimb():
    return ref_module("benchmarks.hillclimb")


@pytest.fixture(scope="module")
def ref_md():
    return ref_module("benchmarks.make_experiments_md")


@pytest.fixture(scope="module")
def fake_pod():
    """The single pod's 256 ranks in this process, on torch's fake backend
    (torn down after the module; never beside another group)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import start_fake_process_group

    start_fake_process_group(256)
    yield
    dist.destroy_process_group()


def stdout_of(fn, *args) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


# -------------------------------------------------------------- hillclimb


def test_hillclimb_variants_cells_and_skips_equal_the_reference(ref_hillclimb):
    assert hillclimb.VARIANTS == ref_hillclimb.VARIANTS
    assert hillclimb.DEFAULT_CELLS == ref_hillclimb.DEFAULT_CELLS
    assert hillclimb.PERF_DIR == os.path.join("results", "perf_torch")


def fake_variant(same_as_baseline: bool = False):
    """Distinct numbers per (cell, variant); with ``same_as_baseline`` the
    MoE dispatch flag changes nothing, as in the port."""
    def run(arch, shape, name, v):
        flags = dict(v, moe_constrain=False) if same_as_baseline else v
        k = sum(2 ** i for i, f in enumerate(flags.values()) if f) + len(arch) / 100
        return {"variant": name, "flags": v, "compute_s": 1.0 + k, "memory_s": 0.5,
                "collective_s": 2.0 + k / 3, "step_s": 2.0 + k / 3,
                "roofline_fraction": 0.1 / (1 + k), "dominant": "collective",
                "collectives": {"all-gather": 1e9 * (1 + k)}, "peak_gib": 3.0 + k}
    return run


def ref_main(mod, argv: list[str]) -> str:
    saved = sys.argv
    sys.argv = ["prog", *argv]
    try:
        return stdout_of(mod.main)
    finally:
        sys.argv = saved


def test_hillclimb_main_prints_the_reference_text(ref_hillclimb, monkeypatch):
    monkeypatch.setattr(hillclimb, "start_fake_process_group", lambda n: None)
    monkeypatch.setattr(hillclimb, "run_variant", fake_variant())
    monkeypatch.setattr(ref_hillclimb, "run_variant", fake_variant())
    ours = stdout_of(hillclimb.main, [])
    assert ours == ref_main(ref_hillclimb, [])
    # the skip rules: MoE-only variants only on the MoE cells
    runs = re.findall(r"\[hillclimb\] (\S+) :: (\S+) \.\.\.", ours)
    assert ("yi-34b:train_4k", "H2_moe_dispatch") not in runs
    assert ("olmoe-1b-7b:train_4k", "H1+H2+H3") in runs
    assert len(runs) == 8 + 8 + 5
    argv = ["--cells", "yi-34b:train_4k", "--variants", "baseline", "H4+H3"]
    assert stdout_of(hillclimb.main, argv) == ref_main(ref_hillclimb, argv)


def test_hillclimb_names_the_variants_that_change_no_op(ref_hillclimb, monkeypatch):
    monkeypatch.setattr(hillclimb, "start_fake_process_group", lambda n: None)
    monkeypatch.setattr(hillclimb, "run_variant", fake_variant(same_as_baseline=True))
    monkeypatch.setattr(ref_hillclimb, "run_variant", fake_variant(same_as_baseline=True))
    argv = ["--cells", "olmoe-1b-7b:train_4k", "--variants", "baseline",
            "H1_bf16gather", "H2_moe_dispatch", "H1+H2"]
    ours = stdout_of(hillclimb.main, argv).splitlines()
    ref = ref_main(ref_hillclimb, argv).splitlines()
    extra = [ln for ln in ours if ln.startswith("[hillclimb] variants that change no op")]
    assert extra == ["[hillclimb] variants that change no op of the port: "
                     "olmoe-1b-7b:train_4k :: H2_moe_dispatch (= baseline); "
                     "olmoe-1b-7b:train_4k :: H1+H2 (= H1_bf16gather)"]
    assert [ln for ln in ours if ln not in extra] == ref
    # it stands before the table
    assert ours.index(extra[0]) < ours.index("| cell | variant | step (s) | collective (s) "
                                             "| compute (s) | frac |")


def reference_out_keys() -> set:
    """The keys of the record the reference's ``run_variant`` writes."""
    with open(os.path.join(REPO, "benchmarks", "hillclimb.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "run_variant")
    out = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "out")
    return {k.value for k in out.value.keys}


def test_run_variant_writes_the_reference_keys(fake_pod, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    arch, shape = CHEAP
    out = hillclimb.run_variant(arch, shape, "H1+H3_headdim", hillclimb.VARIANTS["H1+H3_headdim"])
    assert set(out) == reference_out_keys()
    path = tmp_path / "results" / "perf_torch" / f"{arch}_{shape}__H1_H3_headdim.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(out))
    assert out["step_s"] == max(out["compute_s"], out["memory_s"], out["collective_s"]) > 0
    assert not moe_mod.CONSTRAIN_DISPATCH and not constrain_mod.FSDP_GATHER_WEIGHTS


def test_run_variant_resets_the_flags_when_the_dry_run_raises(monkeypatch):
    seen = {}

    def boom(*args, **kwargs):
        seen.update(moe=moe_mod.CONSTRAIN_DISPATCH, fsdp=constrain_mod.FSDP_GATHER_WEIGHTS,
                    cast=kwargs["settings"].cast_bf16,
                    head_dim=kwargs["rules"].rules["head_dim"])
        raise RuntimeError("trace failed")

    monkeypatch.setattr(hillclimb, "run_cell", boom)
    v = dict(cast_bf16=True, moe_constrain=True, head_dim_tp=True, fsdp_gather=True)
    with pytest.raises(RuntimeError, match="trace failed"):
        hillclimb.run_variant("olmoe-1b-7b", "train_4k", "all", v)
    assert seen == {"moe": True, "fsdp": True, "cast": True, "head_dim": ("model",)}
    assert moe_mod.CONSTRAIN_DISPATCH is False and constrain_mod.FSDP_GATHER_WEIGHTS is False


# --------------------------------------------------- make_experiments_md


@pytest.fixture(scope="module")
def records(tmp_path_factory, ref_md):
    """A smoke cost-model matrix, a small ``cuda`` matrix on the CPU, two
    dry-run records and a hill-climb's records, in one directory."""
    root = tmp_path_factory.mktemp("records")
    costmodel, cuda = str(root / "costmodel"), str(root / "cuda")
    with contextlib.redirect_stdout(io.StringIO()):
        assert paper_matrix.main(["--backend", "costmodel", "--design", "smoke", "--bench",
                                  "harris", "--chip", "v5e", "--out", costmodel]) == 0
        paper_matrix.run_combo("mandelbrot", "cuda",
                               ExperimentDesign(sample_sizes=(5,), n_experiments=(2,),
                                                final_repeats=2),
                               cuda, algorithms=("rs", "ga"), verbose=False,
                               backend_kwargs={"x": 64, "y": 128, "repeats": 1,
                                               "device": "cpu"})
    dry = root / "dryrun"
    dry.mkdir()
    for arch, shape, peak in (("olmoe-1b-7b", "train_4k", 12.64 * 2**30),
                              ("yi-34b", "train_4k", 20e9)):
        rec = {"arch": arch, "shape": shape, "mesh": "single", "n_devices": 256,
               "flops_dot_corrected": 3.2e14, "flops_total": 3.2e14,
               "collectives": {"bytes": {"all-gather": 2.1e10, "all-reduce": 7e8,
                                         "reduce-scatter": 2e10},
                               "total_bytes": 4.2e10},
               "memory": {"peak_bytes_per_dev": peak, "argument_bytes_per_dev": 3.2e8}}
        (dry / f"{arch}_{shape}_single.json").write_text(json.dumps(rec))
    perf = root / "perf"
    perf.mkdir()
    run = fake_variant(same_as_baseline=True)
    for name in ("baseline", "H1_bf16gather", "H2_moe_dispatch"):
        out = run("olmoe-1b-7b", "train_4k", name, hillclimb.VARIANTS[name])
        (perf / f"olmoe-1b-7b_train_4k__{name}.json").write_text(json.dumps(out))
    return {"costmodel": costmodel, "cuda": cuda, "dryrun": str(dry), "perf": str(perf)}


def sections(mod, monkeypatch, matrix: str, dryrun: str, perf: str) -> dict:
    monkeypatch.setattr(mod, "MATRIX_DIR", matrix)
    monkeypatch.setattr(mod, "DRYRUN_DIR", dryrun)
    monkeypatch.setattr(mod, "PERF_DIR", perf)
    return {name: getattr(mod, f"section_{name}")()
            for name in ("validation", "figures", "dryrun", "perf")}


def test_experiments_sections_equal_the_reference(records, ref_md, monkeypatch):
    args = (records["costmodel"], records["dryrun"], records["perf"])
    ours = sections(make_experiments_md, monkeypatch, *args)
    ref = sections(ref_md, monkeypatch, *args)
    # the cost model's matrix: the reference's claims, figures and analysis
    assert ours["validation"] == ref["validation"]
    assert "Analysis of the divergences" in ours["validation"]
    assert ours["figures"] == ref["figures"]
    # the dry-run rows and the hill-climb tables; the fit line is the card's
    rows = [[ln for ln in s["dryrun"].splitlines() if ln.startswith("| ")] for s in (ours, ref)]
    assert rows[0] == rows[1] and len(rows[0]) == 3
    assert "**Fits check**: 2/2 cells under the 80 GB of one H100." in ours["dryrun"]
    assert "1/2 cells under the 16 GiB" in ref["dryrun"]
    tables = [s["perf"][s["perf"].index("\n### "):] for s in (ours, ref)]
    assert tables[0] == tables[1] and "H2_moe_dispatch" in tables[0]


def test_experiments_page_over_the_cards_records_names_no_tpu(records, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "EXPERIMENTS_torch.md"
    printed = stdout_of(make_experiments_md.main,
                        ["--matrix-dir", records["cuda"], "--dryrun-dir", records["dryrun"],
                         "--perf-dir", records["perf"], "--out", str(out)])
    assert printed.startswith(f"{out} written (")
    text = out.read_text()
    for heading in ("# EXPERIMENTS (PyTorch/CUDA port)", "## §Validation", "## §Figures",
                    "## §Dry-run", "## §Roofline", "## §Perf", "## §Repro-perf"):
        assert heading in text, heading
    for word in ("v5e", "TPU", "197 TF"):
        assert word not in text, word
    assert "Analysis of the divergences" not in text
    assert "989 TFLOP/s bf16 dense, 3.35 TB/s HBM3, 450 GB/s NVLink" in text
    assert "| olmoe-1b-7b | train_4k |" in text and "mandelbrot x cuda" in text
    assert not os.path.exists(tmp_path / "EXPERIMENTS.md")


# ------------------------------------------------------------ tune_sharding


def fake_step_time(arch_name, shape_name, cfg):
    base = {"none": 3.0, "dots": 2.0, "full": 2.5}[cfg["remat"]]
    return base / cfg["accum"] ** 0.5 + 0.3 * cfg["seq_parallel"] - 0.2 * cfg["head_dim_tp"]


def test_tune_sharding_history_and_best_equal_the_reference(monkeypatch):
    ref = ref_module("examples/tune_sharding.py")
    monkeypatch.setattr(ref, "step_time_model", fake_step_time)
    monkeypatch.setattr(tune_sharding, "step_time_model", fake_step_time)
    monkeypatch.setattr(tune_sharding, "start_fake_process_group", lambda n: None)
    argv = ["--budget", "6", "--arch", "olmoe-1b-7b"]
    ours = stdout_of(tune_sharding.main, argv)
    theirs = ref_main(ref, argv)
    mask = lambda s: re.sub(r"\((compile|trace) \d+s\)", "(...)", s)  # noqa: E731
    assert mask(ours) == mask(theirs)
    assert len(re.findall(r"cfg=", ours)) >= 3
    assert "best distributed config for olmoe-1b-7b train_4k: {" in ours


def test_seq_parallel_is_inert_in_the_port_as_in_the_reference(fake_pod):
    from repro_torch.models import decoder, encdec, ssm

    cfg = dict(remat="dots", accum=1, seq_parallel=True, head_dim_tp=False)
    on = tune_sharding.step_time_model(*CHEAP, cfg)
    off = tune_sharding.step_time_model(*CHEAP, {**cfg, "seq_parallel": False})
    assert on == off > 0
    # the models bound the hook when imported, and the swap is undone
    for mod in (decoder, encdec, ssm):
        assert mod.constrain_residual is constrain_mod.constrain_residual
