"""The port's paper drivers against the reference's, on the CPU.

* ``python -m repro_torch.benchmarks.paper_matrix`` and the reference's
  ``benchmarks/paper_matrix.py`` run the same smoke cost-model combo
  (``--backend costmodel --design smoke --bench harris --chip v5e``) on the
  ``json`` and the ``sqlite`` store: the run records' results are equal, the
  store values byte-identical (by the port's ``compare_stores``), the
  ``--report`` text equal from "Quality vs sample size" on (the search-cost
  table's wall-clock seconds masked), and the ``--serve-dir`` winners equal
  (but for their ``fresh`` time stamps);
* the port's ``--executor process --max-workers 2`` and a ``--resume`` from
  a copy of the serial store equal the serial run;
* ``--pipeline-workers`` and ``--compile-cache`` are refused on every
  backend (the port's measurement has no such knob), ``--device`` is refused off the ``cuda`` backend, and the ``cuda`` backend
  raises on a host with no card;
* a ``cuda`` combo with ``device="cpu"`` at 64x128 equals the reference's
  ``pallas`` combo, with both packages' clocks ticking one second a
  reading, and its fig2 rows equal the reference's (best observed);
* ``repro_torch.benchmarks.run``'s host rows (searcher overhead, engine
  dispatch, scheduler tail, telemetry overhead), its fig2/3/4 rows and the
  claim verdicts equal the reference's CSV on the smoke matrix, wall-clock
  fields masked.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch

import repro
from benchmarks import paper_matrix as ref_pm
from benchmarks import run as ref_run
from repro.core import ExperimentDesign as RefDesign
from repro.core import clock as ref_clock
from repro.core.backends import BACKENDS as REF_BACKENDS
from repro_torch import RunRecord, TuningSession
from repro_torch.benchmarks import paper_matrix, run
from repro_torch.core import ExperimentDesign
from repro_torch.core import clock as port_clock
from repro_torch.core.backends import BACKENDS
from repro_torch.core.stores import make_store
from repro_torch.tools import compare_stores

SMOKE = ["--backend", "costmodel", "--design", "smoke", "--bench", "harris",
         "--chip", "v5e"]


def ref_main(argv: list[str]) -> str:
    """The reference driver's ``main`` (it reads ``sys.argv``); its stdout."""
    out = io.StringIO()
    saved = sys.argv
    sys.argv = ["paper_matrix", *argv]
    try:
        with contextlib.redirect_stdout(out):
            ref_pm.main()
    finally:
        sys.argv = saved
    return out.getvalue()


def port_main(argv: list[str]) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert paper_matrix.main(argv) == 0
    return out.getvalue()


def same_values(a: str, b: str) -> bool:
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = compare_stores.main([a, b])
    return rc == 0 and out.getvalue().startswith("IDENTICAL")


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """Each package's driver on the smoke combo, on both stores: the json run
    renders the report and fills a serve dir.  The sqlite run reuses the
    json run's sample dataset (same seeds, same file name)."""
    root = tmp_path_factory.mktemp("smoke")
    dirs = {}
    for pkg, main in (("port", port_main), ("ref", ref_main)):
        for store in ("json", "sqlite"):
            out = str(root / f"{pkg}_{store}")
            extra = []
            if store == "json":
                extra = ["--report", "--serve-dir", str(root / f"{pkg}_serve")]
            else:
                os.makedirs(out)
                name = "harris_v5e_dataset_s7g999.npz"
                shutil.copy(os.path.join(dirs[(pkg, "json")], name), os.path.join(out, name))
            main([*SMOKE, "--store", store, "--out", out, *extra])
            dirs[(pkg, store)] = out
        dirs[(pkg, "serve")] = str(root / f"{pkg}_serve")
    return dirs


@pytest.mark.parametrize("store", ["json", "sqlite"])
def test_smoke_matrix_equals_the_reference(smoke, store):
    ours = RunRecord.load(os.path.join(smoke[("port", store)], "harris_v5e.json"))
    ref = RunRecord.load(os.path.join(smoke[("ref", store)], "harris_v5e.json"))
    assert ours.result == ref.result
    assert ours.kind == ref.kind == "tune_matrix"
    assert [(c["algo"], c["sample_size"], c["n_experiments"]) for c in ours.result["cells"]] == \
        [(a, s, e) for a in sorted(paper_matrix.ALGOS) for s, e in ((25, 8), (50, 4))]
    ext = "sqlite" if store == "sqlite" else "json"
    name = f"harris_v5e_cache.{ext}"
    assert same_values(os.path.join(smoke[("port", store)], name),
                       os.path.join(smoke[("ref", store)], name))
    # and across the two stores
    assert same_values(os.path.join(smoke[("port", store)], name),
                       os.path.join(smoke[("port", "json")], "harris_v5e_cache.json"))


def _from_quality(text: str) -> str:
    text = text[text.index("## Quality vs sample size"):]
    # the search-cost table's cells are wall-clock seconds: "1.16s (0.00c + 0.00m)"
    return re.sub(r"\d+\.\d+s \(\d+\.\d+c \+ \d+\.\d+m\)", "Ts", text)


def test_report_equals_the_reference(smoke):
    with open(os.path.join(smoke[("port", "json")], "REPORT.md")) as f:
        ours = f.read()
    with open(os.path.join(smoke[("ref", "json")], "REPORT.md")) as f:
        ref = f.read()
    assert "## Quality vs sample size" in ours
    # the one difference after the provenance: the claims note names the
    # module holding MIN_EXPERIMENTS
    assert _from_quality(ours).replace("repro_torch.analysis", "repro.analysis") == \
        _from_quality(ref)


def winners(serve_dir: str) -> dict:
    store = make_store("sqlite", os.path.join(serve_dir, "store.sqlite"))
    try:
        out = {}
        for key, payload in store.winner_items():
            p = json.loads(payload)
            p.pop("fresh")
            out[key] = p
        return out
    finally:
        store.close()


def test_serve_dir_winners_equal_the_reference(smoke):
    """Equal winners; each fingerprint is its combo's journal namespace, which
    names the combo's dataset file (so its directory): the port's spec for
    the reference's directory gives the reference's."""
    ours, ref = winners(smoke[("port", "serve")]), winners(smoke[("ref", "serve")])
    assert list(ours) == list(ref) == ["harris|x=8192|y=8192|v5e"]
    for pkg, found in (("port", ours), ("ref", ref)):
        spec = paper_matrix.combo_spec("harris", "v5e", ExperimentDesign.smoke(),
                                       smoke[(pkg, "json")], backend="costmodel")
        key = "harris|x=8192|y=8192|v5e"
        assert found[key].pop("fingerprint") == TuningSession(spec).journal_namespace()
    assert ours == ref


def test_process_executor_and_resume_equal_serial(smoke, tmp_path, monkeypatch):
    """A process-executor run equals the serial one; then ``--resume --force``
    in its directory replays every unit from the journal (no unit runs) and
    gives the same record and values again."""
    serial = smoke[("port", "json")]
    want = RunRecord.load(os.path.join(serial, "harris_v5e.json")).result
    dataset = "harris_v5e_dataset_s7g999.npz"
    out = str(tmp_path / "process")
    os.makedirs(out)
    shutil.copy(os.path.join(serial, dataset), os.path.join(out, dataset))
    port_main([*SMOKE, "--out", out, "--executor", "process", "--max-workers", "2"])

    def no_unit(self, unit):
        raise AssertionError(f"unit {unit.key} ran on resume")

    for extra in ([], ["--resume", "--force"]):
        got = RunRecord.load(os.path.join(out, "harris_v5e.json")).result
        if extra:
            monkeypatch.setattr(TuningSession, "run_unit", no_unit)
            port_main([*SMOKE, "--out", out, *extra])
            got = RunRecord.load(os.path.join(out, "harris_v5e.json")).result
            # a run that replays every unit loads no dataset, so its record
            # has no dataset_best (the reference's make_record does the same)
            assert "dataset_best" not in got
            got = {**got, "dataset_best": want["dataset_best"]}
        assert got == want, extra
        assert same_values(os.path.join(out, "harris_v5e_cache.json"),
                           os.path.join(serial, "harris_v5e_cache.json")), extra
        assert not [f for f in os.listdir(out) if ".shard" in f], extra


@pytest.mark.parametrize("flag", [["--pipeline-workers", "2"], ["--compile-cache", "cc"]])
def test_compile_pipeline_knobs_are_refused(flag, tmp_path):
    """The reference's two speed knobs of the measurement have no
    counterpart: the port's driver refuses either flag on every backend,
    and its ``run_combo`` takes neither keyword."""
    knob = flag[0][2:].replace("-", "_")
    for backend in ("costmodel", "cuda"):
        argv = ["--backend", backend, "--design", "smoke", "--bench", "harris",
                "--out", str(tmp_path / backend), *flag]
        err = io.StringIO()
        with pytest.raises(SystemExit) as exc, contextlib.redirect_stderr(err):
            paper_matrix.main(argv)
        assert exc.value.code == 2 and f"unrecognized arguments: {flag[0]}" in err.getvalue()
    with pytest.raises(TypeError, match=knob):
        paper_matrix.run_combo("harris", "cuda", ExperimentDesign(sample_sizes=(5,),
                                                                  n_experiments=(2,)),
                               str(tmp_path / "combo"), **{knob: flag[1]})
    assert not os.listdir(tmp_path)


def test_device_applies_to_the_cuda_backend_only(tmp_path):
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        port_main([*SMOKE, "--device", "cpu", "--out", str(tmp_path)])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks a host without a card")
@pytest.mark.parametrize("device", [[], ["--device", "cuda"]])
def test_cuda_backend_raises_without_a_card(device, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["--design", "smoke", "--bench", "mandelbrot", *device,
                   "--out", str(tmp_path)])
    assert not os.listdir(tmp_path)


def _ticks():
    """A clock that advances one second per reading: every timed repeat
    reads 1.0 in both packages, so both matrices see the same values."""
    count = itertools.count()
    return lambda: float(next(count))


@pytest.fixture(scope="module")
def real_combos(tmp_path_factory):
    """A ``cuda`` combo on the CPU's plain versions and the reference's
    ``pallas`` combo, at 64x128, both clocks ticking."""
    root = tmp_path_factory.mktemp("real")
    small = {"x": 64, "y": 128, "repeats": 1, "warmup": 1}
    design = dict(sample_sizes=(5,), n_experiments=(2,), final_repeats=2)
    ours_dir, ref_dir = str(root / "ours"), str(root / "ref")
    ref_clock.set_timer(_ticks())
    port_clock.set_timer(_ticks())
    try:
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            paper_matrix.run_combo("harris", "cuda", ExperimentDesign(**design), ours_dir,
                                   algorithms=("rs", "ga"), verbose=False,
                                   backend_kwargs={**small, "device": "cpu"})
        spec = ref_pm.combo_spec("harris", "pallas", RefDesign(**design), ref_dir,
                                 algorithms=("rs", "ga"), backend="pallas")
        repro.tune_matrix(spec.replace(backend_kwargs=small), out_dir=ref_dir)
    finally:
        ref_clock.set_timer(None)
        port_clock.set_timer(None)
    return ours_dir, ref_dir, printed.getvalue()


def test_cuda_combo_on_the_cpu_equals_the_pallas_combo(real_combos):
    ours_dir, ref_dir, printed = real_combos
    ours = RunRecord.load(os.path.join(ours_dir, "harris_cuda.json"))
    ref = RunRecord.load(os.path.join(ref_dir, "harris_pallas.json"))
    assert ours.result["cells"] == ref.result["cells"]
    assert ours.result["best_observed"] == ref.result["best_observed"]
    assert "true_optimum" not in ours.result
    assert printed.startswith("[matrix] harris x cuda done in ") and "best observed" in printed
    prov = ours.extra["backend_provenance"]
    assert prov["backend"] == "cuda" and prov["device"] == "cpu" and prov["launches"] == 0
    assert ours.spec["backend_kwargs"]["device"] == "cpu"
    assert not [f for f in os.listdir(ours_dir) if "dataset" in f]


def test_fig2_on_real_measurements_equals_the_reference(real_combos, capsys):
    ours_dir, ref_dir, _ = real_combos
    run.table_fig2(ours_dir)
    ours = capsys.readouterr().out
    ref_run.table_fig2(ref_dir)
    ref = capsys.readouterr().out
    assert ours.count("\n") == 2 * 1 and ours.startswith("fig2/harris_cuda/")
    assert ours.replace("harris_cuda", "harris_pallas") == ref


@pytest.fixture
def straggler_cleanup():
    yield
    BACKENDS.pop("straggler", None)
    REF_BACKENDS.pop("straggler", None)


WALL_FIELDS = re.compile(r"\b(wall|speedup_vs_serial|speedup_vs_static|delta_us)=[-0-9.]+")


def masked(csv: str) -> list[str]:
    """The CSV rows with their wall-clock fields masked: the µs column of
    the timed host rows and their wall ratios."""
    rows = []
    for line in csv.strip().splitlines():
        name, us, derived = line.split(",", 2)
        timed = name.split("/")[0] in ("searcher_overhead", "engine_dispatch",
                                       "scheduler_tail", "telemetry_overhead")
        if timed and name != "engine_dispatch/aggregate":
            us, derived = "T", WALL_FIELDS.sub(r"\1=T", derived)
        rows.append(",".join((name, us, derived)))
    return rows


ROWS = {
    "table_searcher_overhead": (),
    "table_engine_dispatch": (100,),
    "table_scheduler_tail": (),
    "table_telemetry_overhead": (100,),
}


@pytest.mark.parametrize("row", sorted(ROWS))
def test_host_rows_equal_the_reference(row, capsys, straggler_cleanup):
    getattr(run, row)(*ROWS[row])
    ours = capsys.readouterr().out
    getattr(ref_run, row)(*ROWS[row])
    ref = capsys.readouterr().out
    assert ours.strip() and masked(ours) == masked(ref)
    if row != "table_searcher_overhead":
        assert "identical=1" in ours or row == "table_engine_dispatch"


@pytest.mark.parametrize("row", ["table_fig2", "table_fig3", "table_fig4"])
def test_figure_rows_equal_the_reference(row, smoke, capsys):
    getattr(run, row)(smoke[("port", "json")])
    ours = capsys.readouterr().out
    getattr(ref_run, row)(smoke[("ref", "json")])
    assert ours.strip() and ours == capsys.readouterr().out
    values = [float(line.split(",")[1]) for line in ours.strip().splitlines()]
    assert np.isfinite(values).all()


def test_claims_equal_the_reference(smoke):
    ours = run.validate(smoke[("port", "json")])
    ref = ref_run.validate(smoke[("ref", "json")])
    assert {k: (v.status, v.detail) for k, v in ours.items()} == \
        {k: (v.status, v.detail) for k, v in ref.items()}
    assert {v.status for v in ours.values()} == {"insufficient-data"}
