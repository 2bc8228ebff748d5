"""Every cell, configuration, traffic mix and metric loads from its own
files, within the benchmark contract's limits; a cell made only of new
files is found."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from bench.harness import layout

ROOT = layout.ROOT
BENCH = layout.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/") and ".." not in p
    assert BENCH["command"][:2] == ["python3", "bench/run.py"] and len(BENCH["command"]) <= 32
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_have_only_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_units_and_lines_are_legal():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert layout.NAME_RE.fullmatch(n), n
    for m in METRICS:
        assert layout.UNIT_RE.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in BENCH["configs"]] + [w["why"] for w in BENCH["workloads"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text
    for path in (ROOT / "bench").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert all(ch.isalnum() and ch.isascii() or ch in "_.-/" for ch in rel), rel


def test_setup_s_and_one_metric_of_each_kind_in_every_cell():
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    for name in CELLS:
        cell = layout.cell(name)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (name, m["name"])


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_from_its_files(name):
    cell = layout.cell(name)
    assert (ROOT / "bench" / "reference" / f"{cell.config['kernel']}.py").is_file()
    assert cell.config["dtype"] == "float32"
    assert len(cell.config["space"]) == 6
    for key in ("searcher", "budget", "final_repeats", "warmup_budget"):
        assert key in cell.traffic
    assert 1 <= len(cell.traffic["why"]) <= 200
    entry = layout.entry(cell.traffic["entry"])
    assert callable(entry.setup) and callable(entry.window)
    ref = layout.reference(cell.config["kernel"])
    for attr in ("make_inputs", "reference", "control", "error", "counts", "CHECK", "LIMIT"):
        assert hasattr(ref, attr), attr


@pytest.mark.parametrize("name", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(name):
    assert callable(layout.reader(name).read)


def test_config_files_are_distinct_and_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith("bench/configs/") and (ROOT / f).is_file()


def test_a_cell_made_only_of_new_files_loads(tmp_path):
    """A later PR adds a configuration, a traffic mix and a metric as new
    files plus entries in BENCHMARK.json; the harness finds them by name."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "bench/configs/harris-8192.json").read_text())
    cfg["x"] = 4096
    (tmp_path / "bench/configs/harris-4096.json").write_text(json.dumps(cfg))
    (tmp_path / "bench/traffic/rs-400.json").write_text(json.dumps({
        "entry": "tune", "searcher": "rs", "searcher_kwargs": {}, "budget": 400,
        "final_repeats": 10, "warmup_budget": 20, "why": "random search at 400"}))
    (tmp_path / "bench/metrics/invalid_pct.py").write_text(
        "def read(run):\n"
        "    return 100.0 * sum(c['n_invalid'] for c in run.calls) / run.samples\n")
    bench["configs"].append({"name": "harris-4096", "source": "https://arxiv.org/abs/2203.13577",
                             "file": "bench/configs/harris-4096.json", "reduced": ["x"],
                             "why": "a smaller image"})
    bench["workloads"].append({"name": "harris.rs-400", "config": "harris-4096",
                               "traffic": "rs-400", "chips": 1, "why": "random search"})
    bench["per_layer"].append({"name": "invalid_pct", "unit": "%", "better": "lower",
                               "source": "program_counter", "layer": "cuda_bench/validity.py",
                               "moves": "samples_per_s", "workloads": ["harris.rs-400"]})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("harris.rs-400")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = layout.cell("harris.rs-400", tmp_path)
    assert cell.config["x"] == 4096 and cell.traffic["budget"] == 400
    assert [m["name"] for m in cell.per_layer] == ["invalid_pct"]
    assert {m["name"] for m in cell.end_to_end} == {"samples_per_s", "winner_ms", "setup_s"}
    reader = layout.reader("invalid_pct", tmp_path)

    class Run:
        calls = [{"n_invalid": 3}, {"n_invalid": 1}]
        samples = 800

    assert reader.read(Run()) == pytest.approx(0.5)
    assert callable(layout.entry("tune", tmp_path).window)
    with pytest.raises(KeyError):
        layout.cell("harris.rs-800", tmp_path)


def test_traffic_files_are_data_read_by_one_generator():
    for path in (ROOT / "bench/traffic").iterdir():
        assert path.suffix in (".json", ".jsonl", ".toml", ".txt", ".csv"), path
        data = json.loads(path.read_text())
        assert (ROOT / "bench/entries" / f"{data['entry']}.py").is_file()


def test_peaks_table_holds_the_data_sheet():
    peaks = layout.peaks()["NVIDIA H100 80GB HBM3"]
    assert peaks["bytes_per_s"] == 3.35e12 and peaks["f32_per_s"] == 67e12


def test_readme_names_the_command():
    text = (ROOT / "bench/README.md").read_text()
    assert "python3 bench/run.py --workload" in text
    assert Path(ROOT / BENCH["command"][1]).is_file()
