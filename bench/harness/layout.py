"""Finds the benchmark's parts by the names ``BENCHMARK.json`` gives them.

Every configuration, traffic mix, entry driver, metric reader and kernel
reference sits in a file of its own, so a later cell or metric is a new
file and never an edit:

    BENCHMARK.json              the cells, the metrics, the bounds
    bench/configs/<config>.json a deployment of the tuner (the file that
                                BENCHMARK.json names for the config)
    bench/traffic/<traffic>.json one traffic mix; its ``entry`` names
    bench/entries/<entry>.py    the driver of the program's entry point
    bench/metrics/<metric>.py   one reader per metric: ``read(run)``
    bench/reference/<kernel>.py the kernel's plain reference, its control,
                                the number compared and its bytes and
                                operations

Nothing here imports the program.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path

#: the checkout: BENCHMARK.json beside bench/ and src/
ROOT = Path(__file__).resolve().parents[2]

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


@dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with its configuration, its traffic and
    the metrics it reports."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple
    per_layer: tuple
    root: Path

    def metrics(self, trace: bool) -> tuple:
        """What a run of this cell reports: the end-to-end metrics untraced,
        the per-layer ones traced."""
        return self.per_layer if trace else self.end_to_end


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def first_cells(root: Path = ROOT) -> list[str]:
    """The first cell of each configuration, in the order of ``configs``:
    one cell for every kernel the benchmark runs."""
    bench = load_benchmark(root)
    return [next(w["name"] for w in bench["workloads"] if w["config"] == c["name"])
            for c in bench["configs"]]


def traffic_path(name: str, root: Path = ROOT) -> Path:
    return Path(root) / "bench" / "traffic" / f"{name}.json"


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the checkout at ``root``, with its files read."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(Path(root) / configs[w["config"]]["file"], encoding="utf-8") as f:
        config = json.load(f)
    with open(traffic_path(w["traffic"], root), encoding="utf-8") as f:
        traffic = json.load(f)
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=tuple(m for m in bench["end_to_end"] if _applies(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _applies(m, name)),
        root=Path(root),
    )


def load_module(path: Path, name: str):
    """Import the file at ``path`` as module ``name`` (names may hold ``.``
    and ``-``, so the files are loaded by path, not by package)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not Path(path).is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def _part(kind: str, name: str, root: Path):
    root = Path(root)
    return load_module(root / "bench" / kind / f"{name}.py",
                       f"bench_{kind}__{name}__{abs(hash(str(root)))}")


def entry(name: str, root: Path = ROOT):
    """The entry driver ``bench/entries/<name>.py``."""
    return _part("entries", name, root)


def reader(metric: str, root: Path = ROOT):
    """The reader of one metric, ``bench/metrics/<metric>.py``."""
    return _part("metrics", metric, root)


def reference(kernel: str, root: Path = ROOT):
    """The plain reference of one kernel, ``bench/reference/<kernel>.py``."""
    return _part("reference", kernel, root)


def peaks(root: Path = ROOT) -> dict:
    with open(Path(root) / "bench" / "peaks.json", encoding="utf-8") as f:
        return json.load(f)
