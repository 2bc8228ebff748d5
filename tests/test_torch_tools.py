"""The port's ``compare_stores`` tool against the reference's, on the CPU.

The six cases of ``tests/test_tools.py`` run on ``python -m
repro_torch.tools.compare_stores``, each on stores that the port wrote and
on stores that the reference wrote; in every case the reference's tool
(``tools/compare_stores.py``) reads the same files and must print the same
lines and return the same exit code.
"""

from __future__ import annotations

import importlib.util
import os

import pytest

from repro.core.stores import MeasurementStore as RefStore
from repro.core.stores import SqliteMeasurementStore as RefSqliteStore
from repro_torch.core import MeasurementStore, SqliteMeasurementStore
from repro_torch.tools import compare_stores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WRITERS = {
    "port": (MeasurementStore, SqliteMeasurementStore),
    "ref": (RefStore, RefSqliteStore),
}

ENTRIES = {"k/seed=1|a=1": 0.25, "k/seed=1|a=2": 0.5, "k/seed=2|a=1": 0.125}


@pytest.fixture(scope="module")
def ref_tool():
    path = os.path.join(REPO, "tools", "compare_stores.py")
    spec = importlib.util.spec_from_file_location("ref_compare_stores", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(params=sorted(WRITERS))
def write_store(request):
    json_cls, sqlite_cls = WRITERS[request.param]

    def write(path: str, entries: dict[str, float]):
        store = sqlite_cls(path) if path.endswith(".sqlite") else json_cls(path)
        for k, v in entries.items():
            store.put(k, v)
        store.save()
        return store

    return write


@pytest.fixture
def run_both(ref_tool, capsys):
    """Run the port's tool and then the reference's on one argv; the two must
    print the same lines and return the same code.  Returns the port's."""

    def run(argv: list[str]) -> tuple[int, str]:
        rc = compare_stores.main(argv)
        out = capsys.readouterr().out
        assert ref_tool.main(argv) == rc
        assert capsys.readouterr().out == out
        return rc, out

    return run


def test_identical_stores_exit_zero(write_store, run_both, tmp_path):
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    write_store(a, ENTRIES)
    write_store(b, ENTRIES)
    rc, out = run_both([a, b])
    assert rc == 0
    assert "IDENTICAL" in out
    assert f"{len(ENTRIES)} measurement entries" in out


def test_value_divergence_exits_nonzero_and_names_key(write_store, run_both, tmp_path):
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    write_store(a, ENTRIES)
    diverged = dict(ENTRIES)
    # one-byte divergence: the smallest representable nudge on one value
    diverged["k/seed=1|a=2"] = float.fromhex("0x1.0000000000001p-1")
    write_store(b, diverged)
    rc, out = run_both([a, b])
    assert rc == 1
    assert "DIFFER" in out
    assert "value mismatch: k/seed=1|a=2" in out
    # the untouched keys are NOT reported
    assert "k/seed=1|a=1" not in out.replace("k/seed=1|a=2", "")


def test_missing_key_reported_by_side(write_store, run_both, tmp_path):
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    write_store(a, ENTRIES)
    only_b = dict(ENTRIES)
    extra = only_b.pop("k/seed=2|a=1")
    write_store(b, {**only_b, "k/seed=9|fresh": extra})
    rc, out = run_both([a, b])
    assert rc == 1
    assert "only in A: k/seed=2|a=1" in out
    assert "only in B: k/seed=9|fresh" in out


def test_sqlite_and_json_stores_compare(write_store, run_both, tmp_path):
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.sqlite")
    write_store(a, ENTRIES)
    write_store(b, ENTRIES)
    rc, out = run_both([a, b])
    assert rc == 0 and "IDENTICAL" in out


def test_meta_key_sets_compared(write_store, run_both, tmp_path):
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    sa = write_store(a, ENTRIES)
    sb = write_store(b, ENTRIES)
    sa.put_meta("unit|x", "done")
    sa.save()
    assert run_both([a, b])[0] == 0        # values still identical
    rc, out = run_both([a, b, "--meta"])
    assert rc == 1 and "META KEYS DIFFER" in out
    sb.put_meta("unit|x", "done too")      # meta VALUES may differ freely
    sb.save()
    assert run_both([a, b, "--meta"])[0] == 0


def test_missing_file_raises(write_store, ref_tool, tmp_path):
    a = str(tmp_path / "a.json")
    write_store(a, ENTRIES)
    for tool in (compare_stores, ref_tool):
        with pytest.raises(FileNotFoundError):
            tool.main([a, str(tmp_path / "nope.json")])
