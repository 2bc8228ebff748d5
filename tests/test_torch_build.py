"""The kernel build's host side, which runs without nvcc: the library name
follows the sources and flags, the compiler's report is kept beside the
library, and a machine without nvcc gets a clear error at first use — never
at import."""

import shutil
import stat

import pytest

from repro_torch.kernels import _build


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build._digest()
    assert first == _build._digest()
    (csrc / "harris.cu").write_text((csrc / "harris.cu").read_text() + "\n// edited\n")
    assert _build._digest() != first


def test_every_source_and_signature_is_known():
    names = {p.name for p in _build.CSRC.iterdir()}
    assert set(_build.SOURCES) | set(_build.HEADERS) == names
    text = "".join((_build.CSRC / s).read_text() for s in _build.SOURCES)
    for fn in _build.SIGNATURES:
        assert f" {fn}(" in text, fn


def test_missing_nvcc_is_a_clear_error(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


FAKE_NVCC = """#!/bin/sh
# stands in for nvcc: writes the file after -o and prints a report line
out=""
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
echo "object" > "$out"
echo "ptxas info    : Used 40 registers for $out"
"""


def test_the_compiler_report_is_kept_beside_the_library(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    target = tmp_path / "build" / "libkernels-test.so"
    log = _build._compile(str(nvcc), target)
    assert target.exists()
    assert log.count("Used 40 registers") == len(_build.SOURCES)
    # a later process that finds the library reads the same report
    assert _build._report_path(target).read_text() == log
