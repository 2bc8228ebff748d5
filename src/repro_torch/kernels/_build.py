"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each ``csrc/*.cu`` file compiles to an object with its own ``nvcc`` process,
all started together, and the objects link into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds).  The
library lands in ``kernels/build/`` under a name derived from the sources and
flags, so a checkout builds once and an edited source builds anew.  Nothing
here runs at import time: the CPU tests import every module of the port on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from dataclasses import dataclass
from pathlib import Path

from ..core.clock import monotonic

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("add.cu", "harris.cu", "mandelbrot.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signature of every exported function: (argtypes, restype)
SIGNATURES = {
    "repro_add_f32": ((_P, _P, _P) + (_I,) * 11 + (_P,), _I),
    "repro_add_bf16": ((_P, _P, _P) + (_I,) * 11 + (_P,), _I),
    "repro_harris_f32": ((_P, _P) + (_I,) * 8 + (_F, _I, _P), _I),
    "repro_mandelbrot_f32": ((_P,) + (_I,) * 10 + (_F,) * 4 + (_I, _P), _I),
    "repro_add_smem_bytes": ((), _I),
    "repro_harris_smem_bytes": ((), _I),
    "repro_mandelbrot_smem_bytes": ((), _I),
    "repro_cuda_error_string": ((_I,), ctypes.c_char_p),
}


@dataclass(frozen=True)
class KernelLibrary:
    """The loaded library plus how it was built (for provenance)."""

    cdll: ctypes.CDLL
    path: str
    nvcc: str            # ``nvcc --version``'s release line
    build_s: float       # seconds this process spent building (0.0 if reused)
    ptxas_log: str       # ``-Xptxas -v`` report of the build (kept beside the library)


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels "
        "build from source at first use"
    )


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc_version(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout
    lines = [ln for ln in out.splitlines() if "release" in ln]
    return lines[-1].strip() if lines else out.strip().splitlines()[-1]


def _compile(nvcc: str, target: Path) -> str:
    """Compile every source in parallel, link one shared library to
    ``target`` (atomically), and return the compilers' combined report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        logs, failed = [], []
        for name, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(logs)
            )
        so = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(so), *(str(o) for _, o, _ in procs)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        log = "\n".join(logs)
        report = Path(tmp) / "ptxas.txt"
        report.write_text(log)
        os.replace(report, _report_path(target))   # before the library: a
        os.replace(so, target)                     # built library has its report
    return log


def _report_path(target: Path) -> Path:
    return target.with_name(target.name + ".ptxas.txt")


_lock = threading.Lock()
_loaded: list[KernelLibrary] = []


def library() -> KernelLibrary:
    """The kernel library, built on first use in this checkout."""
    with _lock:
        if _loaded:
            return _loaded[0]
        nvcc = find_nvcc()
        target = BUILD_DIR / f"librepro_torch_kernels-{_digest()}.so"
        if target.exists():
            build_s, log = 0.0, _report_path(target).read_text()
        else:
            t0 = monotonic()
            log = _compile(nvcc, target)
            build_s = monotonic() - t0
        cdll = ctypes.CDLL(str(target))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(cdll, name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
        lib = KernelLibrary(cdll=cdll, path=str(target), nvcc=_nvcc_version(nvcc),
                            build_s=build_s, ptxas_log=log)
        _loaded.append(lib)
        return lib


#: launch errors that depend on the launch's geometry or resources, and so on
#: the config (cudaErrorInvalidConfiguration, cudaErrorLaunchOutOfResources);
#: they leave the context usable.  Every other code does not depend on it.
CONFIG_ERRORS = frozenset({9, 701})


class LaunchError(RuntimeError):
    """A launcher returned a CUDA error code other than cudaSuccess."""

    def __init__(self, name: str, code: int, msg: str):
        super().__init__(f"{name}: CUDA launch failed with error {code} ({msg})")
        self.code = code

    @property
    def config_dependent(self) -> bool:
        return self.code in CONFIG_ERRORS


def launch(name: str, *args) -> None:
    """Call one exported launcher; raise :class:`LaunchError` if the launch
    was refused."""
    lib = library().cdll
    err = getattr(lib, name)(*args)
    if err != 0:
        raise LaunchError(name, err, lib.repro_cuda_error_string(err).decode())


def kernel_smem_bytes(kernel: str) -> int:
    """Static shared memory per block of a compiled kernel, as the CUDA
    runtime reports it."""
    n = getattr(library().cdll, f"repro_{kernel}_smem_bytes")()
    if n < 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed for {kernel}")
    return n
