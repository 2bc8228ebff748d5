#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card: ``nvidia-smi`` name and power limit, torch / CUDA / nvcc
   versions, compute capability (must be 9.0);
2. build: the kernel library from ``src/repro_torch/kernels/csrc`` with
   ``nvcc``, its build seconds and ``-Xptxas -v`` report, and the 16-byte
   global loads and stores in each kernel's machine code (``cuobjdump``
   beside ``nvcc``), which add's vector path must have; for harris its
   registers, spills (there must be none) and shared memory, and its counts
   of global-to-shared copies, shared and global loads and stores and
   barriers in the machine code;
3. each CUDA kernel against its plain PyTorch version on the card, at
   8192x8192, a ragged 1000x1000, a width that no 16-byte vector divides
   (1000x1001) and a small odd 37x129, over the reference tests' configs
   plus a large-tile and a clamped-duplicate config: add exactly (f32 and
   bf16, also with an input offset by one element, which takes the scalar
   path), mandelbrot exactly on every pixel, harris within 1e-5 of its
   largest value (also on an image offset by one element, which takes its
   4-byte copies, and at 8x130, one sub-tile high with a ragged column);
   with the count of elements that differ at all;
4. the main path: ``repro_torch.tune(TuningSpec(kernel=k, backend="cuda"))``
   at 8192x8192 for add, harris and mandelbrot (GA) and add (RS), each with
   the launch counts set to 0 just before and read just after, then each GA
   winner and the default config re-timed by the tuner's own timer; each
   call's host time outside the measurement stages (``search_s``);
   then every other searcher (``rf``, ``bo_gp``, ``bo_tpe``, ``sa``, ``pso``,
   ``grid``) through the same entry point on each kernel at 8192x8192,
   counted the same way, each winner held to the plain version and timed
   with CUDA events against the default config;
4c. the experiment matrix through ``repro_torch.tune_matrix`` at 8192x8192
   (backend ``cuda``, design S = 25, 50 with 4 and 2 experiments, 10 final
   repeats, a 200-sample dataset cached on disk): harris with the paper's
   five algorithms on the serial executor (cold; one line per cell, and the
   share of the wall time spent drawing and copying inputs), then replayed
   warm on the ``device`` executor from a copy of its store (no launch, the
   same cells, byte-identical store values, no shard file left), then
   resumed from the unit journal (no unit runs, no launch); add and
   mandelbrot with ``rs`` and ``ga`` on the serial executor; the three
   write their results into one directory as combos ``<kernel>/h100``;
   harris's cold run is traced (``telemetry_dir``): the trace's per-stage
   totals beside the units' summed ``stage_s`` (they must agree to 1e-6 s),
   its completed units and experiments against the plan, and ``python -m
   repro_torch.telemetry`` on the directory in a process of its own;
4d. stores and analysis: harris's cold JSON store copied into a sqlite
   store (values, unit journal, winners), the matrix replayed warm from it
   with ``store="sqlite"`` on the ``device`` executor (no launch, the cold
   run's cells, byte-identical store values, no shard file left) and
   resumed from its journal (no unit runs); then ``generate_report`` over
   the results directory: each claim's verdict line, the speedup-over-RS
   rows, the provenance (backend ``cuda``, the card, the code's version),
   a figure per plot where matplotlib is installed and the "tables only"
   line where it is not, the "Pipeline stage durations" table read from
   harris's trace, and ``python -m repro_torch.analysis`` on the same
   directory in a process of its own;
4e. serving, in a fresh serve dir, through ``python -m repro_torch.serving``:
   harris's cold store indexed; a query for harris at 8192x8192 on the
   card's name must hit with the config of the matrix's best final entry
   (with its ``serve_ms``), one at 4096x4096 must answer ``nearest``; a
   query for mandelbrot at 8192x8192 misses and queues a tuning job
   (``rs`` and ``ga`` at the smoke design); a fleet worker in a process of
   its own tunes it on the card (its launches are the phase's), ``collect``
   lists it and the query hits; the winner's config through the CUDA kernel
   equals the plain version exactly and is timed with CUDA events beside the
   default config; ``serve`` in a process of its own answers ``GET
   /best_config`` for harris with the query's JSON; the trace's serving
   counters match the queries made;
4f. the static gate: ``python -m repro_torch.staticcheck src/repro_torch
   --preflight-paper`` in a process of its own on the card's host (the
   registry checks import the real ``cuda`` backend there and must build
   and launch nothing), which must exit 0; then, in this process, the
   pre-flight of the three ``cuda`` specs phase 4c ran at 8192x8192 (no
   error finding; each kernel's SPEC001 constrained fraction printed);
   no kernel may launch and the kernel library must stay the same file;
5. timing at 8192x8192 with CUDA events: each kernel at the default config
   and at the tuned winner, its plain version, the matching PyTorch call
   where one exists, and the least time the card could take (bound; for
   mandelbrot also at the card's unfused f32 rate, since every operation
   of the kernel rounds on its own); for add also its vector and scalar
   paths on the same aligned inputs, in turns; for add and harris also at
   the default config on an input offset by one element;
6. one ``{"kernels": [...]}`` line, then the device line last.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

SHAPES = [(8192, 8192), (1000, 1000), (1000, 1001), (37, 129)]
CONFIGS = [
    {},
    dict(t_x=2, t_y=1, t_z=2, w_x=2, w_y=2, w_z=2),
    dict(t_x=1, t_y=2, t_z=3, w_x=3, w_y=1, w_z=1),
    dict(t_x=4, t_y=1, t_z=1, w_x=1, w_y=4, w_z=4),
    dict(t_x=16, t_y=16, t_z=16),
    dict(t_x=3, t_y=3, t_z=5, w_x=7, w_y=5),   # clamped duplicate blocks
]
#: harris also at one sub-tile's height with a ragged column (130 = 128 + 2)
HARRIS_SHAPES = [(8, 130)]
DEFAULT_CONFIG = dict(t_x=1, t_y=1, t_z=1, w_x=1, w_y=1, w_z=1)   # what {} means
MAIN_PATH = [("add", "ga"), ("harris", "ga"), ("mandelbrot", "ga"), ("add", "rs")]
#: the searchers the main path does not run, each tuned on every kernel
OTHER_SEARCHERS = ("rf", "bo_gp", "bo_tpe", "sa", "pso", "grid")
KERNELS = ("add", "harris", "mandelbrot")
BUDGET = 40
#: the matrix phase: a cut of the paper's design (E(S) = 20000 / S) to two
#: sample sizes and a few experiments, at full width
MATRIX_DESIGN = dict(sample_sizes=(25, 50), n_experiments=(4, 2), final_repeats=10)
MATRIX_DATASET = 200
MATRIX_ALGORITHMS = {"harris": ("rs", "rf", "ga", "bo_gp", "bo_tpe"),
                     "add": ("rs", "ga"), "mandelbrot": ("rs", "ga")}
#: the matrices' combo names are ``<kernel>/<CARD_TAG>``: the analysis layer
#: reads ``<bench>_<chip>.npz`` and splits the name at its last ``_``, so the
#: tag holds none (phase 1 requires compute capability 9.0)
CARD_TAG = "h100"

#: H100 SXM peaks (NVIDIA data sheet): HBM3 rate and f32 rate off the tensor
#: cores, which counts an FMA as two operations; f32 operations that do not
#: fuse issue at half that rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_F32_UNFUSED_PER_S = 33.5e12

KERNEL_INFO = {
    "add": ("src/repro_torch/kernels/csrc/add.cu", "src/repro/kernels/add/kernel.py:28"),
    "harris": ("src/repro_torch/kernels/csrc/harris.cu", "src/repro/kernels/harris/kernel.py:83"),
    "mandelbrot": ("src/repro_torch/kernels/csrc/mandelbrot.cu",
                   "src/repro/kernels/mandelbrot/kernel.py:54"),
}


def require(ok: bool, what) -> None:
    """Fail the run (unlike ``assert``, this survives ``python -O``)."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sass_of(lib_path: str, nvcc: str) -> str:
    """The library's machine code as ``cuobjdump -sass`` prints it."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          timeout=120, check=True).stdout


def sass_opcodes(sass: str) -> dict:
    """Per kernel function of ``cuobjdump -sass`` output, the opcodes (with
    their modifiers, e.g. ``LDG.E.128.CONSTANT``) of the instructions that
    can run, and how often each occurs."""
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        # an instruction predicated on !PT never runs (the compiler pads
        # cp.async with such shared loads)
        if m and name is not None and (m.group(1) or "").strip() != "@!PT":
            counts[name][m.group(2)] = counts[name].get(m.group(2), 0) + 1
    return counts


def count_ops(ops: dict, prefix: str) -> int:
    """How many instructions of ``ops`` have an opcode that is ``prefix``, or
    starts with it followed by a modifier."""
    return sum(n for op, n in ops.items() if op == prefix or op.startswith(prefix + "."))


def ptxas_report(log: str) -> dict:
    """Per kernel function, what ``-Xptxas -v`` reported: registers, stack
    frame, spill stores and loads, static shared memory (bytes)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(sm.group(1)) if sm else 0
    return out


def time_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean device time of one call over ``n`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def offset_copy(t):
    """``t`` in memory that starts one element past an aligned allocation:
    contiguous, but no row starts on a 16-byte boundary."""
    import torch

    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return flat[1:].view(t.shape).copy_(t)


def check_kernels() -> tuple[dict, dict]:
    """Phase 3: every kernel against its plain version on the card.
    Returns, per kernel at the main path's shape and over the configs, the
    largest |kernel - plain| and the most elements that differ at all."""
    import torch

    import repro_torch.kernels as K
    from repro_torch.kernels.add.ops import vector_path

    before = {k: c.n for k, c in K.LAUNCHES.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = {"add": 0.0, "harris": 0.0, "mandelbrot": 0.0}
    n_diff = {"add": 0, "harris": 0, "mandelbrot": 0}
    for x, y in SHAPES:
        a = torch.randn((x, y), generator=gen, device="cuda")
        b = torch.randn((x, y), generator=gen, device="cuda")
        img = torch.randn((x, y), generator=gen, device="cuda")
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        a_off, a16_off, img_off = offset_copy(a), offset_copy(a16), offset_copy(img)
        ref_add, ref_add16 = K.add_ref(a, b), K.add_ref(a16, b16)
        ref_h = K.harris_ref(img)
        ref_m = K.mandelbrot_ref(x, y, device="cuda")
        paths = {n: vector_path(p, q, torch.empty_like(p)) for n, p, q in
                 (("f32", a, b), ("bf16", a16, b16), ("f32 offset", a_off, b),
                  ("bf16 offset", a16_off, b16))}
        require(paths == {"f32": y % 4 == 0, "bf16": y % 8 == 0,
                          "f32 offset": False, "bf16 offset": False},
                f"add {x}x{y}: vector paths {paths}")
        for cfg in CONFIGS:
            out, out16 = K.add(a, b, cfg), K.add(a16, b16, cfg)
            err = (out - ref_add).abs().max().item()
            require(torch.equal(out, ref_add), f"add f32 {x}x{y} {cfg}: max err {err}")
            require(torch.equal(out16, ref_add16), f"add bf16 {x}x{y} {cfg}")
            require(torch.equal(K.add(a_off, b, cfg), ref_add),
                    f"add f32 {x}x{y} {cfg}, input offset by one element")
            require(torch.equal(K.add(a16_off, b16, cfg), ref_add16),
                    f"add bf16 {x}x{y} {cfg}, input offset by one element")

            h = K.harris(img, cfg)
            h_err = (h - ref_h).abs().max().item()
            rel = h_err / ref_h.abs().max().item()
            require(rel < 1e-5, f"harris {x}x{y} {cfg}: max|d|/max|ref| = {rel}")
            h_off = K.harris(img_off, cfg)
            rel_off = ((h_off - ref_h).abs().max() / ref_h.abs().max()).item()
            require(rel_off < 1e-5, f"harris {x}x{y} {cfg}, image offset by one element: "
                    f"max|d|/max|ref| = {rel_off}")
            h_diff = int((h != ref_h).sum().item())

            m = K.mandelbrot(x, y, cfg, device="cuda")
            m_diff = (m - ref_m).abs()
            m_err = m_diff.max().item()
            require(torch.equal(m, ref_m), f"mandelbrot {x}x{y} {cfg}: "
                    f"{int((m_diff != 0).sum().item())} pixels differ, max|d| {m_err}")
            torch.cuda.synchronize()
            if (x, y) == SHAPES[0]:
                max_err["add"] = max(max_err["add"], err)
                max_err["harris"] = max(max_err["harris"], h_err)
                max_err["mandelbrot"] = max(max_err["mandelbrot"], m_err)
                for k, d in (("add", out != ref_add), ("harris", h != ref_h),
                             ("mandelbrot", m_diff != 0)):
                    n_diff[k] = max(n_diff[k], int(d.sum().item()))
            print(f"check {x}x{y} {json.dumps(cfg, sort_keys=True)}: add exact (f32, bf16, "
                  f"aligned and offset; vector paths {paths}); harris rel {rel:.3e} "
                  f"(offset image {rel_off:.3e}) < 1e-5, {h_diff} elements differ; "
                  f"mandelbrot exact on every pixel")
        del a, b, img, a16, b16, a_off, a16_off, img_off, ref_add, ref_add16, ref_h, ref_m
        torch.cuda.empty_cache()
    for x, y in HARRIS_SHAPES:
        img = torch.randn((x, y), generator=gen, device="cuda")
        ref_h = K.harris_ref(img)
        for cfg in CONFIGS:
            h = K.harris(img, cfg)
            rel = ((h - ref_h).abs().max() / ref_h.abs().max()).item()
            require(rel < 1e-5, f"harris {x}x{y} {cfg}: max|d|/max|ref| = {rel}")
            h_diff = int((h != ref_h).sum().item())
            print(f"check harris {x}x{y} {json.dumps(cfg, sort_keys=True)}: rel {rel:.3e} "
                  f"< 1e-5, {h_diff} elements differ")
    for k, c in K.LAUNCHES.items():
        require(c.n > before[k], f"{k}: launch counter did not move during the checks")
    print(f"check {SHAPES[0][0]}x{SHAPES[0][1]}: most differing elements {n_diff}")
    return max_err, n_diff


def tune_once(kernel: str, searcher: str):
    """One tune call through the public entry point, with the launch counts
    set to 0 just before it and read just after; its line, and the checks
    every tune call must pass.  ``search_s`` is the call's host time outside
    the measurement stages: the searcher's proposals, its surrogate, the
    validity screen it applies to what it samples."""
    import torch

    from repro_torch import TuningSession, TuningSpec
    from repro_torch.kernels import LAUNCHES

    session = TuningSession(TuningSpec(kernel=kernel, backend="cuda", searcher=searcher,
                                       budget=BUDGET, seed=0))
    for c in LAUNCHES.values():
        c.n = 0
    result = session.run()
    torch.cuda.synchronize()
    got = {k: c.n for k, c in LAUNCHES.items()}
    prov = session.last_record.extra["backend_provenance"]
    wall_s = session.last_record.provenance["wall_s"]
    search_s = wall_s - sum(prov["stage_s"].values())
    sampled = [v for c, v in zip(result.history_configs, result.history_values)
               if dict(c) == DEFAULT_CONFIG]
    print(f"tune {kernel}/{searcher}: "
          f"best_config={json.dumps(result.best_config, sort_keys=True)} "
          f"final_value={result.final_value!r} s n_samples={result.n_samples} "
          f"n_invalid={prov['n_invalid']} n_compiles={prov['n_compiles']} "
          f"device_kind={prov['device_kind']!r} launches={got} "
          f"wall_s={wall_s} stage_s={prov['stage_s']} search_s={search_s:.3f} "
          f"default_sampled={bool(sampled)}")
    require(math.isfinite(result.final_value) and result.final_value > 0,
            f"{kernel}/{searcher}: final_value {result.final_value}")
    require(result.n_samples == BUDGET, f"{kernel}/{searcher}: n_samples {result.n_samples}")
    require(got[kernel] > 0, f"{kernel}/{searcher}: the tune call launched no kernel")
    require(all(n == 0 for k, n in got.items() if k != kernel), got)
    require(prov["device"] == "cuda" and prov["launches"] == got[kernel], prov)
    stats = dict(final_ms=result.final_value * 1e3, default_sampled=bool(sampled),
                 default_sampled_ms=sampled[0] * 1e3 if sampled else None,
                 n_invalid=prov["n_invalid"], wall_s=wall_s, stage_s=prov["stage_s"],
                 search_s=search_s)
    return session, result, got[kernel], stats


def run_main_path() -> dict:
    """Phase 4: the tuning loop through the public entry point.  For each GA
    run, afterwards: whether the default config was among the samples, and
    the winner and the default re-measured one after the other by the
    tuner's own timer (host clock around launch + synchronize)."""
    winners, tuner, counted = {}, {}, {k: 0 for k in KERNELS}
    for kernel, searcher in MAIN_PATH:
        session, result, launches, stats = tune_once(kernel, searcher)
        counted[kernel] += launches
        if searcher == "ga":
            winners[kernel] = result.best_config
            m = session.measurement
            tuner[kernel] = dict(
                final_ms=stats["final_ms"],
                default_sampled=stats["default_sampled"],
                default_sampled_ms=stats["default_sampled_ms"],
                host_ms_winner=m.measure_final(result.best_config, repeats=10) * 1e3,
                host_ms_default=m.measure_final(DEFAULT_CONFIG, repeats=10) * 1e3,
            )
            print(f"tune {kernel}/{searcher} afterwards: "
                  + " ".join(f"{k}={v!r}" for k, v in tuner[kernel].items()))
    return {"winners": winners, "tuner": tuner, "launches": counted}


def run_searchers() -> dict:
    """Phase 4b: every searcher the main path does not run, on each kernel,
    counted as the main path is.  ``rf``'s winner must be one of its 10
    measured predictions.  Afterwards, per kernel, each winner held to the
    plain version and timed with CUDA events, the default config timed
    before and after them."""
    import torch

    import repro_torch.kernels as K

    out, counted = {k: {} for k in KERNELS}, {k: 0 for k in KERNELS}
    for kernel in KERNELS:
        for searcher in OTHER_SEARCHERS:
            _, result, launches, stats = tune_once(kernel, searcher)
            if searcher == "rf":
                require(result.best_config in result.history_configs[-10:],
                        f"{kernel}/rf: best_config {result.best_config} is not one of "
                        "its 10 measured predictions")
            counted[kernel] += launches
            out[kernel][searcher] = dict(best_config=result.best_config, **stats)

    x, y = SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(2)
    a = torch.randn((x, y), generator=gen, device="cuda")
    b = torch.randn((x, y), generator=gen, device="cuda")
    ref_add, ref_h = K.add_ref(a, b), K.harris_ref(a)
    ref_m = K.mandelbrot_ref(x, y, device="cuda")
    runs = {
        "add": (lambda cfg: K.add(a, b, cfg), lambda o: torch.equal(o, ref_add), 50),
        "harris": (lambda cfg: K.harris(a, cfg),
                   lambda o: ((o - ref_h).abs().max() / ref_h.abs().max()).item() < 1e-5, 50),
        "mandelbrot": (lambda cfg: K.mandelbrot(x, y, cfg, device="cuda"),
                       lambda o: torch.equal(o, ref_m), 20),
    }
    for kernel, (run, agrees, n) in runs.items():
        default_ms = [time_ms(lambda: run(DEFAULT_CONFIG), n)]
        for searcher, row in out[kernel].items():
            require(agrees(run(row["best_config"])), f"{kernel}/{searcher} winner")
            row["ms"] = time_ms(lambda c=row["best_config"]: run(c), n)
        default_ms.append(time_ms(lambda: run(DEFAULT_CONFIG), n))
        for searcher, row in out[kernel].items():
            row["ms_default"] = default_ms
            print(f"searcher {kernel}/{searcher} {x}x{y}: "
                  + " ".join(f"{k}={v!r}" for k, v in row.items()))
    return {"searchers": out, "launches": counted}


@contextlib.contextmanager
def timed_materialize():
    """Counts the input materialisations inside the block and their seconds:
    every fresh ``CudaMeasurement`` draws its inputs with numpy and copies
    them to the card, as the reference's measurements do.  The script wraps
    the method only to measure that share of a matrix run."""
    import torch

    from repro_torch.cuda_bench.workloads import CudaWorkload

    orig = CudaWorkload.materialize
    stats = {"n": 0, "s": 0.0}

    def materialize(self, device="cpu"):
        t0 = time.perf_counter()
        out = orig(self, device)
        torch.cuda.synchronize()
        stats["n"] += 1
        stats["s"] += time.perf_counter() - t0
        return out

    CudaWorkload.materialize = materialize
    try:
        yield stats
    finally:
        CudaWorkload.materialize = orig


def store_values(path: str) -> str:
    """A JSON store's measurement values, canonically: sorted ``(key,
    value)`` pairs as JSON (journal entries carry wall-clocks and are left
    out)."""
    with open(path) as f:
        raw = json.load(f)
    values = raw["values"] if isinstance(raw, dict) and "__format__" in raw else raw
    return json.dumps(sorted(values.items()), sort_keys=True)


def same_cells(a, b) -> bool:
    import numpy as np

    return set(a.cells) == set(b.cells) and all(
        np.array_equal(getattr(a.cells[k], n), getattr(b.cells[k], n))
        for k in a.cells for n in ("final_values", "search_best_values", "n_samples_used"))


def matrix_cold(kernel: str, tmp: str, telemetry_dir: str | None = None):
    """One cold serial ``tune_matrix`` at 8192x8192, counted as the main
    path is, traced into ``telemetry_dir`` when given; its cell lines and
    checks.  Returns the spec, the results, the kernel's launches, the run's
    wall seconds and its materialisations."""
    import numpy as np
    import torch

    from repro_torch import ExperimentDesign, RunRecord, TuningSpec, tune_matrix
    from repro_torch.kernels import LAUNCHES

    spec = TuningSpec(kernel=kernel, backend="cuda", algorithms=MATRIX_ALGORITHMS[kernel],
                      design=ExperimentDesign(**MATRIX_DESIGN), dataset_size=MATRIX_DATASET,
                      dataset_cache=os.path.join(tmp, f"{kernel}_dataset.npz"),
                      store="json", store_path=os.path.join(tmp, f"{kernel}_cold.json"),
                      cache_key=f"{kernel}/{CARD_TAG}")
    out_dir = results_dir(tmp)
    for c in LAUNCHES.values():
        c.n = 0
    t0 = time.perf_counter()
    with timed_materialize() as inputs:
        results = tune_matrix(spec, out_dir=out_dir, telemetry_dir=telemetry_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: c.n for k, c in LAUNCHES.items()}
    record = RunRecord.load(os.path.join(out_dir, f"{kernel}_{CARD_TAG}.json"))
    walls = {(w["algo"], w["sample_size"]): w for w in record.extra["cell_wall_s"]}
    for (algo, s), cell in sorted(results.cells.items()):
        w = walls[(algo, s)]
        print(f"matrix {kernel}/{algo} S={s}: "
              f"median_final_ms={float(np.median(cell.final_values)) * 1e3!r} "
              f"best_final_ms={float(cell.final_values.min()) * 1e3!r} "
              f"n_samples_used={cell.n_samples_used.tolist()} wall_s={w['wall_s']} "
              f"compile_s={w['compile_s']} measure_s={w['measure_s']}")
        require(cell.n_samples_used.tolist() == [s] * len(cell.n_samples_used),
                f"matrix {kernel}/{algo} S={s}: samples {cell.n_samples_used.tolist()}")
        require(bool(np.isfinite(cell.final_values).all()),
                f"matrix {kernel}/{algo} S={s}: finals {cell.final_values.tolist()}")
    prov = record.extra["backend_provenance"]
    print(f"matrix {kernel} cold serial: wall_s={wall:.3f} launches={got} "
          f"materialised={inputs['n']} materialise_s={inputs['s']:.3f} "
          f"({100 * inputs['s'] / wall:.1f} % of wall) device_kind={prov['device_kind']!r}")
    require(got[kernel] > 0, f"matrix {kernel}: the cold run launched no kernel")
    require(all(n == 0 for k, n in got.items() if k != kernel), got)
    require(prov["device"] == "cuda" and prov["device_kind"] == torch.cuda.get_device_name(0),
            f"matrix {kernel}: provenance {prov}")
    return spec, results, got[kernel], dict(wall_s=wall, materialised=inputs["n"],
                                            materialise_s=inputs["s"])


def check_trace(spec, run_dir: str) -> dict:
    """Harris's cold trace against the run: each stage's trace total beside
    the units' summed ``stage_s`` (read back from the unit journal), which
    must agree to 1e-6 s; the completed units and experiments against the
    plan; the trace's command line in a process of its own."""
    from repro_torch import TuningSession, build_units
    from repro_torch.telemetry import read_run, stage_percentiles, summarize

    events = read_run(run_dir)
    plans = [e for e in events if e.get("ev") == "plan"]
    require(len(plans) == 1, f"trace: {len(plans)} plan events")
    session = TuningSession(spec)
    cells = session.cells()
    units = build_units(cells, min_units=1, cost=session._unit_cost())
    journal = session.unit_journal()
    stage_s: dict = {}
    for u in units:
        result = journal.get(u)
        require(result is not None, f"trace: unit {u.key} not journaled")
        for k, v in result.stage_s.items():
            stage_s[k] = stage_s.get(k, 0.0) + v
    if hasattr(session.store, "close"):
        session.store.close()
    totals = {k: v["total_s"] for k, v in stage_percentiles(events).items()}
    diff = {k: abs(totals.get(k, 0.0) - stage_s.get(k, 0.0)) for k in set(totals) | set(stage_s)}
    summary = summarize(run_dir)
    counters = summary["counters"]
    n_exp = sum(e for _, _, e in cells)
    cli = subprocess.run([sys.executable, "-m", "repro_torch.telemetry", run_dir],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    print(f"trace harris cold: events={summary['n_events']} stage_total_s={totals} "
          f"units_stage_s={stage_s} max_abs_diff_s={max(diff.values())!r} "
          f"units_completed={counters.get('units_completed')}/{plans[0]['units_total']} "
          f"experiments_completed={counters.get('experiments_completed')}/{n_exp} "
          f"compiles={counters.get('compiles')} store_misses={counters.get('store_misses')} "
          f"invalid={summary['invalid']} cli_exit={cli.returncode}")
    require(set(totals) == {"screen", "compile", "time", "record"}, f"trace stages {totals}")
    require(max(diff.values()) <= 1e-6, f"trace stage totals differ from stage_s by {diff}")
    require(plans[0]["units_total"] == len(units) == counters.get("units_completed"),
            f"trace: units planned {plans[0]['units_total']}, built {len(units)}, "
            f"completed {counters.get('units_completed')}")
    require(plans[0]["experiments_total"] == n_exp == counters.get("experiments_completed"),
            f"trace: experiments planned {plans[0]['experiments_total']}, {n_exp} in the "
            f"design, completed {counters.get('experiments_completed')}")
    require(cli.returncode == 0 and "per-stage durations" in cli.stdout,
            f"python -m repro_torch.telemetry: exit {cli.returncode}: {cli.stderr[-2000:]}")
    return dict(stage_total_s=totals, max_abs_diff_s=max(diff.values()),
                n_events=summary["n_events"], counters=counters)


def results_dir(tmp: str) -> str:
    """The one results directory the three cold matrices write into."""
    return os.path.join(tmp, "results")


def run_matrix_phase(tmp: str) -> dict:
    """Phase 4c: the experiment matrix on the card.  Harris cold on the
    serial executor, replayed warm on the device executor, then resumed from
    its journal; add and mandelbrot cold.  Each run's counts are set to 0
    just before it and read just after."""
    import warnings

    import torch

    from repro_torch import TuningSession, tune_matrix
    from repro_torch.kernels import LAUNCHES

    counted, stats = {k: 0 for k in KERNELS}, {}
    spec, cold, n, stats["harris"] = matrix_cold("harris", tmp, telemetry_dir=results_dir(tmp))
    counted["harris"] += n
    stats["harris"]["trace"] = check_trace(spec, results_dir(tmp))

    # warm replay: one worker per card; asking for two on a one-card
    # host caps to one thread (with a warning) rather than degrading to
    # the serial loop, so the executor's pinned thread does the work
    warm_spec = spec.replace(store_path=os.path.join(tmp, "harris_warm.json"))
    shutil.copy(spec.store_path, warm_spec.store_path)
    workers = max(2, torch.cuda.device_count())
    for c in LAUNCHES.values():
        c.n = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        warm = tune_matrix(warm_spec, executor="device", max_workers=workers)
    torch.cuda.synchronize()
    got = {k: c.n for k, c in LAUNCHES.items()}
    shards = [f for f in os.listdir(tmp) if ".shard" in f]
    same_store = store_values(warm_spec.store_path) == store_values(spec.store_path)
    print(f"matrix harris warm device executor ({workers} workers asked, "
          f"{torch.cuda.device_count()} card(s)): wall_s={time.perf_counter() - t0:.3f} "
          f"launches={got} same_cells={same_cells(cold, warm)} "
          f"store_values_identical={same_store} shard_files={shards} "
          f"warnings={[str(w.message) for w in caught]}")
    require(all(n == 0 for n in got.values()), f"matrix warm replay launched {got}")
    require(same_cells(cold, warm), "matrix warm replay: cells differ from the cold run")
    require(same_store, "matrix warm replay: store values differ from the cold run")
    require(not shards, f"matrix warm replay left shard files {shards}")

    # resume: every unit from the journal, so no unit runs at all
    for c in LAUNCHES.values():
        c.n = 0
    t0 = time.perf_counter()
    session = TuningSession(warm_spec)
    resumed = session.run_matrix(resume=True)
    got = {k: c.n for k, c in LAUNCHES.items()}
    print(f"matrix harris resume: wall_s={time.perf_counter() - t0:.3f} launches={got} "
          f"units={len(session.last_unit_plan)} units_run={int(session.measurement is not None)} "
          f"same_cells={same_cells(cold, resumed)}")
    require(all(n == 0 for n in got.values()), f"matrix resume launched {got}")
    require(session.measurement is None, "matrix resume ran a unit")
    require(same_cells(cold, resumed), "matrix resume: cells differ from the cold run")

    specs = {"harris": spec}
    for kernel in ("add", "mandelbrot"):
        specs[kernel], _, n, stats[kernel] = matrix_cold(kernel, tmp)
        counted[kernel] += n
    return {"launches": counted, "stats": stats, "harris": (spec, cold), "specs": specs}


def sqlite_values(path: str) -> str:
    """A sqlite store's measurement values in :func:`store_values`' form."""
    from repro_torch import make_store

    store = make_store("sqlite", path)
    try:
        return json.dumps(sorted(store.items()), sort_keys=True)
    finally:
        store.close()


def run_stores_phase(tmp: str, spec, cold) -> None:
    """Phase 4d: harris's cold JSON store copied into sqlite, the matrix
    replayed warm from it on the device executor and resumed from its
    journal, each with the counts set to 0 just before and read just after;
    then the report over the three cold matrices' results directory, and
    the report's command line in a process of its own."""
    import warnings

    import torch

    import repro_torch
    from repro_torch import TuningSession, make_store, tune_matrix
    from repro_torch.analysis import (
        HAVE_MATPLOTLIB,
        check_claims,
        generate_report,
        load_all,
        speedup_with_ci,
    )
    from repro_torch.core.executors import absorb_store
    from repro_torch.kernels import LAUNCHES

    # sqlite warm replay from a copy of the cold store: values, the unit
    # journal (metadata) and winners
    lite_spec = spec.replace(store="sqlite", store_path=os.path.join(tmp, "harris_warm.sqlite"))
    lite = make_store("sqlite", lite_spec.store_path)
    absorb_store(lite, "json", spec.store_path)
    n_copied = len(lite)
    lite.close()
    workers = max(2, torch.cuda.device_count())
    for c in LAUNCHES.values():
        c.n = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        warm = tune_matrix(lite_spec, executor="device", max_workers=workers)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: c.n for k, c in LAUNCHES.items()}
    shards = [f for f in os.listdir(tmp) if ".shard" in f]
    same_store = sqlite_values(lite_spec.store_path) == store_values(spec.store_path)
    print(f"stores harris sqlite warm device executor: wall_s={wall:.3f} "
          f"values_copied={n_copied} launches={got} same_cells={same_cells(cold, warm)} "
          f"store_values_identical={same_store} shard_files={shards} "
          f"warnings={[str(w.message) for w in caught]}")
    require(n_copied > 0, "stores: the sqlite copy holds no value")
    require(all(n == 0 for n in got.values()), f"stores: sqlite warm replay launched {got}")
    require(same_cells(cold, warm), "stores: sqlite warm replay cells differ from the cold run")
    require(same_store, "stores: sqlite store values differ from the cold JSON store")
    require(not shards, f"stores: sqlite warm replay left shard files {shards}")

    for c in LAUNCHES.values():
        c.n = 0
    t0 = time.perf_counter()
    session = TuningSession(lite_spec)
    resumed = session.run_matrix(resume=True)
    got = {k: c.n for k, c in LAUNCHES.items()}
    print(f"stores harris sqlite resume: wall_s={time.perf_counter() - t0:.3f} launches={got} "
          f"units={len(session.last_unit_plan)} units_run={int(session.measurement is not None)} "
          f"same_cells={same_cells(cold, resumed)}")
    require(all(n == 0 for n in got.values()), f"stores: sqlite resume launched {got}")
    require(session.measurement is None, "stores: sqlite resume ran a unit")
    require(same_cells(cold, resumed), "stores: sqlite resume cells differ from the cold run")

    # the report over the three cold matrices
    out = results_dir(tmp)
    t0 = time.perf_counter()
    path = generate_report(out)
    report_s = time.perf_counter() - t0
    results = load_all(out)
    require(sorted(results) == [(k, CARD_TAG) for k in sorted(KERNELS)],
            f"report: combos {sorted(results)}")
    claims = check_claims(results)
    for v in claims.values():
        print(f"report claim {v}")
    require(all(v.status in ("pass", "fail", "insufficient-data") for v in claims.values()),
            f"report: claim statuses {[v.status for v in claims.values()]}")
    for (bench, chip), algos in sorted(speedup_with_ci(results).items()):
        for algo, row in algos.items():
            print(f"report speedup over rs {bench} x {chip} {algo}: " + " ".join(
                f"S={s}: {m!r} [{lo!r}, {hi!r}]" for s, (m, lo, hi) in sorted(row.items())))
    with open(path) as f:
        text = f.read()
    start = text.index("## Provenance")
    provenance = text[start:text.index("\n## ", start + 1)]
    kind = torch.cuda.get_device_name(0)
    for want in ("| cuda |", f'"device_kind": "{kind}"', f"| {repro_torch.__version__}"):
        require(want in provenance, f"report: provenance lacks {want!r}:\n{provenance}")
    figures = sorted(os.listdir(os.path.join(out, "figures"))) if HAVE_MATPLOTLIB else []
    if HAVE_MATPLOTLIB:
        require(figures == ["pct_of_optimum.png", "rank_heatmap.png",
                            "speedup_vs_sample_size.png"], f"report: figures {figures}")
    else:
        require("(matplotlib unavailable — tables only)" in text, "report: no tables-only line")
    require("### Pipeline stage durations" in text, "report: no pipeline stage durations table")
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", out, "--out",
         os.path.join(tmp, "REPORT_cli.md")],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    print(f"report: wall_s={report_s:.3f} claims={len(claims)} "
          f"decided={sum(v.status != 'insufficient-data' for v in claims.values())} "
          f"matplotlib={HAVE_MATPLOTLIB} figures={figures} bytes={len(text)} "
          f"cli_exit={cli.returncode} {cli.stdout.strip()!r}")
    require(cli.returncode == 0, f"report CLI: exit {cli.returncode}: {cli.stderr[-2000:]}")


def serving_cli(*argv: str) -> str:
    """``python -m repro_torch.serving <argv>`` in this process; its output.
    A non-zero exit fails the run."""
    import io

    from repro_torch.serving.__main__ import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(list(argv))
    require(rc == 0, f"serving {argv[0]}: exit {rc}: {out.getvalue()[-2000:]}")
    return out.getvalue()


def best_final_config(store_path: str) -> dict:
    """The config of the best re-measured (``|final``) entry of a JSON
    store, found by a scan of its values of its own."""
    from repro_torch.serving.winners import parse_config_from_store_key

    with open(store_path) as f:
        raw = json.load(f)
    values = raw["values"] if isinstance(raw, dict) and "__format__" in raw else raw
    value, key = min((v, k) for k, v in values.items() if "|final" in k)
    return parse_config_from_store_key(key)


def run_serving_phase(tmp: str, harris_spec) -> dict:
    """Phase 4e: tuning-as-a-service on the card, in a fresh serve dir.
    The worker is the only part that launches kernels; it runs in a process
    of its own, which starts with its counts at 0, and reports them."""
    import signal
    import socket
    import urllib.parse
    import urllib.request

    import torch

    import repro_torch.kernels as K
    from repro_torch.telemetry.assert_counters import main as assert_counters

    card = torch.cuda.get_device_name(0)
    d = os.path.join(tmp, "serve")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    geometry = ["--x", "8192", "--y", "8192", "--device", card]

    def query(kernel: str, *extra: str) -> dict:
        return json.loads(serving_cli("query", "--dir", d, "--telemetry", "--kernel", kernel,
                                      *extra).strip().splitlines()[-1])

    t0 = time.perf_counter()
    print("serving index: " + serving_cli("index", "--dir", d, harris_spec.store_path
                                          ).strip().replace("\n", "; "))
    hit = query("harris", *geometry, "--expect", "hit")
    want = best_final_config(harris_spec.store_path)
    print(f"serving query harris 8192x8192 {card!r}: status={hit['status']} "
          f"config={json.dumps(hit['config'], sort_keys=True)} value={hit['value']!r} "
          f"serve_ms={hit['serve_ms']!r} matrix_best_final={json.dumps(want, sort_keys=True)}")
    require(hit["config"] == want, f"serving: hit {hit['config']} is not the best final {want}")
    near = query("harris", "--x", "4096", "--y", "4096", "--device", card, "--expect", "nearest")
    print(f"serving query harris 4096x4096: status={near['status']} "
          f"matched_key={near['matched_key']!r} serve_ms={near['serve_ms']!r}")
    miss = query("mandelbrot", *geometry, "--enqueue", "--expect", "miss")
    require(bool(miss["job_id"]), f"serving: the miss queued no job: {miss}")
    print(f"serving query mandelbrot 8192x8192: status={miss['status']} job_id={miss['job_id']} "
          f"serve_ms={miss['serve_ms']!r}")
    jobs = [json.loads(line) for line in serving_cli("jobs", "--dir", d).splitlines()]
    require(jobs == [{"id": miss["job_id"], "kernel": "mandelbrot", "state": "pending"}],
            f"serving: jobs {jobs}")

    t1 = time.perf_counter()
    worker = subprocess.run(
        [sys.executable, "-m", "repro_torch.serving", "worker", "--dir", d, "--max-jobs", "1",
         "--telemetry", "--ident", "card0"],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    worker_s = time.perf_counter() - t1
    line = worker.stdout.strip().splitlines()[-1] if worker.stdout.strip() else ""
    print(f"serving worker: exit={worker.returncode} wall_s={worker_s:.3f} {line}")
    require(worker.returncode == 0 and "1 job(s) completed" in line,
            f"serving worker: exit {worker.returncode}: {worker.stderr[-3000:]}")
    launches = json.loads(line.split("launches ", 1)[1])
    require(launches["mandelbrot"] > 0, f"serving worker launched no mandelbrot: {launches}")
    require(launches["add"] == launches["harris"] == 0, f"serving worker launched {launches}")
    collected = serving_cli("collect", "--dir", d, "--telemetry").strip()
    print(f"serving collect: {collected}")
    require(miss["job_id"] in collected, f"serving collect: {collected}")
    filled = query("mandelbrot", *geometry, "--expect", "hit")
    cfg = filled["config"]
    print(f"serving query mandelbrot 8192x8192 after collect: status={filled['status']} "
          f"config={json.dumps(cfg, sort_keys=True)} value={filled['value']!r} "
          f"serve_ms={filled['serve_ms']!r}")

    # the served winner through the CUDA kernel (uncounted: a comparison)
    x, y = 8192, 8192
    ref = K.mandelbrot_ref(x, y, device="cuda")
    out = K.mandelbrot(x, y, cfg, device="cuda")
    require(torch.equal(out, ref), "serving: the winner's mandelbrot differs from the plain one")
    ms = [time_ms(lambda: K.mandelbrot(x, y, DEFAULT_CONFIG, device="cuda"), 20),
          time_ms(lambda: K.mandelbrot(x, y, cfg, device="cuda"), 20),
          time_ms(lambda: K.mandelbrot(x, y, cfg, device="cuda"), 20),
          time_ms(lambda: K.mandelbrot(x, y, DEFAULT_CONFIG, device="cuda"), 20)]
    print(f"serving mandelbrot winner {x}x{y}: exact on every pixel; ms default/winner/"
          f"winner/default={ms}")

    # the HTTP endpoint in a process of its own, stopped as a user stops it
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    server = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serving", "serve", "--dir", d, "--port", str(port),
         "--telemetry"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)
    try:
        banner = server.stdout.readline().strip()
        qs = urllib.parse.urlencode(dict(kernel="harris", x=x, y=y, device=card))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/best_config?{qs}",
                                    timeout=60) as resp:
            body = json.loads(resp.read())
    finally:
        server.send_signal(signal.SIGINT)
        try:
            server.wait(timeout=60)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()
    same = {k: v for k, v in body.items() if k != "age_s"} == {
        k: v for k, v in hit.items() if k not in ("age_s", "serve_ms")}
    print(f"serving http: {banner} GET /best_config harris: status={body['status']} "
          f"same_as_query={same} server_exit={server.returncode}")
    require(same, f"serving http: {body} differs from the query's {hit}")

    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = assert_counters([d, "serve.hits==3", "serve.nearest==1", "serve.misses==1",
                              "serve.enqueued==1", "fleet.jobs_completed==1",
                              "fleet.jobs_collected==1"])
    print(f"serving counters: {out.getvalue().strip()}")
    require(rc == 0, "serving: the trace's counters differ from the queries made")
    wall = time.perf_counter() - t0
    return {"launches": launches["mandelbrot"], "worker_s": worker_s, "wall_s": wall,
            "winner": cfg, "hit_serve_ms": hit["serve_ms"], "ms_default_winner": ms}


def file_digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


#: ``path:line:col: RULE[ [severity]] message``, as the gate prints a finding
FINDING_LINE = re.compile(r"^.*:\d+:\d+: [A-Z]+\d* (?:\[(warning|info)\] )?")


def run_staticcheck_phase(specs: dict) -> None:
    """Phase 4f: the port's static gate on the card's host.  The gate's CLI
    over the port's tree, with its registries and the paper matrix's
    pre-flight, in a process of its own; then the pre-flight of phase 4c's
    ``cuda`` specs here.  Neither may launch a kernel or rebuild the
    library."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels._build import library
    from repro_torch.staticcheck import preflight_spec
    from repro_torch.staticcheck.findings import format_finding
    from repro_torch.staticcheck.runner import iter_py_files
    from repro_torch.staticcheck.spec_rules import _resolve_space, constrained_fraction

    lib = library()
    lib_before = file_digest(lib.path)
    for c in LAUNCHES.values():
        c.n = 0
    t0 = time.perf_counter()
    port = os.path.join(ROOT, "src", "repro_torch")
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.staticcheck", port, "--preflight-paper"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    cli_s = time.perf_counter() - t0
    lines = cli.stdout.strip().splitlines()
    for line in lines:
        print(f"  {line}")
    require(cli.returncode == 0,
            f"staticcheck CLI: exit {cli.returncode}: {cli.stdout[-2000:]}{cli.stderr[-2000:]}")
    severities = {"error": 0, "warning": 0, "info": 0}
    for line in lines[:-1]:
        m = FINDING_LINE.match(line)
        require(m is not None, f"staticcheck CLI: unparsed line {line!r}")
        severities[m.group(1) or "error"] += 1
    require(severities["error"] == 0, f"staticcheck CLI: {severities}")

    fractions = {}
    for kernel, spec in specs.items():
        findings = preflight_spec(spec, where=f"<cuda:{kernel}/8192x8192>")
        for f in findings:
            print(f"  {format_finding(f)}")
        require(not [f for f in findings if f.severity == "error"],
                f"staticcheck: the {kernel} spec of phase 4c has error findings")
        fractions[kernel] = constrained_fraction(_resolve_space(spec))
    wall = time.perf_counter() - t0
    got = {k: c.n for k, c in LAUNCHES.items()}
    lib_after = file_digest(lib.path)
    n_files = len(iter_py_files([port]))
    print(f"staticcheck: wall_s={wall:.3f} cli_s={cli_s:.3f} files={n_files} "
          f"findings={severities} spec001_fraction={fractions} launches={got} "
          f"library={os.path.basename(lib.path)} sha256={lib_after[:16]} "
          f"unchanged={lib_after == lib_before and library() is lib}")
    require(all(n == 0 for n in got.values()), f"staticcheck launched {got}")
    require(lib_after == lib_before and library() is lib, "staticcheck: the library changed")


def time_add_paths(a, b, winner: dict) -> dict:
    """add's vector and scalar paths on the same aligned inputs, each launched
    through its C entry point (uncounted: these launches are not the main
    path's) and held to the plain version, then timed in turns: vector,
    scalar, scalar, vector; at the default tile, at t_x=4 t_z=2, at the GA
    winner, and in bf16 at the default tile."""
    import torch

    import repro_torch.kernels as K
    from repro_torch.kernels._build import launch
    from repro_torch.kernels.add.ops import launch_args, vector_path

    stream = torch.cuda.current_stream().cuda_stream

    def on_path(p, q, cfg: dict, vector: bool):
        out = torch.empty_like(p)
        launch("repro_add_bf16" if p.dtype == torch.bfloat16 else "repro_add_f32",
               p.data_ptr(), q.data_ptr(), out.data_ptr(),
               *launch_args(*p.shape, cfg, vector), p.device.index, stream)
        return out

    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    cases = {"f32 default": (a, b, {}), "f32 t_x=4 t_z=2": (a, b, dict(t_x=4, t_z=2)),
             "f32 winner": (a, b, winner), "bf16 default": (a16, b16, {})}
    out = {}
    for label, (p, q, cfg) in cases.items():
        require(vector_path(p, q, torch.empty_like(p)), f"add {label}: inputs not aligned")
        ref = K.add_ref(p, q)
        ms = {"vector": [], "scalar": []}
        for path in ms:
            require(torch.equal(on_path(p, q, cfg, path == "vector"), ref),
                    f"add {label}, {path} path")
        for path in ("vector", "scalar", "scalar", "vector"):
            ms[path].append(time_ms(lambda v=path == "vector": on_path(p, q, cfg, v), 50))
        out[label] = ms
    return out


def time_kernels(winners: dict) -> dict:
    """Phase 5: device times at the main path's shape, each tuned winner
    checked once more against the plain version first."""
    import torch

    import repro_torch.kernels as K
    from repro_torch.kernels.mandelbrot.ref import MAX_ITER

    x, y = SHAPES[0]
    n = x * y
    gen = torch.Generator(device="cuda").manual_seed(1)
    a = torch.randn((x, y), generator=gen, device="cuda")
    b = torch.randn((x, y), generator=gen, device="cuda")
    img = torch.randn((x, y), generator=gen, device="cuda")
    out = {}

    win = winners["add"]
    require(torch.equal(K.add(a, b, win), K.add_ref(a, b)), "add winner")
    bms, by = bound(3 * 4 * n, n)
    a_off = offset_copy(a)
    require(torch.equal(K.add(a_off, b), K.add_ref(a, b)), "add, input offset by one element")
    out["add"] = dict(
        ms=time_ms(lambda: K.add(a, b, win), 50),
        ms_default=time_ms(lambda: K.add(a, b), 50),
        ms_default_offset_input=time_ms(lambda: K.add(a_off, b), 50),
        plain_ms=time_ms(lambda: K.add_ref(a, b), 50),
        library_ms=time_ms(lambda: torch.add(a, b), 50),
        bound_ms=bms, bound_by=by,
        paths_ms=time_add_paths(a, b, win))

    win = winners["harris"]
    ref = K.harris_ref(img)
    rel = ((K.harris(img, win) - ref).abs().max() / ref.abs().max()).item()
    require(rel < 1e-5, f"harris winner: rel {rel}")
    # gradients and their products on the (x+2)(y+2) ring, box sums and R on x*y
    bms, by = bound(2 * 4 * n, 15 * (x + 2) * (y + 2) + 31 * n)
    img_off = offset_copy(img)
    rel = ((K.harris(img_off) - ref).abs().max() / ref.abs().max()).item()
    require(rel < 1e-5, f"harris, image offset by one element: rel {rel}")
    out["harris"] = dict(
        ms=time_ms(lambda: K.harris(img, win), 50),
        ms_default=time_ms(lambda: K.harris(img), 50),
        ms_default_offset_input=time_ms(lambda: K.harris(img_off), 50),
        plain_ms=time_ms(lambda: K.harris_ref(img), 10),
        library_ms=None, bound_ms=bms, bound_by=by)

    win = winners["mandelbrot"]
    counts = K.mandelbrot(x, y, win, device="cuda")
    require(torch.equal(counts, K.mandelbrot_ref(x, y, device="cuda")), "mandelbrot winner")
    # what the function needs, not what this kernel issues: 7 f32 operations
    # per trip a pixel is alive (zr*zr, zi*zi, their difference, + cre,
    # 2*zr, * zi, + cim) and 4 for the test an escaping pixel fails (its two
    # squares, their sum, the compare)
    alive_trips = counts.double().sum().item()
    escaped = (counts < MAX_ITER).sum().item()
    ops = 7 * alive_trips + 4 * escaped
    bms, by = bound(4 * n, ops)
    out["mandelbrot"] = dict(
        ms=time_ms(lambda: K.mandelbrot(x, y, win, device="cuda"), 20),
        ms_default=time_ms(lambda: K.mandelbrot(x, y, device="cuda"), 20),
        plain_ms=time_ms(lambda: K.mandelbrot_ref(x, y, device="cuda"), 3, warmup=1),
        library_ms=None, bound_ms=bms, bound_by=by,
        bound_unfused_ms=max(4 * n / PEAK_BYTES_PER_S, ops / PEAK_F32_UNFUSED_PER_S) * 1e3)
    for k, v in out.items():
        print(f"time {k} {x}x{y}: " + " ".join(f"{kk}={vv!r}" for kk, vv in v.items()))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import KERNEL_BENCHES
    from repro_torch.kernels._build import find_nvcc, kernel_smem_bytes, library

    # 1. the card
    print(f"gpu: {gpu_line()}")
    cap = torch.cuda.get_device_capability(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)!r} capability {cap}")
    require(cap == (9, 0), f"need compute capability (9, 0), got {cap}")
    torch.backends.cudnn.allow_tf32 = False          # the plain harris conv2d in f32
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2. build
    lib = library()
    print(f"nvcc: {lib.nvcc}")
    print(f"build: {lib.build_s:.2f} s -> {os.path.relpath(lib.path, ROOT)}")
    for line in lib.ptxas_log.splitlines():
        if line.strip():
            print(f"  {line.strip()}")
    sass = sass_opcodes(sass_of(lib.path, find_nvcc()))
    wide = {fn: {op: count_ops(ops, op) for op in ("LDG.E.128", "STG.E.128")}
            for fn, ops in sass.items()}
    for fn, ops in wide.items():
        print(f"sass {fn}: {ops}")
    add_fns = [ops for fn, ops in wide.items() if "add_kernel" in fn]
    require(len(add_fns) == 2 and all(min(ops.values()) > 0 for ops in add_fns),
            f"add: no 16-byte loads and stores in its machine code: {wide}")
    # harris: what the compiler made of its staging, its shared-memory reads
    # and its barriers (LDGSTS is cp.async); no spills
    harris_fns = [fn for fn in sass if "harris_kernel" in fn]
    require(len(harris_fns) == 1, f"harris: kernel functions {harris_fns}")
    report = ptxas_report(lib.ptxas_log).get(harris_fns[0], {})
    ops = sass[harris_fns[0]]
    harris_sass = {op: count_ops(ops, op)
                   for op in ("LDGSTS", "LDG", "LDS", "STS", "STG", "BAR", "SHFL")}
    print(f"harris: ptxas {report} sass {harris_sass} of {sum(ops.values())} instructions")
    require(report.get("spill_stores") == 0 and report.get("spill_loads") == 0,
            f"harris: spills or no ptxas report: {report}")
    for name, bench in KERNEL_BENCHES.items():
        smem = kernel_smem_bytes(name)
        print(f"smem {name}: compiled {smem} B, screened {bench.smem_bytes} B")
        require(smem <= bench.smem_bytes, f"{name}: compiled smem {smem} > screened")

    max_err, n_diff = check_kernels()                 # 3.
    phase_s = {}
    t0 = time.perf_counter()
    main_path = run_main_path()                       # 4.
    phase_s["main"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    searchers = run_searchers()                       # 4b.
    phase_s["searchers"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        matrix = run_matrix_phase(tmp)                # 4c.
        phase_s["matrix"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_stores_phase(tmp, *matrix["harris"])      # 4d.
        phase_s["stores"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        serving = run_serving_phase(tmp, matrix["harris"][0])   # 4e.
        phase_s["serving"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_staticcheck_phase(matrix["specs"])            # 4f.
    phase_s["staticcheck"] = time.perf_counter() - t0
    print("phase wall s: " + " ".join(f"{k}={v:.3f}" for k, v in phase_s.items()))
    times = time_kernels(main_path["winners"])        # 5.

    # 6. summary lines
    rows = []
    for name in ("add", "harris", "mandelbrot"):
        source, replaces = KERNEL_INFO[name]
        t = times[name]
        served = serving["launches"] if name == "mandelbrot" else 0
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": (main_path["launches"][name] + searchers["launches"][name]
                         + matrix["launches"][name] + served),
            "launches_by_phase": {"main": main_path["launches"][name],
                                  "searchers": searchers["launches"][name],
                                  "matrix": matrix["launches"][name],
                                  "serving": served},
            "max_abs_err": max_err[name],
            "n_differing": n_diff[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "ms_default": t["ms_default"],
            **{k: t[k] for k in ("ms_default_offset_input", "paths_ms", "bound_unfused_ms")
               if k in t},
            "tuned_config": main_path["winners"][name], "tuner": main_path["tuner"][name],
            "searchers": searchers["searchers"][name],
            "matrix": matrix["stats"][name],
            **({"serving": serving} if name == "mandelbrot" else {}),
            "status": "ok",
        })
    print(f"gpu: {gpu_line()}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
