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
   share of the wall time spent staging inputs), then replayed
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
4g. the model stack (which launches none of the three kernels): reduced
   yi-34b and granite-34b (MQA) on the card against the port on the CPU from
   the same weights and batch (forward logits per position, one train
   step's loss and each leaf's gradient, eight decode steps, within bounds
   about twice what the card read, far under the CPU tests' bounds against
   JAX); yi-34b at full width (d_model 7168, 56 heads, 8 KV heads,
   d_ff 20480, vocab 64000) cut to 2 of its 60 layers, seq 4096, batch 1 of
   256: ten ``make_train_step`` steps overfitting one batch (per step
   seconds, tokens/s and loss; finite, the last below the first), the peak
   memory, the model FLOPs per step and their share of the data sheet's 989
   TFLOP/s dense bf16, then prefill against 32 decode steps at B=2 (top-1 >=
   0.99, correlation > 0.99); ``python -m repro_torch.launch.train --arch
   yi-34b --reduced --steps 20 --batch 8 --seq 256`` in a process of its own
   (loss falls, ``step_00000020`` written) and again with ``--steps 30``
   (``resumed_from=20``); a runner crash at step 7 resumed from step 5 to
   12 under deterministic algorithms, equal to an uninterrupted run (atol
   1e-7);
4h. the other model families (which launch none of the three kernels
   either): reduced olmoe-1b-7b, deepseek-v2-236b (fp32 on both sides, TF32
   off, with the router assignments the two sides made differently),
   mamba2-130m, zamba2-1.2b and whisper-medium (bf16) on the card against
   the port on the CPU (forward and eight decode steps' logits, one train
   step's loss and each leaf's gradient; whisper in fp32 like the MoE
   configs); then each at its published width (``FAMILY_RUNS``: each cut
   printed): olmoe at 2 of 16 layers, mamba2, zamba2 (``remat="full"``)
   whole, five train steps each (per-step seconds, tokens/s, loss and
   gradient norm; finite and falling; peak memory; model FLOPs against the
   data sheet's 989 TFLOP/s bf16 and 67 TFLOP/s fp32) and prefill against
   32 decode steps at B=2 (top-1 >= 0.99, correlation > 0.99, in fp32 for
   zamba2 and whisper; an MoE prefill at ample capacity, where none of its
   assignments may drop, with the default capacity's reading and dropped
   assignments printed beside); whisper
   (1500 frames, 448 decoder tokens, B=4) at its 24 + 24 layers timed, its
   gradient norm inf (the reference's init), then at 2 + 2 layers learning
   and decoding; deepseek-v2 at 2 of 60 layers serves only: a timed
   4096-token prefill, prefill against decode, decode milliseconds per
   step at B=2; reduced olmoe's crash at step 7 resumed to step 12 under
   deterministic algorithms, equal to an uninterrupted run (difference 0);
4i. the paper's drivers, through the entry points a user calls:
   ``repro_torch.benchmarks.paper_matrix`` in this process (``--backend
   cuda --design smoke --bench mandelbrot --telemetry --report
   --serve-dir``: 8192x8192, the five algorithms, S = 25, 50 with 8 and 4
   experiments; the record names the card, every cell used its samples and
   has finite finals, ``REPORT.md`` holds its tables, the trace's stage
   totals equal the units' ``stage_s``, the serving query hits on the
   card's name); its warm replay on the ``device`` executor from a copy of
   the store as ``python -m`` (exit 0), ``python -m
   repro_torch.tools.compare_stores`` on the two stores (``IDENTICAL``) and
   on a copy with one value one ulp off (exit 1, the key named);
   ``repro_torch.benchmarks.run``'s rows in this process (the kernels and
   their plain versions in CUDA-event time, a GA tune of add on the card,
   fig2/3/4 and the claims on the matrix, the host rows; every number
   finite); quickstart's real-measurement part in this process; then
   ``python -m repro_torch.examples.tune_kernel --x 8192 --y 8192`` and
   ``python -m repro_torch.examples.train_lm --full`` for 10 steps and again
   for 20 (resumed from 10, the loss falling in each run);
4j. sharding on the one-card host (launches none of the three kernels):
   phase 4g's cut of yi-34b (full width, 2 layers, seq 4096, batch 1,
   the dry run's ``remat="dots"``) through the DTensor path on a 1 x 1
   ("data", "model") mesh over an
   ``nccl`` group, its params, batch and gradients placed by the logical-axis
   rules: its loss and each leaf's gradient against the plain step on the
   same weights and batch (within 4g's ``MODEL_GRAD_REL``), three train
   steps of each timed (the difference is DTensor's dispatch overhead, not
   gated) and the DTensor step's ``max_memory_allocated``; the dry run's
   ``build_step`` at the same cut on a 1 x 1 fake mesh in a process of its
   own, whose tracked peak must lie within 15 % of that; ``python -m
   repro_torch.launch.train --arch yi-34b --reduced --model-parallel 1`` on
   the card (exit 0, loss falls); one full-size dry-run cell, yi-34b
   ``train_4k`` on the single 16 x 16 fake mesh, in a process of its own (its
   FLOPs, collective bytes and peak GiB per device);
4k. the last drivers: a ``tune_matrix`` of mandelbrot at 8192x8192
   (``rs`` and ``ga``, S = 25, 2 experiments) in a process of its own, its
   wall seconds, fills and launches; that no harris geometry the screen
   passes is refused by its launch; while the card measures,
   ``python -m repro_torch.benchmarks.hillclimb`` on olmoe-1b-7b
   ``train_4k`` (three records, the table, the no-op line naming H2) and
   ``python -m repro_torch.examples.tune_sharding --arch olmoe-1b-7b
   --budget 3`` (a best config, a positive modelled step) on the host;
   then ``python -m repro_torch.benchmarks.make_experiments_md`` over 4k's
   matrix, 4j's dry-run records and the hill-climb's records (every
   section, no TPU figure);
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

#: phase 4g: yi-34b at full width, cut from 60 layers to 2 and from batch
#: 256 to 1 at seq 4096; the H100 SXM's dense bf16 peak (NVIDIA data sheet)
MODEL_LAYERS = 2
MODEL_STEPS = 10
PEAK_BF16_PER_S = 989e12
#: the card against the port on the CPU: bf16 logits per position, median
#: and max of max|d|/max|ref|; gradients per leaf, ||d|| / ||ref||.  Both
#: sides run the same torch code and round bf16 alike, differing only in
#: summation order, so the bounds sit about twice above what an H100 read
#: (positions up to 9.3e-3, median 0; leaves up to 0.0227), far under the
#: CPU tests' bounds against JAX (0.15, 0.35), which allow a softmax flip
#: between frameworks
MODEL_LOGITS_MEDIAN = 1e-3
MODEL_LOGITS_MAX = 2e-2
MODEL_GRAD_REL = 0.05

#: phase 4h: the full-width runs: (config, layers kept (None: all; for
#: whisper, each stack's), seq (whisper: encoder frames), batch, remat,
#: whether it learns).  Each cut is forced by one 80 GB card: olmoe's 16
#: layers would hold 111 GB of fp32 train state, deepseek-v2's 60 layers
#: 958 GB of fp32 weights (2 layers serve only: a train step needs 144 GB);
#: zamba2 fits its 38 layers only under ``remat="full"``.  whisper's 1500
#: frames are the paper's 30 s window.  At its full 24 + 24 layers the
#: reference's ``scaled`` init (fan-in of a (D, H, hd) projection taken as
#: H) saturates whisper's attention and its gradients overflow fp32 (the
#: norm reads inf, so the clip zeroes every update and only weight decay
#: moves the weights); the error grows with each layer, in the reference as
#: in the port.  That run is timed and held finite, and a 2 + 2 layer run at
#: full width shows it learning and decoding
FAMILY_RUNS = (
    ("olmoe-1b-7b", 2, 4096, 1, "none", True),
    ("deepseek-v2-236b", 2, 4096, 1, None, False),
    ("mamba2-130m", None, 4096, 1, "none", True),
    ("zamba2-1.2b", None, 4096, 1, "full", True),
    ("whisper-medium", None, 1500, 4, "none", False),
    ("whisper-medium", 2, 1500, 4, "none", True),
)
FAMILY_NAMES = tuple(dict.fromkeys(run[0] for run in FAMILY_RUNS))
FAMILY_STEPS = 5
FAMILY_DECODE_STEPS = 16
#: prefill against decode in fp32 for the deep stacks of saturated attention
FAMILY_PD_FP32 = ("zamba2-1.2b", "whisper-medium")
#: 4g a, 4h a: bounds of each reduced config on the card against the port on
#: the CPU.  yi-34b and granite-34b hold phase 4g's.  The MoE configs run in
#: fp32 on both sides, held to the CPU tests' fp32 bounds against JAX
#: (``logits`` max|d|/max|ref|, ``grad`` per leaf).  whisper runs in fp32
#: too: the reference's ``scaled`` init saturates its attention, so its bf16
#: logits and gradients turn on last bits.  Its bounds, like mamba2's and
#: zamba2's in bf16 (per position ``median`` and ``max``, per leaf
#: ``grad``), sit at about twice what an H100 read (whisper 4.7e-3, 0.030;
#: mamba2 3.0e-3, 7.6e-3, 7.2e-3; zamba2 0, 4.9e-3, 6.0e-3)
CARD_BOUNDS = {
    "yi-34b": {"median": MODEL_LOGITS_MEDIAN, "max": MODEL_LOGITS_MAX, "grad": MODEL_GRAD_REL},
    "granite-34b": {"median": MODEL_LOGITS_MEDIAN, "max": MODEL_LOGITS_MAX,
                    "grad": MODEL_GRAD_REL},
    "olmoe-1b-7b": {"logits": 5e-4, "grad": 1e-3},
    "deepseek-v2-236b": {"logits": 5e-4, "grad": 1e-3},
    "whisper-medium": {"logits": 1e-2, "grad": 0.06},
    "mamba2-130m": {"median": 6e-3, "max": 1.5e-2, "grad": 1.5e-2},
    "zamba2-1.2b": {"median": 1e-3, "max": 1e-2, "grad": 1.2e-2},
}

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
    """Mean device time of one call over ``n`` back-to-back calls: the
    package's CUDA-event timer, which ``benchmarks.run``'s kernel rows use."""
    from repro_torch.cuda_bench.events import time_ms as events_time_ms

    return events_time_ms(fn, n, warmup)


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
    every fresh ``CudaMeasurement`` stages its inputs, drawn with numpy on
    the process's first use of the workload and taken from the input cache
    after it; a matrix call copies them to the card once and its other
    stagings take that copy.  The script wraps the method only to measure
    that share of a matrix run."""
    import torch

    from repro_torch.cuda_bench.workloads import CudaWorkload

    orig = CudaWorkload.materialize
    stats = {"n": 0, "s": 0.0}

    def materialize(self, device, timings=None):
        t0 = time.perf_counter()
        out = orig(self, device, timings)
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
    """The same cells, values and per-experiment winners (``best_indices``;
    ``None`` on both sides counts as the same)."""
    import numpy as np

    return set(a.cells) == set(b.cells) and all(
        np.array_equal(getattr(a.cells[k], n), getattr(b.cells[k], n))
        for k in a.cells
        for n in ("final_values", "search_best_values", "n_samples_used", "best_indices"))


def matrix_cold(kernel: str, tmp: str, telemetry_dir: str | None = None):
    """One cold serial ``tune_matrix`` at 8192x8192, counted as the main
    path is, traced into ``telemetry_dir`` when given; its cell lines and
    checks.  Returns the spec, the results, the kernel's launches, the run's
    wall seconds and its materialisations."""
    import numpy as np
    import torch

    from repro_torch import ExperimentDesign, RunRecord, TuningSession, TuningSpec, tune_matrix
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
    space = TuningSession(spec.replace(store=None, store_path=None)).space
    for (algo, s), cell in sorted(results.cells.items()):
        w = walls[(algo, s)]
        best = cell.best_indices
        print(f"matrix {kernel}/{algo} S={s}: "
              f"median_final_ms={float(np.median(cell.final_values)) * 1e3!r} "
              f"best_final_ms={float(cell.final_values.min()) * 1e3!r} "
              f"n_samples_used={cell.n_samples_used.tolist()} wall_s={w['wall_s']} "
              f"compile_s={w['compile_s']} measure_s={w['measure_s']} "
              f"winners={None if best is None else best.tolist()}")
        require(cell.n_samples_used.tolist() == [s] * len(cell.n_samples_used),
                f"matrix {kernel}/{algo} S={s}: samples {cell.n_samples_used.tolist()}")
        require(bool(np.isfinite(cell.final_values).all()),
                f"matrix {kernel}/{algo} S={s}: finals {cell.final_values.tolist()}")
        # each experiment's winner: an index row of the space, a config the
        # space admits
        require(best is not None and best.shape == (len(cell.final_values), len(space.params))
                and bool((best >= 0).all() and (best < space.cardinalities).all())
                and all(space.is_valid(space.decode(row)) for row in best),
                f"matrix {kernel}/{algo} S={s}: winners {best}")
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


def check_trace(spec, run_dir: str, label: str = "harris cold") -> dict:
    """A cold run's trace against the run: each measurement stage's trace
    total beside the units' summed ``stage_s`` (read back from the unit
    journal), which must agree to 1e-6 s, the matrix's ``dataset`` stage
    among them where the spec has a dataset, and the trace-only host stages (the searchers' ``propose``,
    the session's own ``session``); the completed units and experiments
    against the plan; the trace's command line in a process of its own."""
    from repro_torch import TuningSession, build_units
    from repro_torch.telemetry import read_run, stage_percentiles, summarize
    from repro_torch.telemetry.events import HOST_STAGES, MATRIX_STAGES, PIPELINE_STAGES

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
    every = {k: v["total_s"] for k, v in stage_percentiles(events).items()}
    totals = {k: v for k, v in every.items() if k not in HOST_STAGES}
    host = {k: v for k, v in every.items() if k in HOST_STAGES}
    diff = {k: abs(totals.get(k, 0.0) - stage_s.get(k, 0.0)) for k in set(totals) | set(stage_s)}
    summary = summarize(run_dir)
    counters = summary["counters"]
    n_exp = sum(e for _, _, e in cells)
    cli = subprocess.run([sys.executable, "-m", "repro_torch.telemetry", run_dir],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    print(f"trace {label}: events={summary['n_events']} stage_total_s={totals} host_s={host} "
          f"units_stage_s={stage_s} max_abs_diff_s={max(diff.values())!r} "
          f"units_completed={counters.get('units_completed')}/{plans[0]['units_total']} "
          f"experiments_completed={counters.get('experiments_completed')}/{n_exp} "
          f"compiles={counters.get('compiles')} store_misses={counters.get('store_misses')} "
          f"invalid={summary['invalid']} cli_exit={cli.returncode}")
    want = {*PIPELINE_STAGES, *(MATRIX_STAGES if spec.dataset_size else ())}
    require(set(totals) == want, f"trace stages {totals}")
    require(set(host) == {"propose", "session"}, f"trace host stages {host}")
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


# ---------------------------------------------------------------- phase 4g


def per_position_err(got, ref):
    """Per position, max over the vocabulary of |got - ref| / max|ref|."""
    got, ref = got.float().cpu(), ref.float().cpu()
    return (got - ref).abs().amax(-1).flatten() / ref.abs().max()


def require_logits(err, what: str, median: float, worst: float) -> dict:
    """The card-against-CPU bound on bf16 logits per position."""
    out = {"max": err.max().item(), "median": err.median().item(), "n": err.numel()}
    require(out["median"] <= median and out["max"] <= worst,
            f"{what}: per-position max|d|/max|ref| {out}")
    return out


@contextlib.contextmanager
def compute_dtype(dtype):
    """Every model module of the port computes in ``dtype`` inside the block
    (what the CPU tests' ``fp32`` fixture does)."""
    from repro_torch.models import decoder, encdec, hybrid, layers, ssm

    mods = (layers, decoder, ssm, hybrid, encdec)
    old = [m.COMPUTE_DTYPE for m in mods]
    for m in mods:
        m.COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        for m, d in zip(mods, old, strict=True):
            m.COMPUTE_DTYPE = d


@contextlib.contextmanager
def moe_recorder():
    """Records, inside the block, each router call's experts and each
    dispatch's dropped assignments (``moe``'s own functions, wrapped)."""
    from repro_torch.models import moe

    rec = {"experts": [], "dropped": []}
    topk, dispatch = moe.router_topk, moe._dispatch_indices

    def router_topk(*args):
        out = topk(*args)
        rec["experts"].append(out[1].cpu())
        return out

    def dispatch_indices(*args):
        table, keep = dispatch(*args)
        rec["dropped"].append(int((~keep).sum()))
        return table, keep

    moe.router_topk, moe._dispatch_indices = router_topk, dispatch_indices
    try:
        yield rec
    finally:
        moe.router_topk, moe._dispatch_indices = topk, dispatch


def family_logits(model, params, batch):
    if "src_embeds" in batch:
        return model.forward(params, batch)[0]
    return model.forward(params, batch["tokens"])[0]


def family_decode(model, params, batch, steps: int, device):
    """``steps`` decode steps over the batch's first tokens; whisper's cache
    holds the encoder's output of the batch's frames."""
    import torch

    b = next(iter(batch.values())).shape[0]
    if "src_embeds" in batch:
        cache = model.init_cache(params, model.encode(params, batch["src_embeds"]), b)
        toks = batch["dec_tokens"]
    else:
        cache = model.init_cache(b, max(16, steps), device=device)
        toks = batch["tokens"]
    out = []
    for t in range(steps):
        logits, cache = model.decode_step(params, cache, torch.full((b,), t, device=device),
                                          toks[:, t:t + 1])
        out.append(logits)
    return torch.cat(out, 1)


def family_grads(model, params, batch):
    import torch

    from repro_torch.train import TrainSettings, make_loss_fn
    from repro_torch.tree import tree_from_paths, tree_paths

    flat = {k: p.detach().requires_grad_(True) for k, p in tree_paths(params).items()}
    total, _ = make_loss_fn(model, TrainSettings(remat="none"))(tree_from_paths(flat), batch)
    grads = torch.autograd.grad(total, list(flat.values()), materialize_grads=True)
    return dict(zip(flat, grads, strict=True))


def rel_err(got, ref) -> float:
    return ((got.float().cpu() - ref.float()).abs().max() / ref.float().abs().max()).item()


def card_against_cpu(name: str) -> dict:
    """4g a, 4h a: one reduced config on the card against the port on the CPU from
    the same weights and batch: forward logits, eight decode steps, one
    train step's loss and each leaf's gradient (``CARD_BOUNDS``).  The MoE
    configs also print the router assignments the two sides made
    differently."""
    import torch

    from repro_torch.configs import REGISTRY
    from repro_torch.data import DataConfig, make_train_batch
    from repro_torch.models import build_model, init_params
    from repro_torch.train import TrainSettings, init_train_state, make_train_step
    from repro_torch.tree import tree_map

    cfg = REGISTRY[name].reduced()
    model = build_model(cfg)
    bounds = CARD_BOUNDS[name]
    fp32 = "logits" in bounds
    require(not fp32 or not torch.backends.cuda.matmul.allow_tf32, f"{name}: TF32 is on")
    on_cpu = init_params(model.spec(), torch.Generator().manual_seed(0), "cpu")
    on_card = tree_map(lambda t: t.to("cuda"), on_cpu)
    batch_cpu = make_train_batch(DataConfig(seed=0), cfg, 64, 2, 0, device="cpu")
    batch = tree_map(lambda t: t.to("cuda"), batch_cpu)
    out = {"dtype": "fp32" if fp32 else "bf16"}
    with compute_dtype(torch.float32 if fp32 else torch.bfloat16):
        with torch.no_grad():
            with moe_recorder() as rec_cpu:
                ref = family_logits(model, on_cpu, batch_cpu)
            with moe_recorder() as rec_card:
                got = family_logits(model, on_card, batch)
            ref_dec = family_decode(model, on_cpu, batch_cpu, 8, "cpu")
            got_dec = family_decode(model, on_card, batch, 8, "cuda")
        step = make_train_step(model, TrainSettings(remat="none"))
        ref_loss = float(step(init_train_state(model, on_cpu), batch_cpu)[1]["loss"])
        loss = float(step(init_train_state(model, on_card), batch)[1]["loss"])
        g_cpu, g_card = family_grads(model, on_cpu, batch_cpu), family_grads(model, on_card, batch)
    if fp32:
        out["forward_rel"], out["decode_rel"] = rel_err(got, ref), rel_err(got_dec, ref_dec)
        require(max(out["forward_rel"], out["decode_rel"]) <= bounds["logits"],
                f"{name} card-vs-cpu fp32 logits: {out}")
    else:
        out["forward"] = require_logits(per_position_err(got, ref), f"{name} forward",
                                        bounds["median"], bounds["max"])
        out["decode"] = require_logits(per_position_err(got_dec, ref_dec), f"{name} decode",
                                       bounds["median"], bounds["max"])
    if cfg.moe:
        out["routed_differently"] = sum(int((a != b).sum()) for a, b in zip(
            rec_cpu["experts"], rec_card["experts"], strict=True))
        out["assignments"] = sum(a.numel() for a in rec_cpu["experts"])
    out["loss"] = {"card": loss, "cpu": ref_loss, "rel": abs(loss - ref_loss) / abs(ref_loss)}
    require(out["loss"]["rel"] <= 1e-3, f"{name} train step loss {out['loss']}")
    unused = [k for k, g in g_cpu.items() if not g.any()]
    require(all(not g_card[k].any() for k in unused), f"{name}: gradients where the CPU has 0")
    out["grads"] = {k: ((g_card[k].cpu() - g).norm() / g.norm()).item()
                    for k, g in g_cpu.items() if k not in unused}
    out["grad_max"] = max(out["grads"].values())
    require(out["grad_max"] <= bounds["grad"], f"{name} gradients ||d||/||ref|| {out['grads']}")
    shown = {k: v for k, v in out.items() if k != "grads"}
    print(f"model card-vs-cpu {name} reduced: {shown} zero-gradient leaves {len(unused)}")
    return out


def model_flops(cfg, seq: int, tokens: int) -> float:
    """Model FLOPs of one train step: 6 * matmul params * tokens, plus the
    attention's two products over the full score matrix (the reference
    computes all of it, masked): 12 * L * S * H * hd per token."""
    c = cfg
    per_layer = (2 * c.d_model * c.n_heads * c.head_dim          # wq, wo
                 + 2 * c.d_model * c.n_kv_heads * c.head_dim     # wk, wv
                 + 3 * c.d_model * c.d_ff)                       # w_gate, w_up, w_down
    n_matmul = c.n_layers * per_layer + c.d_model * c.vocab
    return 6 * n_matmul * tokens + 12 * c.n_layers * seq * c.n_heads * c.head_dim * tokens


def model_full_width() -> dict:
    """4g b: yi-34b at full width, 2 of its 60 layers, seq 4096, batch 1:
    ten train steps overfitting one batch, then prefill against decode."""
    import dataclasses

    import torch

    from repro_torch.configs import REGISTRY, SHAPES
    from repro_torch.data import DataConfig, make_train_batch
    from repro_torch.models import build_model, init_params, param_count
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainSettings, init_train_state, make_train_step

    cfg = dataclasses.replace(REGISTRY["yi-34b"], n_layers=MODEL_LAYERS)
    seq, batch_size = SHAPES["train_4k"].seq_len, 1
    model = build_model(cfg)
    n_params = param_count(model.spec())
    batch = make_train_batch(DataConfig(seed=0), cfg, seq, batch_size, 0, device="cuda")
    tokens = seq * batch_size
    out = {"params": n_params, "steps": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(model, init_params(
        model.spec(), torch.Generator(device="cuda").manual_seed(0), "cuda"))
    torch.cuda.synchronize()
    out["init_s"] = init_s = time.perf_counter() - t0
    # remat "none" fits on an 80 GB card (about 61 GB at this size), fp32 scores and all
    step = make_train_step(model, TrainSettings(
        remat="none", optimizer=AdamWConfig(lr=1e-3, warmup_steps=1)))
    for i in range(MODEL_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out["steps"].append({"s": dt, "tok_s": tokens / dt, "loss": loss})
        print(f"model full-width yi-34b L={cfg.n_layers} S={seq} B={batch_size} remat=none "
              f"step {i + 1}: s={dt:.4f} tok/s={tokens / dt:.1f} loss={loss:.6f}")
    losses = [s["loss"] for s in out["steps"]]
    require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
            f"full width: losses {losses}")
    steady = sorted(s["s"] for s in out["steps"][1:])
    out["step_s_median"] = steady[len(steady) // 2]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["flops_per_step"] = model_flops(cfg, seq, tokens)
    out["flop_share_of_peak"] = out["flops_per_step"] / out["step_s_median"] / PEAK_BF16_PER_S
    print(f"model full-width: params={n_params} init_s={init_s:.3f} remat=none "
          f"step_s_median(steps 2-{MODEL_STEPS})={out['step_s_median']:.4f} "
          f"tok/s={tokens / out['step_s_median']:.1f} peak_mem_GB={out['peak_gb']:.2f} "
          f"(of {torch.cuda.get_device_properties(0).total_memory / 1e9:.1f}) "
          f"model_flops_per_step={out['flops_per_step']:.4e} share of the data sheet's "
          f"989 TFLOP/s dense bf16 (H100 SXM)={100 * out['flop_share_of_peak']:.2f} %")

    # prefill against decode on the trained weights: B=2, 32 tokens
    params = state["params"]
    state = None
    toks = make_train_batch(DataConfig(seed=0), cfg, 32, 2, 1, device="cuda")["tokens"]
    with torch.no_grad():
        full, _ = model.forward(params, toks)
        cache = model.init_cache(2, 64, device="cuda")
        for t in range(32):
            last, cache = model.decode_step(params, cache, torch.full((2,), t, device="cuda"),
                                            toks[:, t:t + 1])
    got, want = last[:, 0].float().cpu(), full[:, -1].float().cpu()
    top1 = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    corr = torch.corrcoef(torch.stack([got.flatten(), want.flatten()]))[0, 1].item()
    out["prefill_decode"] = {"top1": top1, "corr": corr}
    print(f"model prefill-vs-decode yi-34b full width B=2 32 tokens: top1={top1} corr={corr:.6f}")
    require(top1 >= 0.99 and corr > 0.99, f"prefill vs decode: {out['prefill_decode']}")
    return out


def train_cli(ckpt: str, steps: int) -> tuple[str, float]:
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "yi-34b", "--reduced",
         "--steps", str(steps), "--batch", "8", "--seq", "256", "--ckpt", ckpt],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    wall = time.perf_counter() - t0
    for line in cli.stdout.strip().splitlines():
        print(f"  {line}")
    require(cli.returncode == 0,
            f"launch.train --steps {steps}: exit {cli.returncode}: {cli.stderr[-3000:]}")
    return cli.stdout, wall


def model_cli(tmp: str) -> dict:
    """4g c: ``python -m repro_torch.launch.train`` on the card, in a
    process of its own, then resumed from its checkpoint."""
    ckpt = os.path.join(tmp, "train_cli")
    first, first_s = train_cli(ckpt, 20)
    lines = [ln for ln in first.splitlines() if ln.startswith("[train]")]
    m = re.search(r"loss ([\d.]+) -> ([\d.]+)", first)
    require(len(lines) == 3 and "resumed_from=None" in lines[1] and m is not None
            and float(m.group(2)) < float(m.group(1)), f"launch.train: {lines}")
    require(os.path.isdir(os.path.join(ckpt, "step_00000020")), "launch.train: no step_00000020")
    again, again_s = train_cli(ckpt, 30)
    require("resumed_from=20" in again, f"launch.train --steps 30: {again[-500:]}")
    out = {"first_s": first_s, "resumed_s": again_s,
           "loss": [float(m.group(1)), float(m.group(2))]}
    print(f"model cli: {out}")
    return out


def crash_resume(tmp: str, name: str, atol: float) -> dict:
    """4g d, 4h c: a reduced config through the fault-tolerant runner: an
    injected failure at step 7, resumed from the step-5 checkpoint to step
    12, equal to an uninterrupted 12-step run (to ``atol``) under
    deterministic algorithms (the embedding's backward is a scatter-add,
    MoE's dispatch scatters, gathers and adds by index, and cuBLAS may
    split K: none repeats bit for bit otherwise)."""
    import torch

    from repro_torch.checkpoint import latest_step
    from repro_torch.configs import REGISTRY
    from repro_torch.data import DataConfig, make_train_batch
    from repro_torch.models import build_model, init_params
    from repro_torch.runtime import InjectedFailure, RunnerConfig, TrainingRunner
    from repro_torch.train import TrainSettings, init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    cfg = REGISTRY[name].reduced()
    model = build_model(cfg)
    torch.use_deterministic_algorithms(True)
    try:
        state0 = init_train_state(model, init_params(
            model.spec(), torch.Generator(device="cuda").manual_seed(0), "cuda"))
        step_fn = make_train_step(model, TrainSettings(remat="none"))
        make_batch = lambda s: make_train_batch(DataConfig(seed=0), cfg, 64, 2, s, device="cuda")
        ref, _ = TrainingRunner(RunnerConfig(ckpt_dir=os.path.join(tmp, f"{name}_whole"),
                                             ckpt_every=5), step_fn, make_batch).run(state0, 12)
        d = os.path.join(tmp, f"{name}_crashed")
        crashed = False
        try:
            TrainingRunner(RunnerConfig(ckpt_dir=d, ckpt_every=5, fail_at_step=7),
                           step_fn, make_batch).run(state0, 12)
        except InjectedFailure:
            crashed = True
        require(crashed and latest_step(d) == 5, f"crash: raised={crashed} at {latest_step(d)}")
        resumed, report = TrainingRunner(RunnerConfig(ckpt_dir=d, ckpt_every=5),
                                         step_fn, make_batch).run(state0, 12)
    finally:
        torch.use_deterministic_algorithms(False)
    diff = max((a - b).abs().max().item() for a, b in zip(
        tree_leaves(ref["params"]), tree_leaves(resumed["params"]), strict=True))
    out = {"restored_from": report.restored_from, "steps_run": report.steps_run,
           "max_abs_diff": diff}
    print(f"model crash-resume {name} reduced, deterministic: {out}")
    require(report.restored_from == 5 and report.steps_run == 7 and diff <= atol,
            f"{name} crash-resume: {out}")
    return out


def run_model_phase(tmp: str) -> dict:
    """Phase 4g: the model stack, which launches none of the three CUDA
    kernels."""
    import torch

    from repro_torch.kernels import LAUNCHES

    for c in LAUNCHES.values():
        c.n = 0
    out = {name: card_against_cpu(name) for name in ("yi-34b", "granite-34b")}
    out["full_width"] = model_full_width()
    torch.cuda.empty_cache()
    out["cli"] = model_cli(tmp)
    out["crash_resume"] = crash_resume(tmp, "yi-34b", 1e-7)
    out["launches"] = got = {k: c.n for k, c in LAUNCHES.items()}
    require(all(n == 0 for n in got.values()), f"the model stack launched {got}")
    return out


# ---------------------------------------------------------------- phase 4h


def family_flops(cfg, seq: int, batch: int) -> dict:
    """Model FLOPs of one forward pass over ``batch`` sequences of ``seq``
    tokens (whisper: ``seq`` frames and its 448 decoder tokens), split into
    the bf16 products and the fp32 ones (MLA's scores and context, the SSD
    terms, the router), 2 per multiply-add.  MoE counts the k active experts
    of E.  Attention counts the full score matrix, as the reference computes
    it (masked).  A train step is three times its forward."""
    c = cfg
    D = c.d_model
    bf16 = fp32 = 0.0
    tokens = seq * batch
    if c.family in ("moe", "mla_moe"):
        m = c.moe
        ffn = 3 * D * m.d_ff_expert * (m.top_k + m.n_shared)
        if c.mla:
            a = c.mla
            H = c.n_heads
            proj = D * a.q_lora + a.q_lora * H * (a.d_nope + a.d_rope) + D * a.kv_lora \
                + D * a.d_rope + H * a.d_v * D
            fp32 += 2 * c.n_layers * tokens * (a.kv_lora * H * (a.d_nope + a.d_v)
                                               + seq * H * (a.d_nope + a.d_rope + a.d_v))
        else:
            proj = 2 * D * c.n_heads * c.head_dim + 2 * D * c.n_kv_heads * c.head_dim
            bf16 += 2 * c.n_layers * tokens * 2 * seq * c.n_heads * c.head_dim
        bf16 += 2 * tokens * (c.n_layers * (proj + ffn) + D * c.vocab)
        fp32 += 2 * c.n_layers * tokens * D * m.n_experts                  # router
    elif c.family in ("ssm", "hybrid"):
        s = c.ssm
        di = s.expand * D
        h = di // s.head_dim
        in_proj = 2 * di + 2 * s.n_groups * s.d_state + h
        bf16 += 2 * tokens * (c.n_layers * (D * in_proj + di * D) + D * c.vocab)
        q = min(s.chunk, seq)
        # intra-chunk scores and outputs, chunk states and their read-out
        fp32 += 2 * c.n_layers * tokens * h * (q * s.d_state + q * s.head_dim
                                              + 2 * s.head_dim * s.d_state)
        if c.family == "hybrid":
            n = c.n_layers // c.shared_attn_every
            proj = 2 * D * c.n_heads * c.head_dim + 2 * D * c.n_kv_heads * c.head_dim
            bf16 += 2 * n * tokens * (proj + 3 * D * c.d_ff
                                      + 2 * seq * c.n_heads * c.head_dim)
    elif c.family == "encdec":
        e = c.encdec
        dec = e.dec_len * batch
        hh = c.n_heads * c.head_dim
        bf16 += 2 * e.n_enc_layers * tokens * (4 * D * hh + 2 * D * c.d_ff + 2 * seq * hh)
        bf16 += 2 * e.n_dec_layers * (dec * (6 * D * hh + 2 * D * c.d_ff
                                             + 2 * e.dec_len * hh + 2 * seq * hh)
                                      + tokens * 2 * D * hh)       # cross K/V of the frames
        bf16 += 2 * dec * D * c.vocab
    return {"bf16": bf16, "fp32": fp32}


def datasheet_s(flops: dict) -> float:
    """The least time the data sheet allows: bf16 products at 989 TFLOP/s,
    fp32 ones at 67 TFLOP/s."""
    return flops["bf16"] / PEAK_BF16_PER_S + flops["fp32"] / PEAK_F32_PER_S


def prefill_against_decode(name, model, params, tokens: int = 32) -> dict:
    """The last position of a prefill over B=2 x ``tokens`` against as many
    decode steps (whisper: its decoder over the encoder's output of one
    batch's frames).  ``FAMILY_PD_FP32`` configs are held in fp32: deep
    stacks of saturated attention turn bf16's last bits into different
    winners (their bf16 reading is printed beside).

    An MoE config is held at ample capacity (``capacity_factor`` =
    experts / top-k, so each expert's capacity is its group's token count)
    and none of the prefill's assignments may drop: decode's capacity never
    drops at B=2, while the trained router's default capacity drops a
    varying share of the prefill's, which is another function (dropped
    assignments are the design's, as in the reference).  The default
    capacity's reading and its dropped assignments are printed beside, and
    with each reading the (token, MoE layer) pairs that prefill and decode
    routed to different experts (bf16 near-ties in the router)."""
    import dataclasses

    import torch

    from repro_torch.data import DataConfig, make_train_batch
    from repro_torch.models import build_model

    cfg = model.cfg
    seq = 1500 if cfg.family == "encdec" else tokens
    batch = make_train_batch(DataConfig(seed=0), cfg, seq, 2, 1, device="cuda")
    if "src_embeds" in batch:
        batch["dec_tokens"] = batch["dec_tokens"][:, :tokens]
    held_model = model
    if cfg.moe:
        held_model = build_model(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)))

    def compare(m, dtype):
        with compute_dtype(dtype), torch.no_grad(), moe_recorder() as rec:
            full = family_logits(m, params, batch)
            dropped, layers = sum(rec["dropped"]), len(rec["experts"])
            last = family_decode(m, params, batch, tokens, "cuda")[:, -1]
        got, want = last.float().cpu(), full[:, -1].float().cpu()
        require(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
                f"{name} prefill vs decode: logits not finite")
        # (token, MoE layer) pairs whose expert set differs between the two
        routed = sum(int((rec["experts"][i].reshape(2, tokens, -1).sort(-1).values != torch.stack(
            [rec["experts"][layers * (t + 1) + i].reshape(2, -1) for t in range(tokens)],
            1).sort(-1).values).any(-1).sum()) for i in range(layers))
        return {"top1": (got.argmax(-1) == want.argmax(-1)).float().mean().item(),
                "corr": torch.corrcoef(torch.stack([got.flatten(), want.flatten()]))[0, 1].item(),
                "prefill_dropped_assignments": dropped, "routed_differently": routed}

    held = torch.float32 if name in FAMILY_PD_FP32 else torch.bfloat16
    out = {"dtype": str(held).removeprefix("torch."), **compare(held_model, held)}
    if cfg.moe:
        out["capacity_factor"] = held_model.cfg.moe.capacity_factor
        out["default_capacity_reading"] = compare(model, held)
    if held != torch.bfloat16:
        out["bf16_reading"] = compare(held_model, torch.bfloat16)
    print(f"model prefill-vs-decode {name} full width B=2 {tokens} tokens: {out}")
    require(out["top1"] >= 0.99 and out["corr"] > 0.99
            and out["prefill_dropped_assignments"] == 0, f"{name} prefill vs decode: {out}")
    return out


def cut_depth(cfg, layers: int | None):
    """The config with ``layers`` layers (each of whisper's two stacks)."""
    import dataclasses

    if layers is None:
        return cfg
    if cfg.encdec:
        return dataclasses.replace(cfg, n_layers=2 * layers, encdec=dataclasses.replace(
            cfg.encdec, n_enc_layers=layers, n_dec_layers=layers))
    return dataclasses.replace(cfg, n_layers=layers)


def family_full_width(name: str, layers: int | None, seq: int, batch_size: int,
                      remat: str, learns: bool) -> dict:
    """4h b: one published config at full width (``layers`` cuts the depth,
    None keeps it): ``FAMILY_STEPS`` train steps overfitting one batch, then
    prefill against decode on the trained weights.  A run that does not
    learn (whisper at full depth) must read an infinite gradient norm at
    every step and a finite loss."""
    import torch

    from repro_torch.configs import REGISTRY
    from repro_torch.data import DataConfig, make_train_batch
    from repro_torch.models import build_model, init_params, param_count
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainSettings, init_train_state, make_train_step

    cfg = cut_depth(REGISTRY[name], layers)
    cut = f"{REGISTRY[name].n_layers} -> {cfg.n_layers} layers" if layers else "none"
    model = build_model(cfg)
    n_params = param_count(model.spec())
    batch = make_train_batch(DataConfig(seed=0), cfg, seq, batch_size, 0, device="cuda")
    tokens = (cfg.encdec.dec_len if cfg.encdec else seq) * batch_size
    flops = {k: 3 * v for k, v in family_flops(cfg, seq, batch_size).items()}
    out = {"params": n_params, "cut": cut, "steps": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, init_params(
        model.spec(), torch.Generator(device="cuda").manual_seed(0), "cuda"))
    step = make_train_step(model, TrainSettings(
        remat=remat, optimizer=AdamWConfig(lr=1e-3, warmup_steps=1)))
    what = (f"{name} L={cfg.n_layers} S={seq} B={batch_size} remat={remat}"
            + (f" frames={seq} dec_tokens={cfg.encdec.dec_len}" if cfg.encdec else ""))
    for i in range(FAMILY_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        gnorm = float(metrics["grad_norm"])
        out["steps"].append({"s": dt, "tok_s": tokens / dt, "loss": loss, "grad_norm": gnorm})
        print(f"model full-width {what} step {i + 1}: s={dt:.4f} tok/s={tokens / dt:.1f} "
              f"loss={loss:.6f} grad_norm={gnorm:.4g}")
    losses = [s["loss"] for s in out["steps"]]
    norms = [s["grad_norm"] for s in out["steps"]]
    require(all(math.isfinite(x) for x in losses), f"{name} full width: losses {losses}")
    if learns:
        require(losses[-1] < losses[0] and all(math.isfinite(x) for x in norms),
                f"{name} full width: losses {losses}, gradient norms {norms}")
    else:
        require(all(x == math.inf for x in norms), f"{name} full width: gradient norms {norms}")
    steady = sorted(s["s"] for s in out["steps"][1:])
    out["step_s_median"] = med = (steady[1] + steady[2]) / 2
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["flops"] = flops
    out["datasheet_share"] = datasheet_s(flops) / med
    print(f"model full-width {name}: params={n_params} cut={cut} remat={remat} "
          f"step_s_median(steps 2-{FAMILY_STEPS})={med:.4f} tok/s={tokens / med:.1f} "
          f"peak_mem_GB={out['peak_gb']:.2f} model_flops_per_step bf16={flops['bf16']:.4e} "
          f"fp32={flops['fp32']:.4e}; share of the data sheet's 989 TFLOP/s dense bf16 "
          f"and 67 TFLOP/s fp32 (H100 SXM)={100 * out['datasheet_share']:.2f} %")
    params = state["params"]
    state = None
    if learns:
        out["prefill_decode"] = prefill_against_decode(name, model, params)
    return out


def deepseek_serving(layers: int, seq: int) -> dict:
    """4h b: deepseek-v2 at full width, 2 of its 60 layers, serving only (a
    train step's fp32 state would need 144 GB): a timed 4096-token prefill
    at B=1, prefill against decode at B=2 over 32 tokens, and decode
    milliseconds per token at B=2."""
    import torch

    from repro_torch.configs import REGISTRY
    from repro_torch.data import DataConfig, make_train_batch
    from repro_torch.models import build_model, init_params, param_count
    from repro_torch.train import make_decode_step, make_prefill_step

    name = "deepseek-v2-236b"
    cfg = cut_depth(REGISTRY[name], layers)
    model = build_model(cfg)
    out = {"params": param_count(model.spec()), "cut": f"60 -> {cfg.n_layers} layers"}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(model.spec(), torch.Generator(device="cuda").manual_seed(0), "cuda")
    prefill = make_prefill_step(model)
    batch = make_train_batch(DataConfig(seed=0), cfg, seq, 1, 0, device="cuda")
    with moe_recorder() as rec:
        logits = prefill(params, batch)
    require(bool(torch.isfinite(logits.float()).all()), f"{name} prefill: logits not finite")
    logits = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    out["prefill_s"] = time.perf_counter() - t0
    logits = None
    out["prefill_tok_s"] = seq / out["prefill_s"]
    out["prefill_dropped_assignments"] = sum(rec["dropped"])
    flops = family_flops(cfg, seq, 1)
    out["prefill_datasheet_share"] = datasheet_s(flops) / out["prefill_s"]
    out["prefill_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"model full-width {name}: params={out['params']} cut={out['cut']} serving only; "
          f"prefill S={seq} B=1: s={out['prefill_s']:.4f} tok/s={out['prefill_tok_s']:.1f} "
          f"dropped assignments={out['prefill_dropped_assignments']} "
          f"model_flops bf16={flops['bf16']:.4e} fp32={flops['fp32']:.4e} (MLA scores and "
          f"context in fp32, counted at 67 TFLOP/s); share of the data sheet="
          f"{100 * out['prefill_datasheet_share']:.2f} % peak_mem_GB={out['prefill_peak_gb']:.2f}")
    out["prefill_decode"] = prefill_against_decode(name, model, params)
    decode = make_decode_step(model)
    cache = model.init_cache(2, 64, device="cuda")
    tok = torch.zeros((2, 1), dtype=torch.int64, device="cuda")
    for t in range(4):                                       # warm-up
        _, cache = decode(params, cache, torch.full((2,), t, device="cuda"), tok)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(4, 4 + FAMILY_DECODE_STEPS):
        _, cache = decode(params, cache, torch.full((2,), t, device="cuda"), tok)
    torch.cuda.synchronize()
    out["decode_ms_per_token"] = (time.perf_counter() - t0) / FAMILY_DECODE_STEPS * 1e3
    print(f"model decode {name} B=2: {out['decode_ms_per_token']:.3f} ms per step "
          f"({FAMILY_DECODE_STEPS} steps after 4 warm-up, cache 64)")
    return out


def run_family_phase(tmp: str) -> dict:
    """Phase 4h: the other model families, which launch none of the three
    CUDA kernels."""
    import torch

    from repro_torch.kernels import LAUNCHES

    for c in LAUNCHES.values():
        c.n = 0
    out = {name: card_against_cpu(name) for name in FAMILY_NAMES}
    for name, layers, seq, batch, remat, learns in FAMILY_RUNS:
        torch.cuda.empty_cache()
        key = f"{name} full L={layers or 'all'}"
        if name == "deepseek-v2-236b":
            out[key] = deepseek_serving(layers, seq)
        else:
            out[key] = family_full_width(name, layers, seq, batch, remat, learns)
    torch.cuda.empty_cache()
    out["crash_resume"] = crash_resume(tmp, "olmoe-1b-7b", 0.0)
    out["launches"] = got = {k: c.n for k, c in LAUNCHES.items()}
    require(all(n == 0 for n in got.values()), f"the model families launched {got}")
    return out


# ---------------------------------------------------------------- phase 4i


def module_cli(module: str, *argv: str, timeout: int = 900) -> subprocess.CompletedProcess:
    """``python -m <module> <argv>`` in a process of its own, from the
    checkout; its exit code, stdout and stderr."""
    return subprocess.run([sys.executable, "-m", module, *argv], capture_output=True,
                          text=True, timeout=timeout, cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})


def csv_rows(fn, *args) -> list[tuple[str, float, str]]:
    """Call one of ``benchmarks.run``'s row functions and parse what it
    prints (``name,us_per_call,derived``); each row is echoed to the log."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    rows = []
    for line in out.getvalue().strip().splitlines():
        print(f"drivers row {line}")
        name, value, derived = line.split(",", 2)
        rows.append((name, float(value), derived))
    return rows


def loss_line(stdout: str) -> tuple[float, float]:
    first, last = re.search(r"^loss: (\S+) -> (\S+)$", stdout, re.M).groups()
    return float(first), float(last)


def run_drivers_phase(tmp: str) -> dict:
    """Phase 4i: the paper's drivers and the examples, through the entry
    points a user calls.  The paper matrix, ``benchmarks.run``'s card rows
    and quickstart's real-measurement part run in this process, counted
    from 0; the warm replay, ``compare_stores``, ``tune_kernel`` and
    ``train_lm`` run as ``python -m`` in processes of their own."""
    import io

    import numpy as np
    import torch

    from repro_torch import MatrixResults, RunRecord
    from repro_torch.benchmarks import paper_matrix, run
    from repro_torch.core import ExperimentDesign
    from repro_torch.core.backends import BACKENDS
    from repro_torch.examples import quickstart
    from repro_torch.kernels import LAUNCHES

    card = torch.cuda.get_device_name(0)
    d, serve = os.path.join(tmp, "drivers"), os.path.join(tmp, "drivers_serve")
    out = {}
    for c in LAUNCHES.values():
        c.n = 0

    # the paper matrix, cold: mandelbrot at 8192x8192, the five algorithms,
    # the smoke design (S = 25, 50; E = 8, 4)
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = paper_matrix.main(["--backend", "cuda", "--design", "smoke", "--bench",
                                "mandelbrot", "--out", d, "--telemetry", "--report",
                                "--serve-dir", serve])
    wall = time.perf_counter() - t0
    require(rc == 0, f"paper_matrix: exit {rc}")
    for line in printed.getvalue().splitlines():
        if line.startswith("[matrix] ") and "[session]" not in line:
            print(f"drivers paper_matrix: {line}")
    record = RunRecord.load(os.path.join(d, "mandelbrot_cuda.json"))
    prov = record.extra["backend_provenance"]
    require(prov["device_kind"] == card, f"paper_matrix: provenance {prov}")
    results = MatrixResults.load(os.path.join(d, "mandelbrot_cuda.npz"))
    walls = {(w["algo"], w["sample_size"]): w for w in record.extra["cell_wall_s"]}
    design = ExperimentDesign.smoke()
    require(set(results.cells) == {(a, s) for a in paper_matrix.ALGOS
                                   for s in design.sample_sizes},
            f"paper_matrix: cells {sorted(results.cells)}")
    for (algo, s), cell in sorted(results.cells.items()):
        w = walls[(algo, s)]
        print(f"drivers matrix mandelbrot/{algo} S={s}: "
              f"median_final_ms={float(np.median(cell.final_values)) * 1e3!r} "
              f"best_final_ms={float(cell.final_values.min()) * 1e3!r} "
              f"n_samples_used={cell.n_samples_used.tolist()} wall_s={w['wall_s']} "
              f"compile_s={w['compile_s']} measure_s={w['measure_s']}")
        e = design.n_experiments[design.sample_sizes.index(s)]
        require(cell.n_samples_used.tolist() == [s] * e,
                f"paper_matrix {algo} S={s}: samples {cell.n_samples_used.tolist()}")
        require(bool(np.isfinite(cell.final_values).all()),
                f"paper_matrix {algo} S={s}: finals {cell.final_values.tolist()}")
    with open(os.path.join(d, "REPORT.md")) as f:
        report = f.read()
    require("## Quality vs sample size" in report, "paper_matrix: REPORT.md lacks its tables")
    spec = paper_matrix.combo_spec("mandelbrot", "cuda", design, d)
    out["trace"] = check_trace(spec, d, label="mandelbrot paper_matrix")
    hit = json.loads(serving_cli("query", "--dir", serve, "--kernel", "mandelbrot", "--x",
                                 "8192", "--y", "8192", "--device", card, "--expect", "hit"
                                 ).strip().splitlines()[-1])
    print(f"drivers paper_matrix: wall_s={wall:.3f} best_observed_ms="
          f"{record.result['best_observed'] * 1e3!r} device_kind={prov['device_kind']!r} "
          f"serving status={hit['status']} config={json.dumps(hit['config'], sort_keys=True)}")
    require(hit["status"] == "hit", f"paper_matrix --serve-dir: {hit}")
    out["matrix_wall_s"] = wall

    # benchmarks.run: the card rows, the figure rows and claims on the
    # matrix, the host rows
    t0 = time.perf_counter()
    rows = csv_rows(run.table_kernels) + csv_rows(run.table_cuda_backend)
    for fn in (run.table_fig2, run.table_fig3, run.table_fig4):
        rows += csv_rows(fn, d)
    for fn in (run.table_searcher_overhead, run.table_engine_dispatch,
               run.table_scheduler_tail, run.table_telemetry_overhead):
        rows += csv_rows(fn)
    BACKENDS.pop("straggler", None)    # the scheduler row's synthetic backend
    claims = run.validate(d)
    for name, v in claims.items():
        print(f"drivers claim {name}: {v.status}")
    print(f"drivers run rows: n={len(rows)} wall_s={time.perf_counter() - t0:.3f}")
    require(all(math.isfinite(v) for _, v, _ in rows), "benchmarks.run: a row is not finite")
    names = [n for n, _, _ in rows]
    for want in ("kernel_cuda/add", "kernel_cuda/harris", "kernel_cuda/mandelbrot",
                 "cuda_backend/add", "scheduler_tail/steal", "telemetry_overhead/on"):
        require(want in names, f"benchmarks.run: no {want} row")
    require(sum(n.startswith("fig2/mandelbrot_cuda/") for n in names) == 10,
            f"benchmarks.run: fig2 rows {names}")
    out["card_rows"] = {n: dict(us=v, derived=dv) for n, v, dv in rows
                        if n.startswith(("kernel_cuda/", "cuda_backend/"))}
    require(all(v.status == "insufficient-data" for v in claims.values()),
            f"claims decided at E = 8, 4: {claims}")

    # quickstart's real-measurement part: harris tuned on the card
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        r = quickstart.real_measurement()
    print(f"drivers quickstart: {printed.getvalue().strip()}")
    require(math.isfinite(r.final_value), f"quickstart: final {r.final_value}")
    torch.cuda.synchronize()
    got = {k: c.n for k, c in LAUNCHES.items()}
    print(f"drivers launches in this process: {got}")
    require(all(n > 0 for n in got.values()), f"drivers: a kernel was never launched: {got}")
    out["launches"] = got

    # the warm replay on the device executor, from a copy of the store
    warm = os.path.join(tmp, "drivers_warm")
    os.makedirs(warm)
    store = "mandelbrot_cuda_cache.json"
    shutil.copy(os.path.join(d, store), os.path.join(warm, store))
    t0 = time.perf_counter()
    replay = module_cli("repro_torch.benchmarks.paper_matrix", "--backend", "cuda",
                        "--design", "smoke", "--bench", "mandelbrot", "--out", warm,
                        "--executor", "device", "--max-workers", "2", "--force", "--resume")
    print(f"drivers warm replay: exit={replay.returncode} wall_s={time.perf_counter() - t0:.3f} "
          f"{replay.stdout.strip().splitlines()[-1] if replay.stdout.strip() else ''}")
    require(replay.returncode == 0, f"warm replay: exit {replay.returncode}: "
                                    f"{replay.stderr[-3000:]}")
    same = module_cli("repro_torch.tools.compare_stores", os.path.join(d, store),
                      os.path.join(warm, store))
    print(f"drivers compare_stores cold vs warm: exit={same.returncode} {same.stdout.strip()}")
    require(same.returncode == 0 and same.stdout.startswith("IDENTICAL"),
            f"compare_stores: {same.stdout} {same.stderr[-2000:]}")
    nudged = os.path.join(tmp, "drivers_nudged.json")
    with open(os.path.join(d, store)) as f:
        raw = json.load(f)
    values = raw["values"] if isinstance(raw, dict) and "__format__" in raw else raw
    key = sorted(k for k, v in values.items() if math.isfinite(v))[0]
    values[key] = float(np.nextafter(values[key], np.inf))
    with open(nudged, "w") as f:
        json.dump(raw, f)
    differ = module_cli("repro_torch.tools.compare_stores", os.path.join(d, store), nudged)
    print(f"drivers compare_stores one ulp: exit={differ.returncode} "
          f"names_key={f'value mismatch: {key}' in differ.stdout}")
    require(differ.returncode == 1 and f"value mismatch: {key}" in differ.stdout,
            f"compare_stores on a one-ulp change: {differ.stdout}")

    # the examples, as a user runs them
    t0 = time.perf_counter()
    tuned = module_cli("repro_torch.examples.tune_kernel", "--x", "8192", "--y", "8192")
    final = re.search(r"re-measured 5x \(paper protocol\): (\S+) ms", tuned.stdout)
    print(f"drivers tune_kernel 8192x8192: exit={tuned.returncode} "
          f"wall_s={time.perf_counter() - t0:.3f} final_ms={final.group(1) if final else None}")
    require(tuned.returncode == 0 and final and math.isfinite(float(final.group(1))),
            f"tune_kernel: {tuned.stdout[-2000:]} {tuned.stderr[-2000:]}")
    ckpt = os.path.join(tmp, "drivers_train_lm")
    trained = {}
    for steps in (10, 20):
        t0 = time.perf_counter()
        done = module_cli("repro_torch.examples.train_lm", "--full", "--steps", str(steps),
                          "--ckpt", ckpt)
        lines = {k: v for k, v in (line.split(": ", 1) for line in done.stdout.splitlines()
                                   if line.startswith(("resumed from", "steps run", "loss")))}
        print(f"drivers train_lm --full --steps {steps}: exit={done.returncode} "
              f"wall_s={time.perf_counter() - t0:.3f} {lines}")
        require(done.returncode == 0, f"train_lm: {done.stderr[-3000:]}")
        trained[steps] = dict(lines, tok_s=float(re.search(r"\((\d+) tok/s\)",
                                                           lines["steps run"]).group(1)))
        first, last = loss_line(done.stdout)
        require(math.isfinite(first) and last < first,
                f"train_lm --steps {steps}: loss {first} -> {last}")
    require(trained[20]["resumed from"] == "10", f"train_lm: resumed from {trained[20]}")
    out["train_lm"] = trained
    return out


# ---------------------------------------------------------------- phase 4j

#: phase 4j: the 1 x 1 mesh's dry run against the real step's peak memory
SHARD_PEAK_REL = 0.15
SHARD_STEPS = 3
#: the 1 x 1 fake-mesh dry run of phase 4g's cut, in a process of its own
#: (a fake process group never shares a process with an nccl one)
FAKE_1X1 = """
import dataclasses, json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import REGISTRY
from repro_torch.configs.base import ShapeCfg
from repro_torch.kernels import LAUNCHES
from repro_torch.launch.dryrun import build_step, measure_step
from repro_torch.launch.mesh import make_host_mesh, start_fake_process_group
from repro_torch.optim import AdamWConfig
from repro_torch.sharding import ShardingRules
from repro_torch.train import TrainSettings
layers, seq = int(sys.argv[1]), int(sys.argv[2])
for c in LAUNCHES.values():
    c.n = 0
start_fake_process_group(1)
mesh = make_host_mesh(1)
cfg = dataclasses.replace(REGISTRY["yi-34b"], n_layers=layers)
settings = TrainSettings(remat="dots", optimizer=AdamWConfig(lr=1e-3, warmup_steps=1))
with FakeTensorMode():
    fn, args = build_step(cfg, ShapeCfg("cut", seq, 1, "train"), mesh, ShardingRules(), settings)
    m = measure_step(fn, args)
print(json.dumps({**m, "launches": {k: c.n for k, c in LAUNCHES.items()}}))
"""

#: ``python -m <module> <argv>`` run in-process by a process of its own,
#: which then prints the kernels' launch counts of that run as its last line
COUNTED_MODULE = """
import json, runpy, sys
from repro_torch.kernels import LAUNCHES
for c in LAUNCHES.values():
    c.n = 0
sys.argv = sys.argv[1:]
try:
    runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
finally:
    print("launches " + json.dumps({k: c.n for k, c in LAUNCHES.items()}), flush=True)
"""


def counted_start(module: str, *argv: str) -> subprocess.Popen:
    """``python -m <module> <argv>`` started in a process of its own that
    reports the kernels' launch counts of its run (``counted_wait``)."""
    return subprocess.Popen([sys.executable, "-c", COUNTED_MODULE, module, *argv],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=ROOT, env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})


def counted_wait(proc: subprocess.Popen, timeout: int) -> tuple:
    """(the completed process, the counts, or None where the run printed
    none); a run past ``timeout`` is killed."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    last = out.strip().splitlines()[-1:] or [""]
    counts = json.loads(last[0][len("launches "):]) if last[0].startswith("launches ") else None
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err), counts


def counted_cli(module: str, *argv: str, timeout: int = 900) -> tuple:
    """``module_cli`` with the kernels' launch counts of the run."""
    return counted_wait(counted_start(module, *argv), timeout)


def dtensor_step_against_plain() -> dict:
    """4j a, b (in a process of its own, so that its ``nccl`` group and its
    allocator start fresh): phase 4g's cut (yi-34b at full width, 2 layers,
    seq 4096, batch 1) through the DTensor path on a 1 x 1 ("data",
    "model") mesh: three train steps, timed, with the card's peak memory;
    then its loss and each leaf's gradient against the plain step on the
    same weights and batch, and three plain train steps, timed."""
    import dataclasses

    import torch

    from repro_torch.configs import REGISTRY, SHAPES
    from repro_torch.data import DataConfig, make_train_batch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import make_host_mesh, start_process_group
    from repro_torch.models import build_model, init_params, param_axes
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding import ShardingRules
    from repro_torch.sharding.regions import distribute
    from repro_torch.train import TrainSettings, init_train_state, make_train_step
    from repro_torch.train.step import make_grad_fn
    from repro_torch.tree import tree_map, tree_paths

    for c in LAUNCHES.values():
        c.n = 0
    torch.backends.cuda.matmul.allow_tf32 = False
    start_process_group("cuda")
    mesh = make_host_mesh(1)
    cfg = dataclasses.replace(REGISTRY["yi-34b"], n_layers=MODEL_LAYERS)
    seq = SHAPES["train_4k"].seq_len
    model = build_model(cfg)
    # the dry run's remat ("dots")
    settings = TrainSettings(remat="dots", optimizer=AdamWConfig(lr=1e-3, warmup_steps=1))
    batch = make_train_batch(DataConfig(seed=0), cfg, seq, 1, 0, device="cuda")
    init = lambda: init_params(model.spec(), torch.Generator(device="cuda").manual_seed(0), "cuda")
    rules = ShardingRules()
    p_shard = rules.tree_shardings(param_axes(model.spec()), init(), mesh)
    dbatch = {k: distribute(v, rules.sharding_for(("batch", None), tuple(v.shape), mesh))
              for k, v in batch.items()}
    out = {}

    def steps(make_state, batch, step_fn, tag):
        """Three steps from a fresh state (the caller keeps no reference to
        it, so each step holds only the state it replaces and the new one)."""
        state = make_state()
        times, losses = [], []
        for _ in range(SHARD_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        print(f"shard {tag} steps: s={[round(t, 4) for t in times]} losses={losses}")
        require(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
                f"{tag} steps: losses {losses}")
        return min(times[1:]), losses

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["dtensor_step_s"], out["dtensor_losses"] = steps(
        lambda: init_train_state(model, tree_map(distribute, init(), p_shard)), dbatch,
        make_train_step(model, settings, grad_shardings=p_shard), "dtensor 1x1")
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()

    params = init()
    grads, loss, _ = make_grad_fn(model, settings)(params, batch)
    grads = tree_map(lambda g: g.cpu(), grads)
    loss = float(loss)
    dparams = tree_map(distribute, params, p_shard)
    params = None
    dgrads, dloss, _ = make_grad_fn(model, settings, grad_shardings=p_shard)(dparams, dbatch)
    dloss = float(dloss.full_tensor())
    grads = tree_paths(grads)
    errs = {k: rel_err(g.full_tensor(), grads[k]) for k, g in tree_paths(dgrads).items()}
    dgrads = grads = dparams = None
    torch.cuda.empty_cache()
    worst = max(errs, key=errs.get)
    out.update(loss=loss, dtensor_loss=dloss, loss_rel=abs(dloss - loss) / abs(loss),
               grad_rel_worst=errs[worst], grad_worst_leaf=worst)
    print(f"shard yi-34b L={cfg.n_layers} S={seq} B=1 mesh 1x1 vs plain: loss {loss:.6f} vs "
          f"{dloss:.6f} (rel {out['loss_rel']:.3e}); worst leaf gradient max|d|/max|ref| "
          f"{errs[worst]:.3e} ({worst}); bound {MODEL_GRAD_REL}")
    require(out["loss_rel"] <= MODEL_GRAD_REL and errs[worst] <= MODEL_GRAD_REL,
            f"DTensor step against the plain step: {out}")

    out["plain_step_s"], _ = steps(lambda: init_train_state(model, init()), batch,
                                   make_train_step(model, settings), "plain")
    print(f"shard step s (best of steps 2-{SHARD_STEPS}): plain={out['plain_step_s']:.4f} "
          f"dtensor 1x1={out['dtensor_step_s']:.4f} (DTensor dispatch overhead "
          f"{out['dtensor_step_s'] - out['plain_step_s']:+.4f} s, not gated); dtensor "
          f"peak {out['max_memory_allocated'] / 2**30:.2f} GiB")
    out["launches"] = {k: c.n for k, c in LAUNCHES.items()}
    return out


#: 4j a, b in a process of its own
SHARD_CARD = """
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
print(json.dumps(chip_smoke.dtensor_step_against_plain()))
"""


def run_shard_phase(tmp: str) -> dict:
    """Phase 4j: sharding on the one-card host.  The model stack launches
    none of the three CUDA kernels.  Every part runs in a process of its
    own, which sets the counts to 0 when it starts and reports them; the
    phase's count is their sum."""
    import torch

    torch.cuda.empty_cache()
    parts = {}
    card = subprocess.run([sys.executable, "-c", SHARD_CARD, ROOT], capture_output=True,
                          text=True, timeout=600, cwd=tmp,
                          env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    for line in card.stdout.strip().splitlines()[:-1]:
        print(line)
    require(card.returncode == 0, f"4j on the card: exit {card.returncode}: {card.stderr[-3000:]}")
    out = json.loads(card.stdout.strip().splitlines()[-1])
    parts["dtensor_vs_plain"] = out.pop("launches")

    # 4j c: the dry run of the same cut on a 1 x 1 fake mesh
    fake = subprocess.run([sys.executable, "-c", FAKE_1X1, str(MODEL_LAYERS), "4096"],
                          capture_output=True, text=True, timeout=600, cwd=tmp,
                          env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    require(fake.returncode == 0,
            f"1x1 fake dry run: exit {fake.returncode}: {fake.stderr[-3000:]}")
    m = json.loads(fake.stdout.strip().splitlines()[-1])
    parts["dryrun_1x1"] = m.pop("launches")
    peak, real = m["memory"]["peak_bytes_per_dev"], out["max_memory_allocated"]
    out["dryrun_1x1"] = m
    out["peak_rel"] = abs(peak - real) / real
    print(f"shard dryrun 1x1 yi-34b L={MODEL_LAYERS} S=4096 B=1: peak_bytes_per_dev={peak} "
          f"({peak / 2**30:.2f} GiB) vs the card's max_memory_allocated={real} "
          f"({real / 2**30:.2f} GiB): rel {out['peak_rel']:.4f} (bound {SHARD_PEAK_REL}); "
          f"dot FLOPs {m['dots']['flops']:.4e}, "
          f"collectives {m['collectives']['total_bytes']:.4e} B")
    require(out["peak_rel"] <= SHARD_PEAK_REL, f"1x1 dry-run peak against the card: {out}")

    # 4j d: the launcher on the card, through the mesh and the rules
    t0 = time.perf_counter()
    cli, parts["cli"] = counted_cli("repro_torch.launch.train", "--arch", "yi-34b", "--reduced",
                                    "--steps", "10", "--batch", "8", "--seq", "256",
                                    "--model-parallel", "1", "--ckpt",
                                    os.path.join(tmp, "shard_cli"), timeout=600)
    lines = [ln for ln in cli.stdout.splitlines() if ln.startswith("[train]")]
    for line in lines:
        print(f"  {line}")
    loss = re.search(r"loss ([\d.]+) -> ([\d.]+)", cli.stdout)
    require(cli.returncode == 0 and "mesh=(1, 1)" in cli.stdout and loss is not None
            and float(loss.group(2)) < float(loss.group(1)),
            f"launch.train --model-parallel 1: exit {cli.returncode}: {cli.stderr[-3000:]}")
    out["cli"] = {"s": time.perf_counter() - t0, "loss": [float(x) for x in loss.groups()]}
    print(f"shard cli: {out['cli']}")

    # 4j e: one full-size dry-run cell, the single 16 x 16 mesh
    t0 = time.perf_counter()
    cell, parts["dryrun_cell"] = counted_cli("repro_torch.launch.dryrun", "--arch", "yi-34b",
                                             "--shape", "train_4k", "--mesh", "single",
                                             "--force", timeout=600)
    cell_s = time.perf_counter() - t0
    require(cell.returncode == 0 and "ALL CELLS PASSED" in cell.stdout,
            f"dryrun yi-34b train_4k single: exit {cell.returncode}: {cell.stderr[-3000:]}")
    with open(os.path.join(ROOT, "results", "dryrun_torch", "yi-34b_train_4k_single.json")) as f:
        rec = json.load(f)
    out["dryrun_cell"] = {k: rec[k] for k in ("n_devices", "flops_dot_corrected", "wall_s")}
    out["dryrun_cell"].update(coll_bytes=rec["collectives"]["total_bytes"],
                              peak_gib=rec["memory"]["peak_bytes_per_dev"] / 2**30, s=cell_s)
    print(f"shard dryrun yi-34b train_4k single (16x16, fake): {out['dryrun_cell']}")
    require(all(c is not None for c in parts.values()), f"4j parts without counts: {parts}")
    out["launches_by_part"] = parts
    out["launches"] = got = {k: sum(c[k] for c in parts.values()) for k in parts["cli"]}
    print(f"shard launches by part: {parts}")
    require(all(n == 0 for n in got.values()), f"the sharded model stack launched {got}")
    return out


# ---------------------------------------------------------------- phase 4k

#: phase 4k: the matrix the experiments page reads: mandelbrot at
#: 8192x8192, rs and ga at S = 25 with 2 experiments
EXPERIMENTS_DESIGN = "ExperimentDesign(sample_sizes=(25,), n_experiments=(2,), final_repeats=10)"
#: one ``tune_matrix`` in a process of its own; prints its wall seconds, its
#: fills, its finals and the kernels' launch counts of the run
EXPERIMENTS_RUN = f"""
import json, sys, time
import torch
from repro_torch import ExperimentDesign, TuningSpec, tune_matrix
from repro_torch.kernels import LAUNCHES
from repro_torch.telemetry import read_run
out_dir, store, trace = sys.argv[1:4]
for c in LAUNCHES.values():
    c.n = 0
spec = TuningSpec(kernel="mandelbrot", backend="cuda", algorithms=("rs", "ga"),
                  design={EXPERIMENTS_DESIGN}, store="json", store_path=store,
                  cache_key="mandelbrot/{CARD_TAG}")
t0 = time.perf_counter()
res = tune_matrix(spec, out_dir=out_dir, telemetry_dir=trace)
torch.cuda.synchronize()
wall = time.perf_counter() - t0
totals = [e for e in read_run(trace) if e["ev"] == "totals"][-1]["counters"]
print(json.dumps({{
    "wall_s": wall,
    "compiles": totals.get("compiles", 0),
    "cells": {{f"{{a}}/S={{s}}": c.final_values.tolist() for (a, s), c in res.cells.items()}},
    "launches": {{k: c.n for k, c in LAUNCHES.items()}},
}}))
"""


def experiments_matrix(tmp: str) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", EXPERIMENTS_RUN, os.path.join(tmp, "matrix"),
                           os.path.join(tmp, "store.json"), os.path.join(tmp, "trace")],
                          capture_output=True, text=True, timeout=600, cwd=tmp,
                          env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    require(proc.returncode == 0, f"experiments matrix: exit {proc.returncode}: "
            f"{proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["process_s"] = time.perf_counter() - t0
    print(f"experiments matrix mandelbrot 8192x8192: wall_s={out['wall_s']:.3f} "
          f"process_s={out['process_s']:.3f} compiles={out['compiles']} "
          f"launches={out['launches']}")
    require(out["compiles"] > 0 and all(math.isfinite(v) for vals in out["cells"].values()
                                        for v in vals),
            f"experiments matrix: compiles {out['compiles']}, finals {out['cells']}")
    return out


def run_experiments_phase(tmp: str) -> dict:
    """Phase 4k: a matrix on the card, then the hill-climb, the sharding
    tuner and the experiments page over that matrix.  Every part
    runs in a process of its own, which sets the counts to 0 when it starts
    and reports them; the phase's count is their sum.  The two host-only
    drivers run while the card measures."""
    hill = counted_start("repro_torch.benchmarks.hillclimb", "--cells", "olmoe-1b-7b:train_4k",
                         "--variants", "baseline", "H1_bf16gather", "H2_moe_dispatch")
    tune = counted_start("repro_torch.examples.tune_sharding", "--arch", "olmoe-1b-7b",
                         "--budget", "3")
    try:
        return experiments_parts(tmp, hill, tune)
    finally:
        for proc in (hill, tune):         # a failed part leaves none running
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def experiments_parts(tmp: str, hill_proc, tune_proc) -> dict:
    from repro_torch.kernels import _build

    parts, out = {}, {}

    # 4k a: the matrix the page reads
    matrix = experiments_matrix(tmp)
    parts["matrix"] = matrix.pop("launches")
    require(parts["matrix"]["mandelbrot"] > 0, f"experiments matrix launched {parts['matrix']}")
    out["matrix"] = matrix
    # 4k a': a harris launch the card refuses for its geometry.  Every
    # config launches 64 threads a block, and the screen holds the grid to
    # CUDA's limits, so no geometry the screen passes is refused
    print("experiments harris invalid: none exists (64 threads a block for every "
          f"config; the screen holds the grid to CUDA's limits; refusals "
          f"{sorted(_build.CONFIG_ERRORS)} reach no screened geometry)")

    # 4k b, c: the host-only drivers started above
    t0 = time.perf_counter()
    hill, parts["hillclimb"] = counted_wait(hill_proc, 600)
    lines = hill.stdout.splitlines()
    for line in lines:
        if line.startswith(("[hillclimb]", "|")):
            print(f"  {line}")
    noop = [ln for ln in lines if ln.startswith("[hillclimb] variants that change no op")]
    recs = [os.path.join(ROOT, "results", "perf_torch", f"olmoe-1b-7b_train_4k__{v}.json")
            for v in ("baseline", "H1_bf16gather", "H2_moe_dispatch")]
    require(hill.returncode == 0 and all(os.path.exists(r) for r in recs)
            and sum(ln.startswith("| olmoe-1b-7b:train_4k |") for ln in lines) == 3
            and noop and "H2_moe_dispatch (= baseline)" in noop[0],
            f"hillclimb: exit {hill.returncode}: {hill.stdout[-2000:]} {hill.stderr[-3000:]} "
            f"records: {[open(r).read() for r in recs if os.path.exists(r)]}")
    tune, parts["tune_sharding"] = counted_wait(tune_proc, 600)
    best = re.search(r"^best distributed config for olmoe-1b-7b train_4k: (.+)$", tune.stdout, re.M)
    step = re.search(r"^modelled step time (\S+)s$", tune.stdout, re.M)
    for line in tune.stdout.splitlines():
        if line.startswith(("  cfg=", "best", "modelled")):
            print(f"  {line}")
    require(tune.returncode == 0 and best is not None and step is not None
            and float(step.group(1)) > 0,
            f"tune_sharding: exit {tune.returncode}: {tune.stdout[-2000:]} {tune.stderr[-3000:]}")
    out["drivers_wait_s"] = time.perf_counter() - t0

    # 4k d: the page over 4k's matrix, 4j's dry-run records and 4k's perf records
    page = os.path.join(tmp, "EXPERIMENTS_torch.md")
    md, parts["make_experiments_md"] = counted_cli(
        "repro_torch.benchmarks.make_experiments_md", "--matrix-dir", os.path.join(tmp, "matrix"),
        "--dryrun-dir", os.path.join(ROOT, "results", "dryrun_torch"),
        "--perf-dir", os.path.join(ROOT, "results", "perf_torch"), "--out", page, timeout=300)
    require(md.returncode == 0 and os.path.exists(page),
            f"make_experiments_md: exit {md.returncode}: {md.stderr[-3000:]}")
    with open(page) as f:
        text = f.read()
    heads = ("# EXPERIMENTS (PyTorch/CUDA port)", "## §Validation", "## §Figures", "## §Dry-run",
             "## §Roofline", "## §Perf", "## §Repro-perf")
    print(f"experiments page: {len(text)} chars, sections "
          f"{[h for h in heads if h in text]}, dry-run rows "
          f"{sum(ln.startswith('| yi-34b | train_4k | single') for ln in text.splitlines())}")
    require(all(h in text for h in heads) and "mandelbrot x h100" in text
            and "### olmoe-1b-7b_train_4k" in text and "| H2_moe_dispatch |" in text,
            f"make_experiments_md: sections missing: {text[:3000]}")
    require(not any(w in text for w in ("v5e", "TPU", "197 TF")), "the page names a TPU figure")
    require(all(c is not None for c in parts.values()), f"4k parts without counts: {parts}")
    out["launches_by_part"] = parts
    out["launches"] = got = {k: sum(p[k] for p in parts.values()) for k in parts["matrix"]}
    print(f"experiments launches by part: {parts}")
    require(all(parts[p][k] == 0 for p in ("hillclimb", "tune_sharding", "make_experiments_md")
                for k in parts[p]), f"the host-only drivers launched kernels: {parts}")
    return out


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
    # phase 4g's crash-resume check runs with deterministic algorithms, which
    # need cuBLAS's workspace fixed before CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        model = run_model_phase(tmp)                  # 4g.
        phase_s["model"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        families = run_family_phase(tmp)              # 4h.
        phase_s["families"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        drivers = run_drivers_phase(tmp)              # 4i.
        phase_s["drivers"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        shard = run_shard_phase(tmp)                  # 4j.
        phase_s["shard"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        experiments = run_experiments_phase(tmp)      # 4k.
        phase_s["experiments"] = time.perf_counter() - t0
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
                         + matrix["launches"][name] + served + drivers["launches"][name]
                         + experiments["launches"][name]),
            "launches_by_phase": {"main": main_path["launches"][name],
                                  "searchers": searchers["launches"][name],
                                  "matrix": matrix["launches"][name],
                                  "serving": served,
                                  "model_stack": model["launches"][name],
                                  "model_families": families["launches"][name],
                                  "drivers": drivers["launches"][name],
                                  "sharding": shard["launches"][name],
                                  "experiments": experiments["launches"][name]},
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
            "drivers": {n: r for n, r in drivers["card_rows"].items()
                        if n.endswith("/" + name)},
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
