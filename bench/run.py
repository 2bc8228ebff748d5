"""The port's benchmark: one run of one cell on one card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  It ends with one JSON line on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
``breakdown`` when traced, and ``checks`` last: each number compared with
its limit, which also close standard error.  It exits non-zero with no
result where there is no CUDA card, fewer cards than the cell asks for, no
program beside ``BENCHMARK.json``, or where JAX or the JAX package was
loaded.  See bench/README.md.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: module names (whole, before the first dot) the run must not have loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names) -> list[str]:
    """The loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def cache_env(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout, so only a
    checkout's first run builds.  The port's own library builds into
    ``src/repro_torch/kernels/build/``."""
    cache = root / ".cache" / "bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "BENCHMARK.json").is_file() or not (ROOT / "src" / "repro_torch").is_dir():
        print(f"bench: no program beside BENCHMARK.json under {ROOT}", file=sys.stderr)
        return 2
    cache_env(ROOT)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from bench.harness import layout, runner

    cell = layout.cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"available={torch.cuda.is_available()} "
              f"count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = runner.run_cell(cell, seed=args.seed, seconds=args.seconds,
                             trace=bool(args.trace), t_start=T_START)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"bench: the run loaded JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
