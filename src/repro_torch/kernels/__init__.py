"""The port's tunable kernels for the paper's three ImageCL benchmarks.

Each kernel directory holds:
    ops.py  — the public wrapper taking the paper's 6-param config: it
              launches the hand-written CUDA kernel (``csrc/*.cu``) on CUDA
              tensors, counts its launches, and computes the plain version
              on CPU tensors
    ref.py  — the plain PyTorch version, mirroring the reference's oracle

Validation policy: against the reference on the CPU, the reference's own
tolerances (add and harris allclose-style across shape/dtype/config sweeps;
Mandelbrot's escape-time loop is chaotic at the set boundary, so '>= 99.5%
pixels exactly equal, violations within +-4 iterations').  On the card each
CUDA kernel is held to its plain version: add and mandelbrot exactly (the
kernels round every operation as the plain versions do), harris within
1e-5 of its largest value.
"""

from .add import ops as _add_ops
from .add.ops import BENCH as _add_bench
from .add.ops import add
from .add.ref import add_ref
from .harris import ops as _harris_ops
from .harris.ops import BENCH as _harris_bench
from .harris.ops import harris
from .harris.ref import harris_ref
from .mandelbrot import ops as _mandelbrot_ops
from .mandelbrot.ops import BENCH as _mandelbrot_bench
from .mandelbrot.ops import mandelbrot
from .mandelbrot.ref import mandelbrot_ref

#: per-kernel input/resource descriptors consumed by the measurement backend
KERNEL_BENCHES = {
    b.name: b for b in (_add_bench, _harris_bench, _mandelbrot_bench)
}

#: each wrapper's count of CUDA launches (``LAUNCHES["add"].n``)
LAUNCHES = {
    "add": _add_ops.launches,
    "harris": _harris_ops.launches,
    "mandelbrot": _mandelbrot_ops.launches,
}

__all__ = [
    "LAUNCHES",
    "add",
    "add_ref",
    "harris",
    "harris_ref",
    "mandelbrot",
    "mandelbrot_ref",
    "KERNEL_BENCHES",
]
