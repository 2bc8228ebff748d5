"""The port's tunable kernels for the paper's three ImageCL benchmarks.

Each kernel directory holds:
    ops.py  — the public wrapper taking the paper's 6-param config: it
              launches the hand-written CUDA kernel (``csrc/*.cu``) on CUDA
              tensors, counts its launches, and computes the plain version
              on CPU tensors
    ref.py  — the plain PyTorch version, mirroring the reference's oracle

Validation policy (as the reference's): add and harris are compared with
allclose-style bounds across shape/dtype/config sweeps; Mandelbrot's
escape-time loop is chaotic at the set boundary, so its check is '>= 99.5%
pixels exactly equal, violations within +-4 iterations'.
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
