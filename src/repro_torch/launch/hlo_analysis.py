"""Per-device FLOP and collective accounting of one step (the port's
counterpart of ``repro.launch.hlo_analysis``, under the reference's name so
that a reader finds it).

The reference parses XLA's post-SPMD HLO text and multiplies each
computation's counts by the trip counts of the ``while`` loops around it.
There is no HLO here: the step itself runs (under ``FakeTensorMode`` in the
dry run, so nothing is allocated) inside a dispatch mode that sees every op
*one rank* runs.  A DTensor op is passed on to DTensor (the mode returns
``NotImplemented`` for it), which redistributes its inputs with functional
collectives and runs the op on the local shards; the mode then sees those
local ops and collectives, so every count is per device.  The ops DTensor
runs on its own nested fake mode to propagate shapes are not counted.

The port's layers run in a Python loop, so every layer dispatches and no
trip-count correction exists: each ``*_uncorrected`` value equals its
corrected one.
"""

from __future__ import annotations

import contextlib
import math

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

#: functional collectives (``torch.ops._c10d_functional``) by the
#: reference's kind; DTensor's redistributions issue these.  A CPU mesh
#: gathers and chunks where a CUDA one would all-to-all
_KIND_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def shape_bytes(dtype, shape) -> int:
    """Bytes of a tensor of ``dtype`` and ``shape``."""
    import torch

    return math.prod(shape) * torch.empty((), dtype=dtype, device="meta").element_size()


def _dot_flops(func, args, out) -> float:
    """2 * output elements * contracted size for the matmul-class ops
    (``mm``, ``addmm``, ``bmm``, ``baddbmm``; ``einsum`` and ``matmul``
    lower to these), else 0."""
    import torch

    aten = torch.ops.aten
    name = func.overloadpacket
    if name in (aten.mm, aten.bmm):
        a = args[0]
    elif name in (aten.addmm, aten.baddbmm):
        a = args[1]
    else:
        return 0.0
    return 2.0 * out.numel() * a.shape[-1]


@contextlib.contextmanager
def propagation_off_the_books():
    """DTensor derives each op's global output shape by running it on
    global-shape fake tensors, in the fake mode it detects: under the dry
    run's, those would count as one rank's FLOPs, traffic and memory.  Hand
    it a fake mode of its own, as it takes when none is active, so the
    counters (which count only under the mode active when they start) skip
    it.  The hook is private: a torch without it raises here, since every
    per-device count would silently turn global."""
    import torch
    import torch.distributed.tensor._sharding_prop as prop

    if not hasattr(prop, "detect_fake_mode"):
        raise RuntimeError(
            f"torch {torch.__version__}: torch.distributed.tensor._sharding_prop has no "
            "detect_fake_mode to redirect, so DTensor's global-shape propagation would "
            "count as one rank's FLOPs, bytes and memory")
    saved, prop.detect_fake_mode = prop.detect_fake_mode, lambda *a, **k: None
    try:
        yield
    finally:
        prop.detect_fake_mode = saved


class StepCounter:
    """A dispatch mode counting one rank's dot FLOPs and collectives."""

    def __init__(self):
        self.flops = 0.0
        #: bytes each (non-view) op reads and writes, per device: the
        #: counterpart of XLA's "bytes accessed"
        self.bytes_accessed = 0.0
        self.bytes = {k: 0.0 for k in _COLLECTIVES}
        self.counts = {k: 0.0 for k in _COLLECTIVES}

    def __enter__(self):
        import torch
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves

        counter = self
        entry_fake = active_fake_mode()

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **(kwargs or {}))
                # DTensor's shape propagation runs on a fake mode of its own
                if active_fake_mode() is entry_fake:
                    counter.flops += _dot_flops(func, args, out)
                    if not func.is_view:
                        counter.bytes_accessed += sum(
                            t.nbytes for t in tree_leaves((args, kwargs, out))
                            if isinstance(t, torch.Tensor))
                    kind = (_KIND_OF.get(func.overloadpacket.__name__)
                            if func.namespace == "_c10d_functional" else None)
                    if kind:
                        outs = out if isinstance(out, (list, tuple)) else [out]
                        counter.bytes[kind] += sum(shape_bytes(o.dtype, o.shape) for o in outs)
                        counter.counts[kind] += 1
                return out

        self._stack = contextlib.ExitStack()
        self._stack.enter_context(propagation_off_the_books())
        self._stack.enter_context(_Mode())
        return self

    def __exit__(self, *exc):
        self._stack.__exit__(*exc)

    def dots(self) -> dict:
        return {"flops": self.flops, "flops_uncorrected": self.flops}

    def collectives(self) -> dict:
        return {
            "bytes": dict(self.bytes),
            "bytes_uncorrected": dict(self.bytes),
            "counts": dict(self.counts),
            "total_bytes": sum(self.bytes.values()),
            "total_bytes_uncorrected": sum(self.bytes.values()),
        }


def _count(step, *args) -> StepCounter:
    with StepCounter() as counter:
        step(*args)
    return counter


def dot_flops(step, *args) -> dict:
    """Per-device FLOPs of every matmul-class op ``step(*args)`` runs:
    2 * output elements * contracted size (elementwise and reduction FLOPs
    excluded, as the reference's count excludes them)."""
    return _count(step, *args).dots()


def collective_stats(step, *args) -> dict:
    """Per-device collective result bytes and op counts by kind, in the
    reference's keys."""
    return _count(step, *args).collectives()
