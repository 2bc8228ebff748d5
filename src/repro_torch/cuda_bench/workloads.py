"""Workload plumbing: materialize deterministic per-kernel problems (a port
of ``repro.pallas_bench.workloads``).

A :class:`CudaWorkload` binds one kernel's :class:`KernelBenchSpec` to a
concrete image size and input seed.  Inputs are drawn exactly as the
reference draws them — ``np.random.default_rng(stable_seed("pallas_inputs",
name, x, y, input_seed))``, ``standard_normal``, cast to float32 — and only
then become tensors, so :meth:`CudaWorkload.materialize` is byte-identical to
the reference's for the same fields.  The measurement stages them in an
``inputs`` stage of its own; ``materialize(device, timings)`` splits that
stage into the draw (or the cache's lookup) and the copy to the device.

The draw is a pure function of ``(kernel, x, y, input_seed)``, so the host
arrays are drawn once a process and kept in a process-wide cache (least
recently used out first, :data:`INPUT_CACHE_BYTES` in all).  Outside a
:func:`shared_inputs` scope every ``materialize`` copies them to the device
and waits for the copy: the device holds nothing across calls.  The cached
arrays are read-only, no tensor handed out aliases them, and two threads
that miss on one key draw once.  :meth:`CudaWorkload.arrays` stays the
plain, uncached draw.

Inside a :func:`shared_inputs` scope (a matrix call opens one around its
dataset, units and merge) the device copies are shared too: the first
``materialize`` of a ``(cache_key, device)`` copies, every later one in the
scope gets the same tensors, and the outermost scope's exit drops them.
The values a measurement reads are unchanged, since the bytes are the same
and no kernel writes its inputs; a measurement's ``release()`` drops only
its own reference.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from concurrent.futures import Future
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.clock import monotonic
from ..core.measurement import fence
from ..core.runner import stable_seed
from ..kernels import KERNEL_BENCHES
from ..kernels.common import Config, KernelBenchSpec

#: default problem size on the card: 8192x8192 f32, the image of the cost
#: model's KernelWorkload.  Each array is 268 MB, well past the 50 MB L2.
DEFAULT_X = 8192
DEFAULT_Y = 8192

#: host bytes the input cache keeps: harris's one 8192² f32 array and add's
#: two fit together.  An entry larger than this is drawn and not kept
INPUT_CACHE_BYTES = 2 << 30


class _InputCache:
    """Drawn host inputs by ``(kernel, x, y, input_seed)``, read-only."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple, tuple[np.ndarray, ...]] = OrderedDict()
        self._drawing: dict[tuple, Future] = {}
        self.nbytes = 0

    def get(self, key: tuple, draw) -> tuple[tuple[np.ndarray, ...], bool]:
        """``(arrays, hit)``: the arrays of ``key``, drawn by ``draw()`` on a
        miss.  A thread that misses while another draws the same key waits
        for that draw (a hit: it drew nothing)."""
        with self._lock:
            arrays = self._entries.get(key)
            if arrays is not None:
                self._entries.move_to_end(key)
                return arrays, True
            pending = self._drawing.get(key)
            if pending is None:
                self._drawing[key] = mine = Future()
        if pending is not None:
            return pending.result(), True
        try:
            arrays = tuple(draw())
            for a in arrays:
                a.flags.writeable = False
        except BaseException as e:
            with self._lock:
                del self._drawing[key]
            mine.set_exception(e)
            raise
        size = sum(a.nbytes for a in arrays)
        with self._lock:
            del self._drawing[key]
            if size <= INPUT_CACHE_BYTES:
                while self._entries and self.nbytes + size > INPUT_CACHE_BYTES:
                    self.nbytes -= sum(a.nbytes for a in self._entries.popitem(last=False)[1])
                self._entries[key] = arrays
                self.nbytes += size
        mine.set_result(arrays)
        return arrays, False

    def peek(self, key: tuple) -> tuple[np.ndarray, ...] | None:
        """The arrays of ``key``, or ``None``; not counted as a use."""
        with self._lock:
            return self._entries.get(key)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.nbytes = 0


_INPUT_CACHE = _InputCache()


def clear_input_cache() -> None:
    """Empty the process's input cache (the next ``materialize`` of each
    workload draws again)."""
    _INPUT_CACHE.clear()


def cached_inputs(workload: "CudaWorkload") -> tuple[np.ndarray, ...] | None:
    """``workload``'s cached host arrays (read-only), or ``None`` where the
    cache holds none."""
    return _INPUT_CACHE.peek(workload.cache_key)


class _DeviceInputs:
    """Device copies of inputs by ``(cache_key, device)``, held while a
    :func:`shared_inputs` scope is open and dropped when the outermost one
    exits."""

    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0
        #: bumped by each outermost exit: a copy that began in an earlier
        #: scope is not kept in a later one
        self._generation = 0
        self._entries: dict[tuple, tuple[torch.Tensor, ...]] = {}
        self._copying: dict[tuple, Future] = {}

    def enter(self) -> None:
        with self._lock:
            self._depth += 1

    def exit(self) -> None:
        with self._lock:
            self._depth -= 1
            if self._depth == 0:
                self._entries.clear()
                self._copying.clear()
                self._generation += 1

    def get(self, key: tuple, copy) -> tuple[tuple[torch.Tensor, ...], bool]:
        """``(tensors, reused)``: outside a scope ``copy()`` every time;
        inside one, the scope's tensors of ``key``, made by ``copy()`` on
        the first use.  A thread that asks while another copies the same
        key waits for that copy (a reuse: it copied nothing)."""
        with self._lock:
            if self._depth == 0:
                shared = False
            else:
                shared = True
                tensors = self._entries.get(key)
                if tensors is not None:
                    return tensors, True
                pending = self._copying.get(key)
                if pending is None:
                    self._copying[key] = mine = Future()
                generation = self._generation
        if not shared:
            return copy(), False
        if pending is not None:
            return pending.result(), True
        try:
            tensors = copy()
        except BaseException as e:
            with self._lock:
                if self._copying.get(key) is mine:
                    del self._copying[key]
            mine.set_exception(e)
            raise
        with self._lock:
            if self._copying.get(key) is mine:
                del self._copying[key]
            if self._generation == generation:
                self._entries[key] = tensors
        mine.set_result(tensors)
        return tensors, False


_DEVICE_INPUTS = _DeviceInputs()


@contextmanager
def shared_inputs():
    """A scope in which every ``materialize`` of one workload on one device
    returns one shared copy, made on the first use.  Scopes nest (the
    outermost owns the copies) and span threads: the whole process shares
    them.  On exit of the outermost, for any reason, every copy is dropped,
    so nothing stays on the device across scopes."""
    _DEVICE_INPUTS.enter()
    try:
        yield
    finally:
        _DEVICE_INPUTS.exit()


@dataclass(frozen=True)
class CudaWorkload:
    """One kernel bound to a concrete problem: the unit cuda_bench measures."""

    bench: KernelBenchSpec = field(repr=False)
    x: int = DEFAULT_X
    y: int = DEFAULT_Y
    input_seed: int = 0

    @property
    def name(self) -> str:
        return self.bench.name

    @property
    def cache_key(self) -> tuple:
        """What the inputs are a function of."""
        return (self.name, self.x, self.y, self.input_seed)

    def arrays(self) -> tuple[np.ndarray, ...]:
        """Deterministic numpy inputs (pure function of the workload fields),
        drawn anew on every call."""
        seed = stable_seed("pallas_inputs", self.name, self.x, self.y, self.input_seed)
        return tuple(self.bench.make_inputs(self.x, self.y, seed))

    def materialize(self, device, timings: dict | None = None) -> tuple[torch.Tensor, ...]:
        """The inputs as tensors on ``device``, the copy waited for (always
        named: a caller who forgets it must not land on the CPU without a
        word).  The host arrays come from the process's input cache, drawn
        by :meth:`arrays` on a miss.  Outside a :func:`shared_inputs` scope
        each tensor is a copy of its own; inside one, the scope's copy for
        this workload and device, made on its first use there (the same
        bytes, and no kernel writes its inputs).

        ``timings``, when given, receives ``draw_s`` (the draw, or on a hit
        the lookup), ``copy_s`` (the copy to ``device``, or on a reuse the
        scope's lookup) and, for a workload with inputs, ``cache_hit`` and
        ``device_reuse`` (1 or 0 each); the tensors hold the same bytes
        either way, and the clock is read as often."""
        t0 = monotonic()
        if self.bench.n_inputs:
            arrays, hit = _INPUT_CACHE.get(self.cache_key, self.arrays)
        else:
            arrays, hit = (), None

        def copy() -> tuple[torch.Tensor, ...]:
            # torch.tensor copies (from_numpy would alias, and warns on a
            # read-only array): one copy to the card, or a tensor of its own
            # here
            out = tuple(torch.tensor(a, device=device) for a in arrays)
            for t in out:
                fence(t)
            return out

        t1 = monotonic()
        if arrays:
            out, reused = _DEVICE_INPUTS.get((self.cache_key, torch.device(device)), copy)
        else:
            out, reused = (), None
        if timings is not None:
            timings.update(draw_s=t1 - t0, copy_s=monotonic() - t1)
            if hit is not None:
                timings.update(cache_hit=int(hit), device_reuse=int(reused))
        return out

    def run(self, inputs: tuple, cfg: Config, device):
        """Launch the kernel; returns its (possibly in-flight) output.  The
        measurement layer owns fencing and timing."""
        return self.bench.run(inputs, cfg, self.x, self.y, device)


def make_workload(
    kernel: str,
    x: int = DEFAULT_X,
    y: int = DEFAULT_Y,
    input_seed: int = 0,
) -> CudaWorkload:
    """Resolve a kernel id to a measurable workload."""
    if kernel not in KERNEL_BENCHES:
        raise KeyError(
            f"unknown kernel {kernel!r}; have {sorted(KERNEL_BENCHES)}"
        )
    if x < 8 or y < 128:
        raise ValueError(
            f"problem size ({x}, {y}) below the minimum f32 tile (8, 128)"
        )
    return CudaWorkload(bench=KERNEL_BENCHES[kernel], x=int(x), y=int(y),
                        input_seed=int(input_seed))
