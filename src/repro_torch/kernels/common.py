"""Geometry shared by the port's three kernels (a port of ``repro.kernels.common``).

A config of the paper's 6-parameter space means the same tile in both
packages, so stored configs stay comparable:

    bm = 8 * t_x          tile rows per row sub-tile
    bn = 128 * t_y        tile cols
    t_z                   row coarsening (row sub-tiles per block)
    w_x, w_y              region splits (grid decomposition)
    w_z                   pipeline depth — kept out of the program, as the
                          reference keeps it: configs differing only in w_z
                          launch identically

Region splits use *clamped block indices*: the grid is
(w_x * steps_r, w_y * steps_c), each region covering ceil(extent / w)
elements in steps of one tile, and an index past the last real tile clamps
to it.  Since ``region * steps + local`` is the flat grid index itself, a
block's tile is ``min(flat index, n_tiles - 1)``: the splits add duplicate
blocks at the end of each axis, which rewrite the last tile with identical
values.  :func:`launch_plan` is the one place this arithmetic lives; the
CUDA kernels receive its numbers as launch arguments.

On the card the grid's x axis walks tile columns and its y axis tile rows,
so consecutive blocks follow the reference's row-major grid order.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from math import ceil
from typing import Callable

Config = dict


@dataclass(frozen=True)
class KernelGeometry:
    bm: int
    bn: int
    tz: int
    wx: int
    wy: int
    wz: int

    @property
    def rows_step(self) -> int:
        return self.bm * self.tz


@dataclass(frozen=True)
class KernelBenchSpec:
    """What a kernel package publishes to the measurement backend
    (:mod:`repro_torch.cuda_bench`): its input model and the two callables
    the bench harness needs.

    ``make_inputs(x, y, seed)`` returns numpy arrays and must be a pure
    function of its arguments, so every process rebuilds bit-identical
    problems.  ``run(inputs, cfg, x, y, device)`` launches the kernel and
    returns its (possibly still in-flight) output; the harness owns fencing
    and timing.  ``smem_bytes`` is the shared memory one block of the CUDA
    kernel uses — fixed per kernel, whatever the config — which the validity
    screen holds against the card's per-block limit.  ``wz_in_program``
    records whether ``w_z`` changes the launched program (it does not).
    """

    name: str
    n_inputs: int
    make_inputs: Callable[[int, int, int], tuple] = field(repr=False, default=None)
    run: Callable[..., object] = field(repr=False, default=None)
    smem_bytes: int = 0


def geometry_from_config(cfg: Config) -> KernelGeometry:
    return KernelGeometry(
        bm=8 * cfg.get("t_x", 1),
        bn=128 * cfg.get("t_y", 1),
        tz=cfg.get("t_z", 1),
        wx=cfg.get("w_x", 1),
        wy=cfg.get("w_y", 1),
        wz=cfg.get("w_z", 1),
    )


def split_grid(extent: int, block: int, splits: int) -> tuple[int, int]:
    """(steps_per_region, n_blocks_total) for a clamped region split."""
    region = ceil(extent / splits)
    steps = ceil(region / block)
    n_blocks = ceil(extent / block)
    return steps, n_blocks


def clamped_index(region: int, local: int, steps: int, n_blocks: int) -> int:
    """Block index for (region, local step), clamped to the last real block."""
    return min(region * steps + local, n_blocks - 1)


@dataclass(frozen=True)
class LaunchPlan:
    """Grid and tiling of one kernel launch on an (x, y) image.

    ``grid`` is (row blocks, col blocks) in the reference's order; the CUDA
    launch puts col blocks on ``gridDim.x`` and row blocks on ``gridDim.y``.
    """

    rows: int          # tile rows: bm * t_z
    cols: int          # tile cols: bn
    bm: int            # rows of one row sub-tile
    tz: int
    steps_r: int
    nblk_r: int
    steps_c: int
    nblk_c: int
    grid: tuple[int, int]

    def row_block(self, gi: int) -> int:
        return clamped_index(gi // self.steps_r, gi % self.steps_r,
                             self.steps_r, self.nblk_r)

    def col_block(self, gj: int) -> int:
        return clamped_index(gj // self.steps_c, gj % self.steps_c,
                             self.steps_c, self.nblk_c)

    def origins(self) -> list[tuple[int, int]]:
        """Clamped tile origin (row, col) of every block, in grid order."""
        gx, gy = self.grid
        return [
            (self.row_block(gi) * self.rows, self.col_block(gj) * self.cols)
            for gi in range(gx)
            for gj in range(gy)
        ]


def launch_plan(g: KernelGeometry, x: int, y: int) -> LaunchPlan:
    """The launch of geometry ``g`` on an (x, y) image: the reference's
    BlockSpec grid, with the ragged edge masked instead of padded."""
    rows = g.rows_step
    steps_r, nblk_r = split_grid(x, rows, g.wx)
    steps_c, nblk_c = split_grid(y, g.bn, g.wy)
    return LaunchPlan(
        rows=rows, cols=g.bn, bm=g.bm, tz=g.tz,
        steps_r=steps_r, nblk_r=nblk_r, steps_c=steps_c, nblk_c=nblk_c,
        grid=(g.wx * steps_r, g.wy * steps_c),
    )


class LaunchCounter:
    """How many times a wrapper launched its CUDA kernel.  The wrapper adds
    one where it launches, and nowhere else; callers read ``n`` and may set
    it to 0.  Adds hold a lock: the device executor's threads launch on
    several cards at once, and ``n += 1`` is a read-modify-write."""

    def __init__(self) -> None:
        self.n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.n += 1
