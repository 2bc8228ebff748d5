"""Config-validity layer: pre-screen geometries, classify failures (a port
of ``repro.pallas_bench.validity`` with the card's limits in place of the
TPU's).

* :func:`validate_config` pre-screens a config's :class:`KernelGeometry`
  BEFORE any launch and returns a structured reason string (``None`` when
  the config is runnable).  Rules, in the reference's order:
  align -> block-vs-image -> grid -> memory.  The grid rule holds the launch
  to CUDA's limits (gridDim.x <= 2^31-1 tile columns, gridDim.y <= 65535
  tile rows) instead of the reference's cap of 65536 steps in all; the
  memory rule holds the kernel's own shared memory per block against the
  227 KB a Hopper block can use.  Both limits are the one supported card's
  fixed figures (:data:`SMEM_LIMIT`, :data:`MAX_GRID_Y`, :data:`MAX_GRID_X`),
  not options.
* :class:`InvalidMeasurement` is the penalty record a failing config maps
  to, with the reference's meta format ``<stage>:<reason>``.
* :func:`fit_constraint` packages the pre-screen as a *named* SearchSpace
  constraint, stable id ``cuda_fit:<kernel>:<x>:<y>:<smem>:<grid>`` (the
  limits it screens against are part of the name), which
  :func:`repro_torch.core.api._resolve_constraint` rebuilds by name.  Its
  ``batch`` attribute (:func:`fit_mask`) gives the same verdicts for a
  whole batch of configs in one numpy pass, which
  :meth:`repro_torch.core.space.SearchSpace.valid_mask` uses.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from math import ceil

import numpy as np

from ..kernels.common import (
    Config,
    KernelBenchSpec,
    KernelGeometry,
    geometry_from_config,
    launch_plan,
)
from .workloads import CudaWorkload

#: shared memory one block may use on Hopper (sm_90, opt-in maximum)
SMEM_LIMIT = 232448
#: CUDA's limit on gridDim.y, which carries the tile rows
MAX_GRID_Y = 65535
#: CUDA's limit on gridDim.x, which carries the tile columns
MAX_GRID_X = 2**31 - 1
SUBLANES = 8    # f32 min tile rows
LANES = 128     # lane count (last-dim tile)


@dataclass(frozen=True)
class InvalidMeasurement:
    """Structured penalty for a config that cannot be (or failed to be)
    measured: served to searchers as ``float("inf")``, persisted to the
    measurement store with its reason."""

    reason: str
    stage: str = "validity"       # "validity" | "compile" | "run"
    penalty: float = float("inf")

    def to_meta(self) -> str:
        """Serialized form stored in the measurement-store metadata."""
        return f"{self.stage}:{self.reason}"

    @classmethod
    def from_meta(cls, meta: str) -> "InvalidMeasurement":
        stage, _, reason = meta.partition(":")
        if stage not in ("validity", "compile", "run"):
            stage, reason = "validity", meta
        return cls(reason=reason, stage=stage)


def validate_geometry(
    bench: KernelBenchSpec,
    g: KernelGeometry,
    x: int,
    y: int,
) -> str | None:
    """Reason the geometry cannot run on problem (x, y), or None if it can.

    * tile alignment — block dims must be multiples of the (8, 128) f32 tile
      (always true for config-derived geometries; guards custom spaces),
    * block-vs-image bounds — a block taller/wider than the (tile-aligned)
      image is >=50% masked-out work,
    * grid bounds — the launch must fit CUDA's grid limits,
    * shared memory — the kernel's per-block figure against the card's.
    """
    if g.bm % SUBLANES or g.bn % LANES:
        return f"align:block ({g.bm},{g.bn}) not a multiple of ({SUBLANES},{LANES})"
    x_pad = ceil(x / SUBLANES) * SUBLANES
    y_pad = ceil(y / LANES) * LANES
    if g.rows_step > x_pad or g.bn > y_pad:
        return (
            f"block:({g.rows_step},{g.bn}) exceeds padded image ({x_pad},{y_pad})"
        )
    grid_r, grid_c = launch_plan(g, x, y).grid
    if grid_r > MAX_GRID_Y or grid_c > MAX_GRID_X:
        return f"grid:({grid_r},{grid_c}) blocks > ({MAX_GRID_Y},{MAX_GRID_X})"
    if bench.smem_bytes > SMEM_LIMIT:
        return f"smem:{bench.smem_bytes} bytes > {SMEM_LIMIT}"
    return None


def _ceil_div(a, b):
    return -(-a // b)


def fit_mask(workload: CudaWorkload, columns: dict[str, np.ndarray]) -> np.ndarray:
    """:func:`validate_geometry`'s verdicts on a batch of configs: True where
    the reason would be None.  ``columns`` maps each parameter's name to an
    integer array of its value in every config; a parameter it lacks counts
    as 1, as in :func:`geometry_from_config`.  The rules are the ones above,
    in integer arithmetic: :func:`launch_plan`'s grid is ``w * ceil(ceil(extent
    / w) / block)`` on each axis (:func:`split_grid`).  A zero divisor in a
    config that reaches the grid rule raises, as the single-config form does.
    """
    n = len(next(iter(columns.values())))
    one = np.ones(n, dtype=np.int64)
    t_x, t_y, t_z, w_x, w_y = (np.asarray(columns.get(k, one), dtype=np.int64)
                               for k in ("t_x", "t_y", "t_z", "w_x", "w_y"))
    x, y = workload.x, workload.y
    bm, bn = 8 * t_x, 128 * t_y
    rows = bm * t_z
    ok = (bm % SUBLANES == 0) & (bn % LANES == 0)
    ok &= (rows <= _ceil_div(x, SUBLANES) * SUBLANES) & (bn <= _ceil_div(y, LANES) * LANES)
    if np.any(ok & ((rows == 0) | (bn == 0) | (w_x == 0) | (w_y == 0))):
        raise ZeroDivisionError("a config's block or split is 0")
    with np.errstate(divide="ignore"):  # the rows ruled out above
        grid_r = w_x * _ceil_div(_ceil_div(x, w_x), rows)
        grid_c = w_y * _ceil_div(_ceil_div(y, w_y), bn)
    ok &= (grid_r <= MAX_GRID_Y) & (grid_c <= MAX_GRID_X)
    return ok & (workload.bench.smem_bytes <= SMEM_LIMIT)


def validate_config(workload: CudaWorkload, cfg: Config) -> str | None:
    """Pre-screen one config against a workload; reason string or None."""
    return validate_geometry(
        workload.bench, geometry_from_config(cfg), workload.x, workload.y
    )


def fit_constraint(workload: CudaWorkload):
    """The pre-screen as a named SearchSpace constraint predicate."""

    def fn(cfg: Config) -> bool:
        return validate_config(workload, cfg) is None

    fn.constraint_id = (
        f"cuda_fit:{workload.name}:{workload.x}:{workload.y}"
        f":{SMEM_LIMIT}:{MAX_GRID_Y}"
    )
    fn.batch = partial(fit_mask, workload)
    return fn
