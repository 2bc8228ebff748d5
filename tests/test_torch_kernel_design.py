"""The host-side choices of the add and mandelbrot kernels' designs, and the
premise the mandelbrot kernel rests on, checked without a card.

- add moves 16 bytes per access only where every row starts 16-byte aligned;
  the wrapper decides that on the host (``vector_path``).
- the launch arguments the wrappers pass come from ``launch_plan``, for the
  configs ``chip_smoke.py`` drives on the card.
- the mandelbrot kernel tests escape once per block of trips (a first block
  of 4, then blocks of 8) and replays a block for the pixels that escaped in
  it.  A torch model of that scheme on whole images must equal
  ``mandelbrot_ref`` on every pixel: it does only if escape is permanent over
  the view.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build, add, add_ref, mandelbrot_ref
from repro_torch.kernels.add.ops import launch_args as add_launch_args
from repro_torch.kernels.add.ops import vector_path
from repro_torch.kernels.common import geometry_from_config, launch_plan
from repro_torch.kernels.mandelbrot.ops import launch_args as mandelbrot_launch_args
from repro_torch.kernels.mandelbrot.ref import MAX_ITER, VIEW


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()


def _offset(t: torch.Tensor) -> torch.Tensor:
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape).copy_(t)


# (dtype, y, which array is offset by one element) -> vector path?
PATH_CASES = [
    (dtype, y, offset, offset is None and y % per_vector == 0)
    for dtype, per_vector in ((torch.float32, 4), (torch.bfloat16, 8))
    for y in (128, 132, 130)
    for offset in (None, "a", "b", "out")
]


@pytest.mark.parametrize("dtype, y, offset, expected", PATH_CASES)
def test_add_path_choice(dtype, y, offset, expected):
    gen = torch.Generator().manual_seed(0)
    arrays = {k: torch.randn((8, y), generator=gen).to(dtype) for k in ("a", "b", "out")}
    if offset is not None:
        arrays[offset] = _offset(arrays[offset])
        assert arrays[offset].is_contiguous()
    assert vector_path(arrays["a"], arrays["b"], arrays["out"]) is expected
    # on the CPU the wrapper computes the plain version whatever the path
    assert torch.equal(add(arrays["a"], arrays["b"]), add_ref(arrays["a"], arrays["b"]))


def _n_ints(name: str) -> int:
    argtypes, _ = _build.SIGNATURES[name]
    return len(argtypes)


@pytest.mark.parametrize("cfg", SMOKE.CONFIGS)
@pytest.mark.parametrize("shape", SMOKE.SHAPES)
def test_add_launch_args_come_from_the_plan(cfg, shape):
    x, y = shape
    plan = launch_plan(geometry_from_config(cfg), x, y)
    for vector in (True, False):
        args = add_launch_args(x, y, cfg, vector)
        assert args == (x, y, plan.bm, plan.tz, plan.cols, plan.nblk_r, plan.nblk_c,
                        *plan.grid, int(vector))
        # three pointers before, the device and the stream after
        assert len(args) + 5 == _n_ints("repro_add_f32") == _n_ints("repro_add_bf16")


@pytest.mark.parametrize("cfg", SMOKE.CONFIGS)
@pytest.mark.parametrize("shape", SMOKE.SHAPES)
def test_mandelbrot_launch_args_come_from_the_plan(cfg, shape):
    x, y = shape
    plan = launch_plan(geometry_from_config(cfg), x, y)
    args = mandelbrot_launch_args(x, y, cfg)
    assert args[:10] == (x, y, plan.bm, plan.tz, plan.cols, plan.nblk_r, plan.nblk_c,
                         *plan.grid, MAX_ITER)
    xmin, xmax, ymin, ymax = VIEW
    f32 = [torch.tensor(v, dtype=torch.float32).item()
           for v in (xmin, ymin, (xmax - xmin) / y, (ymax - ymin) / x)]
    assert list(args[10:]) == f32
    # the output pointer before, the device and the stream after
    assert len(args) + 3 == _n_ints("repro_mandelbrot_f32")


def _c(x: int, y: int):
    """c over the view, as mandelbrot_ref computes it."""
    xmin, xmax, ymin, ymax = VIEW
    f32 = torch.float32
    re = xmin + (torch.arange(y, dtype=f32) + 0.5) * ((xmax - xmin) / y)
    im = ymin + (torch.arange(x, dtype=f32) + 0.5) * ((ymax - ymin) / x)
    return re[None, :].expand(x, y), im[:, None].expand(x, y)


def _trip(zr, zi, cre, cim):
    return zr * zr - zi * zi + cre, 2.0 * zr * zi + cim


def blocked_escape_counts(x: int, y: int, max_iter: int, first: int, k: int) -> torch.Tensor:
    """The kernel's scheme on whole images: blocks of trips (the first of
    ``first`` trips, the rest of ``k``) with no test inside, one test
    !(|z|^2 < 4) after each, and a replay of the block from its saved state,
    one trip at a time, for the pixels that failed it; then the trips left
    over one at a time."""
    cre, cim = _c(x, y)
    zr = torch.zeros((x, y))
    zi = torch.zeros((x, y))
    count = torch.zeros((x, y), dtype=torch.int32)
    done = torch.zeros((x, y), dtype=torch.bool)
    blocks = [first] if first <= max_iter else []
    blocks += [k] * ((max_iter - sum(blocks)) // k)
    for size in blocks:
        sr, si = zr, zi
        for _ in range(size):
            zr, zi = _trip(zr, zi, cre, cim)
        escaped = ~done & ~(zr * zr + zi * zi < 4.0)
        count += (~done & ~escaped).int() * size
        live, rr, ri = escaped.clone(), sr, si
        for _ in range(size):
            live &= rr * rr + ri * ri < 4.0
            count += live.int()
            nr, ni = _trip(rr, ri, cre, cim)
            rr, ri = torch.where(live, nr, rr), torch.where(live, ni, ri)
        done |= escaped
    for _ in range(max_iter - sum(blocks)):
        alive = ~done & (zr * zr + zi * zi < 4.0)
        count += alive.int()
        nr, ni = _trip(zr, zi, cre, cim)
        zr, zi = torch.where(alive, nr, zr), torch.where(alive, ni, zi)
        done |= ~alive
    return count.float()


@pytest.mark.parametrize("x, y, max_iter, first, k", [
    (1024, 1024, MAX_ITER, 4, 8),   # the kernel's schedule: 4, 8 x 7, 4 single trips
    (64, 2048, MAX_ITER, 4, 8),
    (1024, 1024, MAX_ITER, 8, 8),
    (333, 517, MAX_ITER, 7, 7),     # K does not divide max_iter
    (1000, 1001, 60, 4, 8),         # no single trips left over
    (200, 300, 3, 4, 8),            # too few trips for a block
])
def test_blocked_escape_model_equals_the_plain_version(x, y, max_iter, first, k):
    assert torch.equal(blocked_escape_counts(x, y, max_iter, first, k),
                       mandelbrot_ref(x, y, max_iter))


@pytest.mark.parametrize("shape", [(1024, 1024), (1000, 1001)])
def test_escape_is_permanent_over_the_view(shape):
    # run every orbit unfrozen for MAX_ITER trips: no pixel that has tested
    # |z|^2 >= 4 (or inf/NaN) tests below 4 at a later trip
    cre, cim = _c(*shape)
    zr = torch.zeros(shape)
    zi = torch.zeros(shape)
    out = torch.zeros(shape, dtype=torch.bool)
    for _ in range(MAX_ITER + 1):
        inside = zr * zr + zi * zi < 4.0
        assert not (out & inside).any()
        out |= ~inside
        zr, zi = _trip(zr, zi, cre, cim)
    assert out.any() and not out.all()
