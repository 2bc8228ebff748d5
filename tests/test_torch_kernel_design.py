"""The host-side choices of the kernels' designs, and the premises the
mandelbrot and harris kernels rest on, checked without a card.

- add moves 16 bytes per access only where every row starts 16-byte aligned;
  the wrapper decides that on the host (``vector_path``).
- the launch arguments the wrappers pass come from ``launch_plan``, for the
  configs ``chip_smoke.py`` drives on the card.
- the mandelbrot kernel tests escape once per block of trips (a first block
  of 4, then blocks of 8) and replays a block for the pixels that escaped in
  it.  A torch model of that scheme on whole images must equal
  ``mandelbrot_ref`` on every pixel: it does only if escape is permanent over
  the view.
- the harris kernel computes R with separable passes over rolling row
  windows, strip by strip within each launch-plan tile and its halo.  A
  torch model of that arithmetic, tile by tile and stitched, must be the
  same function as ``harris_ref`` and the reference's oracle.
- ``chip_smoke.py`` reads the compiler's reports (``-Xptxas -v`` and
  ``cuobjdump -sass``) to hold the harris kernel to no spills.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import harris_ref as jax_harris_ref
from repro_torch.kernels import _build, add, add_ref, harris_ref, mandelbrot_ref
from repro_torch.kernels.add.ops import launch_args as add_launch_args
from repro_torch.kernels.add.ops import vector_path
from repro_torch.kernels.common import geometry_from_config, launch_plan
from repro_torch.kernels.harris.ops import launch_args as harris_launch_args
from repro_torch.kernels.harris.ref import HARRIS_K
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


@pytest.mark.parametrize("cfg", SMOKE.CONFIGS)
@pytest.mark.parametrize("shape", SMOKE.SHAPES)
def test_harris_launch_args_come_from_the_plan(cfg, shape):
    x, y = shape
    plan = launch_plan(geometry_from_config(cfg), x, y)
    args = harris_launch_args(x, y, cfg)
    assert args == (x, y, plan.rows, plan.cols, plan.nblk_r, plan.nblk_c, *plan.grid)
    # two pointers before; k, the device and the stream after
    assert len(args) + 5 == _n_ints("repro_harris_f32")


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


STRIP = 128     # output columns a block walks at a time (64 threads x 2)
GROUP = 4       # input rows staged together
PAD = 4         # staged columns each side of a strip


def harris_tiled_model(img: torch.Tensor, config: dict, k: float = HARRIS_K) -> torch.Tensor:
    """The harris kernel's arithmetic in f32, in its order: for each clamped
    tile origin of ``launch_plan`` (duplicates included), each 128-column
    strip walks the tile's rows plus a 2-row halo in groups of 4 staged rows
    (zero outside the image), carrying the last two rows of d and s and of
    the products' row sums; each thread's two columns share the middle pair
    of their across-sums.  Outputs outside the tile are computed and
    dropped, as the kernel masks them.  (The kernel fuses 2*a + b into one
    FMA, which rounds as the model does since 2*a is exact; it may contract
    the products in det and tr^2, which the model rounds twice.)"""
    x, y = img.shape
    plan = launch_plan(geometry_from_config(config), x, y)
    # staged element (row r, column c) of the image is ext[r + 2, c + PAD]
    ext = F.pad(img, (PAD, STRIP + 2 * PAD, 2, 2 * GROUP))
    out = torch.full_like(img, float("nan"))

    def across(q):   # q: a staged row, columns cs-4 .. cs+131
        d = q[4:134] - q[2:132]                 # columns cs-1 .. cs+128
        s = (q[2:132] + q[4:134]) + 2.0 * q[3:133]
        return d, s

    def box_across(a):   # a at columns cs-1 .. cs+128 -> sums at cs .. cs+127
        u = a[1:129:2] + a[2:130:2]             # the middle pair of a thread
        return torch.stack([a[0:128:2] + u, u + a[3:130:2]], dim=1).reshape(STRIP)

    def gradient(d0, d1, s0, dn, sn):
        gx = (d0 + dn) + 2.0 * d1
        gy = sn - s0
        return box_across(gx * gx), box_across(gy * gy), box_across(gx * gy)

    for r0, c0 in plan.origins():
        r_end, c_end = min(r0 + plan.rows, x), min(c0 + plan.cols, y)
        n_groups = (r_end - r0 + 4 + GROUP - 1) // GROUP
        for cs in range(c0, c_end, STRIP):
            rows = [ext[r0 + i, cs:cs + STRIP + 2 * PAD] for i in range(GROUP * n_groups)]
            (d0, s0), (d1, s1) = across(rows[0]), across(rows[1])
            h = []
            for i, q in enumerate(rows[2:], start=2):
                dn, sn = across(q)
                hn = gradient(d0, d1, s0, dn, sn)
                d0, d1, s0, s1 = d1, dn, s1, sn
                if i >= 4:
                    row = r0 + i - 4
                    sxx, syy, sxy = ((a + b) + c for a, b, c in zip(*h, hn, strict=True))
                    det = sxx * syy - sxy * sxy
                    tr = sxx + syy
                    resp = det - k * tr * tr
                    if row < r_end:
                        out[row, cs:min(cs + STRIP, c_end)] = resp[:min(STRIP, c_end - cs)]
                    h = [h[1], hn]
                else:
                    h.append(hn)
    return out


@pytest.mark.parametrize("cfg", SMOKE.CONFIGS)
@pytest.mark.parametrize("shape", [(64, 128), (37, 129), (56, 200), (8, 130)])
def test_harris_tiled_model_is_the_reference_function(cfg, shape):
    rng = np.random.default_rng(5)
    img = rng.standard_normal(shape).astype(np.float32)
    model = harris_tiled_model(torch.from_numpy(img), cfg)
    assert not model.isnan().any()      # the tiles cover every pixel
    for ref in (harris_ref(torch.from_numpy(img)),
                torch.from_numpy(np.array(jax_harris_ref(jnp.asarray(img))))):
        assert ((model - ref).abs().max() / ref.abs().max()).item() < 1e-5


PTXAS_LOG = """== harris.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z13harris_kernelPKfPfiiiiiif' for 'sm_90a'
ptxas info    : Function properties for _Z13harris_kernelPKfPfiiiiiif
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers, 8704 bytes smem, 408 bytes cmem[0]
"""

SASS = """
\tFunction : _Z13harris_kernelPKfPfiiiiiif
        /*0000*/                   LDC R1, c[0x0][0x28] ;            /* 0x00000a00ff017b82 */
                                                                     /* 0x000fe20000000800 */
        /*0010*/              @!P0 LDGSTS.E.BYPASS.LTC128B.128 [R3], desc[UR4][R4.64] ;
        /*0018*/              @!PT LDS RZ, [RZ] ;
        /*0020*/                   LDS.64 R6, [R2+0x8] ;
        /*0030*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0040*/               @P1 STG.E.64 desc[UR4][R8.64], R6 ;
        /*0050*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;
"""


def test_chip_smoke_reads_the_compiler_reports():
    report = SMOKE.ptxas_report(PTXAS_LOG)["_Z13harris_kernelPKfPfiiiiiif"]
    assert report == dict(stack=0, spill_stores=8, spill_loads=4, registers=56, smem=8704)
    ops = SMOKE.sass_opcodes(SASS)["_Z13harris_kernelPKfPfiiiiiif"]
    assert sum(ops.values()) == 6
    counts = {op: SMOKE.count_ops(ops, op) for op in ("LDGSTS", "LDG", "LDS", "STS", "BAR")}
    # LDGSTS is neither an LDG nor an STS; an LDS on !PT never runs
    assert counts == dict(LDGSTS=1, LDG=1, LDS=1, STS=0, BAR=1)
    assert SMOKE.count_ops(ops, "LDG.E.128") == 1
