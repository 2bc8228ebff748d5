"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (the kernels build from
``src/repro_torch/kernels/csrc`` at first use) and skips elsewhere.  Run on
the GPU host with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import math

import pytest
import torch

from repro_torch import TuningSession, TuningSpec
from repro_torch.kernels import (
    LAUNCHES,
    add,
    add_ref,
    harris,
    harris_ref,
    mandelbrot,
    mandelbrot_ref,
)
from repro_torch.kernels.add.ops import vector_path

pytestmark = pytest.mark.cuda

CONFIGS = [
    {},
    dict(t_x=2, t_y=1, t_z=2, w_x=2, w_y=2, w_z=2),
    dict(t_x=1, t_y=2, t_z=3, w_x=3, w_y=1, w_z=1),
    dict(t_x=4, t_y=1, t_z=1, w_x=1, w_y=4, w_z=4),
    dict(t_x=3, t_y=3, t_z=5, w_x=7, w_y=5),
]
#: widths 129 and 1001 take no 16-byte vector, so add runs its scalar path there
SHAPES = [(64, 128), (56, 200), (1000, 1000), (2048, 4096), (37, 129), (1000, 1001)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cfg", CONFIGS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [False, True])
def test_cuda_add_is_exact(card, shape, cfg, dtype, offset):
    gen = torch.Generator(device=card).manual_seed(0)
    a = torch.randn(shape, generator=gen, device=card).to(dtype)
    b = torch.randn(shape, generator=gen, device=card).to(dtype)
    ref = add_ref(a, b)
    if offset:
        # contiguous, one element past an aligned allocation: the scalar path
        a = torch.empty(a.numel() + 1, dtype=dtype, device=card)[1:].view(shape).copy_(a)
        assert not vector_path(a, b, torch.empty_like(b))
    before = LAUNCHES["add"].n
    out = add(a, b, cfg)
    torch.cuda.synchronize()
    assert LAUNCHES["add"].n == before + 1
    assert torch.equal(out, ref)


#: (8, 130): one sub-tile high, with a ragged column
@pytest.mark.parametrize("shape", SHAPES + [(8, 130)])
@pytest.mark.parametrize("cfg", CONFIGS)
@pytest.mark.parametrize("offset", [False, True])
def test_cuda_harris_matches_plain(card, shape, cfg, offset):
    gen = torch.Generator(device=card).manual_seed(1)
    img = torch.randn(shape, generator=gen, device=card)
    ref = harris_ref(img)
    if offset:
        # contiguous, one element past an aligned allocation: 4-byte copies
        img = torch.empty(img.numel() + 1, device=card)[1:].view(shape).copy_(img)
    out = harris(img, cfg)
    assert ((out - ref).abs().max() / ref.abs().max()).item() < 1e-5


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cfg", CONFIGS)
def test_cuda_mandelbrot_matches_plain(card, shape, cfg):
    out = mandelbrot(*shape, cfg, device=card)
    ref = mandelbrot_ref(*shape, device=card)
    # the kernel rounds every operation as the plain version does: exact
    assert torch.equal(out, ref)


@pytest.mark.parametrize("max_iter", [1, 7, 12, 60, 100])
def test_cuda_mandelbrot_trip_counts_off_the_block_are_exact(card, max_iter):
    # a first block of 4 trips, blocks of 8, the trips left over one at a time
    out = mandelbrot(333, 517, {}, max_iter=max_iter, device=card)
    assert torch.equal(out, mandelbrot_ref(333, 517, max_iter, device=card))


def test_cuda_wrapper_raises_on_refused_launch(card):
    # 2^17 tile rows exceed gridDim.y's 65535: the launch is refused, and
    # the wrapper raises instead of returning unwritten memory
    a = torch.zeros((8 * 2**17, 128), device=card)
    with pytest.raises(RuntimeError, match="launch failed"):
        add(a, a, {})


def test_cuda_tune_runs_on_the_card(card):
    session = TuningSession(TuningSpec(
        kernel="harris", backend="cuda", searcher="rs", budget=6,
        backend_kwargs={"x": 1024, "y": 1024, "repeats": 2}, final_repeats=3,
    ))
    LAUNCHES["harris"].n = 0
    result = session.run()
    assert math.isfinite(result.final_value)
    assert LAUNCHES["harris"].n > 0
    prov = session.last_record.extra["backend_provenance"]
    assert prov["device"] == "cuda" and prov["capability"] == [9, 0]


@pytest.mark.parametrize("searcher", ["rf", "bo_gp", "bo_tpe", "sa", "pso", "grid"])
def test_cuda_tune_runs_each_searcher_on_the_card(card, searcher):
    budget = 20
    session = TuningSession(TuningSpec(
        kernel="harris", backend="cuda", searcher=searcher, budget=budget,
        backend_kwargs={"x": 1024, "y": 1024, "repeats": 2}, final_repeats=3,
    ))
    for c in LAUNCHES.values():
        c.n = 0
    result = session.run()
    torch.cuda.synchronize()
    assert result.n_samples == budget
    assert math.isfinite(result.final_value) and result.final_value > 0
    prov = session.last_record.extra["backend_provenance"]
    assert prov["device"] == "cuda"
    assert LAUNCHES["harris"].n == prov["launches"] > 0
    assert LAUNCHES["add"].n == LAUNCHES["mandelbrot"].n == 0
    if searcher == "rf":
        assert result.best_config in result.history_configs[-10:]
