"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (the kernels build from
``src/repro_torch/kernels/csrc`` at first use) and skips elsewhere.  Run on
the GPU host with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import math
import os

import pytest
import torch

#: cuBLAS takes its workspace setting when CUDA starts, so deterministic
#: crash-resume needs it in the environment before any test touches the card
CUBLAS_SET_BEFORE_CUDA = (not torch.cuda.is_initialized()
                          or "CUBLAS_WORKSPACE_CONFIG" in os.environ)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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


@pytest.mark.parametrize("kernel", ["add", "harris"])
def test_cuda_kernels_leave_their_cached_inputs_unchanged(card, kernel):
    """After launches over several configs, the staged device tensors and
    the process's cached host arrays still hold the drawn bytes, and a
    second staging (a cache hit) copies the same bytes to the card."""
    import numpy as np

    from repro_torch.cuda_bench import workloads

    w = workloads.make_workload(kernel, 1000, 1001, input_seed=5)
    plain = w.arrays()
    workloads.clear_input_cache()
    inputs = w.materialize(card)
    for cfg in CONFIGS:
        w.run(inputs, cfg, card)
    torch.cuda.synchronize(card)
    timings: dict = {}
    again = w.materialize(card, timings)
    assert timings["cache_hit"] == 1
    cached = workloads.cached_inputs(w)
    for t, u, c, a in zip(inputs, again, cached, plain, strict=True):
        assert t.is_cuda and t.data_ptr() != u.data_ptr()
        assert t.cpu().numpy().tobytes() == a.tobytes()
        assert u.cpu().numpy().tobytes() == a.tobytes()
        assert not c.flags.writeable and np.asarray(c).tobytes() == a.tobytes()
    workloads.clear_input_cache()


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


def test_cuda_matrix_replays_warm_on_the_device_executor(card, tmp_path):
    """A small harris matrix at 1000x1001: the cold serial run launches the
    kernel; the warm replay on the device executor (two workers asked for,
    so its threads run even on a one-card host) launches nothing, gives the
    same cells and leaves the store's values byte-identical."""
    import json
    import shutil
    import warnings

    from repro_torch import ExperimentDesign, tune_matrix
    from repro_torch.core import MeasurementStore

    cold_path, warm_path = str(tmp_path / "cold.json"), str(tmp_path / "warm.json")
    spec = TuningSpec(
        kernel="harris", backend="cuda", algorithms=("rs", "rf", "ga"),
        backend_kwargs={"x": 1000, "y": 1001, "repeats": 2},
        design=ExperimentDesign(sample_sizes=(12,), n_experiments=(2,), final_repeats=3),
        dataset_size=40, dataset_cache=str(tmp_path / "dataset.npz"),
        store="json", store_path=cold_path,
    )
    LAUNCHES["harris"].n = 0
    cold = tune_matrix(spec)
    torch.cuda.synchronize()
    assert LAUNCHES["harris"].n > 0
    shutil.copy(cold_path, warm_path)
    LAUNCHES["harris"].n = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # one card: two workers capped
        warm = tune_matrix(spec.replace(store_path=warm_path), executor="device",
                           max_workers=max(2, torch.cuda.device_count()))
    assert LAUNCHES["harris"].n == 0
    for key, cell in cold.cells.items():
        assert (cell.n_samples_used == 12).all()
        assert torch.isfinite(torch.from_numpy(cell.final_values)).all()
        for name in ("final_values", "search_best_values", "n_samples_used"):
            assert (getattr(cell, name) == getattr(warm.cells[key], name)).all()

    def values(path):
        return json.dumps(sorted(MeasurementStore(path).items()), sort_keys=True)

    assert values(warm_path) == values(cold_path)
    assert not [f for f in tmp_path.iterdir() if ".shard" in f.name]


def test_cuda_matrix_copies_its_image_to_the_card_once(card, tmp_path, monkeypatch):
    """One harris matrix call at 1000x1001 on the card: the profiler's trace
    holds one host-to-device copy of the image's bytes, the dataset's first
    staging makes it and every other staging reuses it (the counter counts
    the traced ones), the shared tensor still holds the host array's bytes
    after the call, and the scope holds nothing afterwards."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import ExperimentDesign
    from repro_torch.cuda_bench import workloads
    from repro_torch.telemetry import Telemetry, read_events

    seen: list[tuple] = []
    plain = workloads.CudaWorkload.materialize

    def recorded(self, device, timings=None):
        timings = {} if timings is None else timings
        out = plain(self, device, timings)
        seen.append((out, timings))
        return out

    monkeypatch.setattr(workloads.CudaWorkload, "materialize", recorded)
    spec = TuningSpec(
        kernel="harris", backend="cuda", algorithms=("rs", "rf", "ga"),
        backend_kwargs={"x": 1000, "y": 1001, "repeats": 2},
        design=ExperimentDesign(sample_sizes=(12,), n_experiments=(2,), final_repeats=3),
        dataset_size=40,
    )
    image = workloads.make_workload("harris", 1000, 1001).arrays()[0]
    tel = Telemetry(str(tmp_path / "t.jsonl"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        TuningSession(spec, telemetry=tel).run_matrix()
        torch.cuda.synchronize()
    tel.close()
    prof.export_chrome_trace(str(tmp_path / "prof.json"))
    with open(tmp_path / "prof.json") as f:
        events = json.load(f)["traceEvents"]
    h2d = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    assert [e["args"].get("bytes") for e in h2d].count(image.nbytes) == 1, h2d
    # the dataset's measurement, each experiment's, and rf's predictions'
    assert [t["device_reuse"] for _, t in seen] == [0] + [1] * 8
    totals = [e for e in read_events(str(tmp_path / "t.jsonl")) if e["ev"] == "totals"]
    assert totals[-1]["counters"]["inputs.device_reuses"] == 8
    (shared,) = seen[0][0]
    assert shared.is_cuda and all(out[0] is shared for out, _ in seen)
    assert shared.cpu().numpy().tobytes() == image.tobytes()
    assert workloads._DEVICE_INPUTS._entries == {}


def test_cuda_fleet_fills_a_miss_on_the_card(card, tmp_path):
    """Serving on the card at a small size: a query for a geometry no one
    tuned misses and queues a cuda job; a fleet worker tunes it on the card
    (mandelbrot launches), the collector indexes the winner under the card's
    name, and the query hits; the winner's config through the CUDA kernel
    equals the plain version exactly."""
    from repro_torch import ExperimentDesign
    from repro_torch.core import make_store
    from repro_torch.serving import FleetWorker, JobQueue, best_config, collect_jobs

    name = torch.cuda.get_device_name(card)
    path, qdir = str(tmp_path / "serve.sqlite"), str(tmp_path / "queue")
    store = make_store("sqlite", path)
    spec = TuningSpec(kernel="mandelbrot", backend="cuda", algorithms=("rs", "ga"),
                      backend_kwargs={"x": 1000, "y": 1001, "repeats": 2},
                      design=ExperimentDesign(sample_sizes=(12,), n_experiments=(2,),
                                              final_repeats=3))
    miss = best_config(store, "mandelbrot", 1000, 1001, name,
                       queue=JobQueue(store, "sqlite", path, qdir), enqueue_spec=spec)
    store.close()
    assert miss.status == "miss" and miss.job_id
    LAUNCHES["mandelbrot"].n = 0
    assert FleetWorker("sqlite", path, qdir, ident="card0").drain(max_jobs=1) == 1
    torch.cuda.synchronize()
    assert LAUNCHES["mandelbrot"].n > 0
    assert collect_jobs("sqlite", path, qdir) == [miss.job_id]
    store = make_store("sqlite", path)
    hit = best_config(store, "mandelbrot", 1000, 1001, name)
    store.close()
    assert hit.status == "hit" and hit.matched_key == f"mandelbrot|x=1000|y=1001|{name}"
    assert torch.equal(mandelbrot(1000, 1001, hit.config, device=card),
                       mandelbrot_ref(1000, 1001, device=card))


# ---------------------------------------------------------------- the model stack
#: the card against the port on the CPU, which run the same torch code and
#: round bf16 alike: about twice what an H100 read (``chip_smoke.py`` phase
#: 4g a), far under the CPU tests' bounds against JAX (0.15, 0.35)
LOGITS_MEDIAN, LOGITS_MAX, GRAD_REL = 1e-3, 2e-2, 0.05


def logits_err(got, ref):
    err = (got.float().cpu() - ref.float()).abs().amax(-1).flatten() / ref.float().abs().max()
    return err.median().item(), err.max().item()


def test_cuda_model_matches_the_cpu(card):
    """Reduced yi-34b on the card against the port on the CPU, from the same
    weights and batch: forward logits, one step's loss and gradients, and
    eight decode steps."""
    from repro_torch.configs import REGISTRY
    from repro_torch.data import DataConfig, make_train_batch
    from repro_torch.models import build_model, init_params
    from repro_torch.train import TrainSettings, make_loss_fn
    from repro_torch.tree import tree_from_paths, tree_map, tree_paths

    model = build_model(REGISTRY["yi-34b"].reduced())
    on_cpu = init_params(model.spec(), torch.Generator().manual_seed(0), "cpu")
    on_card = tree_map(lambda t: t.to(card), on_cpu)
    batch_cpu = make_train_batch(DataConfig(seed=0), model.cfg, 64, 2, 0, device="cpu")
    batch = tree_map(lambda t: t.to(card), batch_cpu)
    with torch.no_grad():
        median, worst = logits_err(model.forward(on_card, batch["tokens"])[0],
                                   model.forward(on_cpu, batch_cpu["tokens"])[0])
    assert median <= LOGITS_MEDIAN and worst <= LOGITS_MAX

    def loss_and_grads(params, b):
        flat = {k: p.detach().requires_grad_(True) for k, p in tree_paths(params).items()}
        total, (loss, _) = make_loss_fn(model, TrainSettings(remat="none"))(
            tree_from_paths(flat), b)
        return float(loss), dict(zip(flat, torch.autograd.grad(total, list(flat.values())),
                                     strict=True))

    ref_loss, ref_g = loss_and_grads(on_cpu, batch_cpu)
    loss, g = loss_and_grads(on_card, batch)
    assert loss == pytest.approx(ref_loss, rel=1e-3)
    for key, ref in ref_g.items():
        assert g[key].device.type == "cuda"
        assert ((g[key].cpu() - ref).norm() / ref.norm()).item() <= GRAD_REL, key

    errs = []
    with torch.no_grad():
        c_cpu = model.init_cache(2, 16, device="cpu")
        c_card = model.init_cache(2, 16, device=card)
        for t in range(8):
            tok = batch_cpu["tokens"][:, t:t + 1]
            ref, c_cpu = model.decode_step(on_cpu, c_cpu, torch.full((2,), t), tok)
            got, c_card = model.decode_step(on_card, c_card, torch.full((2,), t, device=card),
                                            tok.to(card))
            errs.append((got.float().cpu() - ref.float()).abs().amax(-1).flatten()
                        / ref.float().abs().max())
    errs = torch.cat(errs)
    assert errs.median().item() <= LOGITS_MEDIAN and errs.max().item() <= LOGITS_MAX


def test_cuda_crash_resume_is_deterministic(card, tmp_path):
    """An injected failure at step 7, resumed from the step-5 checkpoint to
    step 12, lands on the weights of an uninterrupted run (atol 1e-7) under
    deterministic algorithms."""
    from repro_torch.configs import REGISTRY
    from repro_torch.data import DataConfig, make_train_batch
    from repro_torch.models import build_model, init_params
    from repro_torch.runtime import InjectedFailure, RunnerConfig, TrainingRunner
    from repro_torch.train import TrainSettings, init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    if not CUBLAS_SET_BEFORE_CUDA:
        pytest.skip("CUDA started before CUBLAS_WORKSPACE_CONFIG was set")
    model = build_model(REGISTRY["yi-34b"].reduced())
    step_fn = make_train_step(model, TrainSettings(remat="none"))
    make_batch = lambda s: make_train_batch(DataConfig(seed=0), model.cfg, 64, 2, s, device=card)
    torch.use_deterministic_algorithms(True)
    try:
        state0 = init_train_state(model, init_params(
            model.spec(), torch.Generator(device=card).manual_seed(0), card))
        ref, _ = TrainingRunner(RunnerConfig(ckpt_dir=str(tmp_path / "a"), ckpt_every=5),
                                step_fn, make_batch).run(state0, 12)
        with pytest.raises(InjectedFailure):
            TrainingRunner(RunnerConfig(ckpt_dir=str(tmp_path / "b"), ckpt_every=5,
                                        fail_at_step=7), step_fn, make_batch).run(state0, 12)
        resumed, report = TrainingRunner(RunnerConfig(ckpt_dir=str(tmp_path / "b"),
                                                      ckpt_every=5),
                                         step_fn, make_batch).run(state0, 12)
    finally:
        torch.use_deterministic_algorithms(False)
    assert report.restored_from == 5 and report.steps_run == 7
    for a, b in zip(tree_leaves(ref["params"]), tree_leaves(resumed["params"]), strict=True):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


#: the model families on the card against the port on the CPU, at
#: ``chip_smoke.py`` phase 4h's bounds: the MoE configs and whisper in fp32
#: (logits max|d|/max|ref|, gradients per leaf), mamba2 and zamba2 in bf16
#: (per position median and max, gradients per leaf)
FAMILY_BOUNDS = {
    "olmoe-1b-7b": {"logits": 5e-4, "grad": 1e-3},
    "deepseek-v2-236b": {"logits": 5e-4, "grad": 1e-3},
    "whisper-medium": {"logits": 1e-2, "grad": 0.06},
    "mamba2-130m": {"median": 6e-3, "max": 1.5e-2, "grad": 1.5e-2},
    "zamba2-1.2b": {"median": 1e-3, "max": 1e-2, "grad": 1.2e-2},
}


@pytest.fixture
def fp32_models(monkeypatch):
    """Every model module of the port computes in fp32 (TF32 off)."""
    from repro_torch.models import decoder, encdec, hybrid, layers, ssm

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for mod in (layers, decoder, ssm, hybrid, encdec):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)


@pytest.mark.parametrize("name", list(FAMILY_BOUNDS))
def test_cuda_family_matches_the_cpu(card, name, request):
    """A reduced config on the card against the port on the CPU, from the
    same weights and batch: forward logits, eight decode steps, and each
    leaf's gradient."""
    from repro_torch.configs import REGISTRY
    from repro_torch.data import DataConfig, make_train_batch
    from repro_torch.models import build_model, init_params
    from repro_torch.train import TrainSettings, make_loss_fn
    from repro_torch.tree import tree_from_paths, tree_map, tree_paths

    bounds = FAMILY_BOUNDS[name]
    if "logits" in bounds:
        request.getfixturevalue("fp32_models")
    model = build_model(REGISTRY[name].reduced())
    on_cpu = init_params(model.spec(), torch.Generator().manual_seed(0), "cpu")
    on_card = tree_map(lambda t: t.to(card), on_cpu)
    batch_cpu = make_train_batch(DataConfig(seed=0), model.cfg, 64, 2, 0, device="cpu")
    batch = tree_map(lambda t: t.to(card), batch_cpu)

    def logits(params, b, device):
        """Forward logits and eight decode steps' logits."""
        bsz = next(iter(b.values())).shape[0]
        if "src_embeds" in b:
            full = model.forward(params, b)[0]
            cache = model.init_cache(params, model.encode(params, b["src_embeds"]), bsz)
            toks = b["dec_tokens"]
        else:
            full = model.forward(params, b["tokens"])[0]
            cache, toks = model.init_cache(bsz, 16, device=device), b["tokens"]
        steps = []
        for t in range(8):
            out, cache = model.decode_step(params, cache, torch.full((bsz,), t, device=device),
                                           toks[:, t:t + 1])
            steps.append(out)
        return full.float().cpu(), torch.cat(steps, 1).float().cpu()

    with torch.no_grad():
        for got, ref in zip(logits(on_card, batch, card), logits(on_cpu, batch_cpu, "cpu"),
                            strict=True):
            if "logits" in bounds:
                assert (got - ref).abs().max() / ref.abs().max() <= bounds["logits"]
            else:
                err = (got - ref).abs().amax(-1).flatten() / ref.abs().max()
                assert err.median() <= bounds["median"] and err.max() <= bounds["max"]

    def grads(params, b):
        flat = {k: p.detach().requires_grad_(True) for k, p in tree_paths(params).items()}
        total, _ = make_loss_fn(model, TrainSettings(remat="none"))(tree_from_paths(flat), b)
        return dict(zip(flat, torch.autograd.grad(total, list(flat.values()),
                                                  materialize_grads=True), strict=True))

    g_cpu, g_card = grads(on_cpu, batch_cpu), grads(on_card, batch)
    for key, ref in g_cpu.items():
        assert g_card[key].device.type == "cuda"
        if not ref.any():       # reduced zamba2's shared block runs nowhere
            assert not g_card[key].any(), key
            continue
        assert ((g_card[key].cpu() - ref).norm() / ref.norm()).item() <= bounds["grad"], key


def test_cuda_moe_train_step_is_deterministic(card):
    """Reduced olmoe's train step twice from the same state under
    deterministic algorithms: every weight equal bit for bit (the dispatch's
    sort, scatters, gathers and ``index_add`` included)."""
    from repro_torch.configs import REGISTRY
    from repro_torch.data import DataConfig, make_train_batch
    from repro_torch.models import build_model, init_params
    from repro_torch.train import TrainSettings, init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    if not CUBLAS_SET_BEFORE_CUDA:
        pytest.skip("CUDA started before CUBLAS_WORKSPACE_CONFIG was set")
    model = build_model(REGISTRY["olmoe-1b-7b"].reduced())
    batch = make_train_batch(DataConfig(seed=0), model.cfg, 64, 2, 0, device=card)
    step = make_train_step(model, TrainSettings(remat="none"))
    torch.use_deterministic_algorithms(True)
    try:
        params = init_params(model.spec(), torch.Generator(device=card).manual_seed(0), card)
        runs = [step(init_train_state(model, params), batch) for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(False)
    (a, ma), (b, mb) = runs
    assert float(ma["aux"]) > 0 and float(ma["loss"]) == float(mb["loss"])
    for x, y in zip(tree_leaves(a["params"]), tree_leaves(b["params"]), strict=True):
        assert torch.equal(x, y)


def test_cuda_driver_rows_run_on_the_card(card, capsys):
    """``benchmarks.run``'s card rows: each kernel and its plain version in
    CUDA-event time, then a GA tune of add on the ``cuda`` backend; every
    kernel launches and every number is finite."""
    from repro_torch.benchmarks import run

    for c in LAUNCHES.values():
        c.n = 0
    run.table_kernels(1024, 2048)
    run.table_cuda_backend(budget=4)
    rows = [line.split(",", 2) for line in capsys.readouterr().out.strip().splitlines()]
    assert [r[0] for r in rows] == ["kernel_cuda/add", "kernel_cuda/harris",
                                    "kernel_cuda/mandelbrot", "cuda_backend/add"]
    assert all(math.isfinite(float(r[1])) and float(r[1]) > 0 for r in rows)
    assert all(math.isfinite(float(r[2].split()[0].split("=")[1])) for r in rows[:3])
    assert torch.cuda.get_device_name(card) in rows[3][2]
    assert all(c.n > 0 for c in LAUNCHES.values())


def test_cuda_paper_matrix_combo_on_the_card(card, tmp_path):
    """A ``cuda`` combo of the paper driver on the card: the record names the
    card, every cell's best final is finite and the kernel launched."""
    from repro_torch import ExperimentDesign, RunRecord
    from repro_torch.benchmarks import paper_matrix

    LAUNCHES["mandelbrot"].n = 0
    paper_matrix.run_combo("mandelbrot", "cuda",
                           ExperimentDesign(sample_sizes=(5,), n_experiments=(2,),
                                            final_repeats=2),
                           str(tmp_path), algorithms=("rs", "ga"), verbose=False,
                           backend_kwargs={"x": 512, "y": 1024})
    rec = RunRecord.load(str(tmp_path / "mandelbrot_cuda.json"))
    assert rec.extra["backend_provenance"]["device_kind"] == torch.cuda.get_device_name(card)
    assert all(math.isfinite(c["best_final"]) for c in rec.result["cells"])
    assert LAUNCHES["mandelbrot"].n > 0


def test_a_finished_measurement_frees_its_inputs_on_the_card(card):
    """With the cyclic collector off, the card's memory returns to where it
    was as soon as the last name for a measurement that warmed geometries
    goes: nothing of it is kept alive by a reference cycle."""
    import gc

    from repro_torch.cuda_bench import CudaMeasurement, make_workload

    cfgs = [dict(t_x=tx, t_y=1, t_z=tz, w_x=2, w_y=2, w_z=1)
            for tx in (1, 2, 4) for tz in (1, 2)]
    gc.collect()
    gc.disable()
    try:
        torch.cuda.synchronize(card)
        before = torch.cuda.memory_allocated(card)
        m = CudaMeasurement(make_workload("harris", x=1024, y=2048), repeats=2, device=card)
        assert (m.measure_batch(cfgs) < float("inf")).any()
        assert torch.cuda.memory_allocated(card) > before
        del m
        torch.cuda.synchronize(card)
        assert torch.cuda.memory_allocated(card) == before
    finally:
        gc.enable()
