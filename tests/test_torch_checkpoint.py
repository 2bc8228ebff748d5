"""The port's checkpointer, fault-tolerant runner and training launcher, on
reduced yi-34b on the CPU: round trips, checkpoints crossing between the
packages in both directions, GC, failure injection and resume (equal to the
uninterrupted run, atol 1e-7), the straggler watchdog on a ticking clock,
and ``python -m repro_torch.launch.train --device cpu`` trained and resumed.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as ref_restore
from repro.checkpoint import save as ref_save
from repro.configs import REGISTRY as REF_REGISTRY
from repro.models import build_model as ref_build
from repro.models import init_params as ref_init
from repro.train import init_train_state as ref_init_train_state
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore, save
from repro_torch.configs import REGISTRY
from repro_torch.core import clock
from repro_torch.data import DataConfig, make_train_batch
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, init_params
from repro_torch.runtime import InjectedFailure, RunnerConfig, TrainingRunner
from repro_torch.train import TrainSettings, init_train_state, make_train_step
from repro_torch.tree import tree_leaves, tree_map, tree_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def port_state(seed=0):
    model = build_model(REGISTRY["yi-34b"].reduced())
    params = init_params(model.spec(), torch.Generator().manual_seed(seed), CPU)
    return model, init_train_state(model, params)


def step_and_batches(model):
    step_fn = make_train_step(model, TrainSettings(remat="none"))
    dc = DataConfig(seed=0)
    return step_fn, lambda s: make_train_batch(dc, model.cfg, 16, 2, s, device=CPU)


def assert_same_tree(a, b) -> None:
    pa, pb = tree_paths(a), tree_paths(b)
    assert list(pa) == list(pb)
    for key in pa:
        assert pa[key].dtype == pb[key].dtype and torch.equal(pa[key], pb[key]), key


def test_save_restore_roundtrip(tmp_path):
    _, state = port_state()
    d = str(tmp_path / "ckpt")
    path = save(d, 7, state)
    assert latest_step(d) == 7 and os.path.basename(path) == "step_00000007"
    names = sorted(os.listdir(path))
    assert "manifest.json" in names and "params__layers__wq.npy" in names
    assert "opt__m__embed.npy" in names and "opt__step.npy" in names
    step_arr = np.load(os.path.join(path, "opt__step.npy"))
    assert step_arr.dtype == np.int32 and step_arr.shape == ()
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f) == {"step": 7, "leaves": sorted(tree_paths(state))}
    restored, step = restore(d, tree_map(torch.zeros_like, state))
    assert step == 7
    assert_same_tree(restored, state)
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "none"), state)


def reference_state():
    cfg = REF_REGISTRY["yi-34b"].reduced()
    model = ref_build(cfg)
    return model, ref_init_train_state(model, ref_init(model.spec(), jax.random.PRNGKey(0)))


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A checkpoint the reference wrote restores into the port leaf for leaf
    and gives the reference's forward (the bf16 per-position bound of
    ``tests/test_torch_models.py``)."""
    ref_model, ref_state = reference_state()
    d = str(tmp_path / "ref")
    ref_save(d, 3, ref_state)
    model, like = port_state(seed=1)
    state, step = restore(d, like)
    assert step == 3
    for key, value in tree_paths(jax.tree_util.tree_map(np.asarray, ref_state)).items():
        got = tree_paths(state)[key]
        assert got.dtype == tree_paths(like)[key].dtype and np.array_equal(got.numpy(), value)
    toks = np.random.default_rng(0).integers(0, model.cfg.vocab, (2, 16))
    ref, _ = ref_model.forward(ref_state["params"], jnp.asarray(toks, jnp.int32))
    got, _ = model.forward(state["params"], torch.from_numpy(toks))
    ref = np.asarray(ref, np.float32)
    err = np.abs(got.float().numpy() - ref).max(-1) / np.abs(ref).max()
    assert np.median(err) <= 5e-3 and err.max() <= 0.15, err


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    _, state = port_state(seed=2)
    d = str(tmp_path / "ours")
    save(d, 11, state)
    _, ref_like = reference_state()
    ref_state, step = ref_restore(d, ref_like)
    assert step == 11
    for key, value in tree_paths(jax.tree_util.tree_map(np.asarray, ref_state)).items():
        assert np.array_equal(tree_paths(state)[key].numpy(), value), key
    assert np.asarray(ref_state["opt"]["step"]).dtype == np.int32


def test_async_checkpointer_gc(tmp_path):
    _, state = port_state()
    d = str(tmp_path / "ckpt")
    ck = AsyncCheckpointer(d, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, state)
    ck.wait()
    assert sorted(int(p.split("_")[1]) for p in os.listdir(d)) == [3, 4]
    restored, _ = restore(d, state)
    assert_same_tree(restored, state)


def test_async_snapshot_does_not_alias_the_live_state(tmp_path):
    _, state = port_state()
    before = state["params"]["embed"].clone()
    ck = AsyncCheckpointer(str(tmp_path / "ckpt"))
    ck.save(1, state)
    state["params"]["embed"].add_(1.0)      # a step that wrote in place
    ck.wait()
    restored, _ = restore(str(tmp_path / "ckpt"), state)
    assert torch.equal(restored["params"]["embed"], before)


def test_runner_failure_injection_and_resume(tmp_path):
    model, state = port_state()
    step_fn, make_batch = step_and_batches(model)
    d = str(tmp_path / "ckpt")
    runner = TrainingRunner(RunnerConfig(ckpt_dir=d, ckpt_every=3, fail_at_step=7),
                            step_fn, make_batch)
    with pytest.raises(InjectedFailure):
        runner.run(state, n_steps=10)
    assert latest_step(d) == 6
    runner2 = TrainingRunner(RunnerConfig(ckpt_dir=d, ckpt_every=3), step_fn, make_batch)
    _, report = runner2.run(state, n_steps=10)
    assert report.restored_from == 6 and report.steps_run == 4
    assert latest_step(d) == 10


def test_runner_restart_reproduces_uninterrupted_run(tmp_path):
    """Crash + resume lands on the same weights as a run that never crashed."""
    model, state0 = port_state()
    step_fn, make_batch = step_and_batches(model)
    ref_state, _ = TrainingRunner(RunnerConfig(ckpt_dir=str(tmp_path / "a"), ckpt_every=2),
                                  step_fn, make_batch).run(state0, n_steps=6)
    d = str(tmp_path / "b")
    with pytest.raises(InjectedFailure):
        TrainingRunner(RunnerConfig(ckpt_dir=d, ckpt_every=2, fail_at_step=4),
                       step_fn, make_batch).run(state0, n_steps=6)
    resumed, report = TrainingRunner(RunnerConfig(ckpt_dir=d, ckpt_every=2),
                                     step_fn, make_batch).run(state0, n_steps=6)
    assert report.restored_from == 4
    for a, b in zip(tree_leaves(ref_state["params"]), tree_leaves(resumed["params"]),
                    strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
    assert int(resumed["opt"]["step"]) == 6


def test_straggler_watchdog_on_a_ticking_clock(tmp_path):
    """Each step takes 1 s of a fake clock, the ninth 10 s: one straggler."""
    model, state = port_state()
    inner, make_batch = step_and_batches(model)
    now = {"t": 0.0, "calls": 0}

    def step(st, batch):
        now["calls"] += 1
        now["t"] += 10.0 if now["calls"] == 9 else 1.0
        return inner(st, batch)

    events = []
    prev = clock.set_timer(lambda: now["t"])
    try:
        runner = TrainingRunner(RunnerConfig(ckpt_dir=str(tmp_path / "c"), ckpt_every=100),
                                step, make_batch)
        _, report = runner.run(state, n_steps=10, on_straggler=events.append)
    finally:
        clock.set_timer(prev)
    assert [ev.step for ev in report.stragglers] == [8] and events == report.stragglers
    assert report.stragglers[0].step_time == 10.0 and report.stragglers[0].median == 1.0


def run_cli(*argv):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *argv],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


def test_cli_trains_and_resumes_on_the_cpu(tmp_path):
    common = ["--arch", "yi-34b", "--reduced", "--batch", "2", "--seq", "16",
              "--device", "cpu", "--ckpt", str(tmp_path / "ckpt")]
    first = run_cli(*common, "--steps", "4")
    assert first.returncode == 0, first.stderr
    lines = [ln for ln in first.stdout.splitlines() if ln.startswith("[train]")]
    assert len(lines) == 3, first.stdout
    assert "arch=yi-34b reduced=True params=" in lines[0]
    assert "4 steps in" in lines[1] and "resumed_from=None" in lines[1]
    assert lines[2].startswith("[train] loss ")
    assert latest_step(str(tmp_path / "ckpt")) == 4
    again = run_cli(*common, "--steps", "6")
    assert again.returncode == 0, again.stderr
    assert "2 steps in" in again.stdout and "resumed_from=4" in again.stdout
    assert latest_step(str(tmp_path / "ckpt")) == 6


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b", "mamba2-130m",
                                  "zamba2-1.2b", "whisper-medium"])
def test_cli_trains_every_family_in_process(arch, tmp_path, capsys):
    """``--arch`` reaches each family (whisper through its enc-dec batch)."""
    launch_train.main(["--arch", arch, "--reduced", "--steps", "3", "--batch", "2", "--seq",
                       "16", "--device", "cpu", "--ckpt", str(tmp_path / "ckpt")])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[train]")]
    assert len(lines) == 3 and f"arch={arch} reduced=True" in lines[0], lines
    assert "3 steps in" in lines[1] and "resumed_from=None" in lines[1]
    first, last = map(float, lines[2].split("loss ")[1].split(" -> "))
    assert np.isfinite([first, last]).all()
    assert latest_step(str(tmp_path / "ckpt")) == 3


def test_cli_refuses_what_one_card_cannot_do(monkeypatch, tmp_path, capsys):
    # --model-parallel above the world is clamped to it, as the reference's
    # host mesh clamps it: one process trains on a (1, 1) mesh
    launch_train.main(["--arch", "yi-34b", "--reduced", "--model-parallel", "2", "--steps", "1",
                       "--batch", "2", "--seq", "16", "--device", "cpu",
                       "--ckpt", str(tmp_path / "ckpt")])
    assert "mesh=(1, 1)" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        launch_train.main(["--arch", "yi-34b", "--reduced"])
