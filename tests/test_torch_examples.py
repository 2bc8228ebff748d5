"""The port's examples against the reference's, on the CPU.

* ``repro_torch.examples.quickstart`` with 2 seeds an algorithm prints the
  reference example's lines (the space, the true optimum, the ask/tell
  demo, each algorithm's median and its MWU/CLES against RS) up to the
  real-measurement part, which runs the ``cuda`` backend on the CPU's plain
  versions (``--device cpu``) where the reference runs ``pallas``;
* ``repro_torch.examples.tune_kernel`` with ``device="cpu"`` finds the
  winner the reference's ``tune_kernel_interpret`` finds, after as many
  samples, with both packages' clocks ticking one second a reading;
* ``repro_torch.examples.train_lm``'s small Mamba-2 config is the
  reference's, and trained from the reference's initial parameters (carried
  across with ``params_from_numpy``) it gives the reference's losses over 3
  steps within rel 1e-2, the bound ``tests/test_torch_train.py`` holds a
  bf16 mamba2 train step's loss to; a second run resumes from the
  checkpoint.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import itertools
import os

import jax
import numpy as np
import pytest

import repro
from repro.core import clock as ref_clock
from repro.data import DataConfig as RefDataConfig
from repro.data import make_train_batch as ref_train_batch
from repro.models import build_model as ref_build
from repro.models import init_params as ref_init
from repro.optim import AdamWConfig as RefAdamW
from repro.runtime import RunnerConfig as RefRunnerConfig
from repro.runtime import TrainingRunner as RefRunner
from repro.train import TrainSettings as RefSettings
from repro.train import init_train_state as ref_init_state
from repro.train import make_train_step as ref_train_step
from repro_torch.core import clock as port_clock
from repro_torch.examples import quickstart, train_lm, tune_kernel
from repro_torch.interop import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_example(name: str):
    path = os.path.join(REPO, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"ref_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _RealTail(Exception):
    """Raised where the reference's quickstart reaches its pallas part."""


def test_quickstart_prints_the_reference_lines(monkeypatch):
    ref = load_example("quickstart")
    monkeypatch.setattr(ref, "REPEATS", 2)
    real_tune = repro.tune

    def tune(spec, **kw):
        if spec.backend == "pallas":
            raise _RealTail
        return real_tune(spec, **kw)

    monkeypatch.setattr(repro, "tune", tune)
    ref_out = io.StringIO()
    with contextlib.redirect_stdout(ref_out), pytest.raises(_RealTail):
        ref.main()

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert quickstart.main(["--repeats", "2", "--device", "cpu"]) == 0
    ours = out.getvalue()
    head, tail = ours.rsplit("\nreal-measurement", 1)
    assert head == ref_out.getvalue()
    assert "vs Random Search (MWU alpha=0.01, CLES):" in head
    assert tail.startswith(" harris (backend='cuda', device='cpu'): ")


def test_quickstart_real_measurement_runs_alone():
    with contextlib.redirect_stdout(io.StringIO()):
        r = quickstart.real_measurement(device="cpu", x=64, y=128)
    assert r.n_samples == 10 and np.isfinite(r.final_value)


def _ticks():
    count = itertools.count()
    return lambda: float(next(count))


def test_tune_kernel_finds_the_reference_winner():
    ref = load_example("tune_kernel_interpret")
    ref_clock.set_timer(_ticks())
    port_clock.set_timer(_ticks())
    try:
        ref_out, out = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(ref_out):
            ref.main()
        with contextlib.redirect_stdout(out):
            r = tune_kernel.tune_add(device="cpu")
    finally:
        ref_clock.set_timer(None)
        port_clock.set_timer(None)

    def winner_line(text: str) -> str:
        return next(line for line in text.splitlines() if line.startswith("GA best config"))

    assert winner_line(out.getvalue()) == winner_line(ref_out.getvalue())
    assert r.n_samples == tune_kernel.BUDGET == ref.BUDGET
    assert (tune_kernel.X, tune_kernel.Y) == (ref.X, ref.Y)
    assert r.final_value == 1.0


def test_tune_kernel_main_on_the_cpu():
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert tune_kernel.main(["--x", "64", "--y", "128", "--device", "cpu"]) == 0
    assert "final config re-measured 5x" in out.getvalue()


STEPS, BATCH, SEQ = 3, 2, 64


def reference_losses(ckpt: str):
    """The reference example's loop on its small config: its initial
    parameters and its losses over ``STEPS`` steps."""
    ref_train_lm = load_example("train_lm")
    cfg = ref_train_lm.small_config()
    model = ref_build(cfg)
    params = ref_init(model.spec(), jax.random.PRNGKey(0))
    state = ref_init_state(model, params)
    step_fn = jax.jit(ref_train_step(
        model, RefSettings(remat="none", optimizer=RefAdamW(lr=1e-3, warmup_steps=20))))
    dc = RefDataConfig(seed=0)
    runner = RefRunner(RefRunnerConfig(ckpt_dir=ckpt, ckpt_every=50), step_fn,
                       lambda s: ref_train_batch(dc, cfg, SEQ, BATCH, s))
    _, report = runner.run(state, n_steps=STEPS)
    return cfg, jax.tree_util.tree_map(np.asarray, params), report.losses


def test_train_lm_matches_the_reference_losses_and_resumes(tmp_path):
    ref_cfg, ref_params, ref_losses = reference_losses(str(tmp_path / "ref"))
    cfg = train_lm.small_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)

    ckpt = str(tmp_path / "ours")
    _, report = train_lm.train(cfg, steps=STEPS, batch=BATCH, seq=SEQ, ckpt=ckpt,
                               device="cpu", params=params_from_numpy(ref_params, "cpu"))
    assert report.restored_from is None and report.steps_run == STEPS
    np.testing.assert_allclose(report.losses, ref_losses, rtol=1e-2)

    _, again = train_lm.train(cfg, steps=STEPS + 2, batch=BATCH, seq=SEQ, ckpt=ckpt,
                              device="cpu")
    assert again.restored_from == STEPS and again.steps_run == 2

    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert train_lm.main(["--steps", str(STEPS + 3), "--batch", str(BATCH), "--seq",
                              str(SEQ), "--device", "cpu", "--ckpt", ckpt]) == 0
    assert f"resumed from: {STEPS + 2}" in out.getvalue()
    assert "steps run: 1 in " in out.getvalue()
