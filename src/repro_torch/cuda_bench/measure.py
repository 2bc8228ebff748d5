"""Launch-and-time measurement of the port's CUDA kernels (a port of
``repro.pallas_bench.measure.PallasMeasurement``).

:class:`CudaMeasurement` is the objective function the tuning loop plugs
into.  Measurement is a staged pipeline — **screen -> compile -> time ->
record** — with each stage a method of its own and a
:class:`~repro_torch.core.measurement.StageClock` charging per-stage
wall-clock into provenance:

* **screen** — the validity pre-screen (:mod:`.validity`) rejects bad
  geometries before any launch; failures become structured
  :class:`~repro_torch.cuda_bench.validity.InvalidMeasurement` penalties
  (``float("inf")`` through the ordinary ``tell`` path).
* **compile** — one shared library serves every config (tile sizes, t_z,
  block counts are launch arguments), built once per checkout.  What the
  per-geometry cache holds is therefore a geometry's *warmed* runner: a
  cache fill is a geometry's first warmed launch, and ``n_compiles`` counts
  those fills.  Configs differing only in ``w_z`` share one entry.  A
  launch refused for its geometry (:data:`~repro_torch.kernels._build.CONFIG_ERRORS`)
  becomes a ``compile``-stage penalty.  Anything else would fail every
  config alike and raises: the library is built in the constructor, so a
  missing ``nvcc`` or a failed build raises there, and a launch error of
  another kind, or one after which the device no longer synchronises,
  raises from the measurement.
* **warmup + N-repeat timing** — every measurement runs ``warmup`` fenced
  calls (the fill counts as the first), then ``repeats`` timed calls, each
  fenced INSIDE the timed region: host clock around the launch and
  ``torch.cuda.synchronize()``.  The aggregate is the median; all repeats
  are recorded (``repeats_for``).

With a telemetry sink attached (:meth:`BaseMeasurement.set_telemetry`),
every stage also emits a ``stage`` trace event carrying the same duration
its clock was charged, so a trace's per-stage totals equal ``stage_s``; the
``compiles`` counter counts cache fills (as ``n_compiles`` does) and
``invalid.<rule>`` counts penalties by validity rule (``align`` / ``block``
/ ``grid`` / ``smem``) or by failing stage (``compile`` / ``run``).  The
reference's persistent compile cache counters (``pcache.*``,
``compile_cache_hits``) and its prefetch gauge have no counterpart: there
is no per-config compile to cache or prefetch.

``device="cuda"`` (the default) measures on the card and raises where there
is none; ``device="cpu"`` runs the kernels' plain versions, for tests of
the loop on a machine without a card.  A CPU number is never reported as a
device time: provenance names the device it came from.
"""

from __future__ import annotations

import platform
from contextlib import contextmanager
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.clock import monotonic
from ..core.engine import config_key
from ..core.measurement import BaseMeasurement, StageClock, fence
from ..kernels import LAUNCHES, _build
from ..kernels.common import Config, geometry_from_config
from .validity import InvalidMeasurement, validate_config
from .workloads import CudaWorkload


def resolve_device(device) -> torch.device:
    """``device`` as a concrete torch device; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CudaMeasurement(device='cuda'): no CUDA device is available; "
                "pass device='cpu' to run the kernels' plain versions"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


class CudaMeasurement(BaseMeasurement):
    """Measures real kernel time; never raises on a bad config, always on a
    fault that no config causes.

    ``timer`` is the timing-stage clock (default: the injectable
    monotonic seam in :mod:`repro_torch.core.clock`).
    """

    def __init__(
        self,
        workload: CudaWorkload,
        *,
        repeats: int = 5,
        warmup: int = 1,
        timer: Callable[[], float] | None = None,
        device="cuda",
    ):
        super().__init__()
        if repeats < 1:
            raise ValueError("repeats must be >= 1")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            _build.library()  # a build that fails fails every config: raise now
        self.workload = workload
        self.repeats = int(repeats)
        self.warmup = int(warmup)
        self._timer = timer if timer is not None else monotonic
        #: per-stage wall-clock (screen / compile / time / record), per run
        self.clock = StageClock()
        #: lifetime count of per-geometry cache fills (survives reset())
        self.n_compiles = 0
        #: per-run counters — what provenance reports
        self.run_compiles = 0
        self._run_invalid: set[str] = set()
        #: config_key -> InvalidMeasurement for every penalized config served
        self.invalid: dict[str, InvalidMeasurement] = {}
        #: config_key -> per-repeat seconds of the last search measurement
        self.repeat_log: dict[str, list[float]] = {}
        #: config_key -> per-repeat seconds of the last final re-measurement
        self.final_repeat_log: dict[str, list[float]] = {}
        self._inputs: tuple | None = None
        #: geometry key -> warmed runner (or the penalty of a refused launch)
        self._compiled: dict[tuple, Callable | InvalidMeasurement] = {}

    # -- per-geometry warm cache ----------------------------------------------
    @staticmethod
    def _geom_key(cfg: Config) -> tuple:
        """What the launch depends on: w_z stays out of the program."""
        g = geometry_from_config(cfg)
        return (g.bm, g.bn, g.tz, g.wx, g.wy)

    def _penalty(self, e: Exception, stage: str) -> InvalidMeasurement:
        """The penalty for a launch refused because of its config; re-raise
        any other error, and a refusal that left the device unusable."""
        if not (isinstance(e, _build.LaunchError) and e.config_dependent):
            raise e
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # a sticky fault raises here
        return InvalidMeasurement(reason=f"{type(e).__name__}: {e}", stage=stage)

    def _compile_now(self, cfg: Config, gkey: tuple) -> Callable | InvalidMeasurement:
        """Warm cfg's geometry and cache its runner."""
        if self._inputs is None:
            self._inputs = self.workload.materialize(self.device)
        inputs = self._inputs
        run_cfg = {**cfg, "w_z": 1}
        device = self.device
        self.n_compiles += 1
        self.run_compiles += 1
        if self.telemetry.enabled:
            self.telemetry.inc("compiles")

        def fn():
            return self.workload.run(inputs, run_cfg, device)

        try:
            for _ in range(max(1, self.warmup)):
                fence(fn())
        except RuntimeError as e:  # a refused geometry is a penalty, not a crash
            bad = self._penalty(e, "compile")
            self._compiled[gkey] = bad
            return bad
        self._compiled[gkey] = fn
        return fn

    # -- pipeline stages -------------------------------------------------------
    @contextmanager
    def _staged(self, name: str, **attrs):
        """Charge the stage clock AND (when telemetry is on) emit a ``stage``
        trace event with the same duration — one timing source for both, so
        the trace's per-stage totals reconcile exactly with ``stage_times``."""
        t0 = monotonic()
        try:
            yield
        finally:
            dur = monotonic() - t0
            self.clock.add(name, dur)
            if self.telemetry.enabled:
                self.telemetry.stage(
                    name, dur, **{k: v for k, v in attrs.items() if v is not None}
                )

    def _stage_screen(self, config: Config) -> InvalidMeasurement | None:
        """Validity pre-screen; ``None`` means the config may launch."""
        with self._staged("screen"):
            reason = validate_config(self.workload, config)
        if reason is None:
            return None
        return InvalidMeasurement(reason=reason, stage="validity")

    def _stage_compile(self, config: Config) -> Callable | InvalidMeasurement:
        gkey = self._geom_key(config)
        hit = self._compiled.get(gkey)
        if hit is not None:
            return hit
        with self._staged("compile", key=str(gkey)):
            return self._compile_now(config, gkey)

    def _stage_time(
        self, fn: Callable, repeats: int, key: str | None = None
    ) -> list[float] | InvalidMeasurement:
        """Sequential fenced timing: the fence sits inside the timed region."""
        times = []
        with self._staged("time", key=key):
            for _ in range(repeats):
                try:
                    t0 = self._timer()
                    fence(fn())
                    times.append(self._timer() - t0)
                except RuntimeError as e:  # a refused geometry -> penalty
                    return self._penalty(e, "run")
        return times

    def _stage_record(
        self,
        key: str,
        out: list[float] | InvalidMeasurement,
        log: dict[str, list[float]],
    ) -> float:
        """Fold a stage-pipeline outcome into the served value + the logs."""
        with self._staged("record", key=key):
            if isinstance(out, InvalidMeasurement):
                self.invalid[key] = out
                self._run_invalid.add(key)
                if self.telemetry.enabled:
                    # by validity rule (align/block/grid/smem), or by the
                    # failing stage for compile/run penalties
                    rule = (
                        out.reason.split(":", 1)[0]
                        if out.stage == "validity"
                        else out.stage
                    )
                    self.telemetry.inc(f"invalid.{rule}")
                return out.penalty
            log[key] = out
            return float(np.median(out))

    def _measure_repeats(
        self, config: Config, repeats: int
    ) -> list[float] | InvalidMeasurement:
        bad = self._stage_screen(config)
        if bad is not None:
            return bad
        fn = self._stage_compile(config)
        if isinstance(fn, InvalidMeasurement):
            return fn
        return self._stage_time(fn, repeats, key=config_key(config))

    def _measure_one(self, config: Config) -> float:
        return self._stage_record(
            config_key(config),
            self._measure_repeats(config, self.repeats),
            self.repeat_log,
        )

    def measure_batch(self, configs: Sequence[Config]) -> np.ndarray:
        """One Python-level dispatch per batch; configs time one by one."""
        self.n_samples += len(configs)
        self.n_dispatches += 1
        return np.array(
            [float(self._measure_one(c)) for c in configs], dtype=np.float64
        )

    def measure_final(self, config: Config, repeats: int = 10) -> float:
        """Paper protocol: the winner re-measured ``repeats`` times, median
        kept; raw repeats land in ``final_repeat_log`` for the run record."""
        return self._stage_record(
            config_key(config),
            self._measure_repeats(config, repeats),
            self.final_repeat_log,
        )

    # -- introspection (RunRecord provenance, disk-cache metadata) ------------
    def reason_for(self, config: Config) -> str | None:
        bad = self.invalid.get(config_key(config))
        return None if bad is None else bad.to_meta()

    def repeats_for(self, config: Config) -> list[float] | None:
        key = config_key(config)
        return self.final_repeat_log.get(key) or self.repeat_log.get(key)

    def stage_times(self) -> dict[str, float]:
        return self.clock.times()

    def provenance(self) -> dict:
        """How timings were taken and on what.  On the card: its name and
        capability, the CUDA and nvcc versions and the library's build time;
        on the CPU, the host processor and no device fields."""
        on_card = self.device.type == "cuda"
        prov = {
            "backend": "cuda",
            "kernel": self.workload.name,
            "x": self.workload.x,
            "y": self.workload.y,
            "input_seed": self.workload.input_seed,
            "device": self.device.type,
            "torch": torch.__version__,
            "repeats": self.repeats,
            "warmup": self.warmup,
            "stage_s": {k: round(v, 6) for k, v in self.clock.times().items()},
            "n_compiles": self.run_compiles,
            "n_compiles_total": self.n_compiles,
            "n_invalid": len(self._run_invalid),
            "launches": LAUNCHES[self.workload.name].n,
        }
        if on_card:
            lib = _build.library()
            prov.update(
                device_kind=torch.cuda.get_device_name(self.device),
                capability=list(torch.cuda.get_device_capability(self.device)),
                cuda=torch.version.cuda,
                nvcc=lib.nvcc,
                build_s=round(lib.build_s, 3),
                timer="perf_counter around launch + torch.cuda.synchronize()",
            )
        else:
            prov.update(
                device_kind=platform.processor() or platform.machine() or "cpu",
                capability=None,
                timer="perf_counter around the plain version (CPU)",
            )
        return prov

    def reset(self) -> None:
        """Clear per-run counters, logs, and stage clocks; the warm cache —
        and its lifetime ``n_compiles`` — survives."""
        super().reset()
        self.run_compiles = 0
        self._run_invalid.clear()
        self.repeat_log.clear()
        self.final_repeat_log.clear()
        self.clock.reset()
