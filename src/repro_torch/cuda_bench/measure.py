"""Launch-and-time measurement of the port's CUDA kernels (a port of
``repro.pallas_bench.measure.PallasMeasurement``).

:class:`CudaMeasurement` is the objective function the tuning loop plugs
into.  Measurement is a staged pipeline — **screen -> inputs -> compile ->
time -> record** — with each stage a method of its own and a
:class:`~repro_torch.core.measurement.StageClock` charging per-stage
wall-clock into provenance:

* **screen** — the validity pre-screen (:mod:`.validity`) rejects bad
  geometries before any launch; failures become structured
  :class:`~repro_torch.cuda_bench.validity.InvalidMeasurement` penalties
  (``float("inf")`` through the ordinary ``tell`` path).
* **inputs** — the workload's inputs taken from the process's input cache
  (drawn on its first use in the process) and copied to the device
  (:meth:`~repro_torch.cuda_bench.workloads.CudaWorkload.materialize`,
  waited for), once a measurement, on its first fill and before that
  fill's compile stage opens; a workload without inputs stages an empty
  tuple.  Within one matrix call (a ``shared_inputs`` scope) the copy is
  made once, by the call's first staging, and the call's other
  measurements take the same device tensors: the same bytes, which no
  kernel writes, so every value is what a copy of its own would give.
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

With ``pipeline_workers > 0``, ``measure_batch`` runs two-phase, as the
reference does: a *compile phase* submits the batch's screened geometries to
a thread pool, then the *timing phase* walks the batch strictly
sequentially.  Here the compile stage is a geometry's first warmed launch,
and no launch of the pool may fall inside a timed window: one device lock
serialises every launch (the pool's warm launches, the persistent cache's
served warm launches, the inputs stage) against every timed repeat, so what
overlaps timing is only the host part of the compile stage (the persistent
cache's get, claim and wait).  A pool task stages the inputs, where they are
not staged yet, before its compile stage opens, and launches on the
measurement's device (torch's current device is per thread).
``n_compiles`` is the same with the pipeline on or off.

``compile_cache`` (a :class:`~repro_torch.cuda_bench.compile_cache
.CompileCache` or a directory) layers the persistent cross-process cache of
each geometry's compile outcome under the in-memory one: an ``ok`` entry is
served with the same warm launches and counted as a pcache hit, not a
compile; an ``invalid`` entry (a launch refused for its geometry) is served
as the same ``compile``-stage penalty with no launch.  Only a refusal of
:data:`~repro_torch.kernels._build.CONFIG_ERRORS` is published; any other
error raises and leaves the entry unwritten.

With a telemetry sink attached (:meth:`BaseMeasurement.set_telemetry`),
every stage also emits a ``stage`` trace event carrying the same duration
its clock was charged, so a trace's per-stage totals equal ``stage_s``
(the ``inputs`` event also carries ``bytes``, ``draw_s``, ``copy_s``,
``cache_hit`` and ``device_reuse``); the ``compiles`` counter counts cache
fills (as ``n_compiles`` does), ``inputs.cache_hits`` /
``inputs.cache_misses`` the input cache's lookups and
``inputs.device_reuses`` the stagings a matrix call's shared copy served
(the port's own),
``invalid.<rule>`` counts penalties by validity rule (``align`` / ``block``
/ ``grid`` / ``smem``) or by failing stage (``compile`` / ``run``), and the
reference's ``pcache.hits`` / ``pcache.misses`` / ``pcache.stores`` /
``pcache.waits`` / ``compile_cache_hits`` counters and ``prefetch_inflight``
gauge count what they count there.

``device="cuda"`` (the default) measures on the card and raises where there
is none; ``device="cpu"`` runs the kernels' plain versions, for tests of
the loop on a machine without a card.  A CPU number is never reported as a
device time: provenance names the device it came from.
"""

from __future__ import annotations

import platform
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from contextlib import contextmanager, nullcontext
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.clock import monotonic
from ..core.engine import config_key
from ..core.measurement import BaseMeasurement, StageClock, fence
from ..kernels import LAUNCHES, _build
from ..kernels.common import Config, geometry_from_config
from .compile_cache import (
    CompileCache,
    deserialize_compiled,
    runtime_fingerprint,
    serialize_compiled,
)
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
    ``pipeline_workers=N`` enables the batch compile prefetcher (N pool
    threads); 0 keeps the inline compile-then-time loop.  ``compile_cache``
    is the persistent cross-process cache (or its directory).  Both are
    speed knobs: values do not change.
    """

    def __init__(
        self,
        workload: CudaWorkload,
        *,
        repeats: int = 5,
        warmup: int = 1,
        timer: Callable[[], float] | None = None,
        device="cuda",
        pipeline_workers: int = 0,
        compile_cache: "CompileCache | str | None" = None,
    ):
        super().__init__()
        if repeats < 1:
            raise ValueError("repeats must be >= 1")
        if pipeline_workers < 0:
            raise ValueError("pipeline_workers must be >= 0")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            _build.library()  # a build that fails fails every config: raise now
        self.workload = workload
        self.repeats = int(repeats)
        self.warmup = int(warmup)
        self.pipeline_workers = int(pipeline_workers)
        self._timer = timer if timer is not None else monotonic
        #: per-stage wall-clock (screen / inputs / compile / time / record),
        #: per run
        self.clock = StageClock()
        if isinstance(compile_cache, str):
            compile_cache = CompileCache(
                compile_cache, fingerprint=runtime_fingerprint(self.device)
            )
        #: persistent cross-process compile cache, or None (memory-only)
        self.pcache: CompileCache | None = compile_cache
        #: lifetime count of per-geometry cache fills (survives reset())
        self.n_compiles = 0
        #: lifetime persistent-cache hits (entries served instead of filled)
        self.n_pcache_hits = 0
        #: per-run counters — what provenance reports
        self.run_compiles = 0
        self.run_pcache_hits = 0
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
        #: geometry key -> in-flight prefetch fill (pipelined batches)
        self._inflight: dict[tuple, Future] = {}
        self._cache_lock = threading.RLock()
        #: held around every launch and every timed repeat: no launch of the
        #: pool falls inside a timed window (taken after _cache_lock, never
        #: before it)
        self._device_lock = threading.Lock()
        self._pool: ThreadPoolExecutor | None = None

    # -- per-geometry warm cache ----------------------------------------------
    @staticmethod
    def _geom_key(cfg: Config) -> tuple:
        """What the launch depends on: w_z stays out of the program."""
        g = geometry_from_config(cfg)
        return (g.bm, g.bn, g.tz, g.wx, g.wy)

    def _on_device(self):
        """The measurement's card as this thread's current device (a pool
        thread starts on card 0)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return nullcontext()

    def _penalty(self, e: Exception, stage: str) -> InvalidMeasurement:
        """The penalty for a launch refused because of its config; re-raise
        any other error, and a refusal that left the device unusable."""
        if not (isinstance(e, _build.LaunchError) and e.config_dependent):
            raise e
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # a sticky fault raises here
        return InvalidMeasurement(reason=f"{type(e).__name__}: {e}", stage=stage)

    def _warm(self, fn: Callable) -> None:
        """``max(1, warmup)`` fenced launches, under the device lock."""
        with self._device_lock:
            for _ in range(max(1, self.warmup)):
                fence(fn())

    def _runner(self, inputs: tuple, cfg: Config) -> Callable:
        run_cfg = {**cfg, "w_z": 1}
        device = self.device

        def fn():
            return self.workload.run(inputs, run_cfg, device)

        return fn

    def _pcache_key(self, gkey: tuple) -> str:
        w = self.workload
        return self.pcache.key(
            kernel=w.name,
            x=w.x,
            y=w.y,
            input_seed=w.input_seed,
            device=self.device.type,
            geometry=list(gkey),
        )

    def _pcache_hit(self) -> None:
        with self._cache_lock:
            self.n_pcache_hits += 1
            self.run_pcache_hits += 1
        if self.telemetry.enabled:
            self.telemetry.inc("pcache.hits")

    def _pcache_serve(
        self, entry: dict, cfg: Config, gkey: tuple, inputs: tuple
    ) -> Callable | InvalidMeasurement | None:
        """Turn a persistent-cache entry into a warmed runner (or the cached
        penalty, with no launch); ``None`` means the entry cannot stand in
        for a fill here (no artifact, another library's, or a warm launch
        that failed) and the caller fills locally."""
        if entry.get("status") == "invalid":
            bad = InvalidMeasurement(
                reason=entry.get("reason") or "cached compile failure",
                stage=entry.get("stage") or "compile",
            )
            with self._cache_lock:
                self._compiled[gkey] = bad
            self._pcache_hit()
            return bad
        blob = entry.get("artifact")
        if blob is None:
            return None
        try:
            art = deserialize_compiled(blob)
            if art.get("kernel") != self.workload.name or \
                    tuple(art.get("geometry", ())) != gkey:
                return None
            fn = self._runner(inputs, cfg)
            self._warm(fn)
        except Exception:  # noqa: BLE001 — a bad entry degrades to a local fill
            return None
        with self._cache_lock:
            self._compiled[gkey] = fn
        self._pcache_hit()
        return fn

    def _stage_inputs(self) -> tuple:
        """The workload's inputs on the device: staged once a measurement, in
        the ``inputs`` stage (draw, copy, and a wait for the copy), so the
        compile stage holds warm launches alone.  The host arrays come from
        the process's input cache (:mod:`.workloads`); the copy is made
        every time, but inside a ``shared_inputs`` scope (a matrix call),
        where the scope's copy made by the call's first staging serves.
        With telemetry on, the stage's event carries ``bytes`` (all inputs),
        ``draw_s``, ``copy_s``, ``cache_hit`` and ``device_reuse``, the
        ``inputs.cache_hits`` / ``inputs.cache_misses`` counters count
        lookups (a workload without inputs makes none) and
        ``inputs.device_reuses`` the stagings the scope's copy served."""
        with self._cache_lock:
            if self._inputs is None:
                with self._staged("inputs") as attrs, self._device_lock:
                    inputs = self.workload.materialize(self.device, attrs)
                    attrs["bytes"] = sum(t.numel() * t.element_size() for t in inputs)
                self._inputs = inputs
                hit = attrs.get("cache_hit")
                if hit is not None and self.telemetry.enabled:
                    self.telemetry.inc("inputs.cache_hits" if hit else "inputs.cache_misses")
                    if attrs["device_reuse"]:
                        self.telemetry.inc("inputs.device_reuses")
            return self._inputs

    def _compile_now(
        self, cfg: Config, gkey: tuple, inputs: tuple
    ) -> Callable | InvalidMeasurement:
        """Warm cfg's geometry on the staged ``inputs`` and cache its runner.
        Called from the timing thread (inline path) or a prefetch pool
        thread; shared state mutates under the cache lock, launches run
        under the device lock.

        With a persistent cache attached, the order is: serve the on-disk
        entry (no fill counted) -> claim the key and fill -> or, when
        another process holds the claim, wait for its entry.  Claim holders
        publish ok entries, and invalid ones for a launch refused for its
        geometry, so every other process skips this geometry."""
        pc = self.pcache
        pckey = None
        claimed = False
        if pc is not None:
            pckey = self._pcache_key(gkey)
            entry = pc.get(pckey)
            if entry is None:
                claimed = pc.claim(pckey)
                if claimed:
                    # double-check under the claim: the previous holder may
                    # have published between our miss and our claim
                    entry = pc.get(pckey)
                else:
                    if self.telemetry.enabled:
                        self.telemetry.inc("pcache.waits")
                    entry = pc.wait(pckey)
            if entry is not None:
                got = self._pcache_serve(entry, cfg, gkey, inputs)
                if got is not None:
                    if claimed:
                        pc.release(pckey)
                    return got
            if self.telemetry.enabled:
                self.telemetry.inc("pcache.misses")
        try:
            with self._cache_lock:
                self.n_compiles += 1
                self.run_compiles += 1
            if self.telemetry.enabled:
                self.telemetry.inc("compiles")
            fn = self._runner(inputs, cfg)
            try:
                self._warm(fn)
            except RuntimeError as e:  # a refused geometry is a penalty, not a crash
                bad = self._penalty(e, "compile")
                with self._cache_lock:
                    self._compiled[gkey] = bad
                if claimed:
                    pc.put(pckey, status="invalid", reason=bad.reason, stage="compile")
                return bad
            with self._cache_lock:
                self._compiled[gkey] = fn
            if claimed:
                artifact = serialize_compiled(
                    {"kernel": self.workload.name, "geometry": list(gkey)}
                )
                pc.put(pckey, status="ok", artifact=artifact)
                if self.telemetry.enabled:
                    self.telemetry.inc("pcache.stores")
            return fn
        finally:
            if claimed:
                pc.release(pckey)

    # -- pipeline stages -------------------------------------------------------
    @contextmanager
    def _staged(self, name: str, **attrs):
        """Charge the stage clock AND (when telemetry is on) emit a ``stage``
        trace event with the same duration — one timing source for both, so
        the trace's per-stage totals reconcile exactly with ``stage_times``.
        Yields the event's attributes, which the stage may add to.
        Thread-safe like the clock: prefetch pool threads use it too."""
        t0 = monotonic()
        try:
            yield attrs
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
        """Warmed runner for cfg's geometry: cache hit, prefetched fill
        (pipelined batches), or inline fill on first use."""
        gkey = self._geom_key(config)
        with self._cache_lock:
            hit = self._compiled.get(gkey)
            fut = self._inflight.pop(gkey, None)
        if fut is not None:
            # the pool thread charges the compile stage; waiting here is the
            # pipeline's (ideally zero) bubble.  Its runner may be cached
            # before its task ends: wait for the whole task all the same, so
            # its counters and stage time land in this run
            got = fut.result()
            if hit is None:
                return got
        if hit is not None:
            if self.telemetry.enabled:
                self.telemetry.inc("compile_cache_hits")
            return hit
        inputs = self._stage_inputs()
        with self._staged("compile", key=str(gkey)):
            return self._compile_now(config, gkey, inputs)

    def _stage_time(
        self, fn: Callable, repeats: int, key: str | None = None
    ) -> list[float] | InvalidMeasurement:
        """Sequential fenced timing: the fence sits inside the timed region,
        and each repeat holds the device lock, so no pool launch falls
        inside it."""
        times = []
        with self._staged("time", key=key):
            for _ in range(repeats):
                try:
                    with self._device_lock:
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

    # -- the two-phase batch path ----------------------------------------------
    def _prefetch_compiles(self, configs: Sequence[Config]) -> None:
        """Compile phase: submit every geometry this batch will fill to the
        pool, in batch order.  Only configs that pass the pre-screen are
        prefetched (the inline path never fills a screened-out config), so
        ``n_compiles`` is identical with the pipeline on or off."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.pipeline_workers,
                thread_name_prefix="cuda-compile",
            )
        for cfg in configs:
            if validate_config(self.workload, cfg) is not None:
                continue
            gkey = self._geom_key(cfg)
            with self._cache_lock:
                if gkey in self._compiled or gkey in self._inflight:
                    continue
                self._inflight[gkey] = self._pool.submit(
                    self._prefetch_task, dict(cfg), gkey
                )
                depth = len(self._inflight)
            if self.telemetry.enabled:
                self.telemetry.gauge("prefetch_inflight", depth)

    def _prefetch_task(self, cfg: Config, gkey: tuple):
        with self._on_device():
            inputs = self._stage_inputs()
            with self._staged("compile", key=str(gkey)):
                return self._compile_now(cfg, gkey, inputs)

    def measure_batch(self, configs: Sequence[Config]) -> np.ndarray:
        """One Python-level dispatch per batch.  With ``pipeline_workers``
        set, the batch runs two-phase — compile prefetch, then timing — and
        the timing phase walks configs strictly sequentially."""
        self.n_samples += len(configs)
        self.n_dispatches += 1
        if self.pipeline_workers > 0 and len(configs) > 1:
            self._prefetch_compiles(configs)
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

    def close(self) -> None:
        """Shut the prefetch pool down (idempotent; the pool is rebuilt on
        the next pipelined batch if the instance keeps measuring)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def release(self) -> None:
        """Shut the pool down and drop the staged inputs and the warmed
        runners.  Each runner is a closure over this measurement, so without
        this a finished measurement keeps its inputs on the device until the
        cyclic collector finds it.  Inside a ``shared_inputs`` scope only
        this measurement's reference goes: the scope keeps the copy for the
        call's next measurement.  Values, counters and logs stay; a later
        measurement stages and warms anew (``n_compiles`` counts those fills
        again)."""
        self.close()
        with self._cache_lock:
            self._inputs = None
            self._compiled.clear()
            self._inflight.clear()

    def __del__(self):  # pragma: no cover — interpreter-exit ordering
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass

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
            "pipeline_workers": self.pipeline_workers,
            "compile_cache": self.pcache is not None,
            "stage_s": {k: round(v, 6) for k, v in self.clock.times().items()},
            "n_compiles": self.run_compiles,
            "n_compiles_total": self.n_compiles,
            "n_pcache_hits": self.run_pcache_hits,
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
        self.run_pcache_hits = 0
        self._run_invalid.clear()
        self.repeat_log.clear()
        self.final_repeat_log.clear()
        self.clock.reset()
