"""Executor registry: pluggable strategies for running experiment units (a
port of ``repro.core.executors``).

Mirrors ``SEARCHERS`` / ``BACKENDS`` / ``STORES``: an executor is resolved by
name and runs a list of :class:`~repro_torch.core.workunits.ExperimentUnit`\\ s
for a session, returning :class:`~repro_torch.core.workunits.UnitResult`
fragments the session merges deterministically by unit key.  Built-ins:

* ``"serial"``  — the in-process loop; journals each completed unit.
* ``"process"`` — ``multiprocessing`` (spawn) fan-out.  Under the default
  *work-stealing* scheduler each worker process builds ONE persistent
  session at pool start (initializer), then pulls units one at a time from
  the shared submit queue.  Each worker writes to its own
  ``store_path.<ns8>.shard<pid>`` (seeded from the warm parent store),
  journals completed units into it, and the parent glob-merges shard stores
  when the pool joins.  Each worker opens its own CUDA context: on one card
  concurrent workers time each other's kernels, so timing runs on one card
  use ``serial`` or ``device``.
* ``"futures"`` — the grouped worker payload submitted to ANY
  ``concurrent.futures.Executor`` (``run_matrix(futures_pool=...)``); without
  one a spawn-context ``ProcessPoolExecutor`` is created for the call.  The
  payload is ``(spec_dict, unit dicts, store paths)`` and results come back
  as plain JSON-able dicts.  Under the stealing scheduler every payload
  carries exactly one unit (one session rebuild per unit).
* ``"device"``  — fan-out over the CUDA cards WITHIN one process: worker
  threads, each pinned to one card of :func:`cuda_devices` with
  ``torch.cuda.device``, with one shard store per card.  The pin holds
  around building a thread's session and around every unit, since
  :class:`~repro_torch.cuda_bench.CudaMeasurement` fixes its card when it is
  built.  With no card it raises; it never runs on the CPU in their place.

Scheduling: ``ExecutionPlan.scheduler`` selects ``"steal"`` (default — one
unit per submission, ``as_completed`` streaming) or ``"static"`` (the
round-robin one-payload-per-worker partition).  Unit *results* merge by unit
key, so both schedules — and any completion order — are bit-identical to
the serial loop.

Parallel executors collect worker results as they complete and fail fast:
the first worker exception cancels outstanding work, absorbs completed
workers' shard stores (their journaled units survive into the parent), and
re-raises.  :func:`recover_shard_stores` absorbs leftover
``*.<ns8>.shard<k>`` files a killed run left behind before a resumed run
partitions its units; the namespace digest keeps it from absorbing another
spec's shards.
"""

from __future__ import annotations

import contextlib
import os
import re
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable

from .stores import absorb_winners, make_store
from .workunits import ExperimentUnit, UnitResult

__all__ = [
    "EXECUTORS",
    "ExecutionPlan",
    "Executor",
    "cuda_devices",
    "recover_shard_stores",
    "register_executor",
    "run_units",
    "shard_namespace",
    "shard_store_path",
]


@dataclass
class ExecutionPlan:
    """Everything an executor needs for one fan-out."""

    session: Any                      # TuningSession (duck-typed; no import cycle)
    units: list[ExperimentUnit] = field(default_factory=list)
    max_workers: int = 1
    futures_pool: Any = None          # concurrent.futures.Executor, "futures" only
    scheduler: str = "steal"          # "steal" (shared unit queue) | "static"


@dataclass(frozen=True)
class Executor:
    """A named unit-execution strategy.

    ``parallel`` marks executors that ship work out of the calling thread:
    they require a fully serializable spec (no in-process overrides, a
    name-resolvable backend) and degrade to ``serial`` — with a warning —
    when the plan cannot keep more than one worker busy.
    """

    name: str
    run: Callable[[ExecutionPlan], list[UnitResult]]
    parallel: bool = True


EXECUTORS: dict[str, Executor] = {}


def register_executor(executor: Executor) -> Executor:
    EXECUTORS[executor.name] = executor
    return executor


def run_units(name: str, plan: ExecutionPlan) -> list[UnitResult]:
    """Run ``plan`` through the named executor."""
    if name not in EXECUTORS:
        raise KeyError(f"unknown executor {name!r}; have {sorted(EXECUTORS)}")
    return EXECUTORS[name].run(plan)


# -------------------------------------------------------------------- serial


def _run_serial(plan: ExecutionPlan) -> list[UnitResult]:
    session = plan.session
    journal = session.unit_journal()
    out = []
    for unit in plan.units:
        result = session.run_unit(unit)
        if journal is not None:
            journal.put(result)   # flushed (throttled) — a kill loses little
        out.append(result)
    return out


register_executor(Executor(name="serial", run=_run_serial, parallel=False))


# ----------------------------------------------------- shard-store plumbing


def shard_namespace(session) -> str:
    """8-hex digest namespacing this session's shard-store filenames.

    Derived from :meth:`TuningSession.journal_namespace` — the same
    fingerprint that scopes unit-journal entries — so two different specs
    sharing one store directory can never absorb each other's leftover
    shards on recovery."""
    ns = session.journal_namespace()
    if ns is None:
        # no stable fingerprint (live callables in the spec): fall back to
        # the cache key, which still separates kernels and problem sizes
        ns = str(session.cache_key)
    return f"{zlib.crc32(ns.encode('utf-8')) & 0xFFFFFFFF:08x}"


def shard_store_path(session, ident) -> str | None:
    """The shard-store filename for worker ``ident`` (pid or device index):
    ``<store>.<ns8>.shard<ident>``."""
    if session.spec.store is None or session._store_path is None:
        return None
    return f"{session._store_path}.{shard_namespace(session)}.shard{ident}"


def absorb_store(dst, kind: str, path: str) -> None:
    """Copy one store file's values AND metadata (which carries the unit
    journal) into ``dst``; winner records merge under the better-value /
    never-staler policy."""
    src = make_store(kind, path)
    dst.update(src.items())
    dst.update_meta(src.meta_items())
    absorb_winners(dst, src)


def merge_shard_stores(session, paths: list[str]) -> None:
    """Fold worker shard stores into the session's main store, then delete
    the shard files."""
    if session.store is None:
        return
    for path in paths:
        if path is None or not os.path.exists(path):
            continue
        absorb_store(session.store, session.spec.store, path)
        os.remove(path)
    session.store.save()


def recover_shard_stores(session) -> int:
    """Absorb shard stores left behind by a killed parallel run.

    Workers journal completed units into their shard stores incrementally,
    so even though the dead parent never merged them, their measurements and
    journal entries are intact on disk.  Returns how many files were
    recovered.
    """
    base = session._store_path
    if session.store is None or base is None:
        return 0
    # the namespace digest scopes recovery to THIS spec's shards
    pattern = re.compile(
        re.escape(f"{os.path.basename(base)}.{shard_namespace(session)}")
        + r"\.shard[A-Za-z0-9_-]+$"
    )
    d = os.path.dirname(base) or "."
    if not os.path.isdir(d):
        return 0
    leftovers = sorted(
        os.path.join(d, f) for f in os.listdir(d) if pattern.fullmatch(f)
    )
    merge_shard_stores(session, leftovers)
    return len(leftovers)


# ----------------------------------------------------------- worker payloads


def _check_shippable(session) -> dict:
    """Validate that the session can be rebuilt in a worker; return the
    serialized spec.  Raises the same errors for every parallel executor."""
    if session._has_overrides:
        raise RuntimeError(
            "parallel matrix runs rebuild the session from the serialized "
            "spec in worker processes; in-process overrides (space/"
            "measurement_factory/dataset/store objects) cannot be shipped"
        )
    if not session._backend.serializable:
        raise RuntimeError(
            f"backend {session.spec.backend!r} holds in-process callables and "
            "cannot be rebuilt in shard workers; use a name-resolvable "
            "backend (e.g. 'costmodel' or 'cuda') for parallel runs"
        )
    return session.spec.to_dict()  # raises early if not serializable


def _warm_store_path(session) -> str | None:
    """The parent's store file, when one exists: shard stores start as
    copies of it, so previously-measured entries are served as hits — a
    second parallel run performs zero re-measurements."""
    if (
        session.spec.store is not None
        and session._store_path is not None
        and os.path.exists(session._store_path)
    ):
        return session._store_path
    return None


def _dataset_arrays(session):
    """The parent's pre-generated sample arrays, shipped so N workers never
    redo the dataset's measurements."""
    dataset = session._get_dataset()
    return None if dataset is None else (dataset.indices, dataset.values)


def _make_payloads(plan: ExecutionPlan, spec_dict: dict) -> list[dict]:
    """Group units round-robin into at most ``max_workers`` payloads (the
    static schedule — one payload per worker)."""
    n = max(1, min(plan.max_workers, len(plan.units)))
    return _payloads_for_groups(plan, spec_dict, [plan.units[k::n] for k in range(n)])


def _make_unit_payloads(plan: ExecutionPlan, spec_dict: dict) -> list[dict]:
    """One payload per unit (the stealing schedule for the generic futures
    seam): any pool drains the queue in completion order, at the cost of a
    session rebuild per unit."""
    return _payloads_for_groups(plan, spec_dict, [[u] for u in plan.units])


def _payloads_for_groups(
    plan: ExecutionPlan, spec_dict: dict, groups: list[list[ExperimentUnit]]
) -> list[dict]:
    """One worker payload per unit group: ``spec`` / ``units`` /
    ``store_path`` are plain JSON, ``dataset`` the parent's sample arrays."""
    session = plan.session
    dataset = _dataset_arrays(session)
    base_store_path = _warm_store_path(session)
    return [
        {
            "spec": spec_dict,
            "units": [u.to_dict() for u in group],
            "store_path": shard_store_path(session, k),
            "base_store_path": base_store_path,
            "dataset": dataset,
        }
        for k, group in enumerate(groups)
    ]


def _worker_session(spec_dict: dict, store_path, base_store_path, dataset):
    """A session rebuilt from the serialized spec, its shard store seeded
    from the parent's warm store and its dataset from the parent's arrays."""
    from .api import TuningSession, TuningSpec  # lazy: avoid an import cycle
    from .dataset import SampleDataset

    spec = TuningSpec.from_dict(spec_dict)
    session = TuningSession(spec, store_path=store_path)
    if (
        base_store_path is not None
        and session.store is not None
        and os.path.exists(base_store_path)
    ):
        absorb_store(session.store, spec.store, base_store_path)
    if dataset is not None:
        indices, values = dataset
        session._dataset = SampleDataset(
            space=session.space, indices=indices, values=values
        )
    return session


def _unit_worker(payload: dict) -> list[dict]:
    """Runs one payload's units in a worker (any process with the package
    importable and the store paths reachable), journals each completed unit
    into the shard store, and returns JSON-able :class:`UnitResult` dicts."""
    session = _worker_session(
        payload["spec"], payload["store_path"],
        payload.get("base_store_path"), payload.get("dataset"),
    )
    journal = session.unit_journal()
    out = []
    for d in payload["units"]:
        result = session.run_unit(ExperimentUnit.from_dict(d))
        if journal is not None:
            journal.put(result)
        out.append(result.to_dict())
    session.save_store()
    return out


def _collect(plan: ExecutionPlan, payloads: list[dict],
             worker_results: list[list[dict]]) -> list[UnitResult]:
    merge_shard_stores(plan.session, [p["store_path"] for p in payloads])
    return [
        UnitResult.from_dict(d) for results in worker_results for d in results
    ]


def _drain_futures(plan: ExecutionPlan, payloads: list[dict],
                   futures: list) -> list[list[dict]]:
    """Collect worker futures as they complete, failing fast.

    On the first worker exception: cancel every outstanding future, wait for
    the ones already running to retire (so no worker is still writing its
    shard store), absorb completed workers' shard stores — their journaled
    units survive into the parent store for ``resume=True`` — and re-raise.
    """
    import concurrent.futures

    results: list[list[dict] | None] = [None] * len(futures)
    index = {f: i for i, f in enumerate(futures)}
    try:
        for f in concurrent.futures.as_completed(futures):
            results[index[f]] = f.result()
    except BaseException:
        for f in futures:
            f.cancel()
        concurrent.futures.wait(futures)
        merge_shard_stores(plan.session, [p["store_path"] for p in payloads])
        raise
    return results


# ------------------------------------------------- work-stealing machinery


def _steal_context(plan: ExecutionPlan, spec_dict: dict) -> dict:
    """The per-WORKER context for the stealing scheduler, shipped once per
    worker (pool initializer / thread init) instead of once per unit.
    Workers derive their shard names from their identity, so the parent need
    not know worker pids up front."""
    session = plan.session
    has_store = session.spec.store is not None and session._store_path is not None
    return {
        "spec": spec_dict,
        "store_base": session._store_path if has_store else None,
        # workers build `<store_base>.<shard_ns>.shard<ident>` — the parent
        # computes the namespace once so every worker agrees on it
        "shard_ns": shard_namespace(session) if has_store else None,
        "base_store_path": _warm_store_path(session),
        "dataset": _dataset_arrays(session),
    }


def _build_worker_state(ctx: dict, ident: int) -> dict:
    """One persistent worker session keyed by ``ident`` (pid for process
    workers, device index for device threads), with shard store
    ``<base>.<ns8>.shard<ident>`` — a name the recovery glob understands."""
    store_path = (
        None
        if ctx.get("store_base") is None
        else f"{ctx['store_base']}.{ctx['shard_ns']}.shard{ident}"
    )
    session = _worker_session(
        ctx["spec"], store_path, ctx.get("base_store_path"), ctx.get("dataset")
    )
    return {"session": session, "journal": session.unit_journal(), "ident": int(ident)}


def _close_worker_state(state: dict | None) -> None:
    """Flush a worker's shard store tail."""
    if state is not None:
        state["session"].save_store()


def _run_state_unit(state: dict, unit_dict: dict) -> tuple[int, dict]:
    """Run one pulled unit against a persistent worker state, journaling it
    into the worker's shard store.  Returns ``(worker ident, result dict)``."""
    session = state["session"]
    result = session.run_unit(ExperimentUnit.from_dict(unit_dict))
    if state["journal"] is not None:
        state["journal"].put(result)   # throttled flush — a kill loses little
    return state["ident"], result.to_dict()


def _drain_steal(futures: list) -> list[dict]:
    """Collect per-unit futures as they complete, failing fast on the first
    worker exception (the caller owns pool shutdown + shard merge on both
    paths).  Results come back in submission order."""
    import concurrent.futures

    results: list[dict | None] = [None] * len(futures)
    index = {f: i for i, f in enumerate(futures)}
    for f in concurrent.futures.as_completed(futures):
        _, rd = f.result()        # re-raises the worker's exception
        results[index[f]] = rd
    return results


# ------------------------------------------------------------------- process

#: per-process worker state for the stealing scheduler (set by the pool
#: initializer in each spawned worker; module-global because pool tasks
#: can only receive picklable arguments)
_STEAL_STATE: dict = {}


def _steal_init(ctx: dict) -> None:
    """Pool initializer (runs once per spawned worker process): build the
    persistent session keyed by pid and register its flush at process exit
    — ``ProcessPoolExecutor.shutdown(wait=True)`` joins workers, so the
    parent merges only after every shard store is saved."""
    import atexit

    state = _build_worker_state(ctx, ident=os.getpid())
    _STEAL_STATE["state"] = state
    atexit.register(_close_worker_state, state)


def _steal_unit_task(unit_dict: dict) -> tuple[int, dict]:
    return _run_state_unit(_STEAL_STATE["state"], unit_dict)


def _run_process_static(plan: ExecutionPlan) -> list[UnitResult]:
    """The static schedule: one round-robin payload per worker, submitted to
    a spawn pool and drained ``as_completed`` with fail-fast semantics."""
    import concurrent.futures
    import multiprocessing

    spec_dict = _check_shippable(plan.session)
    payloads = _make_payloads(plan, spec_dict)
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=len(payloads),
        mp_context=multiprocessing.get_context("spawn"),
    )
    try:
        futures = [pool.submit(_unit_worker, p) for p in payloads]
        worker_results = _drain_futures(plan, payloads, futures)
    finally:
        pool.shutdown()
    return _collect(plan, payloads, worker_results)


def _run_process(plan: ExecutionPlan) -> list[UnitResult]:
    """Spawn-process fan-out.  Stealing (default): persistent per-process
    sessions pull units from the shared pool queue; static: the
    one-payload-per-worker partition."""
    if plan.scheduler == "static":
        return _run_process_static(plan)
    import concurrent.futures
    import multiprocessing

    spec_dict = _check_shippable(plan.session)
    ctx = _steal_context(plan, spec_dict)
    n = max(1, min(plan.max_workers, len(plan.units)))
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=n,
        mp_context=multiprocessing.get_context("spawn"),
        initializer=_steal_init,
        initargs=(ctx,),
    )
    try:
        futures = [
            pool.submit(_steal_unit_task, u.to_dict()) for u in plan.units
        ]
        try:
            dicts = _drain_steal(futures)
        except BaseException:
            for f in futures:
                f.cancel()
            # join workers first (their exit handlers flush shard stores),
            # THEN absorb what they completed: journaled units survive
            pool.shutdown(wait=True)
            recover_shard_stores(plan.session)
            raise
    finally:
        pool.shutdown(wait=True)
    # worker pids are not known up front: the recovery glob merges them
    recover_shard_stores(plan.session)
    return [UnitResult.from_dict(d) for d in dicts]


register_executor(Executor(name="process", run=_run_process, parallel=True))


# ------------------------------------------------------------------- futures


def _run_futures(plan: ExecutionPlan) -> list[UnitResult]:
    """The generic ``concurrent.futures`` seam.  Under the stealing
    scheduler each payload carries exactly one unit, so ANY pool — thread,
    process, or remote adapter — drains the queue in completion order; under
    ``static`` one payload per worker is submitted."""
    spec_dict = _check_shippable(plan.session)
    if plan.scheduler == "static":
        payloads = _make_payloads(plan, spec_dict)
    else:
        payloads = _make_unit_payloads(plan, spec_dict)
    pool = plan.futures_pool
    owned = pool is None
    if owned:
        import concurrent.futures
        import multiprocessing

        pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=max(1, min(plan.max_workers, len(payloads))),
            mp_context=multiprocessing.get_context("spawn"),
        )
    try:
        futures = [pool.submit(_unit_worker, p) for p in payloads]
        worker_results = _drain_futures(plan, payloads, futures)
    finally:
        if owned:
            pool.shutdown()
    return _collect(plan, payloads, worker_results)


register_executor(Executor(name="futures", run=_run_futures, parallel=True))


# -------------------------------------------------------------------- device


def cuda_devices() -> list:
    """The CUDA cards the device executor fans units across."""
    import torch

    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _pin(device):
    """Make ``device`` the calling thread's current card (the CUDA current
    device is per thread); a CPU device, which only tests pass, pins
    nothing."""
    import torch

    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _device_worker(payload: dict, device) -> list[dict]:
    """One shard's units, session included, pinned to one card."""
    with _pin(device):
        return _unit_worker(payload)


def _run_device(plan: ExecutionPlan) -> list[UnitResult]:
    """Fan units across the cards of this process, one thread per card.

    Same payloads and shard-store plumbing as the process executor, but the
    workers are threads pinned to cards instead of spawned interpreters.
    Each thread's measurements launch on its card's current stream; the
    launch counters (``repro_torch.kernels.LAUNCHES``) are plain integers
    that threads on several cards could race on — exact on a one-card host.
    """
    import concurrent.futures
    import warnings

    spec_dict = _check_shippable(plan.session)
    devices = cuda_devices()
    if not devices:
        raise RuntimeError(
            "device executor: no CUDA device is available "
            "(torch.cuda.device_count() == 0); it pins one thread per card "
            "and never runs on the CPU in their place — use executor='serial'"
        )
    if plan.max_workers > len(devices):
        warnings.warn(
            f"device executor: {plan.max_workers} workers requested but only "
            f"{len(devices)} CUDA device(s) present; capping"
        )
        plan = ExecutionPlan(
            session=plan.session,
            units=plan.units,
            max_workers=len(devices),
            futures_pool=plan.futures_pool,
            scheduler=plan.scheduler,
        )
    if plan.scheduler == "static":
        payloads = _make_payloads(plan, spec_dict)
        with concurrent.futures.ThreadPoolExecutor(
            max_workers=len(payloads), thread_name_prefix="device-shard"
        ) as pool:
            futures = [
                pool.submit(_device_worker, p, devices[k])
                for k, p in enumerate(payloads)
            ]
            worker_results = _drain_futures(plan, payloads, futures)
        return _collect(plan, payloads, worker_results)
    return _run_device_steal(plan, spec_dict, devices)


def _run_device_steal(
    plan: ExecutionPlan, spec_dict: dict, devices: list
) -> list[UnitResult]:
    """Stealing schedule over card-pinned worker threads.  Each thread
    builds ONE persistent session at thread start, under its pin, and pulls
    units from the pool queue as it frees up; the worker identity is the
    card index, so shard stores use the same ``shard<k>`` names as the
    static path."""
    import concurrent.futures
    import threading

    ctx = _steal_context(plan, spec_dict)
    n = max(1, min(plan.max_workers, len(plan.units)))
    states: list[dict | None] = []
    states_lock = threading.Lock()
    tls = threading.local()

    def _thread_init() -> None:
        with states_lock:
            k = len(states)
            states.append(None)
        with _pin(devices[k]):
            state = _build_worker_state(ctx, ident=k)
        state["device"] = devices[k]
        states[k] = state
        tls.state = state

    def _thread_task(unit_dict: dict) -> tuple[int, dict]:
        state = tls.state
        with _pin(state["device"]):
            return _run_state_unit(state, unit_dict)

    pool = concurrent.futures.ThreadPoolExecutor(
        max_workers=n,
        thread_name_prefix="device-steal",
        initializer=_thread_init,
    )
    try:
        futures = [
            pool.submit(_thread_task, u.to_dict()) for u in plan.units
        ]
        try:
            dicts = _drain_steal(futures)
        except BaseException:
            for f in futures:
                f.cancel()
            pool.shutdown(wait=True)
            for s in states:
                _close_worker_state(s)
            recover_shard_stores(plan.session)
            raise
    finally:
        pool.shutdown(wait=True)
    for s in states:
        _close_worker_state(s)
    recover_shard_stores(plan.session)
    return [UnitResult.from_dict(d) for d in dicts]


register_executor(Executor(name="device", run=_run_device, parallel=True))
