"""Fleet workers: claim queued tuning jobs unit by unit, from any host (a
port of ``repro.serving.fleet``).

A worker never shares a parent process with the queue owner — it rebuilds a
:class:`TuningSession` from each job's serialized spec, seeds a private
shard store (``<parent>.<ns8>.shard<ident>``, the executor layer's
namespaced shard naming) from the warm parent store, and journals every
completed :class:`ExperimentUnit` into it.  Claims, steals, and done
markers go through :class:`repro_torch.serving.queue.JobQueue`.  A
``cuda`` job measures on the worker's card (``CudaMeasurement`` raises
where there is none — a worker never runs the plain versions in its
place); only a job whose spec says ``device="cpu"`` runs them.

With telemetry on, a worker's own work around the units it runs is traced
as trace-only ``fleet`` stages (``repro_torch.telemetry.events.HOST_STAGES``):
its sessions for a job built and seeded, its claims, its journal lookups and
its done markers; its shard session's record of each unit it ran (the
journal's put, the store's save) is a ``session`` stage, as
``TuningSession.run``'s record of its run is; :func:`collect_jobs` is one
``serve`` stage.

Crash semantics are the executor layer's kill-and-resume guarantee lifted
across hosts: a SIGKILLed worker leaves (a) a stale claim a peer steals
after ``claim_timeout_s`` and (b) a shard store whose journal holds
everything it finished.  The peer re-runs only the claimed-but-unfinished
unit; determinism (``stable_seed`` per experiment) makes its values
byte-identical to what the dead worker would have produced, so the
collected parent store is byte-identical to a serial run of the same spec.

:func:`collect_jobs` is the owner side: absorb this spec's shards, check
unit-journal coverage, refresh the winners index, and flip the job record
to ``"done"``.  Run it when workers are idle — absorbing a shard removes
the file.
"""

from __future__ import annotations

import os
import re
import socket
import time

from ..core.api import TuningSession, TuningSpec
from ..core.clock import monotonic
from ..core.executors import absorb_store, recover_shard_stores, shard_store_path
from ..core.workunits import build_units
from ..telemetry.null import NULL_TELEMETRY
from .queue import FLEET_MIN_UNITS, JobQueue
from .winners import record_session_winner


def default_worker_ident() -> str:
    """Fleet-unique worker identity: ``<host>-<pid>``, filesystem- and
    shard-name-safe (the shard glob admits ``[A-Za-z0-9_-]``)."""
    host = re.sub(r"[^A-Za-z0-9_-]", "-", socket.gethostname()) or "host"
    return f"{host}-{os.getpid()}"


def job_units(session: TuningSession, job: dict) -> list:
    """The job's deterministic unit decomposition — a property of the JOB
    (``min_units`` rides in the job record), not of whoever runs it, so
    every worker and the collector agree on the unit list."""
    return build_units(
        session.cells(),
        min_units=int(job.get("min_units", FLEET_MIN_UNITS)),
        cost=session._unit_cost(),
    )


class FleetWorker:
    """One worker process draining a shared job queue.

    ``stall_s`` is a test seam: sleep that long after every claim, before
    running the unit — the window chaos tests SIGKILL a worker in.
    """

    def __init__(self, store_kind: str, store_path: str, qdir: str, *,
                 ident: str | None = None, claim_timeout_s: float = 60.0,
                 poll_s: float = 0.05, stall_s: float = 0.0, telemetry=None):
        self.store_kind = str(store_kind)
        self.store_path = str(store_path)
        self.qdir = str(qdir)
        self.ident = ident if ident is not None else default_worker_ident()
        if not re.fullmatch(r"[A-Za-z0-9_-]+", self.ident):
            raise ValueError(
                f"worker ident {self.ident!r} must match [A-Za-z0-9_-]+ "
                "(it names the shard store file)"
            )
        self.claim_timeout_s = float(claim_timeout_s)
        self.poll_s = float(poll_s)
        self.stall_s = float(stall_s)
        self.telemetry = telemetry if telemetry is not None else NULL_TELEMETRY
        self._jobs: dict[str, dict] = {}        # jid -> worker-side job state
        self._completed: set[str] = set()

    # -- internals -------------------------------------------------------------
    def _clock(self) -> float | None:
        """A worker stage's start, or ``None`` with the sink off (no read)."""
        return monotonic() if self.telemetry.enabled else None

    def _stage(self, part: str, t0: float | None, jid: str | None = None,
               stage: str = "fleet") -> None:
        """One trace-only ``fleet`` (or ``session``) stage from ``t0`` to
        now; nothing where ``t0`` is ``None`` (the sink is off)."""
        if t0 is not None:
            self.telemetry.stage(stage, monotonic() - t0, part=part, job=jid,
                                 ident=self.ident)

    def _open_queue(self) -> JobQueue:
        return JobQueue.open(
            self.store_kind, self.store_path, self.qdir,
            claim_timeout_s=self.claim_timeout_s, poll_s=self.poll_s,
            telemetry=self.telemetry,
        )

    def _job_state(self, job: dict) -> dict:
        jid = str(job["id"])
        state = self._jobs.get(jid)
        if state is not None:
            return state
        t0 = self._clock()
        spec = TuningSpec.from_dict(job["spec"])
        parent = TuningSession(spec)     # read-only: units + shard namespace
        units = job_units(parent, job)
        shard = shard_store_path(parent, self.ident)
        if hasattr(parent.store, "close"):
            parent.store.close()
        wsession = TuningSession(spec, store_path=shard,
                                 telemetry=self.telemetry)
        if (wsession.store is not None and spec.store_path
                and os.path.exists(spec.store_path)):
            # seed from the warm parent: previously-measured entries are
            # served as hits, so a resumed fleet re-measures nothing
            absorb_store(wsession.store, spec.store, spec.store_path)
        state = {
            "units": units,
            "wsession": wsession,
            "journal": wsession.unit_journal(),
        }
        self._jobs[jid] = state
        self._stage("seed", t0, jid)
        return state

    def _work_job(self, queue: JobQueue, job: dict) -> tuple[bool, bool]:
        """Claim and run what we can of one job.  Returns
        ``(ran_any_unit, job_complete)``."""
        jid = str(job["id"])
        state = self._job_state(job)
        ran = False
        for unit in state["units"]:
            t0 = self._clock()
            claim = (None if queue.unit_done(jid, unit.key) is not None
                     else queue.claim_unit(jid, unit.key, self.ident))
            self._stage("claim", t0, jid)
            if claim is None:
                continue
            try:
                if claim == "stolen":
                    self.telemetry.inc("fleet.steals")
                if self.stall_s:
                    time.sleep(self.stall_s)   # chaos-test kill window
                t0 = self._clock()
                covered = (state["journal"].cover(unit)
                           if state["journal"] is not None else None)
                self._stage("journal", t0, jid)
                if covered is None:
                    with self.telemetry.span("fleet_unit", unit=unit.key,
                                             job=jid, ident=self.ident):
                        result = state["wsession"].run_unit(unit)
                t0 = self._clock()
                if covered is None:
                    if state["journal"] is not None:
                        state["journal"].put(result)
                    self.telemetry.inc("fleet.units_run")
                state["wsession"].save_store()
                self._stage("record", t0, jid, stage="session")
                t0 = self._clock()
                queue.write_unit_done(jid, unit.key, {
                    "ident": self.ident,
                    "stolen": claim == "stolen",
                    "unit": unit.key,
                })
                ran = True
            finally:
                queue.release_unit(jid, unit.key)
            self._stage("done", t0, jid)
        t0 = self._clock()
        complete = all(
            queue.unit_done(jid, u.key) is not None for u in state["units"]
        )
        if complete and jid not in self._completed:
            self._completed.add(jid)
            self.telemetry.inc("fleet.jobs_completed")
        self._stage("done", t0, jid)
        return ran, complete

    def _close_jobs(self) -> None:
        t0 = self._clock()
        for state in self._jobs.values():
            wsession = state["wsession"]
            wsession.save_store()
            if wsession.store is not None and hasattr(wsession.store, "close"):
                wsession.store.close()
        self._jobs.clear()
        self._stage("record", t0, stage="session")

    # -- public ----------------------------------------------------------------
    def run_once(self) -> bool:
        """One pass over pending jobs; ``True`` if any unit ran here."""
        queue = self._open_queue()
        try:
            ran = False
            for job in queue.pending_jobs():
                ran_job, _ = self._work_job(queue, job)
                ran = ran or ran_job
            return ran
        finally:
            queue.close()

    def drain(self, *, max_jobs: int | None = None,
              timeout_s: float | None = None) -> int:
        """Work until every pending job is unit-complete (all done markers
        present — a peer may have run some units), ``max_jobs`` jobs
        completed, or ``timeout_s`` elapsed.  Returns completed-job count."""
        completed = 0
        deadline = None if timeout_s is None else monotonic() + timeout_s
        try:
            while True:
                t0 = self._clock()
                queue = self._open_queue()
                try:
                    actionable = [
                        j for j in queue.pending_jobs()
                        if str(j["id"]) not in self._completed
                    ]
                    self._stage("claim", t0)
                    if not actionable:
                        return completed
                    ran = False
                    for job in actionable:
                        ran_job, complete = self._work_job(queue, job)
                        ran = ran or ran_job
                        if complete:
                            completed += 1
                            if max_jobs is not None and completed >= max_jobs:
                                return completed
                finally:
                    t0 = self._clock()
                    queue.close()
                    self._stage("claim", t0)
                if deadline is not None and monotonic() >= deadline:
                    return completed
                if not ran:
                    # peers hold the remaining claims: wait for their done
                    # markers, or for their claims to go stale and be stolen
                    time.sleep(self.poll_s)
        finally:
            self._close_jobs()


def collect_jobs(store_kind: str, store_path: str, qdir: str, *,
                 telemetry=None) -> list[str]:
    """Owner-side collection: for every pending job whose units are fully
    journaled across this spec's shard stores, absorb the shards into the
    parent store, refresh the winners index, flip the job to ``"done"``, and
    drop its claim/done files.  Returns the collected job ids.  With
    telemetry on, the whole collection is one trace-only ``serve`` stage
    (``part="collect"``, with the number of ``jobs`` collected)."""
    tel = telemetry if telemetry is not None else NULL_TELEMETRY
    t0 = monotonic() if tel.enabled else None
    queue = JobQueue.open(store_kind, store_path, qdir, telemetry=tel)
    try:
        jobs = queue.pending_jobs()
    finally:
        queue.close()
    collected: list[str] = []
    for job in jobs:
        jid = str(job["id"])
        spec = TuningSpec.from_dict(job["spec"])
        session = TuningSession(spec, telemetry=tel)
        try:
            recover_shard_stores(session)    # namespaced: only OUR shards
            journal = session.unit_journal()
            if journal is None:
                continue
            _, pending = journal.partition(job_units(session, job))
            if pending:
                continue                     # workers still have units to run
            session.save_store()
            record_session_winner(session)
            # mark done through the session's own handle so a JSON store's
            # whole-file save can't clobber the absorbed measurements
            owner_q = JobQueue(session.store, store_kind, store_path, qdir,
                               telemetry=tel)
            owner_q.mark_done(jid, ident="collect")
            owner_q.cleanup_job_files(jid)
            collected.append(jid)
            tel.inc("fleet.jobs_collected")
        finally:
            if session.store is not None and hasattr(session.store, "close"):
                session.store.close()
    if t0 is not None:
        tel.stage("serve", monotonic() - t0, part="collect", jobs=len(collected))
    return collected
