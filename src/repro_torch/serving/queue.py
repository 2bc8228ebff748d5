"""The fleet job queue: tuning jobs journaled through store metadata,
claims arbitrated through ``O_EXCL`` files (a port of
``repro.serving.queue``).

A *job* is one serialized :class:`TuningSpec` pointed at the queue's shared
store.  Job records live in the store's metadata side-channel under
``__job__|<job_id>`` — the same channel the unit journal uses, so a job
survives anything the store survives.  The job id is a digest of the spec
minus its storage fields: enqueueing the same tuning problem twice is a
no-op, whatever store it was first queued against.

Work arbitration follows the reference's compile cache's discipline:

* a worker claims one :class:`ExperimentUnit` of a job by creating
  ``<qdir>/<job_id>.u<digest>.claim`` with ``O_CREAT | O_EXCL`` (the atomic
  "I own this" primitive on every filesystem);
* a claim whose mtime is older than ``claim_timeout_s`` belongs to a dead
  worker; stealing it is serialized under an advisory ``flock`` on the
  queue-wide lock file, so exactly one peer takes over;
* a finished unit publishes ``<qdir>/<job_id>.u<digest>.done`` atomically
  (tmp file + ``os.replace``) recording who ran it and whether the claim
  was stolen.

Workers never write the shared parent store — they journal into their own
namespaced shard stores (``repro_torch.core.executors.shard_store_path``),
and the owner-side :func:`repro_torch.serving.fleet.collect_jobs` absorbs those
shards, checks unit-journal coverage, and flips the job record to
``"done"``.  Determinism does the rest: every unit's values are a pure
function of the spec, so a unit re-run by a stealing peer produces the
same bytes the dead worker would have.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX hosts
    fcntl = None

from ..core.api import TuningSpec
from ..core.stores import make_store
from ..core.workunits import unit_digest
from ..telemetry.null import NULL_TELEMETRY

#: store-metadata prefix for job records (the unit journal owns ``__unit__``)
JOB_META_PREFIX = "__job__|"

#: deterministic work-unit decomposition for fleet jobs: fixed, NOT derived
#: from the (elastic) worker count, so every worker and the collector build
#: the identical unit list for a job
FLEET_MIN_UNITS = 8


def job_id_for_spec(spec_dict: dict) -> str:
    """Digest of the spec minus storage fields: the same tuning problem maps
    to the same job id whichever store serves it."""
    d = {k: v for k, v in spec_dict.items() if k not in ("store", "store_path")}
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:12]


class JobQueue:
    """Enqueue / claim / publish over one shared store + one claim dir.

    ``store`` is a live store handle (the owner's — pass the same object the
    serving layer reads through, so JSON-store saves never clobber each
    other); :meth:`open` builds its own handle from ``(kind, path)`` for
    worker processes.
    """

    def __init__(self, store, store_kind: str, store_path: str, qdir: str, *,
                 claim_timeout_s: float = 60.0, poll_s: float = 0.05,
                 telemetry=None):
        self.store = store
        self.store_kind = str(store_kind)
        self.store_path = str(store_path)
        self.qdir = str(qdir)
        self.claim_timeout_s = float(claim_timeout_s)
        self.poll_s = float(poll_s)
        self.telemetry = telemetry if telemetry is not None else NULL_TELEMETRY
        os.makedirs(self.qdir, exist_ok=True)

    @classmethod
    def open(cls, store_kind: str, store_path: str, qdir: str, **kwargs
             ) -> "JobQueue":
        return cls(make_store(store_kind, store_path), store_kind, store_path,
                   qdir, **kwargs)

    def close(self) -> None:
        if hasattr(self.store, "close"):
            self.store.close()

    # -- job records -----------------------------------------------------------
    def enqueue(self, spec: TuningSpec, *, min_units: int = FLEET_MIN_UNITS
                ) -> str:
        """Queue one tuning job (idempotent: re-enqueueing the same problem
        returns the existing job id untouched).  The job's spec is re-pointed
        at the queue's shared store so every worker resolves the same parent."""
        spec = spec.replace(store=self.store_kind, store_path=self.store_path)
        d = spec.to_dict()
        jid = job_id_for_spec(d)
        meta_key = JOB_META_PREFIX + jid
        if self.store.get_meta(meta_key) is None:
            payload = {
                "id": jid,
                "spec": d,
                "min_units": int(min_units),
                "state": "pending",
                # wall stamp: queue bookkeeping, never part of a measurement
                "fresh": time.time(),  # repro: allow[DET001]
            }
            self.store.put_meta(meta_key, json.dumps(payload, sort_keys=True))
            self.store.save()
            self.telemetry.inc("serve.enqueued")
        self.telemetry.gauge("serve.queue_depth", self.depth())
        return jid

    def jobs(self) -> list[dict]:
        out = []
        for key, note in self.store.meta_items(JOB_META_PREFIX):
            try:
                d = json.loads(note)
            except ValueError:
                continue
            if isinstance(d, dict) and d.get("id"):
                out.append(d)
        return sorted(out, key=lambda d: str(d["id"]))

    def job(self, jid: str) -> dict | None:
        note = self.store.get_meta(JOB_META_PREFIX + jid)
        if note is None:
            return None
        try:
            d = json.loads(note)
        except ValueError:
            return None
        return d if isinstance(d, dict) else None

    def pending_jobs(self) -> list[dict]:
        return [d for d in self.jobs() if d.get("state") == "pending"]

    def depth(self) -> int:
        return len(self.pending_jobs())

    def mark_done(self, jid: str, *, ident: str = "") -> None:
        """Owner-side: flip a job record to done (after coverage checked)."""
        job = self.job(jid)
        if job is None:
            return
        job["state"] = "done"
        job["done_ident"] = str(ident)
        job["fresh"] = time.time()  # repro: allow[DET001] (bookkeeping stamp)
        self.store.put_meta(JOB_META_PREFIX + jid, json.dumps(job, sort_keys=True))
        self.store.save()

    # -- unit claims (O_EXCL create, stale-claim steal, per unit) -------------
    def _claim_path(self, jid: str, unit_key: str) -> str:
        return os.path.join(self.qdir, f"{jid}.u{unit_digest(unit_key)}.claim")

    def _done_path(self, jid: str, unit_key: str) -> str:
        return os.path.join(self.qdir, f"{jid}.u{unit_digest(unit_key)}.done")

    def _locked(self):
        return _flocked(os.path.join(self.qdir, ".lock"))

    def claim_unit(self, jid: str, unit_key: str, ident: str) -> str | None:
        """Try to own one unit.  ``"fresh"``: clean claim; ``"stolen"``: a
        dead worker's stale claim was removed first; ``None``: a live peer
        holds it."""
        os.makedirs(self.qdir, exist_ok=True)
        path = self._claim_path(jid, unit_key)
        stole = False
        for attempt in range(2):
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                if attempt or not self._steal_stale_claim(path):
                    return None
                stole = True
                continue  # stale claim removed — race for a fresh one
            with os.fdopen(fd, "w") as f:
                f.write(str(ident))
            return "stolen" if stole else "fresh"
        return None

    def _steal_stale_claim(self, path: str) -> bool:
        """Remove ``path`` if its holder looks dead (mtime older than the
        claim timeout); serialized under the queue lock so at most one peer
        steals.  Wall clock against file mtime: pure liveness policy."""
        now = time.time()  # repro: allow[DET001] (compared with a file mtime)
        try:
            age = now - os.path.getmtime(path)
        except OSError:
            return True  # already released
        if age <= self.claim_timeout_s:
            return False
        with self._locked():
            try:
                if now - os.path.getmtime(path) > self.claim_timeout_s:
                    os.remove(path)
            except OSError:
                pass  # another peer stole it first — equally gone
        return not os.path.exists(path)

    def release_unit(self, jid: str, unit_key: str) -> None:
        try:
            os.remove(self._claim_path(jid, unit_key))
        except OSError:
            pass

    def heartbeat_unit(self, jid: str, unit_key: str) -> None:
        """Refresh the claim mtime so long units aren't stolen mid-run."""
        try:
            os.utime(self._claim_path(jid, unit_key))
        except OSError:
            pass

    def unit_claimed(self, jid: str, unit_key: str) -> bool:
        return os.path.exists(self._claim_path(jid, unit_key))

    def write_unit_done(self, jid: str, unit_key: str, payload: dict) -> None:
        """Atomically publish a unit-done marker (tmp + ``os.replace``)."""
        os.makedirs(self.qdir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.qdir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, sort_keys=True)
            os.replace(tmp, self._done_path(jid, unit_key))
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    def unit_done(self, jid: str, unit_key: str) -> dict | None:
        try:
            with open(self._done_path(jid, unit_key)) as f:
                d = json.load(f)
        except (OSError, ValueError):
            return None
        return d if isinstance(d, dict) else None

    def cleanup_job_files(self, jid: str) -> None:
        """Owner-side: drop a finished job's claim/done files."""
        for f in os.listdir(self.qdir):
            if f.startswith(f"{jid}.u"):
                try:
                    os.remove(os.path.join(self.qdir, f))
                except OSError:
                    pass


class _flocked:
    """Advisory exclusive lock on ``path`` (no-op where ``fcntl`` is
    unavailable — O_EXCL/rename atomicity still holds; only the stale-claim
    steal gets racier)."""

    def __init__(self, path: str):
        self.path = path
        self._fd: int | None = None

    def __enter__(self):
        if fcntl is None:  # pragma: no cover - non-POSIX hosts
            return self
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fd = os.open(self.path, os.O_CREAT | os.O_RDWR)
        fcntl.flock(self._fd, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        if self._fd is not None:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None
        return False
