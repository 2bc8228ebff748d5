"""Tuning-as-a-service: serve tuned winners, enqueue what's missing (a port
of ``repro.serving``).

The paper's result — which search algorithm wins depends on the sample
budget — only pays off in production if tuned configurations are *served*
rather than rediscovered per process tree.  This package layers three
pieces over the measurement store:

* :mod:`repro_torch.serving.winners` — a per-``(kernel, x, y, device)``
  best-config index living in the store itself (a ``winners`` table in the
  sqlite backend, a ``"winners"`` mapping in the JSON format), maintained
  transactionally as :class:`~repro_torch.core.api.TuningSession` records
  results.  A ``cuda`` winner's device is the card's name.
* :mod:`repro_torch.serving.api` — the query layer: :func:`best_config`
  answers instantly on an exact-geometry hit, falls back to the nearest
  geometry, and on a miss optionally enqueues an async tuning job.
  ``repro_torch.serve`` re-exports it as the stable entry point.
* :mod:`repro_torch.serving.queue` / :mod:`repro_torch.serving.fleet` — a
  shared-store work queue with ``O_EXCL`` claims and stale-claim steals, so
  fleet workers on any host can claim
  :class:`~repro_torch.core.workunits.ExperimentUnit` jobs, crash, and be
  resumed by peers; a ``cuda`` job is tuned on the worker's card.

``python -m repro_torch.serving`` exposes the whole flow (HTTP endpoint,
query, enqueue, jobs, worker, collect, replay) on the command line.
"""

from .api import ServeResult, best_config, default_miss_spec, open_serve_store
from .fleet import FleetWorker, collect_jobs
from .queue import JobQueue, job_id_for_spec
from .winners import (
    WinnerRecord,
    all_winners,
    device_label,
    index_winners,
    lookup_winner,
    nearest_winner,
    record_session_winner,
    record_winner,
    spec_geometry,
)

__all__ = [
    "FleetWorker",
    "JobQueue",
    "ServeResult",
    "WinnerRecord",
    "all_winners",
    "best_config",
    "collect_jobs",
    "default_miss_spec",
    "device_label",
    "index_winners",
    "job_id_for_spec",
    "lookup_winner",
    "nearest_winner",
    "open_serve_store",
    "record_session_winner",
    "record_winner",
    "spec_geometry",
]
