"""The serving query layer: ``best_config`` and friends (a port of
``repro.serving.api``).

Resolution order for ``(kernel, x, y, device)``:

1. **hit** — an exact-geometry winner exists and is younger than
   ``max_age_s`` (one keyed store read; the hot path).
2. **stale** — an exact-geometry winner exists but is older than
   ``max_age_s``; the config is still returned (stale beats nothing) with
   the status making the age explicit.
3. **nearest** — no exact winner, but the same kernel+device has one at a
   different geometry; the closest in log-space answers.
4. **miss** — nothing to serve.  With a queue attached, a tuning job for
   the missing geometry is enqueued (idempotently) so a fleet worker can
   fill the hole; the returned ``job_id`` tracks it.

Every outcome bumps a serving counter (``serve.hits`` / ``serve.stale`` /
``serve.nearest`` / ``serve.misses`` / ``serve.enqueued``) and the
``serve.queue_depth`` gauge on the attached telemetry, and with the sink on
the query is one trace-only ``serve`` stage — observability only.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

from ..core.api import TuningSpec
from ..core.clock import monotonic
from ..core.stores import make_store
from ..telemetry.null import NULL_TELEMETRY
from .queue import JobQueue
from .winners import lookup_winner, nearest_winner, now_stamp


def store_kind_for_path(path: str) -> str:
    """Store kind from a path's extension (``.sqlite`` -> sqlite, else json)."""
    return "sqlite" if str(path).endswith(".sqlite") else "json"


def open_serve_store(path: str, kind: str | None = None):
    """Open a measurement store for serving; returns ``(store, kind)``."""
    kind = kind or store_kind_for_path(path)
    return make_store(kind, path), kind


@dataclass(frozen=True)
class ServeResult:
    """What a ``best_config`` query resolved to."""

    status: str                 # "hit" | "stale" | "nearest" | "miss"
    kernel: str
    x: int
    y: int
    device: str
    config: dict | None = None
    value: float | None = None
    fresh: float | None = None
    age_s: float | None = None
    fingerprint: str | None = None
    matched_key: str | None = None   # the winner key that answered (if any)
    job_id: str | None = None        # the job a miss enqueued (if any)

    def to_dict(self) -> dict:
        return asdict(self)


def default_miss_spec(kernel: str, x: int, y: int, device: str, *,
                      algorithms=("rs", "ga"), design=None,
                      seed: int = 0) -> TuningSpec:
    """The tuning job a miss enqueues: a smoke-design run of the missing
    problem.  A device naming a costmodel chip tunes through the analytical
    model at the kernel's workload geometry; ``"cpu"`` runs the ``cuda``
    backend's plain versions (``device="cpu"``) at ``(x, y)``; any other
    label — a card's name — is a ``cuda`` run on the card at ``(x, y)``."""
    from ..core import ExperimentDesign
    from ..costmodel import CHIPS

    if design is None:
        design = ExperimentDesign.smoke()
    if device in CHIPS:
        return TuningSpec(
            kernel=kernel, backend="costmodel",
            backend_kwargs={"chip": device},
            algorithms=tuple(algorithms), design=design, seed=seed,
            cache_key=f"{kernel}/{device}",
        )
    backend_kwargs = {"x": int(x), "y": int(y)}
    if device == "cpu":
        backend_kwargs["device"] = "cpu"
    return TuningSpec(
        kernel=kernel, backend="cuda", backend_kwargs=backend_kwargs,
        algorithms=tuple(algorithms), design=design, seed=seed,
    )


def best_config(store, kernel: str, x: int, y: int, device: str, *,
                max_age_s: float | None = None, queue: JobQueue | None = None,
                enqueue_spec: TuningSpec | None = None, telemetry=None,
                now: float | None = None) -> ServeResult:
    """Answer "give me the best config for ``(kernel, x, y, device)``".

    ``store`` is a live store handle (see :func:`open_serve_store`).
    ``max_age_s`` turns exact hits older than that into ``"stale"``.
    ``queue`` (a :class:`JobQueue`) arms enqueue-on-miss; ``enqueue_spec``
    overrides the default smoke-design job.  ``now`` pins the clock for
    age math (tests).  With telemetry on, the query is one trace-only
    ``serve`` stage (``part="query"``, with the answer's ``status``).
    """
    tel = telemetry if telemetry is not None else NULL_TELEMETRY
    t0 = monotonic() if tel.enabled else None
    res = _resolve(store, kernel, int(x), int(y), device, max_age_s, queue,
                   enqueue_spec, tel, now)
    if t0 is not None:
        tel.stage("serve", monotonic() - t0, part="query", status=res.status)
    return res


def _resolve(store, kernel: str, x: int, y: int, device: str, max_age_s, queue,
             enqueue_spec, tel, now) -> ServeResult:
    """:func:`best_config`'s resolution, with its sink in hand."""
    rec = lookup_winner(store, kernel, x, y, device)
    if rec is not None:
        t = now if now is not None else now_stamp()
        age = max(0.0, t - rec.fresh)
        stale = max_age_s is not None and age > float(max_age_s)
        tel.inc("serve.stale" if stale else "serve.hits")
        return ServeResult(
            status="stale" if stale else "hit",
            kernel=kernel, x=x, y=y, device=device,
            config=rec.config, value=rec.value, fresh=rec.fresh, age_s=age,
            fingerprint=rec.fingerprint, matched_key=rec.key,
        )
    near = nearest_winner(store, kernel, x, y, device)
    if near is not None:
        tel.inc("serve.nearest")
        return ServeResult(
            status="nearest",
            kernel=kernel, x=x, y=y, device=device,
            config=near.config, value=near.value, fresh=near.fresh,
            fingerprint=near.fingerprint, matched_key=near.key,
        )
    tel.inc("serve.misses")
    job_id = None
    if queue is not None:
        spec = enqueue_spec if enqueue_spec is not None else default_miss_spec(
            kernel, x, y, device
        )
        job_id = queue.enqueue(spec)
    if queue is not None:
        tel.gauge("serve.queue_depth", queue.depth())
    return ServeResult(
        status="miss", kernel=kernel, x=x, y=y, device=device, job_id=job_id,
    )
