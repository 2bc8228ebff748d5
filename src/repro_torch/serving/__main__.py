"""Command-line surface for tuning-as-a-service (a port of
``python -m repro.serving``).

A *serve dir* is one directory holding the serving store (``store.sqlite``
by default — WAL-mode sqlite, safe for concurrent readers) and the fleet
claim dir (``queue/``)::

    python -m repro_torch.serving index  --dir serve results/harris_cold.json
    python -m repro_torch.serving query  --dir serve --kernel harris --x 8192 \\
        --y 8192 --device "NVIDIA H100 80GB HBM3" --expect hit --max-ms 10
    python -m repro_torch.serving enqueue --dir serve --kernel mandelbrot \\
        --x 8192 --y 8192 --device "NVIDIA H100 80GB HBM3"
    python -m repro_torch.serving worker --dir serve --max-jobs 1 --telemetry
    python -m repro_torch.serving collect --dir serve
    python -m repro_torch.serving serve  --dir serve --port 8777

``--device`` is a winner's label: a cost-model chip (``v5e``...), ``cpu``
(the kernels' plain versions) or a card's name as
``torch.cuda.get_device_name`` gives it.  ``worker`` measures a ``cuda`` job
on the card and raises where there is none; its last line names the
kernel launches it made.  ``query`` prints the :class:`ServeResult` JSON
(plus ``serve_ms``, the time of the lookup against a cold store handle);
``--expect STATUS`` and ``--max-ms N`` turn it into an assertion for CI.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..core.clock import monotonic


def _store_path(args) -> str:
    ext = "sqlite" if args.store == "sqlite" else "json"
    return os.path.join(args.dir, f"store.{ext}")


def _qdir(args) -> str:
    return os.path.join(args.dir, "queue")


def _open(args):
    from .api import open_serve_store

    os.makedirs(args.dir, exist_ok=True)
    return open_serve_store(_store_path(args), args.store)


def _telemetry(args, src: str):
    if not getattr(args, "telemetry", False):
        return None
    from ..telemetry.tracer import Telemetry

    return Telemetry(
        getattr(args, "trace", None) or os.path.join(args.dir, "trace.jsonl"),
        src=src,
    )


def cmd_index(args) -> int:
    from .api import store_kind_for_path
    from .winners import index_winners

    store, kind = _open(args)
    from ..core.stores import make_store

    total = 0
    for src_path in args.sources:
        src = make_store(store_kind_for_path(src_path), src_path)
        n = index_winners(store, src, save=False)
        if hasattr(src, "close"):
            src.close()
        print(f"[serving] indexed {n} winner(s) from {src_path}")
        total += n
    store.save()
    if hasattr(store, "close"):
        store.close()
    print(f"[serving] winners index <- {total} record(s) ({kind})")
    return 0


def cmd_query(args) -> int:
    from .api import best_config, open_serve_store
    from .queue import JobQueue

    tel = _telemetry(args, src="serve-query")
    t0 = monotonic()
    # a COLD query: open the store handle and resolve, end to end
    store, kind = open_serve_store(_store_path(args), args.store)
    queue = None
    if args.enqueue:
        queue = JobQueue(store, kind, _store_path(args), _qdir(args),
                         telemetry=tel)
    res = best_config(store, args.kernel, args.x, args.y, args.device,
                      max_age_s=args.max_age_s, queue=queue, telemetry=tel)
    ms = (monotonic() - t0) * 1e3
    if hasattr(store, "close"):
        store.close()
    if tel is not None:
        tel.close()
    out = res.to_dict()
    out["serve_ms"] = round(ms, 3)
    print(json.dumps(out, sort_keys=True))
    if args.expect is not None and res.status != args.expect:
        print(f"[serving] FAIL: expected status {args.expect!r}, "
              f"got {res.status!r}", file=sys.stderr)
        return 2
    if args.max_ms is not None and ms > args.max_ms:
        print(f"[serving] FAIL: query took {ms:.3f} ms "
              f"(limit {args.max_ms} ms)", file=sys.stderr)
        return 3
    return 0


def cmd_enqueue(args) -> int:
    from .api import default_miss_spec
    from .queue import JobQueue

    store, kind = _open(args)
    queue = JobQueue(store, kind, _store_path(args), _qdir(args))
    spec = default_miss_spec(args.kernel, args.x, args.y, args.device)
    jid = queue.enqueue(spec)
    if hasattr(store, "close"):
        store.close()
    print(jid)
    return 0


def cmd_jobs(args) -> int:
    from .queue import JobQueue

    store, kind = _open(args)
    queue = JobQueue(store, kind, _store_path(args), _qdir(args))
    for job in queue.jobs():
        print(json.dumps({"id": job["id"], "state": job.get("state"),
                          "kernel": job["spec"].get("kernel")},
                         sort_keys=True))
    if hasattr(store, "close"):
        store.close()
    return 0


def cmd_worker(args) -> int:
    from ..kernels import LAUNCHES
    from .fleet import FleetWorker

    tel = _telemetry(args, src=f"fleet-{args.ident or 'worker'}")
    worker = FleetWorker(
        args.store, _store_path(args), _qdir(args),
        ident=args.ident, claim_timeout_s=args.claim_timeout_s,
        poll_s=args.poll_s, stall_s=args.stall_s, telemetry=tel,
    )
    n = worker.drain(max_jobs=args.max_jobs, timeout_s=args.timeout_s)
    if tel is not None:
        tel.close()
    launches = {k: c.n for k, c in LAUNCHES.items()}
    print(f"[serving] worker {worker.ident}: {n} job(s) completed, "
          f"launches {json.dumps(launches, sort_keys=True)}")
    return 0


def cmd_collect(args) -> int:
    from .fleet import collect_jobs

    tel = _telemetry(args, src="serve-collect")
    done = collect_jobs(args.store, _store_path(args), _qdir(args),
                        telemetry=tel)
    if tel is not None:
        tel.close()
    print(f"[serving] collected {len(done)} job(s): {', '.join(done) or '-'}")
    return 0


def cmd_replay(args) -> int:
    """Serially re-run a job's spec into a fresh store — the byte-identity
    reference for the fleet's merged store."""
    from ..core.api import TuningSession, TuningSpec
    from .api import store_kind_for_path
    from .queue import JobQueue

    store, kind = _open(args)
    queue = JobQueue(store, kind, _store_path(args), _qdir(args))
    job = queue.job(args.job)
    if hasattr(store, "close"):
        store.close()
    if job is None:
        print(f"[serving] no job {args.job!r}", file=sys.stderr)
        return 1
    spec = TuningSpec.from_dict(job["spec"]).replace(
        store=store_kind_for_path(args.out), store_path=args.out,
    )
    TuningSession(spec).run_matrix()
    print(f"[serving] replayed job {args.job} -> {args.out}")
    return 0


def cmd_serve(args) -> int:
    from .http import ServingState, make_server
    from .queue import JobQueue

    tel = _telemetry(args, src="serve-http")
    store, kind = _open(args)
    queue = JobQueue(store, kind, _store_path(args), _qdir(args),
                     telemetry=tel)
    state = ServingState(store, queue=queue, telemetry=tel)
    server = make_server(state, host=args.host, port=args.port)
    host, port = server.server_address[:2]
    print(f"[serving] http://{host}:{port} over {_store_path(args)} ({kind})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if hasattr(store, "close"):
            store.close()
        if tel is not None:
            tel.close()
    return 0


def _add_dir(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dir", required=True, help="serve dir (store + queue/)")
    p.add_argument("--store", choices=("sqlite", "json"), default="sqlite",
                   help="serving store backend (sqlite: WAL-mode, safe for "
                        "concurrent readers — the default)")


def _add_geometry(p: argparse.ArgumentParser) -> None:
    p.add_argument("--kernel", required=True)
    p.add_argument("--x", type=int, required=True)
    p.add_argument("--y", type=int, required=True)
    p.add_argument("--device", required=True,
                   help="a cost-model chip's name, 'cpu', or a card's name "
                        "(torch.cuda.get_device_name)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serving")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("index", help="fold winners from tuned stores into "
                                     "the serving store")
    _add_dir(p)
    p.add_argument("sources", nargs="+", help="tuned combo store files")
    p.set_defaults(fn=cmd_index)

    p = sub.add_parser("query", help="resolve best_config once (CI-friendly: "
                                     "--expect / --max-ms assert)")
    _add_dir(p)
    _add_geometry(p)
    p.add_argument("--max-age-s", type=float, default=None)
    p.add_argument("--enqueue", action="store_true",
                   help="on miss, enqueue a tuning job for the geometry")
    p.add_argument("--expect",
                   choices=("hit", "stale", "nearest", "miss"), default=None)
    p.add_argument("--max-ms", type=float, default=None)
    p.add_argument("--telemetry", action="store_true")
    p.add_argument("--trace", default=None)
    p.set_defaults(fn=cmd_query)

    p = sub.add_parser("enqueue", help="queue a tuning job for a geometry")
    _add_dir(p)
    _add_geometry(p)
    p.set_defaults(fn=cmd_enqueue)

    p = sub.add_parser("jobs", help="list queued jobs")
    _add_dir(p)
    p.set_defaults(fn=cmd_jobs)

    p = sub.add_parser("worker", help="run a fleet worker until the queue "
                                      "drains (or --max-jobs / --timeout-s)")
    _add_dir(p)
    p.add_argument("--ident", default=None)
    p.add_argument("--max-jobs", type=int, default=None)
    p.add_argument("--timeout-s", type=float, default=None)
    p.add_argument("--claim-timeout-s", type=float, default=60.0)
    p.add_argument("--poll-s", type=float, default=0.05)
    p.add_argument("--stall-s", type=float, default=0.0,
                   help="test seam: sleep after each claim before running "
                        "(the chaos tests' kill window)")
    p.add_argument("--telemetry", action="store_true")
    p.add_argument("--trace", default=None)
    p.set_defaults(fn=cmd_worker)

    p = sub.add_parser("collect", help="absorb finished workers' shards, "
                                       "refresh winners, mark jobs done")
    _add_dir(p)
    p.add_argument("--telemetry", action="store_true")
    p.add_argument("--trace", default=None)
    p.set_defaults(fn=cmd_collect)

    p = sub.add_parser("replay", help="serially re-run a job into --out (the "
                                      "byte-identity reference store)")
    _add_dir(p)
    p.add_argument("--job", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_replay)

    p = sub.add_parser("serve", help="stdlib JSON endpoint over best_config")
    _add_dir(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8777)
    p.add_argument("--telemetry", action="store_true")
    p.add_argument("--trace", default=None)
    p.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
