"""A stdlib JSON endpoint over :func:`best_config` — no dependencies, one
thread per request (``ThreadingHTTPServer``), a lock around the shared
store handle (a copy of ``repro.serving.http``).

Routes::

    GET /best_config?kernel=harris&x=8192&y=8192&device=<label>[&max_age_s=...]
    GET /healthz
    GET /stats

``/best_config`` always answers 200 with a :class:`ServeResult` JSON body —
a miss is an answer (status ``"miss"``, plus the enqueued ``job_id`` when a
queue is attached), not an error.  400 covers malformed queries only.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..telemetry.null import NULL_TELEMETRY
from .api import best_config


class ServingState:
    """What the handler threads share: the store, the optional queue, the
    telemetry sink, and the lock serializing store access."""

    def __init__(self, store, *, queue=None, telemetry=None):
        self.store = store
        self.queue = queue
        self.telemetry = telemetry if telemetry is not None else NULL_TELEMETRY
        self.lock = threading.Lock()


class ServingHandler(BaseHTTPRequestHandler):
    # quiet by default; the telemetry trace is the observability channel
    def log_message(self, fmt, *args):  # noqa: ARG002 - stdlib signature
        pass

    @property
    def state(self) -> ServingState:
        return self.server.serving_state  # type: ignore[attr-defined]

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload, sort_keys=True).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 - stdlib handler name
        url = urlparse(self.path)
        if url.path == "/healthz":
            self._reply(200, {"ok": True})
            return
        if url.path == "/stats":
            st = self.state
            with st.lock:
                winners = sum(1 for _ in st.store.winner_items())
                depth = st.queue.depth() if st.queue is not None else 0
            self._reply(200, {
                "winners": winners,
                "queue_depth": depth,
                "counters": st.telemetry.counters_snapshot(),
            })
            return
        if url.path == "/best_config":
            q = parse_qs(url.query)

            def one(name, default=None):
                vals = q.get(name)
                return vals[0] if vals else default

            kernel = one("kernel")
            device = one("device")
            try:
                x = int(one("x", ""))
                y = int(one("y", ""))
            except ValueError:
                x = y = None
            if not kernel or not device or x is None or y is None:
                self._reply(400, {"error": "kernel, x, y, device are required"})
                return
            max_age = one("max_age_s")
            try:
                max_age_s = float(max_age) if max_age is not None else None
            except ValueError:
                self._reply(400, {"error": "max_age_s must be a number"})
                return
            st = self.state
            with st.lock:
                res = best_config(
                    st.store, kernel, x, y, device,
                    max_age_s=max_age_s, queue=st.queue,
                    telemetry=st.telemetry,
                )
            self._reply(200, res.to_dict())
            return
        self._reply(404, {"error": f"no route {url.path!r}"})


def make_server(state: ServingState, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Build (but don't start) the endpoint; ``port=0`` picks a free port
    (read it back from ``server.server_address``)."""
    server = ThreadingHTTPServer((host, port), ServingHandler)
    server.serving_state = state  # type: ignore[attr-defined]
    return server
