"""The winners index: per-geometry best configs living in the store (a port
of ``repro.serving.winners``).

Schema — one record per geometry key::

    <kernel>|x=<x>|y=<y>|<device>  ->  {"config": {...}, "value": <seconds>,
                                        "fingerprint": "<spec digest>",
                                        "fresh": <unix stamp>,
                                        "source": "<cache_key>",
                                        "store_key": "<measurement key>"}

The record rides the store's winners side-channel (``winners`` table in
sqlite, ``"winners"`` mapping in JSON format 3) and is written by
:func:`record_session_winner` right after a :class:`TuningSession` saves
its measurements — same store, same save, so a winner never points at
measurements the store doesn't hold.  Concurrent writers and shard merges
resolve through :func:`repro_torch.core.stores.merge_winner_payloads`: the
lower value wins and the freshness stamp never moves backwards.

The ``<device>`` of a winner is where it was measured: a cost-model chip's
name, ``"cpu"`` for the kernels' plain versions, and for a ``cuda`` winner
the card's name as ``torch.cuda.get_device_name`` gives it (e.g. ``NVIDIA
H100 80GB HBM3``) — the counterpart of the reference's device kind.  A
winner therefore never answers a query for another device.

Freshness is a wall-clock stamp (serving liveness policy, never part of any
measured value).
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, replace

from ..core.stores import merge_winner_payloads


def now_stamp() -> float:
    """Wall-clock freshness stamp (seconds since the epoch)."""
    # liveness policy: a winner's age is wall time, never a measured value
    return time.time()  # repro: allow[DET001]


# ------------------------------------------------------------------ records


@dataclass(frozen=True)
class WinnerRecord:
    """One served winner: the best known config for a geometry."""

    kernel: str
    x: int
    y: int
    device: str
    config: dict
    value: float
    fingerprint: str = ""
    fresh: float = 0.0
    source: str = ""
    store_key: str = ""

    @property
    def key(self) -> str:
        return winner_key(self.kernel, self.x, self.y, self.device)

    def to_payload(self) -> str:
        return json.dumps(
            {
                "config": self.config,
                "value": float(self.value),
                "fingerprint": self.fingerprint,
                "fresh": float(self.fresh),
                "source": self.source,
                "store_key": self.store_key,
            },
            sort_keys=True,
        )

    @classmethod
    def from_payload(cls, key: str, payload: str) -> "WinnerRecord | None":
        parsed = parse_winner_key(key)
        if parsed is None:
            return None
        kernel, x, y, device = parsed
        try:
            d = json.loads(payload)
        except ValueError:
            return None
        if not isinstance(d, dict) or not isinstance(d.get("config"), dict):
            return None
        try:
            value = float(d.get("value"))
            fresh = float(d.get("fresh", 0.0))
        except (TypeError, ValueError):
            return None
        return cls(
            kernel=kernel,
            x=x,
            y=y,
            device=device,
            config=d["config"],
            value=value,
            fingerprint=str(d.get("fingerprint", "")),
            fresh=fresh,
            source=str(d.get("source", "")),
            store_key=str(d.get("store_key", "")),
        )


def winner_key(kernel: str, x: int, y: int, device: str) -> str:
    return f"{kernel}|x={int(x)}|y={int(y)}|{device}"


def parse_winner_key(key: str) -> tuple[str, int, int, str] | None:
    parts = key.split("|")
    if len(parts) != 4:
        return None
    kernel, xs, ys, device = parts
    if not (xs.startswith("x=") and ys.startswith("y=")):
        return None
    try:
        return kernel, int(xs[2:]), int(ys[2:]), device
    except ValueError:
        return None


# ----------------------------------------------------------------- geometry


def spec_geometry(spec) -> tuple[int, int, str] | None:
    """The ``(x, y, device)`` a spec's winner is indexed under.

    The costmodel backend measures a fixed per-kernel workload geometry
    (``repro_torch.costmodel.WORKLOADS``) on a named chip model; the cuda
    backend measures the geometry in its backend kwargs on the device its
    ``device`` kwarg names, labelled by :func:`device_label`.  Backends with
    no geometry notion (``timing`` / ``callable`` wrappers) and a card that
    cannot be named here return ``None`` — their runs don't index winners.
    """
    if spec.backend == "costmodel":
        from ..costmodel import WORKLOADS

        w = WORKLOADS.get(spec.kernel)
        if w is None:
            return None
        return int(w.x), int(w.y), str(spec.backend_kwargs.get("chip", "v5e"))
    if spec.backend == "cuda":
        from ..cuda_bench import DEFAULT_X, DEFAULT_Y

        label = device_label(spec.backend_kwargs.get("device", "cuda"))
        if label is None:
            return None
        x = int(spec.backend_kwargs.get("x") or DEFAULT_X)
        y = int(spec.backend_kwargs.get("y") or DEFAULT_Y)
        return x, y, label
    return None


def device_label(device) -> str | None:
    """The winners-index label of a torch device: ``"cpu"`` for the CPU, the
    card's name for a CUDA device (``"cuda"`` is the current card), or
    ``None`` when no card is there to name."""
    import torch

    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(device)


def parse_config_from_store_key(store_key: str) -> dict | None:
    """Recover the config dict from a measurement key
    (``{cache_key}/seed={s}|k=v,k2=v2,...`` with an optional trailing
    ``|final{repeats}`` marker from final-timing re-measurement)."""
    parts = store_key.split("|")
    if len(parts) < 2:
        return None
    config: dict = {}
    for pair in parts[1].split(","):
        if "=" not in pair:
            return None
        k, v = pair.split("=", 1)
        for cast in (int, float):
            try:
                config[k] = cast(v)
                break
            except ValueError:
                continue
        else:
            config[k] = v
    return config or None


def best_store_entry(store, cache_key: str) -> tuple[dict, float, str] | None:
    """The best finite measurement under ``{cache_key}/`` as
    ``(config, value, store_key)`` (ties break on key, deterministically).

    Final re-measured timings (``|final`` keys) outrank search samples:
    a served config should be the one that won the careful re-measurement,
    not a lucky draw from a noisy single-repeat search probe.  Stores
    without final entries fall back to the global best.
    """
    prefix = f"{cache_key}/"
    if hasattr(store, "best_item"):
        try:
            best = store.best_item(prefix, contains="|final")
        except TypeError:  # duck-typed stores with a prefix-only best_item
            best = None
        if best is None:
            best = store.best_item(prefix)
    else:  # duck-typed minimal stores: python scan
        best = best_final = None
        for k, v in store.items():
            if not k.startswith(prefix) or not math.isfinite(v):
                continue
            if best is None or (v, k) < (best[1], best[0]):
                best = (k, float(v))
            if "|final" in k and (
                best_final is None or (v, k) < (best_final[1], best_final[0])
            ):
                best_final = (k, float(v))
        best = best_final or best
    if best is None:
        return None
    key, value = best
    config = parse_config_from_store_key(key)
    if config is None:
        return None
    return config, float(value), key


# ------------------------------------------------------------------ writing


def record_winner(store, rec: WinnerRecord, *, save: bool = True) -> WinnerRecord:
    """Merge ``rec`` into the store's winners channel (better-value /
    never-staler policy) and return what's now stored."""
    fresh = rec.fresh if rec.fresh else now_stamp()
    rec = replace(rec, fresh=float(fresh))
    merged = merge_winner_payloads(store.get_winner(rec.key), rec.to_payload())
    store.put_winner(rec.key, merged)
    if save:
        store.save()
    return WinnerRecord.from_payload(rec.key, merged) or rec


def record_session_winner(session) -> WinnerRecord | None:
    """Index the session's best measurement as a winner.

    Called by :class:`TuningSession` right after it saves results — the
    winner update rides the same store, so the index is maintained
    transactionally with the measurements behind it.  Returns the stored
    record, or ``None`` when the session has no store / no geometry / no
    finite measurement yet.
    """
    store = getattr(session, "store", None)
    if store is None:
        return None
    geom = spec_geometry(session.spec)
    if geom is None:
        return None
    best = best_store_entry(store, session.cache_key)
    if best is None:
        return None
    config, value, store_key = best
    x, y, device = geom[0], geom[1], geom[2]
    fingerprint = session.journal_namespace() or str(session.cache_key)
    rec = WinnerRecord(
        kernel=session.spec.kernel,
        x=x,
        y=y,
        device=device,
        config=config,
        value=value,
        fingerprint=fingerprint,
        fresh=now_stamp(),
        source=str(session.cache_key),
        store_key=store_key,
    )
    return record_winner(store, rec)


# ------------------------------------------------------------------ reading


def all_winners(store) -> list[WinnerRecord]:
    out = []
    for key, payload in store.winner_items():
        rec = WinnerRecord.from_payload(key, payload)
        if rec is not None:
            out.append(rec)
    return out


def lookup_winner(store, kernel: str, x: int, y: int, device: str
                  ) -> WinnerRecord | None:
    """Exact-geometry lookup: one keyed get, the serving hot path."""
    key = winner_key(kernel, x, y, device)
    payload = store.get_winner(key)
    if payload is None:
        return None
    return WinnerRecord.from_payload(key, payload)


def nearest_winner(store, kernel: str, x: int, y: int, device: str
                   ) -> WinnerRecord | None:
    """The same-kernel, same-device winner closest in log-geometry space
    (``|log(x/x0)| + |log(y/y0)|`` — a 2x-wider image is as near as a
    2x-narrower one).  Ties break on the winner key, deterministically."""
    best: tuple[float, str, WinnerRecord] | None = None
    for rec in all_winners(store):
        if rec.kernel != kernel or rec.device != device:
            continue
        if rec.x <= 0 or rec.y <= 0 or x <= 0 or y <= 0:
            continue
        dist = abs(math.log(x / rec.x)) + abs(math.log(y / rec.y))
        cand = (dist, rec.key, rec)
        if best is None or cand[:2] < best[:2]:
            best = cand
    return None if best is None else best[2]


def index_winners(dst_store, src_store, *, save: bool = True) -> int:
    """Fold ``src_store``'s winners into ``dst_store`` (merge policy applies)
    — how ``paper_matrix --serve-dir`` aggregates per-combo stores into one
    serving store.  Returns how many records were considered."""
    n = 0
    for key, payload in src_store.winner_items():
        dst_store.put_winner(
            key, merge_winner_payloads(dst_store.get_winner(key), payload)
        )
        n += 1
    if save and n:
        dst_store.save()
    return n
