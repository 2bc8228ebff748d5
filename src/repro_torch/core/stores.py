"""Measurement store registry and winner merging (the JSON half of
``repro.core.stores``).

Select a store by name through :func:`make_store` (``TuningSpec.store``
routes here).  The port has the JSON :class:`~repro_torch.core.engine.MeasurementStore`
only; the reference's sqlite store is not ported yet, so a spec naming
``"sqlite"`` raises ``KeyError``.  The executor layer's shard-store merge
folds winner records through :func:`absorb_winners`.
"""

from __future__ import annotations

import json
import math

from .engine import MeasurementStore


def merge_winner_payloads(old: str | None, new: str) -> str:
    """Resolve two winner records for the same key: the lower measured value
    wins (ties keep the newer record), and the freshness stamp never moves
    backwards — merging a stale shard into a store that already saw a newer
    update must not make the entry look older than it is.  Unparseable
    payloads lose to parseable ones (last-writer-wins between two)."""
    if old is None:
        return str(new)

    def _load(payload: str) -> dict | None:
        try:
            d = json.loads(payload)
        except ValueError:
            return None
        return d if isinstance(d, dict) else None

    a, b = _load(old), _load(new)
    if b is None:
        return str(old) if a is not None else str(new)
    if a is None:
        return str(new)

    def _value(d: dict) -> float:
        try:
            return float(d.get("value", math.inf))
        except (TypeError, ValueError):
            return math.inf

    def _fresh(d: dict) -> float:
        try:
            return float(d.get("fresh", 0.0))
        except (TypeError, ValueError):
            return 0.0

    if _value(b) != _value(a):
        keep = dict(b if _value(b) < _value(a) else a)
    else:  # value tie: the fresher record answers — merge-order independent
        keep = dict(b if _fresh(b) >= _fresh(a) else a)
    keep["fresh"] = max(_fresh(a), _fresh(b))
    return json.dumps(keep, sort_keys=True)


def absorb_winners(dst, src) -> None:
    """Fold ``src``'s winner records into ``dst`` under the merge policy."""
    if not (hasattr(src, "winner_items") and hasattr(dst, "put_winner")):
        return
    for key, payload in src.winner_items():
        dst.put_winner(key, merge_winner_payloads(dst.get_winner(key), payload))


#: store-kind registry, mirroring SEARCHERS / BACKENDS.
STORES: dict[str, type] = {
    "json": MeasurementStore,
}


def make_store(kind: str, path: str | None = None, **kwargs):
    """Resolve a measurement-store backend by name."""
    if kind not in STORES:
        raise KeyError(f"unknown store kind {kind!r}; have {sorted(STORES)}")
    return STORES[kind](path, **kwargs)
