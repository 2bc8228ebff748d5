"""Measurement store backends: persistent ``str -> float`` mappings (a port
of ``repro.core.stores``).

The JSON :class:`~repro_torch.core.engine.MeasurementStore` (the default)
rewrites its whole file per flush — fine at the scaled designs' ~10^5
entries, but the paper-exact ~3M-sample design needs incremental writes.
:class:`SqliteMeasurementStore` keeps the same duck-typed interface
(``get`` / ``put`` / ``save`` / ``items`` / ``update`` / ``__len__``, the
meta and winner side-channels, ``best_item``) over a single-table database
with batched commits, so :class:`~repro_torch.core.engine.DiskCachedMeasurement`,
the executor layer's shard-store merge, and the work-unit journal (which
lives in the per-key metadata side-channel) work unchanged against either.

Select a backend by name through :func:`make_store` (``TuningSpec.store``
routes here): ``make_store("sqlite", path)`` / ``make_store("json", path)``.
The executor layer's shard-store merge folds winner records through
:func:`absorb_winners`.
"""

from __future__ import annotations

import json
import math
import os
import sqlite3
from typing import Iterable, Iterator

from .engine import MeasurementStore


class SqliteMeasurementStore:
    """Sqlite-backed measurement store (same interface as the JSON store).

    Writes accumulate in the sqlite connection and are committed every
    ``autosave_every`` puts (0 disables autocommit batching; call
    :meth:`save`).  ``path=None`` gives an in-memory database — useful for
    tests and for shard workers that return their entries to the parent.
    Unlike the JSON store, entries hit the file incrementally: a 3M-entry
    run never rewrites the full history per flush.

    File-backed databases run in WAL journal mode with a busy timeout
    (``busy_timeout_ms``): shard workers read the parent's file while it is
    open, and a serving layer opens the same file from many reader
    processes while a tuning session appends; WAL gives readers a
    consistent snapshot without blocking the writer.
    """

    def __init__(self, path: str | None, autosave_every: int = 4096,
                 busy_timeout_ms: int = 5000):
        self.path = path
        self.autosave_every = autosave_every
        self.busy_timeout_ms = busy_timeout_ms
        self._dirty = 0
        if path is not None:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
        # check_same_thread=False: the device executor builds a card's shard
        # store on that card's thread and the caller closes it after the
        # join (and the reference's serving endpoint answers from handler
        # threads behind one lock); sqlite itself is compiled serialized, so
        # cross-thread use under external serialization is safe
        self._conn = sqlite3.connect(
            path if path is not None else ":memory:", check_same_thread=False
        )
        if path is not None:
            # WAL is persistent: every later opener of the same file inherits
            # it even if they skip the pragma
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute(f"PRAGMA busy_timeout={int(busy_timeout_ms)}")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS measurements "
            "(key TEXT PRIMARY KEY, value REAL NOT NULL)"
        )
        # per-key string metadata (penalty reasons from the real-measurement
        # backend); mirrors MeasurementStore's meta side-channel
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS meta "
            "(key TEXT PRIMARY KEY, note TEXT NOT NULL)"
        )
        # serving winners (the serving best-config index); mirrors
        # MeasurementStore's winners side-channel
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS winners "
            "(key TEXT PRIMARY KEY, payload TEXT NOT NULL)"
        )
        self._conn.commit()

    def __len__(self) -> int:
        (n,) = self._conn.execute("SELECT COUNT(*) FROM measurements").fetchone()
        return int(n)

    def get(self, key: str) -> float | None:
        row = self._conn.execute(
            "SELECT value FROM measurements WHERE key = ?", (key,)
        ).fetchone()
        return None if row is None else float(row[0])

    def put(self, key: str, value: float) -> None:
        self._conn.execute(
            "INSERT OR REPLACE INTO measurements (key, value) VALUES (?, ?)",
            (key, float(value)),
        )
        self._dirty += 1
        if self.autosave_every and self._dirty >= self.autosave_every:
            self.save()

    def save(self) -> None:
        self._conn.commit()
        self._dirty = 0

    def items(self) -> Iterator[tuple[str, float]]:
        for key, value in self._conn.execute(
            "SELECT key, value FROM measurements"
        ):
            yield key, float(value)

    def update(self, entries: Iterable[tuple[str, float]]) -> None:
        self._conn.executemany(
            "INSERT OR REPLACE INTO measurements (key, value) VALUES (?, ?)",
            ((k, float(v)) for k, v in entries),
        )
        self.save()

    def best_item(self, prefix: str, contains: str | None = None
                  ) -> tuple[str, float] | None:
        """The minimum-value finite entry under ``prefix`` (ties break on
        key), resolved inside sqlite — the serving winner refresh never
        pages a 3M-row store through Python.  ``contains`` restricts to keys
        holding that substring (e.g. ``"|final"``)."""

        def esc(s: str) -> str:
            return s.replace("\\", "\\\\").replace("%", "\\%").replace("_", "\\_")

        sql = ("SELECT key, value FROM measurements "
               "WHERE key LIKE ? ESCAPE '\\' AND value <= ? AND value >= ? ")
        params: list = [esc(prefix) + "%",
                        1.7976931348623157e308, -1.7976931348623157e308]
        if contains is not None:
            sql += "AND key LIKE ? ESCAPE '\\' "
            params.append("%" + esc(contains) + "%")
        row = self._conn.execute(
            sql + "ORDER BY value ASC, key ASC LIMIT 1", params
        ).fetchone()
        return None if row is None else (str(row[0]), float(row[1]))

    # -- per-key metadata (penalty reasons) ------------------------------------
    def get_meta(self, key: str) -> str | None:
        row = self._conn.execute(
            "SELECT note FROM meta WHERE key = ?", (key,)
        ).fetchone()
        return None if row is None else str(row[0])

    def put_meta(self, key: str, note: str) -> None:
        self._conn.execute(
            "INSERT OR REPLACE INTO meta (key, note) VALUES (?, ?)",
            (key, str(note)),
        )
        self._dirty += 1
        if self.autosave_every and self._dirty >= self.autosave_every:
            self.save()

    def meta_items(self, prefix: str | None = None) -> Iterator[tuple[str, str]]:
        if prefix is None:
            rows = self._conn.execute("SELECT key, note FROM meta")
        else:
            like = prefix.replace("\\", "\\\\").replace("%", "\\%").replace("_", "\\_")
            rows = self._conn.execute(
                "SELECT key, note FROM meta WHERE key LIKE ? ESCAPE '\\'",
                (like + "%",),
            )
        for key, note in rows:
            yield key, str(note)

    def update_meta(self, entries: Iterable[tuple[str, str]]) -> None:
        self._conn.executemany(
            "INSERT OR REPLACE INTO meta (key, note) VALUES (?, ?)",
            ((k, str(v)) for k, v in entries),
        )
        self.save()

    # -- serving winners (the serving best-config index) ---------------------
    def get_winner(self, key: str) -> str | None:
        row = self._conn.execute(
            "SELECT payload FROM winners WHERE key = ?", (key,)
        ).fetchone()
        return None if row is None else str(row[0])

    def put_winner(self, key: str, payload: str) -> None:
        self._conn.execute(
            "INSERT OR REPLACE INTO winners (key, payload) VALUES (?, ?)",
            (key, str(payload)),
        )
        self._dirty += 1
        if self.autosave_every and self._dirty >= self.autosave_every:
            self.save()

    def winner_items(self) -> Iterator[tuple[str, str]]:
        for key, payload in self._conn.execute("SELECT key, payload FROM winners"):
            yield key, str(payload)

    def update_winners(self, entries: Iterable[tuple[str, str]]) -> None:
        self._conn.executemany(
            "INSERT OR REPLACE INTO winners (key, payload) VALUES (?, ?)",
            ((k, str(v)) for k, v in entries),
        )
        self.save()

    def close(self) -> None:
        self._conn.commit()
        self._conn.close()



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
    "sqlite": SqliteMeasurementStore,
}


def make_store(kind: str, path: str | None = None, **kwargs):
    """Resolve a measurement-store backend by name."""
    if kind not in STORES:
        raise KeyError(f"unknown store kind {kind!r}; have {sorted(STORES)}")
    return STORES[kind](path, **kwargs)
