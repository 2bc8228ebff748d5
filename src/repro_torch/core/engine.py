"""Batched evaluation engine: the loop over the searcher ask/tell protocol
plus a persistent on-disk measurement cache (a port of ``repro.core.engine``).

  drive(searcher, measurement, budget)        batched loop (the hot path)
  drive(..., dispatch="one")                  sequential loop (parity audit)
  MeasurementStore / DiskCachedMeasurement    persistent (kernel, config) cache

The JSON store reads and writes the reference's three file formats, so a
store written by either package loads in the other.
"""

from __future__ import annotations

import json
import os
import tempfile
import warnings
from typing import Sequence

import numpy as np

from .measurement import BaseMeasurement
from .searchers.base import Searcher, TuningResult
from .space import Config

DISPATCH_MODES = ("batch", "one")


def drive(
    searcher: Searcher,
    measurement: BaseMeasurement,
    budget: int,
    dispatch: str = "batch",
) -> TuningResult:
    """Run ``searcher`` to completion against ``measurement``.

    ``dispatch="batch"`` hands each proposal batch to ``measure_batch`` in
    one call; ``dispatch="one"`` measures config-by-config.  Both consume the
    same proposals in the same order.
    """
    if dispatch not in DISPATCH_MODES:
        raise ValueError(f"dispatch must be one of {DISPATCH_MODES}")
    searcher.start(budget)
    while True:
        configs = searcher.ask()
        if not configs:
            break
        if dispatch == "batch":
            values = measurement.measure_batch(configs)
        else:
            values = np.array(
                [measurement.measure(c) for c in configs], dtype=np.float64
            )
        searcher.tell(configs, values)
    return searcher.finish()


# ---------------------------------------------------------------- disk cache


def config_key(config: Config) -> str:
    """Canonical string key for a config dict (sorted, compact)."""
    return ",".join(f"{k}={config[k]}" for k in sorted(config))


class MeasurementStore:
    """A persistent str -> float mapping backing :class:`DiskCachedMeasurement`.

    Entries are namespaced by the wrapping measurement's ``prefix``.  Writes
    are atomic (temp file + rename).  ``autosave_every`` new entries trigger
    a flush; 0 disables autosave (call :meth:`save` explicitly).

    File formats, as the reference writes them: a flat JSON object (format
    1, values only); ``{"__format__": 2, "values", "meta"}`` once a key
    carries metadata (the reason a config was penalized); format 3 adds the
    serving ``"winners"`` mapping.  ``inf`` round-trips through Python's JSON
    (``Infinity`` literal).
    """

    def __init__(self, path: str | None, autosave_every: int = 4096):
        self.path = path
        self.autosave_every = autosave_every
        self._data: dict[str, float] = {}
        self._meta: dict[str, str] = {}
        self._winners: dict[str, str] = {}
        self._dirty = 0
        if path is not None and os.path.exists(path):
            try:
                with open(path) as f:
                    raw = json.load(f)
                if isinstance(raw, dict) and raw.get("__format__") in (2, 3):
                    self._data = {k: float(v) for k, v in raw["values"].items()}
                    self._meta = {k: str(v) for k, v in raw.get("meta", {}).items()}
                    self._winners = {
                        k: str(v) for k, v in raw.get("winners", {}).items()
                    }
                else:
                    self._data = {k: float(v) for k, v in raw.items()}
            except (json.JSONDecodeError, ValueError, TypeError, OSError) as e:
                # a cache is not a source of truth: a corrupt/truncated file
                # must degrade to a cold cache, not kill the run
                warnings.warn(
                    f"measurement cache {path!r} unreadable ({e}); starting cold"
                )

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: str) -> float | None:
        return self._data.get(key)

    def items(self):
        return self._data.items()

    def update(self, entries) -> None:
        """Bulk-insert ``(key, value)`` pairs (shard-store merging).  Entries
        are only marked dirty — call :meth:`save` once after the last batch
        so an N-shard merge doesn't rewrite the file N times."""
        for k, v in entries:
            self._data[k] = float(v)
            self._dirty += 1

    def best_item(self, prefix: str, contains: str | None = None
                  ) -> tuple[str, float] | None:
        """The minimum-value finite entry under ``prefix`` (ties break on
        key).  ``contains`` restricts to keys holding that substring (e.g.
        ``"|final"`` to rank only re-measured final timings)."""
        best: tuple[str, float] | None = None
        for k, v in self._data.items():
            if not k.startswith(prefix) or not np.isfinite(v):
                continue
            if contains is not None and contains not in k:
                continue
            if best is None or (v, k) < (best[1], best[0]):
                best = (k, float(v))
        return best

    def put(self, key: str, value: float) -> None:
        self._data[key] = float(value)
        self._dirty += 1
        if self.autosave_every and self._dirty >= self.autosave_every:
            self.save()

    # -- per-key metadata (penalty reasons) ------------------------------------
    def get_meta(self, key: str) -> str | None:
        return self._meta.get(key)

    def put_meta(self, key: str, note: str) -> None:
        self._meta[key] = str(note)
        self._dirty += 1

    def meta_items(self, prefix: str | None = None):
        if prefix is None:
            return self._meta.items()
        return [(k, v) for k, v in self._meta.items() if k.startswith(prefix)]

    def update_meta(self, entries) -> None:
        for k, v in entries:
            self._meta[k] = str(v)
            self._dirty += 1

    # -- serving winners (carried through format 3) ----------------------------
    def get_winner(self, key: str) -> str | None:
        return self._winners.get(key)

    def put_winner(self, key: str, payload: str) -> None:
        self._winners[key] = str(payload)
        self._dirty += 1

    def winner_items(self):
        return self._winners.items()

    def update_winners(self, entries) -> None:
        for k, v in entries:
            self._winners[k] = str(v)
            self._dirty += 1

    def save(self) -> None:
        if self.path is None:
            return
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        if self._winners:
            payload = {
                "__format__": 3,
                "values": self._data,
                "meta": self._meta,
                "winners": self._winners,
            }
        elif self._meta:
            payload = {"__format__": 2, "values": self._data, "meta": self._meta}
        else:
            payload = self._data
        fd, tmp = tempfile.mkstemp(dir=d or ".", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                # sorted keys: two stores holding the same entries produce
                # byte-identical files regardless of insertion order
                json.dump(payload, f, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        self._dirty = 0


class DiskCachedMeasurement(BaseMeasurement):
    """Serves measurements from a :class:`MeasurementStore`, falling back to
    (and recording) the inner measurement on miss.

    Keys are ``{prefix}|{config_key}``.  ``n_samples`` counts every sample
    *served* (hit or miss), so budget audits are identical whether the cache
    is cold or warm; ``n_misses`` counts actual inner measurements.
    """

    def __init__(self, inner: BaseMeasurement, store: MeasurementStore, prefix: str):
        super().__init__()
        self._inner = inner
        self._store = store
        self.prefix = prefix
        self.n_misses = 0

    def _key(self, config: Config) -> str:
        return f"{self.prefix}|{config_key(config)}"

    def _record(self, key: str, config: Config, value: float) -> None:
        """Persist a fresh measurement; penalized (non-finite) values carry
        the inner backend's failure reason as store metadata."""
        self._store.put(key, value)
        if not np.isfinite(value):
            reason = self._inner.reason_for(config)
            self._store.put_meta(key, reason or "non-finite measurement")

    def measure(self, config: Config) -> float:
        return float(self.measure_batch([config])[0])

    def measure_batch(self, configs: Sequence[Config]) -> np.ndarray:
        self.n_samples += len(configs)
        self.n_dispatches += 1
        keys = [self._key(c) for c in configs]
        # a key repeated within the batch is measured once, at its first
        # occurrence, and served as a hit after it: the store keeps one value
        # per key, so a cold run serves what a warm replay will serve.  (The
        # reference measures each occurrence and stores the last.)
        first: dict[str, int] = {}
        miss = np.array(
            [self._store.get(k) is None and first.setdefault(k, i) == i
             for i, k in enumerate(keys)],
            dtype=bool,
        )
        vals = np.full(len(configs), np.nan, dtype=np.float64)
        # walk the batch in contiguous hit/miss runs so the inner backend's
        # per-sample state stays aligned with a cold run
        i, n = 0, len(configs)
        while i < n:
            j = i
            while j < n and miss[j] == miss[i]:
                j += 1
            if miss[i]:
                fresh_cfgs = list(configs[i:j])
                fresh = self._inner.measure_batch(fresh_cfgs)
                self.n_misses += len(fresh_cfgs)
                vals[i:j] = fresh
                for k, c, v in zip(keys[i:j], fresh_cfgs, fresh, strict=True):
                    self._record(k, c, float(v))
            else:
                self._inner.skip_samples(j - i)
                vals[i:j] = [self._store.get(k) for k in keys[i:j]]
            i = j
        return vals

    def measure_final(self, config: Config, repeats: int = 10) -> float:
        k = f"{self._key(config)}|final{repeats}"
        v = self._store.get(k)
        if v is None:
            v = self._inner.measure_final(config, repeats)
            self._record(k, config, float(v))
        return float(v)

    # -- introspection ---------------------------------------------------------
    def provenance(self) -> dict:
        p = self._inner.provenance()
        if p:
            p = {**p, "cache_hits": self.n_samples - self.n_misses,
                 "cache_misses": self.n_misses}
        return p

    def reason_for(self, config: Config) -> str | None:
        """Served-from-cache penalties keep their reason: store metadata wins,
        the live inner backend is the fallback."""
        meta = self._store.get_meta(self._key(config))
        if meta is not None:
            return meta
        return self._inner.reason_for(config)

    def repeats_for(self, config: Config) -> list | None:
        return self._inner.repeats_for(config)

    def stage_times(self) -> dict[str, float]:
        return self._inner.stage_times()

    def reset(self) -> None:
        super().reset()
        self.n_misses = 0
        self._inner.reset()

    def save(self) -> None:
        self._store.save()
