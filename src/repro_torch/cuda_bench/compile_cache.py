"""Persistent cross-process compile cache for CUDA measurements (a port of
``repro.pallas_bench.compile_cache``).

The per-geometry warm cache in :class:`~repro_torch.cuda_bench.measure
.CudaMeasurement` dedups a geometry's first warmed launch within ONE
measurement instance — but a matrix run builds a fresh instance per
experiment, every worker process builds its own, and a re-run starts cold.
This module adds the layer under it: an on-disk cache of each geometry's
compile *outcome* keyed by *(kernel identity, geometry, torch/device/library
fingerprint)*, shared by every process that points at the same directory.

Three guarantees, and how the file protocol provides them:

* **Atomic entries** — an entry is a single pickle file written to a temp
  name and ``os.replace``\\ d into place, so a reader never sees a torn
  entry; concurrent writers of the same key write identical content and the
  last rename wins harmlessly.
* **Cross-process in-flight dedup** — before compiling, a worker *claims*
  the key by creating ``<key>.claim`` with ``O_CREAT | O_EXCL`` (the atomic
  "I am compiling this" marker).  Losers poll for the entry instead of
  compiling the same geometry in parallel.  A claim left behind by a killed
  worker goes stale after ``claim_timeout_s`` and is removed under an
  advisory ``flock`` on the cache-wide lock file, so exactly one waiter
  inherits the compile.
* **Runtime fingerprinting** — every entry records the torch and CUDA
  versions, the device's name and capability, and the kernel library's file
  name it was compiled under; an entry from a different runtime (or from a
  library built from other sources) is a miss, never a wrong outcome.

One ``nvcc`` library serves every config, so there is no executable per
geometry to serialize.  An ``ok`` entry's ``artifact`` is a small blob
naming the kernel, the geometry and the library (:func:`serialize_compiled`);
:func:`deserialize_compiled` refuses a blob of another library, and the
caller then treats the entry as a miss.  ``invalid`` entries carry the
refused launch's reason, so a geometry the card refuses is served as a
penalty without launching it again.  The cache is a pure speed knob: values
served through it come from the same kernels, and the ``compile_cache`` spec
kwarg is excluded from cache keys / journal namespaces / spec fingerprints
(staticcheck PROV001 pins that).
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import tempfile
import time
from contextlib import contextmanager
from typing import Any, Callable

from ..core.clock import monotonic

try:  # POSIX advisory locking; degrade gracefully where absent
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX hosts
    fcntl = None

__all__ = [
    "CompileCache",
    "deserialize_compiled",
    "runtime_fingerprint",
    "serialize_compiled",
]

#: bump when the entry layout changes — old entries become misses, not errors
FORMAT_VERSION = 1


def library_name() -> str:
    """The file name of the kernel library this checkout builds and loads
    (``kernels/_build.py``), from the sources' digest alone: nothing is
    built or loaded, so the CPU needs no ``nvcc``."""
    from ..kernels import _build

    if _build._loaded:
        return os.path.basename(_build._loaded[0].path)
    return f"librepro_torch_kernels-{_build._digest()}.so"


def runtime_fingerprint(device=None) -> dict:
    """What a geometry's compile outcome depends on: the torch build, the
    device it ran on and the kernel library.  Part of every entry;
    mismatches are misses.  ``device`` defaults to the card where there is
    one; a CPU device fingerprints as ``"cpu"``."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        capability = list(torch.cuda.get_device_capability(device))
    else:
        name, capability = "cpu", None
    return {
        "format": FORMAT_VERSION,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device_kind": name,
        "capability": capability,
        "library": library_name(),
    }


def serialize_compiled(compiled: dict) -> bytes | None:
    """The artifact of one geometry: ``{"kernel": ..., "geometry": [...]}``
    plus the library it was launched from, as a blob; ``None`` when it does
    not serialize (the caller then stores an artifact-free entry)."""
    try:
        return pickle.dumps({**compiled, "library": library_name()})
    except Exception:  # noqa: BLE001 — any failure means "no artifact", never a crash
        return None


def deserialize_compiled(blob: bytes) -> dict:
    """The artifact's ``{"kernel", "geometry", "library"}``.  Raises when the
    blob is unreadable or names another library than this checkout's — the
    caller treats that as a miss and compiles again."""
    art = pickle.loads(blob)
    if not isinstance(art, dict) or art.get("library") != library_name():
        got = art.get("library") if isinstance(art, dict) else type(art).__name__
        raise ValueError(f"artifact of library {got!r}, this one is {library_name()!r}")
    return art


class CompileCache:
    """On-disk, file-locked compile cache shared across processes and runs.

    ``root`` is the cache directory (created on first use).  Entry files are
    ``<key>.pkl``; in-flight claims are ``<key>.claim``; the advisory lock
    serializing claim-steals is ``.lock``.  All methods are safe to call
    concurrently from threads and processes — the protocol is built from
    atomic filesystem operations, with ``flock`` only narrowing the
    stale-claim steal race.
    """

    def __init__(
        self,
        root: str,
        *,
        claim_timeout_s: float = 120.0,
        poll_s: float = 0.05,
        fingerprint: dict | None = None,
    ):
        self.root = str(root)
        self.claim_timeout_s = float(claim_timeout_s)
        self.poll_s = float(poll_s)
        self._fingerprint = fingerprint

    # -- identity --------------------------------------------------------------
    def fingerprint(self) -> dict:
        if self._fingerprint is None:
            self._fingerprint = runtime_fingerprint()
        return self._fingerprint

    def key(self, **identity: Any) -> str:
        """Stable hex key over the JSON-able identity fields (kernel name,
        input sizes, geometry tuple, ...) plus the runtime fingerprint."""
        d = {**identity, "fp": self.fingerprint()}
        blob = json.dumps(d, sort_keys=True, default=str)
        return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:32]

    # -- paths -----------------------------------------------------------------
    def _entry_path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.pkl")

    def _claim_path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.claim")

    @contextmanager
    def _locked(self):
        """Advisory exclusive lock on the cache-wide lock file (no-op where
        ``fcntl`` is unavailable — O_EXCL/rename atomicity still holds; only
        the stale-claim steal gets racier)."""
        if fcntl is None:  # pragma: no cover - non-POSIX hosts
            yield
            return
        os.makedirs(self.root, exist_ok=True)
        fd = os.open(os.path.join(self.root, ".lock"), os.O_CREAT | os.O_RDWR)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    # -- entries ---------------------------------------------------------------
    def get(self, key: str) -> dict | None:
        """The entry for ``key``, or ``None``.  Entries are dicts with
        ``status`` (``"ok"`` / ``"invalid"``), ``reason`` / ``stage`` for
        invalid ones, and ``artifact`` (the serialized artifact or
        ``None``).  Unreadable or wrong-runtime entries are misses."""
        try:
            with open(self._entry_path(key), "rb") as f:
                entry = pickle.load(f)
        except (OSError, pickle.UnpicklingError, EOFError, AttributeError):
            return None
        if not isinstance(entry, dict) or entry.get("fp") != self.fingerprint():
            return None
        return entry

    def put(
        self,
        key: str,
        *,
        status: str,
        reason: str | None = None,
        stage: str | None = None,
        artifact: bytes | None = None,
    ) -> None:
        """Atomically publish an entry (tmp file + ``os.replace``)."""
        entry = {
            "status": str(status),
            "reason": reason,
            "stage": stage,
            "artifact": artifact,
            "fp": self.fingerprint(),
        }
        os.makedirs(self.root, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=f"{key}.", suffix=".tmp", dir=self.root)
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(entry, f)
            os.replace(tmp, self._entry_path(key))
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    # -- in-flight claims ------------------------------------------------------
    def claim(self, key: str) -> bool:
        """Try to become the one process compiling ``key``.  ``True`` means
        the caller owns the compile and MUST :meth:`release` (after
        :meth:`put`); ``False`` means someone else holds a live claim — use
        :meth:`wait`."""
        os.makedirs(self.root, exist_ok=True)
        path = self._claim_path(key)
        for attempt in range(2):
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                if attempt or not self._steal_stale_claim(path):
                    return False
                continue  # stale claim removed — race for a fresh one
            with os.fdopen(fd, "w") as f:
                f.write(str(os.getpid()))
            return True
        return False

    def _steal_stale_claim(self, path: str) -> bool:
        """Remove ``path`` if its holder looks dead (mtime older than the
        claim timeout).  Serialized under the cache lock so at most one
        waiter steals; returns whether the claim is gone."""
        # wall clock against the claim file's mtime — pure liveness policy,
        # never part of any measured value
        now = time.time()  # repro: allow[DET001]
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
                pass  # another waiter stole it first — equally gone
        return not os.path.exists(path)

    def release(self, key: str) -> None:
        try:
            os.remove(self._claim_path(key))
        except OSError:
            pass

    def wait(self, key: str, timeout_s: float | None = None) -> dict | None:
        """Poll for the entry another process claimed.  Returns the entry,
        or ``None`` when the claim holder vanished without publishing or the
        timeout elapsed (the caller then compiles locally)."""
        deadline = monotonic() + (
            timeout_s if timeout_s is not None else self.claim_timeout_s
        )
        claim = self._claim_path(key)
        while True:
            entry = self.get(key)
            if entry is not None:
                return entry
            if not os.path.exists(claim):
                return self.get(key)  # holder finished or died; final look
            if monotonic() >= deadline:
                return None
            time.sleep(self.poll_s)

    # -- convenience -----------------------------------------------------------
    def compute(self, key: str, fn: Callable[[], dict]) -> tuple[dict, bool]:
        """Get-or-compute with cross-process dedup: serve the entry if
        present; otherwise claim and run ``fn()`` (which returns the entry
        kwargs to :meth:`put`); if another process holds the claim, wait it
        out and serve its entry.  Returns ``(entry, computed_here)``."""
        entry = self.get(key)
        if entry is not None:
            return entry, False
        if self.claim(key):
            try:
                # double-check under the claim: another process may have
                # published between our miss and our claim (its release is
                # what let this claim succeed) — entries are published
                # before claims are released, so this read is authoritative
                # and each key is computed exactly once across processes
                entry = self.get(key)
                if entry is not None:
                    return entry, False
                kwargs = fn()
                self.put(key, **kwargs)
            finally:
                self.release(key)
            return self.get(key), True
        entry = self.wait(key)
        if entry is not None:
            return entry, False
        # claim holder wedged past the timeout: compute without publishing
        kwargs = fn()
        return {**kwargs, "fp": self.fingerprint()}, True
