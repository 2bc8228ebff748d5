"""The disabled telemetry path: a no-op object with the full Telemetry API
(a copy of ``repro.telemetry.null``).

:data:`NULL_TELEMETRY` is the default everywhere a telemetry sink is
accepted (``TuningSession``, ``BaseMeasurement``, the engine's ``drive``):
callers never branch on "is telemetry on", they just call the sink.  The
null object is deliberately allocation-free in steady state — ``span()``
returns one shared reusable context manager regardless of arguments, every
other method is a bare ``pass`` — so the disabled path is the current code
path plus a dynamic dispatch per call site.  Hot loops that would pay even
for argument packing guard on :attr:`NullTelemetry.enabled` instead.

This module imports nothing from the rest of the package (or the repo), so
determinism-critical core modules can depend on it without import cycles.
"""

from __future__ import annotations


class _NullSpan:
    """A reusable no-op context manager (one instance serves every span)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullTelemetry:
    """No-op stand-in for :class:`repro_torch.telemetry.Telemetry`.

    ``enabled`` is the cheap guard hot paths check before doing any work
    (counting non-finite values, formatting attributes) purely for
    telemetry's benefit.
    """

    enabled = False
    path = None
    src = "main"

    def span(self, name, **attrs):
        return _NULL_SPAN

    def event(self, ev, **fields) -> None:
        pass

    def stage(self, name, dur, **attrs) -> None:
        pass

    def inc(self, name, n=1) -> None:
        pass

    def gauge(self, name, value) -> None:
        pass

    def counters_snapshot(self) -> dict:
        return {}

    def emit_counters(self) -> None:
        pass

    def shard_path(self, shard):
        return None

    def shard_src(self, shard):
        return None

    def absorb(self, paths) -> int:
        return 0

    def recover(self) -> int:
        return 0

    def close(self) -> None:
        pass


NULL_TELEMETRY = NullTelemetry()
