"""Process-invariant seed derivation (a copy of ``repro.core.runner.stable_seed``)."""

from __future__ import annotations

import zlib


def stable_seed(*parts) -> int:
    """Deterministic 31-bit seed from arbitrary parts (python's ``hash`` is
    process-salted and would break run-to-run reproducibility)."""
    return zlib.crc32("|".join(map(str, parts)).encode()) & 0x7FFFFFFF
