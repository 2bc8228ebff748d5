"""Deterministic shard-trace merging (the trace twin of shard-store merging;
a copy of ``repro.telemetry.merge``).

Workers write ``trace.shard<k>.jsonl`` beside their shard stores; the parent
absorbs them into its ``trace.jsonl`` when the pool joins — and, after a
kill, on the next resumed run (:meth:`Telemetry.recover`).  The merge is an
append: shard files in ascending shard order, each file's internal line
order (its writer's ``seq`` order) preserved, then the file is deleted.
Merging the same shard files into the same parent therefore always produces
the same bytes — the property ``tests/test_torch_telemetry.py`` pins.

Events are never rewritten: ``(src, seq)`` already identifies a writer's
stream, and timestamps are only comparable within one ``src`` anyway
(monotonic epochs differ across processes), so interleaving by time would
fabricate an ordering the data cannot support.
"""

from __future__ import annotations

import os


def absorb_traces(telemetry, paths) -> int:
    """Append each existing trace file in ``paths`` (given order) onto
    ``telemetry``'s file; delete absorbed files.  Returns the count."""
    existing = [p for p in paths if p and os.path.exists(p)]
    if not existing:
        return 0
    with telemetry._lock:
        if telemetry._fh is not None:
            telemetry._fh.close()
            telemetry._fh = None
        d = telemetry.dir
        if d:
            os.makedirs(d, exist_ok=True)
        with open(telemetry.path, "a", encoding="utf-8") as out:
            for path in existing:
                with open(path, encoding="utf-8") as f:
                    data = f.read()
                if data and not data.endswith("\n"):
                    data += "\n"   # a torn final line must not glue onto ours
                out.write(data)
                os.remove(path)
    return len(existing)
