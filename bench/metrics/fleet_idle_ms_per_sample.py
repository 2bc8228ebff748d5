"""``fleet_idle_ms_per_sample``: the traced window's idle seconds on the
card that fall in the program's ``fleet`` stage (a fleet worker's own work
around the units it runs: its sessions for a job built and seeded from the
parent store, the queue's scans and claims, the unit journal's lookups,
the done markers; its shard session's record of each unit, the journal's
put and the store's save, is a ``session`` stage), per sample.  ``None``
untraced, or where the program traces no such stage."""

LABEL = "fleet stage"


def read(run):
    if run.trace is None or not run.samples:
        return None
    idle = dict(run.trace.get("idle_gaps", ()))
    if LABEL not in idle:
        return None
    return idle[LABEL] / run.samples * 1e3
