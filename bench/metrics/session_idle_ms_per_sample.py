"""``session_idle_ms_per_sample``: the traced window's idle seconds on the
card that fall in the program's ``session`` stage (``TuningSession.run``'s
own work: the searcher and measurement it builds before the search loop;
the store, winners index and record after the final re-measurement), per
sample.  ``None`` untraced, or where the program traces no such stage."""

LABEL = "session stage"


def read(run):
    if run.trace is None or not run.samples:
        return None
    idle = dict(run.trace.get("idle_gaps", ()))
    if LABEL not in idle:
        return None
    return idle[LABEL] / run.samples * 1e3
