"""``propose_idle_ms_per_sample``: the traced window's idle seconds on the
card that fall in the program's ``propose`` stage (the searcher's steps in
the engine's loop: its operators, its surrogate's fit and acquisition), per
sample.  The measurement fences every launch, so the card has nothing
queued while the host proposes: these seconds are the host's time in the
stage.  ``None`` untraced, or where the program traces no such stage."""

LABEL = "propose stage"


def read(run):
    if run.trace is None or not run.samples:
        return None
    idle = dict(run.trace.get("idle_gaps", ()))
    if LABEL not in idle:
        return None
    return idle[LABEL] / run.samples * 1e3
