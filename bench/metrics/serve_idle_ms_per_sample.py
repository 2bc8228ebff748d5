"""``serve_idle_ms_per_sample``: the traced window's idle seconds on the
card that fall in the program's ``serve`` stage (the queue owner's side of
the winners service: each ``best_config`` query, with the enqueue on a
miss, and ``collect_jobs``: the queue's scan, the job's session, the
shards absorbed, the journal's coverage, the store's save, the winners
index, the done flip), per sample.  ``None`` untraced, or where the
program traces no such stage."""

LABEL = "serve stage"


def read(run):
    if run.trace is None or not run.samples:
        return None
    idle = dict(run.trace.get("idle_gaps", ()))
    if LABEL not in idle:
        return None
    return idle[LABEL] / run.samples * 1e3
