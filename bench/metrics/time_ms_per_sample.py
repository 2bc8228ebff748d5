"""``time_ms_per_sample``: the measurement's time stage (the timed repeats,
each fenced, and the final re-measurement's), summed over the window's
calls, per sample."""


def read(run):
    if not run.samples:
        return None
    return sum(c["stage_s"].get("time", 0.0) for c in run.calls) / run.samples * 1e3
