"""``compile_ms_per_sample``: the measurement's compile stage (the input's
staging on the call's first fill, and each geometry's first warmed launch),
summed over the window's calls, per sample."""


def read(run):
    if not run.samples:
        return None
    return sum(c["stage_s"].get("compile", 0.0) for c in run.calls) / run.samples * 1e3
