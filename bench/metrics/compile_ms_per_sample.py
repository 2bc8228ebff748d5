"""``compile_ms_per_sample``: the measurement's compile stage (each new
geometry's warm launches; the inputs' staging is the ``inputs`` stage,
read by ``inputs_ms_per_sample``), summed over the window's calls, per
sample."""


def read(run):
    if not run.samples:
        return None
    return sum(c["stage_s"].get("compile", 0.0) for c in run.calls) / run.samples * 1e3
