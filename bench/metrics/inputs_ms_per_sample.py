"""``inputs_ms_per_sample``: the measurement's inputs stage (the call's
inputs, drawn by numpy in the process's first call and taken from its
input cache after that, and their copy to the card, once a call, on its
first fill), summed over the window's calls, per sample.  ``None`` where
no call has the stage (a program that stages its inputs inside the
compile stage)."""


def read(run):
    if not run.samples or not any("inputs" in c["stage_s"] for c in run.calls):
        return None
    return sum(c["stage_s"].get("inputs", 0.0) for c in run.calls) / run.samples * 1e3
