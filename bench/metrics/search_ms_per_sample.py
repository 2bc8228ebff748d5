"""``search_ms_per_sample``: the calls' host time outside the measurement's
stages (the searcher's proposals, its surrogate, the engine), summed over
the window and divided by its samples: sum of ``provenance.wall_s`` minus
sum of the backend's ``stage_s``, as ``chip_smoke.py``'s ``search_s``."""


def read(run):
    if not run.samples:
        return None
    outside = sum(c["wall_s"] - sum(c["stage_s"].values()) for c in run.calls)
    return outside / run.samples * 1e3
