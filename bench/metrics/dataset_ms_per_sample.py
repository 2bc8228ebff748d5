"""``dataset_ms_per_sample``: the matrix's ``dataset`` stage (the session
measuring the configs of the sample dataset that serves ``rs`` and ``rf``,
paper section VI.B: their staging, warm launches and timed repeats), summed
over the window's records, per sample.  ``None`` where no record has the
stage (a cell of single tune calls, or a program without the stage)."""


def read(run):
    if not run.samples or not any("dataset" in c["stage_s"] for c in run.calls):
        return None
    return sum(c["stage_s"].get("dataset", 0.0) for c in run.calls) / run.samples * 1e3
