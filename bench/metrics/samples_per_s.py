"""``samples_per_s``: every sample the window's tune calls measured, over
the time from the window's start to the end of its last call (host clock).
It counts each call's input staging, search, timing and final
re-measurement: what a user pays card time for."""


def read(run):
    if not run.calls:
        return None
    return run.samples / (run.calls[-1]["t1"] - run.start)
