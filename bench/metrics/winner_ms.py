"""``winner_ms``: the mean, over the window's calls, of each call's winner's
kernel time, as the benchmark's own CUDA-event timer reads it at the cell's
size after the window (the answer a user gets)."""

from bench.harness.runner import config_key


def read(run):
    times = [run.winner_ms.get(config_key(c["winner"])) for c in run.calls]
    if not times or any(t is None for t in times):
        return None
    return sum(times) / len(times)
