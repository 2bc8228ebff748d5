"""``add_roofline``: the add kernel's bound over the benchmark's CUDA-event
time of the default config (all parameters 1) at the cell's size, in
percent.  The bound is the larger of the bytes the sum needs (two reads,
one write) over the card's HBM rate and its f32 operations over the f32
rate (``bench/reference/add.py``, ``bench/peaks.json``): bytes.  The
default config is the same work on every run, whatever the search picks."""

from bench.harness.roofline import share


def read(run):
    return share(run, "add")
