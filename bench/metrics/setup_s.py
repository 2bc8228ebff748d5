"""``setup_s``: process start to the window's first call: imports, CUDA
start-up, the kernel library (built by nvcc on a checkout's first run only),
one warm-up call of the cell's searcher, the profiler's first start."""


def read(run):
    return run.setup_s
