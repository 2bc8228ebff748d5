"""``mandelbrot_roofline``: the Mandelbrot kernel's bound over the
benchmark's CUDA-event time of the default config (all parameters 1) at the
cell's size, in percent.  The bound counts the operations these escape
counts need (``bench/reference/mandelbrot.py``) at the card's f32 rate, or
the image's bytes at its HBM rate, whichever is larger."""

from bench.harness.roofline import share


def read(run):
    return share(run, "mandelbrot")
