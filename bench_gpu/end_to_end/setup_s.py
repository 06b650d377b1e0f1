"""Seconds from the start of the process to the first timed step: imports,
the port's kernel library (built with nvcc on a checkout's first run, then
loaded from its build cache), the inputs made from the seed and put on the
card, and the warm-up of the cell's own shapes."""


def read(window):
    return window.setup_s
