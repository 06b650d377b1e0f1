"""The 90th percentile of the wall time of every verify call in the window
(each from its start to the device synchronise that ends it), in ms: the
highest percentile with ten calls beyond it at about a hundred calls a
window. ``statistics.quantiles`` with n = 10, its default (exclusive)
method."""

import statistics


def read(window):
    times = [(b - a) * 1e3 for a, b, _ in window.steps]
    if len(times) < 2:
        return times[0] if times else None
    return statistics.quantiles(times, n=10)[8]
