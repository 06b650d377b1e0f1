"""Helpers the per-layer metric readers share."""

from __future__ import annotations

from typing import Optional

from ..roofline import least_seconds
from ..tracing import Trace, kernel_name


def per_step_ms(trace: Trace, seconds: float) -> Optional[float]:
    """Seconds over the traced window -> ms a step (call or chunk)."""
    return seconds * 1e3 / trace.n_steps if trace.n_steps else None


def device_ms_in(trace: Trace, prefixes) -> Optional[float]:
    """Device ms a step of the kernels launched inside ranges ``prefixes*``;
    nothing if no kernel was launched there."""
    ks = trace.launched_in(trace.kernels(), tuple(prefixes))
    if not ks:
        return None
    return per_step_ms(trace, sum(k.dur for k in ks) / 1e6)


def idle_share(trace: Trace) -> Optional[float]:
    if not trace.n_steps or trace.window_s <= 0:
        return None
    return 1.0 - trace.busy_s / trace.window_s


def roofline_share(trace: Trace, model) -> Optional[float]:
    """The least time of ``model``'s kernel at the run's shapes over its
    mean device time in the trace, in %; nothing if the kernel did not run
    or the run reports no such shapes."""
    shapes = model.shapes_of(trace.shapes)
    times = [k.dur / 1e6 for k in trace.kernels() if kernel_name(k.name) == model.KERNEL]
    if shapes is None or not times:
        return None
    least = least_seconds(model.work(*shapes), model.n_bytes(*shapes))
    return 100.0 * least / (sum(times) / len(times))
