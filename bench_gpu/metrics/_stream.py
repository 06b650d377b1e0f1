"""Helpers of the readers of ``pairing_stream``'s ranges (``stream.*``,
opened by the port's ``parallel/runner.py``).

A computed chunk is one ``stream.chunk`` range, a chunk read back from its
checkpoint one ``stream.resume`` range. The computed-chunk metrics are per
``stream.chunk`` range that starts in the traced window, the resume metric
per ``stream.resume`` range; each reads nothing where the trace holds none
(a program without these ranges).
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..tracing import Trace, _merge
from ._spans import PAGEABLE, PROGRAM

CHUNK = "stream.chunk"
RESUME = "stream.resume"
#: the program's ranges, with the stream's own
RANGES = PROGRAM + ("stream.",)


def count(trace: Trace, name: str) -> int:
    """Ranges named ``name`` that start in the traced window."""
    t0, t1 = trace.window
    return sum(1 for s in trace.named(name) if t0 <= s.ts <= t1)


def host_ms_per(trace: Trace, prefixes: Tuple[str, ...], per: str) -> Optional[float]:
    """Host ms inside the union of the ranges named ``prefixes*`` (within the
    window) per range ``per``; nothing without a ``per`` range."""
    n = count(trace, per)
    if not n:
        return None
    t0, t1 = trace.window
    ivs = _merge((max(s.ts, t0), min(s.end, t1)) for s in trace.spans
                 if s.name.startswith(prefixes))
    return sum(b - a for a, b in ivs) / 1e3 / n


def device_ms_per(trace: Trace, prefixes: Tuple[str, ...], per: str) -> Optional[float]:
    """Device ms of the kernels launched inside ranges ``prefixes*`` per
    range ``per``; nothing without a ``per`` range or such a kernel."""
    n = count(trace, per)
    kernels = trace.launched_in(trace.kernels(), prefixes)
    if not n or not kernels:
        return None
    return sum(k.dur for k in kernels) / 1e3 / n


def syncs_a_step(trace: Trace) -> Optional[float]:
    """Copies between the device and pageable host memory launched inside
    the program's ranges, ``stream.*`` among them, a step; nothing where the
    trace holds no ``stream.`` range."""
    if not trace.n_steps or not any(s.name.startswith("stream.") for s in trace.spans):
        return None
    t0, t1 = trace.window
    pageable = [o for o in trace.ops if o.cat == "gpu_memcpy" and o.name in PAGEABLE
                and o.launch is not None and t0 <= o.launch <= t1]
    return len(trace.launched_in(pageable, RANGES)) / trace.n_steps
