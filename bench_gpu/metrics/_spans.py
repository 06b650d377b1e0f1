"""Helpers of the readers of the port's own ranges: host time inside them,
and the blocking copies they launch.

A range nests inside others (``validate.g2_subgroup.ladder`` inside
``validate.g2_subgroup`` inside ``validate.inputs``), so the host time of a
set of ranges is that of the union of their intervals: each moment counts
once. A copy between the device and pageable host memory blocks the host
until the stream has drained and the copy is done; one is counted when its
launch call lies inside a range of the program.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from ..tracing import DeviceOp, Trace, _merge

#: the names of the program's ranges start with these (the benchmark's own
#: spans are ``bench.*``)
PROGRAM = ("pairing.", "validate.", "miller_loop.", "final_exp.", "witness.")
#: the trace's names of the copies to and from pageable host memory
PAGEABLE = ("Memcpy HtoD (Pageable -> Device)", "Memcpy DtoH (Device -> Pageable)")


def host_ms(trace: Trace, prefixes: Tuple[str, ...]) -> Optional[float]:
    """Host ms a step inside the union of the ranges named ``prefixes*``,
    within the traced window; nothing if no such range was traced."""
    t0, t1 = trace.window
    ivs = _merge((max(s.ts, t0), min(s.end, t1)) for s in trace.spans
                 if s.name.startswith(prefixes))
    if not trace.n_steps or not ivs:
        return None
    return sum(b - a for a, b in ivs) / 1e3 / trace.n_steps


def blocking_copies(trace: Trace) -> Optional[List[DeviceOp]]:
    """The pageable copies launched inside the program's ranges in the
    traced window, placed by their launch calls on the host's clock (a
    trace's device timestamps can sit milliseconds off it); nothing if the
    trace holds no such range."""
    if not trace.n_steps or not any(s.name.startswith(PROGRAM) for s in trace.spans):
        return None
    t0, t1 = trace.window
    pageable = [o for o in trace.ops if o.cat == "gpu_memcpy" and o.name in PAGEABLE
                and o.launch is not None and t0 <= o.launch <= t1]
    return trace.launched_in(pageable, PROGRAM)


def syncs_a_step(trace: Trace) -> Optional[float]:
    copies = blocking_copies(trace)
    return None if copies is None else len(copies) / trace.n_steps


def sync_wait_ms(trace: Trace) -> Optional[float]:
    """ms a step from each blocking copy's launch call to the end of the
    top-level host operation that made it (``aten::to``, say), which
    returns only once the stream has drained and the copy is done: the time
    the host waited, on the host's clock alone; a copy launched outside any
    host operation adds nothing."""
    copies = blocking_copies(trace)
    if copies is None:
        return None
    ops = trace._host_ops  # top-level host operations of the steps' thread, in order
    starts = [o.ts for o in ops]
    waited = 0.0
    for c in copies:
        i = bisect.bisect_right(starts, c.launch) - 1
        if i >= 0 and ops[i].end >= c.launch:
            waited += ops[i].end - c.launch
    return waited / 1e3 / trace.n_steps
