"""What the per-layer metrics read: a ``torch.profiler`` Chrome trace reduced
to spans, kernels and copies, with the counters and shapes a run reports.

A kernel belongs to every host range that holds its launch call (matched
by correlation id), as ``phase_profile_torch.py`` groups the port's
ranges. The traced window runs from the start of the first traced step
(the benchmark's ``bench.step`` span around one call or one hand-over) to
the end of the last. Device busy time is the union of the kernel, copy and
memset intervals inside the window; the rest of the window is idle.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

STEP = "bench.step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the port's kernels: ``k_*`` in namespace ``pt`` (``csrc/*.cu``)
_OWN_KERNEL = re.compile(r"^(void )?(pt::)?k_\w+")


@dataclasses.dataclass
class Span:
    name: str
    ts: float  # microseconds
    end: float


@dataclasses.dataclass
class DeviceOp:
    cat: str
    name: str
    ts: float
    end: float
    launch: Optional[float]  # host time of the launch call, if linked
    nbytes: int = 0

    @property
    def dur(self) -> float:
        return self.end - self.ts


def kernel_name(name: str) -> str:
    """A kernel's short name: no return type, the port's namespace, template
    arguments or parameters (``void pt::k_trajectory<true>(int const*, ...)``
    -> ``k_trajectory``)."""
    name = re.sub(r"^(void )?(pt::)?", "", name)
    return re.split(r"[<(]", name, maxsplit=1)[0][:80]


def is_own_kernel(name: str) -> bool:
    """A kernel of the port's own library (``csrc/*.cu``: ``pt::k_*``), as
    against PyTorch's kernels, which live in its namespaces."""
    return bool(_OWN_KERNEL.match(name))


class Trace:
    """One traced window.

    ``counters`` are numbers the run counted itself (bytes handed over, say)
    and ``shapes`` the sizes of its calls (products, pairs, lanes), both as
    the driver reports them."""

    def __init__(self, chrome: dict, counters: Optional[dict] = None,
                 shapes: Optional[dict] = None):
        events = chrome.get("traceEvents", [])
        self.counters = dict(counters or {})
        self.shapes = dict(shapes or {})
        self.spans: List[Span] = sorted(
            (Span(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("cat") == "user_annotation" and "dur" in e),
            key=lambda s: (s.ts, -s.end))
        self.steps = [s for s in self.spans if s.name == STEP]
        launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and "correlation" in e.get("args", {})}
        self.ops: List[DeviceOp] = sorted(
            (DeviceOp(e["cat"], e.get("name", ""), float(e["ts"]),
                      float(e["ts"]) + float(e.get("dur", 0)),
                      launches.get(e.get("args", {}).get("correlation")),
                      int(e.get("args", {}).get("bytes", 0) or 0))
             for e in events if e.get("cat") in DEVICE_CATS),
            key=lambda o: o.ts)
        steps_tids = {e.get("tid") for e in events
                      if e.get("cat") == "user_annotation" and e.get("name") == STEP}
        self._host_ops = _top_level(
            Span(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") == "cpu_op" and "dur" in e
            and e.get("tid") in steps_tids)

    # -- the window -------------------------------------------------------

    @property
    def n_steps(self) -> int:
        return len(self.steps)

    @property
    def window(self) -> Tuple[float, float]:
        if not self.steps:
            return (0.0, 0.0)
        return (self.steps[0].ts, max(s.end for s in self.steps))

    @property
    def window_s(self) -> float:
        t0, t1 = self.window
        return (t1 - t0) / 1e6

    def in_window(self, ops: Iterable[DeviceOp]) -> List[DeviceOp]:
        t0, t1 = self.window
        return [o for o in ops if o.ts >= t0 and o.end <= t1]

    def kernels(self) -> List[DeviceOp]:
        return self.in_window(o for o in self.ops if o.cat == "kernel")

    def copies(self, direction: str = "") -> List[DeviceOp]:
        return self.in_window(o for o in self.ops
                              if o.cat == "gpu_memcpy" and direction in o.name)

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    # -- ranges -----------------------------------------------------------

    def launched_in(self, ops: Sequence[DeviceOp], prefixes: Tuple[str, ...]) -> List[DeviceOp]:
        """The ops whose launch call lies inside a host range whose name
        starts with one of ``prefixes``."""
        ivs = _merge((s.ts, s.end) for s in self.spans if s.name.startswith(prefixes))
        starts = [a for a, _ in ivs]
        out = []
        for o in ops:
            if o.launch is None:
                continue
            i = bisect.bisect_right(starts, o.launch) - 1
            if i >= 0 and ivs[i][1] >= o.launch:
                out.append(o)
        return out

    def device_s_in(self, prefixes: Tuple[str, ...]) -> float:
        """Seconds of kernel time launched inside ranges named ``prefixes*``."""
        return sum(o.dur for o in self.launched_in(self.kernels(), prefixes)) / 1e6

    # -- busy and idle ----------------------------------------------------

    def busy_intervals(self) -> List[Tuple[float, float]]:
        t0, t1 = self.window
        return _merge((max(o.ts, t0), min(o.end, t1)) for o in self.ops
                      if o.end > t0 and o.ts < t1)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def idle_gaps(self) -> List[Tuple[float, float]]:
        t0, t1 = self.window
        gaps, at = [], t0
        for a, b in self.busy_intervals():
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if t1 > at:
            gaps.append((at, t1))
        return gaps

    def host_label(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost benchmark or
        program range and the top-level host operation (``python`` between
        operations)."""
        rng = _innermost(self.spans, t, skip=STEP)
        op = _innermost(self._host_ops, t, nested=False)
        return f"{rng.name if rng else 'outside ranges'} | {op.name if op else 'python'}"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps summed by what the host was doing, in seconds over the window."""
        by_op: Dict[str, float] = defaultdict(float)
        for o in self.in_window(self.ops):
            by_op[kernel_name(o.name) if o.cat == "kernel" else o.name[:80]] += o.dur / 1e6
        by_gap: Dict[str, float] = defaultdict(float)
        for a, b in self.idle_gaps():
            by_gap[self.host_label(a)] += (b - a) / 1e6
        return {"device_ops": sorted(([k, v] for k, v in by_op.items()),
                                     key=lambda kv: -kv[1])[:top],
                "idle_gaps": sorted(([k, v] for k, v in by_gap.items()),
                                    key=lambda kv: -kv[1])[:top]}


def _merge(ivs: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(ivs):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _top_level(spans: Iterable[Span]) -> List[Span]:
    out, end = [], float("-inf")
    for s in sorted(spans, key=lambda s: (s.ts, -s.end)):
        if s.ts >= end:
            out.append(s)
            end = s.end
    return out


def _innermost(spans: List[Span], t: float, skip: str = "", nested: bool = True
               ) -> Optional[Span]:
    """The span with the latest start that holds ``t`` (spans sorted by
    start; ``nested=False`` for spans that never overlap)."""
    lo, hi = 0, len(spans)
    while lo < hi:
        mid = (lo + hi) // 2
        if spans[mid].ts <= t:
            lo = mid + 1
        else:
            hi = mid
    for s in reversed(spans[max(0, lo - (256 if nested else 1)):lo]):
        if s.end >= t and s.name != skip:
            return s
    return None
