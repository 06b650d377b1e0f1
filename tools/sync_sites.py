#!/usr/bin/env python3
"""The blocking host-to-device copies of the port's entries, by range and by
Python site, on one CUDA card.

    python3 tools/sync_sites.py

For ``validate_inputs`` at 256 lanes, ``multi_pairing`` at 256 products of 4
pairs and a 2-chunk ``witness_stream`` of 64 lanes a chunk (the entries of
``tests/test_torch_spans.py``'s card case), after a warm-up call each:

  1. under ``torch.profiler``, the copies to or from pageable host memory
     (each a full stream sync) counted by the innermost program range open
     at the copy's launch call;
  2. under ``torch.cuda.set_sync_debug_mode("warn")``, the synchronising
     operations counted by the innermost three frames of the port that
     made them (``file:line < caller < caller``).

Prints one JSON object per entry. Needs a CUDA device.
"""

from __future__ import annotations

import collections
import json
import sys
import traceback
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import test_torch_spans as S  # noqa: E402


def by_site(fn) -> collections.Counter:
    found = collections.Counter()
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if S.SYNC_WARNING in str(message):
            frames = [f for f in traceback.extract_stack() if "pairing_tpu_torch" in f.filename]
            found[" < ".join(f"{f.filename.split('pairing_tpu_torch/')[-1]}:{f.lineno}"
                             for f in frames[-1:-4:-1])] += 1

    warnings.showwarning = show
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        warnings.showwarning = shown
    return found


def by_range(fn):
    events, syncs = S.profile_on_card(fn)
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith(S.PROGRAM)]
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    out = collections.Counter()
    for e in events:
        if e.get("cat") == "gpu_memcpy" and e["name"] in S.PAGEABLE:
            t = launch.get(e.get("args", {}).get("correlation"))
            holders = [s for s in spans if t is not None and s[1] <= t <= s[2]]
            out[min(holders, key=lambda s: s[2] - s[1])[0] if holders else None] += 1
    return out, syncs


def entries() -> dict:
    import pairing_tpu_torch as pt
    from pairing_tpu_torch.utils.interop import map_limbs, reshape_points
    from pairing_tpu_torch.witness.stream import witness_stream

    products, pairs, chunk = 256, 4, 64
    p, q = S._points(8, "cuda")

    def lanes(pts, n):
        return map_limbs(pts, lambda t: t.repeat(-(-n // t.shape[0]), 1)[:n])

    ps = reshape_points(lanes(p, products * pairs), (pairs, products))
    qs = reshape_points(lanes(q, products * pairs), (pairs, products))
    pw, qw = lanes(p, 2 * chunk), lanes(q, 2 * chunk)
    p1, q1 = map_limbs(ps, lambda t: t[0]), map_limbs(qs, lambda t: t[0])
    return {"validate_inputs": lambda: pt.validate_inputs(p1, q1),
            "multi_pairing": lambda: pt.multi_pairing(ps, qs),
            "witness_stream": lambda: [s for s, _, _ in witness_stream(pw, qw, chunk)]}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    for name, fn in entries().items():
        fn()
        torch.cuda.synchronize()
        ranges, syncs = by_range(fn)
        print(json.dumps({"entry": name, "syncs": syncs, "by_range": dict(ranges),
                          "by_site": dict(by_site(fn).most_common())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
