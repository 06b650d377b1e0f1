#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's paths, on one CUDA card.

    python3 phase_profile_torch.py [--entry pairing|multi_pairing|pairing_witness]
                                   [--batch 16384] [--pairs 4] [--unique 16] [--reps 3]
                                   [--fused-chain]

Times whole calls of the entry point between device synchronisations:
``pairing`` over ``--batch`` lanes, ``multi_pairing`` over ``--batch``
products of ``--pairs`` pairs each, or ``pairing_witness`` (trace
generation, no serialization) over ``--batch`` lanes. Then it profiles one
more call with ``torch.profiler``. The per-phase numbers come from the
``record_function`` ranges that the Miller loop, the final exponentiation
and the witness collection open around their phases (``miller_loop.*``,
``final_exp.*``, ``witness.*``): for each range, read from the profiled
call's Chrome trace, its host span and the device time of the kernels
launched inside it. Device busy time is summed
over kernel events of that same profiled call, so the idle share pairs busy
and wall time of one run. ``--fused-chain`` sets PAIRING_FUSED_CHAIN, so
every final exponentiation runs its hard-part chain as one launch of kernel
K15 instead of 29 launches of A, B and E; the ``final_exp.hard_chain``
range then holds that one kernel. Prints the card's name and power limit,
then one JSON line. Needs a CUDA device; the correctness checks live in
chip_smoke.py.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

PHASE_PREFIXES = ("miller_loop.", "final_exp.", "witness.")


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_device_times(trace: dict) -> dict:
    """Per phase range of a Chrome trace: host span, and the device time and
    count of the kernels launched inside it (a kernel belongs to the range
    that holds its launch call, matched by correlation id). Kernels launched
    outside every range are reported under "outside_phases"."""
    events = trace["traceEvents"]
    ranges = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith(PHASE_PREFIXES)]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    out = {name: {"host_s": 0.0, "device_s": 0.0, "kernels": 0} for name, _, _ in ranges}
    out["outside_phases"] = {"host_s": None, "device_s": 0.0, "kernels": 0}
    for name, t0, t1 in ranges:
        out[name]["host_s"] += (t1 - t0) / 1e6
    for e in events:
        if e.get("cat") != "kernel":
            continue
        ts = launched.get(e.get("args", {}).get("correlation"))
        name = next((n for n, t0, t1 in ranges if ts is not None and t0 <= ts <= t1),
                    "outside_phases")
        out[name]["device_s"] += e["dur"] / 1e6
        out[name]["kernels"] += 1
    return out


def profile_call(fn, trace_path: Path, top: int = 12) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _sync_time(fn)
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    phases = phase_device_times(json.loads(trace_path.read_text()))
    # kernel events only: ranges mirrored onto the device timeline are skipped
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.key.startswith(PHASE_PREFIXES)]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {
        "profiled_wall_s": wall,
        "device_busy_s": busy,
        "idle_share": 1.0 - busy / wall,
        "kernel_launches": sum(e.count for e in kernels),
        "phases": phases,
        "top_kernels": [[e.key[:80], e.count, e.self_device_time_total / 1e3]
                        for e in kernels[:top]],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--entry", choices=("pairing", "multi_pairing", "pairing_witness"),
                    default="pairing")
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--pairs", type=int, default=4, help="K of multi_pairing")
    ap.add_argument("--unique", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--fused-chain", action="store_true",
                    help="run the hard-part chain as one kernel (PAIRING_FUSED_CHAIN)")
    ap.add_argument("--trace", type=Path,
                    default=Path(__file__).resolve().parent / "build" / "phase_profile_trace.json",
                    help="where the profiled call's Chrome trace is written")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("phase_profile_torch: needs a CUDA device", file=sys.stderr)
        return 1
    if args.fused_chain:
        os.environ["PAIRING_FUSED_CHAIN"] = "1"

    import pairing_tpu_torch as pt
    from pairing_tpu_torch import witness as W
    from pairing_tpu_torch.ops import build
    from pairing_tpu_torch.oracle import native as o
    from pairing_tpu_torch.utils import bn254 as c
    from pairing_tpu_torch.utils.interop import map_limbs

    build.load()
    rng = np.random.default_rng(args.seed)
    ks = [int.from_bytes(rng.bytes(32), "little") % (c.R_SCALAR - 1) + 1
          for _ in range(2 * args.unique)]
    g1s = [o.g1_mul(c.G1_GEN, k) for k in ks[: args.unique]]
    g2s = [o.g2_mul((c.G2_GEN_X, c.G2_GEN_Y), k) for k in ks[args.unique:]]
    shape = (args.pairs, args.batch) if args.entry == "multi_pairing" else (args.batch,)
    lanes = int(np.prod(shape))
    reps = -(-lanes // args.unique)

    def tile(limbs):
        return limbs.repeat(reps, 1)[:lanes].reshape(shape + (limbs.shape[-1],))

    p = map_limbs(pt.g1_from_ints(g1s, "cuda"), tile)
    q = map_limbs(pt.g2_from_ints(g2s, "cuda"), tile)
    fn = {"pairing": lambda: pt.pairing(p, q),
          "multi_pairing": lambda: pt.multi_pairing(p, q),
          "pairing_witness": lambda: W.pairing_witness(p, q)}[args.entry]

    _, warm = _sync_time(fn)
    whole = [_sync_time(fn)[1] for _ in range(args.reps)]
    prof = profile_call(fn, args.trace)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card)
    print(json.dumps({"entry": args.entry, "batch": args.batch,
                      "pairs": args.pairs if args.entry == "multi_pairing" else 1,
                      "fused_chain": args.fused_chain,
                      "warmup_s": warm, "call_s": whole, "profile": prof}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
