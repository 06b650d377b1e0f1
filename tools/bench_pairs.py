#!/usr/bin/env python3
"""Parent against change on one card, in turns, through the benchmark.

    python3 tools/bench_pairs.py run --parent DIR --change DIR --out FILE \\
        CELL:SEED[,SEED...]:TRACE ...
    python3 tools/bench_pairs.py summary FILE ...

``run`` builds both checkouts' kernels together, then for each seed of each
spec runs ``bench_gpu/run.py --workload CELL --seed SEED --seconds 40
--trace TRACE`` in both checkouts, the order alternating from one seed to
the next, and appends one JSON record per run to FILE as it comes (the
side, cell, seed, exit code, the card's name, power limit and clock, the
result line). DIR is a checkout (``git archive`` of a commit unpacked into
a git-ignored directory, or the repository itself).

``summary`` prints, per cell, each end-to-end metric of the untraced runs
(both sides' medians, their spreads as the interquartile range over the
median from ``statistics.quantiles``, the ratio, and in how many pairs the
change read better) and each traced run's metrics and breakdown.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SECONDS = 40  # the benchmark's run_seconds
BETTER = {"call_ms_p90": "lower", "proofs_per_s": "higher", "witnesses_per_s": "higher",
          "setup_s": "lower"}


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def prebuild(sides: dict) -> None:
    procs = {k: subprocess.Popen([sys.executable, "-c",
                                  "from pairing_tpu_torch.ops import build; build.build()"],
                                 cwd=d) for k, d in sides.items()}
    for k, p in procs.items():
        if p.wait() != 0:
            raise SystemExit(f"{k}: the kernels did not build")


def run_one(sides: dict, side: str, cell: str, seed: int, trace: int, log) -> None:
    p = subprocess.run([sys.executable, "bench_gpu/run.py", "--workload", cell, "--seed",
                        str(seed), "--seconds", str(SECONDS), "--trace", str(trace)],
                       cwd=sides[side], capture_output=True, text=True, timeout=900)
    line = next((json.loads(ln) for ln in reversed(p.stdout.splitlines())
                 if ln.startswith("{")), None)
    rec = {"side": side, "cell": cell, "seed": seed, "trace": trace, "rc": p.returncode,
           "card": card(), "result": line}
    if line is None:
        rec["stderr"] = p.stderr[-3000:]
    log.write(json.dumps(rec) + "\n")
    log.flush()
    print(side, cell, seed, trace, "rc", p.returncode, "correct",
          (line or {}).get("correct"), flush=True)


def run(args) -> None:
    sides = {"parent": Path(args.parent).resolve(), "change": Path(args.change).resolve()}
    print(card(), flush=True)
    prebuild(sides)
    k = 0
    with open(args.out, "a") as log:
        for spec in args.specs:
            cell, seeds, trace = spec.split(":")
            for seed in seeds.split(","):
                order = ("parent", "change") if k % 2 == 0 else ("change", "parent")
                k += 1
                for side in order:
                    run_one(sides, side, cell, int(seed), int(trace), log)


def value(v):
    return v.get("value") if isinstance(v, dict) else v


def spread(v) -> float:
    if len(v) < 2:
        return float("nan")
    q = statistics.quantiles(v, n=4)
    return (q[2] - q[0]) / statistics.median(v)


def summary(args) -> None:
    recs = [json.loads(ln) for f in args.files for ln in open(f) if ln.strip()]
    by = collections.defaultdict(list)
    for r in recs:
        by[(r["cell"], r["trace"])].append(r)
    for (cell, trace), rs in sorted(by.items()):
        ok = all((r["result"] or {}).get("correct") for r in rs)
        print(f"== {cell} trace={trace}: {len(rs)} runs, all correct: {ok}; {rs[0]['card']}")
        if not trace:
            for m, better in BETTER.items():
                seeds = collections.defaultdict(dict)
                for r in rs:
                    v = value(((r["result"] or {}).get("metrics") or {}).get(m))
                    if v is not None:
                        seeds[r["seed"]][r["side"]] = v
                pairs = [(d["parent"], d["change"]) for d in seeds.values() if len(d) == 2]
                if not pairs:
                    continue
                par, chg = zip(*pairs)
                won = sum((c < p) if better == "lower" else (c > p) for p, c in pairs)
                mp, mc = statistics.median(par), statistics.median(chg)
                print(f"  {m}: parent {mp:.6g} (spread {spread(par):.4f}), change {mc:.6g} "
                      f"(spread {spread(chg):.4f}), change/parent {mc / mp:.4f}, change "
                      f"better in {won} of {len(pairs)}")
            continue
        for r in sorted(rs, key=lambda r: r["side"]):
            res = r["result"] or {}
            metrics = {k: value(v) for k, v in (res.get("metrics") or {}).items()}
            print(f"  {r['side']} seed {r['seed']}: {json.dumps(metrics)}")
            for k, rows in (res.get("breakdown") or {}).items():
                print(f"    {k}: " + "; ".join(f"{n} {v:.5f}" for n, v in rows))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--parent", required=True)
    r.add_argument("--change", required=True)
    r.add_argument("--out", required=True)
    r.add_argument("specs", nargs="+", help="CELL:SEED[,SEED...]:TRACE")
    s = sub.add_parser("summary")
    s.add_argument("files", nargs="+")
    args = ap.parse_args()
    run(args) if args.cmd == "run" else summary(args)


if __name__ == "__main__":
    main()
