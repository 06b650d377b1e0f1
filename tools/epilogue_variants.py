#!/usr/bin/env python3
"""The Miller loop's epilogue kernels on one CUDA card, and kernels H and K
against the parent commit's.

    python3 tools/epilogue_variants.py [--parent DIR]

Builds the port's library (``ops/build.py``), then:

  1. prints ptxas's registers, stack, spills and static shared bytes and the
     SASS instruction count (``cuobjdump -sass``) of ``k_epilogue_points``,
     ``k_epilogue_lines``, both instantiations of ``k_trajectory`` (H) and
     ``k_lines`` (K), which share their mixed addition and chord with the
     epilogue through ``csrc/trajectory.cuh`` and ``csrc/lines.cuh``;
  2. at 16384 and 65,536 lanes of random operands below 2p with settled
     limbs, holds each epilogue kernel against its plain version (the eager
     code) on canonical values, and times kernel and plain version with
     CUDA events, four turns in alternating order, each timing five calls
     back to back, the SM clock sampled before and after.

With ``--parent DIR`` (a checkout of the parent commit, e.g. unpacked with
``git archive`` into a git-ignored directory) it first builds that
checkout's library with ``ops/build.py``'s flags and holds H's storing mode
on the Miller loop's digits, its end-only mode on the subgroup check's and
K on the Miller loop's schedule against this tree's: SASS instructions (and
whether their text is identical), outputs limb for limb, and times at
16384 and 65,536 lanes, four turns alternating parent and change.

It prints one JSON line. Any difference in outputs raises. Needs a CUDA
device and nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from fb_variants import check, same  # noqa: E402
from h_end_variants import body, launcher  # noqa: E402
from k1617_variants import build_parent, held, ptxas_report, timed  # noqa: E402
from pairing_tpu_torch.curves.g2 import SUBGROUP_DIGITS  # noqa: E402
from pairing_tpu_torch.ops import build  # noqa: E402
from pairing_tpu_torch.ops import curve_kernels as CK  # noqa: E402
from pairing_tpu_torch.ops import fq12_kernels as FK  # noqa: E402
from pairing_tpu_torch.ops import line_kernels as LK  # noqa: E402
from pairing_tpu_torch.ops.build import sass, sass_count  # noqa: E402
from pairing_tpu_torch.pairing import miller_loop as ML  # noqa: E402

SEED = 20261023
LANE_COUNTS = (16384, 65536)
#: The kernels whose build this tool reports, by the name in their mangled
#: symbol (H's instantiations by the template argument).
KERNELS = {"epilogue_points": "k_epilogue_points", "epilogue_lines": "k_epilogue_lines",
           "H_store": "k_trajectoryILb1E", "H_end_only": "k_trajectoryILb0E", "K": "k_lines"}


def symbol(texts: dict, kernel: str) -> str:
    """The SASS text of the function whose mangled name holds ``kernel``."""
    return next(v for k, v in texts.items() if re.search(r"\d%sE" % kernel, k))


def lines_launcher(lib, lanes, gen):
    """A ctypes launch of pt_lines on the Miller loop's schedule over random
    operands, and its outputs."""
    n = ML.N_STEPS
    tops, dbls = FK.random_kf12((n, 6), lanes, gen), FK.random_kf12((n, 6), lanes, gen)
    zinv, pq = FK.random_kf12((2 * n + 2, 2), lanes, gen), FK.random_kf12((6,), lanes, gen)
    chords = LK.chord_table(tuple(ML.STEP_DIGITS), tuple(ML.CHORD_ROWS[:n]), ML.N_ADDS,
                            tops.device)
    opts = dict(dtype=torch.int32, device="cuda")
    tg = torch.empty((n, 6, 21, lanes), **opts)
    ch = torch.empty((ML.N_ADDS, 6, 21, lanes), **opts)

    def run(reps: int = 1):
        for _ in range(reps):
            err = lib.pt_lines(tops.data_ptr(), dbls.data_ptr(), zinv.data_ptr(), pq.data_ptr(),
                               chords.data_ptr(), n, chords.shape[0], tg.data_ptr(),
                               ch.data_ptr(), lanes, torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"pt_lines: CUDA error {err}")

    return run, (tg, ch)


def against_parent(parent: Path, lib, lib_path, gen) -> dict:
    t0 = time.perf_counter()
    parent_lib = build_parent(parent)
    print(f"parent build {time.perf_counter() - t0:.1f} s", flush=True)
    plib = ctypes.CDLL(str(parent_lib))
    for entry in ("pt_trajectory", "pt_lines"):
        fn = getattr(plib, entry)
        fn.argtypes = list(build.ENTRY_POINTS[entry])
        fn.restype = ctypes.c_int
    mine_texts, theirs_texts = sass(lib_path), sass(parent_lib)
    report = {"sass": {}}
    for name in ("H_store", "H_end_only", "K"):
        mine, theirs = symbol(mine_texts, KERNELS[name]), symbol(theirs_texts, KERNELS[name])
        report["sass"][name] = {"change": sass_count(mine), "parent": sass_count(theirs),
                                "text_identical": body(mine) == body(theirs)}
        print(f"{name}: SASS {report['sass'][name]}", flush=True)
    report["times"] = {}
    for lanes in LANE_COUNTS:
        q = FK.random_kf12((4,), lanes, gen)
        g = torch.Generator(device="cuda")
        runs, outs = {}, {}
        for which, handle in (("parent", plib), ("change", lib)):
            runs[f"H_store_{which}"], outs[f"H_store_{which}"] = launcher(
                handle, q, list(ML.STEP_DIGITS), True)
            runs[f"H_end_only_{which}"], outs[f"H_end_only_{which}"] = launcher(
                handle, q, [int(d) for d in SUBGROUP_DIGITS], False)
            g.manual_seed(SEED + lanes)  # the same operands on both sides
            runs[f"K_{which}"], outs[f"K_{which}"] = lines_launcher(handle, lanes, g)
        for run in runs.values():
            run()
        for name in ("H_store", "H_end_only", "K"):
            got, want = outs[f"{name}_change"], outs[f"{name}_parent"]
            for a, b in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                held(f"{name} at {lanes} lanes, this tree against the parent", a, b, True)
        report["times"][str(lanes)] = {}
        for name in ("H_store", "H_end_only", "K"):
            kinds = {"parent": f"{name}_parent", "change": f"{name}_change"}
            report["times"][str(lanes)][name] = timed(
                lambda which, reps: runs[which](reps), kinds, name, lanes)
        del runs, outs
        torch.cuda.empty_cache()
    return report


def epilogue_times(gen) -> dict:
    out = {}
    for lanes in LANE_COUNTS:
        q_rows, end = FK.random_kf12((4,), lanes, gen), FK.random_kf12((6,), lanes, gen)
        q1, nq2, st91 = CK.epilogue_points(q_rows, end)
        largs = (end, st91, FK.random_kf12((2, 2), lanes, gen), FK.random_kf12((2,), lanes, gen),
                 q1, nq2)
        for got, want in zip(CK.epilogue_points(q_rows, end),
                             CK.epilogue_points_plain(q_rows, end)):
            check(same(got, want), f"epilogue_points differs from plain at {lanes} lanes")
        check(same(LK.epilogue_lines(*largs), LK.epilogue_lines_plain(*largs)),
              f"epilogue_lines differs from plain at {lanes} lanes")
        print(f"epilogue kernels at {lanes} lanes: equal to their plain versions", flush=True)

        def run(which, reps):
            for _ in range(reps):
                if which.startswith("points"):
                    (CK.epilogue_points if which.endswith("kernel")
                     else CK.epilogue_points_plain)(q_rows, end)
                else:
                    (LK.epilogue_lines if which.endswith("kernel")
                     else LK.epilogue_lines_plain)(*largs)

        kinds = {k: k for k in ("points_kernel", "points_plain", "lines_kernel", "lines_plain")}
        out[str(lanes)] = timed(run, kinds, "epilogue", lanes)
        del q_rows, end, q1, nq2, st91, largs
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of the parent commit: also hold "
                    "H and K against its kernels")
    args = ap.parse_args()
    check(torch.cuda.is_available(), "needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    lib, info = build.load()
    print(f"library build {info.seconds:.1f} s", flush=True)
    results = {"card": card, "ptxas": {}}
    texts = sass(info.path)
    for name, kern in KERNELS.items():
        props = ptxas_report(info.ptxas, kern)
        props["sass"] = sass_count(symbol(texts, kern))
        results["ptxas"][name] = props
        print(f"{name}: {props}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    if args.parent is not None:
        results["against_parent"] = against_parent(args.parent, lib, info.path, gen)
    results["epilogue"] = epilogue_times(gen)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
