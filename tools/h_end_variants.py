#!/usr/bin/env python3
"""Kernel H's two modes, on one CUDA card, and the main path's H against the
parent commit's.

    python3 tools/h_end_variants.py [--parent DIR]

Builds the port's library (``ops/build.py``), then:

  1. prints ptxas's registers, stack, spills and static shared bytes and the
     SASS instruction count (``cuobjdump -sass``) of both instantiations of
     ``k_trajectory``: ``<true>`` stores every loop top and post-double (the
     Miller loop's Phase B), ``<false>`` the end state alone (the G2
     subgroup check);
  2. at 16384 and 65,536 lanes of random affine rows below 2p with settled
     limbs, on the subgroup check's 127 digits (``curves.g2.SUBGROUP_DIGITS``)
     and the Miller loop's 64: holds the end-only mode limb for limb against
     the end state of the storing mode (one kernel body, so the same
     digits), and at 16384 lanes against its plain version
     ``trajectory_end_plain`` on canonical values;
  3. times both modes on the 127 digits and the storing mode on the 64, with
     CUDA events, four turns in alternating order, each timing five launches
     back to back, the SM clock sampled before and after.

With ``--parent DIR`` (a checkout of the parent commit, e.g. unpacked with
``git archive`` into a git-ignored directory) it first builds that
checkout's ``csrc/trajectory.cu`` alone with ``ops/build.py``'s flags and
holds its ``k_trajectory`` against this tree's ``k_trajectory<true>``: the
SASS instructions and their encodings, the outputs limb for
limb at 16384 lanes on the Miller loop's digits, and the times, four turns
alternating parent and change.

It prints one JSON line. Any difference raises. Needs a CUDA device and
nvcc; prints the card's name and power limit first.
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
from k1617_variants import held, ptxas_report, timed  # noqa: E402
from pairing_tpu_torch.curves.g2 import SUBGROUP_DIGITS  # noqa: E402
from pairing_tpu_torch.ops import build, dispatch  # noqa: E402
from pairing_tpu_torch.ops import curve_kernels as CK  # noqa: E402
from pairing_tpu_torch.ops import fq12_kernels as FK  # noqa: E402
from pairing_tpu_torch.ops.build import sass, sass_count  # noqa: E402
from pairing_tpu_torch.pairing.miller_loop import STEP_DIGITS  # noqa: E402

OUT = ROOT / "build" / "h_end_variants"
SEED = 20261022
LANE_COUNTS = (16384, 65536)
#: The two instantiations, by the mangled name's template argument.
MODES = {"store": "k_trajectoryILb1E", "end_only": "k_trajectoryILb0E"}


def body(text: str) -> list:
    """One function's SASS instructions with their encodings: the lines
    that carry an encoding word, without the name line, the header flags
    and whatever cuobjdump prints after the function."""
    return [line.strip() for line in text.splitlines() if "/* 0x" in line]


def launcher(lib, q, digits, with_steps: bool):
    """A ctypes launch of pt_trajectory on ``q`` (storing or end-only), and
    its outputs."""
    lanes, n = q.shape[-1], len(digits)
    table = dispatch.device_table(tuple(digits), q.device)
    opts = dict(dtype=torch.int32, device=q.device)
    tops = torch.empty((n, 6, 21, lanes), **opts) if with_steps else None
    dbls = torch.empty((n, 6, 21, lanes), **opts) if with_steps else None
    end = torch.empty((6, 21, lanes), **opts)
    ptr = (lambda t: None if t is None else t.data_ptr())  # noqa: E731

    def run(reps: int = 1):
        for _ in range(reps):
            err = lib.pt_trajectory(q.data_ptr(), table.data_ptr(), n, ptr(tops), ptr(dbls),
                                    end.data_ptr(), lanes, torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"pt_trajectory: CUDA error {err}")

    return run, end


def build_parent(parent: Path) -> Path:
    """The parent checkout's csrc/trajectory.cu alone, as a shared library."""
    src = (parent / "pairing_tpu_torch" / "csrc" / "trajectory.cu").resolve()
    out = OUT / "parent"
    out.mkdir(parents=True, exist_ok=True)
    obj, lib = out / "trajectory.o", out / "libparent_trajectory.so"
    nvcc = build._nvcc()
    r = subprocess.run([nvcc, *build.NVCC_FLAGS, "-c", "-o", str(obj), str(src)], cwd=src.parent,
                       capture_output=True, text=True)
    check(r.returncode == 0, f"nvcc failed on the parent's trajectory.cu:\n{r.stdout}{r.stderr}")
    subprocess.run([nvcc, *build.ARCH_FLAGS, "-shared", "-o", str(lib), str(obj)], check=True)
    return lib


def against_parent(parent: Path, lib, lib_path, gen) -> dict:
    t0 = time.perf_counter()
    parent_lib = build_parent(parent)
    print(f"parent build {time.perf_counter() - t0:.1f} s", flush=True)
    plib = ctypes.CDLL(str(parent_lib))
    plib.pt_trajectory.argtypes = list(build.ENTRY_POINTS["pt_trajectory"])
    plib.pt_trajectory.restype = ctypes.c_int
    mine = next(v for k, v in sass(lib_path).items() if re.search(r"\d%sE" % MODES["store"], k))
    theirs = next(v for k, v in sass(parent_lib).items() if re.search(r"\dk_trajectoryE", k))
    identical = body(mine) == body(theirs)
    if not identical:
        diff = [(i, a, b) for i, (a, b) in enumerate(zip(body(mine), body(theirs))) if a != b]
        print(f"SASS lines that differ: {len(diff)} of {len(body(mine))}; the first: "
              f"{diff[:6]}", flush=True)
    report = {"sass": sass_count(mine), "parent_sass": sass_count(theirs),
              "sass_text_identical": identical}
    print(f"H k_trajectory<true> SASS {sass_count(mine)}, the parent's k_trajectory "
          f"{sass_count(theirs)}; instructions and encodings identical: {identical}", flush=True)
    lanes, digits = LANE_COUNTS[0], list(STEP_DIGITS)
    q = FK.random_kf12((4,), lanes, gen)
    runs, ends = {}, {}
    for which, handle in (("parent", plib), ("change", lib)):
        runs[which], ends[which] = launcher(handle, q, digits, True)
        runs[which]()
    held("H main mode, this tree against the parent", ends["change"], ends["parent"], True)
    report["times"] = timed(lambda which, reps: runs[which](reps),
                            {"parent": "parent", "change": "change"},
                            "H, Miller digits (64), storing mode", lanes)
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of the parent commit: also hold "
                    "the main path's H against its kernel")
    args = ap.parse_args()
    check(torch.cuda.is_available(), "needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    lib, info = build.load()
    print(f"library build {info.seconds:.1f} s", flush=True)
    results = {"card": card, "ptxas": {}}
    texts = sass(info.path)
    for mode, kern in MODES.items():
        props = ptxas_report(info.ptxas, kern)
        props["sass"] = sass_count(next(v for k, v in texts.items()
                                        if re.search(r"\d%sE" % kern, k)))
        props["dynamic_shared_bytes"] = lib.pt_trajectory_shared_bytes()
        results["ptxas"][mode] = props
        print(f"k_trajectory {mode}: {props}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    if args.parent is not None:
        results["against_parent"] = against_parent(args.parent, lib, info.path, gen)
    sub = [int(d) for d in SUBGROUP_DIGITS]
    results["times"] = {}
    for lanes in LANE_COUNTS:
        q = FK.random_kf12((4,), lanes, gen)
        runs, ends = {}, {}
        for name, digits, steps in (("end_only_127", sub, False), ("store_127", sub, True),
                                    ("end_only_64", list(STEP_DIGITS), False),
                                    ("store_64", list(STEP_DIGITS), True)):
            runs[name], ends[name] = launcher(lib, q, digits, steps)
            runs[name]()
        for n_digits in (127, 64):
            held(f"end-only mode on {n_digits} digits at {lanes} lanes, against the storing "
                 "mode's end", ends[f"end_only_{n_digits}"], ends[f"store_{n_digits}"], True)
        if lanes == LANE_COUNTS[0]:
            check(same(ends["end_only_127"], CK.trajectory_end_plain(q, sub)),
                  "end-only mode differs from trajectory_end_plain")
            print(f"end-only mode at {lanes} lanes equals trajectory_end_plain on canonical "
                  "values", flush=True)
        del runs["end_only_64"]
        results["times"][str(lanes)] = timed(lambda which, reps: runs[which](reps),
                                             {k: k for k in runs}, "H", lanes)
        del runs, ends
        torch.cuda.empty_cache()
    print(json.dumps(results))
    if "against_parent" in results:
        check(results["against_parent"]["sass_text_identical"],
              "k_trajectory<true>'s SASS differs from the parent's k_trajectory")
    return 0


if __name__ == "__main__":
    sys.exit(main())
