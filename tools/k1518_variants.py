#!/usr/bin/env python3
"""Kernels K18 and K15: their design variants against the kernels they
replaced, on one CUDA card.

    python3 tools/k1518_variants.py [--parent DIR]

Builds ``tools/k1518_variants.cu`` (one nvcc, into the git-ignored
``build/k1518_variants/``; it includes ``csrc/fq12_sq.cu`` and
``csrc/hard_chain.cu``) beside the port's library, then:

  1. prints ptxas's registers, stack, spills and static shared bytes, the
     dynamic shared bytes a block asks for and the SASS instruction count
     (``cuobjdump -sass``) of every kernel of the tool;
  2. at 16384 and 65,536 lanes: K18 on random operands below 2p with
     settled limbs, K15 on easy-part outputs m and their x-powers mx, mx2,
     mx3 (``pow_x_streamed``); holds every variant and the wrappers
     ``fq12_kernels.fq12_sq`` / ``fused_kernels.hard_chain`` limb for limb
     against the committed kernel, and the old kernel against it on
     canonical values and in the envelope; at 16384 lanes the committed
     kernels against the plain versions ``fq12_sq_plain`` /
     ``hard_chain_plain`` and K15 against the 29 launches of A, B and E
     (``final_exp.hard_part_chain_k(..., fused=False)``) too;
  3. times each with CUDA events, four turns in alternating order, each
     timing one call of the C side that launches REPS_IN_C times back to
     back, the SM clock sampled before and after; beside K15, the 29
     launches replayed from a CUDA graph (their device time, without the
     host's pace), in the same turns.

With ``--parent DIR`` (a checkout of the commit before this design, e.g.
unpacked with ``git archive``) it first builds that checkout's kernel
sources the way ``ops/build.py`` does and holds kernels A, B and E, which
share their term loops and tables with K18 and K15, against the parent's in
the same process: the SASS of each (instruction count, and whether the text
is identical), the outputs limb for limb at 16384 lanes (E on its four
programs: the conjugate, p, p^2, p^3), and the times, four turns
alternating parent and change, each timing a CUDA graph of REPS_IN_C calls.

It prints one JSON line. Any difference raises. Needs a CUDA device and
nvcc; prints the card's name and power limit first.

K18 kinds: ``old`` (one thread per lane), ``committed`` (rows staged in
shared memory), ``l1`` (every operand through L1, carried at each use).
K15 kinds: ``old`` (one thread per lane, the file in a global scratch),
``committed`` (registers 3-7 in shared memory), ``global`` (registers 3-7
in a global scratch of the shared file's layout), and ``launches29``.
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
from k1617_variants import REPS_IN_C, build_parent, held, ptxas_report, timed  # noqa: E402
from pairing_tpu_torch.ops import build  # noqa: E402
from pairing_tpu_torch.ops.build import sass, sass_count  # noqa: E402
from pairing_tpu_torch.ops import fq12_kernels as FK  # noqa: E402
from pairing_tpu_torch.ops import fused_kernels as FU  # noqa: E402
from pairing_tpu_torch.ops import klayout as KL  # noqa: E402
from pairing_tpu_torch.pairing.final_exp import easy_part_k, hard_part_chain_k  # noqa: E402

SOURCE = Path(__file__).resolve().parent / "k1518_variants.cu"
OUT = ROOT / "build" / "k1518_variants"
SEED = 20261022
LANE_COUNTS = (16384, 65536)
SQ_KINDS = {"old": 0, "committed": 1, "l1": 2}
CHAIN_KINDS = {"old": 0, "committed": 1, "global": 2}
#: Kernel name (a part of its mangled name) -> dynamic shared bytes a block
#: (None: the committed entry reports it).
KERNELS = {"k_sq_old": 0, "k_fq12_sq": 0, "k_sq_l1": 0,
           "k_chain_old": 0, "k_hard_chain": None, "k_chain_global": 0}
#: The kernels that share their term loops and tables with K18 and K15:
#: (C entry, kernel).
CORE = {"A": ("pt_fq12_mul", "k_fq12_mul"), "B": ("pt_fq12_cyc_sq", "k_fq12_cyc_sq"),
        "E": ("pt_fq12_slotwise", "k_fq12_slotwise")}


def build_variants():
    nvcc = build._nvcc()
    OUT.mkdir(parents=True, exist_ok=True)
    obj, lib = OUT / "k1518_variants.o", OUT / "libk1518_variants.so"
    t0 = time.perf_counter()
    r = subprocess.run([nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-c", "-o", str(obj),
                        str(SOURCE)], capture_output=True, text=True)
    print(r.stdout + r.stderr, flush=True)
    if r.returncode != 0:
        raise RuntimeError("nvcc failed on k1518_variants.cu")
    subprocess.run([nvcc, *build.ARCH_FLAGS, "-shared", "-o", str(lib), str(obj)], check=True)
    print(f"variants build {time.perf_counter() - t0:.1f} s", flush=True)
    text = sass(obj)
    h = ctypes.CDLL(str(lib))
    h.pt_hard_chain_shared_bytes.restype = ctypes.c_int
    report = {}
    for name, dyn in KERNELS.items():
        props = ptxas_report(r.stdout + r.stderr, name)
        props["dynamic_shared_bytes"] = h.pt_hard_chain_shared_bytes() if dyn is None else dyn
        props["sass"] = sass_count(text[props["mangled"]])
        report[name] = props
        print(f"{name}: {props['registers']} registers, {props['stack_bytes']} B stack, spill "
              f"stores {props['spill_store_bytes']} B, loads {props['spill_load_bytes']} B, "
              f"{props['static_shared_bytes']} B static + {props['dynamic_shared_bytes']} B "
              f"dynamic shared a block, {props['sass']} SASS", flush=True)
    p, i = ctypes.c_void_p, ctypes.c_int
    h.h_sq.argtypes = [i, p, p, i, i, p]
    h.h_chain.argtypes = [i, p, p, p, p, p, i, p, p, p, p, p, i, p, p, i, i, p]
    h.h_sq.restype = h.h_chain.restype = i
    h.h_chain_global_words.argtypes = [i]
    h.h_chain_global_words.restype = ctypes.c_longlong
    return h, report


def graphed(call, reps: int):
    """A CUDA graph of ``reps`` calls of ``call`` (warmed up on a side
    stream first); returns its replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            call()
    return graph.replay


def core_against_parent(parent: Path, gen, stream) -> dict:
    """Kernels A, B and E of this tree against the parent's, in one process
    on the same inputs."""
    t0 = time.perf_counter()
    parent_lib = build_parent(parent)
    print(f"parent build {time.perf_counter() - t0:.1f} s", flush=True)
    lib, info = build.load()
    plib = ctypes.CDLL(str(parent_lib))
    for entry, _ in CORE.values():
        fn = getattr(plib, entry)
        fn.argtypes, fn.restype = list(build.ENTRY_POINTS[entry]), ctypes.c_int
    mine, theirs = sass(info.path), sass(parent_lib)
    report = {}
    for label, (_, kern) in CORE.items():
        a = next(v for k, v in mine.items() if re.search(r"\d%sE" % kern, k))
        b = next(v for k, v in theirs.items() if re.search(r"\d%sE" % kern, k))
        report[label] = {"sass": sass_count(a), "parent_sass": sass_count(b),
                         "sass_text_identical": a == b}
        print(f"{label} ({kern}): SASS {sass_count(a)}, at the parent {sass_count(b)}; text "
              f"identical: {a == b}", flush=True)
    lanes = LANE_COUNTS[0]
    a, b = (FK.random_kf12((12,), lanes, gen) for _ in range(2))
    progs = [KL._slot_prog_host(pw) for pw in FU.SLOT_POWERS]
    out = torch.empty_like(a)
    outs = torch.empty((len(progs),) + tuple(a.shape), dtype=torch.int32, device="cuda")
    calls = {"A": lambda: [(a.data_ptr(), b.data_ptr(), 0x3F, out.data_ptr(), lanes, stream())],
             "B": lambda: [(a.data_ptr(), out.data_ptr(), lanes, stream())],
             "E": lambda: [(a.data_ptr(), ops.data_ptr(), consts.data_ptr(), outs[i].data_ptr(),
                            lanes, stream()) for i, (ops, consts) in enumerate(progs)]}
    for label, (entry, _) in CORE.items():
        result = outs if label == "E" else out

        def once(which, label=label, entry=entry):
            fn = getattr(lib if which == "change" else plib, entry)
            for args in calls[label]():
                err = fn(*args)
                if err != 0:
                    raise RuntimeError(f"{label} ({which}): launch failed, CUDA error {err}")

        once("parent")
        torch.cuda.synchronize()
        want = result.clone()
        result.fill_(-1)
        once("change")
        held(f"{label}, this tree against the parent", result, want, True)
        graphs = {w: graphed(lambda w=w: once(w), REPS_IN_C) for w in ("parent", "change")}

        def run(which, reps, once=once, graphs=graphs):
            if reps == 1:
                once(which)
            else:
                graphs[which]()

        report[label]["times"] = timed(run, {"parent": "parent", "change": "change"},
                                       f"{label} ({len(calls[label]())} launches a call)", lanes)
        del graphs
    return report


def chain_inputs(lanes: int, gen):
    m = easy_part_k(FK.random_kf12((12,), lanes, gen))
    mx = FU.pow_x_streamed(m)
    mx2 = FU.pow_x_streamed(mx)
    return m, mx, mx2, FU.pow_x_streamed(mx2)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of the parent commit: also hold "
                    "kernels A, B and E against its kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    h, report = build_variants()
    _, info = build.load()
    print(f"library build {info.seconds:.1f} s", flush=True)
    print("library SASS:", json.dumps({k: sass_count(v) for k, v in sass(info.path).items()
                                       if any(s in k for s in ("k_fq12_sq", "k_hard_chain",
                                                               "k_fq12_mul", "k_fq12_cyc_sq",
                                                               "k_fq12_slotwise"))}), flush=True)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    results = {"ptxas": report}
    if args.parent is not None:
        results["core_against_parent"] = core_against_parent(args.parent, gen, stream)
    prog, ops, consts = FU._hard_chain_consts()
    dprog, dops, dconsts = (t.cuda() for t in (prog, ops, consts))
    for lanes in LANE_COUNTS:
        a = FK.random_kf12((12,), lanes, gen)
        out = torch.empty_like(a)

        def run_sq(kind, reps):
            err = h.h_sq(kind, a.data_ptr(), out.data_ptr(), lanes, reps, stream())
            if err != 0:
                raise RuntimeError(f"K18 kind {kind}: launch failed, CUDA error {err}")
            return out

        tag = f"K18 {lanes} lanes"
        want = run_sq(SQ_KINDS["committed"], 1).clone()
        if lanes == LANE_COUNTS[0]:
            check(same(want, FK.fq12_sq_plain(a)), f"{tag}: committed kernel differs from plain")
            print(f"{tag}: committed kernel equal to the plain version", flush=True)
        held(f"{tag}, wrapper", FK.fq12_sq(a), want, True)
        for name, kind in SQ_KINDS.items():
            if name != "committed":
                out.fill_(-1)
                held(f"{tag}, {name}", run_sq(kind, 1), want, name != "old")
        results[f"K18_{lanes}"] = timed(run_sq, SQ_KINDS, "K18", lanes)
        del a, want

        xs = chain_inputs(lanes, gen)
        scratch = torch.empty(max(8 * 12 * 21 * lanes, h.h_chain_global_words(lanes)),
                              dtype=torch.int32, device="cuda")

        def run_chain(kind, reps):
            if kind == "launches29":
                if reps == 1:
                    out.copy_(hard_part_chain_k(*xs, fused=False))
                else:
                    replay()
                return out
            err = h.h_chain(kind, *(x.data_ptr() for x in xs), prog.data_ptr(), len(prog),
                            ops.data_ptr(), consts.data_ptr(), dprog.data_ptr(), dops.data_ptr(),
                            dconsts.data_ptr(), FU.HARD_CHAIN_OUT, scratch.data_ptr(),
                            out.data_ptr(), lanes, reps, stream())
            if err != 0:
                raise RuntimeError(f"K15 kind {kind}: launch failed, CUDA error {err}")
            return out

        tag = f"K15 {lanes} lanes"
        want = run_chain(CHAIN_KINDS["committed"], 1).clone()
        unfused = hard_part_chain_k(*xs, fused=False)
        check(same(want, unfused), f"{tag}: committed kernel differs from the 29 launches")
        print(f"{tag}: committed kernel equal to the 29 launches of A, B and E", flush=True)
        if lanes == LANE_COUNTS[0]:
            check(same(want, FU.hard_chain_plain(*xs)), f"{tag}: committed kernel differs from "
                  "plain")
            print(f"{tag}: committed kernel equal to the plain version", flush=True)
        held(f"{tag}, wrapper", FU.hard_chain(*xs), want, True)
        for name, kind in CHAIN_KINDS.items():
            if name != "committed":
                out.fill_(-1)
                held(f"{tag}, {name}", run_chain(kind, 1), want, name != "old")
        replay = graphed(lambda: hard_part_chain_k(*xs, fused=False), REPS_IN_C)
        results[f"K15_{lanes}"] = timed(run_chain, dict(CHAIN_KINDS, launches29="launches29"),
                                        "K15", lanes)
        del xs, scratch, out, unfused, replay
        torch.cuda.empty_cache()
    print(json.dumps({"k1518_variants": results, "device": torch.cuda.get_device_name(0)}))
    differ = [k for k, v in results.get("core_against_parent", {}).items()
              if not v["sass_text_identical"]]
    check(not differ, f"SASS differs from the parent's: {differ}")


if __name__ == "__main__":
    main()
