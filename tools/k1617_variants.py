#!/usr/bin/env python3
"""Kernels K16 and K17: their design variants against the kernels they
replaced, on one CUDA card.

    python3 tools/k1617_variants.py [--parent DIR]

Builds ``tools/k1617_variants.cu`` (one nvcc, into the git-ignored
``build/k1617_variants/``; it includes ``csrc/pow_naf.cu`` and
``csrc/pow_w4.cu``) beside the port's library, then:

  1. prints ptxas's registers, stack, spills and static shared bytes, the
     dynamic shared bytes a block asks for and the SASS instruction count
     (``cuobjdump -sass``) of every kernel of the tool;
  2. at 16384 and 65,536 lanes of easy-part outputs, on BN_X's digits and on
     short digit vectors with negative digits (K17: one starting at a
     negative digit as well), holds every variant and the wrappers
     ``fused_kernels.pow_ladder`` / ``pow_ladder_w4`` limb for limb against
     the committed kernel, and the old kernel against it on canonical values
     and in the envelope; at 16384 lanes the committed kernels against the
     plain versions ``pow_ladder_plain`` / ``pow_ladder_w4_plain`` too;
  3. times each on BN_X's digits with CUDA events, four turns in
     alternating order, each timing one call of the C side that launches
     REPS_IN_C times back to back, the SM clock sampled before and after;

With ``--parent DIR`` (a checkout of the commit before this design, e.g.
unpacked with ``git archive``) it first builds that checkout's kernel
sources the way ``ops/build.py`` does and holds kernels C, D and K12, which
share ``csrc/field_group.cuh`` with K16 and K17, against the parent's in the
same process: the SASS of each (instruction count, and whether the text is
identical), the outputs limb for limb at 16384 lanes, and the times, four
turns alternating parent and change.

It prints one JSON line. Any difference raises. Needs a CUDA device and
nvcc; prints the card's name and power limit first.

K16 kinds: ``old`` (one thread per lane), ``committed`` (m and mc resident
in shared memory), ``staged`` (m or mc staged per nonzero digit, as kernel
D stages its row). K17 kinds: ``old``, ``committed`` (rows m^3, m^5, m^7 in
a global scratch, staged per nonzero digit; the table's steps and the
ladder's in one loop, one call site a routine), ``two_phase`` (the same
work with the table built before the loop), ``scratch4`` (m stored as a
scratch row too), ``rows3`` (the committed loop with m^3, m^5, m^7 resident
in shared memory, m from the input; 2 blocks of 4 warps an SM),
``rows4_4w`` (all four rows resident; one block of 4 warps an SM),
``rows4_2w`` (the same in blocks of 2 warps, three an SM).
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

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from fb_variants import TURNS, check, clock_mhz, same, sass, sass_count  # noqa: E402
from pairing_tpu_torch.ops import build  # noqa: E402
from pairing_tpu_torch.ops import fq12_kernels as FK  # noqa: E402
from pairing_tpu_torch.ops import fused_kernels as FU  # noqa: E402
from pairing_tpu_torch.ops import klayout as KL  # noqa: E402
from pairing_tpu_torch.pairing import miller_loop as ML  # noqa: E402
from pairing_tpu_torch.pairing.final_exp import easy_part_k  # noqa: E402

SOURCE = Path(__file__).resolve().parent / "k1617_variants.cu"
OUT = ROOT / "build" / "k1617_variants"
SEED = 20261021
LANE_COUNTS = (16384, 65536)
NAF_KINDS = {"old": 0, "committed": 1, "staged": 2}
W4_KINDS = {"old": 0, "committed": 1, "two_phase": 2, "scratch4": 3, "rows3": 4, "rows4_4w": 5,
            "rows4_2w": 6}
#: Short digit vectors with negative digits (tests/test_torch_fused_kernels.py's).
NAF_SHORT = ([0, -1, 1, 0, -1],)
W4_SHORT = ([3, 0, -5, 0, 7, -1, 0, 1], [-7, 0, -3, 5, 0, -1, 3])
#: Kernel name (a part of its mangled name) -> dynamic shared bytes a block.
F12 = 12 * 21 * 4
KERNELS = {
    "k_naf_old": 0, "k_pow_ladder": None, "k_naf_staged": 0,
    "k_w4_old": 0, "k_pow_ladder_w4": None, "k_w4_two_phase": 60560, "k_w4_scratch4": 60560,
    "k_w4_resILi3ELi4ELi2E": 20 * (5 * F12 + 4), "k_w4_resILi4ELi4ELi1E": 20 * (6 * F12 + 4),
    "k_w4_resILi4ELi2ELi3E": 10 * (6 * F12 + 4),
}
REPS_IN_C = 5
#: The group-core kernels that K16 and K17 share field_group.cuh with:
#: (C entry, kernel).
CORE = {"C": ("pt_miller_f", "k_miller_f"), "D": ("pt_pow_ladder_stream", "k_pow_ladder_stream"),
        "K12": ("pt_exp_bits", "k_exp_bits")}


def ptxas_report(log: str, kernel: str) -> dict:
    """Registers, stack, spills and static shared bytes of the entry whose
    mangled name holds ``kernel`` as a whole identifier (a length, the name,
    then the E that closes it)."""
    m = re.search(r"Compiling entry function '(_Z\w*?\d%sE\w*)'" % kernel, log)
    check(m is not None, f"ptxas report has no entry {kernel}")
    block = log[m.end():].split("Compiling entry function")[0]
    props = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      block)
    regs = re.search(r"Used (\d+) registers", block)
    smem = re.search(r"(\d+) bytes smem", block)
    return {"mangled": m.group(1), "registers": int(regs.group(1)),
            "stack_bytes": int(props.group(1)), "spill_store_bytes": int(props.group(2)),
            "spill_load_bytes": int(props.group(3)),
            "static_shared_bytes": int(smem.group(1)) if smem else 0}


def build_variants():
    nvcc = build._nvcc()
    OUT.mkdir(parents=True, exist_ok=True)
    obj, lib = OUT / "k1617_variants.o", OUT / "libk1617_variants.so"
    t0 = time.perf_counter()
    r = subprocess.run([nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-c", "-o", str(obj),
                        str(SOURCE)], capture_output=True, text=True)
    print(r.stdout + r.stderr, flush=True)
    if r.returncode != 0:
        raise RuntimeError("nvcc failed on k1617_variants.cu")
    subprocess.run([nvcc, *build.ARCH_FLAGS, "-shared", "-o", str(lib), str(obj)], check=True)
    print(f"variants build {time.perf_counter() - t0:.1f} s", flush=True)
    text = sass(obj)
    h = ctypes.CDLL(str(lib))
    report = {}
    for name, dyn in KERNELS.items():
        props = ptxas_report(r.stdout + r.stderr, name)
        if dyn is None:  # a committed kernel: its entry reports the bytes
            dyn = getattr(h, f"pt_{name[2:]}_shared_bytes")()
        props["dynamic_shared_bytes"] = dyn
        props["sass"] = sass_count(text[props["mangled"]])
        report[name] = props
        print(f"{name}: {props['registers']} registers, {props['stack_bytes']} B stack, spill "
              f"stores {props['spill_store_bytes']} B, loads {props['spill_load_bytes']} B, "
              f"{props['static_shared_bytes']} B static + {dyn} B dynamic shared a block, "
              f"{props['sass']} SASS", flush=True)
    p, i = ctypes.c_void_p, ctypes.c_int
    h.h_naf.argtypes = [i, p, p, p, i, p, i, i, p]
    h.h_w4.argtypes = [i, p, p, i, p, i, p, i, i, p]
    h.h_naf.restype = h.h_w4.restype = i
    return h, report


def timed(run, kinds: dict, label: str, lanes: int) -> dict:
    """Four turns, kinds in alternating order; each timing is one call of
    run(kind, REPS_IN_C), whose launches the C side makes back to back."""
    times = {k: [] for k in kinds}
    clocks = {k: [] for k in kinds}
    names = list(kinds)
    for turn in range(TURNS):
        for name in (names if turn % 2 == 0 else names[::-1]):
            run(kinds[name], 1)
            torch.cuda.synchronize()
            before = clock_mhz()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            run(kinds[name], REPS_IN_C)
            e1.record()
            torch.cuda.synchronize()
            times[name].append(e0.elapsed_time(e1) / REPS_IN_C)
            clocks[name].append((before, clock_mhz()))
    for k, v in times.items():
        print(f"{label} {k}: ms per launch at {lanes} lanes, turns {[round(t, 4) for t in v]}, "
              f"mean {sum(v) / len(v):.4f}; SM MHz before/after {clocks[k]}", flush=True)
    return {k: {"ms": v, "mean_ms": sum(v) / len(v), "sm_mhz": clocks[k]}
            for k, v in times.items()}


def held(name: str, got, want, committed: bool) -> None:
    torch.cuda.synchronize()
    if committed:
        ok = torch.equal(got, want)
    else:
        ok = same(got, want)
    print(f"{name}: {'limb-equal' if committed else 'equal on canonical values'} to the "
          f"committed kernel: {ok}", flush=True)
    check(ok, f"{name} differs")


def build_parent(parent: Path) -> Path:
    """The parent checkout's kernel library: one nvcc per source, started
    together, then one link, with ``ops/build.py``'s flags."""
    src = (parent / "pairing_tpu_torch" / "csrc").resolve()
    out = OUT / "parent"
    out.mkdir(parents=True, exist_ok=True)
    nvcc, units = build._nvcc(), sorted(src.glob("*.cu"))
    objs = [out / f"{u.stem}.o" for u in units]
    procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-c", "-o", str(o), str(u)], cwd=src,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for u, o in zip(units, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [f"{u.name}:\n{log}" for u, p, log in zip(units, procs, logs) if p.returncode != 0]
    check(not failed, "nvcc failed on the parent's sources:\n" + "\n".join(failed))
    lib = out / "libparent_kernels.so"
    subprocess.run([nvcc, *build.ARCH_FLAGS, "-shared", "-o", str(lib), *map(str, objs)],
                   check=True)
    return lib


def core_against_parent(parent: Path, gen, stream) -> dict:
    """Kernels C, D and K12 of this tree against the parent's, in one
    process on the same inputs."""
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
    m = easy_part_k(FK.random_kf12((12,), lanes, gen))
    tg, ch, ep = (FK.random_kf12((n, 6), lanes, gen) for n in (ML.N_STEPS, ML.N_ADDS, 2))
    sched_c = torch.as_tensor(FU.miller_schedule(ML.MILLER_FLAGS, ML.CHORD_ROWS), device="cuda")
    table, rows = FU.pow_x_table(m)
    digits = FU.BN_X_W4_DIGITS
    sched_d = torch.as_tensor(np.stack([(digits != 0).astype(np.int32), rows], axis=1),
                              device="cuda")
    bits = torch.as_tensor(FU.BN_X_BITS_MSB, device="cuda")
    out = torch.empty_like(m)
    k12_rows = torch.empty((len(bits), 12, 21, lanes), dtype=torch.int32, device="cuda")
    args = {"C": lambda: (tg.data_ptr(), ch.data_ptr(), ep.data_ptr(), sched_c.data_ptr(),
                          len(sched_c), 1, out.data_ptr(), 0, lanes, stream()),
            "D": lambda: (table.data_ptr(), sched_d.data_ptr(), len(digits), out.data_ptr(),
                          lanes, stream()),
            "K12": lambda: (m.data_ptr(), bits.data_ptr(), len(bits), k12_rows.data_ptr(),
                            lanes, stream())}
    for label, (entry, _) in CORE.items():
        result = k12_rows if label == "K12" else out

        def run(which, reps, label=label, entry=entry):
            fn = getattr(lib if which == "change" else plib, entry)
            for _ in range(reps):
                err = fn(*args[label]())
                if err != 0:
                    raise RuntimeError(f"{label} ({which}): launch failed, CUDA error {err}")

        run("parent", 1)
        torch.cuda.synchronize()
        want = result.clone()
        result.fill_(-1)
        run("change", 1)
        held(f"{label}, this tree against the parent", result, want, True)
        report[label]["times"] = timed(run, {"parent": "parent", "change": "change"}, label,
                                       lanes)
    return report


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of the parent commit: also hold "
                    "kernels C, D and K12 against its kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    h, report = build_variants()
    _, info = build.load()
    print(f"library build {info.seconds:.1f} s", flush=True)
    print("library SASS:", json.dumps({k: sass_count(v) for k, v in sass(info.path).items()
                                       if any(s in k for s in ("k_pow_ladder", "k_exp_bits",
                                                               "k_miller_f"))}), flush=True)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    results = {"ptxas": report}
    if args.parent is not None:
        results["core_against_parent"] = core_against_parent(args.parent, gen, stream)
    for lanes in LANE_COUNTS:
        m = easy_part_k(FK.random_kf12((12,), lanes, gen))
        mc = KL.kconj(m)
        cols = -(-lanes // FU.K17_BLOCK_LANES) * FU.K17_BLOCK_LANES
        tab = torch.empty((4, 12, 21, cols), dtype=torch.int32, device="cuda")
        out = torch.empty_like(m)

        def run_naf(kind, reps, digits):
            err = h.h_naf(kind, m.data_ptr(), mc.data_ptr(), digits.data_ptr(), len(digits),
                          out.data_ptr(), lanes, reps, stream())
            if err != 0:
                raise RuntimeError(f"K16 kind {kind}: launch failed, CUDA error {err}")
            return out

        def run_w4(kind, reps, digits):
            err = h.h_w4(kind, m.data_ptr(), digits.data_ptr(), len(digits), tab.data_ptr(), cols,
                         out.data_ptr(), lanes, reps, stream())
            if err != 0:
                raise RuntimeError(f"K17 kind {kind}: launch failed, CUDA error {err}")
            return out

        for family, run, kinds, vectors, wrapper, plain in (
                ("K16", run_naf, NAF_KINDS, (FU.BN_X_LADDER_DIGITS,) + NAF_SHORT,
                 lambda d: FU.pow_ladder(m, mc, d), lambda d: FU.pow_ladder_plain(m, mc, d)),
                ("K17", run_w4, W4_KINDS, (FU.BN_X_W4_DIGITS,) + W4_SHORT,
                 lambda d: FU.pow_ladder_w4(m, d), lambda d: FU.pow_ladder_w4_plain(m, d))):
            for vec in vectors:
                digits = torch.as_tensor(vec, dtype=torch.int32, device="cuda")
                tag = f"{family} {lanes} lanes, {len(vec)} digits"
                want = run(kinds["committed"], 1, digits).clone()
                if lanes == LANE_COUNTS[0] and vec[0] > 0:
                    check(same(want, plain(vec)), f"{tag}: committed kernel differs from plain")
                    print(f"{tag}: committed kernel equal to the plain version", flush=True)
                if vec[0] > 0:
                    held(f"{tag}, wrapper", wrapper(vec), want, True)
                for name, kind in kinds.items():
                    if name != "committed":
                        out.fill_(-1)
                        held(f"{tag}, {name}", run(kind, 1, digits), want, name != "old")
            digits = torch.as_tensor(vectors[0], dtype=torch.int32, device="cuda")
            results[f"{family}_{lanes}"] = timed(lambda k, r: run(k, r, digits), kinds, family,
                                                 lanes)
        del m, mc, tab, out
        torch.cuda.empty_cache()
    print(json.dumps({"k1617_variants": results, "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
