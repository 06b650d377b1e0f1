#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the BN254 pairing once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit (nvcc). It

  1. prints the card and builds the port's kernels from ``pairing_tpu_torch/
     csrc`` (one nvcc per source, in parallel; build seconds, ptxas
     registers and spills);
  2. checks every kernel and kernel mode against its plain PyTorch version
     on seeded operands made on the card, values below 2p with settled limbs:
     the eleven of the main path (A dense Fq12 product, B cyclotomic square,
     C Miller f-accumulation, D streamed x-power ladder, E conjugate/
     Frobenius, F Fq power, G Fq12 inverse, H point trajectory, I/J the two
     batch-inversion passes, K lines) at its shapes, then kernel C with K = 4
     pairs per product and with per-step collection, K12 the witness bit
     ladder and K13 the affine export at the witness path's shapes. Canonical
     values must be equal (tolerance zero: exact integer arithmetic) and
     every output limb in [0, 2^13 + 1], every value below 2p; prints both
     times and the kernel's bound on this card;
  3. runs the main path, ``pairing_tpu_torch.pairing`` at batch 16384 with
     256 distinct seeded pairs tiled: all 256 distinct lanes must equal the
     port's pure-integer oracle, every tiled lane its original, and each of
     the eleven kernels must have launched; prints pairings/s;
  4. runs ``multi_pairing`` at K = 4 over 16384 products (65,536 pairs from
     the same 256 distinct pairs): the first 64 products must equal the
     oracle's, every tiled product its original; prints products/s and
     pairings/s;
  5. runs ``pairing_witness`` over the main path's 16384 lanes: its output
     must equal ``pairing``'s lane for lane; prints witnesses/s for trace
     generation on the device (no serialization) and the peak device
     memory; writes the first 16 lanes with ``save_pairing_witness`` and
     both of the port's checkers must accept them;
  6. runs ``multi_pairing_witness`` at K = 4 on 64 products, writes all of
     it, and both checkers must accept it;
  7. runs the final exponentiation's other routes on the main path's lanes:
     ``pairing`` with the fused hard-part chain (PAIRING_FUSED_CHAIN, kernel
     K15), equal to the unfused run on every lane, with pairings/s of both
     forms; the split ``hard_part(easy_part(f))`` on the main path's Miller
     outputs (K17 three times, G once), equal to the oracle's final_exp;
     ``fq12_pow`` at 16384 lanes of 256 distinct random elements for
     e = 0b101101110101 and e = BN_X (K18, A, G), equal to the oracle; and
     the kernel-layout ops ``kmul_sparse`` (both line shapes), ``pow_ladder``
     (K16) and ``ksq`` (K18) at 16384 lanes;
  8. runs ``validate_inputs`` at 16384 lanes of the main path's pairs with
     four bad lanes at fixed positions (a Q on the twist outside G2, P =
     (5, 5), P = (0, 0), a Q off the twist): both masks, with and without
     the subgroup check, must equal the oracle's lane for lane, and kernel
     H's end-only mode (``trajectory_end``) must have launched; prints the
     call's ms, the mode's time and bound and the peak device memory;
  9. runs ``parallel.runner.pairing_stream`` over 40,000 pairs (the main
     path's pairs tiled) in chunks of 16384 on the card, checkpointed into
     a temporary directory: two full chunks and a ragged tail, every lane
     equal to the oracle's value of its pair; runs it again to resume from
     the checkpoints (equal arrays) and once against changed inputs (it
     must refuse); prints pairs/s (the codec's and the host's time
     included);
 10. runs ``witness.stream.witness_stream`` over the main path's pairs tiled
     to 65,536 lanes: a warm-up pass in chunks of 16384 in which every
     chunk's ``out`` must equal ``pairing``'s canonical values on its lanes
     and the first and the last chunk's host trace must equal, leaf for
     leaf, a one-shot ``pairing_witness`` of those lanes copied out; then
     timed passes in chunks of 16384 and of 8192 (each chunk's ``out``
     checked after the clock): streamed witnesses/s with the trace on the
     host, the same chunks computed and copied one after the other, the
     one-shot rate on the device, host bytes a chunk, the first chunk's
     time apart, and peak device memory, which must stay at most twice the
     one-shot peak;
 11. runs the parallel layer on the one card: ``launch.init_distributed``
     over NCCL with a world of one, ``mesh.pairing_data_parallel`` at 16384
     lanes and ``mesh.multi_pairing_sharded`` at K = 4 over 16384 products,
     equal to ``pairing`` and ``multi_pairing`` lane for lane with their
     kernels launched, the all-gather collective over NCCL, and
     ``pairing_stream`` with ``mesh_shape=(1,)`` equal to step 9's run;
     then two processes of ``python -m pairing_tpu_torch.parallel.launch
     --backend gloo --device cuda`` sharing the card (their own timeout),
     each of which must print OK;
 12. prints one JSON line of per-kernel results, the card's name and power
     limit, and last ``{"ok": true, "device": {...}}``.

Step 2 also holds B on random inputs beside cyclotomic ones, K15, K16,
K17, K18 and kernel A's sparse mode (both line shapes) against their plain
versions, H's end-only mode (the G2 subgroup check's 127 digits) at 16384
lanes and at 1029, and runs K16, K17 and D on the same m:
the three ladder designs for m^BN_X side by side, and K15 beside the 29
launches of A, B and E it replaces (launched call by call and replayed
from a CUDA graph). The entries of the redesigned kernels, A, B, E, K18
and K15 (A in both modes; one thread per output component and lane), C
(all three modes), D, K12, K16 and K17 (six threads a lane), F (one thread
a lane, G's window chain), G (three launches: the tower to the norm and
back one thread per output component, the Fermat chain one thread per
lane), H (two; both modes), I (two), J (four), K (one thread per line and lane) and
K13 (one thread per state and lane), in the JSON line also carry their
registers, stack, spill and shared bytes per block from this build's
ptxas report and their SASS instruction count (``cuobjdump -sass``; G's
second and third kernels under ``ptxas_more``; the shared memory of G, H,
K12, K15, K16 and K17 is dynamic, so the report shows none; their entries
give the bytes they ask for at launch). ``fq12_pow``'s lines give its
device time and its K18 launches. The entries of I, J and F also
carry their times at the K = 4 path's 65,536 lanes; E's carries each
program's device time (replayed from a CUDA graph: launched call by call
E would be timed at the host's pace, kept as ``ms_eager``) and bound
under ``programs`` (the conjugate and the powers 1, 2, 3), its ms and
bound the means of theirs. K13 is also checked in the witness
path's segment form. Every kernel's line gives its share of its bound.
Launch counts are set to 0 just before each of the paths of steps 3-11 and
read just after; every kernel the path runs must have launched in it.

Any failed check raises, so the script exits non-zero and prints no result
line; it also fails at once without a CUDA device. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

BATCH = 16384
UNIQUE = 256
K_PAIRS = 4
WITNESS_CUT = 16
MULTI_WITNESS_PRODUCTS = 64
SEED = 20261016
DEVICE = "cuda"
KERNEL_REPS = 10
WIDE = K_PAIRS * BATCH  # lanes of phases B, N and C on the K = 4 path
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# CUDA C++ Programming Guide throughput table, cc 9.0; tools/fb_variants.py's
# IMAD loop measured 63.67-64.02 on an H100 80GB HBM3 at 700 W
IMADS_PER_SM_CLOCK = 64
SMS = 132

KERNEL_SOURCES = {
    "fq12_mul": ("pairing_tpu_torch/csrc/fq12_mul.cu", "pairing_tpu/ops/fq12_kernels.py:275"),
    "fq12_cyc_sq": ("pairing_tpu_torch/csrc/cyc_sq.cu", "pairing_tpu/ops/klayout.py:120"),
    "miller_f": ("pairing_tpu_torch/csrc/miller_f.cu", "pairing_tpu/ops/fused_kernels.py:260"),
    "miller_f_multi": ("pairing_tpu_torch/csrc/miller_f.cu",
                       "pairing_tpu/ops/fused_kernels.py:260"),
    "miller_f_collect": ("pairing_tpu_torch/csrc/miller_f.cu",
                         "pairing_tpu/ops/fused_kernels.py:260"),
    "pow_ladder_stream": ("pairing_tpu_torch/csrc/pow_ladder.cu",
                          "pairing_tpu/ops/fused_kernels.py:606"),
    "fq12_slotwise": ("pairing_tpu_torch/csrc/slotwise.cu", "pairing_tpu/ops/klayout.py:200"),
    "fp_pow_bits": ("pairing_tpu_torch/csrc/fp_pow.cu", "pairing_tpu/ops/fp_kernels.py:68"),
    "fq12_inv": ("pairing_tpu_torch/csrc/fq12_inv.cu", "pairing_tpu/ops/fq2_vm.py:276"),
    "trajectory": ("pairing_tpu_torch/csrc/trajectory.cu",
                   "pairing_tpu/ops/curve_kernels.py:214"),
    "prefix_products": ("pairing_tpu_torch/csrc/norm.cu", "pairing_tpu/ops/norm_kernels.py:116"),
    "running_inverse": ("pairing_tpu_torch/csrc/norm.cu", "pairing_tpu/ops/norm_kernels.py:156"),
    "lines": ("pairing_tpu_torch/csrc/lines.cu", "pairing_tpu/ops/line_kernels.py:209"),
    "exp_bits": ("pairing_tpu_torch/csrc/exp_bits.cu", "pairing_tpu/ops/fused_kernels.py:702"),
    "affine_export": ("pairing_tpu_torch/csrc/affine_export.cu",
                      "pairing_tpu/ops/fq2_vm.py:334"),
    "fq12_mul_sparse": ("pairing_tpu_torch/csrc/fq12_mul.cu",
                        "pairing_tpu/ops/fq12_kernels.py:275"),
    "fq12_sq": ("pairing_tpu_torch/csrc/fq12_sq.cu", "pairing_tpu/ops/fq12_kernels.py:290"),
    "pow_ladder": ("pairing_tpu_torch/csrc/pow_naf.cu", "pairing_tpu/ops/fused_kernels.py:355"),
    "pow_ladder_w4": ("pairing_tpu_torch/csrc/pow_w4.cu", "pairing_tpu/ops/fused_kernels.py:501"),
    "hard_chain": ("pairing_tpu_torch/csrc/hard_chain.cu",
                   "pairing_tpu/ops/fused_kernels.py:953"),
    "trajectory_end": ("pairing_tpu_torch/csrc/trajectory.cu",
                       "pairing_tpu/ops/curve_kernels.py:214"),
}

#: The kernels each path runs; each must launch in its path's run.
PAIRING_KERNELS = ("fq12_mul", "fq12_cyc_sq", "miller_f", "pow_ladder_stream", "fq12_slotwise",
                   "fp_pow_bits", "fq12_inv", "trajectory", "prefix_products",
                   "running_inverse", "lines")
MULTI_KERNELS = tuple("miller_f_multi" if n == "miller_f" else n for n in PAIRING_KERNELS)
WITNESS_KERNELS = tuple(n for n in PAIRING_KERNELS if n not in ("miller_f", "pow_ladder_stream")
                        ) + ("miller_f_collect", "exp_bits", "affine_export")
FUSED_KERNELS = PAIRING_KERNELS + ("hard_chain",)
SPLIT_KERNELS = ("pow_ladder_w4", "fq12_inv", "fq12_mul", "fq12_cyc_sq", "fq12_slotwise")
POW_KERNELS = ("fq12_sq", "fq12_mul", "fq12_inv")
KLAYOUT_KERNELS = ("fq12_mul_sparse", "pow_ladder", "fq12_sq")
VALIDATE_KERNELS = ("trajectory_end",)
STREAM_PAIRS = 40000  # two full chunks of BATCH and a ragged tail
STREAM_LANES = 4 * BATCH  # witness_stream: four chunks of BATCH, eight of BATCH // 2
LAUNCH_PROCESSES = 2  # launch --backend gloo --device cuda on the one card
LAUNCH_BATCH = 16  # pairings a process in that run
LAUNCH_TIMEOUT = 300
RAGGED_LANES = 1029  # cuts kernel H's 16-lane warps and 64-lane blocks
POW_E = 0b101101110101  # its NAF has -1 digits (tests/test_pairing.py)
LINE_SHAPES = ((0, 3, 4), (2, 3, 5))

# ---------------------------------------------------------------------------
# Operation counts: the least number of 32-bit integer multiply-adds (IMADs)
# per lane that each function needs, whatever the kernel issues. With 13-bit
# limbs one 32-bit IMAD holds a limb product: a column of 21 products below
# 8193^2 plus the 21 m * p terms of the word-by-word reduction stays below
# 2^32. An Fq square needs 231 distinct limb products. The tower takes
# Karatsuba and complex squaring: an Fq2 product is 3 Fq products, an Fq2
# square 2, an Fq12 product 54, an Fq12 square 36, an Fq12 product by a line
# (three Fq2 slots) 13 Fq2 products, a cyclotomic square 9 Fq2 squares.
# With lazy reduction each output Fq coefficient is reduced once. Additions,
# carries, selects and small-constant multiplies are not counted, so the
# operation bound below is a lower bound.
# ---------------------------------------------------------------------------
LIMB_PRODUCTS = 21 * 21  # one Fq product, unreduced
SQ_PRODUCTS = 21 * 22 // 2  # one Fq square, unreduced
MONT = 21 * (1 + 21)  # word-by-word reduction: m, then m * p, per word


def tower(products: int, reductions: int) -> int:
    return products * LIMB_PRODUCTS + reductions * MONT


FP_MUL = tower(1, 1)
FP_SQ = SQ_PRODUCTS + MONT
FP2_MUL = tower(3, 2)
FP2_SQ = tower(2, 2)
FQ12_DENSE = tower(54, 12)
FQ12_SQ = tower(36, 12)
FQ12_SPARSE = tower(39, 12)
CYC_SQ = tower(18, 12)
#: The hard-part chain: 13 products, 4 cyclotomic squares, and the Fq2
#: products by constants of its 7 Frobenius maps (counted from kernel E's
#: slot programs below).
HARD_CHAIN_PRODUCTS, HARD_CHAIN_SQUARES = 13, 4


def ladder_imads(digits, start_squares: bool) -> int:
    """A cyclotomic ladder: a square per digit (after the first when the
    ladder starts at the top digit's entry), a dense product per nonzero one."""
    steps = digits if start_squares else digits[1:]
    return len(steps) * CYC_SQ + int(np.count_nonzero(steps)) * FQ12_DENSE


def pow_imads(e: int) -> int:
    """x^e by the least of the sliding-window chains with windows of 1 to 8
    bits (kernel F and G's chain run a fixed 4-bit window, which takes more
    products): a table of the odd powers x, x^3, ..., x^(2^k - 1) (one
    square, 2^(k-1) - 1 products), r the top window's entry, then a square a
    bit and a product a window below it."""
    bits = bin(e)[2:]
    counts = []
    for k in range(1, 9):
        squares, products = (1, (1 << (k - 1)) - 1) if k > 1 else (0, 0)
        i, first = 0, True
        while i < len(bits):
            if bits[i] == "0":
                squares, i = squares + 1, i + 1
                continue
            j = min(i + k, len(bits))
            while bits[j - 1] == "0":
                j -= 1
            if not first:
                squares, products = squares + j - i, products + 1
            first, i = False, j
        counts.append(squares * FP_SQ + products * FP_MUL)
    return min(counts)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def query_gpu(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls (the caller has warmed it up)."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time of fn() per call, replayed from a CUDA graph of ``reps``
    calls: no host time between launches, for a kernel that takes about as
    long as its wrapper's call (the caller has warmed fn up)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    ms = timed_ms(graph.replay, 1) / reps
    del graph
    return ms


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Bounds:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the multiply-adds over the peak integer rate."""

    def __init__(self):
        mhz = float(query_gpu("clocks.max.sm").split()[0])
        self.imads_per_s = SMS * IMADS_PER_SM_CLOCK * mhz * 1e6
        print(f"bounds: {HBM_BYTES_PER_S / 1e12:.2f} TB/s; {self.imads_per_s / 1e12:.2f} T "
              f"32-bit IMAD/s ({SMS} SMs x {IMADS_PER_SM_CLOCK}/clock x {mhz:.0f} MHz: the "
              f"CUDA C++ Programming Guide's rate for cc 9.0, as tools/fb_variants.py "
              f"measures it)", flush=True)

    def __call__(self, imads: float, n_bytes: float):
        t_ops, t_mem = imads / self.imads_per_s, n_bytes / HBM_BYTES_PER_S
        return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def compare_kernel(name, kernel_fn, plain_fn, results, bound, imads, in_bytes, calls: int = 1):
    """Kernel vs plain version on the same inputs: exact, envelope, timed.

    Each fn returns one tensor or a tuple of them and makes ``calls``
    launches of the kernel (or calls of the plain version); times are per
    call. ``imads`` and ``in_bytes`` are the multiply-adds and the input
    bytes the ``calls`` launches need; the outputs' bytes are added."""
    from pairing_tpu_torch.ops import dispatch
    from pairing_tpu_torch.ops.fq12_kernels import kf12_canonical, kf12_in_envelope

    before = dispatch.KERNELS[name].launches
    got = kernel_fn()
    torch.cuda.synchronize()
    check(dispatch.KERNELS[name].launches == before + calls, f"{name}: kernel did not launch")
    want = plain_fn()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = 0
    for g, w in zip(got, want, strict=True):
        check(kf12_in_envelope(g), f"{name}: output outside [0, 2^13 + 1] limbs / < 2p")
        err = max(err, (kf12_canonical(g).long() - kf12_canonical(w).long()).abs().max().item())
    check(err == 0, f"{name}: kernel differs from its plain version (max |diff| {err})")
    del want
    ms = timed_ms(kernel_fn, KERNEL_REPS) / calls
    plain_ms = timed_ms(plain_fn, 1) / calls
    bound_ms, bound_by = bound(imads / calls, (in_bytes + nbytes(got)) / calls)
    src, replaces = KERNEL_SOURCES[name]
    results[name] = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                     "launches_by_path": {}}
    print(f"{name}: equal to plain, envelope ok; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of it, per call "
          f"(lanes {got[0].shape[-1]})", flush=True)


def ptxas_entry(log: str, kernel: str) -> dict:
    """Registers, stack, spill and static shared bytes of one kernel from
    nvcc's -Xptxas -v report (the lines from its 'Compiling entry function'
    to the next). The mangled name must hold ``kernel`` whole: its length,
    the name, then the E that closes it (k_pow_ladder is not
    k_pow_ladder_w4)."""
    m = re.search(r"Compiling entry function '_Z\w*?\d%sE\w*'" % kernel, log)
    check(m is not None, f"ptxas report has no entry {kernel}")
    block = log[m.end():].split("Compiling entry function")[0]
    props = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      block)
    regs = re.search(r"Used (\d+) registers", block)
    check(props is not None and regs is not None, f"ptxas report of {kernel} unreadable")
    smem = re.search(r"(\d+) bytes smem", block)
    stack, stores, loads = map(int, props.groups())
    return {"registers": int(regs.group(1)), "stack_bytes": stack, "spill_store_bytes": stores,
            "spill_load_bytes": loads, "shared_bytes_per_block": int(smem.group(1)) if smem else 0}


#: SASS instructions per kernel of the library (``cuobjdump -sass``), by
#: mangled name; filled by ``library_sass``.
SASS: dict = {}


def library_sass(lib_path) -> None:
    """Count each kernel's SASS instructions in the built library."""
    from pairing_tpu_torch.ops import build

    SASS.update({name: build.sass_count(text) for name, text in build.sass(lib_path).items()})


def add_ptxas(entry: dict, log: str, kernel: str, dynamic_shared: int = 0, *more) -> None:
    """The entry of a redesigned kernel gains its ptxas registers, stack,
    spills and shared bytes per block:
    the static bytes of the report plus ``dynamic_shared``, the bytes it
    asks for at launch, and its SASS instruction count. A kernel of several
    launches (G) names the others in ``more`` as (kernel, dynamic_shared);
    each gets its own entry under ``ptxas_more``."""
    for i, (name, dyn) in enumerate(((kernel, dynamic_shared),) + more):
        props = ptxas_entry(log, name)
        props["shared_bytes_per_block"] += dyn
        props["sass"] = next((v for k, v in SASS.items() if re.search(r"\d%sE" % name, k)), None)
        if i == 0:
            entry.update(props)
        else:
            entry.setdefault("ptxas_more", {})[name] = props
        print(f"{entry['name']}: {props['registers']} registers, {props['stack_bytes']} B stack, "
              f"spill stores {props['spill_store_bytes']} B, loads {props['spill_load_bytes']} B, "
              f"{props['shared_bytes_per_block']} B shared per block (ptxas, {name}); "
              f"{props['sass']} SASS", flush=True)


def slot_imads(power) -> int:
    """Kernel E's least count for one program: a product by a real constant
    (p^2's) is two Fq products, a complex one a Karatsuba Fq2 product; each
    output coefficient reduced once."""
    from pairing_tpu_torch.ops import klayout as KL

    ops, consts = KL._slot_prog(power)
    return sum(2 * FP_MUL if not consts[i, 1].any() else FP2_MUL
               for i in range(6) if ops[i] & KL.MUL_CONST)


def per_program(entry: dict, bound, programs, run, imads, n_bytes: int) -> None:
    """A kernel of several programs that takes about as long as its
    wrapper's call (E): each program's device time (``graph_ms``), its time
    launched call by call (``ms_eager``, the host's pace) and its bound into
    ``entry["programs"]``; the entry's ms and bound become the means of
    theirs, its ms launched call by call (``compare_kernel``'s) ms_eager."""
    rows, bounds = {}, []
    for prog in programs:
        fn = run(prog)
        fn()
        ms, eager = graph_ms(fn, KERNEL_REPS), timed_ms(fn, KERNEL_REPS)
        bound_ms, bound_by = bound(imads(prog), n_bytes)
        bounds.append((bound_ms, bound_by))
        rows[str(prog)] = {"ms": ms, "ms_eager": eager, "bound_ms": bound_ms,
                           "bound_by": bound_by, "share": bound_ms / ms}
        print(f"{entry['name']} program {prog}: {ms:.5f} ms replayed from a CUDA graph "
              f"({eager:.5f} launched call by call), bound {bound_ms:.5f} ms ({bound_by}), "
              f"{100 * bound_ms / ms:.1f}% of it", flush=True)
    entry["programs"] = rows
    entry["ms_eager"] = entry["ms"]
    entry["ms"] = sum(r["ms"] for r in rows.values()) / len(rows)
    entry["bound_ms"] = sum(b for b, _ in bounds) / len(bounds)
    by = {k: sum(b for b, w in bounds if w == k) for k in ("bytes", "operations")}
    entry["bound_by"] = max(by, key=by.get)
    print(f"{entry['name']}: mean {entry['ms']:.5f} ms ({entry['ms_eager']:.5f} launched call "
          f"by call), mean of the programs' bounds {entry['bound_ms']:.5f} ms, "
          f"{100 * entry['bound_ms'] / entry['ms']:.1f}% of it", flush=True)


def wide_case(entry: dict, bound, run, plain, imads: float, inputs) -> None:
    """A kernel at the K = 4 path's 65,536 lanes (kernels I, J and F run
    there on ``multi_pairing``): equal to its plain version on canonical
    values, in the envelope, timed, into its entry."""
    from pairing_tpu_torch.ops.fq12_kernels import kf12_canonical, kf12_in_envelope

    name = entry["name"]
    got, want = run(), plain()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    lanes = got[0].shape[-1]
    for g, w in zip(got, want, strict=True):
        check(kf12_in_envelope(g) and torch.equal(kf12_canonical(g), kf12_canonical(w)),
              f"{name} differs from its plain version at {lanes} lanes")
    del want
    ms = timed_ms(run, KERNEL_REPS)
    bound_ms, _ = bound(imads, nbytes(inputs) + nbytes(got))
    entry["ms_65536_lanes"], entry["bound_ms_65536_lanes"] = ms, bound_ms
    print(f"{name} at {lanes} lanes: equal to plain; kernel {ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms, {100 * bound_ms / ms:.1f}% of it", flush=True)


def kernel_phases(results, bound, ptxas_log: str) -> None:
    from pairing_tpu_torch.ops import build
    from pairing_tpu_torch.ops import curve_kernels as CK
    from pairing_tpu_torch.ops import fp_kernels as FPK
    from pairing_tpu_torch.ops import fq12_kernels as FK
    from pairing_tpu_torch.ops import fq2_vm as VM
    from pairing_tpu_torch.ops.fq12_kernels import kf12_canonical
    from pairing_tpu_torch.ops import fused_kernels as FU
    from pairing_tpu_torch.ops import klayout as KL
    from pairing_tpu_torch.ops import line_kernels as LK
    from pairing_tpu_torch.ops import norm_kernels as NK
    from pairing_tpu_torch.pairing import final_exp as FE
    from pairing_tpu_torch.pairing import miller_loop as ML
    from pairing_tpu_torch.utils.bn254 import P

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    B = BATCH

    def rand(*lead, lanes=B):
        return FK.random_kf12(lead, lanes, gen)

    a, b = rand(12), rand(12)
    compare_kernel("fq12_mul", lambda: FK.fq12_mul(a, b), lambda: FK.fq12_mul_plain(a, b),
                   results, bound, B * FQ12_DENSE, nbytes((a, b)))
    add_ptxas(results["fq12_mul"], ptxas_log, "k_fq12_mul")

    m = FE.easy_part_k(a)  # cyclotomic-subgroup inputs for B, D and K12
    # B on m and on the random a: the same polynomial on any input
    compare_kernel("fq12_cyc_sq", lambda: (KL.kcyc_sq(m), KL.kcyc_sq(a)),
                   lambda: (KL.kcyc_sq_plain(m), KL.kcyc_sq_plain(a)), results, bound,
                   2 * B * CYC_SQ, nbytes((m, a)), calls=2)
    add_ptxas(results["fq12_cyc_sq"], ptxas_log, "k_fq12_cyc_sq")

    sched = FU.miller_schedule(ML.MILLER_FLAGS, ML.CHORD_ROWS)
    n_loop, n_lines = ML.N_STEPS, ML.N_STEPS + ML.N_ADDS + 2

    def miller_case(name, n_pairs, collect):
        tg, ch, ep = (rand(n, 6, lanes=n_pairs * B) for n in (ML.N_STEPS, ML.N_ADDS, 2))
        imads = B * (n_loop * FQ12_SQ + n_pairs * n_lines * FQ12_SPARSE)
        compare_kernel(
            name,
            lambda: FU.miller_f(tg, ch, ep, ML.MILLER_FLAGS, ML.CHORD_ROWS, n_pairs, collect),
            lambda: FU.miller_f_plain(tg, ch, ep, sched, n_pairs, collect),
            results, bound, imads, nbytes((tg, ch, ep)))
        add_ptxas(results[name], ptxas_log, "k_miller_f")

    miller_case("miller_f", 1, False)

    stream, rows = FU.pow_x_table(m)
    digits = FU.BN_X_W4_DIGITS
    compare_kernel("pow_ladder_stream",
                   lambda: FU.pow_ladder_stream(stream, digits, rows),
                   lambda: FU.pow_ladder_stream_plain(stream, digits, rows), results, bound,
                   B * ((len(digits) - 1) * CYC_SQ
                        + int(np.count_nonzero(digits[1:])) * FQ12_DENSE), nbytes((stream,)))
    add_ptxas(results["pow_ladder_stream"], ptxas_log, "k_pow_ladder_stream")

    powers = (None, 1, 2, 3)  # the conjugate and the three Frobenius maps
    compare_kernel("fq12_slotwise",
                   lambda: tuple(KL.slotwise(a, pw) for pw in powers),
                   lambda: tuple(KL.slotwise_plain(a, pw) for pw in powers), results, bound,
                   B * sum(slot_imads(pw) for pw in powers), len(powers) * nbytes((a,)),
                   calls=len(powers))
    add_ptxas(results["fq12_slotwise"], ptxas_log, "k_fq12_slotwise")
    per_program(results["fq12_slotwise"], bound, powers,
                lambda pw: lambda: KL.slotwise(a, pw), lambda pw: B * slot_imads(pw),
                2 * nbytes((a,)))

    x = rand()
    compare_kernel("fp_pow_bits", lambda: FPK.fp_pow_bits(x, P - 2),
                   lambda: FPK.fp_pow_bits_plain(x, P - 2), results, bound,
                   B * pow_imads(P - 2), nbytes((x,)))
    add_ptxas(results["fp_pow_bits"], ptxas_log, "k_fp_pow_bits")
    x = rand(lanes=WIDE)
    wide_case(results["fp_pow_bits"], bound, lambda: FPK.fp_pow_bits(x, P - 2),
              lambda: FPK.fp_pow_bits_plain(x, P - 2), WIDE * pow_imads(P - 2), (x,))

    # two Fq6 squares, the Fq6 inverse, two Fq6 products; the Fq2 norm's two
    # squares share one reduction, then the Fq inverse (a sliding window)
    # and two Fq products
    inv_imads = (25 * FP2_MUL + 9 * FP2_SQ + 2 * SQ_PRODUCTS + MONT + pow_imads(P - 2)
                 + 2 * FP_MUL)
    compare_kernel("fq12_inv", lambda: KL.kinv(a), lambda: KL.kinv_plain(a), results, bound,
                   B * inv_imads, nbytes((a,)))
    lib, _ = build.load()
    add_ptxas(results["fq12_inv"], ptxas_log, "k_fq12_inv_norm", lib.pt_fq12_inv_shared_bytes(),
              ("k_fq12_inv_chain", 0), ("k_fq12_inv_out", lib.pt_fq12_inv_shared_bytes()))

    q = rand(4)
    n_adds = sum(1 for d in ML.STEP_DIGITS if d)
    traj_imads = ML.N_STEPS * (5 * FP2_SQ + 2 * FP2_MUL) + n_adds * (4 * FP2_SQ + 7 * FP2_MUL)
    compare_kernel("trajectory", lambda: CK.trajectory(q, ML.STEP_DIGITS),
                   lambda: CK.trajectory_plain(q, ML.STEP_DIGITS), results, bound,
                   B * traj_imads, nbytes((q,)))
    add_ptxas(results["trajectory"], ptxas_log, "k_trajectoryILb1E",
              lib.pt_trajectory_shared_bytes())
    # its end-only mode on the G2 subgroup check's digits, at 16384 lanes and
    # at a ragged lane count
    from pairing_tpu_torch.curves.g2 import SUBGROUP_DIGITS

    n_sub = sum(1 for d in SUBGROUP_DIGITS if d)
    end_imads = (len(SUBGROUP_DIGITS) * (5 * FP2_SQ + 2 * FP2_MUL)
                 + n_sub * (4 * FP2_SQ + 7 * FP2_MUL))
    compare_kernel("trajectory_end", lambda: CK.trajectory_end(q, SUBGROUP_DIGITS),
                   lambda: CK.trajectory_end_plain(q, SUBGROUP_DIGITS), results, bound,
                   B * end_imads, nbytes((q,)))
    add_ptxas(results["trajectory_end"], ptxas_log, "k_trajectoryILb0E",
              lib.pt_trajectory_shared_bytes())
    qr = rand(4, lanes=RAGGED_LANES)
    check(torch.equal(kf12_canonical(CK.trajectory_end(qr, SUBGROUP_DIGITS)),
                      kf12_canonical(CK.trajectory_end_plain(qr, SUBGROUP_DIGITS))),
          f"trajectory_end differs from its plain version at {RAGGED_LANES} lanes")
    results["trajectory_end"]["ragged_lanes_equal"] = RAGGED_LANES
    print(f"trajectory_end: equal to plain at {RAGGED_LANES} lanes too ({len(SUBGROUP_DIGITS)} "
          f"digits, {n_sub} nonzero)", flush=True)
    del qr

    z, tinv = rand(2 * ML.N_STEPS + 2, 2), rand(2)
    prefix, _ = NK.prefix_products(z)
    n_z = z.shape[0]
    compare_kernel("prefix_products", lambda: NK.prefix_products(z),
                   lambda: NK.prefix_products_plain(z), results, bound,
                   B * n_z * FP2_MUL, nbytes((z,)))
    add_ptxas(results["prefix_products"], ptxas_log, "k_prefix_products")
    compare_kernel("running_inverse", lambda: NK.running_inverse(z, prefix, tinv),
                   lambda: NK.running_inverse_plain(z, prefix, tinv), results, bound,
                   B * 2 * n_z * FP2_MUL, nbytes((z, prefix, tinv)))
    add_ptxas(results["running_inverse"], ptxas_log, "k_running_inverse")
    zw = rand(n_z, 2, lanes=WIDE)
    wide_case(results["prefix_products"], bound, lambda: NK.prefix_products(zw),
              lambda: NK.prefix_products_plain(zw), WIDE * n_z * FP2_MUL, (zw,))
    pw, tw = rand(n_z, 2, lanes=WIDE), rand(2, lanes=WIDE)
    wide_case(results["running_inverse"], bound, lambda: NK.running_inverse(zw, pw, tw),
              lambda: NK.running_inverse_plain(zw, pw, tw), WIDE * 2 * n_z * FP2_MUL,
              (zw, pw, tw))
    del zw, pw, tw

    tops, dbls, zinv, pq = rand(ML.N_STEPS, 6), rand(ML.N_STEPS, 6), z, rand(6)
    ch_rows = ML.CHORD_ROWS[:ML.N_STEPS]
    lsched = LK.line_schedule(ML.STEP_DIGITS, ch_rows, ML.N_ADDS)
    lines_imads = (ML.N_STEPS * (3 * FP2_SQ + 4 * FP2_MUL + 4 * FP_MUL)
                   + n_adds * (FP2_SQ + 5 * FP2_MUL + 4 * FP_MUL))
    compare_kernel("lines",
                   lambda: LK.lines(tops, dbls, zinv, pq, ML.STEP_DIGITS, ch_rows, ML.N_ADDS),
                   lambda: LK.lines_plain(tops, dbls, zinv, pq, lsched, ML.N_ADDS), results,
                   bound, B * lines_imads,
                   # X, Y of every top and of the added post-doubles, their inverses, P and Q
                   B * 21 * 4 * (4 * (ML.N_STEPS + n_adds) + 2 * (ML.N_STEPS + n_adds) + 6))
    add_ptxas(results["lines"], ptxas_log, "k_lines")
    del tops, dbls, pq, z, prefix, tinv, stream

    # this slice's kernel modes, at the shapes of the K-pair and witness paths
    miller_case("miller_f_multi", K_PAIRS, False)
    miller_case("miller_f_collect", 1, True)

    bits = FU.BN_X_BITS_MSB
    compare_kernel("exp_bits", lambda: FU.exp_bits_ladder(m, bits)[1],  # rows; out is rows[-1]
                   lambda: FU.exp_bits_ladder_plain(m, bits), results,
                   bound, B * (len(bits) * CYC_SQ + int(bits.sum()) * FQ12_DENSE), nbytes((m,)))
    add_ptxas(results["exp_bits"], ptxas_log, "k_exp_bits", lib.pt_exp_bits_shared_bytes())

    n_states = 2 * ML.N_STEPS + 2
    xy, zi = rand(n_states, 4), rand(n_states, 2)
    compare_kernel("affine_export", lambda: VM.affine_export(xy, zi),
                   lambda: VM.affine_export_plain(xy, zi), results, bound,
                   B * n_states * (FP2_SQ + 3 * FP2_MUL), nbytes((xy, zi)))
    add_ptxas(results["affine_export"], ptxas_log, "k_affine_export")
    # the witness path's form: the Miller loop's four segments, six rows a state
    rows6 = torch.zeros((n_states, 6, 21, B), dtype=torch.int32, device=DEVICE)
    rows6[:, 0:4] = xy
    cut = ML.N_STEPS
    segs = (rows6[:cut, 0:4], rows6[cut:2 * cut, 0:4], rows6[2 * cut:2 * cut + 1, 0:4],
            rows6[2 * cut + 1:, 0:4])
    check(torch.equal(VM.affine_export(segs, zi), VM.affine_export(xy, zi)),
          "affine_export: the segment form differs from the single tensor")
    print("affine_export: the segment form (four segments, six rows a state) equals the single "
          "tensor limb for limb", flush=True)
    del xy, zi, rows6, segs

    # this slice's kernels: K18, kernel A's sparse mode, K16, K17, K15
    compare_kernel("fq12_sq", lambda: FK.fq12_sq(a), lambda: FK.fq12_sq_plain(a), results, bound,
                   B * FQ12_SQ, nbytes((a,)))
    add_ptxas(results["fq12_sq"], ptxas_log, "k_fq12_sq")

    lines = [rand(12) for _ in LINE_SHAPES]  # only the present slots are read
    compare_kernel("fq12_mul_sparse",
                   lambda: tuple(FK.fq12_mul_sparse(a, sh, ln) for sh, ln in zip(LINE_SHAPES, lines)),
                   lambda: tuple(FK.fq12_mul_sparse_plain(a, sh, ln)
                                 for sh, ln in zip(LINE_SHAPES, lines)),
                   results, bound, len(LINE_SHAPES) * B * FQ12_SPARSE,
                   len(LINE_SHAPES) * nbytes((a,)) + sum(nbytes((ln,)) // 2 for ln in lines),
                   calls=len(LINE_SHAPES))
    add_ptxas(results["fq12_mul_sparse"], ptxas_log, "k_fq12_mul")
    del lines

    mc = KL.kconj(m)
    naf, w4 = FU.BN_X_LADDER_DIGITS, FU.BN_X_W4_DIGITS
    compare_kernel("pow_ladder", lambda: FU.pow_ladder(m, mc, naf),
                   lambda: FU.pow_ladder_plain(m, mc, naf), results, bound,
                   B * ladder_imads(naf, True), nbytes((m, mc)))
    add_ptxas(results["pow_ladder"], ptxas_log, "k_pow_ladder", lib.pt_pow_ladder_shared_bytes())
    compare_kernel("pow_ladder_w4", lambda: FU.pow_ladder_w4(m, w4),
                   lambda: FU.pow_ladder_w4_plain(m, w4), results, bound,
                   B * (CYC_SQ + 3 * FQ12_DENSE + ladder_imads(w4, False)), nbytes((m,)))
    add_ptxas(results["pow_ladder_w4"], ptxas_log, "k_pow_ladder_w4",
              lib.pt_pow_ladder_w4_shared_bytes())
    # the three ladder designs for m^BN_X on one m: one value, times side by side
    mx = FU.pow_x_streamed(m)
    same = [kf12_canonical(FU.pow_ladder(m, mc, naf)), kf12_canonical(FU.pow_ladder_w4(m, w4))]
    check(all(torch.equal(x, kf12_canonical(mx)) for x in same), "the three ladders differ")
    d_ms = timed_ms(lambda: FU.pow_x_streamed(m), KERNEL_REPS)
    print(f"m^BN_X three ways on one m ({B} lanes, equal): D {d_ms:.3f} ms with its table "
          f"(A, B, E; the ladder kernel alone {results['pow_ladder_stream']['ms']:.3f} ms), "
          f"K16 plain NAF {results['pow_ladder']['ms']:.3f} ms, K17 w4 with the table in the "
          f"kernel {results['pow_ladder_w4']['ms']:.3f} ms", flush=True)
    del same, mc

    mx2 = FU.pow_x_streamed(mx)
    chain_in = (m, mx, mx2, FU.pow_x_streamed(mx2))
    n_const = sum(int(np.count_nonzero(KL._slot_prog(FU.SLOT_POWERS[op - FU.OPC_CONJ])[0]
                                       & KL.MUL_CONST))
                  for op, *_ in FU.HARD_CHAIN_PROG if op >= FU.OPC_CONJ)
    compare_kernel("hard_chain", lambda: FU.hard_chain(*chain_in),
                   lambda: FU.hard_chain_plain(*chain_in), results, bound,
                   B * (HARD_CHAIN_PRODUCTS * FQ12_DENSE + HARD_CHAIN_SQUARES * CYC_SQ
                        + n_const * FP2_MUL), nbytes(chain_in))
    add_ptxas(results["hard_chain"], ptxas_log, "k_hard_chain", lib.pt_hard_chain_shared_bytes())
    unfused = FE.hard_part_chain_k(*chain_in, fused=False)
    check(torch.equal(kf12_canonical(FU.hard_chain(*chain_in)), kf12_canonical(unfused)),
          "hard_chain differs from the unfused chain")
    chain = lambda: FE.hard_part_chain_k(*chain_in, fused=False)  # noqa: E731
    chain_ms, chain_graph_ms = timed_ms(chain, KERNEL_REPS), graph_ms(chain, KERNEL_REPS)
    k15_ms = results["hard_chain"]["ms"]
    results["hard_chain"]["launches29_ms"] = chain_ms
    results["hard_chain"]["launches29_graph_ms"] = chain_graph_ms
    print(f"hard-part chain ({B} lanes, equal): 29 launches of A, B, E {chain_ms:.3f} ms "
          f"launched call by call, {chain_graph_ms:.3f} ms replayed from a CUDA graph; K15 in "
          f"one launch {k15_ms:.3f} ms, {k15_ms / chain_ms:.3f} x and "
          f"{k15_ms / chain_graph_ms:.3f} x theirs", flush=True)


def seeded_pairs():
    from pairing_tpu_torch.oracle import native as o
    from pairing_tpu_torch.utils import bn254 as c

    rng = np.random.default_rng(SEED)

    def scalar():
        return int.from_bytes(rng.bytes(32), "little") % (c.R_SCALAR - 1) + 1

    g1s = [o.g1_mul(c.G1_GEN, scalar()) for _ in range(UNIQUE)]
    g2s = [o.g2_mul((c.G2_GEN_X, c.G2_GEN_Y), scalar()) for _ in range(UNIQUE)]
    return g1s, g2s


def tiled_points(g1s, g2s, shape):
    """The distinct pairs repeated over prod(shape) lanes, in row-major order
    of ``shape``, as (G1, G2) batches of that shape on the card."""
    import pairing_tpu_torch as pt
    from pairing_tpu_torch.utils.interop import map_limbs

    reps = int(np.prod(shape)) // len(g1s)
    tile = lambda limbs: limbs.repeat(reps, 1).reshape(tuple(shape) + (21,))  # noqa: E731
    return (map_limbs(pt.g1_from_ints(g1s, DEVICE), tile),
            map_limbs(pt.g2_from_ints(g2s, DEVICE), tile))


def run_path(name, kernels, fn, results):
    """fn() with every launch count set to 0 just before and read just after;
    each of ``kernels`` must have launched. Returns (fn's result, seconds)."""
    from pairing_tpu_torch.ops import dispatch

    dispatch.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dispatch.launch_counts()
    print(f"{name} launches: { {k: v for k, v in counts.items() if v} } "
          f"(first call {seconds:.2f} s)", flush=True)
    for k in kernels:
        check(counts[k] > 0, f"{name} never launched kernel {k}")
        results[k]["launches_by_path"][name] = counts[k]
    return out, seconds


def canonical(out):
    from pairing_tpu_torch.fields.fp12 import fq12_to_canonical_limbs

    for s in out.s:
        for comp in (s.c0, s.c1):
            check(int(comp.limbs.min()) >= 0 and int(comp.limbs.max()) <= 8193,
                  "output limbs outside [0, 2^13 + 1]")
    return fq12_to_canonical_limbs(out)


def main_path(results, card: str, g1s, g2s):
    import pairing_tpu_torch as pt
    from pairing_tpu_torch.fields.fp12 import fq12_limbs_to_int_coeffs
    from pairing_tpu_torch.oracle import native as o

    t0 = time.perf_counter()
    p, q = tiled_points(g1s, g2s, (BATCH,))
    reps = BATCH // UNIQUE
    print(f"main path: {UNIQUE} seeded pairs tiled to {BATCH} lanes "
          f"({time.perf_counter() - t0:.1f} s to make)", flush=True)

    out, _ = run_path("pairing", PAIRING_KERNELS, lambda: pt.pairing(p, q), results)
    canon = canonical(out)  # [BATCH, 12, 21]
    check(tuple(canon.shape) == (BATCH, 12, 21), f"output shape {tuple(canon.shape)}")
    tiled = canon.reshape(reps, UNIQUE, 12, 21)
    check(bool((tiled == tiled[:1]).all()), "a tiled lane differs from its original")
    got = fq12_limbs_to_int_coeffs(canon[:UNIQUE].cpu().numpy())
    t0 = time.perf_counter()
    want = [o.pairing(pp, qq) for pp, qq in zip(g1s, g2s)]
    bad = [i for i in range(UNIQUE) if got[i] != want[i]]
    check(not bad, f"lanes {bad[:8]} differ from the oracle")
    print(f"main path: all {UNIQUE} distinct lanes equal the oracle, all {BATCH} tiled "
          f"lanes equal their originals (oracle {time.perf_counter() - t0:.1f} s)", flush=True)

    # steady state: the first call above was the warm-up
    from pairing_tpu_torch.pairing.final_exp import final_exp_k
    from pairing_tpu_torch.pairing.miller_loop import flatten_pairs, miller_loop_k

    qf, pf, _ = flatten_pairs(q, p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f = miller_loop_k(qf, pf)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    final_exp_k(f)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    runs = 5
    for _ in range(runs):
        pt.pairing(p, q)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    per_batch = (t3 - t2) / runs
    print(f"main path: miller_loop {t1 - t0:.3f} s, final_exp {t2 - t1:.3f} s per batch; "
          f"pairing {per_batch:.3f} s per batch of {BATCH} = {BATCH / per_batch:.1f} "
          f"pairings/s on {card}", flush=True)
    return p, q, canon, want


def multi_path(results, card: str, g1s, g2s):
    import pairing_tpu_torch as pt
    from pairing_tpu_torch.fields.fp12 import fq12_limbs_to_int_coeffs
    from pairing_tpu_torch.oracle import native as o
    from pairing_tpu_torch.utils.interop import map_limbs

    K, n_prod = K_PAIRS, BATCH
    per_cycle = UNIQUE // K  # product b takes distinct pairs K*b .. K*b + K-1 (mod 256)
    # product-major tiling [n_prod, K], then the pairs axis first: [K, n_prod]
    swap = lambda limbs: limbs.transpose(0, 1).contiguous()  # noqa: E731
    ps, qs = (map_limbs(pts, swap) for pts in tiled_points(g1s, g2s, (n_prod, K)))
    print(f"K-pair path: {UNIQUE} seeded pairs tiled to {K} x {n_prod} = {K * n_prod} pairs",
          flush=True)
    out, _ = run_path("multi_pairing", MULTI_KERNELS, lambda: pt.multi_pairing(ps, qs), results)
    canon = canonical(out)
    check(tuple(canon.shape) == (n_prod, 12, 21), f"output shape {tuple(canon.shape)}")
    tiled = canon.reshape(n_prod // per_cycle, per_cycle, 12, 21)
    check(bool((tiled == tiled[:1]).all()), "a tiled product differs from its original")
    got = fq12_limbs_to_int_coeffs(canon[:per_cycle].cpu().numpy())
    t0 = time.perf_counter()
    want = [o.final_exp(o.multi_miller_loop([(g1s[K * b + k], g2s[K * b + k]) for k in range(K)]))
            for b in range(per_cycle)]
    bad = [b for b in range(per_cycle) if got[b] != want[b]]
    check(not bad, f"products {bad[:8]} differ from the oracle")
    print(f"K-pair path: the first {per_cycle} products equal the oracle, all {n_prod} tiled "
          f"products equal their originals (oracle {time.perf_counter() - t0:.1f} s)",
          flush=True)
    runs = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        pt.multi_pairing(ps, qs)
    torch.cuda.synchronize()
    per_batch = (time.perf_counter() - t0) / runs
    print(f"K-pair path: multi_pairing {per_batch:.3f} s per batch of {n_prod} products of "
          f"{K} = {n_prod / per_batch:.1f} products/s, {K * n_prod / per_batch:.1f} pairings/s "
          f"on {card}", flush=True)
    return ps, qs, canon


@contextlib.contextmanager
def fused_chain():
    """PAIRING_FUSED_CHAIN set: every final_exp_k runs the chain on K15."""
    old = os.environ.get("PAIRING_FUSED_CHAIN")
    os.environ["PAIRING_FUSED_CHAIN"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["PAIRING_FUSED_CHAIN"]
        else:
            os.environ["PAIRING_FUSED_CHAIN"] = old


def fused_chain_path(results, card: str, p, q, canon, want):
    import pairing_tpu_torch as pt
    from pairing_tpu_torch.fields.fp12 import fq12_limbs_to_int_coeffs

    with fused_chain():
        out, _ = run_path("pairing_fused_chain", FUSED_KERNELS, lambda: pt.pairing(p, q), results)
    got = canonical(out)
    check(bool((got == canon).all()), "fused-chain pairing differs from the unfused run")
    check(fq12_limbs_to_int_coeffs(got[:UNIQUE].cpu().numpy()) == want,
          "fused-chain pairing differs from the oracle")
    print(f"fused chain: pairing equals the unfused run on all {BATCH} lanes and the oracle on "
          f"the {UNIQUE} distinct ones", flush=True)
    runs, times = 3, {"unfused": 0.0, "fused": 0.0}
    for _ in range(runs):  # alternating, so both forms see the same host
        for form in times:
            with fused_chain() if form == "fused" else contextlib.nullcontext():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pt.pairing(p, q)
                torch.cuda.synchronize()
                times[form] += (time.perf_counter() - t0) / runs
    print("fused chain: " + ", ".join(
        f"{form} {sec:.3f} s per batch = {BATCH / sec:.1f} pairings/s" for form, sec in
        times.items()) + f" ({runs} alternating calls each, batch {BATCH}, on {card})", flush=True)


def split_final_exp_path(results, p, q, canon):
    from pairing_tpu_torch.fields.fp12 import fq12_limbs_to_int_coeffs
    from pairing_tpu_torch.oracle import native as o
    from pairing_tpu_torch.ops import dispatch
    from pairing_tpu_torch.ops.fq12_kernels import from_kernel_layout
    from pairing_tpu_torch.pairing import final_exp as FE
    from pairing_tpu_torch.pairing.miller_loop import flatten_pairs, miller_loop_k

    qf, pf, bs = flatten_pairs(q, p)
    f = from_kernel_layout(miller_loop_k(qf, pf), bs)
    out, seconds = run_path("split_final_exp", SPLIT_KERNELS,
                            lambda: FE.hard_part(FE.easy_part(f)), results)
    counts = dispatch.launch_counts()
    check(counts["pow_ladder_w4"] == 3 and counts["fq12_inv"] == 1
          and counts["pow_ladder_stream"] == 0 and counts["hard_chain"] == 0,
          f"split final exponentiation took other kernels: {counts}")
    got = canonical(out)
    check(bool((got == canon).all()), "hard_part(easy_part(f)) differs from pairing")
    miller = fq12_limbs_to_int_coeffs(canonical(f)[:UNIQUE].cpu().numpy())
    t0 = time.perf_counter()
    want = [o.final_exp(x) for x in miller]
    check(fq12_limbs_to_int_coeffs(got[:UNIQUE].cpu().numpy()) == want,
          "hard_part(easy_part(f)) differs from the oracle's final_exp")
    print(f"split final exponentiation: hard_part(easy_part(f)) on the main path's {BATCH} "
          f"Miller outputs equals pairing on every lane and the oracle's final_exp on the "
          f"{UNIQUE} distinct ones (oracle {time.perf_counter() - t0:.1f} s); first call "
          f"{seconds:.3f} s", flush=True)


def fq12_pow_path(results, card: str):
    import pairing_tpu_torch as pt
    from pairing_tpu_torch.fields.fp12 import fq12_limbs_to_int_coeffs
    from pairing_tpu_torch.oracle import native as o
    from pairing_tpu_torch.pairing.final_exp import fq12_pow
    from pairing_tpu_torch.utils import bn254 as c
    from pairing_tpu_torch.utils.interop import map_limbs

    rng = np.random.default_rng(SEED + 1)
    coeffs = [[int.from_bytes(rng.bytes(40), "little") % c.P for _ in range(12)]
              for _ in range(UNIQUE)]
    reps = BATCH // UNIQUE
    a = map_limbs(pt.fq12_from_int_coeffs(coeffs, DEVICE), lambda limbs: limbs.repeat(reps, 1))
    for e, name in ((POW_E, "fq12_pow"), (c.BN_X, "fq12_pow_bn_x")):
        kernels = POW_KERNELS if -1 in c.get_naf(e) else tuple(k for k in POW_KERNELS
                                                                if k != "fq12_inv")
        out, seconds = run_path(name, kernels, lambda: fq12_pow(a, e), results)
        got = canonical(out)
        tiled = got.reshape(reps, UNIQUE, 12, 21)
        check(bool((tiled == tiled[:1]).all()), f"{name}: a tiled lane differs")
        want = [o.pow_fq12(x, e) for x in coeffs]
        check(fq12_limbs_to_int_coeffs(got[:UNIQUE].cpu().numpy()) == want,
              f"{name}: differs from the oracle")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fq12_pow(a, e)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        print(f"{name}: e = {e:#x}, {BATCH} lanes ({UNIQUE} distinct) equal the oracle; "
              f"{sec:.4f} s per batch = {BATCH / sec:.1f} powers/s on {card} (first call "
              f"{seconds:.3f} s); K18 launches {results['fq12_sq']['launches_by_path'][name]}, "
              f"device {timed_ms(lambda: fq12_pow(a, e), 3):.3f} ms per call", flush=True)


def klayout_path(results):
    """The kernel-layout ops of this slice, each against another route to
    the same value: kmul_sparse against the dense product by the line with
    its absent slots zeroed, ksq against kmul(a, a), pow_ladder (K16)
    against pow_x_streamed (D)."""
    from pairing_tpu_torch.ops import fq12_kernels as FK
    from pairing_tpu_torch.ops import fused_kernels as FU
    from pairing_tpu_torch.ops import klayout as KL
    from pairing_tpu_torch.ops.fq12_kernels import kf12_canonical
    from pairing_tpu_torch.pairing.final_exp import easy_part_k

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 2)
    a, b = (FK.random_kf12((12,), BATCH, gen) for _ in range(2))
    m = easy_part_k(a)
    mc = KL.kconj(m)

    def ops():
        return ([KL.kmul_sparse(a, sh, b) for sh in LINE_SHAPES], KL.ksq(a),
                FU.pow_ladder(m, mc, FU.BN_X_LADDER_DIGITS))

    (sparse, sq, mx), _ = run_path("kernel_layout_ops", KLAYOUT_KERNELS, ops, results)
    for sh, got in zip(LINE_SHAPES, sparse):
        line = b.clone()
        for j in set(range(6)) - set(sh):
            line[2 * j: 2 * j + 2] = 0
        check(torch.equal(kf12_canonical(got), kf12_canonical(KL.kmul(a, line))),
              f"kmul_sparse {sh} differs from the dense product")
    check(torch.equal(kf12_canonical(sq), kf12_canonical(KL.kmul(a, a))), "ksq differs from kmul")
    check(torch.equal(kf12_canonical(mx), kf12_canonical(FU.pow_x_streamed(m))),
          "pow_ladder differs from pow_x_streamed")
    print(f"kernel-layout ops: kmul_sparse (both line shapes), ksq and pow_ladder at {BATCH} "
          f"lanes equal the dense product, kmul(a, a) and pow_x_streamed", flush=True)


def non_subgroup_point():
    """An on-twist point outside G2 (tests/test_validate.py's search)."""
    from pairing_tpu_torch.oracle import native as o

    for x0 in range(1, 200):
        pt = o.g2_point_from_x((x0, 1))
        if pt is not None and not o.g2_in_subgroup(pt):
            return pt
    raise RuntimeError("chip_smoke: no on-twist point outside G2 found")


def validation_path(results, card: str, g1s, g2s):
    """``validate_inputs`` over the main path's pairs tiled to BATCH lanes,
    with bad lanes at fixed positions, lane for lane against the oracle's
    masks, with and without the subgroup check."""
    import pairing_tpu_torch as pt
    from pairing_tpu_torch.oracle import native as o
    from pairing_tpu_torch.utils import bn254 as c

    g1 = [g1s[i % UNIQUE] for i in range(BATCH)]
    g2 = [g2s[i % UNIQUE] for i in range(BATCH)]
    (x0, x1), (y0, y1) = g2s[0]
    bad = {5: "Q on the twist, outside G2", BATCH // 16: "P = (5, 5), off the curve",
           BATCH // 2 - 1: "P = (0, 0)", BATCH - 1: "Q off the twist"}
    g2[5] = non_subgroup_point()
    g1[BATCH // 16] = (5, 5)
    g1[BATCH // 2 - 1] = (0, 0)
    g2[BATCH - 1] = ((x0, x1), ((y0 + 1) % c.P, y1))
    sub = {}

    def in_g2(q):
        if q not in sub:
            sub[q] = o.g2_in_subgroup(q)
        return sub[q]

    t0 = time.perf_counter()
    on = [(y * y - x ** 3 - 3) % c.P == 0 and c._on_twist(*q) for (x, y), q in zip(g1, g2)]
    want = {"subgroup_check": [ok and in_g2(q) for ok, q in zip(on, g2)],
            "no_subgroup_check": on}
    check(want["subgroup_check"].count(False) == len(bad)
          and want["no_subgroup_check"].count(False) == len(bad) - 1,
          "the oracle's masks do not single out the bad lanes")
    oracle_s = time.perf_counter() - t0
    p, q = pt.g1_from_ints(g1, DEVICE), pt.g2_from_ints(g2, DEVICE)
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    full, first_s = run_path("validate_inputs", VALIDATE_KERNELS,
                             lambda: pt.validate_inputs(p, q), results)
    peak = torch.cuda.max_memory_allocated()
    fast = pt.validate_inputs(p, q, subgroup_check=False)
    for name, got in (("subgroup_check", full), ("no_subgroup_check", fast)):
        check(got.dtype == torch.bool and tuple(got.shape) == (BATCH,),
              f"validate_inputs ({name}): {got.dtype} {tuple(got.shape)}")
        diff = [i for i, (g, w) in enumerate(zip(got.tolist(), want[name])) if g != w]
        check(not diff, f"validate_inputs ({name}) differs from the oracle at lanes {diff[:8]}")
    runs = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        pt.validate_inputs(p, q)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / runs * 1e3
    entry = results["trajectory_end"]
    print(f"validation path: validate_inputs at {BATCH} lanes equals the oracle's masks lane for "
          f"lane with and without the subgroup check (bad lanes: {bad}; oracle {oracle_s:.1f} s); "
          f"{ms:.3f} ms per call ({runs} calls; first call {first_s:.3f} s), kernel H's end-only "
          f"mode {entry['ms']:.4f} ms of it, bound {entry['bound_ms']:.4f} ms "
          f"({entry['bound_by']}); peak device memory {peak / 2**30:.3f} GiB, "
          f"{(peak - held_before) / 2**20:.1f} MiB above the {held_before / 2**30:.3f} GiB held "
          f"before, on {card}", flush=True)


def stream_path(results, card: str, g1s, g2s, want):
    """``pairing_stream`` over STREAM_PAIRS pairs in chunks of BATCH on the
    card, checkpointed; then resumed from its checkpoints, and refused
    against changed inputs. Every lane against the oracle's value of its
    distinct pair."""
    from pairing_tpu_torch.fields.fp import int_to_limbs
    from pairing_tpu_torch.parallel.runner import pairing_stream
    from pairing_tpu_torch.utils.config import PairingConfig

    n = STREAM_PAIRS
    g1 = [g1s[i % UNIQUE] for i in range(n)]
    g2 = [g2s[i % UNIQUE] for i in range(n)]
    want_limbs = np.asarray([[int_to_limbs(v) for v in row] for row in want])  # [UNIQUE, 12, 21]
    with tempfile.TemporaryDirectory() as ckpt:
        cfg = PairingConfig(device=DEVICE, chunk_size=BATCH, checkpoint_dir=ckpt)
        chunks, seconds = run_path("pairing_stream", PAIRING_KERNELS,
                                   lambda: list(pairing_stream(g1, g2, cfg)), results)
        sizes = [len(ch) for ch in chunks]
        check(sizes == [BATCH, BATCH, n - 2 * BATCH], f"pairing_stream chunk sizes {sizes}")
        start = 0
        for i, ch in enumerate(chunks):
            check(ch.shape[1:] == (12, 21), f"chunk {i}: shape {ch.shape}")
            idx = (start + np.arange(len(ch))) % UNIQUE
            check(bool((ch == want_limbs[idx]).all()),
                  f"pairing_stream chunk {i} differs from the oracle")
            start += len(ch)
        t0 = time.perf_counter()
        again = list(pairing_stream(g1, g2, cfg))
        resume_s = time.perf_counter() - t0
        check(len(again) == len(chunks) and all(np.array_equal(a, b)
                                                for a, b in zip(again, chunks)),
              "the resumed pairing_stream differs from the first run")
        changed = list(g1)
        changed[0] = g1s[1]
        try:
            next(iter(pairing_stream(changed, g2, cfg)))
        except ValueError:
            refused = True
        else:
            refused = False
        check(refused, "pairing_stream resumed against changed inputs")
    print(f"stream path: pairing_stream over {n} pairs in chunks of {BATCH} ({sizes}) equals the "
          f"oracle on every lane; {seconds:.3f} s = {n / seconds:.1f} pairs/s with the codec, the "
          f"checkpoints and the host in the loop, on {card}; resumed from its checkpoints in "
          f"{resume_s:.3f} s, equal; refused against changed inputs", flush=True)
    return g1, g2, chunks


def stream_pass(p, q, chunk: int, consume=None):
    """One ``witness_stream`` pass: (the seconds at which each chunk was
    handed over, host bytes a chunk, the outs, checked after the clock)."""
    from pairing_tpu_torch.witness.stream import make_stream_fn, span_bytes, witness_stream

    run, n_bytes = make_stream_fn(), []

    def fn(pc, qc):
        res = run(pc, qc)
        if not n_bytes:
            n_bytes.append(span_bytes(res))
        return res

    outs, handed = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for start, out, trace in witness_stream(p, q, chunk, fn=fn):
        handed.append(time.perf_counter() - t0)
        if consume is not None:
            consume(start, out, trace)
        outs.append((start, out))
        del trace
    return handed, n_bytes[0], outs


def serial_pass(p, q, chunk: int) -> float:
    """The same chunks computed and copied out one after the other: compute,
    then the same copy into pinned memory waited for at once."""
    from pairing_tpu_torch.utils.interop import map_limbs
    from pairing_tpu_torch.witness import pairing_witness
    from pairing_tpu_torch.witness.stream import copy_out, map_tensors

    n = p.batch_shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for start in range(0, n, chunk):
        cut = lambda limbs: limbs[start:start + chunk]  # noqa: E731
        host = copy_out(pairing_witness(map_limbs(p, cut), map_limbs(q, cut)), non_blocking=True)
        torch.cuda.synchronize()
        map_tensors(host, lambda t: t.numpy())
        del host
    return time.perf_counter() - t0


def witness_stream_path(results, card: str, g1s, g2s, p, q, canon):
    """``witness_stream`` over the main path's pairs tiled to STREAM_LANES
    lanes, in chunks of BATCH and of BATCH // 2, after one checked warm-up
    pass in chunks of BATCH: every chunk's out equal to ``pairing``'s
    canonical values on its lanes, the first and the last chunk's host trace
    equal leaf for leaf to a one-shot ``pairing_witness`` of those lanes
    copied out (the lanes repeat every UNIQUE, so both chunks hold the main
    path's lanes). Then streamed witnesses/s beside the serial loop and the
    one-shot rate, host bytes a chunk, the first chunk apart, and peak
    device memory against the one-shot peak."""
    from pairing_tpu_torch.fields.fp12 import fq12_to_canonical_limbs
    from pairing_tpu_torch.utils.interop import fq12_from_leaves, map_limbs
    from pairing_tpu_torch.witness import pairing_witness
    from pairing_tpu_torch.witness.stream import copy_out, span_bytes, tensor_leaves

    def leaves(tree):
        return tensor_leaves(tree, (np.ndarray, torch.Tensor))

    n = STREAM_LANES
    pw, qw = tiled_points(g1s, g2s, (n,))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    one_shot = pairing_witness(p, q)
    torch.cuda.synchronize()
    one_peak = torch.cuda.max_memory_allocated() - base
    dev_bytes = span_bytes(one_shot)
    want = leaves(copy_out(one_shot, non_blocking=False))
    del one_shot

    def check_out(start, out, what):
        limbs = [c.limbs for s in out.s for c in (s.c0, s.c1)]
        got = fq12_to_canonical_limbs(fq12_from_leaves(limbs, DEVICE))
        lo = start % BATCH
        check(bool((got == canon[lo:lo + len(got)]).all()),
              f"witness_stream ({what}) chunk at {start}: out differs from pairing's")

    def check_chunk(start, out, trace):
        check_out(start, out, "warm-up")
        if start in (0, n - BATCH):
            got = leaves((out, trace))
            check(len(got) == len(want), f"chunk at {start}: {len(got)} leaves, want {len(want)}")
            for i, (g, w) in enumerate(zip(got, want)):
                check(g.shape == tuple(w.shape) and np.array_equal(g, w.numpy()),
                      f"witness_stream chunk at {start}: trace leaf {i} differs from the one-shot")

    (handed, _, _), _ = run_path(
        "witness_stream", WITNESS_KERNELS, lambda: stream_pass(pw, qw, BATCH, check_chunk),
        results)
    del want
    print(f"witness stream: warm-up pass over {n} lanes in chunks of {BATCH} ({handed[-1]:.3f} "
          f"s, first chunk {handed[0]:.3f} s): every chunk's out equals pairing's, the first and "
          f"the last chunk's host trace equal the one-shot pairing_witness leaf for leaf",
          flush=True)
    for chunk in (BATCH, BATCH // 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        handed, n_bytes, outs = stream_pass(pw, qw, chunk)
        peak = torch.cuda.max_memory_allocated() - base
        for start, out in outs:
            check_out(start, out, f"chunks of {chunk}")
        del outs
        serial = serial_pass(pw, qw, chunk)
        cut = lambda limbs: limbs[:chunk]  # noqa: E731
        pc, qc = map_limbs(pw, cut), map_limbs(qw, cut)
        pairing_witness(pc, qc)
        one = float("inf")
        for _ in range(3):  # the fastest: the rate the stream is held to
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pairing_witness(pc, qc)
            torch.cuda.synchronize()
            one = min(one, time.perf_counter() - t0)
        # the first chunk waits for two chunks' compute (and any first page-locking of
        # pinned blocks); the last for its own copy alone; between them each hand-over
        # is one chunk's compute with the previous chunk's copy beside it
        total, first = handed[-1], handed[0]
        period = (handed[-2] - first) / (len(handed) - 2)
        print(f"witness stream, chunks of {chunk}: {n / total:.1f} streamed witnesses/s with the "
              f"trace on the host ({total:.3f} s for {n} lanes; first chunk {first:.3f} s; then "
              f"one chunk each {period:.4f} s = {chunk / period:.1f}/s over the "
              f"{len(handed) - 2} overlapped hand-overs; the last chunk's copy "
              f"{handed[-1] - handed[-2]:.4f} s after); serial loop {n / serial:.1f}/s "
              f"({serial:.3f} s); one-shot on the "
              f"device {chunk / one:.1f}/s (the fastest of 3 calls, {one:.4f} s); host bytes a chunk {n_bytes} "
              f"({n_bytes / 2**30:.3f} GiB); peak device memory {peak / 2**30:.3f} GiB above the "
              f"inputs (one-shot at {BATCH} lanes {one_peak / 2**30:.3f} GiB, its trace "
              f"{dev_bytes / 2**30:.3f} GiB), on {card}", flush=True)
        check(peak <= 2 * one_peak, f"witness_stream in chunks of {chunk}: peak {peak} above "
              f"twice the one-shot peak {one_peak}")


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def parallel_path(results, card: str, p, q, canon, ps, qs, multi_canon, g1, g2, chunks):
    """The parallel layer on the one card: (a) a world of one over NCCL,
    ``pairing_data_parallel`` at BATCH lanes and ``multi_pairing_sharded``
    at K_PAIRS x BATCH products, equal to ``pairing`` and ``multi_pairing``
    lane for lane, then the all-gather collective over NCCL at BATCH
    lanes; (c) ``pairing_stream`` with ``mesh_shape=(1,)`` equal to the
    unsharded run; (b) two processes of ``parallel.launch --backend gloo
    --device cuda`` sharing the card, each checking its shard and the
    product of 2 x 2 pairings (the butterfly's exchange) against the
    oracle."""
    import torch.distributed as dist

    from pairing_tpu_torch.parallel import launch
    from pairing_tpu_torch.parallel import mesh as M
    from pairing_tpu_torch.parallel.collectives import fq12_reduce_mul_psum_style
    from pairing_tpu_torch.parallel.runner import pairing_stream
    from pairing_tpu_torch.utils.config import PairingConfig

    print(f"parallel: NCCL available: {dist.is_nccl_available()}; gloo available: "
          f"{dist.is_gloo_available()}", flush=True)
    launch.init_distributed(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    try:
        data = M.make_mesh((1,), ("data",))
        out, dp_s = run_path("pairing_data_parallel", PAIRING_KERNELS,
                             lambda: M.pairing_data_parallel(data, p, q), results)
        check(bool((canonical(out) == canon).all()), "pairing_data_parallel differs from pairing")
        pairs = M.make_mesh((1,), ("pairs",))
        out, mp_s = run_path("multi_pairing_sharded", MULTI_KERNELS,
                             lambda: M.multi_pairing_sharded(pairs, ps, qs), results)
        check(bool((canonical(out) == multi_canon).all()),
              "multi_pairing_sharded differs from multi_pairing")
        gathered = fq12_reduce_mul_psum_style(out, pairs.get_group("pairs"))
        check(bool((canonical(gathered) == multi_canon).all()),
              "the all-gather collective over NCCL changed its value")
        cfg = PairingConfig(device=DEVICE, chunk_size=BATCH, mesh_shape=(1,))
        sharded, st_s = run_path("pairing_stream_sharded", PAIRING_KERNELS,
                                 lambda: list(pairing_stream(g1, g2, cfg)), results)
        check(len(sharded) == len(chunks) and all(np.array_equal(a, b)
                                                  for a, b in zip(sharded, chunks)),
              "pairing_stream with mesh_shape=(1,) differs from the unsharded run")
    finally:
        dist.destroy_process_group()
    print(f"parallel, NCCL world of 1: pairing_data_parallel at {BATCH} lanes equals pairing lane "
          f"for lane ({dp_s:.3f} s), multi_pairing_sharded at K = {K_PAIRS} over {BATCH} products "
          f"equals multi_pairing ({mp_s:.3f} s), the all-gather collective keeps it, "
          f"pairing_stream with mesh_shape=(1,) equals the unsharded run over {len(g1)} pairs "
          f"({st_s:.3f} s), on {card}", flush=True)

    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pairing_tpu_torch.parallel.launch", "--backend", "gloo",
         "--device", "cuda", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(LAUNCH_PROCESSES), "--process-id", str(r),
         "--per-device-batch", str(LAUNCH_BATCH)],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(LAUNCH_PROCESSES)]
    t0 = time.perf_counter()
    try:
        outs = [pr.communicate(timeout=LAUNCH_TIMEOUT)[0] for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    for r, (pr, text) in enumerate(zip(procs, outs)):
        ok = [ln for ln in text.splitlines()
              if ln.startswith(f"process {r}/{LAUNCH_PROCESSES}:") and ln.endswith(": OK")]
        check(pr.returncode == 0 and len(ok) == 1,
              f"launch process {r} (gloo, cuda) failed, rc {pr.returncode}:\n{text[-4000:]}")
        print(f"parallel, launch --backend gloo --device cuda: {ok[0]}", flush=True)
    print(f"parallel: {LAUNCH_PROCESSES} processes on the one card over gloo, "
          f"{time.perf_counter() - t0:.1f} s with their start-up", flush=True)


def check_written(path, label):
    from pairing_tpu_torch.witness import (check_pairing_constraints, load_pairing_witness,
                                           verify_pairing_witness)

    t0 = time.perf_counter()
    meta, data = load_pairing_witness(path)
    check_pairing_constraints(meta, data)
    t1 = time.perf_counter()
    verify_pairing_witness(meta, data)
    print(f"{label}: written (K = {meta['k']}, B = {data['f_steps'].shape[1]}), "
          f"check_pairing_constraints {t1 - t0:.1f} s and verify_pairing_witness "
          f"{time.perf_counter() - t1:.1f} s accept it", flush=True)


def witness_path(results, card: str, p, q, pairing_canon, tmp: Path):
    from pairing_tpu_torch import witness as W

    torch.cuda.reset_peak_memory_stats()
    (out, trace), _ = run_path("pairing_witness", WITNESS_KERNELS,
                               lambda: W.pairing_witness(p, q), results)
    peak = torch.cuda.max_memory_allocated()
    check(bool((canonical(out) == pairing_canon).all()),
          "pairing_witness output differs from pairing's")
    print(f"witness path: output equals pairing's on all {BATCH} lanes", flush=True)
    path = str(tmp / "witness_cut.npz")
    W.save_pairing_witness(path, p, q, out, trace, lanes=range(WITNESS_CUT))
    del out, trace

    runs = 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        W.pairing_witness(p, q)
    torch.cuda.synchronize()
    per_batch = (time.perf_counter() - t0) / runs
    print(f"witness path: pairing_witness {per_batch:.3f} s per batch of {BATCH} = "
          f"{BATCH / per_batch:.1f} witnesses/s (trace generation on the device, no "
          f"serialization); peak device memory {peak / 2**30:.2f} GiB on {card}", flush=True)
    check_written(path, f"witness path: the first {WITNESS_CUT} lanes")


def multi_witness(ps, qs, tmp: Path):
    from pairing_tpu_torch import witness as W
    from pairing_tpu_torch.utils.interop import map_limbs

    n = MULTI_WITNESS_PRODUCTS
    first = lambda limbs: limbs[:, :n].contiguous()  # noqa: E731
    p, q = map_limbs(ps, first), map_limbs(qs, first)
    out, trace = W.multi_pairing_witness(p, q)
    path = str(tmp / "multi_witness.npz")
    W.save_pairing_witness(path, p, q, out, trace)
    check_written(path, f"multi_pairing_witness at K = {K_PAIRS} on {n} products")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    card = query_gpu("name,power.limit")
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    from pairing_tpu_torch.ops import build

    t0 = time.perf_counter()
    _, info = build.load()
    print(f"build: nvcc {info.seconds:.1f} s, load {time.perf_counter() - t0:.1f} s, "
          f"{info.path}", flush=True)
    for line in info.ptxas.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("ptxas:", line.strip())

    library_sass(info.path)
    results: dict = {}
    kernel_phases(results, Bounds(), info.ptxas)
    torch.cuda.empty_cache()
    g1s, g2s = seeded_pairs()
    p, q, canon, want = main_path(results, card, g1s, g2s)
    ps, qs, multi_canon = multi_path(results, card, g1s, g2s)
    with tempfile.TemporaryDirectory() as tmp:
        witness_path(results, card, p, q, canon, Path(tmp))
        multi_witness(ps, qs, Path(tmp))
    fused_chain_path(results, card, p, q, canon, want)
    split_final_exp_path(results, p, q, canon)
    fq12_pow_path(results, card)
    klayout_path(results)
    validation_path(results, card, g1s, g2s)
    g1, g2, chunks = stream_path(results, card, g1s, g2s, want)
    torch.cuda.empty_cache()
    witness_stream_path(results, card, g1s, g2s, p, q, canon)
    torch.cuda.empty_cache()
    parallel_path(results, card, p, q, canon, ps, qs, multi_canon, g1, g2, chunks)

    # "launches" is the count in the path each kernel (mode) serves
    home = {n: "pairing" for n in PAIRING_KERNELS}
    home.update(miller_f_multi="multi_pairing", miller_f_collect="pairing_witness",
                exp_bits="pairing_witness", affine_export="pairing_witness",
                hard_chain="pairing_fused_chain", pow_ladder_w4="split_final_exp",
                fq12_sq="fq12_pow", fq12_mul_sparse="kernel_layout_ops",
                pow_ladder="kernel_layout_ops", trajectory_end="validate_inputs")
    for name, r in results.items():
        r["launches"] = r["launches_by_path"][home[name]]
    print(json.dumps({"kernels": [results[n] for n in KERNEL_SOURCES]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
