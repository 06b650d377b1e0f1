"""The port's ``torch.profiler.record_function`` ranges: which appear on
each entry, and how they nest.

On the CPU (one parametrised test): ``validate_inputs`` and ``pairing`` on
one point pair, ``multi_pairing`` with K = 2 and batch 1,
``witness_stream`` with a cheap ``fn`` over 2 lanes in chunks of 1, and
``pairing_stream`` over one pair, checkpointed, then run again over its
checkpoint (the rerun opens ``stream.resume`` alone). Each
runs under the profiler with only the ``record_function`` scope recorded
(the plain versions of the kernels make hundreds of thousands of tensor
operations, which a full profile would record one by one); every range of
the entry's path must appear with the parent range it has in the program,
and no other range. The CPU branch of the stream has no wait, so
``witness.stream.wait`` is asserted only on the card. About 45 s on two
threads.

Marked ``cuda`` (skips without a card; from the repository root on a
machine with the card, ``python -m pytest --noconftest
tests/test_torch_spans.py -q -k cuda``): ``validate_inputs`` and
``multi_pairing`` at 256 products of 4 pairs, ``pairing`` at 256 lanes, a
2-chunk ``witness_stream`` and a 2-chunk checkpointed ``pairing_stream``
from Python ints, each under the full profiler. Every kernel and every
copy to or from pageable host memory must be launched inside a range of
the program (``stream.*`` among them), and the pageable copies of each entry must number
the synchronising operations that ``torch.cuda.set_sync_debug_mode("warn")``
reports for it; ``multi_pairing`` and ``pairing`` make none. Each call of
the Miller loop's ``miller_loop.N_normalize.points``,
``miller_loop.N_normalize.inverse`` and ``miller_loop.C_lines.epilogue``
launches its one kernel (``k_epilogue_points``, ``k_fq2_inv``,
``k_epilogue_lines``), no other kernel and no pageable copy.
"""

import json
import os
import re
import tempfile
import warnings

import pytest
import torch

import pairing_tpu_torch as pt
from pairing_tpu_torch.oracle import native as o
from pairing_tpu_torch.parallel.runner import pairing_stream
from pairing_tpu_torch.utils import bn254 as c
from pairing_tpu_torch.utils.config import PairingConfig
from pairing_tpu_torch.utils.interop import map_limbs, reshape_points
from pairing_tpu_torch.witness.stream import witness_stream

torch.set_num_threads(2)

G2GEN = (c.G2_GEN_X, c.G2_GEN_Y)
#: the names of the program's ranges start with these
PROGRAM = ("pairing.", "validate.", "miller_loop.", "final_exp.", "witness.", "stream.")

#: each range of an entry's path and the range it lies directly inside
VALIDATE = {
    "validate.inputs": None,
    "validate.g1_on_curve": "validate.inputs",
    "validate.g2_on_curve": "validate.inputs",
    "validate.g2_subgroup": "validate.inputs",
    "validate.g2_subgroup.ladder": "validate.g2_subgroup",
    "validate.g2_subgroup.compare": "validate.g2_subgroup",
}
MILLER = {
    "miller_loop.B_trajectory": "{entry}",
    "miller_loop.N_normalize": "{entry}",
    "miller_loop.N_normalize.points": "miller_loop.N_normalize",
    "miller_loop.N_normalize.prefix": "miller_loop.N_normalize",
    "miller_loop.N_normalize.inverse": "miller_loop.N_normalize",
    "miller_loop.N_normalize.running": "miller_loop.N_normalize",
    "miller_loop.C_lines": "{entry}",
    "miller_loop.C_lines.lines": "miller_loop.C_lines",
    "miller_loop.C_lines.epilogue": "miller_loop.C_lines",
    "miller_loop.D_miller_f": "{entry}",
}
FINAL_EXP = {
    "final_exp.easy_part": "{entry}",
    "final_exp.pow_x_ladders": "{entry}",
    "final_exp.hard_chain": "{entry}",
}
WITNESS = {
    "witness.affine_export": "witness.pairing",
    "witness.exp_ladders": "witness.pairing",
}


def _under(table: dict, entry: str) -> dict:
    out = {entry: None}
    out.update({k: v.format(entry=entry) if v else v for k, v in table.items()})
    return out


#: each entry's own ranges around the phases: the flattening of the public
#: points (``pairing`` only) and the conversion of the result to the public Fq12
EDGES = {"pairing.pairing": ("pairing.flatten", "pairing.output"),
         "pairing.multi_pairing": ("pairing.output",)}


def pairing_path(entry: str) -> dict:
    return _under({**MILLER, **FINAL_EXP, **{name: "{entry}" for name in EDGES[entry]}}, entry)


def witness_path() -> dict:
    """``pairing_witness`` of one stream chunk, then its copy, wait and
    hand-over: the chunk's final exponentiation is the easy part, the
    three K12 ladders and the chain, all inside ``witness.pairing``."""
    path = _under({**MILLER, **WITNESS, "final_exp.easy_part": "{entry}",
                   "final_exp.hard_chain": "{entry}"}, "witness.pairing")
    path.update({"witness.stream.copy_out": None, "witness.stream.wait": None,
                 "witness.stream.handover": None})
    return path


def pairing_stream_path() -> dict:
    """A chunk of ``pairing_stream`` computed and checkpointed: its six
    steps inside ``stream.chunk``, the pairing's own ranges inside
    ``pairing.pairing``; and a chunk read back from its checkpoint."""
    path = {"stream.chunk": None, "stream.resume": None}
    path.update({name: "stream.chunk" for name in (
        "stream.encode", "stream.canonical", "stream.to_host", "stream.digest",
        "stream.checkpoint")})
    path.update(pairing_path("pairing.pairing"))
    path["pairing.pairing"] = "stream.chunk"
    return path


def _stream_twice(g1, g2, chunk: int, device) -> None:
    """``pairing_stream`` over the ints ``g1``, ``g2`` into a new checkpoint
    directory, then again over it: every chunk computed, then every chunk
    resumed."""
    with tempfile.TemporaryDirectory() as ckpt:
        cfg = PairingConfig(device=device, chunk_size=chunk, checkpoint_dir=ckpt)
        first = list(pairing_stream(g1, g2, cfg))
        again = list(pairing_stream(g1, g2, cfg))
    assert [a.tolist() for a in again] == [a.tolist() for a in first]


def parents(ranges):
    """{name: set of the names of the ranges each occurrence lies directly
    inside (None at the top)}; ``ranges`` are (name, start, end)."""
    out = {}
    for name, a, b in ranges:
        holders = [r for r in ranges if r[1] <= a and b <= r[2] and r != (name, a, b)]
        inner = min(holders, key=lambda r: r[2] - r[1], default=None)
        out.setdefault(name, set()).add(inner[0] if inner else None)
    return out


def assert_nesting(ranges, want: dict):
    got = parents(ranges)
    assert set(got) == set(want), (sorted(set(got) - set(want)), sorted(set(want) - set(got)))
    for name, parent in want.items():
        assert got[name] == {parent}, (name, got[name], parent)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


def user_ranges(fn):
    """The ``record_function`` ranges ``fn()`` opens, as (name, start ns, end
    ns): the profiler (Kineto, CPU activity) with only the user scope
    recorded, so the tensor operations themselves cost nothing to trace."""
    from torch._C._profiler import (ProfilerActivity, ProfilerConfig, ProfilerState,
                                    RecordScope, _ExperimentalConfig)
    from torch.autograd.profiler import _disable_profiler, _enable_profiler, _prepare_profiler

    config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                            _ExperimentalConfig())
    activities = {ProfilerActivity.CPU}
    _prepare_profiler(config, activities)
    _enable_profiler(config, activities, {RecordScope.USER_SCOPE})
    try:
        fn()
    finally:
        result = _disable_profiler()
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in result.events()]


def _points(n: int, device):
    p = pt.g1_from_ints([o.g1_mul(c.G1_GEN, k + 1) for k in range(n)], device)
    q = pt.g2_from_ints([o.g2_mul(G2GEN, 2 * k + 1) for k in range(n)], device)
    return p, q


def _cheap_fn(pc, qc):
    return pc.x.limbs + 1, {"qx": qc.x.c0.limbs, "rows": [pc.y.limbs * 2]}


def _validate_case():
    p, q = _points(1, "cpu")
    return lambda: pt.validate_inputs(p, q), VALIDATE


def _pairing_case():
    p, q = _points(1, "cpu")
    return lambda: pt.pairing(p, q), pairing_path("pairing.pairing")


def _multi_pairing_case():
    p, q = _points(2, "cpu")
    ps, qs = reshape_points(p, (2, 1)), reshape_points(q, (2, 1))
    return lambda: pt.multi_pairing(ps, qs), pairing_path("pairing.multi_pairing")


def _stream_case():
    p, q = _points(2, "cpu")

    def run():
        assert [s for s, _, _ in witness_stream(p, q, 1, fn=_cheap_fn)] == [0, 1]

    return run, {"witness.stream.copy_out": None, "witness.stream.handover": None}


def _pairing_stream_case():
    g1, g2 = [c.G1_GEN], [G2GEN]
    return lambda: _stream_twice(g1, g2, 1, "cpu"), pairing_stream_path()


CPU_CASES = {"validate_inputs": _validate_case, "pairing": _pairing_case,
             "multi_pairing": _multi_pairing_case, "witness_stream": _stream_case,
             "pairing_stream": _pairing_stream_case}


@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_ranges_nest_as_the_program_opens_them(case):
    fn, want = CPU_CASES[case]()
    ranges = user_ranges(fn)
    assert_nesting(ranges, want)
    if case == "witness_stream":  # two chunks, each copied and handed over once
        assert sorted(n for n, _, _ in ranges) == ["witness.stream.copy_out"] * 2 + [
            "witness.stream.handover"] * 2
    if case == "pairing_stream":  # the chunk computed once; the rerun only resumes
        tops = sorted((a, n) for n, a, _ in ranges if n in ("stream.chunk", "stream.resume"))
        assert [n for _, n in tops] == ["stream.chunk", "stream.resume"]
        assert [n for n, a, _ in ranges if a >= tops[1][0]] == ["stream.resume"]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

PAGEABLE = ("Memcpy HtoD (Pageable -> Device)", "Memcpy DtoH (Device -> Pageable)")
#: what ``torch.cuda.set_sync_debug_mode("warn")`` says of each synchronising operation
SYNC_WARNING = "called a synchronizing CUDA operation"


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card (see the module docstring)")
    products, pairs, chunk = 256, 4, 64
    p, q = _points(8, "cuda")

    def lanes(pts, n):
        return map_limbs(pts, lambda t: t.repeat(-(-n // t.shape[0]), 1)[:n])

    ps = reshape_points(lanes(p, products * pairs), (pairs, products))
    qs = reshape_points(lanes(q, products * pairs), (pairs, products))
    pw, qw = lanes(p, 2 * chunk), lanes(q, 2 * chunk)
    g1 = [o.g1_mul(c.G1_GEN, k % 8 + 1) for k in range(2 * chunk)]
    g2 = [o.g2_mul(G2GEN, 2 * (k % 8) + 1) for k in range(2 * chunk)]
    p1, q1 = map_limbs(ps, lambda t: t[0]), map_limbs(qs, lambda t: t[0])
    entries = {
        "validate_inputs": (lambda: pt.validate_inputs(p1, q1), VALIDATE),
        "multi_pairing": (lambda: pt.multi_pairing(ps, qs), pairing_path("pairing.multi_pairing")),
        "pairing": (lambda: pt.pairing(p1, q1), pairing_path("pairing.pairing")),
        "witness_stream": (lambda: [s for s, _, _ in witness_stream(pw, qw, chunk)],
                           witness_path()),
        "pairing_stream": (lambda: _stream_twice(g1, g2, chunk, "cuda"), pairing_stream_path()),
    }
    for fn, _ in entries.values():  # build the kernels, warm every shape
        fn()
    torch.cuda.synchronize()
    return entries


def profile_on_card(fn):
    """``fn()`` under the full profiler (CPU and CUDA activity) with the
    synchronisation warnings on: (chrome trace events, the synchronising
    operations warned of)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    # the first use of the mode in a process also warns that it is a prototype
    syncs = sum(SYNC_WARNING in str(w.message) for w in caught)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return events, syncs


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["validate_inputs", "multi_pairing", "pairing",
                                   "witness_stream", "pairing_stream"])
def test_cuda_every_launch_lies_in_a_program_range(card, entry):
    fn, want = card[entry]
    events, syncs = profile_on_card(fn)
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("cat") == "user_annotation"]
    assert_nesting(spans, want)
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    program = [(a, b) for n, a, b in spans if n.startswith(PROGRAM)]

    def in_program(e):
        t = launch.get(e.get("args", {}).get("correlation"))
        return t is not None and any(a <= t <= b for a, b in program)

    kernels = [e for e in events if e.get("cat") == "kernel"]
    pageable = [e for e in events if e.get("cat") == "gpu_memcpy" and e["name"] in PAGEABLE]
    assert kernels
    outside = [e["name"][:60] for e in kernels + pageable if not in_program(e)]
    assert not outside, outside
    assert len(pageable) == syncs, (len(pageable), syncs)
    if entry in ("multi_pairing", "pairing"):  # no blocking copy left in a call
        assert syncs == 0, [e["name"][:60] for e in pageable]
    if entry == "validate_inputs":
        return
    # each such range: one launch, of its kernel; no pageable copy
    for name, kernel in ONE_KERNEL.items():
        calls = [(a, b) for n, a, b in spans if n == name]
        assert calls, name
        for a, b in calls:
            inside = [e for e in kernels + pageable
                      if a <= launch.get(e.get("args", {}).get("correlation"), -1) <= b]
            names = [_kernel_name(e["name"]) for e in inside]
            assert names == [kernel], (name, [e["name"][:60] for e in inside])


#: the Miller loop's ranges of one kernel each: the epilogue points and
#: lines, and Phase N's Fq2 inverse
ONE_KERNEL = {"miller_loop.N_normalize.points": "k_epilogue_points",
              "miller_loop.N_normalize.inverse": "k_fq2_inv",
              "miller_loop.C_lines.epilogue": "k_epilogue_lines"}


def _kernel_name(name: str):
    """``k_*`` of one of the port's kernels in the trace (``void
    pt::k_lines(...)``), else None."""
    m = re.match(r"(?:void )?(?:pt::)?(k_\w+)", name)
    return m.group(1) if m else None
