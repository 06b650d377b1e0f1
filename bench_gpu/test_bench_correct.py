"""What decides ``correct``, on the CPU at a size a test run holds: each
cell's run, driven through the harness past its look for a chip, comes out
correct as it is, and not correct with its control in the program's place
or with the timed path broken underneath in each way the cell can break:

  * an answer altered where it is produced;
  * half of the batch left out, the other half's answers given for it;
  * a step that returns its state unchanged (the Miller loop's accumulator
    for verification, an x-power ladder's for witnesses).

The cells run on one chip, so no exchange between chips can be left out.
"""

import copy
import json
import shutil
import time

import pytest
import torch

import pairing_tpu_torch as pt
from bench_gpu import harness
from pairing_tpu_torch.fields import fp12 as F12
from pairing_tpu_torch.ops.fq12_kernels import kf12_from
from pairing_tpu_torch.utils.interop import map_limbs
from pairing_tpu_torch.witness import stream as stream_mod
from pairing_tpu_torch.witness import trace as trace_mod

SEED = 2**36 + 99
TINY = {
    "groth16.tiny": ("groth16_verify", {
        "generator": "groth16_proofs", "why": "four proofs: two with C moved, one with B "
        "outside G2", "pool": 4, "batch": 4, "bad_c_every": 2,
        "bad_b_every": 4, "warmup_calls": 0, "trace_warm_steps": 0, "trace_steps": 1}),
    "witness.tiny": ("plonky2_pairing_witness", {
        "generator": "pairs", "why": "one chunk of two lanes", "pool": 2, "g2_pool": 1,
        "chunk_size": 2, "warmup_chunks": 0, "max_rate": 1, "trace_warm_steps": 0,
        "trace_steps": 1}),
}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """BENCHMARK.json with the two tiny cells, and a copy of the benchmark's
    folder holding their traffic files."""
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("bench") / "bench_gpu"
    shutil.copytree(harness.BENCH_DIR, root, ignore=shutil.ignore_patterns("__pycache__"))
    b = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for name, (config, traffic) in TINY.items():
        (root / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
        b["workloads"].append({"name": name, "config": config, "traffic": name, "chips": 1,
                               "why": traffic["why"]})
        for m in b["end_to_end"] + b["per_layer"]:
            if "workloads" in m and any(w.split(".")[0] == name.split(".")[0]
                                        for w in m["workloads"]):
                m["workloads"].append(name)
    return b, root


def run(bench, name, control=False):
    b, root = bench
    return harness.run_cell(copy.deepcopy(b), name, SEED, 0.0, False, "cpu",
                            time.perf_counter(), control=control, root=root)


# -- faults of the verify path ----------------------------------------------


def altered_product(monkeypatch):
    real = pt.multi_pairing

    def fake(ps, qs):
        out = real(ps, qs)
        out.s[0].c0.limbs[..., 0] += 1
        return out

    monkeypatch.setattr(pt, "multi_pairing", fake)


def half_the_proofs(monkeypatch):
    real = pt.multi_pairing

    def fake(ps, qs):
        h = ps.batch_shape[1] // 2
        dup = lambda t: torch.cat([t[:, :h], t[:, :h]], dim=1)  # noqa: E731
        return real(map_limbs(ps, dup), map_limbs(qs, dup))

    monkeypatch.setattr(pt, "multi_pairing", fake)


def miller_state_unchanged(monkeypatch):
    from pairing_tpu_torch.pairing import api

    def fake(qs, ps):
        return kf12_from(F12.fq12_one((qs.batch_shape[1],), qs.x.c0.device))

    monkeypatch.setattr(api, "multi_miller_loop_k", fake)


# -- faults of the witness path ---------------------------------------------


def altered_witness(monkeypatch):
    real = stream_mod.pairing_witness

    def fake(p, q):
        out, trace = real(p, q)
        out.s[0].c0.limbs[..., 0] += 1
        return out, trace

    monkeypatch.setattr(stream_mod, "pairing_witness", fake)


def half_the_lanes(monkeypatch):
    real = stream_mod.pairing_witness

    def fake(p, q):
        h = p.batch_shape[0] // 2
        dup = lambda t: torch.cat([t[:h], t[:h]])  # noqa: E731
        return real(map_limbs(p, dup), map_limbs(q, dup))

    monkeypatch.setattr(stream_mod, "pairing_witness", fake)


def ladder_state_unchanged(monkeypatch):
    def fake(x, bits):
        rows = x.expand((len(bits),) + tuple(x.shape)).clone()
        return rows[-1], rows

    monkeypatch.setattr(trace_mod, "exp_bits_ladder", fake)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(bench, cell):
    result = run(bench, cell)
    assert result["correct"], result["checks"]
    assert all(c["value"] == 0 for c in result["checks"].values())
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct(bench, cell):
    result = run(bench, cell, control=True)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell,fault", [
    ("groth16.tiny", altered_product), ("groth16.tiny", half_the_proofs),
    ("groth16.tiny", miller_state_unchanged), ("witness.tiny", altered_witness),
    ("witness.tiny", half_the_lanes), ("witness.tiny", ladder_state_unchanged)],
    ids=lambda f: getattr(f, "__name__", f))
def test_fault_is_not_correct(bench, monkeypatch, cell, fault):
    fault(monkeypatch)
    result = run(bench, cell)
    assert not result["correct"], result["checks"]
