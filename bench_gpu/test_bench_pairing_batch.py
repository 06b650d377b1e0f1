"""The ``bn254_pairing_batch`` cells on the CPU at a size a test run holds
(a pool of 16 pairs, 8 G2 points, calls of 8): a sound run is correct, a
value altered where ``pairing`` produces it and the control (the easy part
alone) are not, the reference's recurrence gives the oracle's pairing on
every lane of a slice, the cell's metric readers read what they name, and
kernel C's count at its shapes is ``chip_smoke.py``'s K = 1 count."""

import copy
import importlib.util
import json
import shutil
import time

import pytest
import torch

import pairing_tpu_torch as pt
from bench_gpu import harness
from bench_gpu import roofline as RL
from bench_gpu.generators import pairs
from bench_gpu.reference import limbs
from bench_gpu.reference import oracle as o
from bench_gpu.reference import pairing_batch as ref
from bench_gpu.roofline import least_seconds, miller_f_multi
from bench_gpu.tracing import Trace

SEED = 2**35 + 17
CELL = "pairing.tiny"
TRAFFIC = {"generator": "pairs", "why": "two slices of eight pairs", "pool": 16, "g2_pool": 8,
           "batch": 8, "warmup_calls": 0, "trace_warm_steps": 0, "trace_steps": 1}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """BENCHMARK.json with the tiny cell beside ``pairing.b16384``, and a
    copy of the benchmark's folder holding its traffic file."""
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("bench") / "bench_gpu"
    shutil.copytree(harness.BENCH_DIR, root, ignore=shutil.ignore_patterns("__pycache__"))
    (root / "traffic" / f"{CELL}.json").write_text(json.dumps(TRAFFIC))
    b = harness.load_json(harness.ROOT / "BENCHMARK.json")
    b["workloads"].append({"name": CELL, "config": "bn254_pairing_batch", "traffic": CELL,
                           "chips": 1, "why": TRAFFIC["why"]})
    for m in b["end_to_end"] + b["per_layer"]:
        if "pairing.b16384" in m.get("workloads", []):
            m["workloads"].append(CELL)
    return b, root


def run(bench, control=False):
    b, root = bench
    return harness.run_cell(copy.deepcopy(b), CELL, SEED, 0.0, False, "cpu",
                            time.perf_counter(), control=control, root=root)


def test_sound_run_is_correct(bench):
    result = run(bench)
    assert result["correct"], result["checks"]
    assert {n: c["value"] for n, c in result["checks"].items()} == {"value_wrong": 0,
                                                                    "oracle_wrong": 0}
    assert result["attempted"] == 8 and result["failed"] == 0
    assert set(result["metrics"]) == {"call_ms_p90", "setup_s"}


def test_one_altered_limb_is_a_wrong_value(bench, monkeypatch):
    real = pt.pairing

    def fake(p, q):
        out = real(p, q)
        out.s[3].c1.limbs[5, 0] += 1
        return out

    monkeypatch.setattr(pt, "pairing", fake)
    result = run(bench)
    assert not result["correct"]
    assert result["checks"]["value_wrong"]["value"] >= 1


def test_control_is_not_correct(bench):
    result = run(bench, control=True)
    assert not result["correct"], result["checks"]
    assert result["checks"]["value_wrong"]["value"] >= 8


def test_recurrence_is_the_oracles_pairing():
    ps, qs = pairs.make(SEED, pool=16, g2_pool=8)
    lanes = range(8, 16)
    values = ref.lane_values(ps, qs, lanes)
    assert values == [o.pairing(ps[i], qs[i]) for i in lanes]
    rows = ref.expected_rows(values[:2])
    assert rows.tolist() == [[limbs.representatives(c) for c in v] for v in values[:2]]


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def test_the_cells_metrics_read_what_they_name(bench):
    """Two steps of 1000 us: kernel C for 400 us inside ``miller_loop.``, a
    final-exp kernel for 100 us, a transpose for 10 us inside
    ``pairing.output``; a trace without the edges' ranges reads None there."""
    ev, corr = [], 0
    for base in (0, 1000):
        ev.append(_x("user_annotation", "bench.step", base, 1000))
        ev.append(_x("user_annotation", "pairing.pairing", base + 10, 900))
        ev.append(_x("user_annotation", "pairing.flatten", base + 10, 5))
        ev.append(_x("user_annotation", "miller_loop.D_miller_f", base + 20, 100))
        ev.append(_x("user_annotation", "final_exp.hard_chain", base + 440, 100))
        ev.append(_x("user_annotation", "pairing.output", base + 590, 50))
        for at, name, dur in ((30, "void pt::k_miller_f(int const*)", 400),
                              (450, "void pt::k_fq12_mul(int const*)", 100),
                              (600, "void at::native::elementwise_kernel<128, 4>()", 10)):
            corr += 1
            ev.append(_x("cuda_runtime", "cudaLaunchKernel", base + at, 2, correlation=corr))
            ev.append(_x("kernel", name, base + at + 5, dur, tid=7, correlation=corr))
    shapes = {"products": 16384, "pairs": 1}
    trace = Trace({"traceEvents": ev}, counters={"host_bytes_per_pair": 1008.0}, shapes=shapes)
    b, root = bench
    names = [m["name"] for m in harness.plan(b, CELL, root)["per_layer"]]
    got = {n: harness.reader(root, "metrics", n)(trace) for n in names}
    least = least_seconds(miller_f_multi.work(16384, 1), miller_f_multi.n_bytes(16384, 1))
    assert got == {
        "miller_loop_device_ms.pairing": pytest.approx(0.4),
        "final_exp_device_ms.pairing": pytest.approx(0.1),
        "edges_device_ms.pairing": pytest.approx(0.01),
        "miller_f_single_roofline": pytest.approx(100 * least / 400e-6),
        "host_bytes_per_pair.pairing": 1008.0,
        "host_syncs.pairing": 0.0,
        "device_idle_share.pairing": pytest.approx(1 - 2 * 510 / 2000),
    }
    parent = Trace({"traceEvents": [e for e in ev if e["name"] not in ("pairing.flatten",
                                                                        "pairing.output")]})
    assert harness.reader(root, "metrics", "edges_device_ms.pairing")(parent) is None


def test_single_pair_count_is_chip_smokes_k1():
    """``miller_f_single_roofline`` reads C at the shapes (16384, 1): the
    count of ``chip_smoke.py``'s K = 1 case, whose 13-bit bound is 3.37 ms."""
    from pairing_tpu_torch.pairing import miller_loop as ML

    spec = importlib.util.spec_from_file_location("chip_smoke", harness.ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    lanes = 16384
    want = lanes * (ML.N_STEPS * smoke.FQ12_SQ
                    + (ML.N_STEPS + ML.N_ADDS + 2) * smoke.FQ12_SPARSE)
    assert miller_f_multi.shapes_of({"products": lanes, "pairs": 1}) == (lanes, 1)
    assert miller_f_multi.work(lanes, 1).issues(RL.LIMB13) == want
    assert want / RL.IMADS_PER_S * 1e3 == pytest.approx(3.37, abs=0.005)
