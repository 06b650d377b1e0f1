"""The ``bn254_pairing_stream`` cells on the CPU at a size a test run holds
(a job of 64 pairs in chunks of 8, pools of 32 G1 and 12 G2 points): the
generator's pairs are distinct and a chunk's recurrence is the oracle's
pairing; a sound run with a preemption and its resume is correct; one
altered limb, a checkpoint deleted, rewritten or read back altered, and
the control are not; the cell's metric readers read what they name, and
the range readers read nothing on a program without the stream's ranges.

A run here takes a fixed number of steps with the preemption the traced
run makes (after ``trace_preempt_after`` chunks), so that every test knows
which chunks are computed and which resumed. About 2 min on two threads.
"""

import copy
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from bench_gpu import harness
from bench_gpu.generators import stream_pairs
from bench_gpu.reference import oracle as o
from bench_gpu.reference import pairing_batch as batch_ref
from bench_gpu.reference import pairing_stream as ref
from bench_gpu.tracing import Trace
from pairing_tpu_torch.parallel import runner

SEED = 2**33 + 91
CELL = "stream.tiny"
TRAFFIC = {"generator": "stream_pairs", "why": "a job of 64 pairs in chunks of 8", "pairs": 64,
           "chunk_size": 8, "g1_pool": 32, "g2_shift": 4, "warmup_chunks": 0,
           "trace_warm_steps": 0, "trace_steps": 1, "trace_preempt_after": 2}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """BENCHMARK.json with the tiny cell beside ``stream.1m``, and a copy of
    the benchmark's folder holding its traffic file."""
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("bench") / "bench_gpu"
    shutil.copytree(harness.BENCH_DIR, root, ignore=shutil.ignore_patterns("__pycache__"))
    (root / "traffic" / f"{CELL}.json").write_text(json.dumps(TRAFFIC))
    b = harness.load_json(harness.ROOT / "BENCHMARK.json")
    b["workloads"].append({"name": CELL, "config": "bn254_pairing_stream", "traffic": CELL,
                           "chips": 1, "why": TRAFFIC["why"]})
    for m in b["end_to_end"] + b["per_layer"]:
        if "stream.1m" in m.get("workloads", []):
            m["workloads"].append(CELL)
    return b, root


def run(bench, steps, control=False, preempt_after=2, patch=None):
    """One run of the tiny cell through the harness, with ``steps`` steps
    and the preemption after ``preempt_after`` chunks; ``patch(driver)``
    may alter the driver before its first step."""
    b, root = bench
    traffic = dict(TRAFFIC, trace_preempt_after=preempt_after)
    (root / "traffic" / f"{CELL}.json").write_text(json.dumps(traffic))

    def fixed(drv, seconds):
        drv.traced = True  # the traced run's preemption point
        if patch:
            patch(drv)
        out = []
        for _ in range(steps):
            a = time.perf_counter()
            n = drv.step()
            out.append((a, time.perf_counter(), n))
        return out

    real = harness._steps
    harness._steps = fixed
    try:
        return harness.run_cell(copy.deepcopy(b), CELL, SEED, 0.0, False, "cpu",
                                time.perf_counter(), control=control, root=root)
    finally:
        harness._steps = real


def checks(result):
    return {n: c["value"] for n, c in result["checks"].items()}


def test_pairs_are_distinct_and_a_chunks_recurrence_is_the_oracles():
    ps, qs = stream_pairs.make(SEED, **{k: v for k, v in TRAFFIC.items() if k != "generator"})
    assert len(ps) == len(qs) == 64
    assert len(set(zip(ps, qs))) == 64
    assert len(set(ps)) == 32 and len(set(qs)) == 12
    lanes = range(40, 48)  # chunk 5: s = 1, t = 1
    assert ps[40:48] == ps[8:16] and qs[40:48] == qs[32:40]
    values = batch_ref.lane_values(ps, qs, lanes)
    assert values == [o.pairing(ps[i], qs[i]) for i in lanes]
    rows = ref.canonical_rows(values[:1])
    weights = np.array([1 << (13 * i) for i in range(21)], dtype=object)
    assert [int(v) for v in (rows[0].astype(object) * weights).sum(axis=-1)] == values[0]


def test_sound_run_is_correct(bench):
    """Chunks 0 and 1 computed, the preemption, both resumed, chunk 2
    computed: every check reads 0."""
    result = run(bench, steps=5)
    assert result["correct"], result["checks"]
    assert checks(result) == {"value_wrong": 0, "oracle_wrong": 0, "checkpoint_wrong": 0}
    assert result["attempted"] == 40 and result["failed"] == 0
    assert set(result["metrics"]) == {"call_ms_p90", "setup_s"}


def test_one_altered_limb_is_a_wrong_value(bench, monkeypatch):
    real = runner.F12.fq12_to_canonical_limbs

    def fake(a):
        out = real(a).clone()
        out[3, 7, 0] += 1
        return out

    monkeypatch.setattr(runner.F12, "fq12_to_canonical_limbs", fake)
    result = run(bench, steps=1)
    assert not result["correct"]
    assert checks(result)["value_wrong"] >= 1


def _path(drv, c):
    return os.path.join(drv.dir, f"pairing_chunk_{c:06d}.npz")


def _deleted_before_the_preemption(drv):
    preempt = drv._preempt

    def deleted():
        os.unlink(_path(drv, 0))
        preempt()

    drv._preempt = deleted


def _rewritten_after_the_preemption(drv):
    """Chunk 0's file goes after the preemption's record: the resumed stream
    computes it again and publishes a new file in its place."""
    preempt = drv._preempt

    def then_deleted():
        preempt()
        os.unlink(_path(drv, 0))

    drv._preempt = then_deleted


@pytest.mark.parametrize("fault", ["deleted", "rewritten", "read_back_altered"])
def test_a_faulty_checkpoint_is_a_wrong_checkpoint(bench, monkeypatch, fault):
    patch = {"deleted": _deleted_before_the_preemption,
             "rewritten": _rewritten_after_the_preemption}.get(fault)
    if fault == "read_back_altered":
        resume = runner._resume

        def altered(*args):
            limbs = resume(*args).copy()
            limbs[0, 0, 0] ^= 1
            return limbs

        monkeypatch.setattr(runner, "_resume", altered)
    result = run(bench, steps=1 if fault == "deleted" else 2, preempt_after=1, patch=patch)
    assert not result["correct"]
    assert checks(result)["checkpoint_wrong"] >= 1
    assert checks(result)["value_wrong"] == 0


def test_control_is_not_correct(bench):
    result = run(bench, steps=1, control=True)
    assert not result["correct"], result["checks"]
    assert checks(result)["value_wrong"] >= 8


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def test_the_cells_metrics_read_what_they_name(bench):
    """Three steps of 1000 us: two computed chunks (encode 30 us, the
    pairing's kernel 400 us, the export's 5 us, digest 100 us and
    checkpoint 60 us, a pageable copy in encode and one in to_host), then a
    resumed chunk of 150 us. On the parent's trace (no ``stream.`` range)
    the range readers read nothing."""
    ev, corr = [], [0]

    def launch(ts, cat, name, dur):
        corr[0] += 1
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", ts, 2, correlation=corr[0]))
        ev.append(_x(cat, name, ts + 5, dur, tid=7, correlation=corr[0]))

    for base in (0, 1000):
        ev.append(_x("user_annotation", "bench.step", base, 1000))
        ev.append(_x("user_annotation", "stream.chunk", base + 10, 900))
        ev.append(_x("user_annotation", "stream.encode", base + 10, 30))
        ev.append(_x("user_annotation", "pairing.pairing", base + 40, 450))
        ev.append(_x("user_annotation", "stream.canonical", base + 490, 10))
        ev.append(_x("user_annotation", "stream.to_host", base + 500, 20))
        ev.append(_x("user_annotation", "stream.digest", base + 520, 100))
        ev.append(_x("user_annotation", "stream.checkpoint", base + 620, 60))
        launch(base + 20, "gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 2)
        launch(base + 50, "kernel", "void pt::k_miller_f(int const*)", 400)
        launch(base + 491, "kernel", "void pt::k_canonical(int const*)", 5)
        launch(base + 505, "gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 3)
    ev.append(_x("user_annotation", "bench.step", 2000, 1000))
    ev.append(_x("user_annotation", "stream.resume", 2010, 150))
    trace = Trace({"traceEvents": ev}, counters={"checkpoint_bytes_per_pair": 1008.04},
                  shapes={"products": 16384, "pairs": 1})
    b, root = bench
    names = [m["name"] for m in harness.plan(b, CELL, root)["per_layer"]]
    got = {n: harness.reader(root, "metrics", n)(trace) for n in names}
    assert got == {
        "encode_host_ms.stream": pytest.approx(0.03),
        "pairing_device_ms.stream": pytest.approx(0.4),
        "export_device_ms.stream": pytest.approx(0.005),
        "checkpoint_host_ms.stream": pytest.approx(0.16),
        "resume_host_ms.stream": pytest.approx(0.15),
        "host_syncs.stream": pytest.approx(4 / 3),
        "checkpoint_bytes_per_pair.stream": 1008.04,
        "device_idle_share.stream": pytest.approx(1 - 2 * 410 / 3000),
    }
    parent = Trace({"traceEvents": [e for e in ev if not e["name"].startswith("stream.")]})
    for n in ("encode_host_ms.stream", "pairing_device_ms.stream", "export_device_ms.stream",
              "checkpoint_host_ms.stream", "resume_host_ms.stream", "host_syncs.stream",
              "checkpoint_bytes_per_pair.stream"):
        assert harness.reader(root, "metrics", n)(parent) is None, n
