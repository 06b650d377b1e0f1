"""The per-layer metric readers on a small Chrome trace in the profiler's
format: two traced steps with the port's ranges, the benchmark's spans,
launch calls linked to their kernels by correlation id, a copy and host
operations. Every number below is worked out by hand from the events."""

import pytest

from bench_gpu import harness
from bench_gpu.roofline import least_seconds, miller_f_multi, pow_ladder_stream
from bench_gpu.tracing import Trace, kernel_name

BENCH = harness.BENCH_DIR


def _x(cat, name, ts, dur, tid=1, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if args:
        e["args"] = args
    return e


def _chrome():
    ev = []
    corr = [0]

    def launch(ts, kernel, at, dur):
        corr[0] += 1
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", ts, 2, correlation=corr[0]))
        ev.append(_x("kernel", kernel, at, dur, tid=7, correlation=corr[0]))

    for base in (0, 1000):  # two steps of 1000 us, the second starting at 1000
        ev.append(_x("user_annotation", "bench.step", base, 900))
        ev.append(_x("user_annotation", "bench.validate", base + 10, 100))
        ev.append(_x("user_annotation", "bench.multi_pairing", base + 200, 500))
        ev.append(_x("user_annotation", "miller_loop.D_miller_f", base + 210, 100))
        ev.append(_x("user_annotation", "final_exp.pow_x_ladders", base + 400, 100))
        ev.append(_x("gpu_user_annotation", "miller_loop.D_miller_f", base + 215, 400, tid=7))
        ev.append(_x("cpu_op", "aten::index_add_", base + 20, 30))
        launch(base + 25, "void at::native::index_kernel<int>(int*)", base + 30, 20)
        launch(base + 220, "pt::k_miller_f(int const*, int const*)", base + 230, 300)
        launch(base + 410, "pt::k_pow_ladder_stream(int const*)", base + 530, 50)
        launch(base + 420, "pt::k_pow_ladder_stream(int const*)", base + 580, 50)
        ev.append(_x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", base + 650, 100, tid=8,
                     bytes=4_000_000))
    return {"traceEvents": ev}


@pytest.fixture
def trace():
    return Trace(_chrome(), counters={"host_bytes_per_lane": 354312.5},
                 shapes={"products": 2, "pairs": 4, "lanes": 2})


def read(name, trace):
    return harness.reader(BENCH, "metrics", name)(trace)


def test_window_busy_and_idle(trace):
    assert trace.n_steps == 2 and trace.window == (0.0, 1900.0)
    # busy a step: [30, 50] + [230, 530] + [530, 630] + [650, 750] = 20 + 300 + 100 + 100
    assert trace.busy_s == pytest.approx(2 * 520e-6)
    assert read("device_idle_share.groth16", trace) == pytest.approx(1 - 1040 / 1900)
    assert read("device_idle_share.witness", trace) == pytest.approx(1 - 1040 / 1900)


def test_layer_times_and_counts(trace):
    assert read("validate_ms.groth16", trace) == pytest.approx(0.1)
    assert read("miller_loop_device_ms.groth16", trace) == pytest.approx(0.3)
    assert read("final_exp_device_ms.groth16", trace) == pytest.approx(0.1)
    assert read("glue_kernels.groth16", trace) == 1
    assert read("miller_loop_device_ms.witness", trace) == pytest.approx(0.3)
    assert read("exp_ladders_device_ms.witness", trace) is None  # no such range here
    assert read("host_bytes_per_lane.witness", trace) == 354312.5
    assert read("copy_gbps.witness", trace) == pytest.approx(8e6 / 200e-6 / 1e9)


def test_roofline_shares(trace):
    least = least_seconds(miller_f_multi.work(2, 4), miller_f_multi.n_bytes(2, 4))
    assert read("miller_f_multi_roofline", trace) == pytest.approx(100 * least / 300e-6)
    least = least_seconds(pow_ladder_stream.work(2), pow_ladder_stream.n_bytes(2))
    assert read("pow_ladder_stream_roofline", trace) == pytest.approx(100 * least / 50e-6)
    assert read("exp_bits_roofline", trace) is None  # K12 did not run


def test_nothing_to_read_gives_nothing():
    empty = Trace({"traceEvents": []})
    for m in harness.load_json(BENCH.parent / "BENCHMARK.json")["per_layer"]:
        assert read(m["name"], empty) is None, m["name"]


def test_breakdown(trace):
    b = trace.breakdown()
    ops = dict(b["device_ops"])
    assert ops["k_miller_f"] == pytest.approx(600e-6)
    assert ops["k_pow_ladder_stream"] == pytest.approx(200e-6)
    assert ops["at::native::index_kernel"] == pytest.approx(40e-6)
    gaps = dict(b["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(1900e-6 - 1040e-6)
    # a gap is labelled at its start: [50, 230] of each step begins as index_add_
    # ends, inside the validation span
    assert gaps["bench.validate | aten::index_add_"] == pytest.approx(2 * 180e-6)
    assert gaps["outside ranges | python"] == pytest.approx(30e-6 + 280e-6 + 150e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert kernel_name("void pt::k_trajectory<true>(int const*, int)") == "k_trajectory"
    assert kernel_name("void at::native::f<1>(int)") == "at::native::f"


# -- a recorded trace --------------------------------------------------------


@pytest.fixture(scope="module")
def recorded():
    """Part of one traced verify step of 16 proofs on an H100 (see the
    file's ``recorded`` note): the final exponentiation's ranges, its
    kernels and their launch calls, in the profiler's own format."""
    import gzip
    import json

    chrome = json.loads(gzip.open(BENCH / "testdata" / "groth16_step16.json.gz", "rt").read())
    return chrome, Trace(chrome, shapes=chrome["shapes"])


def test_recorded_trace_reads_as_counted_by_hand(recorded):
    chrome, trace = recorded
    ev = chrome["traceEvents"]
    launch = {e["args"]["correlation"]: e["ts"] for e in ev if e["cat"] == "cuda_runtime"}
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in ev
             if e["cat"] == "user_annotation" and e["name"].startswith("final_exp.")]
    kernels = [e for e in ev if e["cat"] == "kernel"]
    in_fe = [k for k in kernels
             if any(a <= launch.get(k["args"]["correlation"], -1) <= b for a, b in spans)]
    assert len(in_fe) > 30  # the easy part, three ladders of D with their tables, the chain
    assert read("final_exp_device_ms.groth16", trace) == pytest.approx(
        sum(k["dur"] for k in in_fe) / 1e3)
    ladders = [k["dur"] for k in kernels if k["name"].startswith("pt::k_pow_ladder_stream")]
    assert len(ladders) == 3
    least = least_seconds(pow_ladder_stream.work(16), pow_ladder_stream.n_bytes(16))
    share = read("pow_ladder_stream_roofline", trace)
    assert share == pytest.approx(100 * least / (sum(ladders) / 3 / 1e6))
    assert 0 < share < 100
    assert read("glue_kernels.groth16", trace) == sum(
        not k["name"].startswith("pt::k_") for k in kernels)
    assert read("miller_f_multi_roofline", trace) is None  # C is outside the record
    # busy time: the union of the device intervals, worked out point by point
    t0, t1 = trace.window
    cover = set()
    for e in ev:
        if e["cat"] in ("kernel", "gpu_memcpy", "gpu_memset"):
            cover.update(range(int(max(e["ts"], t0) * 10), int(min(e["ts"] + e["dur"], t1) * 10)))
    assert trace.busy_s == pytest.approx(len(cover) / 1e7, rel=1e-3)
