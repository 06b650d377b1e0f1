"""The readers of the port's own ranges (``metrics/_spans.py`` and the
metrics that use it) on a small Chrome trace in the profiler's format: two
traced steps with nested program ranges, kernels and copies linked to their
launch calls by correlation id. Every number below is worked out by hand
from the events."""

import pytest

from bench_gpu import harness
from bench_gpu.tracing import Trace

BENCH = harness.BENCH_DIR
NEW = ("validate_device_ms.groth16", "validate_host_ms.groth16", "miller_glue_host_ms.groth16",
       "miller_glue_host_ms.witness", "host_syncs.groth16", "host_syncs.witness",
       "sync_wait_ms.groth16", "sync_wait_ms.witness", "stream_wait_ms.witness")


def _x(cat, name, ts, dur, tid=1, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if args:
        e["args"] = args
    return e


def _chrome(program_ranges=True, device_offset=0):
    """``device_offset`` moves every device timestamp, as a trace whose
    device clock sits off the host's."""
    ev = []
    corr = [0]

    def launch(api, ts, cat, name, at, dur, **args):
        corr[0] += 1
        ev.append(_x("cuda_runtime", api, ts, 2, correlation=corr[0]))
        ev.append(_x(cat, name, at + device_offset, dur, tid=7, correlation=corr[0], **args))

    def kernel(ts, at, dur):
        launch("cudaLaunchKernel", ts, "kernel", "void at::native::f<1>(int)", at, dur)

    def copy(ts, name, at, dur):
        launch("cudaMemcpyAsync", ts, "gpu_memcpy", name, at, dur, bytes=64)

    ranges = [  # (name, start, end) a step, in microseconds from its start
        ("validate.inputs", 20, 220),
        ("validate.g1_on_curve", 30, 60),
        ("validate.g2_subgroup", 100, 200),
        ("validate.g2_subgroup.ladder", 110, 150),
        ("validate.g2_subgroup.compare", 150, 200),
        ("validate.g1_on_curve", 250, 280),
        ("pairing.multi_pairing", 400, 800),
        ("miller_loop.N_normalize", 410, 500),
        ("miller_loop.N_normalize.points", 410, 440),
        ("miller_loop.N_normalize.prefix", 440, 450),
        ("miller_loop.N_normalize.inverse", 450, 480),
        ("miller_loop.N_normalize.running", 480, 500),
        ("miller_loop.C_lines", 500, 560),
        ("miller_loop.C_lines.lines", 500, 520),
        ("miller_loop.C_lines.epilogue", 520, 560),
        ("witness.stream.wait", 850, 870),
    ]
    for base in (0, 1000):
        ev.append(_x("user_annotation", "bench.step", base, 900))
        ev.append(_x("user_annotation", "bench.validate", base + 10, 300))
        if program_ranges:
            ev.extend(_x("user_annotation", n, base + a, b - a) for n, a, b in ranges)
        kernel(base + 120, base + 125, 20)  # in validate.g2_subgroup.ladder
        kernel(base + 160, base + 170, 5)  # in validate.g2_subgroup.compare
        kernel(base + 300, base + 305, 3)  # in bench.validate alone
        kernel(base + 415, base + 420, 10)  # in miller_loop.N_normalize.points
        # blocking copies inside program ranges, each in the host operation
        # that waits for it: waits 44 - 35 and 462 - 455 us
        ev.append(_x("cpu_op", "aten::to", base + 34, 10))
        copy(base + 35, "Memcpy HtoD (Pageable -> Device)", base + 40, 2)
        ev.append(_x("cpu_op", "aten::item", base + 454, 8))
        copy(base + 455, "Memcpy DtoH (Device -> Pageable)", base + 460, 1)
        # not counted: a pinned copy inside a range, a pageable one outside
        copy(base + 600, "Memcpy DtoH (Device -> Pinned)", base + 600, 100)
        copy(base + 330, "Memcpy HtoD (Pageable -> Device)", base + 335, 1)
    return {"traceEvents": ev}


def read(name, trace):
    return harness.reader(BENCH, "metrics", name)(trace)


@pytest.fixture
def trace():
    return Trace(_chrome())


def test_host_time_counts_nested_ranges_once(trace):
    # validate.*: [20, 220] and [250, 280] a step; the nested ranges add nothing
    assert read("validate_host_ms.groth16", trace) == pytest.approx(0.230)
    # points [410, 440], inverse [450, 480], epilogue [520, 560]
    for cell in ("groth16", "witness"):
        assert read(f"miller_glue_host_ms.{cell}", trace) == pytest.approx(0.100)
    assert read("stream_wait_ms.witness", trace) == pytest.approx(0.020)


def test_validation_device_time(trace):
    # the ladder's 20 us and the compare's 5 us; not the 3 us launched in
    # bench.validate outside the program's ranges
    assert read("validate_device_ms.groth16", trace) == pytest.approx(0.025)


def test_blocking_copies_inside_program_ranges(trace):
    for cell in ("groth16", "witness"):
        assert read(f"host_syncs.{cell}", trace) == 2
        assert read(f"sync_wait_ms.{cell}", trace) == pytest.approx((9 + 7) / 1e3)


def test_blocking_copies_read_the_host_clock_alone():
    """A device clock 45 us early puts the first step's first copy before
    the window on the device's clock: it still counts, by its launch, and
    its wait still ends where the host operation does."""
    trace = Trace(_chrome(device_offset=-45))
    assert len(trace.copies("Pageable")) == 5
    assert read("host_syncs.groth16", trace) == 2
    assert read("sync_wait_ms.groth16", trace) == pytest.approx((9 + 7) / 1e3)


def test_a_trace_without_the_ranges_reads_nothing():
    bare = Trace(_chrome(program_ranges=False))
    assert bare.n_steps == 2 and bare.copies()
    for name in NEW:
        assert read(name, bare) is None, name


def test_ranges_with_no_copy_read_zero_syncs():
    chrome = _chrome()
    chrome["traceEvents"] = [e for e in chrome["traceEvents"] if e["cat"] != "gpu_memcpy"]
    trace = Trace(chrome)
    assert read("host_syncs.groth16", trace) == 0
    assert read("sync_wait_ms.groth16", trace) == 0


def test_every_new_metric_is_in_the_benchmark():
    bench = harness.load_json(BENCH.parent / "BENCHMARK.json")
    names = [m["name"] for m in bench["per_layer"]]
    assert names[-len(NEW):] == list(NEW)
