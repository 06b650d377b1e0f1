"""The harness finds every configuration, traffic mix, generator kind, cell
and metric by name, in files of its own: a cell, a mix of a new kind and a
per-layer metric added as new files and entries are picked up with no file
that was there edited. And ``BENCHMARK.json`` keeps to the benchmark's
contract."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from bench_gpu import harness
from bench_gpu.tracing import Trace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_every_cell_finds_its_files():
    bench = _bench()
    for cell in bench["workloads"]:
        p = harness.plan(bench, cell["name"])
        assert p["config"]["driver"] and p["traffic"]["generator"]
        names = {m["name"] for m in p["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert p["per_layer"], cell["name"]
        for m in p["end_to_end"]:
            assert callable(harness.reader(BENCH, "end_to_end", m["name"]))
        for m in p["per_layer"]:
            assert m["moves"] in names
            assert callable(harness.reader(BENCH, "metrics", m["name"]))


def test_a_new_cell_and_metric_need_no_edit(tmp_path):
    """In a copy of the benchmark's folder: a traffic file, a metric file and
    a cell entry added; the harness plans the new cell and reads the new
    metric, and no file that was there before has changed."""
    root = tmp_path / "bench_gpu"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root)
    traffic = json.loads((root / "traffic" / "closed_b2048.json").read_text())
    traffic.update(generator="groth16_sized", batch=4096, why="a new mix of a new kind")
    (root / "traffic" / "closed_b4096.json").write_text(json.dumps(traffic))
    (root / "generators" / "groth16_sized.py").write_text(
        '"""A throwaway kind of input generator."""\n\n\n'
        "def make(seed, batch, **_):\n    return ('groth16_proofs', seed, batch)\n")
    (root / "metrics" / "steps_traced.groth16.py").write_text(
        '"""Steps in the traced window: a throwaway metric."""\n\n\n'
        "def read(trace):\n    return trace.n_steps or None\n")
    bench = _bench()
    bench["workloads"].append({"name": "groth16.b4096", "config": "groth16_verify",
                               "traffic": "closed_b4096", "chips": 1, "why": "a new cell"})
    for m in bench["end_to_end"]:
        if "groth16.b2048" in m.get("workloads", []):
            m["workloads"].append("groth16.b4096")
    bench["per_layer"].append({"name": "steps_traced.groth16", "unit": "steps",
                               "better": "higher", "source": "program_span", "layer": "device",
                               "moves": "proofs_per_s", "workloads": ["groth16.b4096"]})
    p = harness.plan(bench, "groth16.b4096", root)
    assert p["traffic"]["batch"] == 4096
    assert harness.make_inputs(p["traffic"], 7, root) == ("groth16_proofs", 7, 4096)
    assert [m["name"] for m in p["per_layer"]] == ["steps_traced.groth16"]
    read = harness.reader(root, "metrics", "steps_traced.groth16")
    chrome = {"traceEvents": [{"ph": "X", "cat": "user_annotation", "name": "bench.step",
                               "ts": t, "dur": 5, "tid": 1} for t in (0, 10, 20)]}
    assert read(Trace(chrome)) == 3
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert sorted(map(str, set(after) - set(before))) == [
        "generators/groth16_sized.py", "metrics/steps_traced.groth16.py",
        "traffic/closed_b4096.json"]


def test_a_per_layer_metric_names_its_cells():
    bench = _bench()
    del bench["per_layer"][0]["workloads"]
    with pytest.raises(SystemExit, match="lists no workloads"):
        harness.plan(bench, bench["workloads"][0]["name"])


def test_benchmark_json_keeps_to_the_contract():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"][1] == "bench_gpu/run.py" and len(bench["command"]) <= 32
    assert all(not p.startswith("/") and ".." not in p for p in bench["paths"])
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) <= {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200
        assert c["file"].startswith("bench_gpu/") and (ROOT / c["file"]).is_file()
        assert c["reduced"] == json.loads((ROOT / c["file"]).read_text())["reduced"]
    cells = bench["workloads"]
    assert len({(c["config"], c["traffic"]) for c in cells}) == len(cells)
    assert sum(c["chips"] == 4 for c in cells) <= max(1, len(cells) // 4)
    for c in cells:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(c["name"]) and NAME.match(c["traffic"]) and c["config"] in configs
        assert c["chips"] in (1, 4) and 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert (BENCH / "traffic" / f"{c['traffic']}.json").is_file()
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200 and m["workloads"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in cells}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
