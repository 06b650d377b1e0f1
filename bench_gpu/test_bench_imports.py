"""The import guard: no module that a run loads has the top-level name of
JAX or of the JAX package (compared as whole names: the port's name,
``pairing_tpu_torch``, begins with ``pairing_tpu``), and the plain reference
loads nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

LOAD_ALL = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from pathlib import Path
from bench_gpu import harness
bench = json.loads((Path(sys.argv[1]) / "BENCHMARK.json").read_text())
for cell in bench["workloads"]:
    p = harness.plan(bench, cell["name"])
    __import__(f"bench_gpu.drivers.{p['config']['driver']}")
    for m in p["end_to_end"]:
        harness.reader(harness.BENCH_DIR, "end_to_end", m["name"])
    for m in p["per_layer"]:
        harness.reader(harness.BENCH_DIR, "metrics", m["name"])
import bench_gpu.tracing, bench_gpu.generate
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = _loaded(LOAD_ALL)
    assert "pairing_tpu_torch" in loaded  # the port is what runs
    assert not loaded & {"jax", "jaxlib", "flax", "pairing_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import bench_gpu.reference.groth16, bench_gpu.reference.witness, bench_gpu.generate, "
            "bench_gpu.generators.groth16_proofs, bench_gpu.generators.pairs; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    loaded = _loaded(code)
    assert not loaded & {"pairing_tpu_torch", "pairing_tpu", "jax"}
    for path in ([BENCH / "generate.py"] + list((BENCH / "reference").glob("*.py"))
                 + list((BENCH / "generators").glob("*.py"))):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            assert not any(n.split(".")[0].startswith("pairing_tpu") for n in names), path


def test_the_guard_compares_whole_names():
    code = ("import json, sys, types; sys.path.insert(0, sys.argv[1]); "
            "from bench_gpu import harness; import pairing_tpu_torch; "
            "first = harness.forbidden_modules(); "
            "sys.modules['pairing_tpu.fields'] = types.ModuleType('pairing_tpu.fields'); "
            "print(json.dumps([first, harness.forbidden_modules()]))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=300, check=True)
    first, after = json.loads(out.stdout.strip().splitlines()[-1])
    assert first == [] and after == ["pairing_tpu"]
