"""The benchmark's one run: a cell of ``BENCHMARK.json`` from set-up to the
result line.

Everything about a cell is found by name, in files of its own:

  BENCHMARK.json                  the cell: its configuration and traffic mix
  configs/<config>.json           the deployment: its source, sizes,
                                  guarantees, the driver that runs it and the
                                  limits of its comparison
  traffic/<traffic>.json          the mix: the kind of its generator and
                                  that kind's parameters (pool, batch,
                                  chunk, bad inputs)
  generators/<kind>.py            the inputs of a mix's kind from the seed
  drivers/<driver>.py             the timed entry and its comparison with the
                                  plain reference under ``reference/``
  end_to_end/<metric>.py          an end-to-end metric from the window's steps
  metrics/<metric>.py             a per-layer metric from the traced window

A run: set-up (inputs from the seed, the port's kernels from the checkout's
build cache, warm-up of the cell's own shapes), then ``--seconds`` of steps
back to back (a step is one verify call or one hand-over of the witness
stream, each ending with its results on the host), then the comparison,
then one JSON line. With ``--trace 1`` the steps run under
``torch.profiler`` instead (a fixed number of them, after a few untraced
ones) and the line carries the per-layer metrics.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Tuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "pairing_tpu")


@dataclasses.dataclass
class Window:
    """The measured window: (start, end, units) of each step, host clock."""

    steps: List[Tuple[float, float, int]]
    setup_s: float

    @property
    def seconds(self) -> float:
        return self.steps[-1][1] - self.steps[0][0] if self.steps else 0.0

    @property
    def units(self) -> int:
        return sum(n for _, _, n in self.steps)


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"bench_gpu: no workload {name!r} in BENCHMARK.json")


def applies(entry: dict, cell: str) -> bool:
    """A metric entry of BENCHMARK.json applies to ``cell``: named in its
    ``workloads``; an end-to-end entry without that key applies to every
    cell."""
    return cell in entry.get("workloads", (cell,))


def plan(bench: dict, name: str, root: Path = BENCH_DIR) -> dict:
    """What a run of cell ``name`` reads: its configuration, its traffic mix,
    and the end-to-end and per-layer metrics it reports. Every per-layer
    entry names its cells."""
    cell = cell_of(bench, name)
    for m in bench["per_layer"]:
        if "workloads" not in m:
            raise SystemExit(f"bench_gpu: per-layer metric {m['name']!r} lists no workloads")
    return {
        "cell": cell,
        "config": load_json(root / "configs" / f"{cell['config']}.json"),
        "traffic": load_json(root / "traffic" / f"{cell['traffic']}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m, name)],
        "per_layer": [m for m in bench["per_layer"] if applies(m, name)],
    }


def load(root: Path, kind: str, name: str):
    """The module ``<root>/<kind>/<name>.py``, found by its name."""
    path = Path(root) / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_gpu.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # dataclasses look their module up there
    spec.loader.exec_module(module)
    return module


def make_inputs(traffic: dict, seed: int, root: Path = BENCH_DIR):
    """The inputs that the traffic file ``traffic`` describes, from ``seed``:
    ``make`` of ``<root>/generators/<kind>.py``, the kind named by its
    ``"generator"`` key, with the file's other keys as parameters."""
    params = {k: v for k, v in traffic.items() if k != "generator"}
    return load(root, "generators", traffic["generator"]).make(seed, **params)


def reader(root: Path, kind: str, name: str) -> Callable:
    """``read`` of the metric file ``<root>/<kind>/<name>.py``."""
    return load(root, kind, name).read


def forbidden_modules() -> List[str]:
    """Modules of JAX or the JAX package loaded in this process, by their
    whole top-level name (``pairing_tpu_torch`` is not ``pairing_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, control: bool = False, root: Path = BENCH_DIR) -> dict:
    """One run of cell ``name`` on ``device``; returns the result line's
    object. ``control`` runs the comparison's control in the program's
    place (see each driver)."""
    import torch

    p = plan(bench, name, root)
    driver = load(root, "drivers", p["config"]["driver"])
    drv = driver.Driver(p["config"], p["traffic"], seed, device, control=control)
    drv.setup(make_inputs(p["traffic"], seed, root), seconds)
    setup_s = time.perf_counter() - t_start
    cuda = torch.device(device).type == "cuda"

    drv.start()
    view = _traced(drv, p["traffic"], cuda) if trace else None
    window = None if trace else Window(_steps(drv, seconds), setup_s)
    drv.stop()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    drv.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    verdict = drv.check()
    checks = verdict["checks"]

    if trace:
        metrics = {}
        for m in p["per_layer"]:
            value = reader(root, "metrics", m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": reader(root, "end_to_end", m["name"])(window),
                               "unit": m["unit"]} for m in p["end_to_end"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if trace:
        dev.update(busy_s=view.busy_s, window_s=view.window_s)
    result = {"correct": all(v <= lim for _, v, lim in checks),
              "attempted": verdict["attempted"], "failed": verdict["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = view.breakdown()
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result


def _steps(drv, seconds: float) -> List[Tuple[float, float, int]]:
    """Steps back to back until ``seconds`` have passed since the first
    began (or the driver has nothing left)."""
    steps = []
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        n = drv.step()
        b = time.perf_counter()
        if n == 0:
            break
        steps.append((a, b, n))
        if b - t0 >= seconds:
            break
    return steps


def _traced(drv, traffic: dict, cuda: bool):
    """``trace_warm_steps`` untraced steps, then ``trace_steps`` under the
    profiler, each inside a ``bench.step`` span; the Chrome trace reduced."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .tracing import STEP, Trace

    drv.traced = True
    for _ in range(int(traffic["trace_warm_steps"])):
        drv.step()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        for _ in range(int(traffic["trace_steps"])):
            with record_function(STEP):
                drv.step()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        chrome = load_json(Path(path))
    return Trace(chrome, counters=drv.counters, shapes=drv.shapes)


def main(argv: List[str], t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="bench_gpu/run.py", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="put the comparison's control in the program's place (not a "
                         "benchmark run: it must come out not correct)")
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = cell_of(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"bench_gpu: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                      t_start, control=args.control)
    bad = forbidden_modules()
    if bad:
        print(f"bench_gpu: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    for n, c in result["checks"].items():
        print(f"check {n} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
