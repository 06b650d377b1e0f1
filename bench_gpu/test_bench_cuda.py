"""On the card: each cell's control, at the cell's own size, comes out not
correct, and a sound run of the same seed comes out correct.

Marked ``cuda``; every test skips without a CUDA device (decided in the
fixture). Run on the card with ``python -m pytest bench_gpu/test_bench_cuda.py -q``.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CELLS = ("groth16.b16384", "witness.stream16384", "groth16.b2048")

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _run(cell, seed, control):
    cmd = [sys.executable, "bench_gpu/run.py", "--workload", cell, "--seed", str(seed),
           "--seconds", "2", "--trace", "0"] + (["--control"] if control else [])
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(card, cell):
    seed = 3_141_592_653_589
    assert _run(cell, seed, control=False)["correct"]
    result = _run(cell, seed, control=True)
    assert not result["correct"], result["checks"]
