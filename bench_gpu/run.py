#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``pairing_tpu_torch``).

    python3 bench_gpu/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit. Prints one JSON line (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``; with ``--trace 1`` ``breakdown`` too; last the
``checks`` compared, each with its limit) and exits 0; exits non-zero and
prints no result without a CUDA device, or if the run loaded JAX or the JAX
package. See ``bench_gpu/README.md``.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here, before any import

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# import bench_gpu and the port from this checkout, never the script's folder alone
sys.path[0] = str(ROOT)
# every kernel and build cache inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "bench_gpu" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "bench_gpu" / "triton")

from bench_gpu.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
