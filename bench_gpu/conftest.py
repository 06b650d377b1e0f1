"""pytest settings of the benchmark's own tests (``python -m pytest bench_gpu``).

Registers the ``cuda`` marker as the repository's tests do: a test that
needs the card carries it and decides inside a fixture whether a card is
there. Imports nothing of JAX.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device and nvcc; skipped without one")
