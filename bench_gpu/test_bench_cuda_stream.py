"""On the card: the ``stream.1m`` cell's control (the G2 list rotated by one
lane within each chunk), at the cell's own size, comes out not correct, and
a sound run of the same seed comes out correct; ``test_bench_cuda.py``'s
case for this cell.

Marked ``cuda``; skips without a CUDA device (decided in the fixture). Run
on the card with ``python -m pytest bench_gpu/test_bench_cuda_stream.py -q``.
"""

import pytest

from bench_gpu.test_bench_cuda import _run, card  # noqa: F401  (card: the fixture)

pytestmark = pytest.mark.cuda


def test_control_fails_where_the_program_passes(card):  # noqa: F811
    seed = 1_618_033_988_749
    assert _run("stream.1m", seed, control=False)["correct"]
    result = _run("stream.1m", seed, control=True)
    assert not result["correct"], result["checks"]
    assert result["checks"]["value_wrong"]["value"] >= 16384
