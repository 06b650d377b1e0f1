"""On the card: the ``pairing.b16384`` cell's control (the easy part alone
in ``pairing``'s place), at the cell's own size, comes out not correct, and
a sound run of the same seed comes out correct; ``test_bench_cuda.py``'s
case for this cell.

Marked ``cuda``; skips without a CUDA device (decided in the fixture). Run
on the card with ``python -m pytest bench_gpu/test_bench_cuda_pairing.py -q``.
"""

import pytest

from bench_gpu.test_bench_cuda import _run, card  # noqa: F401  (card: the fixture)

pytestmark = pytest.mark.cuda


def test_control_fails_where_the_program_passes(card):  # noqa: F811
    seed = 2_718_281_828_459
    assert _run("pairing.b16384", seed, control=False)["correct"]
    result = _run("pairing.b16384", seed, control=True)
    assert not result["correct"], result["checks"]
    assert result["checks"]["value_wrong"]["value"] >= 16384
