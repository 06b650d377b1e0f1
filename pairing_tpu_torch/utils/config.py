"""Runtime configuration: the PyTorch counterpart of
``pairing_tpu/utils/config.py``.

The limb geometry is fixed in ``fields.fp``; this dataclass carries the
runtime choices. It has no backend switch: the port picks each kernel's
route by the device of its tensors (a CUDA tensor launches the hand-written
kernel, a CPU tensor takes its plain version), so ``device`` is the choice.
The mesh fields of the JAX package's config (``mesh_shape``, ``mesh_axes``)
come with the port's parallel layer over ``torch.distributed``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class PairingConfig:
    """Runtime configuration for batched pairing execution."""

    #: where the points are made and the pairing runs: "cuda" (the card,
    #: the default), "cuda:1", or "cpu" (the kernels' plain versions)
    device: str = "cuda"
    #: pairs a chunk when streaming huge batches through the device
    chunk_size: int = 8192
    #: optional directory for chunk checkpoints (resumable 1M+ runs)
    checkpoint_dir: Optional[str] = None
