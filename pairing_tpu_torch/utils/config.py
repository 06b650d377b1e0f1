"""Runtime configuration: the PyTorch counterpart of
``pairing_tpu/utils/config.py``.

The limb geometry is fixed in ``fields.fp``; this dataclass carries the
runtime choices. It has no backend switch: the port picks each kernel's
route by the device of its tensors (a CUDA tensor launches the hand-written
kernel, a CPU tensor takes its plain version), so ``device`` is the choice.
``mesh_shape`` and ``mesh_axes`` have the reference's meaning over the
port's ``torch.distributed`` mesh (``parallel.mesh.make_mesh``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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
    #: mesh shape for data parallelism (the runner shards each chunk's
    #: batch axis over its first axis), e.g. (8,) or (2, 4) for dcn x data;
    #: needs an initialized process group of prod(mesh_shape) ranks
    mesh_shape: Optional[Tuple[int, ...]] = None
    #: mesh axis names matching mesh_shape; the first axis carries the batch
    mesh_axes: Tuple[str, ...] = ("data",)
