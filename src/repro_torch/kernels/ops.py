"""Public wrappers around the port's kernels, and what each one replaces.

Each wrapper dispatches by the device of the tensors it is given: the
plain PyTorch version for CPU tensors, the hand-written Hopper kernel for
CUDA tensors (or an error).  No capability check ever picks the plain
version on a card.
"""
from __future__ import annotations

from repro_torch.kernels.fedagg import fedagg

# name -> (route, source in the repo, the TPU kernel it replaces)
KERNELS = {
    "fedagg": ("cuda", "src/repro_torch/csrc/fedagg.cu",
               "src/repro/kernels/fedagg.py:149"),
}

__all__ = ["KERNELS", "fedagg"]
