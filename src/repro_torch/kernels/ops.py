"""Public wrappers around the port's kernels, and what each one replaces.

Each wrapper dispatches by the device of the tensors it is given: the
plain PyTorch version for CPU tensors, the hand-written Hopper kernel for
CUDA tensors (or an error).  No capability check ever picks the plain
version on a card.
"""
from __future__ import annotations

from repro_torch.kernels.fedagg import dequant_install, fedagg, fedagg_dequant
from repro_torch.kernels.quantize import dequantize_int8, quantize_int8

# name -> (route, source in the repo, the TPU kernel it replaces: its def line)
KERNELS = {
    "fedagg": ("cuda", "src/repro_torch/csrc/fedagg.cu",
               "src/repro/kernels/fedagg.py:150"),
    "quantize_int8": ("cuda", "src/repro_torch/csrc/quantize_int8.cu",
                      "src/repro/kernels/quantize.py:76"),
    "dequantize_int8": ("cuda", "src/repro_torch/csrc/dequantize_int8.cu",
                        "src/repro/kernels/quantize.py:107"),
    "fedagg_dequant": ("cuda", "src/repro_torch/csrc/fedagg_dequant.cu",
                       "src/repro/kernels/fedagg.py:50"),
    "dequant_install": ("cuda", "src/repro_torch/csrc/dequant_install.cu",
                        "src/repro/kernels/fedagg.py:109"),
}

__all__ = ["KERNELS", "dequant_install", "dequantize_int8", "fedagg",
           "fedagg_dequant", "quantize_int8"]
