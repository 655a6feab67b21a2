"""Public wrappers around the port's kernels, and what each one replaces.

Each wrapper dispatches by the device of the tensors it is given: the
plain PyTorch version for CPU tensors, the hand-written Hopper kernel for
CUDA tensors (or an error).  No capability check ever picks the plain
version on a card.
"""
from __future__ import annotations

from repro_torch.kernels.fedagg import dequant_install, fedagg, fedagg_dequant
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.quantize import (Int8Table, dequantize_int8,
                                          dequantize_int8_grouped, quantize_int8)
from repro_torch.kernels.robust import masked_median, trimmed_mean
from repro_torch.kernels.rwkv6_scan import rwkv6_scan

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
    # one kernel for both rules: the median is the trimmed mean at f = S
    "trimmed_mean": ("cuda", "src/repro_torch/csrc/trimmed_mean.cu",
                     "src/repro/kernels/robust.py:71, src/repro/kernels/robust.py:100"),
    "flash_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:79"),
    "rwkv6_scan": ("cuda", "src/repro_torch/csrc/rwkv6_scan.cu",
                   "src/repro/kernels/rwkv6_scan.py:51"),
    "mamba_scan": ("cuda", "src/repro_torch/csrc/mamba_scan.cu",
                   "src/repro/kernels/mamba_scan.py:47"),
}

__all__ = ["Int8Table", "KERNELS", "dequant_install", "dequantize_int8",
           "dequantize_int8_grouped", "fedagg",
           "fedagg_dequant", "flash_attention", "mamba_scan", "masked_median",
           "quantize_int8", "rwkv6_scan", "trimmed_mean"]
