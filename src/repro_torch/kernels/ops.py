"""Public wrappers around the port's kernels, and what each one replaces.

Each wrapper dispatches by the device of the tensors it is given: the
plain PyTorch version for CPU tensors, the hand-written Hopper kernel for
CUDA tensors (or an error).  No capability check ever picks the plain
version on a card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba_scan as _mamba
from repro_torch.kernels import rwkv6_scan as _rwkv6
from repro_torch.kernels.fedagg import dequant_install, fedagg, fedagg_dequant
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_bwd
from repro_torch.kernels.quantize import (Int8Table, dequantize_int8,
                                          dequantize_int8_grouped, quantize_int8)
from repro_torch.kernels.robust import masked_median, trimmed_mean
from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_bwd

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
    # the gradient of row 7: the reference has no TPU kernel for it (XLA
    # differentiates its jnp attention, models/attention.py:155-166)
    "flash_attention_bwd": ("cuda", "src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/models/attention.py:155"),
    # row 7 and its gradient in bf16, on Hopper's warpgroup products: one
    # design a dtype, so the bf16 instances are kernels of their own
    "flash_attention_bf16": ("cuda", "src/repro_torch/csrc/flash_attention_bf16.cu",
                             "src/repro/kernels/flash_attention.py:79"),
    "flash_attention_bwd_bf16": ("cuda", "src/repro_torch/csrc/flash_attention_bwd_bf16.cu",
                                 "src/repro/models/attention.py:155"),
    "rwkv6_scan": ("cuda", "src/repro_torch/csrc/rwkv6_scan.cu",
                   "src/repro/kernels/rwkv6_scan.py:51"),
    "mamba_scan": ("cuda", "src/repro_torch/csrc/mamba_scan.cu",
                   "src/repro/kernels/mamba_scan.py:47"),
    # the gradients of rows 8 and 9: the reference has no TPU kernel for
    # them (XLA differentiates its jnp scans)
    "rwkv6_scan_bwd": ("cuda", "src/repro_torch/csrc/rwkv6_scan_bwd.cu",
                       "src/repro/models/rwkv6.py:105"),
    "mamba_scan_bwd": ("cuda", "src/repro_torch/csrc/mamba_scan_bwd.cu",
                       "src/repro/models/mamba.py:86"),
}

# the ``__global__`` functions of a kernel whose symbols are not the one
# ``<name>_kernel``: the quantizer's vectorised and any-width kernels, the
# attention backwards' delta, dK/dV, head-sum and dQ kernels, the selective scan's walk back
# and its sum of the blocks' partials
_SYMBOLS = {"quantize_int8": r"quantize_int8_(?:vec|any)",
            "flash_attention_bwd": r"flash_attention_bwd_(?:delta|dkdv|sum|dq)_kernel",
            "flash_attention_bwd_bf16": r"flash_attention_bwd_bf16_(?:delta|dkdv|sum|dq)_kernel",
            "mamba_scan_bwd": r"mamba_scan_bwd_(?:reduce_)?kernel"}


def symbol_pattern(name: str) -> str:
    """A regex matching the device symbols of kernel ``name`` (a key of
    ``KERNELS``) in a profiler trace."""
    return rf"\b{_SYMBOLS.get(name, name + '_kernel')}\b"


# the kernels a federated job can launch (a job builds and loads them before
# its first round: ``build.prepare``)
FL_KERNELS = ("fedagg", "quantize_int8", "dequantize_int8", "fedagg_dequant",
              "dequant_install", "trimmed_mean")


# the token models' kernels and their gradients
TOKEN_KERNELS = ("flash_attention", "flash_attention_bwd", "flash_attention_bf16",
                 "flash_attention_bwd_bf16", "rwkv6_scan", "rwkv6_scan_bwd", "mamba_scan",
                 "mamba_scan_bwd")


def job_kernels(kind: str) -> tuple:
    """The kernels a federated job of task ``kind`` can launch: a token
    job's models add the three token kernels and their backwards."""
    return FL_KERNELS + (TOKEN_KERNELS if kind == "tokens" else ())


def check_backward_instances(cfg, dtype: torch.dtype = torch.float32) -> None:
    """Raise :class:`~repro_torch.NotPorted`, naming the backward kernel's
    seam, where training the token model ``cfg`` on the card needs a
    backward instance the port lacks: attention at the model's head dim in
    ``dtype`` (the weights'; MLA at its own q/k and v head dims where the
    dtype has that instance, else at the one its prefill is padded to,
    ``padded_head_dim`` of its wider head dim: ``resolved_head_dim`` is
    its v head dim),
    the WKV-6 scan at its head dim and the selective scan at its
    ``d_state`` (both in fp32: their modules cast their inputs).  Reads
    the config only; no card is needed."""
    mixers = {spec.mixer for spec in cfg.layer_specs()}
    if "attn" in mixers:
        _fa.check_bwd_instance(dtype, cfg.resolved_head_dim)
    if "mla" in mixers:
        dqk, dv = cfg.mla.qk_head_dim, cfg.mla.v_head_dim
        if _fa.native_instance(dtype, dqk, dv):
            _fa.check_bwd_instance(dtype, dqk, dv)
        else:
            _fa.check_bwd_instance(dtype, _fa.padded_head_dim(max(dqk, dv)))
    if "rwkv6" in mixers:
        _rwkv6.check_bwd_instance(torch.float32, cfg.rwkv.head_dim)
    if "mamba" in mixers:
        _mamba.check_bwd_instance(torch.float32, cfg.mamba.d_state)


__all__ = ["FL_KERNELS", "Int8Table", "KERNELS", "TOKEN_KERNELS", "check_backward_instances",
           "dequant_install", "dequantize_int8", "dequantize_int8_grouped", "fedagg",
           "fedagg_dequant", "flash_attention", "flash_attention_bwd", "mamba_scan",
           "mamba_scan_bwd", "job_kernels", "masked_median", "quantize_int8", "rwkv6_scan",
           "rwkv6_scan_bwd", "symbol_pattern", "trimmed_mean"]
