"""Byzantine-robust coordinate-wise aggregation: the Hopper kernel's wrapper.

- ``trimmed_mean(stacked, active, f)``: over the active rows of an fp32
  ``[S, N]`` buffer (``active`` [S], ``> 0.5`` means active), drop the
  ``f`` smallest and ``f`` largest values of every column (``f`` clamps to
  ``(k - 1) // 2`` for ``k`` active rows, so something is always kept) and
  take the unweighted mean of the rest -> ``[N]`` fp32.
- ``masked_median(stacked, active)``: the trimmed mean at ``f = S``.

Both launch one CUDA kernel, ``csrc/trimmed_mean.cu``, which is bit-equal
to the plain version :func:`repro_torch.kernels.ref.trimmed_mean_ref`.
Dispatch is by the tensors' device and nothing else: CPU tensors take the
plain version, CUDA tensors launch the kernel or raise.  The kernel takes
fp32 buffers of at most :data:`MAX_SITES` sites; the plain version, any
number, as the reference does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import trimmed_mean_ref

NAME = "trimmed_mean"
MAX_SITES = 256                 # kMaxSites in csrc/trimmed_mean.cu
_P, _I = ctypes.c_void_p, ctypes.c_int64
_ARGS = [_P, _P, _P, _I, _I, _I, _P]


def _check(stacked: torch.Tensor, active: torch.Tensor, f: int) -> None:
    if stacked.dim() != 2 or stacked.dtype != torch.float32:
        raise TypeError(f"trimmed_mean: stacked must be float32 [S, N], "
                        f"got {stacked.dtype} {tuple(stacked.shape)}")
    if active.shape != (stacked.shape[0],):
        raise ValueError(f"trimmed_mean: active must be [{stacked.shape[0]}], "
                         f"got {tuple(active.shape)}")
    if active.device != stacked.device:
        raise ValueError(f"trimmed_mean: active on {active.device}, "
                         f"stacked on {stacked.device}")
    if f < 0:
        raise ValueError(f"trimmed_mean: f must be >= 0, got {f}")


def trimmed_mean_cuda(stacked: torch.Tensor, active: torch.Tensor, f: int) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream.  The kernel
    takes at most :data:`MAX_SITES` sites; the plain version any number."""
    _check(stacked, active, f)
    if stacked.shape[0] > MAX_SITES:
        raise ValueError(f"trimmed_mean_cuda: the kernel takes at most {MAX_SITES} "
                         f"sites, got {stacked.shape[0]}")
    act = active.float().contiguous()
    build.require_cuda("trimmed_mean_cuda", stacked, act)
    s, n = stacked.shape
    out = torch.empty((n,), dtype=torch.float32, device=stacked.device)
    if s == 0 or n == 0:
        return out.zero_()
    with torch.cuda.device(stacked.device):
        build.launch(NAME, "trimmed_mean_f32", _ARGS, stacked.data_ptr(),
                     act.data_ptr(), out.data_ptr(), s, n, min(f, s), build.stream())
    return out


def trimmed_mean(stacked: torch.Tensor, active: torch.Tensor, f: int) -> torch.Tensor:
    """[S, N] x [S] -> [N]: the plain version on CPU, the kernel on CUDA."""
    _check(stacked, active, f)
    return build.dispatch("trimmed_mean", stacked.device, trimmed_mean_ref,
                          trimmed_mean_cuda, stacked, active, f)


def masked_median(stacked: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median over the active rows: ``trimmed_mean`` at
    ``f = S`` (one kernel for both)."""
    return trimmed_mean(stacked, active, int(stacked.shape[0]))
