"""JAX's threefry2x32 stream on PyTorch tensors.

The reference draws its DP noise (``privacy/dp.py``) and the ``noise``
attack (``core/adversary.py``) from ``jax.random`` key chains.  This
module reproduces them as JAX 0.9.0 computes them with
``jax_threefry_partitionable=True`` (that release's default), on any
device:

- a key is an int64 tensor ``[..., 2]`` holding two uint32 words;
  :func:`key` is ``jax.random.PRNGKey`` for a seed in ``[0, 2**31)``
  (words ``(0, seed)``);
- ``fold_in(k, d)`` hashes the counter pair ``(0, d)`` under ``k``, and
  ``split(k, n)[i]`` hashes ``(0, i)``: under the partitionable flag the
  two are the same function, as in ``jax/_src/prng.py``
  (``_threefry_split_foldlike``, ``_threefry_fold_in``);
- ``bits(k, shape)`` hashes the 64-bit flat index of each element (its
  high and low words) and xors the two output words
  (``_threefry_random_bits_partitionable``);
- ``randint`` combines two such streams modulo the span, as
  ``jax.random.randint`` does for int32 (``_randint``);
- ``uniform`` puts 23 of those bits in a float's mantissa, subtracts 1,
  then multiplies by ``maxval - minval`` and adds ``minval``, each rounded
  on its own (``jax/_src/random.py`` ``_uniform``; XLA's CPU contracts the
  two into an FMA, which agrees wherever the span is a power of two, as
  on ``[0, 1)`` and the normal's interval; :func:`uniform_fma_from_bits`
  rounds the two once, as the traced generators' ranges need);
- ``normal`` is ``sqrt(2) * erf_inv(u)`` for ``u`` uniform on
  ``(nextafter(-1, 0), 1)``, with XLA's single-precision ``erf_inv``:
  Giles' polynomial in ``w = -log1p(-u*u)``, each Horner step rounded
  once to fp32 as a fused multiply-add rounds it.

The integer chain and the uniforms are bit-equal to ``jax.random``'s;
the normals differ from XLA's by a few ulp where its ``log1p`` and an
FMA contraction round otherwise (``tests/test_torch_prng.py`` holds them
within 4 ulp, most bit-equal).  Integer words live in int64 tensors
masked to 32 bits after every operation, exact on the CPU and on CUDA.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Words = Union[int, torch.Tensor]


def _rotl(x: Words, d: int) -> Words:
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k1: Words, k2: Words, x1: Words, x2: Words):
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key words ``(k1, k2)``, elementwise over broadcast int64
    tensors (or Python ints) holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for ``0 <= seed < 2**31``."""
    if not 0 <= int(seed) < 2 ** 31:
        raise ValueError(f"seed {seed} outside [0, 2**31)")
    return torch.tensor([0, int(seed)], dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(k, data)``; ``data`` an int or an int tensor
    that broadcasts against ``k[..., 0]``."""
    if isinstance(data, torch.Tensor):
        data = data.to(device=k.device, dtype=torch.int64) & MASK
    else:
        data = int(data) & MASK
    a, b = threefry2x32(k[..., 0], k[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(torch.as_tensor(a, device=k.device),
                                               torch.as_tensor(b, device=k.device)), -1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(k, num)`` of one key: ``[num, 2]``."""
    return fold_in(k, torch.arange(num, dtype=torch.int64, device=k.device))


def bits_at(k1: Words, k2: Words, counter: torch.Tensor) -> torch.Tensor:
    """32 random bits at each flat index ``counter`` (int64, below 2**32)
    under key words ``(k1, k2)`` that broadcast against it."""
    a, b = threefry2x32(k1, k2, 0, counter)
    return a ^ b


def _counter(shape: Sequence[int], device) -> torch.Tensor:
    return torch.arange(math.prod(shape), dtype=torch.int64, device=device).view(tuple(shape))


def bits(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(k, shape)`` (uint32 values in an int64 tensor)."""
    return bits_at(k[0], k[1], _counter(shape, k.device))


def randint(k: torch.Tensor, shape: Sequence[int], minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval, jnp.int32)`` (int64
    values), bit for bit, for Python int bounds in int32's range; for a
    batch of keys ``k`` [G, 2], each key's draw: [G, *shape].

    As ``jax/_src/random.py`` ``_randint``: two streams of 32 bits from
    ``split(k)``, combined modulo ``span = maxval - minval`` (1 where
    ``maxval <= minval``) as ``(hi % span) * m + lo % span``, ``m = (2**16 %
    span)**2 % span``, every operation in uint32 with its wrap-around (so
    ``m`` is 0 for a span past 2**16), then ``% span`` and ``+ minval``."""
    lo_b, hi_b = int(np.int32(minval)), int(np.int32(maxval))
    span = hi_b - lo_b if hi_b > lo_b else 1
    # split(k)[0] and [1]; for a batch of keys [G, 2], each key's at once
    k1, k2 = fold_in(k, 0), fold_in(k, 1)
    if k.dim() == 1:
        higher, lower = bits(k1, shape), bits(k2, shape)
    else:
        higher, lower = keys_bits(k1, shape), keys_bits(k2, shape)
    mult = ((((2 ** 16) % span) ** 2) & MASK) % span     # 0 for a span past 2**16
    offset = (((higher % span) * mult) & MASK) + lower % span
    return (offset & MASK) % span + lo_b


_ONE_BITS = int(np.array(1.0, np.float32).view(np.int32))


def uniform_from_bits(b: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """fp32 uniforms on ``[minval, maxval)`` from 32-bit words, as
    ``jax.random.uniform`` makes them: the top 23 bits as the mantissa of a
    float in ``[1, 2)``, minus 1, times ``maxval - minval`` (in fp32), plus
    ``minval``, each operation rounded on its own."""
    f = ((b >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    # fp32 constants as Python floats: an fp32 tensor meets them in fp32, and
    # no host-to-device copy keeps the draw capturable in a CUDA graph
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(f * span + lo, lo)


def uniform(k: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, jnp.float32, minval, maxval)``."""
    return uniform_from_bits(bits(k, shape), minval, maxval)


def keys_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``bits(k, shape)`` for each key of ``keys`` [G, 2] at once: [G, *shape]."""
    ones = (1,) * len(shape)
    return bits_at(keys[:, 0].reshape(-1, *ones), keys[:, 1].reshape(-1, *ones),
                   _counter(shape, keys.device))


def uniform_fma_from_bits(b: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """fp32 uniforms on ``[minval, maxval)`` as XLA compiles
    ``jax.random.uniform`` on the CPU: the multiply by the span and the
    add of ``minval`` contracted into one fused multiply-add, rounded once.
    The product and the sum are exact in float64 for spans and bounds
    within a few binades of each other (23-bit fractions times a 24-bit
    span), so the float64 result rounded to fp32 is the FMA's, on any
    device.  :func:`uniform_from_bits` rounds twice; the two agree where
    the span is a power of two."""
    f = ((b >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min((f.double() * span + lo).float(), lo)


# XLA's single-precision erf_inv (Giles 2010), highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's fp32 ``erf_inv``: ``w = -log1p(-x*x)``, a degree-8 polynomial
    in ``w - 2.5`` (``w < 5``) or ``sqrt(w) - 3``, times ``x``.  Each
    Horner step ``c + p * w`` is computed in float64 and rounded to fp32
    once, as a fused multiply-add rounds it (the product is exact in
    float64)."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()

    def coef(i: int, dtype) -> torch.Tensor:
        return torch.where(lt, torch.full_like(w, float(np.float32(_ERFINV_LT5[i])), dtype=dtype),
                           torch.full_like(w, float(np.float32(_ERFINV_GE5[i])), dtype=dtype))

    p = coef(0, torch.float32)
    for i in range(1, len(_ERFINV_LT5)):
        p = (p.double() * w + coef(i, torch.float64)).float()
    out = p * x
    return torch.where(x.abs() == 1.0, x * float("inf"), out)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal_from_bits(b: torch.Tensor) -> torch.Tensor:
    """Standard normals from 32-bit words, as ``jax.random.normal`` makes
    them (fp32)."""
    return erf_inv(uniform_from_bits(b, _NORMAL_LO, 1.0)) * _SQRT2


def normal(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal(k, shape, jnp.float32)``."""
    return normal_from_bits(bits(k, shape))
