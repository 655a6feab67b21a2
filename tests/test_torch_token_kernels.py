"""The token models' three kernels against the JAX reference: the port's
``flash_attention``, ``rwkv6_scan`` and ``mamba_scan`` on CPU tensors
(their plain versions) against the reference's Pallas kernels under the
interpreter (``repro.kernels.ops.* (interpret=True)``, as the reference's
own tests run them) and against its jnp oracles (``repro.kernels.ref``).
The CUDA kernels are held to the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Shapes on the JAX side divide the Pallas block sizes (a block is the
whole axis when the axis is shorter than 128); on the port's side the
scans' L is not a multiple of the reference's chunk, and attention has
``Lq < Lk``, GQA groups 1 to 4, windows, ``causal=False``, D 32 and 64.

Tolerances: fp32 ``rtol=atol=1e-5`` (the same fp32 arithmetic, sums in
another order: blockwise online softmax against one softmax); bf16
``2e-2`` (one bf16 rounding of the output).  The scans' final states,
which the reference's Pallas kernels do not return, are held to its
oracles only.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan_cuda  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda  # noqa: E402

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _same_values(x: np.ndarray, dtype: str):
    """(JAX array, torch tensor) holding the same values in ``dtype``."""
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    return jx, tx


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# (b, hq, hkv, lq, lk, d, causal, window)
FLASH_CASES = [
    (1, 2, 2, 16, 16, 32, True, None),       # group 1
    (2, 4, 2, 24, 24, 64, True, None),       # group 2
    (1, 6, 2, 20, 20, 32, True, 7),          # group 3 (smollm's 9/3), a window
    (1, 4, 1, 16, 48, 64, True, None),       # group 4 (gemma3), Lq < Lk
    (2, 3, 1, 8, 40, 32, True, 11),          # Lq < Lk with a window
    (1, 2, 1, 32, 32, 64, False, None),      # not causal
    (1, 4, 2, 16, 32, 32, False, 9),         # a window without the causal mask
    (1, 2, 1, 128, 128, 32, True, 16),       # a whole block of 128
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_reference_kernel_and_oracle(case, dtype):
    b, hq, hkv, lq, lk, d, causal, window = case
    rng = np.random.default_rng(hq * 131 + lq * 7 + lk + d)
    (jq, tq), (jk, tk), (jv, tv) = (_same_values(rng.normal(size=s).astype(np.float32), dtype)
                                    for s in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d)))
    before = dict(build.LAUNCHES)
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert build.LAUNCHES == before             # CPU tensors: the plain version
    assert out.dtype == tq.dtype and out.shape == (b, hq, lq, d)
    got = out.float().numpy()
    kern = jops.flash_attention(jq, jk, jv, causal=causal, window=window, interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(got, _f32(kern), **TOL[dtype])
    np.testing.assert_allclose(got, _f32(oracle), **TOL[dtype])


def _rwkv_inputs(b, h, l, d, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, h, l, d)).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(rng.normal(-2.0, 1.0, size=(b, h, l, d)))).astype(np.float32)
    u = (rng.normal(size=(h, d)) * 0.1).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("b,h,l,d", [(1, 2, 13, 32), (2, 4, 37, 64), (1, 1, 1, 32),
                                     (2, 2, 130, 32)])
def test_rwkv6_scan_matches_reference_kernel_and_oracle(b, h, l, d):
    xs = _rwkv_inputs(b, h, l, d, seed=l * 3 + d)
    out, state = ops.rwkv6_scan(*map(torch.from_numpy, xs))
    assert out.shape == (b, h, l, d) and state.shape == (b, h, d, d)
    assert state.dtype == torch.float32
    j_out, j_state = jref.rwkv6_scan_ref(*map(jnp.asarray, xs))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL["float32"])
    np.testing.assert_allclose(state.numpy(), np.asarray(j_state), **TOL["float32"])
    if l <= 128:                  # the Pallas kernel's chunk must divide L
        kern = jops.rwkv6_scan(*map(jnp.asarray, xs), interpret=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(kern), **TOL["float32"])


def _mamba_inputs(b, l, di, ds, seed):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.normal(-3.0, 1.0, size=(b, l, di)))).astype(np.float32)
    bm, cm = (rng.normal(size=(b, l, ds)).astype(np.float32) for _ in range(2))
    x = rng.normal(size=(b, l, di)).astype(np.float32)
    log_a = np.log(np.broadcast_to(np.arange(1, ds + 1, dtype=np.float32), (di, ds))).copy()
    log_a += rng.normal(0, 0.1, size=(di, ds)).astype(np.float32)
    return dt, bm, cm, x, log_a


@pytest.mark.parametrize("b,l,di,ds", [(1, 13, 24, 8), (2, 37, 130, 16), (1, 1, 5, 4),
                                       (2, 130, 64, 8)])
def test_mamba_scan_matches_reference_kernel_and_oracle(b, l, di, ds):
    xs = _mamba_inputs(b, l, di, ds, seed=l + di + ds)
    y, state = ops.mamba_scan(*map(torch.from_numpy, xs))
    assert y.shape == (b, l, di) and state.shape == (b, di, ds)
    j_y, j_state = jref.mamba_scan_ref(*map(jnp.asarray, xs))
    np.testing.assert_allclose(y.numpy(), np.asarray(j_y), **TOL["float32"])
    np.testing.assert_allclose(state.numpy(), np.asarray(j_state), **TOL["float32"])
    if l <= 128:                  # the Pallas kernel's chunk must divide L
        kern = jops.mamba_scan(*map(jnp.asarray, xs), interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(kern), **TOL["float32"])


def test_token_kernels_raise_on_what_they_do_not_take():
    q = torch.zeros(1, 4, 8, 32)
    kv = torch.zeros(1, 3, 8, 32)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, kv, kv)                       # 4 q heads on 3 kv heads
    with pytest.raises(ValueError, match="Lq"):
        ops.flash_attention(torch.zeros(1, 2, 9, 32), torch.zeros(1, 1, 8, 32),
                            torch.zeros(1, 1, 8, 32))
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q, q, window=0)
    r = torch.zeros(1, 2, 5, 32)
    with pytest.raises(ValueError, match="u must be"):
        ops.rwkv6_scan(r, r, r, r, torch.zeros(3, 32))
    with pytest.raises(TypeError):
        ops.mamba_scan(*(t.double() for t in map(torch.from_numpy,
                                                 _mamba_inputs(1, 3, 4, 4, 0))))
    # the CUDA entry points refuse CPU tensors: there is no CPU mode
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_scan_cuda(r, r, r, r, torch.zeros(2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan_cuda(*map(torch.from_numpy, _mamba_inputs(1, 3, 4, 4, 0)))
    # flash_attention and rwkv6_scan copy their inputs 16 bytes at a time
    build.require_aligned("x", q, kv)
    with pytest.raises(ValueError, match="16-byte"):
        build.require_aligned("x", q, torch.zeros(33)[1:])
