"""A CPU rehearsal of the fp32 flash-attention kernel's arithmetic.

``csrc/flash_attention.cu`` runs its fp32 instance on the tensor cores as
three TF32 products: every fp32 operand x is split into ``hi`` (x rounded
to TF32, to nearest with ties away from zero, as ``cvt.rna.tf32.f32``
does: add 0x1000 to the bits and clear the low 13) and ``lo`` (x - hi,
whose low 13 bits the tensor cores do not read), and each product is
``hi*lo + lo*hi + hi*hi``.  This test does that arithmetic in plain torch,
in the kernel's order (blocks of ``BLOCK_ROWS`` packed (query, head) rows,
key tiles of ``BLOCK_KEYS`` from the block's first visible key, each tile
split between two key halves with their own online softmax, merged at
the end), at gemma3-1b's attention shape (4 q heads on 1 kv head, 1024
causal keys, D 256, window 512 and none), and holds it to the plain
version within the fp32 gate, rtol = atol = 1e-5.  One TF32 product in
the same order misses that gate: the split is needed.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import BLOCK_KEYS, BLOCK_ROWS  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402

FLASH_TOL = dict(rtol=1e-5, atol=1e-5)
SOURCE = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc/flash_attention.cu"


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` does (finite x)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """The TF32 value the tensor cores read from fp32 bits: the low 13 cleared."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def product(a: torch.Tensor, b: torch.Tensor, split: bool) -> torch.Tensor:
    """a @ b as the kernel's products: three TF32 products of the split
    operands, or (``split=False``) one product of the rounded operands."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    if not split:
        return ah @ bh
    al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
    return ah @ bl + al @ bh + ah @ bh


def emulate(q, k, v, window, split):
    """The fp32 kernel's arithmetic for one batch row and one kv head:
    q [G, L, D] (the group's heads), k, v [L, D], causal, Lq = Lk."""
    g, l, d = q.shape
    qs = q * np.float32(1.0 / np.sqrt(d))                # scaled as it is staged
    rows = qs.transpose(0, 1).reshape(l * g, d)          # packed row R: head R % g, query R // g
    nblk = rows.shape[0] // BLOCK_ROWS
    qb = rows.reshape(nblk, BLOCK_ROWS, d)
    pos = torch.arange(l * g).reshape(nblk, BLOCK_ROWS) // g
    kend = pos[:, -1] + 1
    kbeg = (pos[:, 0] - window + 1).clamp_min(0) if window else torch.zeros_like(kend)
    ntiles = int(((kend - kbeg + BLOCK_KEYS - 1) // BLOCK_KEYS).max())
    half = BLOCK_KEYS // 2
    state = [[torch.full((nblk, BLOCK_ROWS), -1e30), torch.zeros(nblk, BLOCK_ROWS),
              torch.zeros(nblk, BLOCK_ROWS, d)] for _ in range(2)]
    for it in range(ntiles):
        for h, (m, s_l, o) in enumerate(state):
            keys = kbeg[:, None] + it * BLOCK_KEYS + h * half + torch.arange(half)
            seen = keys < kend[:, None]
            kt = torch.where(seen[..., None], k[keys.clamp_max(l - 1)], 0.0)
            vt = torch.where(seen[..., None], v[keys.clamp_max(l - 1)], 0.0)
            s = product(qb, kt.transpose(1, 2), split)
            ok = seen[:, None, :] & (keys[:, None, :] <= pos[..., None])
            if window:
                ok &= keys[:, None, :] > pos[..., None] - window
            s = torch.where(ok, s, -torch.inf)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            state[h] = [m_new, s_l * alpha + p.sum(-1),
                        o * alpha[..., None] + product(p, vt, split)]
    (m0, l0, o0), (m1, l1, o1) = state
    m_new = torch.maximum(m0, m1)
    a0, a1 = torch.exp(m0 - m_new), torch.exp(m1 - m_new)
    denom = (l0 * a0 + l1 * a1).clamp_min(1e-30)
    out = (o0 * a0[..., None] + o1 * a1[..., None]) / denom[..., None]
    return out.reshape(l, g, d).transpose(0, 1)


def _gemma_inputs():
    rng = np.random.default_rng(15)
    q = torch.from_numpy(rng.normal(size=(4, 1024, 256)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(1024, 256)).astype(np.float32))
            for _ in range(2))
    return q, k, v


def test_tile_sizes_are_the_kernels():
    src = SOURCE.read_text()
    assert re.search(rf"constexpr int kBlockM = {BLOCK_ROWS};", src)
    assert re.search(rf"constexpr int kBlockN = {BLOCK_KEYS};", src)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    ulp = 2.0 ** -10                     # of a TF32 value in [1, 2)
    x = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2.0 ** -23, -(1.0 + ulp / 2),
                      1.0 + 1.5 * ulp, 3.0e-39], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + ulp, 1.0, -(1.0 + ulp), 1.0 + 2 * ulp, 3.0e-39],
                        dtype=torch.float32)
    got = tf32_rna(x)
    assert torch.equal(got[:5], want[:5])
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    # hi + lo keeps 21 of fp32's 24 significand bits
    y = torch.from_numpy(np.random.default_rng(0).normal(size=1000).astype(np.float32))
    hi = tf32_rna(y)
    err = (hi + tf32_trunc(y - hi) - y).abs() / y.abs()
    assert float(err.max()) < 2.0 ** -20


@pytest.mark.parametrize("window", [None, 512])
def test_three_tf32_products_meet_the_fp32_gate(window):
    q, k, v = _gemma_inputs()
    got = emulate(q, k, v, window, split=True)
    want = flash_attention_ref(q[None], k[None, None], v[None, None], True, window)[0]
    torch.testing.assert_close(got, want, **FLASH_TOL)


@pytest.mark.parametrize("window", [None, 512])
def test_one_tf32_product_misses_the_fp32_gate(window):
    q, k, v = _gemma_inputs()
    got = emulate(q, k, v, window, split=False)
    want = flash_attention_ref(q[None], k[None, None], v[None, None], True, window)[0]
    assert float((got - want).abs().max()) > 10 * FLASH_TOL["atol"]
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, want, **FLASH_TOL)
