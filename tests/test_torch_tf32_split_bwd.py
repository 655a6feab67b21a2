"""A CPU rehearsal of the fp32 attention backward kernel's arithmetic.

``csrc/flash_attention_bwd.cu`` runs all five products of the gradient
(``s = q k^T``, ``dp = dout v^T``, ``dv = p^T dout``, ``dk = ds^T q``,
``dq = ds k``, the first two twice) on the tensor cores as three TF32
products: every fp32 operand x is split into ``hi`` (x rounded to TF32 as
``cvt.rna.tf32.f32`` rounds) and ``lo`` (x - hi, of which the tensor
cores read the top 19 bits), each 8-deep step of a product adds
``hi*lo``, then ``lo*hi``, then ``hi*hi`` to its accumulator, and p is
``2^(s scale log2 e - lse log2 e)``.  Each
``mma.sync`` is modelled as the card computes it: exact products added to
the accumulator, the sum rounded toward zero to fp32 (this model gives the
1.2e-4 drift of dk that a first layout showed on the card, below).  This
test does that arithmetic in plain torch, in the kernels' order:

- dK/dV: a block of ``BWD_BLOCK_KEYS`` keys walks the q heads of its GQA
  group, each over its query tiles of ``BWD_BLOCK_QUERIES``, in order;
  each tile's queries are split between two halves, each with its own dk
  and dv sums; each stage's product is taken in fresh accumulators and
  added to those sums in fp32 (rounded to nearest); the halves are added
  (half 0 + half 1) at the end and dk is scaled;
- dQ: a block of ``BWD_BLOCK_QUERIES`` queries walks the key tiles of
  ``BWD_BLOCK_KEYS`` in order, each split between two halves with their
  own dq sums, taken the same way, added at the end and scaled.

At head dim 256 a cluster of blocks splits D (``BWD_SPLIT_COLS`` columns
a block): each block takes s and dp over its own columns in fresh
accumulators (a chain of 24 mma.sync, as at D 64), and the blocks'
partials are added in fp32 in rank order; dk, dv and dq are taken column
by column as at the other head dims, so the split does not change their
arithmetic.  There a dK/dV cluster walks one q head of the group: each
head's share of dk and dv (its halves added) is summed apart, and a
second pass adds the shares in head order, then scales dk.

Every block is emulated at once, each step only over the blocks that walk
that tile (the others would add exact zeros).  It holds dq, dk and
dv to the plain backward, ``flash_attention_bwd_ref``, within
``chip_smoke.BWD_RTOL``'s gate (rtol 1e-5, atol 1e-5 of the output's
largest value) at one (batch, kv head) of smollm-135m's training shape (3
q heads on 1 kv head, causal, D 64, L 1024) and with a 300-key window,
and of gemma3-1b's (4 q heads on 1 kv head, D 256, L 1024) without a
window and with its 512-key one.  It shows that one TF32 product a flop
misses that gate at both, and that keeping dk and dv in the tensor cores'
accumulators for a whole walk (a chain of 576 rounded-toward-zero sums at
L 1024) misses it too.  (A chain over all of D 256 in one accumulator,
96 mma.sync, met the gate on these inputs with about half the margin of
the quarters; the split takes fresh accumulators a block anyway.)
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (BWD_BLOCK_KEYS,  # noqa: E402
                                                 BWD_BLOCK_QUERIES, BWD_SPLIT_COLS,
                                                 bwd_split_cols)
from repro_torch.kernels.ref import (flash_attention_bwd_ref,  # noqa: E402
                                     flash_attention_lse_ref)
from test_torch_tf32_split import tf32_rna, tf32_trunc  # noqa: E402

BWD_RTOL = 1e-5                          # chip_smoke.BWD_RTOL
SOURCE = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc/flash_attention_bwd.cu"
L = 1024
# q heads a kv head and head dim: smollm-135m (9 q heads on 3 kv heads of 64)
# and gemma3-1b (4 on 1 of 256)
SHAPES = {"smollm": (3, 64), "gemma": (4, 256)}
STEP = 8                                 # the depth of one mma.sync.m16n8k8
LOG2E = 1.4426950408889634               # p = 2^(s scale log2 e - lse log2 e), as ex2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small fp64 products, many of them: one PyTorch thread is as fast
    and does not contend with the other test workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mma(acc, a, b):
    """One ``mma.sync``: acc + a @ b (a, b fp64) with exact products, rounded
    toward zero (fp64's significand cut to fp32's 24 bits, then converted
    exactly)."""
    x = acc.double() + a @ b
    return (x.view(torch.int64) & ~((1 << 29) - 1)).view(torch.float64).float()


def _operands(x, split):
    """x as the tensor cores read it, in fp64: (hi, lo) of the split, or x
    rounded to TF32 alone."""
    hi = tf32_rna(x)
    return (hi.double(), tf32_trunc(x - hi).double()) if split else (hi.double(),)


def _gemm(acc, a, b, split):
    """acc + a @ b in the tensor cores' accumulators, the depth taken 8 at a
    time in order, each step as the kernel's mma.sync calls: hi*lo, lo*hi,
    hi*hi, or one product of the rounded operands."""
    ops_a, ops_b = _operands(a, split), _operands(b, split)
    for c in range(0, a.shape[-1], STEP):
        xa = [x[..., c:c + STEP] for x in ops_a]
        xb = [x[..., c:c + STEP, :] for x in ops_b]
        if split:
            acc = _mma(_mma(_mma(acc, xa[0], xb[1]), xa[1], xb[0]), xa[0], xb[0])
        else:
            acc = _mma(acc, xa[0], xb[0])
    return acc


def _stage(acc, a, b, split, whole_walk=False):
    """acc + a @ b for one stage: in fresh accumulators, then added in fp32
    (the kernels); or, with ``whole_walk``, in acc's own accumulators."""
    if whole_walk:
        return _gemm(acc, a, b, split)
    return acc + _gemm(torch.zeros_like(acc), a, b, split)


def _seen(queries, keys, window):
    ok = keys <= queries                 # causal, Lq = Lk
    return ok & (keys > queries - window) if window else ok


def _contract(a, b, split, cols):
    """a @ b where the depth is D, as the kernels take s and dp: each block's
    ``cols`` columns of D in fresh accumulators, the blocks' partials added
    in fp32 in rank order (one block at D <= 128: cols = D)."""
    out = None
    for c in range(0, a.shape[-1], cols):
        zero = torch.zeros(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
                           + (a.shape[-2], b.shape[-1]))
        part = _gemm(zero, a[..., c:c + cols], b[..., c:c + cols, :], split)
        out = part if out is None else out + part
    return out


def emulate(q, k, v, out, lse, dout, window, split, whole_walk=False, with_dq=True,
            cols=None):
    """(dq, dk, dv) as the kernels compute them for one batch row and one kv
    head: q, out, dout [G, L, D], k, v [L, D], lse [G, L]; causal.  s and dp
    are taken ``cols`` columns of D a block (default: the instance's,
    ``bwd_split_cols``); where that splits D, each q head's share of dk and
    dv is summed apart and the shares added in head order.  dq is None
    without ``with_dq``."""
    g, l, d = q.shape
    cols = cols or bwd_split_cols(d)
    per_head = cols < d
    scale = d ** -0.5
    delta = (dout * out).sum(-1)
    kb, qb = BWD_BLOCK_KEYS, BWD_BLOCK_QUERIES
    nk, nq = l // kb, l // qb

    # dK/dV: every key tile at once; halves of each query tile apart; with
    # per-head shares every head at once too
    kt, vt = k.reshape(nk, kb, d), v.reshape(nk, kb, d)
    keys = torch.arange(l).reshape(1, nk, kb, 1)
    acc_k = torch.zeros(g if per_head else 1, 2, nk, kb, d)
    acc_v = torch.zeros_like(acc_k)
    for hs in [slice(0, g)] if per_head else [slice(h, h + 1) for h in range(g)]:
        n = hs.stop - hs.start
        for t in range(nq):
            rows = slice(t * qb, (t + 1) * qb)
            # the key tiles whose keys the tile's queries see
            blk = slice(max(0, t * qb - window + 1) // kb if window else 0, t + 1)
            qt = q[hs, rows].reshape(n, 2, 1, qb // 2, d)
            gt = dout[hs, rows].reshape(n, 2, 1, qb // 2, d)
            lt = lse[hs, rows].reshape(n, 2, 1, 1, qb // 2)
            dl = delta[hs, rows].reshape(n, 2, 1, 1, qb // 2)
            s = _contract(kt[blk], qt.transpose(-1, -2), split, cols)     # s^T
            dp = _contract(vt[blk], gt.transpose(-1, -2), split, cols)    # dp^T
            queries = (t * qb + torch.arange(qb)).reshape(2, 1, 1, qb // 2)
            p = torch.where(_seen(queries, keys[:, blk], window),
                            torch.exp2(s * (scale * LOG2E) - lt * LOG2E), torch.zeros(()))
            ds = p * (dp - dl)
            acc_v[:, :, blk] = _stage(acc_v[:, :, blk], p, gt, split, whole_walk)
            acc_k[:, :, blk] = _stage(acc_k[:, :, blk], ds, qt, split, whole_walk)
    share_k, share_v = acc_k[:, 0] + acc_k[:, 1], acc_v[:, 0] + acc_v[:, 1]
    dk, dv = share_k[0], share_v[0]
    for h in range(1, len(share_k)):
        dk, dv = dk + share_k[h], dv + share_v[h]
    dk, dv = (dk * scale).reshape(l, d), dv.reshape(l, d)
    if not with_dq:
        return None, dk, dv

    # dQ: every (q head, query tile) at once; halves of each key tile apart
    qt = q.reshape(1, g, nq, qb, d)
    gt = dout.reshape(1, g, nq, qb, d)
    lt = lse.reshape(1, g, nq, qb, 1)
    dl = delta.reshape(1, g, nq, qb, 1)
    queries = torch.arange(l).reshape(1, 1, nq, qb, 1)
    acc = torch.zeros(2, g, nq, qb, d)
    for t in range(nk):
        rows = slice(t * kb, (t + 1) * kb)
        # the query tiles whose queries see the tile's keys
        blk = slice(t, min(l - 1, (t + 1) * kb - 2 + window) // qb + 1 if window else nq)
        ks = k[rows].reshape(2, 1, 1, kb // 2, d)
        vs = v[rows].reshape(2, 1, 1, kb // 2, d)
        s = _contract(qt[:, :, blk], ks.transpose(-1, -2), split, cols)
        dp = _contract(gt[:, :, blk], vs.transpose(-1, -2), split, cols)
        keys_t = (t * kb + torch.arange(kb)).reshape(2, 1, 1, 1, kb // 2)
        p = torch.where(_seen(queries[:, :, blk], keys_t, window),
                        torch.exp2(s * (scale * LOG2E) - lt[:, :, blk] * LOG2E), torch.zeros(()))
        acc[:, :, blk] = _stage(acc[:, :, blk], p * (dp - dl[:, :, blk]), ks, split)
    dq = ((acc[0] + acc[1]) * scale).reshape(g, l, d)
    return dq, dk, dv


def _inputs(shape, window):
    group, d = SHAPES[shape]
    rng = np.random.default_rng(25)
    q, dout = (torch.from_numpy(rng.normal(size=(group, L, d)).astype(np.float32))
               for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(L, d)).astype(np.float32)) for _ in range(2))
    out, lse = flash_attention_lse_ref(q[None], k[None, None], v[None, None], True, window)
    return q, k, v, out[0], lse[0], dout


def _plain(q, k, v, out, lse, dout, window):
    dq, dk, dv = flash_attention_bwd_ref(q[None], k[None, None], v[None, None], out[None],
                                         lse[None], dout[None], True, window)
    return dq[0], dk[0, 0], dv[0, 0]


def _gate(got, want):
    """|got - want| <= BWD_RTOL |want| + BWD_RTOL max(max |want|, 1), as
    chip_smoke's ``_close_bwd``; returns the largest excess (<= 0: met)."""
    atol = BWD_RTOL * max(float(want.abs().max()), 1.0)
    return float(((got - want).abs() - BWD_RTOL * want.abs() - atol).max())


def test_tile_sizes_are_the_kernels():
    src = SOURCE.read_text()
    assert re.search(rf"constexpr int kKeys = {BWD_BLOCK_KEYS};", src)
    assert re.search(rf"constexpr int kQueries = {BWD_BLOCK_QUERIES};", src)
    assert re.search(r"constexpr int kHalf = 32;", src)          # two halves a stage
    assert BWD_BLOCK_KEYS == BWD_BLOCK_QUERIES == 64
    # the D split: kSplitCols columns a block above D 128, the whole of D below
    assert re.search(rf"constexpr int kSplitCols = {BWD_SPLIT_COLS};", src)
    assert re.search(r"return d > 128 \? d / kSplitCols : 1;", src)
    assert [bwd_split_cols(d) for d in (32, 64, 128, 256)] == [32, 64, 128, 64]


@pytest.mark.parametrize("shape,window", [
    pytest.param("smollm", None, id="None"), pytest.param("smollm", 300, id="300"),
    pytest.param("gemma", None, id="gemma-None"), pytest.param("gemma", 512, id="gemma-512")])
def test_three_tf32_products_meet_the_backward_gate(shape, window):
    inputs = _inputs(shape, window)
    got = emulate(*inputs, window, split=True)
    want = _plain(*inputs, window)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert _gate(a, w) <= 0, name
        torch.testing.assert_close(a, w, rtol=BWD_RTOL,
                                   atol=BWD_RTOL * max(float(w.abs().max()), 1.0))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_one_tf32_product_misses_the_backward_gate(shape):
    inputs = _inputs(shape, None)
    got = emulate(*inputs, None, split=False)
    want = _plain(*inputs, None)
    excess = [_gate(a, w) for a, w in zip(got, want)]
    assert all(e > 0 for e in excess), excess


def test_a_whole_walk_in_the_tensor_cores_misses_the_backward_gate():
    """dk and dv summed in the tensor cores' accumulators across the walk
    (no fp32 add a stage) drift toward zero beyond the gate."""
    inputs = _inputs("smollm", None)
    _, dk, dv = emulate(*inputs, None, split=True, whole_walk=True, with_dq=False)
    _, want_k, want_v = _plain(*inputs, None)
    assert max(_gate(dk, want_k), _gate(dv, want_v)) > 0
