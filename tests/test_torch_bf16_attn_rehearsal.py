"""A CPU rehearsal of the bf16 attention backward kernel's arithmetic.

``csrc/flash_attention_bwd_bf16.cu`` runs every product of the gradient
on Hopper's warpgroup products (``wgmma.m64nNk16``, bf16 operands, fp32
accumulators).  Each 16-deep step of a product is modelled as the card
computes it: exact products of the bf16 operands added to the
accumulator, the sum rounded toward zero to fp32 (the model
``tests/test_torch_tf32_split_bwd.py`` uses for ``mma.sync``, which
reproduced the card's drift).  This test does that arithmetic in plain
torch, in the kernels' order and at their rounding points:

- s^T = K Q^T and dp^T = V dO^T (and, in the dQ kernel, s and dp) start
  from zero every stage and run their 16-deep steps over the head dims
  in order; each element's chain is the same in both kernels, so one
  matrix of each serves both;
- p = 2^(s scale log2 e - lse log2 e), 0 where the masks hide a key, and
  ds = p (dp - delta), in fp32; then p and ds are rounded to bf16 (to
  nearest), the kernels' two rounding points;
- dv += p^T dO and dk += ds^T Q stay in the tensor cores' accumulators for
  the whole walk of a key tile: the q heads of the GQA group in order,
  each over its queries 16 at a time in order; dq += ds K likewise over
  the keys.  Unseen pairs add exact zeros, which leave a sum rounded
  toward zero as it was, so the walk may run over every query;
- dk and dq are scaled in fp32 and every gradient rounded to bf16.

It holds dq, dk and dv to the plain backward (``flash_attention_bwd_ref``
on the same bf16 inputs, the plain forward's out and lse) within one bf16
ulp of the largest value (``chip_smoke._top_ulps``, the gate of
``chip_smoke.BF16_BWD_ULPS``) at one (batch, kv head) of smollm-135m's
training shape (3 q heads on 1 kv head, D 64, L 1024, causal), with a
300-key window, and at DeepSeek-V2's MLA head dims (q/k 192, v 128, 4
heads, L 256, scale 192^-0.5), and the fp32 sums before that last
rounding within half a unit of the plain backward's fp32 sums: the
rounding of p and ds leaves about 0.15-0.25 units, and the rest of the
gate is a gradient near the top of its binade rounded the other way.
bf16 p and ds meet it, so neither is split into hi and lo parts; and the
whole-walk sums meet it, so the kernel keeps dk, dv and dq in the
accumulators (the fp32 kernel adds each stage's product in fp32 instead:
its gate is 1e-5, and a whole walk missed that).
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ref import (flash_attention_bwd_ref,  # noqa: E402
                                     flash_attention_lse_ref)

SOURCE = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc/flash_attention_bwd_bf16.cu"
STEP = 16                                # the depth of one wgmma.m64nNk16
LOG2E = 1.4426950408889634               # p = 2^(s scale log2 e - lse log2 e), as ex2
BF16_BWD_ULPS = 1.0                      # chip_smoke.BF16_BWD_ULPS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rz(x):
    """fp64 rounded toward zero to fp32 (its significand cut to 24 bits)."""
    return (x.view(torch.int64) & ~((1 << 29) - 1)).view(torch.float64).float()


def _chain(a, b):
    """a @ b over the last dim of a, 16 deep at a time in order from zero, each
    step's sum rounded toward zero (fp32 out; a, b bf16 values)."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    a, b = a.double(), b.double()
    for c in range(0, a.shape[-1], STEP):
        acc = _rz(acc.double() + a[..., c:c + STEP] @ b[..., c:c + STEP, :])
    return acc


def _top_ulps(got, want):
    """chip_smoke._top_ulps: max |got - want| in 2^-7 of the largest |want|
    (at least 1)."""
    top = max(float(want.float().abs().max()), 1.0)
    return float((got.float() - want.float()).abs().max()) / (2.0 ** -7 * top)


def emulate(q, k, v, out, lse, dout, window, scale):
    """(dq, dk, dv) as the kernels compute them, in fp32 before their last
    rounding to bf16, causal, Lq = Lk:
    q [H, G, L, Dqk], k [H, L, Dqk], v [H, L, Dv], out and dout [H, G, L,
    Dv], lse [H, G, L] (H kv heads, G q heads each)."""
    h, g, l, _ = q.shape
    pos = torch.arange(l)
    seen = pos[None, :] <= pos[:, None]                       # [query, key]
    if window:
        seen &= pos[None, :] > pos[:, None] - window
    delta = (dout.float() * out.float()).sum(-1)
    s = _chain(q, k[:, None].transpose(-1, -2))               # [H, G, Lq, Lk]
    dp = _chain(dout, v[:, None].transpose(-1, -2))
    x = s * np.float32(scale * LOG2E) - lse[..., None] * np.float32(LOG2E)
    p = torch.where(seen, torch.exp2(x), torch.zeros(()))
    ds = p * (dp - delta[..., None])
    p16, ds16 = p.bfloat16().double(), ds.bfloat16().double()

    # dK/dV: each key's sums over the walk, q heads outermost, queries 16 at a time
    acc_v = torch.zeros(h, l, v.shape[-1])
    acc_k = torch.zeros(h, l, k.shape[-1])
    for head in range(g):
        for c in range(0, l, STEP):
            rows = slice(c, c + STEP)
            acc_v = _rz(acc_v.double() + p16[:, head, rows].transpose(-1, -2)
                        @ dout[:, head, rows].double())
            acc_k = _rz(acc_k.double() + ds16[:, head, rows].transpose(-1, -2)
                        @ q[:, head, rows].double())
    # dQ: each query's sum over the keys, 16 at a time
    acc_q = torch.zeros(q.shape)
    for c in range(0, l, STEP):
        acc_q = _rz(acc_q.double() + ds16[..., c:c + STEP] @ k[:, None, c:c + STEP].double())
    sc = np.float32(scale)
    return acc_q * sc, acc_k * sc, acc_v


def _inputs(heads, group, length, dqk, dv, window, scale):
    rng = np.random.default_rng(31)

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()
    q, dout = draw(heads, group, length, dqk), draw(heads, group, length, dv)
    k, v = draw(heads, length, dqk), draw(heads, length, dv)
    out, lse = flash_attention_lse_ref(q, k[:, None], v[:, None], True, window, scale)
    return q, k, v, out, lse, dout


CASES = {"smollm": (1, 3, 1024, 64, 64, None), "smollm-window-300": (1, 3, 1024, 64, 64, 300),
         "mla": (4, 1, 256, 192, 128, None)}


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_p_and_ds_and_whole_walk_sums_meet_the_gate(case):
    """The kernels' bf16 gradients within the gate; and their fp32 sums,
    before that last rounding, within half a unit of the plain backward's
    fp32 sums, so that only a rounding the other way at the top binade can
    bring a gradient to a whole unit."""
    heads, group, length, dqk, dv, window = CASES[case]
    scale = dqk ** -0.5
    q, k, v, out, lse, dout = _inputs(heads, group, length, dqk, dv, window, scale)
    got = emulate(q, k, v, out, lse, dout, window, scale)

    def plain(*xs):      # on [B, Hq, L, D] and [B, Hkv, L, D]: the kv heads as B
        dq, dk, dv = flash_attention_bwd_ref(xs[0], xs[1][:, None], xs[2][:, None], *xs[3:],
                                             True, window, scale)
        return dq, dk[:, 0], dv[:, 0]
    want = plain(q, k, v, out, lse, dout)
    want32 = plain(*(x.float() for x in (q, k, v, out)), lse, dout.float())
    for name, a, w, w32 in zip(("dq", "dk", "dv"), got, want, want32):
        assert a.shape == w.shape and w.dtype == torch.bfloat16, name
        assert _top_ulps(a.bfloat16(), w) <= BF16_BWD_ULPS, (name, _top_ulps(a.bfloat16(), w))
        assert _top_ulps(a, w32) <= 0.5, (name, _top_ulps(a, w32))


def test_the_steps_and_walk_are_the_kernels():
    """The emulation's 16-deep steps are the instruction's, and the kernels
    walk the q heads outermost and keep the sums in the accumulators."""
    src = SOURCE.read_text()
    assert "wgmma_rs<DV>(first<DV / 2>(acc)" in src            # dv in its accumulators
    assert "wgmma_rs<DQK>(first<DQK / 2>(acc)" in src          # dk
    assert "wgmma_rs<DQK>(acc, a[kk]" in src                   # dq
    assert re.search(r"const int h = h0 \+ s / nt, q0 = \(t_lo \+ s % nt\) \* kQueries;", src)
    hdr = (SOURCE.parent / "wgmma_bf16.cuh").read_text()
    assert hdr.count("k16.f32.bf16.bf16") >= 8
