"""The gradient of the port's flash attention against the JAX reference.

- ``flash_attention_bwd_ref`` (the backward written out: the CPU path of
  the backward kernel and its oracle on the card) against
  ``torch.autograd`` through ``flash_attention_ref`` and against
  ``jax.vjp`` of the reference's own attention, ``sdpa`` (with
  ``causal_mask``) and ``sdpa_blockwise`` (its online-softmax scan, in
  chunks of 8 keys), on the same inputs: causal and not, windows, GQA
  groups 1, 2 and 3, ``Lq <= Lk``, head dims 32 and 64.
- ``flash_attention_lse_ref``'s row log-sum-exp against ``logsumexp``.
- The ``torch.autograd.Function``: on CPU tensors ``flash_attention``
  has a ``grad_fn`` wherever autograd needs one and its gradient is the
  plain backward's; ``torch.func.vmap(torch.func.grad(...))`` (per-example
  DP-SGD) runs through its ``vmap`` rules and gives autograd's per-example
  gradients; no second derivative.
- The rule that refuses a gradient through the WKV-6 and selective-scan
  kernels on the card (``build.refuse_backward``, asked by their CUDA
  wrappers only), and that the CPU
  trains through their plain versions.
- The backward's C interface: its instances (fp32, head dims 32/64/128)
  and argument list against ``csrc/flash_attention_bwd.cu``; what it has
  no instance of raises a ``ValueError`` that names it.

Tolerances: fp32 sums in another order than autograd's or XLA's einsums
(and the blockwise scan's rescaling): rtol=atol=2e-5 on unit-scale
inputs.  The CUDA kernel is held to the plain backward on the card by
``chip_smoke.py`` (phase 20a).
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch import NotPorted  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_cuda  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_cuda  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-5, atol=2e-5)

# (b, hq, hkv, lq, lk, d, causal, window)
CASES = [
    (1, 2, 2, 16, 16, 32, True, None),       # group 1
    (2, 4, 2, 24, 24, 64, True, None),       # group 2
    (1, 6, 2, 20, 20, 32, True, 7),          # group 3 (smollm's 9/3), a window
    (1, 3, 1, 9, 40, 64, True, None),        # group 3, Lq < Lk
    (2, 4, 2, 8, 32, 32, True, 11),          # Lq < Lk with a window
    (1, 2, 1, 16, 16, 64, False, None),      # not causal
    (1, 4, 2, 16, 24, 32, False, 9),         # a window without the causal mask
]
IDS = [f"b{c[0]}-h{c[1]}/{c[2]}-q{c[3]}-k{c[4]}-d{c[5]}-{'c' if c[6] else 'nc'}-w{c[7]}"
       for c in CASES]


def _inputs(case, seed=0):
    b, hq, hkv, lq, lk, d = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d), (b, hq, lq, d))]


def _plain_bwd(q, k, v, g, causal, window):
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = ref.flash_attention_lse_ref(tq, tk, tv, causal, window)
    return ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tg, causal, window)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_is_autograd_of_the_plain_forward(case):
    causal, window = case[6:]
    q, k, v, g = _inputs(case)
    got = _plain_bwd(q, k, v, g, causal, window)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ref.flash_attention_ref(*leaves, causal, window)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, a, b in zip("qkv", got, want):
        torch.testing.assert_close(a, b, **TOL, msg=lambda m: f"d{name}: {m}")


def _heads_last(x):
    return jnp.asarray(np.swapaxes(x, 1, 2))           # [B, H, L, D] -> [B, L, H, D]


# ``sdpa`` is always causal (its mask): the non-causal cases run through
# ``sdpa_blockwise`` only
VJP_CASES = [pytest.param(c, False, id=f"{i}-sdpa") for c, i in zip(CASES, IDS) if c[6]] + \
    [pytest.param(c, True, id=f"{i}-sdpa_blockwise") for c, i in zip(CASES, IDS)]


@pytest.mark.parametrize("case,blockwise", VJP_CASES)
def test_plain_backward_is_the_vjp_of_the_reference_attention(case, blockwise):
    """The reference trains through these two and differentiates them with
    XLA."""
    b, hq, hkv, lq, lk, d, causal, window = case
    q, k, v, g = _inputs(case)

    def attend(jq, jk, jv):
        if blockwise:
            return jattn.sdpa_blockwise(jq, jk, jv, causal=causal, window=window, chunk=8)
        return jattn.sdpa(jq, jk, jv, jattn.causal_mask(lq, lk, window))

    _, vjp = jax.vjp(attend, *(_heads_last(x) for x in (q, k, v)))
    want = [np.swapaxes(np.asarray(x), 1, 2) for x in vjp(_heads_last(g))]
    got = _plain_bwd(q, k, v, g, causal, window)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), w, **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", CASES[:5], ids=IDS[:5])
def test_lse_is_the_rows_logsumexp(case):
    causal, window = case[6:]
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(case))
    out, lse = ref.flash_attention_lse_ref(q, k, v, causal, window)
    torch.testing.assert_close(out, ref.flash_attention_ref(q, k, v, causal, window),
                               rtol=1e-6, atol=1e-6)
    mask = ref._seen(q.shape[2], k.shape[2], causal, window, q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.repeat_interleave(q.shape[1] // k.shape[1], 1))
    s = torch.where(mask, s * q.shape[-1] ** -0.5, torch.full_like(s, -float("inf")))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", CASES[1:4], ids=IDS[1:4])
def test_the_function_differentiates_on_the_cpu(case):
    causal, window = case[6:]
    q, k, v, g = _inputs(case)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal, window=window)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    torch.testing.assert_close(out.detach(), ref.flash_attention_ref(
        *(x.detach() for x in leaves), causal, window), rtol=1e-6, atol=1e-6)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for a, b in zip(got, _plain_bwd(q, k, v, g, causal, window)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # a non-contiguous output gradient, as the attention module's transpose gives
    out = fa.flash_attention(*leaves, causal=causal, window=window)
    gt = torch.from_numpy(np.ascontiguousarray(np.swapaxes(g, 1, 2))).transpose(1, 2)
    assert not gt.is_contiguous()
    for a, b in zip(torch.autograd.grad(out, leaves, gt), got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # no grad needed: the plain forward, no graph
    with torch.no_grad():
        assert fa.flash_attention(*leaves, causal=causal, window=window).grad_fn is None
    # no second derivative
    out = fa.flash_attention(*leaves, causal=causal, window=window)
    (gq,) = torch.autograd.grad((out * out).sum(), leaves[0], create_graph=True)
    with pytest.raises(NotImplementedError, match="second derivative"):
        torch.autograd.grad(gq.sum(), leaves[0])


def test_vmap_of_grad_runs_through_the_vmap_rules():
    """Per-example DP-SGD's transform: each example's gradient of a loss
    through ``flash_attention`` (a projection of q by a shared weight) is
    autograd's gradient of the same loss through the plain version."""
    rng = np.random.default_rng(1)
    n, hq, hkv, l, d = 3, 6, 2, 10, 32
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((n, hq, l, d), (n, hkv, l, d), (n, hkv, l, d)))
    w = torch.from_numpy((rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32))

    def loss(attend):
        def f(w, qq, kk, vv):
            return torch.sum(torch.tanh(attend((qq @ w)[None], kk[None], vv[None])))
        return f

    fast = loss(lambda a, b, c: fa.flash_attention(a, b, c, causal=True, window=4))
    got = torch.func.vmap(torch.func.grad(fast, argnums=(0, 1, 2)),
                          in_dims=(None, 0, 0, 0))(w, q, k, v)
    plain = loss(lambda a, b, c: ref.flash_attention_ref(a, b, c, True, 4))
    for i in range(n):
        leaves = [w.clone().requires_grad_(), q[i].clone().requires_grad_(),
                  k[i].clone().requires_grad_()]
        want = torch.autograd.grad(plain(*leaves, v[i]), leaves)
        for a, b in zip(got, want):
            torch.testing.assert_close(a[i], b, **TOL)


def test_the_scans_refuse_a_gradient_on_the_card_only():
    """``refuse_backward`` decides: a call that autograd would
    differentiate (grad mode and an input that requires grad, or a
    ``torch.func`` transform) raises, never one without a grad.  Only
    the CUDA wrappers ask it, so the CPU trains through the plain
    versions."""
    x, y = torch.zeros(2, requires_grad=True), torch.zeros(2)
    with pytest.raises(NotPorted):
        build.refuse_backward("k", y, x)
    build.refuse_backward("k", y, y)
    with torch.no_grad():
        build.refuse_backward("k", x, y)

    def probe(t):
        build.refuse_backward("k", t)
        return t.sum()
    for transform, arg in ((torch.func.grad, y), (torch.func.vmap, torch.zeros(3, 2))):
        with pytest.raises(NotPorted):
            transform(probe)(arg)
    # on the CPU the plain versions train
    rng = np.random.default_rng(2)
    r, k, v, w = (torch.from_numpy(rng.standard_normal((1, 2, 5, 32)).astype(np.float32))
                  .requires_grad_() for _ in range(4))
    u = torch.zeros(2, 32)
    out, _ = rwkv6_scan(r, k, v, torch.sigmoid(w), u)
    assert all(g is not None for g in torch.autograd.grad(out.sum(), (r, k, v, w)))
    dt, x = (torch.rand(1, 6, 8, requires_grad=True) for _ in range(2))
    bm, cm = (torch.randn(1, 6, 4) for _ in range(2))
    y, _ = mamba_scan(dt, bm, cm, x, torch.zeros(8, 4))
    assert all(g is not None for g in torch.autograd.grad(y.sum(), (dt, x)))


def test_refuse_backward_names_the_kernel():
    """The CUDA wrappers refuse before anything else: an input that
    requires grad gets ``NotPorted`` naming the missing backward kernel,
    and one that does not gets the wrapper's own device check."""
    t, u = torch.zeros(1, 1, 1, 32, requires_grad=True), torch.zeros(1, 32)
    with pytest.raises(NotPorted) as err:
        rwkv6_scan_cuda(t, t, t, t, u)
    assert err.value.seam == "rwkv6_scan_bwd"
    with pytest.raises(ValueError, match="on CUDA"):
        rwkv6_scan_cuda(*(t.detach(),) * 4, u)
    dt, bc = torch.zeros(1, 2, 4, requires_grad=True), torch.zeros(1, 2, 3)
    with pytest.raises(NotPorted) as err:
        mamba_scan_cuda(dt, bc, bc, dt, torch.zeros(4, 3))
    assert err.value.seam == "mamba_scan_bwd"
    with pytest.raises(ValueError, match="on CUDA"):
        mamba_scan_cuda(dt.detach(), bc, bc, dt.detach(), torch.zeros(4, 3))


def _c_params(source: str, symbol: str) -> int:
    text = (ROOT / "src" / "repro_torch" / "csrc" / source).read_text()
    m = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text)
    return len(m.group(1).split(","))


def test_symbol_patterns_match_the_sources():
    """``ops.symbol_pattern`` (how the profilers find a kernel in a trace)
    matches every ``__global__`` function of the kernel's source and no
    other kernel's."""
    found = {}
    for name, (_, source, _) in ops.KERNELS.items():
        text = (ROOT / source).read_text()
        found[name] = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s+)?"
                                 r"(\w+)\s*\(", text)
        assert found[name], name
    for name in ops.KERNELS:
        for other, symbols in found.items():
            # as a trace spells a template instance
            hits = [s for s in symbols
                    if re.search(ops.symbol_pattern(name), f"void {s}<64>(float const*)")]
            assert hits == (symbols if other == name else []), (name, other)


def test_c_interfaces_and_instances():
    assert ops.KERNELS["flash_attention_bwd"][1] == "src/repro_torch/csrc/flash_attention_bwd.cu"
    assert (ROOT / ops.KERNELS["flash_attention_bwd"][1]).is_file()
    assert _c_params("flash_attention.cu", "flash_attention_f32") == len(fa._ARGS)
    assert _c_params("flash_attention.cu", "flash_attention_bf16") == len(fa._ARGS)
    assert _c_params("flash_attention_bwd.cu", "flash_attention_bwd_f32") == len(fa._BWD_ARGS)
    text = (ROOT / "src" / "repro_torch" / "csrc" / "flash_attention_bwd.cu").read_text()
    entry = text[text.index('extern "C" int flash_attention_bwd_f32'):]
    assert tuple(int(d) for d in re.findall(r"case (\d+): return launch<", entry)) \
        == fa.BWD_HEAD_DIMS
    lse = torch.zeros(1, 2, 4)
    q, kv = torch.zeros(1, 2, 4, 256), torch.zeros(1, 1, 4, 256)
    with pytest.raises(ValueError, match="head dim 256"):          # gemma3-1b's
        fa.flash_attention_bwd_cuda(q, kv, kv, q, lse, q, True, None)
    q, kv = torch.zeros(1, 2, 4, 64), torch.zeros(1, 1, 4, 64)
    with pytest.raises(ValueError, match="bfloat16 instance"):
        b = q.bfloat16()
        fa.flash_attention_bwd_cuda(b, kv.bfloat16(), kv.bfloat16(), b, lse, b, True, None)
    with pytest.raises(ValueError, match="on CUDA"):
        fa.flash_attention_bwd_cuda(q, kv, kv, q, lse, q, True, None)
