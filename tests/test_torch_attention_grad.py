"""The gradient of the port's flash attention against the JAX reference.

- ``flash_attention_bwd_ref`` (the backward written out: the CPU path of
  the backward kernel and its oracle on the card) against
  ``torch.autograd`` through ``flash_attention_ref`` and against
  ``jax.vjp`` of the reference's own attention, ``sdpa`` (with
  ``causal_mask``) and ``sdpa_blockwise`` (its online-softmax scan, in
  chunks of 8 keys), on the same inputs: causal and not, windows, GQA
  groups 1, 2 and 3, ``Lq <= Lk``, head dims 32 and 64; and at gemma3-1b's
  head dim 256, 4 q heads on 1 kv head, its 512-key window and 1024
  tokens, where the reference's attention takes ``sdpa_blockwise`` in its
  own chunks of 512.
- ``flash_attention_lse_ref``'s row log-sum-exp against ``logsumexp``.
- The ``torch.autograd.Function``: on CPU tensors ``flash_attention``
  has a ``grad_fn`` wherever autograd needs one and its gradient is the
  plain backward's; ``torch.func.vmap(torch.func.grad(...))`` (per-example
  DP-SGD) runs through its ``vmap`` rules and gives autograd's per-example
  gradients; no second derivative.
- The refusals of a gradient instance the backward kernels lack (the
  WKV-6 scan at head dim 128, the selective scan at d_state 48, the scans
  in bf16, attention at head dim 96): ``NotPorted`` naming the
  backward's seam, on the card only, decided without one; the CPU trains
  through the plain versions.  Full-width gemma3-1b (head dim 256, fp32)
  passes ``FederatedJob.check_ported`` on the card, as the other ported
  architectures do; a token job on the card whose model needs a missing
  instance (gemma3-1b's config at head dim 96) is refused by it, before
  any kernel is built or batch drawn; the same job on the CPU is accepted.
- The kernels' C interfaces: their instances (fp32 at head dims
  32/64/128/256 in ``csrc/flash_attention{,_bwd}.cu``, bf16 at
  ``BF16_INSTANCES``, MLA's (192, 128) among them, in
  ``csrc/flash_attention{,_bwd}_bf16.cu``) and argument lists; what they
  have no instance of raises ``NotPorted`` naming the backward.

Tolerances: fp32 sums in another order than autograd's or XLA's einsums
(and the blockwise scan's rescaling): rtol=atol=2e-5 on unit-scale
inputs.  The CUDA kernel is held to the plain backward on the card by
``chip_smoke.py`` (phase 20a).
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch import NotPorted  # noqa: E402
from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rs  # noqa: E402

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
    [pytest.param(c, True, id=f"{i}-sdpa_blockwise") for c, i in zip(CASES, IDS)] + \
    [pytest.param((1, 4, 1, 1024, 1024, 256, True, 512), True,     # gemma3-1b's layer
                  id="b1-h4/1-q1024-k1024-d256-c-w512-sdpa_blockwise")]


@pytest.mark.parametrize("case,blockwise", VJP_CASES)
def test_plain_backward_is_the_vjp_of_the_reference_attention(case, blockwise):
    """The reference trains through these two and differentiates them with
    XLA."""
    b, hq, hkv, lq, lk, d, causal, window = case
    q, k, v, g = _inputs(case)

    # from BLOCKWISE_MIN_LEN tokens the reference's own chunks, as its module
    # takes them; below, chunks of 8 keys
    chunk = {} if lk >= jattn.BLOCKWISE_MIN_LEN else {"chunk": 8}

    def attend(jq, jk, jv):
        if blockwise:
            return jattn.sdpa_blockwise(jq, jk, jv, causal=causal, window=window, **chunk)
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
    """``build.needs_grad`` decides: a call that autograd would
    differentiate (grad mode and an input that requires grad, or a
    ``torch.func`` transform), never one without a grad.  A gradient
    instance the backward kernels lack (WKV-6 at head dim 128, the
    selective scan at d_state 48, the scans in bf16, attention at head dim
    96 or in fp16; attention in bf16 has its instances) is ``NotPorted`` naming the
    backward's seam, decided before anything runs; only CUDA tensors are
    refused, so the CPU trains through the plain versions at any of them."""
    x, y = torch.zeros(2, requires_grad=True), torch.zeros(2)
    assert build.needs_grad(y, x) and not build.needs_grad(y, y)
    with torch.no_grad():
        assert not build.needs_grad(x, y)
    seen = []

    def probe(t):
        seen.append(build.needs_grad(t))
        return t.sum()
    torch.func.grad(probe)(y)
    torch.func.vmap(probe)(torch.zeros(3, 2))
    assert seen == [True, True]
    refused = [(rs.check_bwd_instance, torch.float32, 128, "rwkv6_scan_bwd"),
               (rs.check_bwd_instance, torch.bfloat16, 64, "rwkv6_scan_bwd"),
               (ms.check_bwd_instance, torch.float32, 48, "mamba_scan_bwd"),
               (ms.check_bwd_instance, torch.bfloat16, 16, "mamba_scan_bwd"),
               (fa.check_bwd_instance, torch.bfloat16, 96, "flash_attention_bwd"),
               (fa.check_bwd_instance, torch.float16, 64, "flash_attention_bwd")]
    for check, dtype, dim, seam in refused:
        with pytest.raises(NotPorted) as err:
            check(dtype, dim)
        assert err.value.seam == seam and str(dim) in str(err.value)
    for check, dims in ((rs.check_bwd_instance, (32, 64)), (ms.check_bwd_instance, (1, 16, 32)),
                        (fa.check_bwd_instance, (32, 64, 128, 256))):
        for dim in dims:
            check(torch.float32, dim)
    for dim, vdim in fa.BF16_INSTANCES:             # the bf16 attention backward's instances
        fa.check_bwd_instance(torch.bfloat16, dim, vdim)
    # on the CPU the plain versions train, at instances the card lacks too
    rng = np.random.default_rng(2)
    for d, dtype in ((32, torch.float32), (128, torch.float32), (32, torch.bfloat16)):
        r, k, v, w = (torch.from_numpy(rng.standard_normal((1, 2, 5, d)).astype(np.float32))
                      .to(dtype).requires_grad_() for _ in range(4))
        u = torch.zeros(2, d)
        out, _ = rs.rwkv6_scan(r, k, v, torch.sigmoid(w), u)
        assert all(g is not None for g in torch.autograd.grad(out.sum(), (r, k, v, w)))
    for ds in (4, 48):
        dt, x = (torch.rand(1, 6, 8, requires_grad=True) for _ in range(2))
        bm, cm = (torch.randn(1, 6, ds) for _ in range(2))
        y_, _ = ms.mamba_scan(dt, bm, cm, x, torch.zeros(8, ds))
        assert all(g is not None for g in torch.autograd.grad(y_.sum(), (dt, x)))


def test_refuse_backward_names_the_kernel(monkeypatch):
    """The backward wrappers refuse an instance they lack first, naming
    their seam, before the device check; an instance they have gets the
    device check.  C9: a token job on the card whose model needs a
    missing instance is refused by ``check_ported`` from its config alone
    (no card needed), and the same job on the CPU is accepted."""
    t, u = torch.zeros(1, 1, 3, 128), torch.zeros(1, 128)
    with pytest.raises(NotPorted) as err:
        rs.rwkv6_scan_bwd_cuda(t, t, t, t, u, torch.zeros(1, 1, 1, 128, 128), t,
                               torch.zeros(1, 1, 128, 128))
    assert err.value.seam == "rwkv6_scan_bwd"
    t, u = torch.zeros(1, 1, 3, 32), torch.zeros(1, 32)
    with pytest.raises(ValueError, match="on CUDA"):
        rs.rwkv6_scan_bwd_cuda(t, t, t, t, u, torch.zeros(1, 1, 1, 32, 32), t,
                               torch.zeros(1, 1, 32, 32))
    dt, bc = torch.zeros(1, 2, 4), torch.zeros(1, 2, 48)
    with pytest.raises(NotPorted) as err:
        ms.mamba_scan_bwd_cuda(dt, bc, bc, dt, torch.zeros(4, 48), torch.zeros(1, 1, 4, 48), dt,
                               torch.zeros(1, 4, 48))
    assert err.value.seam == "mamba_scan_bwd"
    bc = torch.zeros(1, 2, 3)
    with pytest.raises(ValueError, match="on CUDA"):
        ms.mamba_scan_bwd_cuda(dt, bc, bc, dt, torch.zeros(4, 3), torch.zeros(1, 1, 4, 3), dt,
                               torch.zeros(1, 4, 3))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    gemma = TaskConfig(kind="tokens", arch="gemma3-1b", reduced=False)
    for arch in ("gemma3-1b", "smollm-135m", "qwen3-8b", "rwkv6-7b", "jamba-1.5-large-398b",
                 "deepseek-v2-236b", "qwen3-moe-30b-a3b", "granite-3-2b", "chameleon-34b",
                 "musicgen-medium"):
        FederatedJob(task=TaskConfig(kind="tokens", arch=arch, reduced=False),
                     device="cuda").check_ported()
    # gemma3-1b's gradient in bf16 (the mixed policy's) has its instance at
    # head dim 256, as every ported architecture's has
    ops.check_backward_instances(gemma.model_config(), torch.bfloat16)
    # a model whose head dim the backward lacks
    from repro_torch.configs import gemma3_1b
    monkeypatch.setattr(gemma3_1b, "CONFIG", dataclasses.replace(gemma3_1b.CONFIG, head_dim=96))
    with pytest.raises(NotPorted) as err:
        FederatedJob(task=gemma, device="cuda").check_ported()
    assert err.value.seam == "flash_attention_bwd" and "head dim 96" in str(err.value)
    FederatedJob(task=gemma, device="cpu").check_ported()
    # the job runs nothing before it refuses: no task built, no kernel prepared
    calls = []
    monkeypatch.setattr(TaskConfig, "build", lambda self: calls.append("build"))
    monkeypatch.setattr(build, "prepare", lambda *a: calls.append("prepare"))
    for transport in ("stacked", "thread"):
        with pytest.raises(NotPorted):
            FederatedJob(task=gemma, device="cuda", transport=transport).run()
    assert calls == []


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
    assert ops.KERNELS["flash_attention_bwd_bf16"][1] == \
        "src/repro_torch/csrc/flash_attention_bwd_bf16.cu"
    assert _c_params("flash_attention.cu", "flash_attention_f32") == len(fa._ARGS)
    assert _c_params("flash_attention_bf16.cu", "flash_attention_bf16") == len(fa._BF16_ARGS)
    assert _c_params("flash_attention_bwd.cu", "flash_attention_bwd_f32") == len(fa._BWD_ARGS)
    assert _c_params("flash_attention_bwd_bf16.cu", "flash_attention_bwd_bf16") \
        == len(fa._BF16_BWD_ARGS)
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    text = (csrc / "flash_attention_bwd.cu").read_text()
    entry = text[text.index("int entry("):]          # the fp32 entry's dispatch by head dim
    assert tuple(int(d) for d in re.findall(r"case (\d+): return launch<", entry)) \
        == fa.BWD_HEAD_DIMS
    assert "bf16" not in (csrc / "flash_attention.cu").read_text().split("#include")[1]
    for source, macro in (("flash_attention_bf16.cu", "FA_BF16"),
                          ("flash_attention_bwd_bf16.cu", "FA_BWD_BF16")):
        text = (csrc / source).read_text()            # the bf16 entries' (q/k, v) instances
        assert tuple((int(a), int(b)) for a, b in re.findall(
            rf"^  {macro}\((\d+), (\d+)\)$", text, re.M)) == fa.BF16_INSTANCES
    lse = torch.zeros(1, 2, 4)
    for d in (64, 256):                                 # 256: gemma3-1b's
        q, kv = torch.zeros(1, 2, 4, d), torch.zeros(1, 1, 4, d)
        for dt in (torch.float32, torch.bfloat16):     # an instance: the device check
            b, c = q.to(dt), kv.to(dt)
            with pytest.raises(ValueError, match="on CUDA"):
                fa.flash_attention_bwd_cuda(b, c, c, b, lse, b, True, None)
    q, kv = torch.zeros(1, 2, 4, 96), torch.zeros(1, 1, 4, 96)
    with pytest.raises(NotPorted, match="head dim 96"):
        fa.flash_attention_bwd_cuda(q, kv, kv, q, lse, q, True, None)
    # MLA's (192, 128): an instance in bf16 only (fp32 pads to 256)
    q, k, v = torch.zeros(1, 2, 4, 192), torch.zeros(1, 1, 4, 192), torch.zeros(1, 1, 4, 128)
    o = torch.zeros(1, 2, 4, 128)
    with pytest.raises(ValueError, match="on CUDA"):
        fa.flash_attention_bwd_cuda(*(t.bfloat16() for t in (q, k, v, o)), lse, o.bfloat16(),
                                    True, None)
    with pytest.raises(NotPorted, match=r"head dim 192 \(v 128\)"):
        fa.flash_attention_bwd_cuda(q, k, v, o, lse, o, True, None)
