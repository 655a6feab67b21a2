"""The port's CUDA kernels and its job on the card (marker ``cuda``).

These tests need an NVIDIA GPU and ``nvcc``: a CUDA kernel has no CPU
mode, so they skip anywhere else.  They import neither JAX nor the
reference, so they also run where only PyTorch is installed; from the
repository root, on a machine with a card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 rtol=atol=1e-6 (the same fp32 products summed in
another order, with FMA contraction); bf16 2e-2 (one bf16 rounding of
the output).  The int8 kernels ``quantize_int8``, ``dequantize_int8``,
``dequant_install`` and ``fedagg_dequant``'s residual are bit-equal to
their plain versions (IEEE division, round half to even, no FMA
contraction), and the quantized values and scales also equal the numpy
int8 rule; ``fedagg_dequant``'s fold ``g`` is within rtol=atol=1e-6
(the sum over sites in another order).  ``trimmed_mean`` (and the median,
f = S) is bit-equal to its plain version, with NaN where it has NaN.  Job losses: rtol 1e-4, with TF32
off on both sides, since sum orders differ and AdamW's first step
amplifies noise on near-zero gradients.  The token kernels:
``flash_attention`` fp32 rtol=atol=1e-5 (a tiled online softmax, its
products as three TF32 products on the tensor cores, against one fp32
softmax over up to 1024 keys), bf16 2e-2; its backward (fp32, D <=
128) rtol 1e-5 and atol 1e-5 of the plain backward's largest value
(sums of up to G * Lq products in another order), bit-equal across two
launches, its bf16 instance within 2^-7 of the plain backward's largest
value (at least 1) on the same bf16 inputs (one bf16 rounding of each
gradient); the scans (out or y,
and the final state) rtol 1e-5 and atol 1e-5 of the plain version's
largest value, since each output sums D or ds terms in another order
(``mamba_scan`` also takes its exp as ``ex2.approx``), and their
backwards (fp32) within the same gate of the plain backwards, bit-equal
across two launches;
served logits card vs CPU rtol=atol=1e-4 (TF32 off), greedy tokens equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import fedagg as fedagg_mod  # noqa: E402
from repro_torch.kernels.ref import fedagg_ref  # noqa: E402

TOL = {torch.float32: dict(rtol=1e-6, atol=1e-6),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s,n", [(1, 1), (3, 127), (4, 6_844_323), (16, 65_537)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fedagg_kernel_matches_plain_on_card(cuda_device, s, n, dtype):
    rng = np.random.default_rng(s * 7 + n)
    w = rng.dirichlet(np.ones(s)).astype(np.float32)
    if s > 1:                       # an inactive site: a zero-weight row
        w[1] = 0.0
        w /= w.sum()
    x = torch.from_numpy(rng.normal(size=(s, n)).astype(np.float32))
    x, w = x.to(cuda_device, dtype), torch.from_numpy(w).to(cuda_device)
    before = build.LAUNCHES.get("fedagg", 0)
    out = fedagg_mod.fedagg(x, w)
    torch.cuda.synchronize()
    assert build.LAUNCHES["fedagg"] == before + 1
    assert out.dtype == dtype and out.shape == (n,) and out.is_cuda
    torch.testing.assert_close(out.float(), fedagg_ref(x, w).float(), **TOL[dtype])


@pytest.mark.cuda
def test_small_job_on_card_matches_cpu_and_launches_the_kernel(cuda_device, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    job = FederatedJob(task=TaskConfig(kind="dose", sites=3, batch=2), rounds=3,
                       max_dropout=1)
    before = build.LAUNCHES.get("fedagg", 0)
    gpu = job.run()
    assert build.LAUNCHES["fedagg"] - before == job.rounds + 1  # + global_model
    cpu = job.replace(device="cpu").run()
    np.testing.assert_allclose(gpu.losses, cpu.losses, rtol=1e-4, atol=1e-6)


# -- the int8 kernels -----------------------------------------------------------

# widths 4 (the narrowest 16-byte row) and 1028 (past the register path's
# 1024); 2 x 20,000 rows take more than one grid-stride pass (33,792 rows)
INT8_SHAPES = [(1, 1, 1), (3, 7, 127), (4, 7, 640), (1, 6_797, 1024),
               (4, 6_797, 1024), (3, 1, 1024), (4, 6_797, 127), (3, 7, 1),
               (3, 7, 4), (2, 20_000, 4), (1, 5, 1028), (4, 6_797, 1028)]


def _int8_inputs(dev, s, rows, c, seed=0):
    """u [S, rows, c] with a zero chunk (the MIN_SCALE floor), weights [S]
    with a zero-weight row, base [S, rows, c]."""
    gen = torch.Generator(device=dev).manual_seed(seed * 131 + rows * 7 + c)
    u = torch.randn(s, rows, c, device=dev, generator=gen) * 0.05
    u[0, 0] = 0.0
    w = torch.rand(s, device=dev, generator=gen)
    if s > 1:
        w[1] = 0.0
    w = w / w.sum()
    base = torch.randn(s, rows, c, device=dev, generator=gen)
    return u, w, base


def _numpy_int8(x: np.ndarray):
    s = np.maximum(np.max(np.abs(x), axis=1) / np.float32(127.0),
                   np.float32(1e-12)).astype(np.float32)
    return np.clip(np.rint(x / s[:, None]), -127, 127).astype(np.int8), s


@pytest.mark.cuda
@pytest.mark.parametrize("s,rows,c", INT8_SHAPES)
def test_quantize_kernels_bit_equal_plain_and_numpy_on_card(cuda_device, s, rows, c):
    u, _, _ = _int8_inputs(cuda_device, s, rows, c)
    x = u.reshape(s * rows, c)
    before = dict(build.LAUNCHES)
    q, sc = ops.quantize_int8(x)
    deq = ops.dequantize_int8(q, sc)
    torch.cuda.synchronize()
    assert build.LAUNCHES["quantize_int8"] == before.get("quantize_int8", 0) + 1
    assert build.LAUNCHES["dequantize_int8"] == before.get("dequantize_int8", 0) + 1
    q_ref, sc_ref = ref.quantize_int8_ref(x)
    assert torch.equal(q, q_ref) and torch.equal(sc, sc_ref)
    assert torch.equal(deq, ref.dequantize_int8_ref(q, sc))
    q_np, sc_np = _numpy_int8(x.cpu().numpy())
    np.testing.assert_array_equal(q.cpu().numpy(), q_np)
    np.testing.assert_array_equal(sc.cpu().numpy(), sc_np)
    assert float(sc[0]) == float(np.float32(1e-12))        # the zero chunk


def _message(rng, sizes, align, head):
    """A payload of int8 leaves (each leaf's q, then its scales) after
    ``head`` bytes, and its leaf table."""
    from repro_torch.comms.compression import chunk_geom
    parts, entries, pos, out = [np.zeros(head, np.uint8)], [], head, 0
    for n in sizes:
        rows, width = chunk_geom(n, 1024, align)
        q = rng.integers(-127, 128, size=rows * width, dtype=np.int8)
        sc = rng.random(rows, dtype=np.float32)
        entries.append((pos, pos + q.nbytes, rows, width, n, out))
        parts += [q.view(np.uint8), sc.view(np.uint8)]
        pos += q.nbytes + sc.nbytes
        out += n
    return np.concatenate(parts), ops.Int8Table.of(entries), out


@pytest.mark.cuda
@pytest.mark.parametrize("align", [1, 128])
@pytest.mark.parametrize("head", [0, 1, 3, 7])
def test_grouped_dequantize_bit_equal_plain_on_card(cuda_device, align, head):
    """One launch decodes every leaf of a message, bit-equal to the plain
    version, at any header length (rows, scales and outputs off alignment)."""
    rng = np.random.default_rng(head)
    buf, table, n = _message(rng, [1, 5, 127, 128, 1025, 3001, 70_000], align, head)
    b = torch.from_numpy(buf).to(cuda_device)
    before = build.LAUNCHES.get("dequantize_int8", 0)
    got = ops.dequantize_int8_grouped(table, b, b, torch.empty(n, device=cuda_device))
    torch.cuda.synchronize()
    assert build.LAUNCHES["dequantize_int8"] == before + 1
    want = ref.dequantize_int8_grouped_ref(torch.from_numpy(table.host), b.cpu(), b.cpu(),
                                           torch.empty(n))
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_small_thread_job_on_card_decodes_each_message_in_one_launch(cuda_device,
                                                                     monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    job = FederatedJob(task=TaskConfig(kind="dose", sites=2, batch=1, volume=(8, 8, 8),
                                       base_filters=4), rounds=2, transport="thread",
                       compression="int8", down_compression="int8")
    build.reset_launches()
    gpu = job.run()
    launched = build.LAUNCHES.get("dequantize_int8", 0)
    cpu = job.replace(device="cpu").run()
    np.testing.assert_allclose(gpu.losses, cpu.losses, rtol=1e-4)
    # round 0: 2 uploads (server decode + site residual); round 1: also 2
    # delta downloads (site decode + server held copy)
    assert launched == 4 + 8


@pytest.mark.cuda
def test_small_robust_socket_job_on_card_runs_the_trimmed_mean_kernel(cuda_device,
                                                                      monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    job = FederatedJob(task=TaskConfig(kind="dose", sites=3, batch=1, volume=(8, 8, 8),
                                       base_filters=4), rounds=2, transport="thread",
                       aggregator="median")
    build.reset_launches()
    gpu = job.run()
    assert build.LAUNCHES.get("trimmed_mean", 0) == job.rounds    # one a round, at the server
    cpu = job.replace(device="cpu").run()
    np.testing.assert_allclose(gpu.losses, cpu.losses, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("s,rows,c", INT8_SHAPES)
def test_fold_and_install_kernels_match_plain_on_card(cuda_device, s, rows, c):
    u, w, base = _int8_inputs(cuda_device, s, rows, c, seed=1)
    q, sc = ops.quantize_int8(u.reshape(s * rows, c))
    q, sc = q.view(s, rows, c), sc.view(s, rows)
    before = dict(build.LAUNCHES)
    g, r = ops.fedagg_dequant(q, sc, u, w)
    inst = ops.dequant_install(q, sc, base)
    torch.cuda.synchronize()
    assert build.LAUNCHES["fedagg_dequant"] == before.get("fedagg_dequant", 0) + 1
    assert build.LAUNCHES["dequant_install"] == before.get("dequant_install", 0) + 1
    g_ref, r_ref = ref.fedagg_dequant_ref(q, sc, u, w)
    assert torch.equal(r, r_ref)
    torch.testing.assert_close(g, g_ref, rtol=1e-6, atol=1e-6)
    assert torch.equal(inst, ref.dequant_install_ref(q, sc, base))


# -- the robust kernel ----------------------------------------------------------

TRIM_SHAPES = [(1, 1), (2, 127), (4, 128), (5, 65_537), (8, 300), (17, 127),
               (33, 300), (64, 65_537), (4, 6_844_323)]


@pytest.mark.cuda
@pytest.mark.parametrize("s,n", TRIM_SHAPES)
def test_trimmed_mean_kernel_bit_equal_plain_on_card(cuda_device, s, n):
    rng = np.random.default_rng(s * 11 + n)
    x = (rng.normal(size=(s, n)) * 3.0).astype(np.float32)
    if n >= 8:                      # non-finite values in active and inactive rows
        x[0, 0], x[s - 1, 1], x[0, 2], x[s // 2, 3] = np.nan, np.inf, -np.inf, np.nan
        x[:, 4] = np.inf
    x = torch.from_numpy(x).to(cuda_device)
    one_off = np.ones(s, np.float32)
    one_off[s // 2] = 0.0
    k1 = np.zeros(s, np.float32)
    k1[-1] = 1.0
    for a in (np.ones(s, np.float32), one_off, k1, np.zeros(s, np.float32)):
        a = torch.from_numpy(a).to(cuda_device)
        for f in sorted({0, 1, 2, s}):
            before = build.LAUNCHES.get("trimmed_mean", 0)
            out = ops.trimmed_mean(x, a, f) if f != s else ops.masked_median(x, a)
            torch.cuda.synchronize()
            assert build.LAUNCHES["trimmed_mean"] == before + 1
            want = ref.trimmed_mean_ref(x, a, f)
            nan = want.isnan()
            assert torch.equal(out.isnan(), nan)
            assert torch.equal(torch.where(nan, 0.0, out).view(torch.int32),
                               torch.where(nan, 0.0, want).view(torch.int32))


@pytest.mark.cuda
def test_small_robust_job_on_card_matches_cpu_and_launches_the_kernel(cuda_device, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    job = FederatedJob(task=TaskConfig(kind="dose", sites=4, batch=2), rounds=3,
                       max_dropout=1, aggregator="trimmed:1", adversary="sign_flip:1")
    before = build.LAUNCHES.get("trimmed_mean", 0)
    gpu = job.run()
    assert build.LAUNCHES["trimmed_mean"] - before == job.rounds
    cpu = job.replace(device="cpu").run()
    np.testing.assert_allclose(gpu.losses, cpu.losses, rtol=1e-4, atol=1e-6)


# -- the token models' kernels -------------------------------------------------

FLASH_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# (b, hq, hkv, lq, lk, d, causal, window): ragged, groups 1, 2, 3, 4 and 8,
# both masks; Lq <= 16 against Lk >= 600 (one block of packed rows), window
# edges inside a 32-key stage
FLASH_SHAPES = [(1, 2, 2, 1, 1, 32, True, None), (2, 4, 2, 37, 37, 32, True, 17),
                (1, 6, 2, 45, 70, 64, True, None), (3, 4, 1, 70, 99, 64, False, None),
                (1, 3, 1, 33, 600, 128, True, 512), (2, 8, 2, 129, 129, 128, False, 17),
                (1, 4, 1, 200, 530, 256, True, 17), (1, 4, 1, 1024, 1024, 256, True, None),
                (1, 9, 3, 50, 50, 64, True, None), (2, 16, 2, 77, 90, 128, True, None),
                (1, 8, 1, 100, 100, 256, True, 64), (1, 4, 1, 16, 640, 256, True, None),
                (2, 8, 1, 9, 700, 64, True, 300), (1, 8, 2, 150, 180, 64, True, 45)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_SHAPES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain_on_card(cuda_device, case, dtype):
    b, hq, hkv, lq, lk, d, causal, window = case
    gen = torch.Generator(device=cuda_device).manual_seed(lq * 7 + lk)
    q = torch.randn(b, hq, lq, d, device=cuda_device, generator=gen).to(dtype)
    k, v = (torch.randn(b, hkv, lk, d, device=cuda_device, generator=gen).to(dtype)
            for _ in range(2))
    before = build.LAUNCHES.get("flash_attention", 0)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = ref.flash_attention_ref(q, k, v, causal, window)
    torch.testing.assert_close(out.float(), want.float(), **FLASH_TOL[dtype])


def _close_scaled(got, want):
    scale = max(float(want.abs().max()) if want.numel() else 0.0, 1.0)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_SHAPES, ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_backward_kernel_matches_plain_on_card(cuda_device, case):
    """The forward's output has a grad_fn on the card; its backward launches
    the backward kernel once, bit-equal across two launches, and holds the
    plain backward within rtol 1e-5, atol 1e-5 of the largest value."""
    b, hq, hkv, lq, lk, d, causal, window = case
    gen = torch.Generator(device=cuda_device).manual_seed(lq * 5 + lk)
    q = torch.randn(b, hq, lq, d, device=cuda_device, generator=gen).requires_grad_()
    k, v = (torch.randn(b, hkv, lk, d, device=cuda_device, generator=gen).requires_grad_()
            for _ in range(2))
    g = torch.randn(b, hq, lq, d, device=cuda_device, generator=gen)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert out.grad_fn is not None
    before = build.LAUNCHES.get("flash_attention_bwd", 0)
    got = torch.autograd.grad(out, (q, k, v), g, retain_graph=True)
    again = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention_bwd"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    o, lse = ref.flash_attention_lse_ref(q.detach(), k.detach(), v.detach(), causal, window)
    want = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), out.detach(),
                                       lse, g, causal, window)
    for a, w in zip(got, want):
        _close_scaled(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_SHAPES, ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_bf16_backward_kernel_matches_plain_on_card(cuda_device, case):
    """The backward's bf16 instance: launched once a gradient, bit-equal
    across two launches, and within one bf16 ulp of the largest value
    (2^-7 of it, or of 1 where that is smaller) of the plain backward on
    the same bf16 inputs, output and lse (the same fp32 arithmetic in
    another order, then one rounding)."""
    b, hq, hkv, lq, lk, d, causal, window = case
    gen = torch.Generator(device=cuda_device).manual_seed(lq * 3 + lk)
    q = torch.randn(b, hq, lq, d, device=cuda_device, generator=gen).bfloat16().requires_grad_()
    k, v = (torch.randn(b, hkv, lk, d, device=cuda_device, generator=gen).bfloat16()
            .requires_grad_() for _ in range(2))
    g = torch.randn(b, hq, lq, d, device=cuda_device, generator=gen).bfloat16()
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    before = build.LAUNCHES.get("flash_attention_bwd", 0)
    got = torch.autograd.grad(out, (q, k, v), g, retain_graph=True)
    again = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention_bwd"] == before + 2
    assert all(a.dtype == torch.bfloat16 and torch.equal(a, b) for a, b in zip(got, again))
    lse = ref.flash_attention_lse_ref(q.detach(), k.detach(), v.detach(), causal, window)[1]
    want = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), out.detach(), lse,
                                       g, causal, window)
    for a, w in zip(got, want):
        # unit-scale inputs: one query against one key gives dq = dk = 0 in
        # exact arithmetic and rounding noise in each, hence the floor of 1
        top = max(float(w.float().abs().max()), 1.0)
        assert float((a.float() - w.float()).abs().max()) <= 2.0 ** -7 * top


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,l,d", [(1, 1, 1, 32), (1, 2, 0, 64), (2, 3, 13, 32),
                                     (1, 5, 77, 64), (2, 40, 45, 32), (1, 64, 100, 32),
                                     (4, 64, 512, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_kernel_matches_plain_on_card(cuda_device, b, h, l, d, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(l * 3 + d)
    r, k, v = (torch.randn(b, h, l, d, device=cuda_device, generator=gen).to(dtype)
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(b, h, l, d, device=cuda_device,
                                         generator=gen) - 5.0)).to(dtype)
    u = torch.randn(h, d, device=cuda_device, generator=gen) * 0.1
    before = build.LAUNCHES.get("rwkv6_scan", 0)
    out, state = ops.rwkv6_scan(r, k, v, w, u)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rwkv6_scan"] == before + 1
    want_out, want_state = ref.rwkv6_scan_ref(r, k, v, w, u)
    _close_scaled(state, want_state)
    if dtype == torch.float32:
        _close_scaled(out, want_out)
    else:
        torch.testing.assert_close(out.float(), want_out.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,di,ds", [(1, 1, 5, 4), (2, 13, 24, 8), (1, 77, 300, 16),
                                       (2, 33, 130, 32), (2, 512, 16384, 16),
                                       (1, 16, 100, 4), (2, 48, 36, 8), (1, 70, 68, 32),
                                       (2, 100, 4100, 16), (1, 45, 77, 5), (2, 0, 64, 16)])
def test_mamba_scan_kernel_matches_plain_on_card(cuda_device, b, l, di, ds):
    """Every threads-a-channel instance (d_state 4, 8, 16, 32), 16-byte and
    4-byte copies (d_inner and d_state multiples of 4 or not), d_inner past
    a block's channels, L = 0 and L not a multiple of the 16-step stage; a
    row of A for each channel, so reading another channel's row fails."""
    gen = torch.Generator(device=cuda_device).manual_seed(l + di + ds)
    dt = torch.nn.functional.softplus(
        torch.randn(b, l, di, device=cuda_device, generator=gen) - 3.0)
    bm, cm = (torch.randn(b, l, ds, device=cuda_device, generator=gen) for _ in range(2))
    x = torch.randn(b, l, di, device=cuda_device, generator=gen)
    log_a = torch.log(torch.arange(1, ds + 1, device=cuda_device,
                                   dtype=torch.float32)).expand(di, ds)
    log_a = (log_a + 0.1 * torch.randn(di, ds, device=cuda_device, generator=gen)).contiguous()
    before = build.LAUNCHES.get("mamba_scan", 0)
    y, state = ops.mamba_scan(dt, bm, cm, x, log_a)
    torch.cuda.synchronize()
    assert build.LAUNCHES["mamba_scan"] == before + 1
    want_y, want_state = ref.mamba_scan_ref(dt, bm, cm, x, log_a)
    _close_scaled(y, want_y)
    _close_scaled(state, want_state)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-1b", "rwkv6-7b", "jamba-1.5-large-398b"])
def test_small_generate_on_card_matches_cpu_and_launches_the_kernels(cuda_device, arch,
                                                                     monkeypatch):
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_arch(arch).reduced()
    gen = torch.Generator().manual_seed(11)
    params = T.init(gen, cfg, "cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 20), generator=gen)
    cpu = serve.generate(params, prompts, cfg, 5)
    gpu = serve.generate(tree_map(lambda t: t.to(cuda_device), params),
                         prompts.to(cuda_device), cfg, 5)
    assert sum(gpu["prefill_launches"].values()) == cfg.num_layers
    assert gpu["decode_launches"] == {}
    assert torch.equal(gpu["tokens"].cpu(), cpu["tokens"])
    torch.testing.assert_close(gpu["logits"].cpu(), cpu["logits"], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,l,d,shift", [(1, 1, 1, 32, -5.0), (2, 3, 13, 32, 3.0),
                                           (1, 5, 77, 64, -9.0), (2, 4, 32, 64, -5.0),
                                           (1, 2, 0, 64, -5.0), (2, 64, 300, 64, -5.0),
                                           (2, 64, 1024, 64, -5.0)])
def test_rwkv6_scan_backward_kernel_matches_plain_on_card(cuda_device, b, h, l, d, shift):
    """The forward's output has a grad_fn on the card; its backward launches
    the backward kernel once, bit-equal across two launches, and holds the
    plain backward (u's gradient summed over the batch rows) within rtol
    1e-5, atol 1e-5 of the largest value, with a final-state gradient; w
    near 0 (shift 3), in between and near 1 (shift -9)."""
    gen = torch.Generator(device=cuda_device).manual_seed(l * 3 + d + h)
    r, k, v = (torch.randn(b, h, l, d, device=cuda_device, generator=gen).requires_grad_()
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(b, h, l, d, device=cuda_device, generator=gen)
                             + shift)).requires_grad_()
    u = (torch.randn(h, d, device=cuda_device, generator=gen) * 0.5).requires_grad_()
    g = torch.randn(b, h, l, d, device=cuda_device, generator=gen)
    gs = torch.randn(b, h, d, d, device=cuda_device, generator=gen)
    out, state = ops.rwkv6_scan(r, k, v, w, u)
    assert out.grad_fn is not None
    leaves = (r, k, v, w, u)
    before = build.LAUNCHES.get("rwkv6_scan_bwd", 0)
    got = torch.autograd.grad((out, state), leaves, (g, gs), retain_graph=True)
    again = torch.autograd.grad((out, state), leaves, (g, gs))
    torch.cuda.synchronize()
    assert build.LAUNCHES["rwkv6_scan_bwd"] == before + 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = ref.rwkv6_scan_bwd_ref(*(t.detach() for t in leaves), g, gs)
    for x, y in zip(got, want):
        _close_scaled(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,di,ds,shift", [(1, 1, 5, 1, -3.0), (2, 13, 24, 8, -3.0),
                                             (1, 77, 300, 16, 4.0), (2, 33, 130, 32, 4.0),
                                             (1, 45, 77, 5, -3.0), (2, 0, 64, 16, -3.0),
                                             (2, 512, 16384, 16, -3.0)])
def test_mamba_scan_backward_kernel_matches_plain_on_card(cuda_device, b, l, di, ds, shift):
    """The selective scan's backward on the card: launched once a backward,
    bit-equal across two launches, within rtol 1e-5, atol 1e-5 of the
    plain backward's largest value at every d_state instance, with a
    final-state gradient and (shift 4) decays that underflow to 0."""
    gen = torch.Generator(device=cuda_device).manual_seed(l + di + ds)
    dt = torch.nn.functional.softplus(
        torch.randn(b, l, di, device=cuda_device, generator=gen) + shift).requires_grad_()
    bm, cm = (torch.randn(b, l, ds, device=cuda_device, generator=gen).requires_grad_()
              for _ in range(2))
    x = torch.randn(b, l, di, device=cuda_device, generator=gen).requires_grad_()
    log_a = torch.log(torch.arange(1, ds + 1, device=cuda_device,
                                   dtype=torch.float32)).expand(di, ds)
    log_a = (log_a + 0.1 * torch.randn(di, ds, device=cuda_device, generator=gen)
             ).contiguous().requires_grad_()
    g = torch.randn(b, l, di, device=cuda_device, generator=gen)
    gs = torch.randn(b, di, ds, device=cuda_device, generator=gen)
    y, state = ops.mamba_scan(dt, bm, cm, x, log_a)
    assert y.grad_fn is not None
    leaves = (dt, bm, cm, x, log_a)
    before = build.LAUNCHES.get("mamba_scan_bwd", 0)
    got = torch.autograd.grad((y, state), leaves, (g, gs), retain_graph=True)
    again = torch.autograd.grad((y, state), leaves, (g, gs))
    torch.cuda.synchronize()
    assert build.LAUNCHES["mamba_scan_bwd"] == before + 2
    assert all(torch.equal(p, q) for p, q in zip(got, again))
    want = ref.mamba_scan_bwd_ref(*(t.detach() for t in leaves), g, gs)
    for p, q in zip(got, want):
        _close_scaled(p, q)


@pytest.mark.cuda
def test_threefry_stream_on_card_matches_cpu(cuda_device):
    """The DP noise stream drawn on the card: the key chain, the bits and
    the uniforms bit-equal to the CPU's, the normals within 4 ulp."""
    from repro_torch.core import prng
    from repro_torch.privacy import dp
    cfg = dp.DPConfig(clip=0.5, noise_multiplier=0.8)
    key = dp.site_step_key(dp.round_key(cfg, 3), 2, 0)
    gpu_key = key.to(cuda_device)
    assert torch.equal(prng.split(gpu_key, 7).cpu(), prng.split(key, 7))
    assert torch.equal(prng.bits(gpu_key, (1001,)).cpu(), prng.bits(key, (1001,)))
    assert torch.equal(prng.uniform(gpu_key, (1001,)).cpu(), prng.uniform(key, (1001,)))
    a = prng.normal(gpu_key, (1 << 16,)).cpu().view(torch.int32).long()
    b = prng.normal(key, (1 << 16,)).view(torch.int32).long()
    assert int((a - b).abs().max()) <= 4
