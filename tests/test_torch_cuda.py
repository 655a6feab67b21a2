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
amplifies noise on near-zero gradients.
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

INT8_SHAPES = [(1, 1, 1), (3, 7, 127), (4, 7, 640), (1, 6_797, 1024),
               (4, 6_797, 1024), (3, 1, 1024), (4, 6_797, 127), (3, 7, 1)]


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
