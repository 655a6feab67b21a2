"""The port's ``fedagg`` against the JAX reference kernel and its oracle,
and what every kernel wrapper refuses.  (The int8 kernels' plain versions
are held to the reference in ``tests/test_torch_compression.py``.)

On the CPU the port's wrapper takes its plain version; the JAX kernel
runs under the Pallas interpreter, as the reference's own tests run it.
The CUDA kernel itself is held to the plain version on the card by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import fedagg_ref as jax_fedagg_ref  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import fedagg as fedagg_mod  # noqa: E402
from repro_torch.kernels.ref import fedagg_ref  # noqa: E402

# fp32: the same fp32 products summed in another order -> a few ulps.
# bf16: both sides round one fp32 sum to bf16; an ulp of bf16 is 2**-8.
TOL = {"float32": dict(rtol=1e-6, atol=1e-6), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(s, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(s, n)).astype(np.float32)
    w = rng.dirichlet(np.ones(s)).astype(np.float32)
    if s > 1:                       # an inactive site: a zero-weight row
        w[1] = 0.0
        w /= w.sum()
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    # torch gets exactly the values JAX holds (bf16 rounded once, by JAX)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    return jx, tx, w


@pytest.mark.parametrize("s,n", [(1, 1), (3, 127), (4, 1000), (16, 65_537)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fedagg_matches_reference_kernel_and_oracle(s, n, dtype):
    jx, tx, w = _inputs(s, n, dtype, seed=s * 7 + n)
    out = ops.fedagg(tx, torch.from_numpy(w))
    assert out.dtype == tx.dtype and out.shape == (n,)
    got = out.float().numpy()
    kern = np.asarray(jops.fedagg(jx, jnp.asarray(w), interpret=True).astype(jnp.float32))
    oracle = np.asarray(jax_fedagg_ref(jx, jnp.asarray(w)).astype(jnp.float32))
    np.testing.assert_allclose(got, kern, **TOL[dtype])
    np.testing.assert_allclose(got, oracle, **TOL[dtype])


def test_fedagg_cpu_takes_plain_version_without_launching():
    _, tx, w = _inputs(3, 4096, "float32")
    before = dict(build.LAUNCHES)
    out = ops.fedagg(tx, torch.from_numpy(w))
    assert torch.equal(out, fedagg_ref(tx, torch.from_numpy(w)))
    assert build.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "weights_dtype", "weights_shape", "rank"])
def test_fedagg_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros(3, 8)
    w = torch.full((3,), 1 / 3)
    if bad == "dtype":
        x = x.double()
    elif bad == "weights_dtype":
        w = w.double()
    elif bad == "weights_shape":
        w = w[:2]
    else:
        x = x[0]
    with pytest.raises((TypeError, ValueError)):
        ops.fedagg(x, w)


def test_fedagg_cuda_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        fedagg_mod.fedagg_cuda(torch.zeros(2, 4), torch.full((2,), 0.5))



# -- the int8 kernels' wrappers -------------------------------------------------

def _int8_args(s=2, rows=3, c=5):
    q = torch.zeros(s, rows, c, dtype=torch.int8)
    sc = torch.ones(s, rows)
    return q, sc, torch.zeros(s, rows, c), torch.full((s,), 1 / s)


@pytest.mark.parametrize("bad", ["x_dtype", "x_rank", "q_dtype", "scales_shape",
                                 "dense_shape", "weights_shape"])
def test_int8_wrappers_reject_what_the_kernels_do_not_take(bad):
    q, sc, u, w = _int8_args()
    with pytest.raises((TypeError, ValueError)):
        if bad == "x_dtype":
            ops.quantize_int8(u[0].double())
        elif bad == "x_rank":
            ops.quantize_int8(u)
        elif bad == "q_dtype":
            ops.dequantize_int8(q[0].int(), sc[0])
        elif bad == "scales_shape":
            ops.dequant_install(q, sc[:, :2], u)
        elif bad == "dense_shape":
            ops.fedagg_dequant(q, sc, u[:, :2], w)
        else:
            ops.fedagg_dequant(q, sc, u, w[:1])


@pytest.mark.parametrize("name", ["quantize_int8_cuda", "dequantize_int8_cuda",
                                  "fedagg_dequant_cuda", "dequant_install_cuda"])
def test_int8_cuda_wrappers_refuse_cpu_tensors(name):
    from repro_torch.kernels import quantize as quantize_mod
    q, sc, u, w = _int8_args()
    args = {"quantize_int8_cuda": (u[0],), "dequantize_int8_cuda": (q[0], sc[0]),
            "fedagg_dequant_cuda": (q, sc, u, w), "dequant_install_cuda": (q, sc, u)}[name]
    fn = getattr(quantize_mod, name, None) or getattr(fedagg_mod, name)
    before = dict(build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args)
    assert build.LAUNCHES == before
