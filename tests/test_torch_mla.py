"""DeepSeek-V2's Multi-head Latent Attention against the JAX reference.

The reduced deepseek-v2-236b config (4 heads, q/k head dim 16 + 8 of
rope, v head dim 16, kv_lora 32), the reference's ``mla_init`` carried
into the port by ``convert.from_reference``, the same numpy inputs
through both:

- ``mla_apply`` at L = 24 (the reference's L^2 ``sdpa``) and at L = 1024
  (its online-softmax ``sdpa_blockwise``), output and every cache leaf;
- 3 ``mla_decode`` steps after a prefill, the absorbed latent-space form;
- the padded route to the flash kernel (q/k 24 and v 16 padded to the
  kernel's D 32 instance at the kernel's scale argument ``24 ** -0.5``) against the
  port's unpadded ``sdpa`` at scale ``24 ** -0.5``, forward and gradient,
  and at the full width's (192, 128) -> 256;
- in bf16 the route sends MLA's own (192, 128) head dims to the bf16
  kernels' instance unpadded: the plain versions there against the padded
  route's in fp32 on the same bf16-valued inputs (1e-6 relative), and a
  bf16 attention step (output and vjp) against ``jax.vjp`` of the
  reference's bf16 ``sdpa``;
- the MLA backward instance ``check_backward_instances`` asks for, and a
  full-width deepseek token job accepted on the card from its config;
- one reduced deepseek FedAvg token job (2 sites, 2 rounds, seq 16)
  against the JAX job: per-site losses rtol 1e-4, ``comm`` equal, the
  global within ``lr * rounds`` with its median element within 1e-6
  (``_torch_jax_helpers.hold_job_to_jax``, the token jobs' gate), and
  every element of the global within rtol = atol = 1e-4 (3.8e-5 apart at
  most on an 8-core CPU).

On the CPU the flash kernel takes its plain version.  Tolerances: rtol =
atol = 1e-4 against the reference (the same fp32 function, sums in other
orders), 1e-5 between the port's two routes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from _torch_jax_helpers import hold_job_to_jax  # noqa: E402

from repro.api import FederatedJob as JJob  # noqa: E402
from repro.api import TaskConfig as JTask  # noqa: E402
from repro.configs.registry import get_arch as jax_get_arch  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch import NotPorted, convert  # noqa: E402
from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.configs.base import MLAConfig  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import padded_head_dim  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ROUTE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _setup(seed=0):
    jcfg = jax_get_arch("deepseek-v2-236b").reduced()
    cfg = get_arch("deepseek-v2-236b").reduced()
    jparams = jax.tree.map(np.asarray, jax.jit(JA.mla_init, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg))
    return jcfg, cfg, jparams, convert.from_reference(jparams)


# the reference's functions jitted (one compile each, not one a primitive)
_jit_apply = jax.jit(lambda p, x, cfg, cap: JA.mla_apply(p, x, cfg, return_cache=True,
                                                         cache_len=cap),
                     static_argnums=(2, 3))
_jit_decode = jax.jit(JA.mla_decode, static_argnums=3)


def _close_tree(got, want, where):
    assert sorted(got) == sorted(want), where
    for k in want:
        w = np.asarray(want[k])
        g = got[k].detach().numpy()
        assert g.shape == w.shape and str(got[k].dtype) == f"torch.{w.dtype}", (where, k)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=f"{where}/{k}")
        else:
            np.testing.assert_allclose(g, w, err_msg=f"{where}/{k}", **TOL)


def test_mla_init_has_the_reference_tree():
    jcfg, cfg, jparams, _ = _setup()
    params = A.mla_init(torch.Generator().manual_seed(0), cfg, "cpu")
    assert sorted(params) == sorted(jparams)
    for k in jparams:
        assert tuple(params[k].shape) == jparams[k].shape, k


@pytest.mark.parametrize("length", [24, 1024])
def test_mla_apply_and_its_cache_match_the_reference(length):
    """L 24 takes the reference's sdpa, L 1024 its sdpa_blockwise."""
    jcfg, cfg, jparams, params = _setup()
    b = 2 if length < 1024 else 1
    x = np.random.default_rng(length).standard_normal((b, length, cfg.d_model)).astype(
        np.float32)
    cap = length + 3
    jy, jcache = _jit_apply(jparams, x, jcfg, cap)
    y, cache = A.mla_apply(params, torch.from_numpy(x), cfg, return_cache=True, cache_len=cap)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    _close_tree(cache, jcache, f"L={length} cache")
    assert A.mla_apply(params, torch.from_numpy(x), cfg)[1] is None


def test_three_mla_decode_steps_match_the_reference():
    jcfg, cfg, jparams, params = _setup(1)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    _, jcache = _jit_apply(jparams, x, jcfg, 12)
    _, cache = A.mla_apply(params, torch.from_numpy(x), cfg, return_cache=True, cache_len=12)
    for step in range(3):
        xs = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jcache = _jit_decode(jparams, xs, jcache, jcfg)
        y, cache = A.mla_decode(params, torch.from_numpy(xs), cache, cfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), err_msg=f"step {step}", **TOL)
        _close_tree(cache, jcache, f"step {step}")
    assert int(cache["index"]) == 12


@pytest.mark.parametrize("mla,heads,length", [
    pytest.param(get_arch("deepseek-v2-236b").reduced().mla, 4, 40, id="reduced-d32"),
    pytest.param(get_arch("deepseek-v2-236b").CONFIG.mla, 2, 20, id="full-d256"),
])
def test_the_padded_route_is_the_unpadded_attention(mla, heads, length):
    """Through the flash kernel's padded instance (its plain version on
    the CPU) and the port's unpadded sdpa at scale qk_head_dim ** -0.5:
    the outputs and the gradients of q, k and v."""
    gen = torch.Generator().manual_seed(heads)
    shape = (2, length, heads)
    q, k = (torch.randn(shape + (mla.qk_head_dim,), generator=gen).requires_grad_()
            for _ in range(2))
    v = torch.randn(shape + (mla.v_head_dim,), generator=gen).requires_grad_()
    g = torch.randn(shape + (mla.v_head_dim,), generator=gen)
    out = A._padded_attention(q, k, v, mla)
    want = A.sdpa(q, k, v, A.causal_mask(length, length), scale=mla.qk_head_dim ** -0.5)
    torch.testing.assert_close(out, want, **ROUTE_TOL)
    got = torch.autograd.grad(out, (q, k, v), g)
    ref = torch.autograd.grad(want, (q, k, v), g)
    for name, a, w in zip("qkv", got, ref):
        torch.testing.assert_close(a, w, **ROUTE_TOL, msg=f"d{name}")


def test_the_unpadded_plain_versions_are_the_padded_route():
    """The plain versions at MLA's own head dims (q/k 192, v 128: the bf16
    kernels' instance) against the padded route's (the D 256 instance) on
    the same bf16-valued inputs, in fp32 (the arithmetic both round from):
    output, lse and the three gradients within 1e-6 relative."""
    gen = torch.Generator().manual_seed(31)
    b, h, l, scale = 1, 2, 40, 192 ** -0.5

    def draw(d):
        return torch.randn(b, h, l, d, generator=gen).bfloat16().float()
    q, k, v, g = draw(192), draw(192), draw(128), draw(128)

    def pad(t):
        return torch.nn.functional.pad(t, (0, 256 - t.shape[-1]))

    def close(got, want, what):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()),
                                   msg=lambda m: f"{what}: {m}")
    out, lse = ref.flash_attention_lse_ref(q, k, v, True, None, scale)
    pout, plse = ref.flash_attention_lse_ref(pad(q), pad(k), pad(v), True, None, scale)
    close(out, pout[..., :128], "out")
    close(lse, plse, "lse")
    got = ref.flash_attention_bwd_ref(q, k, v, out, lse, g, True, None, scale)
    want = ref.flash_attention_bwd_ref(pad(q), pad(k), pad(v), pout, plse, pad(g), True, None,
                                       scale)
    for name, a, w, n in zip(("dq", "dk", "dv"), got, want, (192, 192, 128)):
        assert a.shape[-1] == n
        close(a, w[..., :n], name)


def test_a_bf16_mla_step_takes_the_unpadded_route_and_matches_jax(monkeypatch):
    """bf16 q, k, v at DeepSeek-V2's head dims through ``_padded_attention``
    take the bf16 kernels' own instance, unpadded (on the CPU its plain
    version), and the output and its vjp (dq, dk, dv) match ``jax.vjp``
    of the reference's bf16 ``sdpa`` at scale 192^-0.5 under the gate
    tests/test_torch_precision.py holds the plain bf16 attention to: the
    output within two bf16 units (2^-7) of each value, each gradient within
    two of its largest value (delta is taken from the bf16 output, as the
    kernel takes it, where the reference's is exact in fp32)."""
    mla = get_arch("deepseek-v2-236b").CONFIG.mla
    assert fa.native_instance(torch.bfloat16, mla.qk_head_dim, mla.v_head_dim)
    assert not fa.native_instance(torch.float32, mla.qk_head_dim, mla.v_head_dim)
    rng = np.random.default_rng(31)
    b, l, h = 1, 24, 2
    qn, kn = (rng.standard_normal((b, l, h, mla.qk_head_dim)).astype(np.float32)
              for _ in range(2))
    vn, gn = (rng.standard_normal((b, l, h, mla.v_head_dim)).astype(np.float32)
              for _ in range(2))
    scale = mla.qk_head_dim ** -0.5
    jq, jk, jv, jg = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (qn, kn, vn, gn))

    def fwd_bwd(q, k, v, g):                    # one compile, not one a primitive
        out, pull = jax.vjp(lambda *a: JA.sdpa(*a, JA.causal_mask(l, l), scale=scale), q, k, v)
        return (out, *pull(g))
    want = jax.jit(fwd_bwd)(jq, jk, jv, jg)
    q, k, v = (torch.from_numpy(x).bfloat16().requires_grad_() for x in (qn, kn, vn))
    calls, real = [], A.flash_attention
    monkeypatch.setattr(A, "flash_attention", lambda *a, **kw: calls.append(
        tuple(t.shape for t in a)) or real(*a, **kw))
    out = A._padded_attention(q, k, v, mla)
    assert calls == [((b, h, l, 192), (b, h, l, 192), (b, h, l, 128))]     # unpadded
    got = (out, *torch.autograd.grad(out, (q, k, v), torch.from_numpy(gn).bfloat16()))
    for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and str(w.dtype) == "bfloat16", name
        w = np.asarray(w.astype(jnp.float32))
        a = a.detach().float().numpy()
        if name == "out":
            np.testing.assert_allclose(a, w, rtol=2.0 ** -7, atol=0)
        else:
            assert np.abs(a - w).max() <= 2.0 ** -7 * np.abs(w).max(), name


def test_the_padded_width_and_its_backward_instance(monkeypatch):
    for cfg, d in ((get_arch("deepseek-v2-236b").CONFIG, 256),
                   (get_arch("deepseek-v2-236b").reduced(), 32)):
        assert padded_head_dim(max(cfg.mla.qk_head_dim, cfg.mla.v_head_dim)) == d
    wide = MLAConfig(qk_nope_head_dim=256, qk_rope_head_dim=64, v_head_dim=128)
    q = torch.zeros(1, 2, 1, wide.qk_head_dim)
    with pytest.raises(NotPorted) as err:
        A._padded_attention(q, q, torch.zeros(1, 2, 1, wide.v_head_dim), wide)
    assert err.value.seam == "flash_attention" and "head dim 320" in str(err.value)
    full = get_arch("deepseek-v2-236b").CONFIG
    assert full.resolved_head_dim == 128          # the v head dim, as the reference's
    ops.check_backward_instances(full)            # asks for the fp32 D 256 instance
    ops.check_backward_instances(full, torch.bfloat16)     # and the bf16 (192, 128) one
    with pytest.raises(NotPorted) as err:
        ops.check_backward_instances(full, torch.float16)
    assert err.value.seam == "flash_attention_bwd" and "head dim 256" in str(err.value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    FederatedJob(task=TaskConfig(kind="tokens", arch="deepseek-v2-236b", reduced=False),
                 device="cuda").check_ported()


def test_a_deepseek_token_job_matches_the_reference():
    task = dict(kind="tokens", arch="deepseek-v2-236b", sites=2, batch=2, seq=16)
    jjob = JJob(task=JTask(**task), rounds=2, seed=0)
    jres = jjob.run()
    job = FederatedJob(task=TaskConfig(**task), rounds=2, seed=0, device="cpu")
    tres = hold_job_to_jax(job, jjob, jres)
    want = jax.tree.leaves(jax.tree.map(np.asarray, jres.global_params))
    for got, w in zip(jax.tree.leaves(convert.to_reference(tres.global_params)), want):
        np.testing.assert_allclose(got, w, **TOL)
