"""The reference's precision policy in the port, against the JAX package.

- The configs: ``precision_for`` and ``mesh_for`` (single and multi-pod)
  of every architecture at every shape, ``INPUT_SHAPES``,
  ``MeshConfig.for_sites`` and ``is_skipped``, field for field.
- The optimizers in bf16: ``adamw`` with bf16 moments and a schedule for
  its learning rate, ``sgd`` with bf16 momentum, 4 steps on the same
  numpy gradients and parameters; the schedules' values.  The moments may
  differ by one bf16 ulp (an fp32 sum a rounding boundary apart), the
  updates by fp32 rounding: rtol 2^-7 and 1e-5.
- The plain bf16 attention backward (the CPU path of the kernel's bf16
  instance, and its oracle on the card) against ``jax.vjp`` of the
  reference's ``sdpa`` in bf16 at head dims 32, 64, 128 and 256: the
  outputs within one bf16 ulp (a few elements round the other way).  The
  reference differentiates its fp32 arithmetic exactly; the port's delta
  is ``rowsum(dout * out)`` of the bf16 ``out`` the forward wrote, which
  moves each gradient by up to 1.44 units of ``2^-8 * max|gradient|`` on
  these inputs: the gate is two such units, one bf16 ulp of the largest
  |gradient|.  The CUDA instance against the plain version carries the
  ``cuda`` marker and lives in ``test_torch_cuda.py`` (the card's machine
  has no JAX).
- bf16 serving of one reduced config a mixer family (gemma3-1b,
  DeepSeek-V2's MLA, rwkv6-7b, Jamba's Mamba and MoE, musicgen's
  codebooks): prefill and 2 decode steps of the same bf16 weights (the
  reference's ``T.init(dtype=bfloat16)``, carried across) on the same
  prompts.  The bound is measured, not chosen: the distance between the
  reference's own bf16 run and its fp32 run on the same bf16-valued
  weights; the port's bf16 logits lie no farther than twice that from
  the reference's bf16 logits, and the greedy tokens are equal wherever
  the reference's top-two margin exceeds that bound.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base, registry  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.optim import schedules  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402

EPS = 2.0 ** -8            # bf16's unit roundoff: half an ulp (7 stored mantissa bits)


def _fields(x):
    return dataclasses.asdict(x)


@pytest.mark.parametrize("arch_id", list(jreg.ARCH_IDS))
def test_precision_and_mesh_policies_match_the_reference(arch_id):
    mine, theirs = registry.get_arch(arch_id), jreg.get_arch(arch_id)
    for name, shape in jbase.INPUT_SHAPES.items():
        port_shape = base.INPUT_SHAPES[name]
        assert _fields(port_shape) == _fields(shape) and port_shape.is_decode == shape.is_decode
        assert _fields(mine.precision_for(port_shape)) == _fields(theirs.precision_for(shape))
        for multi_pod in (False, True):
            got, want = mine.mesh_for(port_shape, multi_pod), theirs.mesh_for(shape, multi_pod)
            assert _fields(got) == _fields(want)
            assert (got.total_sites, got.total_devices) == (want.total_sites,
                                                            want.total_devices)
        assert registry.is_skipped(arch_id, name) == jreg.is_skipped(arch_id, name)
    assert sorted(base.INPUT_SHAPES) == sorted(jbase.INPUT_SHAPES)
    assert registry.LONG_500K_SKIPS == jreg.LONG_500K_SKIPS
    assert registry.SHAPE_SKIPS == jreg.SHAPE_SKIPS
    for sites in (1, 3, 4, 16, 32):
        assert _fields(base.MeshConfig.for_sites(sites)) == \
            _fields(jbase.MeshConfig.for_sites(sites))
    for policy in ("mixed", "bf16_train"):
        assert _fields(getattr(base.PrecisionConfig, policy)()) == \
            _fields(getattr(jbase.PrecisionConfig, policy)())


def _grads(rng, shapes, steps):
    return [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(steps)]


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_bf16_optimizer_state_matches_the_reference(kind):
    rng = np.random.default_rng(7)
    shapes = [(5, 3), (7,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = _grads(rng, shapes, 4)
    if kind == "adamw":
        make = lambda lib, sched, dt: lib.adamw(sched(1e-2, 2, 6), weight_decay=0.01,
                                                 state_dtype=dt)
        keys = ("mu", "nu")
    else:
        make = lambda lib, sched, dt: lib.sgd(sched(1e-2, 2, 6), momentum=0.9, state_dtype=dt)
        keys = ("mom",)
    jo = make(jopt, jsched.linear_warmup_cosine, jnp.bfloat16)
    to = make(opt, schedules.linear_warmup_cosine, torch.bfloat16)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p) for p in params]
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        ju, js = jo.update([jnp.asarray(x) for x in g], js, jp)
        tu, ts = to.update([torch.from_numpy(x) for x in g], ts, tp)
        for a, b in zip(tu, ju):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-9)
        jp = jopt.apply_updates(jp, ju)
        tp = opt.apply_updates(tp, tu)
    assert int(ts["step"]) == int(js["step"]) == len(grads)
    for key in keys:
        for a, b in zip(ts[key], js[key]):
            assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
            np.testing.assert_allclose(a.float().numpy(), np.asarray(b.astype(jnp.float32)),
                                       rtol=2 * EPS, atol=1e-12)


def test_schedules_match_the_reference():
    steps = np.arange(0, 25, dtype=np.int32)
    for mine, theirs in ((schedules.cosine_schedule(3e-4, 20), jsched.cosine_schedule(3e-4, 20)),
                         (schedules.linear_warmup_cosine(1e-3, 5, 20, 0.05),
                          jsched.linear_warmup_cosine(1e-3, 5, 20, 0.05))):
        got = mine(torch.from_numpy(steps)).numpy()
        want = np.asarray(theirs(jnp.asarray(steps)))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# (batch, q heads, kv heads, length, head dim, window)
BWD_CASES = {32: (2, 3, 1, 40, 32, None), 64: (1, 4, 2, 64, 64, 16),
             128: (1, 2, 1, 48, 128, None), 256: (1, 4, 1, 64, 256, 24)}


def _bwd_inputs(d):
    b, hq, hkv, l, _, window = BWD_CASES[d]
    rng = np.random.default_rng(d)
    q, do = (rng.standard_normal((b, l, hq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, l, hkv, d)).astype(np.float32) for _ in range(2))
    return [jnp.asarray(x.astype(jnp.bfloat16)) for x in (q, k, v, do)], window


def _heads_first(x):
    return torch.from_numpy(np.asarray(x).astype(np.float32)).bfloat16() \
        .transpose(1, 2).contiguous()


@pytest.mark.parametrize("d", sorted(BWD_CASES))
def test_the_plain_bf16_attention_backward_matches_jax(d):
    (jq, jk, jv, jdo), window = _bwd_inputs(d)
    lq = jq.shape[1]

    def fwd_bwd(q, k, v, do):                   # one compile, not one a primitive
        o, pull = jax.vjp(lambda *a: jattn.sdpa(*a, jattn.causal_mask(lq, lq, window)),
                          q, k, v)
        return o, pull(do)
    out, grads = jax.jit(fwd_bwd)(jq, jk, jv, jdo)
    want = [np.asarray(g).astype(np.float32) for g in grads]
    q, k, v = (_heads_first(x).requires_grad_() for x in (jq, jk, jv))
    o = fa.flash_attention(q, k, v, causal=True, window=window)
    assert o.dtype == torch.bfloat16 and o.grad_fn is not None
    np.testing.assert_allclose(o.detach().float().transpose(1, 2).numpy(),
                               np.asarray(out).astype(np.float32), rtol=2 * EPS, atol=0)
    got = torch.autograd.grad(o, (q, k, v), _heads_first(jdo))
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16, name
        gate = 2 * EPS * np.abs(w).max()
        err = np.abs(g.float().transpose(1, 2).numpy() - w).max()
        assert err <= gate, (name, d, err, gate)


# one reduced config a mixer family
SERVE_ARCHS = ["gemma3-1b", "deepseek-v2-236b", "rwkv6-7b", "jamba-1.5-large-398b",
               "musicgen-medium"]
PROMPT, STEPS = 20, 3


def _f32(tree):
    """numpy fp32 leaves (a bf16 leaf widened by numpy: no XLA compile)."""
    return jax.tree.map(lambda x: np.asarray(x).astype(np.float32), tree)


def _port_params(jparams):
    """The reference's tree (bf16 and fp32 leaves) carried into the port
    leaf by leaf, each leaf in its own dtype."""
    dts = [x.dtype for x in jax.tree.leaves(jparams)]
    tp = convert.from_reference(_f32(jparams))
    return tree_unflatten(tp, [t.bfloat16() if dt == jnp.bfloat16 else t
                               for t, dt in zip(tree_leaves(tp), dts)])


@functools.lru_cache(maxsize=None)
def _jax_serve(arch):
    """The reference's bf16 run and its fp32 run on the same bf16-valued
    weights: each step's logits (numpy fp32), and its bf16 tokens."""
    jcfg = jreg.get_arch(arch).reduced()
    p16 = jax.jit(lambda k: JT.init(k, jcfg, dtype=jnp.bfloat16))(jax.random.PRNGKey(3))
    rng = np.random.default_rng(sum(map(ord, arch)))
    shape = (2, PROMPT) + ((jcfg.num_codebooks,) if jcfg.num_codebooks > 1 else ())
    prompts = rng.integers(0, jcfg.vocab_size, size=shape).astype(np.int32)
    cap = PROMPT + STEPS
    pre = jax.jit(lambda p, t: JT.prefill(p, t, jcfg, cache_capacity=cap))
    dec = jax.jit(lambda p, t, c: JT.decode_step(p, t, c, jcfg))

    def run(params, tokens):
        logits, caches = pre(params, prompts)
        out = [np.asarray(logits)]
        for t in tokens:
            logits, caches = dec(params, t, caches)
            out.append(np.asarray(logits))
        return out

    logits16, toks = [], []
    logits, caches = pre(p16, prompts)
    logits16.append(np.asarray(logits))
    for _ in range(STEPS - 1):
        toks.append(np.asarray(logits[:, -1:].argmax(-1), np.int32))
        logits, caches = dec(p16, toks[-1], caches)
        logits16.append(np.asarray(logits))
    logits32 = run(_f32(p16), toks)
    return p16, prompts, toks, logits16, logits32


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_bf16_serving_matches_the_reference(arch):
    p16, prompts, toks, want16, want32 = _jax_serve(arch)
    cfg = registry.get_arch(arch).reduced()
    params = _port_params(p16)
    assert {t.dtype for t in tree_leaves(params)} <= {torch.bfloat16, torch.float32}
    logits, caches = T.prefill(params, torch.from_numpy(prompts).long(), cfg,
                               cache_capacity=PROMPT + STEPS)
    got = [logits]
    for t in toks:                       # the reference's tokens, so both runs see the same
        logits, caches = T.decode_step(params, torch.from_numpy(t).long(), caches, cfg)
        got.append(logits)
    for i, (g, w16, w32) in enumerate(zip(got, want16, want32)):
        assert g.dtype == torch.float32  # the logits in fp32
        bound = 2 * float(np.abs(w16 - w32).max())     # twice the reference's own
        dist = float(np.abs(g.numpy() - w16).max())
        assert 0 < bound and dist <= bound, (arch, i, dist, bound)
        top2 = np.sort(w16[:, -1], axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > bound
        np.testing.assert_array_equal(g[:, -1].argmax(-1).numpy()[clear],
                                      w16[:, -1].argmax(-1)[clear], err_msg=f"{arch} step {i}")
