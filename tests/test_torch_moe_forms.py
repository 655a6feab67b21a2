"""The MoE ``dispatch`` and ``gather`` formulations against the JAX reference.

The reference's parameters from ``moe_init`` are carried into the port by
``convert.from_reference`` and the same numpy tokens go through both:

- ``moe_apply_dispatch`` at ``capacity_factor`` 4.0 (nothing dropped) and
  0.25 (pairs dropped), as the reference's ``tests/test_models.py``
  drives it, and at a token count its group size does not divide (one
  group): the top-k indices bit-equal to ``jax.lax.top_k`` on the
  reference's router probabilities (a near tie that flips one is named
  with its two probabilities in the message), the kept (token, expert,
  slot) set bit-equal to the reference's own dispatch tensor (read off
  its first einsum by a spy on its module's ``jnp`` while ``jax.jit``
  traces it), the combine weights, the output and the aux loss;
- ``moe_apply_sparse`` (the ``gather`` form), output and aux loss;
- ``T.prefill`` with its default ``moe_impl="dispatch"`` on the reduced
  qwen3-moe-30b-a3b against the reference's ``prefill`` with its default:
  logits and every cache leaf (Jamba's is in ``test_torch_serve.py``).

Tolerance rtol = atol = 1e-4 on outputs and logits (the same fp32
function, sums in other orders); 1e-6 on the combine weights.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.configs.registry import get_arch as jax_get_arch  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
SHARED = dict(num_experts=4, top_k=2, d_expert=32, num_shared_experts=1, d_shared=16)
ROUTED = dict(num_experts=4, top_k=2, d_expert=16)
# (MoE config, x shape, capacity factor, group size): the reference's two
# tests, and 21 tokens in groups of 8 (one group of 21)
CASES = [pytest.param(SHARED, (2, 16, 24), 4.0, 8, id="cf4-no-drops"),
         pytest.param(ROUTED, (1, 32, 12), 0.25, 16, id="cf0.25-drops"),
         pytest.param(SHARED, (3, 7, 24), 1.25, 8, id="ragged-one-group")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _EinsumSpy:
    """The reference module's ``jnp`` with ``einsum`` recording its operands."""

    def __init__(self):
        self.seen = {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *operands, **kw):
        self.seen[spec] = operands
        return jnp.einsum(spec, *operands, **kw)


def _moe(kw, d, seed):
    jparams = jax.tree.map(np.asarray, jax.jit(jmoe.moe_init, static_argnums=(1, 2))(
        jax.random.PRNGKey(seed), d, JMoEConfig(**kw)))
    return JMoEConfig(**kw), MoEConfig(**kw), jparams, convert.from_reference(jparams)


def _assert_same_topk(got, want, probs):
    bad = np.argwhere(got != want)
    msg = "; ".join(f"token {tuple(i[:-1])} slot {i[-1]}: port expert {got[tuple(i)]} "
                    f"(p {probs[tuple(i[:-1]) + (got[tuple(i)],)]:.9g}), reference expert "
                    f"{want[tuple(i)]} (p {probs[tuple(i[:-1]) + (want[tuple(i)],)]:.9g})"
                    for i in bad[:5])
    assert not len(bad), f"top-k indices differ at {len(bad)} pairs (a near tie?): {msg}"


@pytest.mark.parametrize("kw,shape,cf,group", CASES)
def test_dispatch_matches_the_reference(kw, shape, cf, group, monkeypatch):
    jcfg, cfg, jparams, params = _moe(kw, shape[-1], 0)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    spy = _EinsumSpy()

    def reference(p, x):            # traced once: the spy sees the traced operands
        y, aux = jmoe.moe_apply_dispatch(p, x, jcfg, capacity_factor=cf, group_size=group)
        dispatch = spy.seen["gsec,gsd->gecd"][0]                         # [G, S, E, C]
        probs = jmoe.router_probs(p, x.reshape(dispatch.shape[:2] + x.shape[-1:]), jcfg)
        return (y, aux, dispatch, spy.seen["gsec,gecd->gsd"][0], probs,
                jax.lax.top_k(probs, jcfg.top_k)[1])
    monkeypatch.setattr(jmoe, "jnp", spy)
    jy, jaux, want_dispatch, want_combine, jprobs, jidx = jax.tree.map(
        np.asarray, jax.jit(reference)(jparams, x))
    monkeypatch.undo()
    g, s = want_dispatch.shape[:2]
    xt = x.reshape(g, s, -1)

    probs = moe.router_probs(params, torch.from_numpy(xt), cfg)
    top_vals, top_idx, slot, kept, cap = moe.dispatch_slots(probs, cfg, cf)
    _assert_same_topk(top_idx.numpy(), np.asarray(jidx), jprobs)
    assert cap == want_dispatch.shape[-1]
    got = np.zeros_like(want_dispatch)
    gi, si, ji = np.nonzero(kept.numpy())
    got[gi, si, top_idx.numpy()[gi, si, ji], slot.numpy()[gi, si, ji]] = 1.0
    np.testing.assert_array_equal(got, want_dispatch)                # the kept set
    weights = np.zeros_like(want_combine)
    weights[gi, si, top_idx.numpy()[gi, si, ji], slot.numpy()[gi, si, ji]] = \
        top_vals.numpy()[gi, si, ji]
    np.testing.assert_allclose(weights, want_combine, rtol=1e-6, atol=1e-7)
    dropped = int((~kept).sum())
    assert dropped == 0 if cf >= 4.0 else dropped > 0, dropped

    y, aux = moe.moe_apply_dispatch(params, torch.from_numpy(x), cfg, capacity_factor=cf,
                                    group_size=group)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    if cf >= 4.0:                       # nothing dropped: the dense function
        np.testing.assert_allclose(y.numpy(), moe.moe_apply(params, torch.from_numpy(x),
                                                            cfg)[0].numpy(), **TOL)


@pytest.mark.parametrize("kw,shape", [pytest.param(SHARED, (2, 16, 24), id="shared"),
                                      pytest.param(ROUTED, (3, 5, 12), id="routed")])
def test_gather_matches_the_reference(kw, shape):
    jcfg, cfg, jparams, params = _moe(kw, shape[-1], 2)
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    jy, jaux = jmoe.moe_apply_sparse(jparams, x, jcfg)
    y, aux = moe.moe_apply_sparse(params, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    dense, _ = moe.moe_apply(params, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), dense.numpy(), **TOL)


def test_prefill_defaults_to_dispatch_as_the_reference():
    arch = "qwen3-moe-30b-a3b"
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    jparams = jax.jit(JT.init, static_argnums=1)(jax.random.PRNGKey(4), jcfg)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    jlogits, jcaches = jax.jit(lambda p, t: JT.prefill(p, t, jcfg, cache_capacity=44))(
        jparams, prompts)
    params = convert.from_reference(jax.tree.map(np.asarray, jparams))
    logits, caches = T.prefill(params, torch.from_numpy(prompts).long(), cfg, 44)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for got, want in zip(jax.tree.leaves(caches), jax.tree.leaves(jcaches)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL)
    dense, _ = T.prefill(params, torch.from_numpy(prompts).long(), cfg, 44, moe_impl="dense")
    assert not torch.allclose(dense, logits, **TOL)      # 80 tokens: the default drops pairs
