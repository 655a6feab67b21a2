"""The port's step builders, gradient accumulation and remat against the
JAX package.

- ``repro_torch.launch.steps.build`` at every (token architecture x shape)
  that ``is_skipped`` allows: its ``abstract_inputs`` have the shapes and
  dtypes of the reference's (its site-stacked state from its
  ``init_fl_state``: ``T.init`` in the policy's ``param_dtype``, the
  moments in ``opt_state_dtype``; its batches and round inputs; its
  serving parameters, tokens and bf16 caches), from ``jax.eval_shape``;
  ``TRAIN_MICROBATCH`` is the reference's; every token architecture's
  model passes ``check_backward_instances`` in bf16.
- ``remat``: a reduced config's gradients with and without the checkpoint
  around each repeat of its layer group are equal bit for bit.
- Gradient accumulation: a reduced smollm round of 2 sites, 4 sequences a
  site in 2 microbatches, fp32, ``remat_local`` on, the optimizer's
  update in slices of 10,000 elements (as a full-width row's), against the
  reference's ``build_fl_round`` with the same ``FLContext`` fields (its
  ``launch/steps.py``'s): losses and parameters within rtol=atol=2e-5
  (fp32 sums in other orders).  DP-SGD with a microbatch raises the
  reference's ``ValueError`` in both.
- The policies: a reduced smollm round in ``mixed`` and a reduced
  DeepSeek-V2 round in ``bf16_train`` (bf16 moments, bf16 accumulator, its
  MoE router and fp32 leaves kept fp32), each through ``build_train`` on
  the CPU (``remat`` on), against the reference's round in the same
  policy from the same bf16 weights and tokens (``remat`` off: the same
  values, half the compile time).  The bound is measured: each quantity (the
  losses; all parameters, all first and all second moments, each taken
  over the whole tree) lies no farther (max |difference|) from the
  reference's bf16 round than twice the distance between the reference's
  own bf16 round and its fp32 round on the same bf16-valued weights.
- ``fedavg_aggregate``, ``hierarchical_aggregate`` and
  ``StreamingAccumulator.nbytes`` against the reference's (rtol 1e-6).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.core import agg_engine as jagg  # noqa: E402
from repro.core import aggregation as jaggregation  # noqa: E402
from repro.core import federation as JF  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.privacy.dp import DPConfig as JDP  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base, registry  # noqa: E402
from repro_torch.core import agg_engine, aggregation  # noqa: E402
from repro_torch.core import federation as F  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.privacy.dp import DPConfig  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402

TOKEN_ARCHS = sorted(a for a in jreg.ALIASES if a != "sanet-openkbp")


def _spec(tree):
    """{path: (shape, dtype name)} of a tree of arrays or tensors."""
    out = {}

    def walk(x, path):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")
        elif x is not None:
            out[path] = (tuple(x.shape), str(x.dtype).replace("torch.", ""))
    walk(tree, "")
    return out


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_abstract_inputs_have_the_references_shapes_and_dtypes(arch):
    arch_id = jreg.ALIASES[arch]
    jcfg = jreg.get_arch(arch).CONFIG
    traced = {}                                  # the reference's tree, a param dtype
    for name, shape in jbase.INPUT_SHAPES.items():
        if jreg.is_skipped(arch_id, name):
            continue
        art = steps.build(arch, name, device="cpu")
        prec = jreg.get_arch(arch).precision_for(shape)
        assert dataclasses.asdict(art.precision) == dataclasses.asdict(prec)
        pdt = jnp.dtype(prec.param_dtype)
        if pdt not in traced:
            traced[pdt] = jax.eval_shape(lambda: JT.init(jax.random.PRNGKey(0), jcfg,
                                                         dtype=pdt))
        params = traced[pdt]
        b = shape.global_batch
        k = (jcfg.num_codebooks,) if jcfg.num_codebooks > 1 else ()
        tok = jax.ShapeDtypeStruct
        if shape.kind == "train":
            s = jreg.get_arch(arch).mesh_for(shape).total_sites
            sdt = jnp.dtype(prec.opt_state_dtype)
            stacked = jax.tree.map(lambda x: tok((s,) + x.shape, x.dtype), params)
            want = ({"params": stacked,
                     "opt": {"step": tok((s,), jnp.int32),
                             "mu": jax.tree.map(lambda x: tok(x.shape, sdt), stacked),
                             "nu": jax.tree.map(lambda x: tok(x.shape, sdt), stacked)},
                     "strategy": {}, "round": tok((), jnp.int32)},
                    {"tokens": tok((s, 1, b // s, shape.seq_len) + k, jnp.int32)},
                    {"active": tok((s,), jnp.bool_), "partner": tok((s,), jnp.int32),
                     "is_receiver": tok((s,), jnp.bool_)})
        elif shape.kind == "prefill":
            want = (params, tok((b, shape.seq_len) + k, jnp.int32))
        else:
            caches = jax.eval_shape(lambda: JT.init_caches(b, shape.seq_len, jcfg,
                                                           dtype=jnp.bfloat16))
            want = (params, tok((b, 1) + k, jnp.int32), caches)
        assert len(art.abstract_inputs) == len(want)
        for got, w in zip(art.abstract_inputs, want):
            assert _spec(got) == _spec(w), (arch, name)
            assert all(t.device.type == "meta" for t in tree_leaves(got))
    assert steps.TRAIN_MICROBATCH == jsteps.TRAIN_MICROBATCH
    ops.check_backward_instances(registry.get_arch(arch).CONFIG, torch.bfloat16)


def test_the_steps_run_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.build("smollm-135m", "prefill_32k")
    cfg = registry.get_arch("gemma3-1b").reduced()
    art = steps.build("gemma3-1b", "decode_32k", cfg=cfg, device="cpu")
    params, tokens, caches = art.make_inputs(seed=1, batch=2, seq_len=24)
    assert {t.dtype for t in tree_leaves(params)} == {torch.bfloat16}
    logits, caches = art.step_fn(params, tokens, caches)
    assert logits.shape == (2, 1, cfg.padded_vocab) and bool(torch.isfinite(logits).all())
    assert [int(c["index"]) for c in caches["prefix"]] == [24] * cfg.num_layers


@pytest.mark.parametrize("arch", ["smollm-135m", "rwkv6-7b", "qwen3-moe-30b-a3b"])
def test_remat_gradients_are_bit_equal(arch):
    cfg = registry.get_arch(arch).reduced()
    assert T.plan_groups(cfg)[1] is not None         # a layer group to checkpoint
    params = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_()
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(1))
    grads = []
    for remat in (False, True):
        loss, _ = T.next_token_loss(params, {"tokens": tokens}, cfg, remat=remat,
                                    moe_impl="dispatch")
        grads.append(torch.autograd.grad(loss, leaves))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def _jax_ctx(jcfg, sites, state_dtype, accum_dtype, microbatch, remat=True, **kw):
    """The reference's FLContext as its ``launch/steps.py`` builds it
    (``remat=False`` compiles in half the time, to the same values)."""
    fed = jbase.FederationConfig(num_sites=sites)
    return JF.FLContext(
        fed=fed, mesh=jbase.MeshConfig(sites_per_pod=sites),
        case_weights=jnp.asarray(fed.case_weights()),
        loss_fn=lambda p, b: JT.next_token_loss(p, b, jcfg, remat=remat, moe_impl="dispatch"),
        logits_fn=None, optimizer=jadamw(1e-4, weight_decay=0.01, state_dtype=state_dtype),
        grad_clip=1.0, dcml_lr=1e-4, microbatch=microbatch, accum_dtype=accum_dtype, **kw)


def _f32(tree):
    """numpy fp32 leaves (a bf16 leaf widened by numpy: no XLA compile)."""
    return jax.tree.map(lambda x: np.asarray(x).astype(np.float32), tree)


def _jax_init(jcfg, seed, dtype=jnp.float32):
    """The reference's ``T.init`` in one compile (eager, every random op
    would compile on its own)."""
    return jax.jit(lambda k: JT.init(k, jcfg, dtype=dtype))(jax.random.PRNGKey(seed))


def _jax_round(ctx, params, tokens, remat_local=False):
    """One reference round from ``params`` (one tree) on every site:
    (per-site losses, the stacked params, the moments), numpy fp32."""
    s = ctx.fed.num_sites

    def one_round(p, toks, ri):
        state = JF.init_fl_state(ctx, lambda key: p, jax.random.PRNGKey(0))
        return JF.build_fl_round(ctx, remat_local=remat_local)(state, {"tokens": toks}, ri)
    ri = JF.make_round_inputs(ctx, active=np.ones(s, bool))
    state, metrics = jax.jit(one_round)(params, tokens, ri)
    return (np.asarray(metrics["loss"]), _f32(state["params"]), _f32(state["opt"]["mu"]),
            _f32(state["opt"]["nu"]))


def _port_tree(jparams):
    """A reference tree carried into the port, each leaf in its dtype."""
    dts = [x.dtype for x in jax.tree.leaves(jparams)]
    tp = convert.from_reference(_f32(jparams))
    return tree_unflatten(tp, [t.bfloat16() if dt == jnp.bfloat16 else t
                               for t, dt in zip(tree_leaves(tp), dts)])


def _port_state(state):
    """(the stacked params, mu, nu) of a port round as reference-layout
    numpy trees ([S, ...] leaves, fp32)."""
    layout = state["layout"]
    trees = []
    for flat in (state["params"], state["opt"]["mu"], state["opt"]["nu"]):
        rows = [[v.float().numpy() for v in layout.views(flat[s])]
                for s in range(flat.shape[0])]
        trees.append([np.stack(leaf) for leaf in zip(*rows)])
    return trees


def _flat(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def test_microbatch_accumulation_matches_the_reference(monkeypatch):
    jcfg = jreg.get_arch("smollm-135m").reduced()
    cfg = registry.get_arch("smollm-135m").reduced()
    jparams = _jax_init(jcfg, 5)
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 1, 4, 16)).astype(np.int32)
    jctx = _jax_ctx(jcfg, 2, jnp.float32, jnp.float32, 2)
    want = _jax_round(jctx, jparams, tokens, remat_local=True)
    fed = base.FederationConfig(num_sites=2)
    ctx = F.FLContext(fed=fed, case_weights=torch.as_tensor(fed.case_weights()),
                      loss_fn=lambda p, b: T.next_token_loss(p, b, cfg, remat=True,
                                                             moe_impl="dispatch"),
                      optimizer=adamw(1e-4, weight_decay=0.01), grad_clip=1.0,
                      device=torch.device("cpu"), dcml_lr=1e-4, microbatch=2)
    state = F.init_fl_state(ctx, convert.from_reference(jax.tree.map(np.asarray, jparams)))
    monkeypatch.setattr(F, "UPDATE_SLICE", 10_000)   # the update in many slices, as at full width
    state, metrics = F.build_fl_round(ctx, remat_local=True)(
        state, {"tokens": torch.from_numpy(tokens)}, F.make_round_inputs(ctx, np.ones(2, bool)))
    np.testing.assert_allclose(metrics["loss"].numpy(), want[0], rtol=2e-5, atol=2e-5)
    for got, w in zip(_port_state(state), want[1:]):
        for a, b in zip(got, _flat(w)):
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)
    dp = dict(privacy=DPConfig(clip=1.0, noise_multiplier=0.0))
    with pytest.raises(ValueError, match="microbatch"):
        F.build_fl_round(dataclasses.replace(ctx, **dp))
    with pytest.raises(ValueError, match="microbatch"):
        JF.build_fl_round(dataclasses.replace(jctx, privacy=JDP(clip=1.0, noise_multiplier=0.0)))


@pytest.mark.parametrize("arch,policy", [("smollm-135m", "mixed"),
                                         ("deepseek-v2-236b", "bf16_train")])
def test_policy_rounds_match_the_reference(arch, policy):
    jcfg = jreg.get_arch(arch).reduced()
    cfg = registry.get_arch(arch).reduced()
    prec = jreg.get_arch(arch).precision_for(jbase.INPUT_SHAPES["train_4k"])
    assert dataclasses.asdict(prec) == dataclasses.asdict(getattr(jbase.PrecisionConfig,
                                                                  policy)())
    sdt = jnp.dtype(prec.opt_state_dtype)
    p16 = _jax_init(jcfg, 11, jnp.bfloat16)
    tokens = np.random.default_rng(11).integers(0, jcfg.vocab_size,
                                                (2, 1, 4, 16)).astype(np.int32)
    ref16 = _jax_round(_jax_ctx(jcfg, 2, sdt, sdt, 2, remat=False), p16, tokens)
    ref32 = _jax_round(_jax_ctx(jcfg, 2, jnp.float32, jnp.float32, 2, remat=False),
                       _f32(p16), tokens)
    art = steps.build_train(arch, cfg=cfg, override_mesh=base.MeshConfig(sites_per_pod=2),
                            microbatch=2, device="cpu")
    state, _, ri = art.make_inputs(params=_port_tree(p16))
    assert state["params"].dtype == (torch.bfloat16 if policy == "mixed" else torch.float32)
    assert state["opt"]["mu"].dtype == getattr(torch, prec.opt_state_dtype)
    state, metrics = art.step_fn(state, {"tokens": torch.from_numpy(tokens)}, ri)
    bound = 2 * float(np.abs(ref16[0] - ref32[0]).max())
    assert 0 < bound and abs(float(metrics["loss"]) - float(ref16[0].mean())) <= bound
    for name, got, w16, w32 in zip(("params", "mu", "nu"), _port_state(state), ref16[1:],
                                   ref32[1:]):
        a, b, c = (np.concatenate([x.ravel() for x in t]) for t in (got, _flat(w16), _flat(w32)))
        bound = 2 * float(np.abs(b - c).max())
        assert 0 < bound and float(np.abs(a - b).max()) <= bound, (arch, name)


def test_aggregation_wrappers_and_nbytes_match_the_reference():
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((4, 3, 5)).astype(np.float32),
            "b": [rng.standard_normal((4, 7)).astype(np.float32)]}
    w = np.asarray([1.0, 2.0, 3.0, 4.0], np.float32)
    active = np.asarray([True, False, True, True])
    mine = {"a": torch.from_numpy(tree["a"]), "b": [torch.from_numpy(tree["b"][0])]}
    jt = jax.tree.map(jnp.asarray, tree)
    for got, want in ((aggregation.fedavg_aggregate(mine, torch.from_numpy(w), active),
                       jaggregation.fedavg_aggregate(jt, jnp.asarray(w), jnp.asarray(active))),
                      (aggregation.hierarchical_aggregate(mine, torch.from_numpy(w), 2, active),
                       jaggregation.hierarchical_aggregate(jt, jnp.asarray(w), 2,
                                                           jnp.asarray(active)))):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    acc, jacc = agg_engine.StreamingAccumulator(), jagg.StreamingAccumulator()
    assert acc.nbytes == jacc.nbytes == 0
    for i in range(3):
        site = jax.tree.map(lambda x: x[i], tree)
        acc.fold({"a": torch.from_numpy(site["a"]), "b": [torch.from_numpy(site["b"][0])]},
                 float(w[i]))
        jacc.fold(site, float(w[i]))
        assert acc.nbytes == jacc.nbytes == 4 * (15 + 7)
    got, want = acc.finalize(), jacc.finalize()
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert acc.nbytes == 0
