"""The port's token models and serving entry point against the JAX reference.

For each reduced config (gemma3: a window-16 layer and a global one;
smollm: 3 q heads on 1 kv head; qwen3: qk-norm and an untied head;
rwkv6; jamba: Mamba, attention and MoE; jamba again with a prompt of 2,
shorter than the conv window, which is then zero-padded on the left;
smollm with a vocabulary that is not a multiple of 128, so that padded
logit rows are masked; the reference's reduced musicgen at its published
4 codebooks, whose codebooks, sinusoidal positions and plain GELU FFN
take the other branches of the embedding, the unembedding and the MLP;
and the five reduced configs ported in the nineteenth slice: deepseek-v2
(MLA, its latent cache and absorbed decode; a dense first layer, then
shared and routed experts), qwen3-moe, granite, chameleon and musicgen)
the reference's parameters from ``T.init(PRNGKey(seed), cfg)`` are
carried into the port by ``convert.from_reference``, and the same numpy
prompts go through both:

- ``forward`` logits;
- ``prefill`` logits and every cache leaf (KV ring slots and index, the
  RWKV state, last x and channel-mix last, the Mamba state and conv
  window).  gemma3's prompt of 20 wraps its window-16 ring;
- ``STEPS - 1`` ``decode_step``s fed the greedy tokens, logits and
  caches after each;
- the greedy tokens of the port's ``serve.generate`` against the JAX
  greedy loop over ``T.prefill`` / ``T.decode_step``.

On the CPU the port's kernels take their plain versions.  Tolerance
``rtol=atol=1e-4`` on logits and caches: the same fp32 model, with sums
taken in other orders (the reference's blockwise scans against the
port's plain loops).  Token ids are compared exactly.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.registry import get_arch as jax_get_arch  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import NotPorted, convert  # noqa: E402
from repro_torch.configs.base import ModelConfig as PortModelConfig  # noqa: E402
from repro_torch.configs.registry import get_arch, get_token_arch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
BATCH, STEPS = 2, 4
PROMPT = {"gemma3-1b": 20,             # > window 16: the ring buffer wraps
          "jamba-short": 2}            # < d_conv - 1: a zero-padded conv window
ARCHS = ["gemma3-1b", "smollm-135m", "qwen3-8b", "rwkv6-7b", "jamba-1.5-large-398b",
         "jamba-short", "smollm-padvocab", "musicgen-codebooks", "deepseek-v2-236b",
         "qwen3-moe-30b-a3b", "granite-3-2b", "chameleon-34b", "musicgen-medium"]
PORTED = ["gemma3-1b", "smollm-135m", "qwen3-8b", "rwkv6-7b", "jamba-1.5-large-398b",
          "deepseek-v2-236b", "qwen3-moe-30b-a3b", "granite-3-2b", "chameleon-34b",
          "musicgen-medium"]
NEW = PORTED[5:]                       # the archs of the nineteenth slice


def _configs(arch):
    """(reference config, port config) of a reduced arch."""
    if arch == "smollm-padvocab":
        j, t = (dataclasses.replace(m.reduced(), vocab_size=250)
                for m in (jax_get_arch("smollm-135m"), get_arch("smollm-135m")))
        return j, t
    if arch == "musicgen-codebooks":     # the reduced musicgen at the published 4 codebooks
        j = dataclasses.replace(jax_get_arch("musicgen-medium").reduced(), num_codebooks=4)
        return j, PortModelConfig(**dataclasses.asdict(j))
    if arch == "jamba-short":
        arch = "jamba-1.5-large-398b"
    return jax_get_arch(arch).reduced(), get_arch(arch).reduced()


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    """The reference on one arch: params, prompts, forward logits, prefill
    and decode-step logits and caches, greedy tokens (numpy)."""
    jcfg, _ = _configs(arch)
    params = JT.init(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(sum(map(ord, arch)))
    lp = PROMPT.get(arch, 12)
    shape = (BATCH, lp) if jcfg.num_codebooks == 1 else (BATCH, lp, jcfg.num_codebooks)
    prompts = rng.integers(0, jcfg.vocab_size, size=shape).astype(np.int32)
    cap = lp + STEPS
    fwd = jax.jit(lambda p, t: JT.forward(p, t, jcfg)[0])
    pre = jax.jit(lambda p, t: JT.prefill(p, t, jcfg, cache_capacity=cap, moe_impl="dense"))
    dec = jax.jit(lambda p, t, c: JT.decode_step(p, t, c, jcfg, moe_impl="dense"))
    as_np = functools.partial(jax.tree.map, np.asarray)
    logits, caches = pre(params, prompts)
    steps = [(as_np(logits), as_np(caches))]
    toks = np.asarray(logits[:, -1:].argmax(-1), np.int32)
    tokens = [toks]
    for _ in range(STEPS - 1):
        logits, caches = dec(params, toks, caches)
        steps.append((as_np(logits), as_np(caches)))
        toks = np.asarray(logits[:, -1:].argmax(-1), np.int32)
        tokens.append(toks)
    return {"params": as_np(params), "prompts": prompts,
            "forward": np.asarray(fwd(params, prompts)), "steps": steps,
            "tokens": np.concatenate(tokens, axis=1)}


def _port(arch):
    _, cfg = _configs(arch)
    ref = _jax_run(arch)
    return cfg, convert.from_reference(ref["params"]), ref


def _assert_tree_close(got, want, where=""):
    """Same nesting, same shapes, values within TOL (integers exactly)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            _assert_tree_close(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_close(g, w, f"{where}[{i}]")
    elif want is None:
        assert got is None, where
    else:
        g = got.detach().cpu().float().numpy()
        if want.dtype.name == "bfloat16":
            want = want.astype(np.float32)
        assert g.shape == want.shape, (where, g.shape, want.shape)
        if np.issubdtype(want.dtype, np.integer):
            assert not got.dtype.is_floating_point, where
            np.testing.assert_array_equal(g, want, err_msg=where)
        else:
            np.testing.assert_allclose(g, want, err_msg=where, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    cfg, params, ref = _port(arch)
    logits, aux = T.forward(params, torch.from_numpy(ref["prompts"]).long(), cfg)
    np.testing.assert_allclose(logits.numpy(), ref["forward"], **TOL)
    assert torch.isfinite(aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_jax(arch):
    cfg, params, ref = _port(arch)
    before = dict(build.LAUNCHES)
    logits, caches = T.prefill(params, torch.from_numpy(ref["prompts"]).long(), cfg,
                               cache_capacity=ref["prompts"].shape[1] + STEPS,
                               moe_impl="dense")
    assert build.LAUNCHES == before            # CPU tensors: the plain versions
    want_logits, want_caches = ref["steps"][0]
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
    _assert_tree_close(caches, want_caches, "caches")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
    cfg, params, ref = _port(arch)
    _, caches = T.prefill(params, torch.from_numpy(ref["prompts"]).long(), cfg,
                          cache_capacity=ref["prompts"].shape[1] + STEPS, moe_impl="dense")
    for s in range(1, STEPS):
        toks = torch.from_numpy(ref["tokens"][:, s - 1:s]).long()
        logits, caches = T.decode_step(params, toks, caches, cfg, moe_impl="dense")
        want_logits, want_caches = ref["steps"][s]
        np.testing.assert_allclose(logits.numpy(), want_logits, err_msg=f"step {s}", **TOL)
        _assert_tree_close(caches, want_caches, f"step {s} caches")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax_greedy_loop(arch):
    cfg, params, ref = _port(arch)
    out = serve.generate(params, torch.from_numpy(ref["prompts"]).long(), cfg, STEPS)
    np.testing.assert_array_equal(out["tokens"].numpy(), ref["tokens"])
    want = np.concatenate([lg[:, -1:] for lg, _ in ref["steps"]], axis=1)
    np.testing.assert_allclose(out["logits"].numpy(), want, **TOL)
    assert out["prefill_launches"] == {} and out["decode_launches"] == {}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_match_reference_layout(arch):
    """Empty caches: the reference's nesting, shapes and dtypes."""
    jcfg, cfg = _configs(arch)
    want = jax.tree.map(np.asarray, JT.init_caches(BATCH, 24, jcfg))
    got = T.init_caches(BATCH, 24, cfg)
    _assert_tree_close(got, want, "init_caches")
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert str(g.dtype) == f"torch.{w.dtype}", (g.dtype, w.dtype)


@pytest.mark.parametrize("arch", ["gemma3-1b", "rwkv6-7b", "jamba-1.5-large-398b",
                                  "deepseek-v2-236b"])
def test_convert_carries_a_token_tree_across_unchanged(arch):
    """from_reference -> to_reference is the identity on a token model's
    tree: same nesting, every leaf's shape and values (SA-Net's 5-D conv
    rule never touches a token leaf)."""
    ref = _jax_run(arch)["params"]
    back = convert.to_reference(convert.from_reference(ref))
    want = jax.tree.leaves(ref)
    got = jax.tree.leaves(back)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch", PORTED)
def test_count_params_matches_reference(arch):
    for which in ("reduced", "CONFIG"):
        jcfg = getattr(jax_get_arch(arch), which)
        tcfg = getattr(get_arch(arch), which)
        jcfg, tcfg = (jcfg(), tcfg()) if which == "reduced" else (jcfg, tcfg)
        if arch.startswith("jamba") and which == "CONFIG":   # 398B: count the cut depth
            jcfg, tcfg = (dataclasses.replace(c, num_layers=2) for c in (jcfg, tcfg))
        assert T.count_params(tcfg) == JT.count_params(jcfg)
        assert T.count_params(tcfg, active_only=True) == JT.count_params(jcfg, active_only=True)


@pytest.mark.parametrize("arch", NEW)
def test_configs_equal_the_reference(arch):
    """The published config and the reduced one, field for field."""
    for which in (lambda m: m.CONFIG, lambda m: m.reduced()):
        assert dataclasses.asdict(which(get_arch(arch))) == \
            dataclasses.asdict(which(jax_get_arch(arch)))


def test_plan_groups_matches_reference():
    for arch in PORTED:
        for cfg_t, cfg_j in ((get_arch(arch).CONFIG, jax_get_arch(arch).CONFIG),
                             (get_arch(arch).reduced(), jax_get_arch(arch).reduced())):
            pt, gt = T.plan_groups(cfg_t)
            pj, gj = JT.plan_groups(cfg_j)
            assert pt == pj
            assert (gt is None) == (gj is None)
            if gt is not None:
                assert (gt.start, gt.period, gt.n_repeats) == (gj.start, gj.period, gj.n_repeats)
                assert [dataclasses.asdict(s) for s in gt.specs] == \
                    [dataclasses.asdict(s) for s in gj.specs]


def test_moe_combine_matrix_matches_reference():
    """The top-k combine weights (renormalised with +1e-9), compared as a
    matrix, not as expert indices (top_k may order ties differently)."""
    cfg = get_arch("jamba-1.5-large-398b").reduced().moe
    rng = np.random.default_rng(5)
    probs = rng.dirichlet(np.ones(cfg.num_experts), size=(2, 7)).astype(np.float32)
    want, want_aux = jmoe.topk_dispatch(probs, cfg)
    got, got_aux = moe.topk_dispatch(torch.from_numpy(probs), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)


def test_serve_cli_on_cpu_returns_the_reference_keys():
    out = serve.run(serve.make_parser().parse_args(
        ["--arch", "gemma3-1b", "--device", "cpu", "--batch", "2", "--prompt-len", "20",
         "--decode-steps", "4"]))
    for key in ("prefill_s", "decode_s", "tok_per_s"):
        assert np.isfinite(out[key]) and out[key] >= 0
    assert out["logits_finite"] and len(out["continuation"]) == 4


def test_serve_defaults_to_cuda_and_raises_without_it():
    args = serve.make_parser().parse_args(["--arch", "smollm-135m"])
    assert args.device == "cuda" and args.reduced
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run(args)


def test_unported_archs_and_seams_raise_a_typed_error():
    """sanet-openkbp loads through ``get_arch`` as the reference's registry
    loads it (its module, with the reference's ``precision_for`` and
    ``mesh_for``), but it is not a token model: the token lookup refuses
    it (seam ``arch``), and a head dim past the attention kernel's widest
    instance is a seam that stays unported; the reference's default
    ``moe_impl`` ("dispatch") and an MLA mixer, refused here until the
    nineteenth slice, now run and match the reference: reduced Jamba's
    prefill with the default, logits and caches, and qwen3's reduced
    config with DeepSeek-V2's reduced MLA, its parameter tree and forward
    logits."""
    from repro_torch.kernels.flash_attention import padded_head_dim
    sanet = get_arch("sanet-openkbp")
    assert sanet.CONFIG.name == "sanet-openkbp" == jax_get_arch("sanet-openkbp").CONFIG.name
    with pytest.raises(NotPorted) as err:
        get_token_arch("sanet-openkbp")
    assert err.value.seam == "arch"
    with pytest.raises(NotPorted) as err:
        padded_head_dim(320)
    assert err.value.seam == "flash_attention"
    with pytest.raises(KeyError):
        get_arch("no-such-model")
    cfg, params, ref = _port("jamba-1.5-large-398b")
    jcfg, _ = _configs("jamba-1.5-large-398b")
    cap = ref["prompts"].shape[1] + STEPS
    want = jax.jit(lambda p, t: JT.prefill(p, t, jcfg, cache_capacity=cap))(
        ref["params"], ref["prompts"])
    got = T.prefill(params, torch.from_numpy(ref["prompts"]).long(), cfg, cache_capacity=cap)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    _assert_tree_close(got[1], jax.tree.map(np.asarray, want[1]), "dispatch caches")
    mla = jax_get_arch("deepseek-v2-236b").reduced().mla
    jcfg = dataclasses.replace(jax_get_arch("qwen3-8b").reduced(), mla=mla)
    cfg = dataclasses.replace(get_arch("qwen3-8b").reduced(), mla=get_arch(
        "deepseek-v2-236b").reduced().mla)
    jparams = jax.tree.map(np.asarray, JT.init(jax.random.PRNGKey(0), jcfg))
    mine = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
    assert jax.tree.structure(jax.tree.map(lambda t: 0, mine)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, jparams))
    assert [tuple(t.shape) for t in jax.tree.leaves(mine)] == \
        [t.shape for t in jax.tree.leaves(jparams)]
    prompts = ref["prompts"] % cfg.vocab_size
    want = jax.jit(lambda p, t: JT.forward(p, t, jcfg)[0])(jparams, prompts)
    got, _ = T.forward(convert.from_reference(jparams), torch.from_numpy(prompts).long(), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
