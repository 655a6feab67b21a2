"""The token task (``TaskConfig(kind="tokens")``, the reference's default)
against the reference.

- ``core/prng.randint``: ``jax.random.randint`` for int32, bit for bit, on
  power-of-two spans and others, past 2**16 (where JAX's uint32
  multiplier wraps to 0), negative bounds and empty spans.
- ``TokenTaskGenerator``: ``sample`` and ``stacked_batches`` bit-equal to
  the reference's numpy generator, ``traced_stacked_batches`` bit-equal to
  the reference's jitted draw on the same key (codebooks and
  heterogeneity too).
- ``transformer.next_token_loss`` and its gradient against
  ``jax.value_and_grad`` of the reference's on reduced smollm-135m,
  qwen3-8b, rwkv6-7b and Jamba (its MoE aux term), and on gemma3's reduced
  config at its published head dim, 256 (2 layers: one with an 8-key
  window, one global; 12 tokens), the weights carried over by
  ``convert.from_reference``: the loss rtol 1e-6, every leaf's gradient
  within ``GRAD_TOL`` of that leaf's largest value, and no leaf without a
  gradient.  1e-5 for the attention models (2.4e-6 measured);
  rwkv6-7b's reduced config at a random init is ill-conditioned in fp32
  (its per-head group norm): the port in float64 lies 7.6e-5 (relative)
  from the reference's own fp32 gradient and the port in fp32 2.6e-4, so
  its gate is 1e-3.
- One stacked FedAvg token job (reduced smollm-135m, 3 sites, 3 rounds,
  seq 16) in both packages from the JAX job's initial parameters: per-site
  losses rtol 1e-4, ``comm`` equal, the globals within the reference's
  thread-vs-stacked bound (rtol 2e-3, atol 2e-4) with the median element
  within 1e-6; then ``device_data=True`` (the reference's scan engine with
  traced batches; a second JAX job, in the same process, so it pays no
  eager start-up) held the same way.
- Port only, on the CPU: every engine and transport that takes a dose task
  takes a token task (int8/fp8/top-k both ways, the host loop, thread and
  tcp, GCML, FedProx, pooled, individual, pods, buffered, robust rules and
  adversaries, the sharded engine, DP per site and per example); a thread
  job and a tcp job equal the stacked job's losses; a resume is bit-equal;
  ``convert`` passes every token tree unchanged; ``launch/train.py --task
  tokens`` trains and prints the reference's dry-run dict.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from _torch_jax_helpers import assert_globals_close, hold_job_to_jax  # noqa: E402

from repro.api import FederatedJob as JJob  # noqa: E402
from repro.api import TaskConfig as JTask  # noqa: E402
from repro.configs.registry import get_arch as jget_arch  # noqa: E402
from repro.data.synthetic import TokenTaskGenerator as JGen  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import NotPorted, convert  # noqa: E402
from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.configs.registry import PORTED  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.session import BufferedScheduler  # noqa: E402
from repro_torch.data.synthetic import TokenTaskGenerator  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TOKENS = dict(kind="tokens", arch="smollm-135m", sites=3, batch=2, seq=16)
GRAD_TOL = {"smollm-135m": 1e-5, "qwen3-8b": 1e-5, "jamba-1.5-large-398b": 1e-5,
            "rwkv6-7b": 1e-3, "gemma3-1b@256": 1e-5}
# configs changed from an architecture's reduced one: gemma3's at head dim 256,
# 2 layers (``global_attn_every=2``: the first local, the second global) and a
# window shorter than the 12 tokens
CHANGED = {"gemma3-1b@256": ("gemma3-1b", dict(head_dim=256, num_layers=2,
                                               global_attn_every=2, sliding_window=8))}


def _reduced(get, name):
    arch, changes = CHANGED.get(name, (name, {}))
    return dataclasses.replace(get(arch).reduced(), **changes)
TIMES = ("wall_s", "batch_s", "step_s")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


SPANS = [(0, 8), (0, 65536), (0, 49152), (0, 6144), (0, 65537), (100, 70000),
         (-5, 7), (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1), (0, 1), (3, 3), (5, 2)]


@pytest.mark.parametrize("lo,hi", SPANS, ids=[f"{a}..{b}" for a, b in SPANS])
def test_randint_is_jax_bit_for_bit(lo, hi):
    for seed in (0, 7, 123457):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (5, 33), lo, hi,
                                             dtype=jnp.int32))
        got = prng.randint(prng.key(seed), (5, 33), lo, hi)
        np.testing.assert_array_equal(got.numpy(), want)
    # a batch of keys draws each key's stream
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    want = np.stack([np.asarray(jax.random.randint(k, (6,), lo, hi, dtype=jnp.int32))
                     for k in keys])
    got = prng.randint(torch.as_tensor(np.asarray(keys).astype(np.int64)), (6,), lo, hi)
    np.testing.assert_array_equal(got.numpy(), want)


GENS = [dict(vocab_size=49152, num_sites=4),
        dict(vocab_size=512, num_sites=3, heterogeneity=0.3, seed=1),
        dict(vocab_size=64, num_sites=2, num_codebooks=4, heterogeneity=0.5, seed=3)]


@pytest.mark.parametrize("kw", GENS, ids=["smollm-vocab", "het", "codebooks"])
def test_token_generator_matches_the_reference(kw):
    j, t = JGen(**kw), TokenTaskGenerator(**kw)
    np.testing.assert_array_equal(t.site_offsets, j.site_offsets)
    for site in range(kw["num_sites"]):
        a, b = t.sample(site, 5, 3, 9), j.sample(site, 5, 3, 9)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.stacked_batches(2, 2, 3, 11)["tokens"],
                                  j.stacked_batches(2, 2, 3, 11)["tokens"])
    draw = jax.jit(lambda k: j.traced_stacked_batches(k, 2, 3, 13)["tokens"])
    for seed in (0, 5):
        want = np.asarray(draw(jax.random.PRNGKey(seed)))
        got = t.traced_stacked_batches(prng.key(seed), 2, 3, 13)["tokens"]
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", list(GRAD_TOL))
def test_next_token_loss_and_gradient_match_the_reference(arch):
    jcfg, cfg = _reduced(jget_arch, arch), _reduced(get_arch, arch)
    params = JT.init(jax.random.PRNGKey(0), jcfg)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    (jloss, jmet), jgrad = jax.jit(jax.value_and_grad(
        lambda p: JT.next_token_loss(p, {"tokens": jnp.asarray(toks)}, jcfg),
        has_aux=True))(params)
    tparams = convert.from_reference(jax.tree.map(np.asarray, params))
    leaves = [t.requires_grad_() for t in tree_leaves(tparams)]
    loss, met = T.next_token_loss(tparams, {"tokens": torch.from_numpy(toks)}, cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(met["aux"].item(), float(jmet["aux"]), rtol=1e-5, atol=1e-7)
    if arch.startswith("jamba"):
        assert met["aux"].item() > 0                    # the MoE term is in the loss
    want = convert.from_reference(jax.tree.map(np.asarray, jgrad))
    for g, w in zip(grads, tree_leaves(want)):
        assert g is not None
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= GRAD_TOL[arch] * scale


def test_token_trees_cross_convert_unchanged():
    """No token leaf is 5-D, so none takes the SA-Net conv transpose."""
    for name in PORTED:
        mod = get_arch(name)
        for cfg in (mod.CONFIG, mod.reduced()):
            shapes = [t.shape for t in tree_leaves(T.init(None, cfg, "meta"))]
            assert all(convert.reference_order(s) is None for s in shapes), name
    p = T.init(torch.Generator().manual_seed(0), get_arch("jamba-1.5-large-398b").reduced(),
               "cpu")
    back = convert.from_reference(convert.to_reference(p))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(p)))


def test_stacked_token_jobs_match_the_reference():
    kw = dict(rounds=3, seed=0)
    jjob = JJob(task=JTask(**TOKENS), **kw)
    jres = jjob.run()
    job = FederatedJob(task=TaskConfig(**TOKENS), device="cpu", **kw)
    tres = hold_job_to_jax(job, jjob, jres)
    assert_globals_close(convert.to_reference(tres.global_params),
                         jax.tree.map(np.asarray, jres.global_params), 0.0)
    # device_data: the reference's scan engine draws the batches from its key
    jdd = jjob.replace(device_data=True)
    jres = jdd.run()
    tres = hold_job_to_jax(job.replace(device_data=True), jdd, jres)
    assert_globals_close(convert.to_reference(tres.global_params),
                         jax.tree.map(np.asarray, jres.global_params), 0.0)


BASE = FederatedJob(task=TaskConfig(**TOKENS), rounds=2, device="cpu")
COMPOSITIONS = {
    "int8-both": dict(compression="int8", down_compression="int8"),
    "fp8": dict(compression="fp8"),
    "topk-fixed-both": dict(compression="topk-fixed", down_compression="topk-fixed"),
    "topk-sparse": dict(compression="topk-sparse"),
    "host-loop-int8": dict(round_engine="loop", compression="int8"),
    "gcml": dict(strategy="gcml"),
    "fedprox": dict(strategy="fedprox"),
    "pooled": dict(strategy="pooled"),
    "individual": dict(strategy="individual"),
    "pods": dict(task=TaskConfig(**dict(TOKENS, sites=4)), topology="pods:2"),
    "buffered": dict(scheduler=BufferedScheduler(buffer_k=2)),
    "trimmed-signflip": dict(aggregator="trimmed:1", adversary="sign_flip:1"),
    "labelflip": dict(adversary="label_flip:1"),
    "sharded": dict(shard_sites=True),
    "sampled-churn": dict(sample="uniform:2", max_dropout=1),
    "dp-per-site": dict(dp_clip=0.5, dp_noise_multiplier=0.8),
    "dp-per-example": dict(dp_clip=0.5, dp_noise_multiplier=0.8, dp_mode="per-example"),
    "thread-int8": dict(transport="thread", compression="int8", down_compression="int8"),
}


@pytest.mark.parametrize("name", list(COMPOSITIONS))
def test_every_engine_takes_a_token_task(name):
    res = BASE.replace(**COMPOSITIONS[name]).run()
    assert len(res.history) == 2
    assert all(np.isfinite(h["loss"]) for h in res.history)
    assert all(torch.isfinite(t).all() for t in tree_leaves(res.global_params))


def test_socket_token_jobs_equal_the_stacked_job():
    stacked = BASE.run()
    thread = BASE.replace(transport="thread").run()
    for a, b in zip(thread.history, stacked.history):
        np.testing.assert_allclose(a["per_site_loss"], b["per_site_loss"], rtol=1e-6)
    tcp = BASE.replace(transport="tcp", task=TaskConfig(**dict(TOKENS, sites=2))).run()
    thread2 = BASE.replace(transport="thread", task=TaskConfig(**dict(TOKENS, sites=2))).run()
    for a, b in zip(tcp.history, thread2.history):
        np.testing.assert_allclose(a["per_site_loss"], b["per_site_loss"], rtol=1e-6)


def test_token_resume_is_bit_equal(tmp_path):
    full = BASE.replace(rounds=4).run()
    job = BASE.replace(rounds=4, ckpt_every=2, checkpoint_dir=str(tmp_path))
    job.run(rounds=3)
    res = job.run(resume=True)
    assert res.resumed_from == 2
    assert res.history[-1]["loss"] == full.history[-1]["loss"]
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(res.global_params), tree_leaves(full.global_params)))


def test_unported_archs_and_the_job_surface():
    with pytest.raises(NotPorted) as err:
        BASE.replace(task=TaskConfig(kind="tokens", arch="sanet-openkbp")).run()
    assert err.value.seam == "arch"
    full = TaskConfig(kind="tokens", reduced=False, seq=2048)
    assert full.model_config() == get_arch("smollm-135m").CONFIG
    assert T.count_params(full.model_config()) == 134_515_008
    bundle = TaskConfig(**TOKENS).build()
    b = bundle.stacked(1, 2)["tokens"]
    assert b.shape == (3, 2, 2, 16) and b.dtype == np.int32
    assert bundle.sample(2, 3)["tokens"].shape == (2, 16)
    p = tree_map(lambda t: t, bundle.init_fn(0))
    loss, logits, labels = bundle.forward_fn(p, {"tokens": torch.from_numpy(b[0, 0])})
    assert logits.shape[:2] == labels.shape == (2, 15)
    assert float(loss) == float(bundle.loss_fn(p, {"tokens": torch.from_numpy(b[0, 0])})[0])


def _untimed(d):
    return {**d, "wall_s": None, "compile_s": None,
            "history": [{k: v for k, v in h.items() if k not in TIMES} for h in d["history"]]}


def test_train_cli_runs_the_token_task(tmp_path, capsys):
    argv = ["--task", "tokens", "--arch", "smollm-135m", "--reduced", "--sites", "2",
            "--rounds", "2", "--seq", "16", "--batch", "2", "--quiet"]
    want = jtrain.run(jtrain.make_parser().parse_args(argv + ["--dry-run"]))
    want_out = capsys.readouterr().out
    got = ttrain.run(ttrain.make_parser().parse_args(argv + ["--dry-run", "--device", "cpu"]))
    assert got == want and json.loads(capsys.readouterr().out) == json.loads(want_out)
    out = ttrain.run(ttrain.make_parser().parse_args(
        argv + ["--device", "cpu", "--out", str(tmp_path)]))
    written = json.loads((tmp_path / "train_fedavg.json").read_text())
    job = FederatedJob(task=TaskConfig(kind="tokens", arch="smollm-135m", reduced=True,
                                       sites=2, seq=16, batch=2), rounds=2, device="cpu")
    assert _untimed(written) == _untimed(json.loads(json.dumps(out))) == \
        _untimed(json.loads(json.dumps({**job.run().to_dict(), "strategy": "fedavg"})))
