"""``device_data=True``: the round's batches and inputs drawn on the device,
the port against the reference.

- The traced generators (``traced_stacked_batches``, dose and seg, 16^3,
  3 sites x 2 steps x 1 case, 4 OARs / 4 classes, heterogeneity 0.4)
  against the reference's, jitted as its round engine runs them, on the
  same keys: every mask channel, the body mask and the labels bit for
  bit; the CT channel (``0.3 * normal * body``) within ``FLOAT_ULP`` ulp;
  the seg volume (``0.15 * normal + label * gain``) within ``FLOAT_ULP``
  ulp of its two terms' magnitude (XLA folds its constants otherwise, and
  the sum cancels near 0); the dose within ``DOSE_ATOL`` (the dose is in
  [0, 1]; ``exp`` and XLA's fused division differ by an ulp or two).
- ``availability_step_traced`` and ``pair_sites_traced`` bit-equal to the
  reference's over many keys, 5 and 6 sites, random masks.
- One JAX job (dose GCML, 5 sites, ``max_dropout=1``, 8^3, 3 rounds, its
  scan engine) against the port's from the same initial parameters:
  ``active``, ``partner`` and ``is_receiver`` equal round by round,
  per-site losses rtol 1e-4, atol 1e-5, the global within ``lr * rounds``
  with its median element within 1e-6.
- Port only: a resume bit-equal to the uninterrupted run (the active
  chain continues from the carry); the thread transport ignores the field,
  as the reference's does; every refusal is the reference's
  ``ValueError``, message for message.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from _torch_jax_helpers import hold_job_to_jax  # noqa: E402

from repro.api import FederatedJob as JJob  # noqa: E402
from repro.api import TaskConfig as JTask  # noqa: E402
from repro.core.dropout import availability_step_traced as j_availability  # noqa: E402
from repro.core.gossip import pair_sites_traced as j_pair  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.core.dropout import availability_step_traced  # noqa: E402
from repro_torch.core.gossip import pair_sites_traced  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

FLOAT_ULP = 4
DOSE_ATOL = 4 * 2.0 ** -23
TINY = dict(kind="dose", sites=3, batch=1, volume=(8, 8, 8), base_filters=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tkey(jkey):
    return torch.as_tensor(np.asarray(jkey).astype(np.int64))


def _ulps(a, b):
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("kind", ["dose", "seg"])
def test_traced_generators_match_the_reference(kind):
    if kind == "dose":
        kw = dict(volume=(16, 16, 16), num_oars=4, num_sites=3, heterogeneity=0.4)
        jgen, tgen = jsyn.DoseTaskGenerator(**kw), tsyn.DoseTaskGenerator(**kw)
    else:
        kw = dict(volume=(16, 16, 16), in_channels=4, num_classes=4, num_sites=3,
                  heterogeneity=0.4)
        jgen, tgen = jsyn.SegTaskGenerator(**kw), tsyn.SegTaskGenerator(**kw)
    draw = jax.jit(lambda k: jgen.traced_stacked_batches(k, 2, 1))
    for seed in (0, 7):
        key = jax.random.PRNGKey(seed)
        want = {k: np.asarray(v) for k, v in draw(key).items()}
        got = {k: v.numpy() for k, v in tgen.traced_stacked_batches(_tkey(key), 2, 1).items()}
        assert {k: (v.shape, v.dtype) for k, v in got.items()} == \
            {k: (v.shape, v.dtype) for k, v in want.items()}
        if kind == "dose":
            assert np.array_equal(got["volume"][..., 1:], want["volume"][..., 1:])
            assert np.array_equal(got["mask"], want["mask"])
            assert int(_ulps(got["volume"][..., 0], want["volume"][..., 0]).max()) <= FLOAT_ULP
            assert float(np.abs(got["dose"] - want["dose"]).max()) <= DOSE_ATOL
        else:
            assert np.array_equal(got["labels"], want["labels"])
            gain = np.array([0.5 + 0.25 * c for c in range(4)], np.float32)
            signal = want["labels"][..., None].astype(np.float32) * gain
            bound = FLOAT_ULP * 2.0 ** -23 * (np.abs(want["volume"] - signal) + np.abs(signal))
            assert bool((np.abs(got["volume"] - want["volume"]) <= bound).all())


def test_traced_generator_groups_change_no_value(monkeypatch):
    gen = tsyn.DoseTaskGenerator(volume=(8, 8, 8), num_oars=2, num_sites=3)
    key = _tkey(jax.random.PRNGKey(3))
    whole = gen.traced_stacked_batches(key, 2, 2)
    monkeypatch.setattr(tsyn, "CASE_VOXELS", 8 ** 3)           # one case a group
    one_by_one = gen.traced_stacked_batches(key, 2, 2)
    for k in whole:
        assert torch.equal(whole[k], one_by_one[k])


def test_availability_and_pairing_match_the_reference():
    step = jax.jit(j_availability, static_argnums=2)
    pair = jax.jit(j_pair)
    rng = np.random.default_rng(0)
    for n in (5, 6):
        for seed in range(25):
            key = jax.random.PRNGKey(100 * n + seed)
            active = rng.random(n) < 0.6
            md = 1 + seed % (n - 1)
            want = np.asarray(step(key, jnp.asarray(active), md))
            got = availability_step_traced(_tkey(key), torch.as_tensor(active), md)
            assert np.array_equal(got.numpy(), want)
            for g, w in zip(pair_sites_traced(_tkey(key), torch.as_tensor(active)),
                            pair(key, jnp.asarray(active))):
                assert np.array_equal(g.numpy(), np.asarray(w))
    same = torch.as_tensor(rng.random(5) < 0.5)
    assert availability_step_traced(_tkey(jax.random.PRNGKey(1)), same, 0) is same


def test_device_data_gcml_job_matches_the_reference():
    task = dict(TINY, sites=5)
    kw = dict(strategy="gcml", rounds=3, max_dropout=1, seed=0, device_data=True)
    jjob = JJob(task=JTask(**task), **kw)
    jres = jjob.run()
    tres = hold_job_to_jax(FederatedJob(task=TaskConfig(**task), device="cpu", **kw),
                           jjob, jres)
    for th, jh in zip(tres.history, jres.history):
        assert th["partner"] == jh["partner"]
        assert th["is_receiver"] == jh["is_receiver"]
    assert min(h["active"] for h in jres.history) < 5        # the chain dropped a site
    assert any(any(h["is_receiver"]) for h in jres.history)


def _flat(tree):
    return torch.cat([t.reshape(-1) for t in tree_leaves(tree)])


def _untimed(h):
    return {k: v for k, v in h.items() if k not in ("wall_s", "batch_s", "step_s")}


@pytest.mark.parametrize("strategy", ["fedavg", "gcml"])
def test_device_data_resume_is_bit_equal(tmp_path, strategy):
    job = FederatedJob(task=TaskConfig(**dict(TINY, sites=4)), strategy=strategy, rounds=5,
                       ckpt_every=2, max_dropout=2, device_data=True, device="cpu")
    full = job.run()
    killed = job.replace(checkpoint_dir=str(tmp_path))
    killed.run(rounds=3)
    res = killed.run(resume=True)
    assert res.resumed_from == 2
    np.testing.assert_equal([_untimed(h) for h in res.history],
                            [_untimed(h) for h in full.history[3:]])
    assert torch.equal(_flat(res.global_params), _flat(full.global_params))
    if strategy == "fedavg":
        assert res.comm["upload_count"] == sum(h["active"] for h in full.history[3:])


def test_socket_transports_ignore_device_data():
    base = FederatedJob(task=TaskConfig(**dict(TINY, sites=2)), rounds=2, transport="thread",
                        device="cpu")
    plain, on = base.run(), base.replace(device_data=True).run()
    assert plain.losses == on.losses and plain.comm == on.comm
    assert torch.equal(_flat(plain.global_params), _flat(on.global_params))


# the reference's refusals of device_data=True, in its order of checks
REFUSED = [
    dict(sample="uniform:2"),
    dict(round_engine="loop"),
    dict(scheduler="buffered"),
    dict(compression="int8"),
    dict(down_compression="int8"),
    dict(strategy="pooled"),
    dict(task=dict(TINY, site_pools=(2, 1, 1))),
    dict(topology="pods:3", pod_dropout=1),
    dict(shard_sites=True),
]


@pytest.mark.parametrize("kw", REFUSED, ids=[",".join(k) for k in REFUSED])
def test_refusals_raise_the_reference_value_error(kw):
    kw = dict(kw)
    task = kw.pop("task", TINY)
    with pytest.raises(ValueError) as want:
        JJob(task=JTask(**task), rounds=1, device_data=True, **kw).run()
    with pytest.raises(ValueError) as got:
        FederatedJob(task=TaskConfig(**task), rounds=1, device_data=True, device="cpu",
                     **kw).run()
    assert str(got.value) == str(want.value)
    assert "device_data" in str(got.value)
