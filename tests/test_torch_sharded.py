"""``shard_sites=True``: the sharded many-site simulator, the port against
the reference and against its own dense engines.

- ``pack_participants`` equals the reference's ``_pack_participants``
  array for array (numpy only): several shapes, padded blocks (``s_pad >
  S``) and devices with no participant.
- The reference's seven sharded-vs-dense cases (fedavg, fedprox,
  ``pods:2``, int8, int8 + fedprox, ``uniform:2``, ``poisson:0.6`` + churn;
  4 sites, 8^3, 4 rounds), port against port: the globals at the
  reference's tolerances (rtol 1e-5, atol 1e-4; int8 rtol 1e-4, atol
  1e-3) but the GroupNorm-fed conv biases, whose zero true gradient lets
  AdamW turn fold-order round-off into about ``lr`` a step (held to ``lr *
  rounds``); the active counts and ``upload_bytes`` equal; each trained
  row's loss rtol 1e-4 and the NaN rows exactly the non-participants.
- One JAX job (int8, ``uniform:2``, shutdown, 4 sites, 3 rounds) against
  the port's from the same initial parameters: per-site losses (NaN where
  a site did not train) rtol 1e-4, atol 1e-5, ``comm`` equal, the global
  within ``lr * rounds`` with its median element within 1e-6,
  ``participants`` and ``k_cap`` equal.
- Port only: the rows laid over D = 2 and 3 CPU blocks against D = 1
  (allclose: the fold sums the blocks' partials); sites that never
  participate keep their initial rows and zero moments bit for bit, and
  each last-round participant's row is the final global; the refusals are
  the reference's ``ValueError``s, message for message.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_jax_helpers import hold_job_to_jax, tree_paths  # noqa: E402

from repro.api import FederatedJob as JJob  # noqa: E402
from repro.api import TaskConfig as JTask  # noqa: E402
from repro.core.round_engine import _pack_participants  # noqa: E402
from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.core import round_engine  # noqa: E402
from repro_torch.core.session import SyncScheduler  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import site_devices  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TINY = dict(kind="dose", sites=4, batch=1, volume=(8, 8, 8), base_filters=4)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _job(**kw):
    base = dict(task=TaskConfig(**TINY), rounds=4, device="cpu")
    base.update(kw)
    return FederatedJob(**base)


def _flat(tree):
    return torch.cat([t.reshape(-1) for t in tree_leaves(tree)])


@pytest.mark.parametrize("sites,devices,rounds", [(4, 1, 3), (5, 2, 4), (7, 3, 5), (6, 4, 3)])
def test_pack_participants_matches_the_reference(sites, devices, rounds):
    rng = np.random.default_rng(sites * 10 + devices)
    participate = rng.random((rounds, sites)) < 0.5
    participate[0] = False
    participate[0, 0] = True              # every device but the first empty
    weight = rng.random((rounds, sites)).astype(np.float32)
    pod_of = (np.arange(sites) % 2).astype(np.int32)
    s_loc = -(-sites // devices)
    got = round_engine.pack_participants(participate, weight, pod_of, s_loc, devices)
    want = _pack_participants(participate, weight, pod_of, s_loc, devices)
    assert got[-1] == want[-1]
    for g, w in zip(got[:-1], want[:-1]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    empty = np.zeros((2, sites), bool)
    got = round_engine.pack_participants(empty, weight[:2], pod_of, s_loc, devices)
    want = _pack_participants(empty, weight[:2], pod_of, s_loc, devices)
    assert got[-1] == want[-1] == 1
    assert all(np.array_equal(g, w) for g, w in zip(got[:-1], want[:-1]))


def _hold_globals(got, want, rtol, noise_bound):
    for (path, a), (_, b) in zip(tree_paths(got), tree_paths(want)):
        a, b = np.asarray(a), np.asarray(b)
        if path.endswith(("/conv1/b", "/conv2/b")):
            assert float(np.abs(a - b).max()) <= noise_bound, path
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=10 * rtol, err_msg=path)


def _hold_losses(dense, shard):
    for hd, hs in zip(dense.history, shard.history):
        assert hd["active"] == hs["active"] == hs["participants"]
        d, s = np.asarray(hd["per_site_loss"]), np.asarray(hs["per_site_loss"])
        m = np.isfinite(s)
        assert m.sum() == hs["active"]
        np.testing.assert_allclose(d[m], s[m], rtol=1e-4)


@pytest.mark.parametrize("kw,rtol", [
    (dict(), 1e-5),
    (dict(strategy="fedprox"), 1e-5),
    (dict(topology="pods:2"), 1e-5),
    (dict(compression="int8"), 1e-4),
    (dict(compression="int8", strategy="fedprox"), 1e-4),
    (dict(sample="uniform:2", dropout_scenario="shutdown"), 1e-5),
    (dict(sample="poisson:0.6", max_dropout=1, dropout_scenario="shutdown"), 1e-5),
], ids=["fedavg", "fedprox", "pods", "int8", "int8-fedprox", "sampled-uniform",
        "sampled-poisson-churn"])
def test_sharded_matches_dense(kw, rtol):
    job = _job(**kw)
    dense = job.run()
    shard = job.replace(shard_sites=True).run()
    _hold_globals(shard.global_params, dense.global_params, rtol, job.lr * job.rounds)
    assert shard.comm["sharded"] is True and shard.comm["devices"] == 1
    assert shard.comm["upload_bytes"] == dense.comm["upload_bytes"]
    _hold_losses(dense, shard)
    assert shard.state["params"].shape == dense.state["params"].shape


def test_sharded_int8_job_matches_the_reference():
    kw = dict(rounds=3, seed=0, compression="int8", sample="uniform:2",
              dropout_scenario="shutdown", shard_sites=True)
    jjob = JJob(task=JTask(**TINY), **kw)
    jres = jjob.run()
    tres = hold_job_to_jax(FederatedJob(task=TaskConfig(**TINY), device="cpu", **kw),
                           jjob, jres)
    for th, jh in zip(tres.history, jres.history):
        assert (th["participants"], th["k_cap"]) == (jh["participants"], jh["k_cap"])
        assert np.array_equal(np.isnan(th["per_site_loss"]), np.isnan(jh["per_site_loss"]))


def test_device_blocks_agree_with_one_block():
    job = _job(task=TaskConfig(**dict(TINY, sites=5)), rounds=3, strategy="fedprox",
               compression="int8", topology="pods:2", sample="uniform:3",
               dropout_scenario="shutdown")
    bundle = job.task.build()
    codec, down = job.codecs()
    runs = [round_engine.execute_sharded(job, bundle, SyncScheduler(), job.rounds, codec, down,
                                         devices=[CPU] * d) for d in (1, 2, 3)]
    one = runs[0]
    for d, res in zip((2, 3), runs[1:]):
        assert res.comm == {**one.comm, "devices": d, "k_cap": res.comm["k_cap"]}
        torch.testing.assert_close(_flat(res.global_params), _flat(one.global_params),
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(res.state["params"], one.state["params"],
                                   rtol=1e-5, atol=1e-6)
        for a, b in zip(res.history, one.history):
            np.testing.assert_allclose(a["per_site_loss"], b["per_site_loss"], rtol=1e-5)
    assert runs[1].history[0]["k_cap"] <= one.history[0]["k_cap"]


@pytest.mark.parametrize("strategy", ["fedavg", "fedprox"])
def test_non_participants_stay_frozen(strategy):
    job = _job(task=TaskConfig(**dict(TINY, sites=6)), rounds=3, sample="uniform:2",
               dropout_scenario="shutdown", shard_sites=True, strategy=strategy)
    res = job.run()
    participate, _ = job.participation(job.rounds)
    init = _flat(job.task.build().init_fn(job.seed))
    never = ~participate.any(axis=0)
    assert never.any()
    state = res.state
    for i in np.flatnonzero(never):
        assert torch.equal(state["params"][i], init)
        assert not state["opt"]["mu"][i].any() and not state["opt"]["nu"][i].any()
        assert int(state["opt"]["step"][i]) == 0
    # the last round's global, installed on its participants (FedProx's
    # anchor is that global)
    last = [state["params"][i] for i in np.flatnonzero(participate[-1])]
    assert all(torch.equal(row, last[0]) for row in last)
    if strategy == "fedprox":
        assert torch.equal(state["strategy"]["global"], last[0])
    # the result's global: Eq. 1 over every row at the case weights
    w = torch.full((6,), 1 / 6)
    assert torch.equal(_flat(res.global_params), ops.fedagg(state["params"], w))
    for h, row in zip(res.history, participate):
        assert h["participants"] == 2 and h["k_cap"] == 2
        assert np.array_equal(np.isnan(h["per_site_loss"]), ~row)


def test_site_devices():
    assert site_devices(device="cpu") == [CPU]
    assert site_devices(1, device="cpu") == [CPU]
    with pytest.raises(ValueError, match="outside"):
        site_devices(2, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        site_devices(0, device="cpu")


# the reference's refusals of shard_sites=True, in its order of checks
REFUSED = [
    dict(scheduler="buffered"),
    dict(strategy="gcml"),
    dict(compression="fp8"),
    dict(down_compression="int8"),
    dict(device_data=True),
    dict(dp_clip=1.0, dp_noise_multiplier=1.0),
    dict(aggregator="trimmed:1"),
    dict(sample="uniform:2"),
    dict(max_dropout=1),
]


@pytest.mark.parametrize("kw", REFUSED, ids=[",".join(k) for k in REFUSED])
def test_refusals_raise_the_reference_value_error(kw):
    with pytest.raises(ValueError) as want:
        JJob(task=JTask(**TINY), rounds=1, shard_sites=True, **kw).run()
    with pytest.raises(ValueError) as got:
        FederatedJob(task=TaskConfig(**TINY), rounds=1, shard_sites=True, device="cpu",
                     **kw).run()
    assert str(got.value) == str(want.value)
    assert "shard" in str(got.value)


def test_resume_and_socket_refusals(tmp_path):
    job = _job(shard_sites=True, checkpoint_dir=str(tmp_path), ckpt_every=1)
    job.replace(shard_sites=False).run(rounds=1)
    with pytest.raises(ValueError, match="does not checkpoint its sharded carry"):
        job.run(resume=True)
    with pytest.raises(ValueError, match="shard_sites=True shards"):
        job.replace(transport="thread").run()
