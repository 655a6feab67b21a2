"""The port's two-tier topology against the JAX reference.

The same numpy inputs go to both packages; the jobs start from the
reference's initial parameters (converted) at the tiny size (8^3, 4
filters, 4 sites, 3 rounds).  What is held, and at what tolerance:

- ``Topology``, ``resolve_topology``, ``pod_of``, ``members``,
  ``validate`` and their errors; ``pod_availability_masks``, the site x
  pod composition (its empty-round rule) and its composition with client
  sampling; ``active_pod_counts`` and ``simulated_pods_comm``: equal, bit
  for bit and word for word;
- ``reduce_pods_flat`` and ``reduce_pods_robust`` against the reference's
  engine under its Pallas interpreter: rtol 1e-6, atol 1e-7 (the one-hot
  contraction sums at most five fp32 products a coordinate in another
  order; the trimmed mean sorts the same values and adds the same ranks);
  Krum's pick verbatim;
- stacked jobs: per-site losses rtol 1e-4, atol 1e-5 (fp32 round-off
  through a few AdamW steps), ``comm`` equal, and the global within ``lr *
  rounds`` of the reference's: AdamW's first step is about ``lr *
  sign(g)`` and flips where float noise flips the sign of a near-zero
  gradient (the GroupNorm-fed conv biases), while the median coordinate
  agrees to 1e-6;
- socket pods jobs (thread and tcp) against the reference's stacked pods
  job: losses rtol 1e-4, atol 1e-5, and the socket jobs' bound on the
  global (rtol 2e-3, atol 2e-4, the GroupNorm-fed conv biases within
  ``lr * rounds``: the fold order follows the arrivals);
- a per-tier buffered composition on sockets: the reference's own
  invariants (finite losses, uploads equal to the folds, cross-pod bytes
  above 0), since the arrival order follows the threads.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_jax_helpers import assert_globals_close, reference_init  # noqa: E402

from repro.api import FederatedJob as JJob  # noqa: E402
from repro.api import TaskConfig as JTask  # noqa: E402
from repro.core import agg_engine as JE  # noqa: E402
from repro.core import session as jsess  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.core import agg_engine as TE  # noqa: E402
from repro_torch.core import session as tsess  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TINY = dict(kind="dose", sites=4, batch=1, volume=(8, 8, 8), base_filters=4)
POD_TOL = dict(rtol=1e-6, atol=1e-7)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch thread for this module's tiny models (the suite runs in
    several worker processes on one host's cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _outcome(fn):
    """``("ok", value)`` or ``(exception type name, message)``."""
    try:
        return "ok", fn()
    except (ValueError, KeyError) as e:
        return type(e).__name__, str(e)


def _same(a, b):
    assert a[0] == b[0], (a, b)
    if a[0] != "ok":
        assert a[1] == b[1]
    elif isinstance(a[1], list):
        assert len(a[1]) == len(b[1]) and all(np.array_equal(x, y) for x, y in zip(*(a[1], b[1])))
    else:
        np.testing.assert_array_equal(a[1], b[1])


# -- the topology itself: bit-equal ------------------------------------------------


SPECS = ["flat", "pods:1", "pods:2", "pods:3", "pods:7", "pods", "pods:x", "ring", None,
         dict(kind="pods", num_pods=3, assignment=(2, 0, 2, 0)),
         dict(kind="pods", num_pods=2, assignment=(0, 1, 1)),
         dict(kind="pods", num_pods=2, assignment=(0, 2, 1, 1)),
         dict(kind="pods", num_pods=2, intra="uniform", inter="uniform"),
         dict(kind="ring"), dict(kind="pods", intra="median"),
         dict(kind="pods", inter="mean"), dict(kind="pods", num_pods=0)]


@pytest.mark.parametrize("spec", SPECS, ids=[str(i) for i in range(len(SPECS))])
def test_topology_resolution_and_structure_bit_equal(spec):
    def resolve(mod):
        return mod.Topology(**spec) if isinstance(spec, dict) else mod.resolve_topology(spec)
    j, t = _outcome(lambda: resolve(jtopo)), _outcome(lambda: resolve(ttopo))
    assert t[0] == j[0] and (j[0] == "ok" or t[1] == j[1]), (t, j)
    if j[0] != "ok":
        return
    jt, tt = j[1], t[1]
    assert (tt.kind, tt.num_pods, tt.assignment, tt.intra, tt.inter, tt.is_pods) == \
        (jt.kind, jt.num_pods, jt.assignment, jt.intra, jt.inter, jt.is_pods)
    for s in (1, 2, 3, 4, 5):
        _same(_outcome(lambda: jt.pod_of(s)), _outcome(lambda: tt.pod_of(s)))
        _same(_outcome(lambda: jt.members(s)), _outcome(lambda: tt.members(s)))
        _same(_outcome(lambda: jt.validate(s)), _outcome(lambda: tt.validate(s)))


@pytest.mark.parametrize("num_pods,sites,pod_dropout,seed", [
    (2, 4, 1, 0), (3, 6, 2, 7), (4, 5, 1, 3), (2, 2, 1, 11), (3, 3, 0, 1)])
def test_pod_masks_and_their_composition_bit_equal(num_pods, sites, pod_dropout, seed):
    jt, tt = jtopo.Topology.pods(num_pods), ttopo.Topology.pods(num_pods)
    want = jtopo.pod_availability_masks(jt, sites, pod_dropout, seed, 40)
    got = ttopo.pod_availability_masks(tt, sites, pod_dropout, seed, 40)
    np.testing.assert_array_equal(got, want)
    for max_dropout in range(min(sites, 2)):
        want = jsess.availability_masks(sites, max_dropout, seed, 40, topology=jt,
                                        pod_dropout=pod_dropout)
        got = tsess.availability_masks(sites, max_dropout, seed, 40, topology=tt,
                                       pod_dropout=pod_dropout)
        np.testing.assert_array_equal(got, want)
        assert got.any(axis=1).all()                 # the empty-round rule held
        np.testing.assert_array_equal(ttopo.active_pod_counts(tt, got),
                                      jtopo.active_pod_counts(jt, want))
        for kw2 in (dict(), dict(intra_upload_bytes=123, compression="int8"),
                    dict(intra_upload_bytes=77, intra_download_bytes=55,
                         compression="int8", down_compression="int8")):
            assert ttopo.simulated_pods_comm(tt, got, 4096, **kw2) == \
                jtopo.simulated_pods_comm(jt, want, 4096, **kw2)
    with pytest.raises(ValueError) as je:
        jtopo.pod_availability_masks(jt, sites, num_pods, seed, 2)
    with pytest.raises(ValueError) as te:
        ttopo.pod_availability_masks(tt, sites, num_pods, seed, 2)
    assert str(te.value) == str(je.value)


def test_empty_intersection_rounds_take_the_pod_tier():
    """2 sites in 2 pods, both chains dropping one: rounds where the site
    chain keeps one pod's site and the pod chain the other's are empty
    intersections, and the pod tier's mask wins there."""
    topo = ttopo.Topology.pods(2)
    hit = 0
    for seed in range(12):
        site = tsess.availability_masks(2, 1, seed, 40)
        pod = ttopo.pod_availability_masks(topo, 2, 1, seed, 40)
        got = tsess.availability_masks(2, 1, seed, 40, topology=topo, pod_dropout=1)
        empty = ~(site & pod).any(axis=1)
        hit += int(empty.sum())
        np.testing.assert_array_equal(got[empty], pod[empty])
        np.testing.assert_array_equal(got[~empty], (site & pod)[~empty])
        np.testing.assert_array_equal(got, jsess.availability_masks(
            2, 1, seed, 40, topology=jtopo.Topology.pods(2), pod_dropout=1))
    assert hit > 0


@pytest.mark.parametrize("kw", [
    dict(topology="pods:2", pod_dropout=1, max_dropout=1, sample="uniform:3"),
    dict(topology="pods:2", pod_dropout=1, sample="poisson:0.5", seed=4),
    dict(topology="pods:3", max_dropout=2, sample="uniform:2", seed=2),
    dict(topology="flat", max_dropout=1, sample="poisson:0.75")])
def test_job_participation_with_sampling_bit_equal(kw):
    task = {**TINY, "sites": 5}
    jp, js = JJob(task=JTask(**task), **kw).participation(30)
    tp, ts = FederatedJob(task=TaskConfig(**task), device="cpu", **kw).participation(30)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ts, js)
    assert ts.dtype == js.dtype


def test_pod_dropout_needs_pods_in_both_packages():
    for job in (JJob(task=JTask(**TINY), pod_dropout=1),
                FederatedJob(task=TaskConfig(**TINY), device="cpu", pod_dropout=1)):
        with pytest.raises(ValueError, match="pod_dropout requires a pods topology"):
            job.masks(3)


# -- the engine's two tiers against the reference's under its Pallas interpreter ---


def _rows(s, n, seed):
    return np.random.default_rng(seed).normal(size=(s, n)).astype(np.float32)


def _jengine():
    return JE.AggregationEngine(use_pallas=True, interpret=True)


@pytest.mark.parametrize("intra,inter", [("fedavg", "fedavg"), ("uniform", "fedavg"),
                                         ("fedavg", "uniform"), ("uniform", "uniform")])
@pytest.mark.parametrize("case", ["contiguous", "arbitrary-empty-pod", "scaled"])
def test_reduce_pods_flat_matches_reference_engine(intra, inter, case):
    flat = _rows(5, 1031, 3)
    cw = np.random.default_rng(4).dirichlet(np.ones(5)).astype(np.float32)
    active = np.array([True, False, True, True, True])
    pods, num_pods, scale = np.array([0, 0, 0, 1, 1]), 2, None
    if case == "arbitrary-empty-pod":
        pods, num_pods = np.array([2, 0, 2, 0, 3]), 4          # pod 1 has no site
        active = np.array([True, True, True, False, False])    # pod 3 none active
    if case == "scaled":
        scale = np.random.default_rng(5).uniform(1, 3, 5).astype(np.float32)
    want = _jengine().reduce_pods_flat(
        jnp.asarray(flat), jnp.asarray(cw), jnp.asarray(active), jnp.asarray(pods), num_pods,
        intra, inter, scale=None if scale is None else jnp.asarray(scale))
    got = TE.get_engine().reduce_pods_flat(
        torch.from_numpy(flat), torch.from_numpy(cw), active, pods, num_pods, intra, inter,
        scale=None if scale is None else torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **POD_TOL)


@pytest.mark.parametrize("spec", ["trimmed:1", "median", "krum:1"])
@pytest.mark.parametrize("inter", ["fedavg", "uniform"])
def test_reduce_pods_robust_matches_reference_engine(spec, inter):
    """Pods of 1, 2 and 3 members (``trimmed:1`` clamps to ``(k - 1) // 2``
    in the small ones), one member inactive, and a pod with no active
    member (zero partial at weight 0)."""
    flat = _rows(8, 2053, 6)
    flat[3, :7] = 50.0                                   # an outlier in pod 2
    pods = np.array([0, 1, 1, 2, 2, 2, 3, 3])
    active = np.array([True, True, True, True, True, False, False, False])
    want = _jengine().reduce_pods_robust(jnp.asarray(flat), jnp.asarray(active),
                                         jnp.asarray(pods), 4, JE.parse_aggregator(spec),
                                         inter)
    got = TE.get_engine().reduce_pods_robust(torch.from_numpy(flat), active, pods, 4,
                                             TE.parse_aggregator(spec), inter)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **POD_TOL)


@pytest.mark.parametrize("aggregator", ["fedavg", "normclip:2", "median"])
def test_aggregate_pods_and_hierarchical_match_reference(aggregator):
    rng = np.random.default_rng(8)
    tree = {"w": rng.normal(size=(6, 3, 5)).astype(np.float32),
            "b": rng.normal(size=(6, 7)).astype(np.float32)}
    cw = np.array([1, 2, 3, 1, 2, 3], np.float32) / 12
    active = np.array([True, True, False, True, True, True])
    pods = np.array([1, 0, 1, 0, 1, 0])
    jnew, jg = _jengine().aggregate_pods(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(cw), jnp.asarray(pods), 2,
        jnp.asarray(active), aggregator=JE.parse_aggregator(aggregator))
    tnew, tg = TE.get_engine().aggregate_pods(
        {k: torch.from_numpy(v) for k, v in tree.items()}, torch.from_numpy(cw), pods, 2,
        active, aggregator=TE.parse_aggregator(aggregator))
    for k in tree:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), **POD_TOL)
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]), **POD_TOL)
    jnew, jg = _jengine().aggregate_hierarchical(jax.tree.map(jnp.asarray, tree),
                                                 jnp.asarray(cw), 3, jnp.asarray(active))
    tnew, tg = TE.get_engine().aggregate_hierarchical(
        {k: torch.from_numpy(v) for k, v in tree.items()}, torch.from_numpy(cw), 3, active)
    for k in tree:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), **POD_TOL)
    with pytest.raises(ValueError, match="does not divide"):
        TE.get_engine().aggregate_hierarchical(
            {k: torch.from_numpy(v) for k, v in tree.items()}, torch.from_numpy(cw), 4)


# -- stacked jobs -----------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_job(items):
    """The reference's job (cached: the socket tests reuse the stacked
    pods job) and its initial parameters in the port's layout."""
    kw = dict(items)
    jjob = JJob(task=JTask(**TINY), rounds=3, **kw)
    return jjob.run(), reference_init(jjob), jjob


def _held_to_reference(tres, jres, jjob):
    assert [h["active"] for h in tres.history] == [h["active"] for h in jres.history]
    for th, jh in zip(tres.history, jres.history):
        np.testing.assert_allclose(th["per_site_loss"], jh["per_site_loss"], **LOSS_TOL)
    want = convert.from_reference(jax.tree.map(np.asarray, jres.global_params))
    diff = torch.cat([(a - b).abs().reshape(-1) for a, b in
                      zip(tree_leaves(tres.global_params), tree_leaves(want))])
    assert float(diff.max()) <= jjob.lr * jjob.rounds
    assert float(diff.median()) <= 1e-6


STACKED = {
    "fedavg-case-counts": (("topology", "pods:2"), ("case_counts", (3, 1, 2, 2))),
    "fedprox-sampled": (("strategy", "fedprox"), ("topology", "pods:2"),
                        ("sample", "uniform:3"), ("prox_mu", 0.5)),
    "trimmed-pod-dropout": (("topology", ttopo.Topology(kind="pods", num_pods=2,
                                                        assignment=(0, 0, 0, 1))),
                            ("aggregator", "trimmed:1"), ("pod_dropout", 1),
                            ("max_dropout", 1), ("seed", 3)),
    "int8-both-ways": (("topology", "pods:2"), ("compression", "int8"),
                       ("down_compression", "int8"), ("max_dropout", 1)),
}


@pytest.mark.parametrize("name", list(STACKED))
def test_stacked_pods_job_matches_jax_job(name):
    items = STACKED[name]
    jitems = tuple((k, jtopo.Topology(**{f: getattr(v, f) for f in ("kind", "num_pods",
                                                                   "assignment")})
                    if isinstance(v, ttopo.Topology) else v) for k, v in items)
    jres, init, jjob = _jax_job(jitems)
    tres = FederatedJob(task=TaskConfig(**TINY), rounds=3, device="cpu",
                        **dict(items)).run(init_params=init)
    _held_to_reference(tres, jres, jjob)
    assert tres.comm == jres.comm
    assert tres.comm["pods"] == 2 and tres.comm["cross_pod_upload_bytes"] > 0
    if name == "trimmed-pod-dropout":
        # a round with a whole pod offline ran
        masks = FederatedJob(task=TaskConfig(**TINY), device="cpu", **dict(items)).masks(3)
        assert any(not m[:3].any() or not m[3] for m in masks)


# -- socket pods jobs against the reference's stacked pods job ---------------------


@pytest.mark.parametrize("transport", ["thread", "tcp"])
def test_socket_pods_job_matches_reference_stacked_pods_job(transport):
    jres, init, jjob = _jax_job(STACKED["fedavg-case-counts"])
    tres = FederatedJob(task=TaskConfig(**TINY), rounds=3, device="cpu", transport=transport,
                        **dict(STACKED["fedavg-case-counts"])).run(init_params=init)
    for th, jh in zip(tres.history, jres.history):
        np.testing.assert_allclose(th["per_site_loss"], jh["per_site_loss"], **LOSS_TOL)
    assert_globals_close(convert.to_reference(tres.global_params), jres.global_params,
                         jjob.lr * jjob.rounds)
    c = tres.comm
    assert c["pods"] == 2 and c["upload_count"] == 12 and not c["simulated"]
    assert c["upload_bytes"] == c["intra_pod_upload_bytes"] + c["cross_pod_upload_bytes"]
    assert c["cross_pod_upload_bytes"] > 0 and c["cross_pod_download_bytes"] > 0


def test_socket_per_tier_buffered_composition_holds_its_invariants():
    """A sync pod tier under a buffered root (and the reverse): the
    reference's invariants.  Each round's uploads fold; the losses stay
    finite; the cross-pod link carries bytes; no staleness runs away."""
    from repro_torch.core.session import BufferedScheduler
    for topo in (ttopo.Topology.pods(2, inter_scheduler=BufferedScheduler(buffer_k=1)),
                 ttopo.Topology.pods(2, intra_scheduler=BufferedScheduler(buffer_k=1))):
        res = FederatedJob(task=TaskConfig(**TINY), rounds=3, device="cpu", transport="thread",
                           topology=topo, io_timeout=30).run()
        assert np.isfinite(res.losses).all()
        assert res.comm["upload_count"] == 12
        assert res.comm["cross_pod_upload_bytes"] > 0
        assert all(s <= 1 for s in res.history[-1]["stale_uploads"])


def test_socket_pods_resume_reproduces_the_uninterrupted_run(tmp_path):
    """``run(resume=True)`` under pods: the root server checkpoints the
    global, each site its state; the resumed rounds reproduce the
    uninterrupted run (dense: the leaders hold no codec state)."""
    kw = dict(task=TaskConfig(**TINY), seed=0, device="cpu", transport="thread",
              topology="pods:2", ckpt_every=1)
    ref = FederatedJob(rounds=3, **kw).run()
    job = FederatedJob(rounds=3, checkpoint_dir=str(tmp_path), **kw)
    job.run(rounds=2)
    res = job.run(rounds=3, resume=True)
    assert res.resumed_from == 1 and len(res.history) == 1
    np.testing.assert_allclose(res.losses, ref.losses[2:], rtol=1e-5)
    for a, b in zip(tree_leaves(res.global_params), tree_leaves(ref.global_params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_whole_pod_dropout_survives_on_sockets():
    """A thread pods job whose schedule takes a whole pod offline: the
    root's barrier counts the active pods, the offline pod's leader skips
    its partial, and the job ends."""
    job = FederatedJob(task=TaskConfig(**TINY), rounds=3, device="cpu", transport="thread",
                       topology="pods:2", pod_dropout=1, seed=3, io_timeout=30)
    masks = job.masks(3)
    assert any(not m[:2].any() or not m[2:].any() for m in masks)
    res = job.run()
    assert np.isfinite(res.losses).all()
    assert res.comm["upload_count"] == int(masks.sum())
