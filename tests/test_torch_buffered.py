"""The port's buffered (FedBuff) rounds against the JAX reference.

The same numpy inputs go to both packages; the jobs start from the
reference's initial parameters (converted) at the tiny size (8^3, 4
filters, 4 sites, 3 rounds).  What is held, and at what tolerance:

- ``BufferedScheduler``'s ``discount``, ``ready`` and
  ``staleness_weights``, ``resolve_scheduler``, the arrival orders and the
  host-computed schedule (who folds, who resyncs, when a version fires):
  equal, bit for bit;
- the aggregation server's buffered branch, port against JAX on the same
  uploads (K-of-S, the staleness discount, the stale rejection, int8
  deltas decoded against the global of their version): rtol 1e-6 (both
  fold the same decoded fp32 uploads in the same order);
- stacked buffered jobs (the reference's scan engine, dense and int8, and
  its host loop past the decode ring): per-site losses rtol 1e-4, atol
  1e-5 (fp32 round-off through a few AdamW steps), ``comm`` and the
  recorded versions equal, and the global within ``lr * rounds`` of the
  reference's (AdamW's first step is about ``lr * sign(g)`` and flips
  where float noise flips a near-zero gradient's sign), the median
  coordinate within 1e-6;
- a buffered socket job: the reference's own invariants (finite losses,
  uploads equal to the participation, staleness bounded), since its
  arrival order follows the threads;
- the edge rules a site and a pod leader share (``edge_rounds``,
  ``UploadCompressor.encode_against``): the reference site's upload round,
  pull and dense re-send past its ``KEEP_GLOBALS_DEFAULT`` window, exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_jax_helpers import reference_init  # noqa: E402

from repro.api import FederatedJob as JJob  # noqa: E402
from repro.api import TaskConfig as JTask  # noqa: E402
from repro.comms import compression as jcomp  # noqa: E402
from repro.comms.coordinator import AggregationServer as JServer  # noqa: E402
from repro.comms.peer import Peer as JPeer  # noqa: E402
from repro.core import round_engine as jre  # noqa: E402
from repro.core import session as jsess  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.comms import compression as tcomp  # noqa: E402
from repro_torch.comms.coordinator import AggregationServer  # noqa: E402
from repro_torch.core import round_engine as tre  # noqa: E402
from repro_torch.core import session as tsess  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TINY = dict(kind="dose", sites=4, batch=1, volume=(8, 8, 8), base_filters=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch thread for this module's tiny models (the suite runs in
    several worker processes on one host's cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


SCHEDULERS = [dict(), dict(buffer_k=1), dict(buffer_k=3, alpha=1.0, max_staleness=2),
              dict(buffer_k=2, alpha=0.25, max_staleness=0), dict(max_staleness=16)]


@pytest.mark.parametrize("kw", SCHEDULERS)
def test_buffered_scheduler_bit_equal(kw):
    j, t = jsess.BufferedScheduler(**kw), tsess.BufferedScheduler(**kw)
    assert t.name == j.name == "buffered"
    for tau in range(-2, 20):
        assert t.discount(tau) == j.discount(tau)
    for buffered in range(6):
        for expected in range(6):
            assert t.ready(buffered, expected) == j.ready(buffered, expected)
    taus = [tau for tau in range(5) if j.discount(tau) is not None]
    np.testing.assert_array_equal(t.staleness_weights(taus), j.staleness_weights(taus))
    assert t.staleness_weights(taus).dtype == np.float32
    with pytest.raises(ValueError) as je:
        j.staleness_weights([j.max_staleness + 1])
    with pytest.raises(ValueError) as te:
        t.staleness_weights([t.max_staleness + 1])
    assert str(te.value) == str(je.value)


def test_resolve_scheduler_bit_equal():
    for spec in (None, "sync", "buffered"):
        assert type(tsess.resolve_scheduler(spec)).__name__ == \
            type(jsess.resolve_scheduler(spec)).__name__
    sched = tsess.BufferedScheduler(buffer_k=3)
    assert tsess.resolve_scheduler(sched) is sched
    with pytest.raises(KeyError) as je:
        jsess.resolve_scheduler("bogus")
    with pytest.raises(KeyError) as te:
        tsess.resolve_scheduler("bogus")
    assert str(te.value) == str(je.value)


def _masks(sites, rounds, seed):
    return tsess.availability_masks(sites, min(2, sites - 1), seed, rounds)


@pytest.mark.parametrize("sites,seed", [(1, 0), (4, 1), (5, 7), (9, 3)])
def test_arrival_orders_bit_equal(sites, seed):
    masks = _masks(sites, 25, seed)
    for got, want in zip(tre.arrival_orders(masks, seed), jre._arrival_orders(masks, seed)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def _reference_replay(masks, seed, sched):
    """The reference's buffered host loop (``api._execute_buffered``), its
    integer half: per round the (site, admitted, fired) arrivals and the
    version after the round."""
    rng = np.random.default_rng(seed + 13)
    version, count = 0, 0
    base = np.zeros(masks.shape[1], np.int64)
    rounds, versions = [], []
    for r in range(masks.shape[0]):
        active = np.flatnonzero(masks[r])
        arrivals, uploaded = [], []
        for site in rng.permutation(active):
            site = int(site)
            if sched.discount(version - int(base[site])) is None:
                base[site] = version
                arrivals.append((site, False, False))
                continue
            count += 1
            uploaded.append(site)
            fire = sched.ready(count, len(active))
            if fire:
                version += 1
                count = 0
            arrivals.append((site, True, fire))
        base[uploaded] = version
        rounds.append(arrivals)
        versions.append(version)
    return rounds, versions


@pytest.mark.parametrize("kw", SCHEDULERS)
@pytest.mark.parametrize("sites,seed", [(4, 0), (6, 5)])
def test_buffered_schedule_is_the_reference_loop(kw, sites, seed):
    masks = _masks(sites, 30, seed)
    cw = np.random.default_rng(seed).dirichlet(np.ones(sites)).astype(np.float32)
    arrivals, versions = tre.buffered_schedule(masks, seed, tsess.BufferedScheduler(**kw), cw)
    want, want_versions = _reference_replay(masks, seed, jsess.BufferedScheduler(**kw))
    assert versions == want_versions
    assert [[(a.site, a.admit, a.fire) for a in rnd] for rnd in arrivals] == want
    jsched = jsess.BufferedScheduler(**kw)
    for rnd in arrivals:
        for a in rnd:
            if a.admit:       # the scan's fp32 weight: case weight x discount
                assert np.isclose(a.weight, cw[a.site] * jsched.discount(a.tau), rtol=1e-6)


# -- the aggregation server's buffered branch, port against JAX --------------------


def _buffered_exchange(server, peer_cls, int8):
    """Uploads in an order that exercises the buffered server: K-of-S
    fires, a late upload at a discount, a stale rejection, and (int8) a
    delta decoded against the global of its version; returns each pull's
    (round, global) and the acks' stale flags."""
    rng = np.random.default_rng(0)
    trees = [{"w": rng.normal(size=(6, 50)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)} for _ in range(9)]
    peers = [peer_cls(i) for i in range(3)]
    comps = [jcomp.UploadCompressor(jcomp.Int8Codec(use_kernel=False)) for _ in peers]
    held = {}                               # site -> (round, global it pulled)
    pulls, stale = [], []

    def upload(site, tree, upload_round):
        meta = None
        if int8:
            base = held.get(site)
            tree, meta = comps[site].encode(tree, None if base is None else base[1])
            meta["base_round"] = 0 if base is None else base[0]
        stale.append(bool(peers[site].upload(server.addr, tree, upload_round,
                                             active_sites=3, meta_extra=meta).get("stale")))

    def pull(site):
        g, meta = peers[site].download(server.addr, 0, with_meta=True)
        if g is not None:
            held[site] = (int(meta["round"]), jax.tree.map(np.asarray, g))
            pulls.append((int(meta["round"]), held[site][1]))

    try:
        upload(0, trees[0], 1)
        upload(1, trees[1], 1)               # fires version 1
        pull(0)
        pull(1)
        upload(2, trees[2], 1)               # staleness 1: discounted
        upload(0, trees[3], 2)               # fires version 2
        pull(0)
        upload(1, trees[4], 2)               # staleness 1
        upload(2, trees[5], 1)               # staleness 2 > 1: stale
        pull(2)
        upload(0, trees[6], 3)               # fires version 3
        pull(0)
        pull(1)
        upload(1, trees[7], 2)               # staleness 2: stale
        upload(2, trees[8], 3)
        upload(0, trees[0], 4)               # fires version 4
        pull(2)
        return pulls, stale
    finally:
        for p in peers:
            p.close()
        server.stop()


@pytest.mark.parametrize("int8", [False, True])
def test_buffered_server_matches_the_jax_server(int8):
    cw = [1.0, 2.0, 3.0]
    sched = dict(buffer_k=2, alpha=0.5, max_staleness=1)
    want, want_stale = _buffered_exchange(
        JServer("127.0.0.1", 0, num_sites=3, case_weights=cw,
                scheduler=jsess.BufferedScheduler(**sched)), JPeer, int8)
    got, got_stale = _buffered_exchange(
        AggregationServer("127.0.0.1", 0, num_sites=3, case_weights=cw, device="cpu",
                          scheduler=tsess.BufferedScheduler(**sched)), JPeer, int8)
    assert got_stale == want_stale and sum(want_stale) == 2
    assert [r for r, _ in got] == [r for r, _ in want] == [1, 1, 2, 2, 3, 3, 4]
    for (_, g), (_, w) in zip(got, want):
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


# -- stacked buffered jobs ------------------------------------------------------------


STACKED = {
    "dense-dropout": (dict(buffer_k=2), dict(max_dropout=1)),
    "dense-stale-resync": (dict(buffer_k=1, max_staleness=0), dict(max_dropout=1, seed=2)),
    "int8-scan": (dict(buffer_k=2), dict(compression="int8", max_dropout=1)),
    "int8-host-loop": (dict(buffer_k=3, max_staleness=16),
                       dict(compression="int8", case_counts=(3, 1, 2, 2))),
}


@pytest.mark.parametrize("name", list(STACKED))
def test_stacked_buffered_job_matches_jax_job(name):
    sched, kw = STACKED[name]
    jjob = JJob(task=JTask(**TINY), rounds=3, scheduler=jsess.BufferedScheduler(**sched), **kw)
    jres = jjob.run()
    tres = FederatedJob(task=TaskConfig(**TINY), rounds=3, device="cpu",
                        scheduler=tsess.BufferedScheduler(**sched), **kw).run(
                            init_params=reference_init(jjob))
    assert tres.scheduler == jres.scheduler == "buffered"
    assert [h["version"] for h in tres.history] == [h["version"] for h in jres.history]
    assert [h["active"] for h in tres.history] == [h["active"] for h in jres.history]
    for th, jh in zip(tres.history, jres.history):
        np.testing.assert_allclose(th["per_site_loss"], jh["per_site_loss"],
                                   rtol=1e-4, atol=1e-5)
    assert tres.comm == jres.comm
    want = convert.from_reference(jax.tree.map(np.asarray, jres.global_params))
    diff = torch.cat([(a - b).abs().reshape(-1) for a, b in
                      zip(tree_leaves(tres.global_params), tree_leaves(want))])
    assert float(diff.max()) <= jjob.lr * jjob.rounds
    assert float(diff.median()) <= 1e-6
    if name == "dense-stale-resync":
        masks = FederatedJob(task=TaskConfig(**TINY), device="cpu", **kw).masks(3)
        arrivals, _ = tre.buffered_schedule(masks, 2, tsess.BufferedScheduler(**sched),
                                            np.full(4, 0.25, np.float32))
        assert any(not a.admit for rnd in arrivals for a in rnd)    # a site resynced


def test_buffered_socket_job_holds_its_invariants():
    res = FederatedJob(task=TaskConfig(**TINY), rounds=3, device="cpu", transport="thread",
                       scheduler=tsess.BufferedScheduler(buffer_k=2), max_dropout=1,
                       compression="int8", io_timeout=30).run()
    masks = FederatedJob(task=TaskConfig(**TINY), device="cpu", max_dropout=1).masks(3)
    assert res.scheduler == "buffered"
    assert np.isfinite(res.losses).all()
    assert res.comm["upload_count"] == int(masks.sum())
    assert all(s <= 1 for s in res.history[-1]["stale_uploads"])


# -- the edge rules of sites and pod leaders -------------------------------------------


@pytest.mark.parametrize("buffered,r,base_round", [(False, 4, 2), (True, 4, 2), (True, 0, 0)])
def test_edge_rounds_are_the_reference_sites(buffered, r, base_round):
    # the reference site: upload_round = base_round + 1 if buffered else r + 1;
    # it then downloads round 0 (the newest) if buffered, else r + 1
    want = (base_round + 1 if buffered else r + 1, 0 if buffered else r + 1)
    assert tcomp.edge_rounds(buffered, r, base_round) == want


@pytest.mark.parametrize("gap", [1, 15, 16, 20])
def test_encode_against_resends_dense_past_the_window(gap):
    tree = {"w": torch.linspace(-1.0, 1.0, 3000)}
    ref = {"w": torch.full((3000,), 0.25)}
    comp = tcomp.UploadCompressor(tcomp.resolve_codec("int8"), port=False)
    payload, meta = comp.encode_against(tree, ref, 4, 4 + gap)
    dense = gap >= jcomp.KEEP_GLOBALS_DEFAULT        # the reference server's window
    assert meta["delta"] is (not dense)
    assert meta["base_round"] == (0 if dense else 4)
    got = tcomp.decode_upload(payload, meta, None if dense else ref, plan=comp.plan(tree))
    np.testing.assert_allclose(got["w"].numpy(), tree["w"].numpy(), atol=1.25 / 127)
