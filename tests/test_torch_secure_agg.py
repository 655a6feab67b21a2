"""The port's secure aggregation against the JAX reference.

Sites mask their fixed-point uploads with pairwise Philox streams; the
server folds the words as a sum modulo 2^64 and unmasks once the barrier
closes.  The wire is shared, so the tests hold the port to the reference
bit for bit wherever the result is integer or is decoded from the same
integers:

- ``SecureAggClient.encode``: the masked words and the upload meta equal;
- ``SecureAggState.unmask`` of the same words: the fp32 global bit-equal
  (int64 on the port's device against the reference's uint64 numpy; both
  decode in float64), the recovered (round, site) pairs equal;
- a reference site's masked uploads folded on a port server: the global
  bit-equal to the reference server's (the modular sum does not depend on
  the fold's order);
- a dropped site's masks repaired: the reference's own test's bound, rtol
  1e-6, atol 1e-6, against the weighted mean of the sites that reported
  (the fixed point has 32 fractional bits);
- the thread job with ``secure_agg=True`` against the reference's: per-site
  losses rtol 1e-4, atol 1e-5 (fp32 round-off through a few AdamW steps),
  ``comm`` and ``privacy`` equal;
- the masked job against the port's plain job: the socket jobs' bound,
  rtol 2e-3, atol 2e-4, but the GroupNorm-fed conv biases within ``lr *
  rounds``.  A round's masked global differs from the plain fp32 fold by
  the fixed point's step (2^-32 a site, absolute) and the fold's fp32
  round-off; AdamW's next step turns that into about ``lr * sign(noise)``
  on the biases whose true gradient is zero.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_jax_helpers import assert_globals_close, reference_init  # noqa: E402

from repro.api import FederatedJob as JJob  # noqa: E402
from repro.api import TaskConfig as JTask  # noqa: E402
from repro.comms.coordinator import AggregationServer as JServer  # noqa: E402
from repro.comms.peer import Peer as JPeer  # noqa: E402
from repro.privacy import SecureAggClient as JClient  # noqa: E402
from repro.privacy import SecureAggState as JState  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.comms import transport as transport_mod  # noqa: E402
from repro_torch.comms.codec import MaskedTensor, encode_message  # noqa: E402
from repro_torch.comms.coordinator import AggregationServer  # noqa: E402
from repro_torch.comms.peer import Peer  # noqa: E402
from repro_torch.core.agg_engine import StreamingAccumulator  # noqa: E402
from repro_torch.privacy import SecureAggClient, SecureAggState, masked_values  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

CPU = "cpu"
TINY = dict(kind="dose", sites=3, batch=1, volume=(8, 8, 8), base_filters=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch thread for this module's tiny models (the suite runs in
    several worker processes on one host's cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(seed):
    """A reference-layout tree: a DHWIO conv leaf, odd sizes, a list."""
    rng = np.random.default_rng(seed)
    return {"conv": (rng.normal(size=(3, 3, 3, 2, 5)) * 0.1).astype(np.float32),
            "bias": (rng.normal(size=(5,)) * 0.1).astype(np.float32),
            "dense": [(rng.normal(size=(13, 7)) * 3.0).astype(np.float32),
                      np.full((1,), -2.5, np.float32)]}


def _words(tree):
    return [np.asarray(x.data["v"]) for x in tree_leaves(tree)]


@pytest.mark.parametrize("me,participants,rnd,weight", [
    (0, [0, 1, 2], 0, 1 / 3), (2, [0, 2, 3, 5], 7, 0.25), (4, [4], 1, 1.0)])
def test_client_encode_words_equal_the_reference(me, participants, rnd, weight):
    tree = _tree(me)
    got, gmeta = SecureAggClient("s3cret", "site", me).encode(tree, weight, participants, rnd)
    want, wmeta = JClient("s3cret", "site", me).encode(tree, weight, participants, rnd)
    assert gmeta == wmeta
    jleaves = jax.tree.leaves(want, is_leaf=lambda x: hasattr(x, "data"))
    assert [tuple(x.shape) for x in tree_leaves(got)] == [tuple(x.shape) for x in jleaves]
    for a, b in zip(_words(got), [np.asarray(x.data["v"]) for x in jleaves]):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    # the frame is the reference's too: the same words under the same skeleton
    from repro.comms.codec import encode_message as jencode
    assert encode_message("upload", gmeta, got) == jencode("upload", wmeta, want)


@pytest.mark.parametrize("me,participants,rnd", [(0, [0, 1], 0), (1, [0, 1, 2], 4), (2, [2], 1)])
def test_pod_tier_encode_and_unmask_equal_the_reference(me, participants, rnd):
    """The cross-pod tier: a leader's masked partial (ids are pod ids, the
    streams keyed by the tier "pod") and the root's unmask of the folded
    leaders, a missing pod repaired."""
    tree = _tree(10 + me)
    got, gmeta = SecureAggClient("s3cret", "pod", me).encode(tree, 0.5, participants, rnd)
    want, wmeta = JClient("s3cret", "pod", me).encode(tree, 0.5, participants, rnd)
    assert gmeta == wmeta and gmeta["tier"] == "pod"
    jleaves = jax.tree.leaves(want, is_leaf=lambda x: hasattr(x, "data"))
    for a, b in zip(_words(got), [np.asarray(x.data["v"]) for x in jleaves]):
        np.testing.assert_array_equal(a, b)
    masks = np.zeros((rnd + 1, 3), bool)
    masks[rnd, participants] = True
    words = [torch.from_numpy(w) for w in _words(got)]
    want_state, got_state = JState("s3cret", "pod", masks), SecureAggState("s3cret", "pod", masks)
    jw = want_state.unmask([w.numpy().view(np.uint64) for w in words], rnd, {me}, 0.5)
    tw = got_state.unmask(words, rnd, {me}, 0.5)
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a.numpy(), b)
    assert got_state.recovered == want_state.recovered
    np.testing.assert_allclose(tw[0].numpy(), tree["bias"], rtol=0, atol=1e-6)


def test_thread_pods_secure_agg_job_matches_the_plain_pods_job(monkeypatch):
    """Secure aggregation at both tiers: every upload on the wire (the
    sites' to their pod servers, the leaders' partials to the root) is
    masked, and the job's global is the plain pods job's within the socket
    jobs' bound (the GroupNorm-fed conv biases within ``lr * rounds``)."""
    violations, uploads = [], []

    def spy(kind, meta, tree):
        if kind == "upload":
            uploads.append(meta.get("tier"))
            violations.extend(x for x in tree_leaves(tree) if not isinstance(x, MaskedTensor))
        return encode_message(kind, meta, tree)

    job = FederatedJob(task=TaskConfig(**{**TINY, "sites": 4}), rounds=3, device=CPU,
                       transport="thread", topology="pods:2", max_dropout=1, seed=1)
    plain = job.run()
    monkeypatch.setattr(transport_mod, "encode_message", spy)
    masked = job.replace(secure_agg=True).run()
    masks = job.masks(3)
    pods_active = sum(int(m[:2].any()) + int(m[2:].any()) for m in masks)
    assert not violations
    assert uploads.count("site") == int(masks.sum()) and uploads.count("pod") == pods_active
    assert masked.privacy == {"secure_agg": True, "mechanism": "none"}
    assert masked.comm["cross_pod_upload_bytes"] > plain.comm["cross_pod_upload_bytes"]
    np.testing.assert_allclose(masked.losses, plain.losses, rtol=1e-4)
    assert_globals_close(convert.to_reference(masked.global_params),
                         convert.to_reference(plain.global_params), 1e-3 * 3)


@pytest.mark.parametrize("folded", [[0, 1, 2], [0, 2], [1]], ids=["all", "one-missing",
                                                                  "two-missing"])
def test_unmask_bit_equal_the_reference(folded):
    """The same folded words unmask to the same fp32 global, missing sites
    repaired by the same streams."""
    rng = np.random.default_rng(11)
    shapes = [(3, 3, 3, 2, 5), (5,), (13, 7)]
    words = [rng.integers(-2 ** 40, 2 ** 40, size=sh, dtype=np.int64) for sh in shapes]
    masks = np.ones((3, 3), bool)
    want_state, got_state = JState("k", "site", masks), SecureAggState("k", "site", masks)
    want = want_state.unmask([w.view(np.uint64) for w in words], 2, set(folded), 1.75)
    got = got_state.unmask([torch.from_numpy(w) for w in words], 2, set(folded), 1.75)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)
    assert got_state.recovered == want_state.recovered
    assert len(got_state.recovered) == 3 - len(folded)


def test_masked_fold_is_the_reference_modular_sum():
    """int64 additions on the device wrap as the reference's uint64 sum."""
    trees = [SecureAggClient("s", "site", i).encode(_tree(i), 0.5, [0, 1, 2], 3)[0]
             for i in range(3)]
    acc = StreamingAccumulator()
    for t in trees:
        acc.fold(masked_values(t, device=CPU), 1.0)
    assert acc.is_integer
    with pytest.raises(ValueError, match="finalize_int"):
        acc.finalize()
    with pytest.raises(ValueError, match="weight 1.0"):
        acc.fold(masked_values(trees[0], device=CPU), 0.5)
    got = [x.numpy().view(np.uint64) for x in tree_leaves(acc.finalize_int())]
    want = [sum((w.view(np.uint64) for w in ws), np.zeros(ws[0].shape, np.uint64))
            for ws in zip(*[_words(t) for t in trees])]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # the masks cancel: the sum is the three sites' fixed point
    fixed = [np.round(sum(np.asarray(x, np.float64) for x in xs) * 0.5 * 2.0 ** 32)
             .astype(np.int64).view(np.uint64)
             for xs in zip(*[tree_leaves(_tree(i)) for i in range(3)])]
    for a, b in zip(got, fixed):
        assert np.abs(a.view(np.int64) - b.view(np.int64)).max() <= 2


def _reference_uploads(server, sites=3, rounds=2):
    """Each round, every REFERENCE site's masked upload (its client, its
    peer); the downloaded globals."""
    peers = [JPeer(i) for i in range(sites)]
    weights = [1.0, 2.0, 3.0]
    try:
        out = []
        for r in range(rounds):
            for i, p in enumerate(peers):
                enc, meta = JClient("s", "site", i).encode(_tree(10 * r + i), weights[i],
                                                          list(range(sites)), r)
                ack = p.upload(server.addr, enc, r + 1, active_sites=sites, meta_extra=meta)
                assert not ack["stale"] and not ack.get("rejected")
            out.append(peers[0].download(server.addr, r + 1))
        return out
    finally:
        for p in peers:
            p.close()
        server.stop()


def test_reference_sites_fold_on_a_port_server_to_the_reference_global():
    masks = np.ones((2, 3), bool)
    want = _reference_uploads(JServer("127.0.0.1", 0, num_sites=3,
                                      secure_agg=JState("s", "site", masks)))
    got = _reference_uploads(AggregationServer("127.0.0.1", 0, num_sites=3, device=CPU,
                                               secure_agg=SecureAggState("s", "site", masks)))
    for g, w in zip(got, want):
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    expect = (_tree(10)["bias"] + 2 * _tree(11)["bias"] + 3 * _tree(12)["bias"]) / 6
    np.testing.assert_allclose(got[1]["bias"], expect, rtol=1e-6, atol=1e-6)


def test_masked_dropout_mid_round_seed_recovery():
    """A site that joins the round's schedule and dies mid-round (lease
    expiry) leaves its pairwise masks uncancelled; the server regenerates
    exactly those streams and the surviving sum is the weighted mean of the
    sites that did report."""
    rng = np.random.default_rng(0)
    models = [{"w": rng.normal(size=(64,)).astype(np.float32)} for _ in range(3)]
    weights = [1.0, 2.0, 3.0]
    sa = SecureAggState("s", "site", np.ones((1, 3), bool))
    srv = AggregationServer("127.0.0.1", 0, num_sites=3, case_weights=weights,
                            download_timeout=5.0, lease_ttl=0.3, secure_agg=sa, device=CPU)
    peers = [Peer(i) for i in range(3)]
    try:
        for i in range(3):
            peers[i].request(srv.addr, "join", {"site": i})
        for i in (0, 2):          # site 1 dies after joining the schedule
            enc, meta = SecureAggClient("s", "site", i).encode(models[i], weights[i],
                                                               [0, 1, 2], 0)
            ack = peers[i].upload(srv.addr, enc, 1, active_sites=3, meta_extra=meta)
            assert not ack["stale"]
        deadline = time.time() + 5.0
        g = None
        while time.time() < deadline:
            try:
                g, _ = peers[0].download(srv.addr, 1, with_meta=True)
                break
            except RuntimeError:
                pass
        assert g is not None, "lease expiry never unblocked the round"
        expect = (weights[0] * models[0]["w"] + weights[2] * models[2]["w"]) \
            / (weights[0] + weights[2])
        np.testing.assert_allclose(g["w"], expect, rtol=1e-6, atol=1e-6)
        assert sa.recovered == [(0, 1)]
    finally:
        for p in peers:
            p.close()
        srv.stop()


def test_masked_upload_rejected_without_server_state():
    """A masked payload at a server without ``SecureAggState`` errors out
    instead of folding garbage; mixing masked and plaintext uploads in one
    round is refused too."""
    srv = AggregationServer("127.0.0.1", 0, num_sites=2, download_timeout=2.0, device=CPU)
    sa_srv = AggregationServer("127.0.0.1", 0, num_sites=2, download_timeout=2.0, device=CPU,
                               secure_agg=SecureAggState("s", "site", np.ones((1, 2), bool)))
    peer = Peer(0)
    try:
        enc, meta = SecureAggClient("s", "site", 0).encode({"w": np.ones(4, np.float32)},
                                                           1.0, [0, 1], 0)
        with pytest.raises(RuntimeError, match="secure aggregation"):
            peer.upload(srv.addr, enc, 1, active_sites=2, meta_extra=meta)
        peer.upload(sa_srv.addr, enc, 1, active_sites=2, meta_extra=meta)
        with pytest.raises(RuntimeError, match="mixed masked and plaintext"):
            Peer(1).upload(sa_srv.addr, {"w": np.ones(4, np.float32)}, 1, active_sites=2)
    finally:
        peer.close()
        srv.stop()
        sa_srv.stop()
    with pytest.raises(ValueError, match="rank-based"):
        AggregationServer("127.0.0.1", 0, num_sites=2, device=CPU, aggregator="median",
                          secure_agg=SecureAggState("s", "site", np.ones((1, 2), bool)))


def test_no_plaintext_crosses_the_wire(monkeypatch):
    """With ``secure_agg`` on, every upload the sites encode is a tree of
    :class:`MaskedTensor` (the thread transport shares this process, so the
    spy sees every site's wire encode)."""
    violations, uploads = [], []

    def spy(kind, meta, tree):
        if kind == "upload":
            uploads.append(kind)
            violations.extend(x for x in tree_leaves(tree) if not isinstance(x, MaskedTensor))
        return encode_message(kind, meta, tree)

    monkeypatch.setattr(transport_mod, "encode_message", spy)
    res = FederatedJob(task=TaskConfig(**TINY), rounds=2, device=CPU, transport="thread",
                       secure_agg=True).run()
    assert np.isfinite(res.losses).all()
    assert len(uploads) == 6 and not violations


@pytest.mark.parametrize("strategy", ["fedavg", "fedprox"])
def test_thread_secure_agg_job_matches_jax_thread_job(strategy):
    kw = dict(strategy=strategy, rounds=3, seed=0, max_dropout=1, transport="thread",
              secure_agg=True)
    jjob = JJob(task=JTask(**TINY), **kw)
    jres = jjob.run()
    job = FederatedJob(task=TaskConfig(**TINY), device=CPU, **kw)
    tres = job.run(init_params=reference_init(jjob))
    assert min(h["active"] for h in jres.history) < 3       # a masked round ran
    for th, jh in zip(tres.history, jres.history):
        assert th["active"] == jh["active"]
        np.testing.assert_allclose(th["per_site_loss"], jh["per_site_loss"],
                                   rtol=1e-4, atol=1e-5)
    assert tres.comm == jres.comm                     # framing too: the same frames
    assert tres.privacy == jres.privacy == {"secure_agg": True, "mechanism": "none"}
    plain = job.replace(secure_agg=False).run(init_params=reference_init(jjob))
    assert plain.privacy is None
    assert_globals_close(tres.global_params, plain.global_params, jjob.lr * jjob.rounds)
    want = convert.from_reference(jax.tree.map(np.asarray, jres.global_params))
    assert_globals_close(tres.global_params, want, jjob.lr * jjob.rounds)
