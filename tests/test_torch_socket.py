"""The port's socket deployment against the JAX reference.

The wire layer (handshake, auth, TLS, streaming, retries, leases) is the
reference's ``tests/test_comms.py`` run against the port's modules, with
the port's ``AggregationServer`` on the CPU.  A port peer and a JAX server
(and the reverse) exchange int8 uploads on the same wire.  The jobs run in
both packages from the same initial parameters (the JAX init, converted)
and the same host batches, at the tiny size (8^3, 4 filters).

Tolerances, and why:

- cross-runtime globals: rtol 1e-6.  Both servers fold the same decoded
  fp32 uploads in the same order; each package decodes int8 with one fp32
  product a value;
- the robust rules at the server, port against JAX on the same uploads:
  rtol 1e-6 (atol 1e-7 for values that round to zero).  The rank rules
  sort the same fp32 values and average the kept ones (numpy's pairwise
  sum against the port's); Krum's pick is an upload verbatim; ``normclip``
  scales by the same float32 factor (both take the norm in float64);
- jobs, port against JAX: per-site losses rtol 1e-4, atol 1e-5 (fp32
  round-off through a few AdamW steps, as for the stacked jobs), the
  ``comm`` split equal byte for byte (the frames are the reference's), and
  globals within rtol 2e-3, atol 2e-4, the reference's own bound between
  two of its transports (``tests/test_compression.py``): the fold order
  follows the uploads' arrival.  The one exception is the biases of the
  convolutions ahead of a GroupNorm (``conv1/b``, ``conv2/b``): their true
  gradient is zero (the norm removes what they add), so AdamW moves them by
  about ``lr * sign(round-off)`` a step, and they are held to ``lr *
  rounds``.  The reference's own thread and stacked jobs on this task
  differ there beyond its bound, and nowhere else (the test below);
- tcp against thread (both the port): losses rtol 1e-5 (fold order);
- resume: the resumed rounds' losses rtol 1e-5, globals rtol 1e-4, atol
  1e-5, as the reference's ``tests/test_resume.py``.
"""
import shutil
import subprocess
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.api import FederatedJob as JJob  # noqa: E402
from repro.api import TaskConfig as JTask  # noqa: E402
from repro.comms import compression as jcomp  # noqa: E402
from repro.comms.coordinator import AggregationServer as JServer  # noqa: E402
from repro.comms.peer import Peer as JPeer  # noqa: E402
from repro_torch import NotPorted, convert  # noqa: E402
from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.comms import compression as tcomp  # noqa: E402
from repro_torch.comms.codec import chunk_spans  # noqa: E402
from repro_torch.comms.codec import encode_message as _enc  # noqa: E402
from repro_torch.comms.coordinator import AggregationServer  # noqa: E402
from repro_torch.comms.membership import HeartbeatClient, LeaseRegistry  # noqa: E402
from repro_torch.comms.peer import Peer  # noqa: E402
from repro_torch.comms.transport import (AuthError, Channel, ChannelError,  # noqa: E402
                                         FlakyChannel, PeerClosed,
                                         ProtocolVersionError, Server, WireConfig)
from repro_torch.tree import tree_leaves  # noqa: E402

CPU = "cpu"
TINY = dict(kind="dose", sites=3, batch=1, volume=(8, 8, 8), base_filters=4)


def _server(**kw):
    return AggregationServer("127.0.0.1", 0, device=CPU, **kw)


def _echo_server(wire=None):
    def handler(kind, meta, tree):
        return _enc("echo", meta, tree)
    return Server("127.0.0.1", 0, handler, wire=wire).start()


# ---------------------------------------------------------------------------
# The wire and the server (the reference's tests/test_comms.py)
# ---------------------------------------------------------------------------


def test_server_runs_on_cuda_by_default_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        AggregationServer("127.0.0.1", 0, num_sites=1)


def test_centralized_roundtrip_weighted_and_timeout():
    agg = _server(num_sites=4, case_weights=[1.0, 2.0, 3.0, 4.0], download_timeout=0.3)
    peers = [Peer(i) for i in range(4)]
    try:
        with pytest.raises(RuntimeError, match="timeout"):
            peers[0].download(agg.addr, 1)
        threads = [threading.Thread(target=peers[i].upload,
                                    args=(agg.addr, {"w": np.full(3, float(i))}, 1))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        g = peers[0].download(agg.addr, 1)
        np.testing.assert_allclose(g["w"], sum(i * (i + 1) for i in range(4)) / 10.0,
                                   rtol=1e-6)
        assert g["w"].dtype == np.float32
        with pytest.raises(RuntimeError, match="remote error"):
            peers[0]._channel(agg.addr).request("bogus_rpc", {}, None)
    finally:
        for p in peers:
            p.close()
        agg.stop()


def test_partial_round_with_dropout_and_stale_upload():
    agg = _server(num_sites=4)
    peers = [Peer(i) for i in range(3)]
    try:
        for i, p in enumerate(peers):
            p.upload(agg.addr, {"w": np.full(2, float(i), np.float32)}, 1, active_sites=3)
        np.testing.assert_allclose(peers[0].download(agg.addr, 1)["w"], 1.0, rtol=1e-6)
        ack = peers[1].upload(agg.addr, {"w": np.zeros(2, np.float32)}, 1, active_sites=3)
        assert ack["stale"] is True                    # round 1 is done
    finally:
        for p in peers:
            p.close()
        agg.stop()


def test_hello_version_mismatch_rejected_typed():
    srv = _echo_server(wire=WireConfig())
    try:
        class _OldChannel(Channel):
            proto_version = 99
        with pytest.raises(ProtocolVersionError, match="version"):
            _OldChannel(srv.addr)
    finally:
        srv.stop()


def test_hello_auth_token_verified():
    srv = _echo_server(wire=WireConfig(secret="s3cret"))
    try:
        with pytest.raises(AuthError):
            Channel(srv.addr, wire=WireConfig())
        with pytest.raises(AuthError):
            Channel(srv.addr, wire=WireConfig(secret="wrong"))
        ch = Channel(srv.addr, wire=WireConfig(secret="s3cret"), identity="site:0")
        kind, meta, _ = ch.request("ping", {"x": 42})
        assert kind == "echo" and meta["x"] == 42
        ch.close()
    finally:
        srv.stop()


def test_tls_wire_roundtrip(tmp_path):
    openssl = shutil.which("openssl")
    if openssl is None:
        pytest.skip("openssl not available to mint a test cert")
    cert, key = str(tmp_path / "c.pem"), str(tmp_path / "k.pem")
    subprocess.run([openssl, "req", "-x509", "-newkey", "rsa:2048", "-keyout", key,
                    "-out", cert, "-days", "1", "-nodes", "-subj", "/CN=127.0.0.1"],
                   check=True, capture_output=True)
    wire = WireConfig(tls_cert=cert, tls_key=key, secret="s")
    srv = _echo_server(wire=wire)
    try:
        ch = Channel(srv.addr, wire=wire, identity="site:0")
        kind, meta, tree = ch.request("ping", {"x": 1}, {"w": np.ones(4, np.float32)})
        assert kind == "echo" and meta["x"] == 1
        np.testing.assert_array_equal(tree["w"], 1.0)
        ch.close()
    finally:
        srv.stop()


def test_streamed_upload_bit_identical_and_counted_once():
    tree = {"w": np.arange(12288, dtype=np.float32)}
    encoded_len = len(_enc("upload", {"site": 0, "round": 1}, tree))
    mms = 4096
    assert len(chunk_spans(encoded_len, mms)) >= 4
    globals_, stats = [], []
    for wire in (None, WireConfig(max_message_size=mms)):
        agg = _server(num_sites=1, wire=wire)
        p = Peer(0, wire=wire)
        try:
            p.upload(agg.addr, tree, 1)
            globals_.append(p.download(agg.addr, 1))
            stats.append(agg.stats.snapshot())
        finally:
            p.close()
            agg.stop()
    np.testing.assert_array_equal(globals_[0]["w"], globals_[1]["w"])
    np.testing.assert_array_equal(globals_[0]["w"], tree["w"])
    assert stats[1]["upload"]["count"] == 1
    assert stats[1]["upload"]["in_bytes"] >= encoded_len


def test_flaky_channel_reconnects_and_replays():
    srv = _echo_server()
    try:
        ch = FlakyChannel(srv.addr, drop=0.25, dup=0.25, seed=0,
                          wire=WireConfig(connect_retries=10, backoff_base=0.005))
        for i in range(25):
            kind, meta, _ = ch.request("ping", {"i": i})
            assert kind == "echo" and meta["i"] == i
        ch.close()
    finally:
        srv.stop()
    with pytest.raises(ChannelError):
        Channel(("127.0.0.1", 1), timeout=0.3,
                wire=WireConfig(connect_retries=1, backoff_base=0.001))


def test_lease_registry_expected_semantics():
    reg = LeaseRegistry(ttl=60.0)
    assert reg.expected(4) == 4
    reg.join(0)
    reg.join(1)
    assert reg.expected(4) == 2
    reg.leave(1)
    reg.leave(0)
    assert reg.expected(4) == 1


def test_lease_expiry_unblocks_flat_barrier_and_leave_shrinks_it():
    agg = _server(num_sites=2, lease_ttl=0.4, download_timeout=10)
    p0, p1 = Peer(0), Peer(1)
    hb = None
    try:
        hb = HeartbeatClient(0, lambda k, m: p0.request(agg.addr, k, m), 0.4).start()
        p1.request(agg.addr, "join", {"site": 1})      # joins, never beats
        p0.upload(agg.addr, {"w": np.ones(3, np.float32)}, 1, active_sites=2)
        np.testing.assert_allclose(p0.download(agg.addr, 1)["w"], 1.0)
        assert any(s == 1 for _, s in agg.registry.expired_log)
        p1.request(agg.addr, "join", {"site": 1})
        p1.request(agg.addr, "leave", {"site": 1})
        p0.upload(agg.addr, {"w": np.full(3, 2.0, np.float32)}, 2, active_sites=2)
        np.testing.assert_allclose(p0.download(agg.addr, 2)["w"], 2.0)
    finally:
        if hb is not None:
            hb.stop()
        p0.close()
        p1.close()
        agg.stop()


def test_late_joiner_bootstrap_carries_current_global():
    g0 = {"w": np.full(4, 7.0, np.float32)}
    agg = _server(num_sites=2, lease_ttl=5.0, initial_round=3, initial_global=g0)
    p = Peer(5)
    hb = None
    try:
        hb = HeartbeatClient(5, lambda k, m: p.request(agg.addr, k, m), 5.0).start()
        assert hb.join_meta["round"] == 3
        np.testing.assert_array_equal(np.asarray(hb.bootstrap["w"]), g0["w"])
    finally:
        if hb is not None:
            hb.stop()
        p.close()
        agg.stop()


def test_peer_close_wakes_blocked_receiver_typed():
    p = Peer(9)
    caught = []

    def recv():
        try:
            p.recv_model(timeout=10)
        except Exception as e:  # noqa: BLE001
            caught.append(e)
    t = threading.Thread(target=recv)
    t.start()
    p.close()
    t.join(timeout=5)
    assert len(caught) == 1 and isinstance(caught[0], PeerClosed)
    with pytest.raises(PeerClosed):
        p.recv_model(timeout=0.1)


def test_sanitation_rejects_non_finite_and_norm_outliers():
    agg = _server(num_sites=3, max_upload_norm=10.0)
    peers = [Peer(i) for i in range(3)]
    try:
        bad = peers[0].upload(agg.addr, {"w": np.array([np.nan, 1.0], np.float32)}, 1)
        big = peers[1].upload(agg.addr, {"w": np.array([100.0, 0.0], np.float32)}, 1)
        ok = peers[2].upload(agg.addr, {"w": np.array([3.0, 4.0], np.float32)}, 1)
        assert bad["reason"] == "non_finite" and big["reason"] == "norm_outlier"
        assert not ok.get("rejected")
        np.testing.assert_array_equal(peers[2].download(agg.addr, 1)["w"], [3.0, 4.0])
        assert agg.rejected_uploads == 2
    finally:
        for p in peers:
            p.close()
        agg.stop()


# ---------------------------------------------------------------------------
# Cross-runtime: a port site and a JAX server on one wire, and the reverse
# ---------------------------------------------------------------------------


def _site_trees(seed, n=2):
    rng = np.random.default_rng(seed)
    return [{"conv": (rng.normal(size=(3, 3, 3, 5, 7)) * 0.1).astype(np.float32),
             "bias": (rng.normal(size=(7,)) * 0.1).astype(np.float32),
             "dense": [(rng.normal(size=(40, 30)) * 0.1).astype(np.float32)]}
            for _ in range(n)]


def _exchange(server, peers, comps, encode, rounds=2):
    """``rounds`` of int8 uploads from each peer in turn (round 2 a delta
    against the round-1 global), and the downloaded globals."""
    globals_, reference = [], None
    for r in range(1, rounds + 1):
        for i, (peer, comp) in enumerate(zip(peers, comps)):
            payload, meta = encode(comp, _site_trees(10 * r + i, 1)[0], reference)
            meta["base_round"] = r - 1 if reference is not None else 0
            peer.upload(server.addr, payload, r, meta_extra=meta)
        g = peers[0].download(server.addr, r)
        globals_.append(g)
        reference = g
    return globals_


def _jax_encode(comp, tree, reference):
    return comp.encode(tree, reference)


def _port_encode(comp, tree, reference):
    ref = None if reference is None else convert.from_reference(reference)
    return comp.encode(convert.from_reference(tree), ref)


@pytest.mark.parametrize("direction", ["port-site-jax-server", "jax-site-port-server"])
def test_int8_uploads_cross_runtimes(direction):
    def run(server_cls, peer_cls, comp_cls, encode):
        server = server_cls()
        peers = [peer_cls(i) for i in range(2)]
        try:
            return _exchange(server, peers, [comp_cls() for _ in peers], encode)
        finally:
            for p in peers:
                p.close()
            server.stop()
    jserver = lambda: JServer("127.0.0.1", 0, num_sites=2)  # noqa: E731
    tserver = lambda: AggregationServer("127.0.0.1", 0, num_sites=2, device=CPU)  # noqa: E731
    jcompressor = lambda: jcomp.UploadCompressor(jcomp.Int8Codec(use_kernel=False))  # noqa: E731
    tcompressor = lambda: tcomp.UploadCompressor(tcomp.Int8Codec())  # noqa: E731
    same = run(jserver, JPeer, jcompressor, _jax_encode)
    if direction == "port-site-jax-server":
        cross = run(jserver, Peer, tcompressor, _port_encode)
    else:
        cross = run(tserver, JPeer, jcompressor, _jax_encode)
    port_pair = run(tserver, Peer, tcompressor, _port_encode)
    for want, got, tt in zip(same, cross, port_pair):
        for a, b, c in zip(jax.tree.leaves(want), jax.tree.leaves(got), jax.tree.leaves(tt)):
            assert a.shape == b.shape == c.shape
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
            np.testing.assert_allclose(c, a, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# The server's robust rules and sanitation: a JAX server and the port's
# ---------------------------------------------------------------------------

ROBUST_SITES = 5


def _robust_uploads(round_index):
    """Five sites' dense uploads in the wire's layout: a shared model plus
    each site's noise; one site a round sends it 30 times over."""
    rng = np.random.default_rng(round_index)
    base = {"conv": rng.normal(size=(3, 3, 3, 5, 7)) * 0.1, "bias": rng.normal(size=(7,)) * 0.1,
            "dense": [rng.normal(size=(40, 30)) * 0.1]}
    trees = []
    for site in range(ROBUST_SITES):
        gain = 30.0 if site == round_index % ROBUST_SITES else 1.0
        trees.append(jax.tree.map(
            lambda x: (gain * (x + rng.normal(size=x.shape) * 0.02)).astype(np.float32), base))
    return trees


def _robust_exchange(server, peer_cls):
    """Two rounds of the five uploads, one site after another; per round
    the downloaded global and which uploads the server rejected."""
    peers = [peer_cls(i) for i in range(ROBUST_SITES)]
    try:
        rounds = []
        for r in (1, 2):
            acks = [p.upload(server.addr, t, r) for p, t in zip(peers, _robust_uploads(r))]
            rounds.append((peers[0].download(server.addr, r),
                           [bool(a.get("rejected")) for a in acks]))
        return rounds, server.rejected_uploads
    finally:
        for p in peers:
            p.close()
        server.stop()


@pytest.mark.parametrize("kw", [
    pytest.param(dict(aggregator="median"), id="median"),
    pytest.param(dict(aggregator="trimmed:1"), id="trimmed-1"),
    pytest.param(dict(aggregator="trimmed:3"), id="trimmed-3-clamped"),
    pytest.param(dict(aggregator="krum:1"), id="krum-1"),
    pytest.param(dict(aggregator="krum:3"), id="krum-3-m-floor"),
    pytest.param(dict(aggregator="normclip:2.0"), id="normclip"),
    pytest.param(dict(max_upload_norm=20.0), id="max-upload-norm"),
    pytest.param(dict(aggregator="median", max_upload_norm=20.0), id="median-max-upload-norm"),
    pytest.param(dict(aggregator="krum:1", max_upload_norm=20.0), id="krum-max-upload-norm"),
])
def test_server_rules_match_the_jax_server(kw):
    """The same uploads, the same global: the rank rules (the reference's
    clamp ``fe = min(f, (k - 1) // 2)`` and Krum's ``m`` floor included),
    norm clipping, and the norm sanitation, whose rejections shrink the
    round's k the same way."""
    want, want_rejected = _robust_exchange(
        JServer("127.0.0.1", 0, num_sites=ROBUST_SITES, **kw), JPeer)
    got, got_rejected = _robust_exchange(
        AggregationServer("127.0.0.1", 0, num_sites=ROBUST_SITES, device=CPU, **kw), Peer)
    assert got_rejected == want_rejected
    assert (want_rejected > 0) == ("max_upload_norm" in kw)
    for (g, g_rej), (w, w_rej) in zip(got, want):
        assert g_rej == w_rej
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            assert a.shape == b.shape and a.dtype == b.dtype == np.float32
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Jobs
# ---------------------------------------------------------------------------

def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_globals_close(got, want, noise_bound):
    """rtol 2e-3, atol 2e-4 everywhere but the GroupNorm-fed conv biases,
    which are held to ``noise_bound`` (see the module docstring)."""
    for (path, a), (_, b) in zip(_paths(got), _paths(want)):
        a, b = np.asarray(a), np.asarray(b)
        if path.endswith(("/conv1/b", "/conv2/b")):
            assert float(np.abs(a - b).max()) <= noise_bound, path
        else:
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4, err_msg=path)


PAYLOAD_KEYS = ("site_payload_bytes", "upload_raw_bytes", "download_payload_bytes",
                "download_raw_bytes", "upload_count", "download_count", "compression",
                "down_compression", "simulated")


def _init(jjob):
    return convert.from_reference(jax.tree.map(
        np.asarray, jjob.task.build().init_fn(jax.random.PRNGKey(jjob.seed))))


@pytest.mark.parametrize("codec,extra", [
    pytest.param("none", {}, id="none"), pytest.param("int8", {}, id="int8"),
    pytest.param("int8", dict(sample="uniform:2"), id="int8-sampled"),
    pytest.param("none", dict(aggregator="median", max_upload_norm=1e3, round_deadline_s=30.0),
                 id="median"),
    pytest.param("none", dict(strategy="individual"), id="individual")])
def test_thread_job_matches_jax_thread_job(codec, extra):
    kw = dict(rounds=3, seed=0, max_dropout=1, transport="thread",
              compression=codec, down_compression=codec, **extra)
    jjob = JJob(task=JTask(**TINY), **kw)
    jres = jjob.run()
    tres = FederatedJob(task=TaskConfig(**TINY), device=CPU, **kw).run(init_params=_init(jjob))
    assert min(h["active"] for h in jres.history) < 3       # a masked round ran
    assert len(tres.history) == len(jres.history) == 3
    for th, jh in zip(tres.history, jres.history):
        assert th["active"] == jh["active"]
        np.testing.assert_allclose(th["per_site_loss"], jh["per_site_loss"],
                                   rtol=1e-4, atol=1e-5)
    for k in PAYLOAD_KEYS if jres.comm is not None else ():
        assert tres.comm.get(k) == jres.comm.get(k), k
    assert tres.comm == jres.comm      # framing too: the same frames (individual: None)
    assert tres.rejected_uploads == jres.rejected_uploads == 0
    want = convert.from_reference(jax.tree.map(np.asarray, jres.global_params))
    _assert_globals_close(tres.global_params, want, jjob.lr * jjob.rounds)


def test_reference_transports_exceed_their_bound_only_on_groupnorm_fed_biases():
    """The evidence for the one exception above: the reference's own thread
    and stacked jobs on this task agree within rtol 2e-3, atol 2e-4 on
    every leaf but the GroupNorm-fed conv biases, where they differ beyond
    it (within ``lr * rounds``)."""
    kw = dict(rounds=3, seed=0, max_dropout=1)
    jjob = JJob(task=JTask(**TINY), transport="thread", **kw)
    thread, stacked = jjob.run(), jjob.replace(transport="stacked").run()
    beyond = []
    for (path, a), (_, b) in zip(
            _paths(convert.from_reference(jax.tree.map(np.asarray, thread.global_params))),
            _paths(convert.from_reference(jax.tree.map(np.asarray, stacked.global_params)))):
        a, b = a.numpy(), b.numpy()
        if np.any(np.abs(a - b) > 2e-4 + 2e-3 * np.abs(b)):
            beyond.append(path)
        assert float(np.abs(a - b).max()) <= jjob.lr * jjob.rounds
    assert beyond and all(p.endswith(("/conv1/b", "/conv2/b")) for p in beyond), beyond


@pytest.mark.parametrize("kw", [
    dict(wire=WireConfig(flaky="drop=0.15,dup=0.1,seed=3", connect_retries=8,
                         backoff_base=0.01)),
    dict(wire=WireConfig(secret="s3cret", max_message_size=4096)),
    dict(lease_ttl=30.0, io_timeout=60.0),
], ids=["flaky", "auth-streamed", "leases"])
def test_socket_job_wire_options_leave_the_trajectory_unchanged(kw):
    """A faulty wire (drops and duplicates, replayed and deduplicated), an
    authenticated wire that streams every upload in 4 KiB chunks, and
    leased sites all give the clean job's trajectory bit for bit (2 sites:
    the fold's order cannot differ)."""
    base = FederatedJob(task=TaskConfig(**{**TINY, "sites": 2}), rounds=2, seed=0,
                        device=CPU, transport="thread", compression="int8",
                        down_compression="int8")
    clean, other = base.run(), base.replace(**kw).run()
    assert other.losses == clean.losses
    for a, b in zip(tree_leaves(other.global_params), tree_leaves(clean.global_params)):
        assert torch.equal(a, b)
    # the payload the sites sent and the server encoded (the server's framed
    # counts include the faulty wire's replays)
    for k in ("site_payload_bytes", "download_payload_bytes"):
        assert other.comm[k] == clean.comm[k]


def test_tcp_job_matches_thread_job():
    job = FederatedJob(task=TaskConfig(**{**TINY, "sites": 2}), rounds=2, seed=0, device=CPU,
                       transport="tcp", compression="int8", down_compression="int8")
    tcp = job.run()
    thread = job.replace(transport="thread").run()
    np.testing.assert_allclose(tcp.losses, thread.losses, rtol=1e-5)
    assert tcp.comm == thread.comm
    assert tcp.transport == "tcp"


def test_thread_job_resumes_from_its_checkpoints(tmp_path):
    """Killed after 2 of 4 rounds (a short first run), ``run(resume=True)``
    re-enters at round 1 and reproduces the uninterrupted run.  Int8
    uploads (the sites' references and residuals are restored); downloads
    dense: the server saves its per-site downlink references before the
    round's downloads, so a down-compressing job resumes through a dense
    bootstrap, in both packages, and is not checkpoint-exact."""
    kw = dict(task=TaskConfig(**{**TINY, "sites": 2}), seed=0, device=CPU,
              transport="thread", compression="int8", ckpt_every=1)
    ref = FederatedJob(rounds=4, **kw).run()
    job = FederatedJob(rounds=4, checkpoint_dir=str(tmp_path), **kw)
    job.run(rounds=2)
    res = job.run(rounds=4, resume=True)
    assert res.resumed_from == 1
    assert len(res.history) == 2
    np.testing.assert_allclose(res.losses, ref.losses[2:], rtol=1e-5)
    for a, b in zip(tree_leaves(res.global_params), tree_leaves(ref.global_params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        FederatedJob(rounds=1, **kw).run(resume=True)


def test_individual_and_robust_socket_jobs_run():
    base = FederatedJob(task=TaskConfig(**TINY), rounds=2, seed=0, device=CPU,
                        transport="thread")
    ind = base.replace(strategy="individual").run()
    assert ind.comm is None and len(ind.history) == 2
    med = base.replace(aggregator="median", max_upload_norm=1e3,
                       round_deadline_s=30.0).run()
    assert med.rejected_uploads == 0 and med.comm["upload_count"] == 6


# the unported socket seams name their seam; the refused compositions raise
# the reference's ValueError on both packages
UNPORTED = [
    ("scheduler", dict(scheduler="buffered")),
    ("strategy", dict(strategy="fedprox")),
    ("strategy", dict(strategy="gcml")),
    ("topology", dict(topology="pods:2")),
    ("secure_agg", dict(secure_agg=True)),
    ("dp", dict(dp_clip=1.0)),
    ("compression", dict(compression="fp8")),
    ("down_compression", dict(down_compression="topk-fixed")),
]


@pytest.mark.parametrize("seam,kw", UNPORTED)
def test_unported_socket_seams_raise_a_typed_error(seam, kw):
    job = FederatedJob(task=TaskConfig(**TINY), rounds=1, device=CPU, transport="thread")
    with pytest.raises(NotPorted) as err:
        job.replace(**kw).run()
    assert err.value.seam == seam


REFUSED = [
    (dict(shard_sites=True), "shard_sites=True shards"),
    (dict(strategy="pooled"), "single-process baseline"),
    (dict(strategy="gcml", max_dropout=1), "gossip under dropout"),
    (dict(topology="pods:2", strategy="individual"), "centrally-aggregated"),
    (dict(secure_agg=True, compression="int8"), "quantizing that ciphertext"),
    (dict(secure_agg=True, scheduler="buffered"), "masks would never cancel"),
    (dict(round_deadline_s=1.0, topology="pods:2"), "per-tier pod deadlines"),
    (dict(aggregator="median", compression="int8"), "plaintext fp32 uploads"),
]


@pytest.mark.parametrize("kw,frag", REFUSED)
def test_refused_socket_compositions_raise_the_reference_value_error(kw, frag):
    with pytest.raises(ValueError, match=frag):
        JJob(task=JTask(**TINY), rounds=1, transport="thread", **kw).run()
    with pytest.raises(ValueError, match=frag):
        FederatedJob(task=TaskConfig(**TINY), rounds=1, device=CPU, transport="thread",
                     **kw).run()
