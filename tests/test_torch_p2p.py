"""The port's serverless socket deployment (GCML over the wire) against the
JAX reference.

The coordination server pairs the sites, which push models to each other
directly.  Jobs run in both packages from the same initial parameters (the
JAX init, converted) and the same host batches, at the tiny size (8^3, 4
filters, 2 levels, PanSeg-like: one channel, two classes).

Tolerances, and why:

- the coordinator's assignments: equal (the same numpy pairing on the
  same generator);
- jobs, port against JAX: per-site losses rtol 1e-4, atol 1e-5 (fp32
  round-off through a few AdamW steps and the DCML step), ``comm`` equal
  (None when dense; the pushes' payload bytes when int8), globals within
  ``assert_globals_close(..., lr * rounds)``: rtol 2e-3, atol 2e-4, the
  reference's own bound between two of its transports, but the
  GroupNorm-fed conv biases, whose true gradient is zero and which AdamW
  moves by about ``lr * sign(round-off)`` a step;
- the port's thread job against its stacked job (the same pairings, the
  same pushes bit for bit over the dense wire): losses rtol 1e-6, globals
  atol 1e-6: only the final fold differs (the socket driver normalizes
  once, the stacked one folds normalized weights).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_jax_helpers import assert_globals_close, reference_init  # noqa: E402

from repro.api import FederatedJob as JJob  # noqa: E402
from repro.api import TaskConfig as JTask  # noqa: E402
from repro.comms.coordinator import CoordinationServer as JCoord  # noqa: E402
from repro.comms.peer import Peer as JPeer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.comms.coordinator import CoordinationServer  # noqa: E402
from repro_torch.comms.peer import Peer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

CPU = "cpu"
PAN = dict(kind="seg", in_channels=1, num_classes=2, batch=1, volume=(8, 8, 8),
           base_filters=4, num_levels=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch thread for this module's tiny models (the suite runs in
    several worker processes on one host's cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# The coordination server
# ---------------------------------------------------------------------------


def _register(server, peer, sites):
    for i in range(sites):
        peer.request(server.addr, "register", {"site": i, "addr": ["127.0.0.1", 9000 + i]})


def _assignments(server, peer, sites):
    """Register ``sites`` at fixed addresses, take rounds 1-2, mark site 2
    inactive, take rounds 3-5, then ask for round 1 again (pruned: the
    servers keep 3 rounds)."""
    try:
        _register(server, peer, sites)
        out = [peer.get_assignment(server.addr, r) for r in (1, 2)]
        peer.request(server.addr, "status_update", {"site": 2, "active": False})
        out += [peer.get_assignment(server.addr, r) for r in (3, 4, 5)]
        with pytest.raises(RuntimeError) as err:
            peer.get_assignment(server.addr, 1)
        return out, str(err.value).split(": ", 1)[1]
    finally:
        peer.close()
        server.stop()


@pytest.mark.parametrize("sites,seed", [(5, 0), (4, 7)])
def test_coordination_server_pairs_as_the_reference(sites, seed):
    want, want_err = _assignments(JCoord("127.0.0.1", 0, num_sites=sites, seed=seed,
                                         keep_assignments=3), JPeer(99), sites)
    got, got_err = _assignments(CoordinationServer("127.0.0.1", 0, num_sites=sites,
                                                   seed=seed, keep_assignments=3),
                                Peer(99), sites)
    assert got == want
    assert not got[3]["active"][2] and got[1]["active"][2]
    for asg in got:
        assert sum(asg["is_receiver"]) == sum(asg["active"]) // 2
    assert got_err == want_err == "assignment for round 1 already pruned"


def test_coordination_server_pairs_as_the_stacked_job():
    """With every site active the socket pairings are the stacked job's
    (both draw from ``default_rng(seed)`` round by round)."""
    job = FederatedJob(task=TaskConfig(sites=5, **PAN), strategy="gcml", rounds=3, seed=3,
                       device=CPU)
    stacked = job.run()
    server, peer = CoordinationServer("127.0.0.1", 0, num_sites=5, seed=3), Peer(99)
    try:
        _register(server, peer, 5)
        got = [peer.get_assignment(server.addr, r) for r in (1, 2, 3)]
    finally:
        peer.close()
        server.stop()
    for h, asg in zip(stacked.history, got):
        assert h["partner"] == asg["partner"] and h["is_receiver"] == asg["is_receiver"]


# ---------------------------------------------------------------------------
# Jobs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sites,extra", [
    pytest.param(4, {}, id="dense"),
    pytest.param(2, dict(compression="int8"), id="int8"),
    pytest.param(2, dict(aggregator="normclip:0.01", adversary="sign_flip:1", seed=1),
                 id="sign-flip-normclip"),
])
def test_thread_gcml_matches_jax_thread_gcml(sites, extra):
    """Dense and int8 pushes; a sign-flipping site that pushes under a
    clip that binds on the incoming delta (at seed 1 the flipping site
    sends; at seed 0 it never does on 2 sites)."""
    kw = {**dict(strategy="gcml", rounds=2, seed=0, transport="thread"), **extra}
    jjob = JJob(task=JTask(sites=sites, **PAN), **kw)
    jres = jjob.run()
    job = FederatedJob(task=TaskConfig(sites=sites, **PAN), device=CPU, **kw)
    tres = job.run(init_params=reference_init(jjob))
    if "adversary" in extra:                 # each seam acted: the clip and the flip
        unclipped = job.replace(aggregator="fedavg").run(init_params=reference_init(jjob))
        honest = job.replace(adversary=None).run(init_params=reference_init(jjob))
        assert unclipped.losses != tres.losses and honest.losses != tres.losses
    for th, jh in zip(tres.history, jres.history):
        assert th["active"] == jh["active"] == sites
        np.testing.assert_allclose(th["per_site_loss"], jh["per_site_loss"],
                                   rtol=1e-4, atol=1e-5)
    assert tres.comm == jres.comm
    assert (tres.comm is None) == ("compression" not in extra)
    assert tres.privacy is jres.privacy is None
    want = convert.from_reference(jax.tree.map(np.asarray, jres.global_params))
    assert_globals_close(tres.global_params, want, jjob.lr * jjob.rounds)


def test_thread_gcml_matches_the_stacked_gcml():
    """The same pairings and the same pushes: each site's losses are the
    stacked job's; the global differs by the final fold's round-off."""
    job = FederatedJob(task=TaskConfig(sites=4, **PAN), strategy="gcml", rounds=3, seed=1,
                       device=CPU)
    stacked, thread = job.run(), job.replace(transport="thread").run()
    assert any(any(h["is_receiver"]) for h in stacked.history)
    for s, t in zip(stacked.history, thread.history):
        np.testing.assert_allclose(t["per_site_loss"], s["per_site_loss"], rtol=1e-6)
    for a, b in zip(tree_leaves(thread.global_params), tree_leaves(stacked.global_params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    assert thread.comm is None and thread.transport == "thread"


def test_tcp_gcml_matches_thread_gcml():
    """One process a site, int8 pushes: the thread job's losses and bytes."""
    job = FederatedJob(task=TaskConfig(sites=2, **PAN), strategy="gcml", rounds=2, seed=0,
                       device=CPU, transport="tcp", compression="int8")
    tcp, thread = job.run(), job.replace(transport="thread").run()
    np.testing.assert_allclose(tcp.losses, thread.losses, rtol=1e-5)
    assert tcp.comm == thread.comm and tcp.comm["upload_count"] == 2
    assert tcp.transport == "tcp"
