"""The fp8 and top-k codecs on the socket deployment, and the stacked
``topk-fixed`` job both ways against the JAX job.

- Cross-runtime uploads: a JAX site and the port's server, a port site and
  the JAX server, and a port pair, each exchanging fp8 or top-k uploads
  (round 2 a delta against the round-1 global) on one wire: the
  downloaded globals agree at rtol 1e-6 (the same decoded values, folded
  in fp32 in another order), the payload shapes are equal.
- A thread job against the port's own stacked job (3 sites, 2 rounds):
  per-site losses rtol 1e-4, atol 1e-5, the payload bytes equal both
  ways, and the served global (the case-weighted mean of the sites' final
  models, on both transports) within the reference's thread-vs-stacked
  bound, rtol 2e-3, atol 2e-4, but the GroupNorm-fed conv biases, held to
  ``lr * rounds`` (``assert_globals_close``).  With fp8 both ways that
  holds everywhere.  With ``topk-fixed`` downloads a site installs the
  top 10% of ``g - held``; the two transports fold ``g`` in another order,
  so an entry whose magnitude sits within an ulp of a leaf's k-th can be
  kept on one and not on the other, and the installs then differ by that
  entry.  Such flips are held apart: at most 1e-3 of the elements may
  lie outside the bound.
- The stacked ``topk-fixed`` job both ways (3 sites, 3 rounds), held to
  the JAX job by ``hold_job_to_jax`` (losses rtol 1e-4, atol 1e-5;
  ``comm`` equal; the global within ``lr * rounds``, median within 1e-6).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_jax_helpers import assert_globals_close, hold_job_to_jax, tree_paths  # noqa: E402

from repro.api import FederatedJob as JJob  # noqa: E402
from repro.api import TaskConfig as JTask  # noqa: E402
from repro.comms import compression as jcomp  # noqa: E402
from repro.comms.coordinator import AggregationServer as JServer  # noqa: E402
from repro.comms.peer import Peer as JPeer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.comms import compression as tcomp  # noqa: E402
from repro_torch.comms.coordinator import AggregationServer  # noqa: E402
from repro_torch.comms.peer import Peer  # noqa: E402
from repro_torch.core.agg_engine import get_engine, ravel  # noqa: E402

TINY = dict(kind="dose", sites=3, batch=1, volume=(8, 8, 8), base_filters=4)
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch thread for this module's tiny models (the suite runs in
    several worker processes on one host's cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _site_tree(seed):
    rng = np.random.default_rng(seed)
    return {"conv": (rng.normal(size=(3, 3, 3, 5, 7)) * 0.1).astype(np.float32),
            "bias": (rng.normal(size=(7,)) * 0.1).astype(np.float32),
            "dense": [(rng.normal(size=(40, 30)) * 0.1).astype(np.float32)]}


CODECS = {"fp8": (jcomp.Fp8Codec, tcomp.Fp8Codec), "topk": (jcomp.TopKCodec, tcomp.TopKCodec)}


@pytest.mark.parametrize("direction", ["port-site-jax-server", "jax-site-port-server"])
@pytest.mark.parametrize("codec", list(CODECS))
def test_uploads_cross_runtimes(codec, direction):
    jcodec_cls, tcodec_cls = CODECS[codec]

    def jax_encode(comp, tree, reference):
        return comp.encode(tree, reference)

    def port_encode(comp, tree, reference):
        ref = None if reference is None else convert.from_reference(reference)
        return comp.encode(convert.from_reference(tree), ref)

    def run(server, peer_cls, comp_cls, encode):
        peers = [peer_cls(i) for i in range(2)]
        comps = [tcomp.UploadCompressor(tcodec_cls()) if comp_cls == "port"
                 else jcomp.UploadCompressor(jcodec_cls()) for _ in peers]
        try:
            globals_, reference = [], None
            for r in (1, 2):
                for i, (peer, comp) in enumerate(zip(peers, comps)):
                    payload, meta = encode(comp, _site_tree(10 * r + i), reference)
                    meta["base_round"] = r - 1 if reference is not None else 0
                    peer.upload(server.addr, payload, r, meta_extra=meta)
                reference = peers[0].download(server.addr, r)
                globals_.append(reference)
            return globals_
        finally:
            for p in peers:
                p.close()
            server.stop()

    jserver = lambda: JServer("127.0.0.1", 0, num_sites=2)  # noqa: E731
    tserver = lambda: AggregationServer("127.0.0.1", 0, num_sites=2, device=CPU)  # noqa: E731
    same = run(jserver(), JPeer, "jax", jax_encode)
    if direction == "port-site-jax-server":
        cross = run(jserver(), Peer, "port", port_encode)
    else:
        cross = run(tserver(), JPeer, "jax", jax_encode)
    pair = run(tserver(), Peer, "port", port_encode)
    for want, got, tt in zip(same, cross, pair):
        for a, b, c in zip(jax.tree.leaves(want), jax.tree.leaves(got), jax.tree.leaves(tt)):
            assert a.shape == b.shape == c.shape
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
            np.testing.assert_allclose(c, a, rtol=1e-6, atol=0)


def _served(result, sites):
    """The stacked job's served global as the socket driver serves one: the
    case-weighted mean of the sites' final models."""
    eng = get_engine()
    w = torch.full((sites,), 1.0 / sites)
    return eng.unflatten(eng.reduce_flat(result.state["params"], w), result.state["layout"])


@pytest.mark.parametrize("down", ["fp8", "topk-fixed"])
def test_thread_job_is_held_to_the_stacked_job(down):
    job = FederatedJob(task=TaskConfig(**TINY), rounds=2, device=CPU, compression="fp8",
                       down_compression=down)
    stacked, thread = job.run(), job.replace(transport="thread").run()
    for s, t in zip(stacked.history, thread.history):
        np.testing.assert_allclose(t["per_site_loss"], s["per_site_loss"], rtol=1e-4, atol=1e-5)
    assert thread.comm["site_payload_bytes"] == stacked.comm["upload_bytes"]
    assert thread.comm["download_payload_bytes"] == stacked.comm["download_bytes"]
    assert thread.comm["upload_count"] == stacked.comm["upload_count"] == 6
    got, want = thread.global_params, _served(stacked, 3)
    if down == "fp8":
        assert_globals_close(got, want, job.lr * job.rounds)
        return
    outside = n = 0
    for (path, a), (_, b) in zip(tree_paths(convert.to_reference(got)),
                                 tree_paths(convert.to_reference(want))):
        bound = (job.lr * job.rounds if path.endswith(("/conv1/b", "/conv2/b"))
                 else 2e-4 + 2e-3 * np.abs(b))
        outside += int(np.sum(np.abs(a - b) > bound))
        n += a.size
    assert outside <= 1e-3 * n, f"{outside} of {n} elements outside the socket bound"


def test_topk_fixed_both_ways_matches_jax_job():
    """``topk-fixed`` uploads and downloads through the port's twin of the
    reference's bidirectional compressed scan: round 0 bootstraps dense
    both ways, the folds are ``fedagg`` of the kept rows."""
    kw = dict(compression="topk-fixed", down_compression="topk-fixed")
    jjob = JJob(task=JTask(**TINY), rounds=3, **kw)
    tres = hold_job_to_jax(FederatedJob(task=TaskConfig(**TINY), rounds=3, device=CPU, **kw),
                           jjob, jjob.run())
    dense = 4 * ravel(tres.global_params).numel()
    assert tres.history[0]["upload_bytes"] == tres.history[0]["download_bytes"] == 3 * dense
    assert tres.history[1]["upload_bytes"] < dense
