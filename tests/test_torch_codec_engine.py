"""The stacked transport's ``round_engine`` and ``chunk_rounds`` seams, and
the buffered fp8 job against the JAX job.

- Routing: ``"auto"`` and ``"scan"`` run the on-device twins of the
  reference's scan engine where its ``execute_stacked`` runs the job, and
  the host loops where it returns None (``topk-sparse`` either way, a
  buffered top-k job, a buffered codec whose staleness reaches past the
  decode ring); ``"scan"`` then raises the reference's ``ValueError``,
  word for word, as does an unknown engine.  ``"loop"`` takes the host
  loops.  ``chunk_rounds`` changes no result (bit for bit).
- The host loop and the twin compute the same rounds: an fp8 job both
  ways (3 rounds, churn) on each, held as a JAX job is held: per-site
  losses rtol 1e-4, atol 1e-5, the global within ``lr * rounds`` with its
  median element within 1e-6, ``comm`` equal.  The two fold the same
  decoded values in another fp32 order; where that flips an fp8 rounding
  of a later round's delta, the values part by one fp8 step, and AdamW
  carries it on.
- The tcp transport (a process a site, 2 sites, 2 rounds) with fp8
  uploads and ``topk-fixed`` downloads against the thread job: losses
  rtol 1e-5, payload bytes equal (its socket twins are in
  ``test_torch_codec_sockets.py``; this file has the room).
- The buffered fp8 job (3 sites, 3 rounds, ``buffer_k=2``; the twin of
  the reference's buffered scan, its flat qdq at ``align=1``) is held to
  the JAX job by ``hold_job_to_jax``: losses rtol 1e-4, atol 1e-5;
  ``comm`` equal; the global within ``lr * rounds``, median within 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_jax_helpers import hold_job_to_jax  # noqa: E402

from repro.api import FederatedJob as JJob  # noqa: E402
from repro.api import TaskConfig as JTask  # noqa: E402
from repro.core import session as jsess  # noqa: E402
from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.core import round_engine as tre  # noqa: E402
from repro_torch.core import session as tsess  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

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


def _sched(mod, kw):
    return {**kw, "scheduler": mod.BufferedScheduler(**kw["scheduler"])} if "scheduler" in kw \
        else kw


# (job fields, the port's rounds under "auto", under "loop")
ROUTES = [
    (dict(), tre.run_sync, tre.run_sync),
    (dict(compression="fp8"), tre.run_compressed, tre.run_compressed_host),
    (dict(compression="int8", down_compression="topk-fixed"), tre.run_compressed,
     tre.run_compressed_host),
    (dict(down_compression="fp8"), tre.run_compressed, tre.run_compressed_host),
    (dict(compression="topk-sparse"), None, tre.run_compressed_host),
    (dict(compression="int8", down_compression="topk-sparse"), None, tre.run_compressed_host),
    (dict(compression="fp8", scheduler=dict(buffer_k=2)), tre.run_buffered,
     tre.run_buffered_host),
    (dict(scheduler=dict(buffer_k=2)), tre.run_buffered, tre.run_buffered_host),
    (dict(compression="topk-fixed", scheduler=dict(buffer_k=2)), None, tre.run_buffered_host),
    (dict(compression="fp8", scheduler=dict(buffer_k=2, max_staleness=16)), None,
     tre.run_buffered_host),
]


@pytest.mark.parametrize("kw,auto,loop", ROUTES)
def test_round_engine_routes_as_the_reference(kw, auto, loop):
    """The twins where the reference's scan runs the job; elsewhere
    ``round_engine="scan"`` raises the reference's error, word for word."""
    job = FederatedJob(task=TaskConfig(**TINY), rounds=1, device=CPU, **_sched(tsess, kw))
    codec, down = job.codecs()
    sched = tsess.resolve_scheduler(job.scheduler)
    assert tre.engine_for(sched, codec, down) is auto
    assert tre.host_loop_for(sched, codec, down) is loop
    if auto is None:
        with pytest.raises(ValueError) as want:
            JJob(task=JTask(**TINY), rounds=1, round_engine="scan", **_sched(jsess, kw)).run()
        with pytest.raises(ValueError) as got:
            job.replace(round_engine="scan").run()
        assert str(got.value) == str(want.value)
        assert "take the host path" in str(got.value)


def test_unknown_round_engine_raises_the_reference_error():
    with pytest.raises(ValueError) as want:
        JJob(task=JTask(**TINY), rounds=1, round_engine="eager").run()
    with pytest.raises(ValueError) as got:
        FederatedJob(task=TaskConfig(**TINY), rounds=1, device=CPU, round_engine="eager").run()
    assert str(got.value) == str(want.value) == \
        "unknown round_engine 'eager'; known: auto, scan, loop"


def test_chunk_rounds_changes_nothing_and_loop_runs_the_same_rounds():
    job = FederatedJob(task=TaskConfig(**TINY), rounds=3, device=CPU, compression="fp8",
                       down_compression="fp8", max_dropout=1)
    auto, chunked = job.run(), job.replace(chunk_rounds=1, round_engine="scan").run()
    assert auto.losses == chunked.losses and auto.comm == chunked.comm
    for x, y in zip(tree_leaves(auto.global_params), tree_leaves(chunked.global_params)):
        assert torch.equal(x, y)
    loop = job.replace(round_engine="loop").run()
    for x, y in zip(loop.history, auto.history):
        np.testing.assert_allclose(x["per_site_loss"], y["per_site_loss"], rtol=1e-4, atol=1e-5)
    diff = torch.cat([(x - y).abs().reshape(-1) for x, y in
                      zip(tree_leaves(loop.global_params), tree_leaves(auto.global_params))])
    assert float(diff.max()) <= job.lr * job.rounds and float(diff.median()) <= 1e-6
    assert loop.comm == auto.comm


def test_buffered_fp8_job_matches_jax_job():
    kw = dict(compression="fp8", max_dropout=1)
    jjob = JJob(task=JTask(**TINY), rounds=3,
                scheduler=jsess.BufferedScheduler(buffer_k=2), **kw)
    jres = jjob.run()
    tres = hold_job_to_jax(
        FederatedJob(task=TaskConfig(**TINY), rounds=3, device=CPU,
                     scheduler=tsess.BufferedScheduler(buffer_k=2), **kw), jjob, jres)
    assert [h["version"] for h in tres.history] == [h["version"] for h in jres.history]
    assert tres.comm["compression"] == "fp8"


def test_tcp_job_matches_the_thread_job():
    """One process a site, fp8 uploads and ``topk-fixed`` downloads: the
    thread job's losses (rtol 1e-5) and payload bytes."""
    job = FederatedJob(task=TaskConfig(**dict(TINY, sites=2)), rounds=2, device=CPU,
                       transport="tcp", compression="fp8", down_compression="topk-fixed")
    tcp, thread = job.run(), job.replace(transport="thread").run()
    np.testing.assert_allclose(tcp.losses, thread.losses, rtol=1e-5)
    for key in ("site_payload_bytes", "download_payload_bytes", "upload_count"):
        assert tcp.comm[key] == thread.comm[key]
    assert tcp.transport == "tcp" and tcp.comm["down_compression"] == "topk-fixed"
