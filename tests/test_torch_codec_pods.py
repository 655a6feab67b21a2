"""fp8 in two tiers and on gossip pushes: the stacked ``pods:2`` fp8 job
against the JAX job, the thread pods job against the port's stacked one,
and GCML's pushes under fp8 and top-k.

- The stacked pods job (3 sites in 2 pods, whole-site churn, 3 rounds) is
  held to the JAX job by ``hold_job_to_jax``: losses rtol 1e-4, atol 1e-5,
  ``comm`` (with its per-tier split) equal, the global within ``lr *
  rounds`` and its median element within 1e-6.
- The thread pods job (a server a pod, a leader thread a pod re-uploading
  its partial through its own fp8 compressor) against the stacked pods
  job (4 sites, 1 round): the losses rtol 1e-6 (both train from the
  initial model) and the site payload bytes equal the stacked intra-pod
  upload bytes.  The stacked engine (the reference's too) compresses the
  site tier only, so the global differs by the leaders' fp8 hop: each
  element within one fp8 rounding of its pod's partial (2^-4 of its
  magnitude, or the subnormal step 2^-10 of its chunk's scale).  One
  rounding flipped by the two folds' order makes a whole fp8 step, so no
  tighter bound holds past round 0 (nor between the reference's own
  thread and stacked pods jobs).
- GCML's pushes (2 PanSeg-like sites, 2 rounds on the thread transport):
  an fp8 push is compressed (its payload bytes the fp8 model's a push);
  a top-k push carries a whole model, so the dense-bootstrap rule sends
  it dense: the job is the dense job's, losses and global bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_jax_helpers import hold_job_to_jax  # noqa: E402

from repro.api import FederatedJob as JJob  # noqa: E402
from repro.api import TaskConfig as JTask  # noqa: E402
from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.core import round_engine as tre  # noqa: E402
from repro_torch.core.agg_engine import ravel, tree_layout  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TINY = dict(kind="dose", sites=3, batch=1, volume=(8, 8, 8), base_filters=4)
PAN = dict(kind="seg", in_channels=1, num_classes=2, batch=1, volume=(8, 8, 8),
           base_filters=4, num_levels=2, sites=2)
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch thread for this module's tiny models (the suite runs in
    several worker processes on one host's cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_fp8_pods_stacked_job_matches_jax_job():
    kw = dict(compression="fp8", topology="pods:2", max_dropout=1)
    jjob = JJob(task=JTask(**TINY), rounds=3, **kw)
    tres = hold_job_to_jax(FederatedJob(task=TaskConfig(**TINY), rounds=3, device=CPU, **kw),
                           jjob, jjob.run())
    assert tres.comm["pods"] == 2 and tres.comm["cross_pod_upload_bytes"] > 0


def test_fp8_thread_pods_job_is_held_to_the_stacked_pods_job():
    job = FederatedJob(task=TaskConfig(**dict(TINY, sites=4)), rounds=1, device=CPU,
                       compression="fp8", topology="pods:2")
    stacked, thread = job.run(), job.replace(transport="thread").run()
    np.testing.assert_allclose(thread.history[0]["per_site_loss"],
                               stacked.history[0]["per_site_loss"], rtol=1e-6)
    assert thread.comm["site_payload_bytes"] == stacked.comm["intra_pod_upload_bytes"]
    assert thread.comm["compression"] == stacked.comm["compression"] == "fp8"
    # the leaders' partials ride fp8 to the root: within one fp8 rounding
    # of a partial, 2^-4 of its magnitude (a site moves it by about lr
    # from the global), or the subnormal step 2^-10 of its chunk's scale
    lr = job.lr
    for a, b in zip(tree_leaves(thread.global_params), tree_leaves(stacked.global_params)):
        bound = 2.0 ** -4 * (b.abs() + 2 * lr) + 2.0 ** -18 * (b.abs().max() + lr)
        assert bool(((a - b).abs() <= bound).all())


def test_gcml_pushes_fp8_compressed_and_top_k_dense():
    job = FederatedJob(task=TaskConfig(**PAN), strategy="gcml", rounds=2, device=CPU,
                       transport="thread")
    dense, fp8 = job.run(), job.replace(compression="fp8").run()
    layout = tree_layout(dense.global_params)
    pushes = fp8.comm["upload_count"]
    assert pushes == 2 and fp8.comm["compression"] == "fp8"
    assert fp8.comm["upload_bytes"] == pushes * tre.encoded_nbytes(layout.shapes, 1024, 1)
    assert fp8.comm["upload_raw_bytes"] == pushes * 4 * layout.n
    assert np.isfinite(fp8.losses).all() and fp8.losses != dense.losses
    for spec in ("topk-sparse", "topk-fixed"):
        topk = job.replace(compression=spec).run()
        assert topk.losses == dense.losses
        for a, b in zip(tree_leaves(topk.global_params), tree_leaves(dense.global_params)):
            assert torch.equal(a, b)
        assert topk.comm["upload_bytes"] == topk.comm["upload_raw_bytes"] == pushes * 4 * \
            ravel(dense.global_params).numel()
