"""The port's FedProx (paper Eq. 2) and the strategy seams of its job against
the JAX reference.

Inputs are made with numpy from a seed and fed to both packages; the jobs
start from the reference's initial parameters, converted.  Tolerances:

- ``prox_term`` and its gradient: rtol 1e-5 (fp32 sums in another order);
- the stacking row operations: exact;
- jobs (8^3, 4 filters, 2 levels, 4 sites, 3 rounds, Algorithm-2 churn):
  per-site losses rtol 1e-4, atol 1e-5, ``comm`` and the history's
  ``active`` (and bytes) equal; FedProx's final anchor within
  ``lr * rounds`` of the reference's (AdamW's first step is about
  ``lr * sign(g)`` and flips where float noise flips a near-zero
  gradient's sign), or, under int8, within one quantization step more.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import FederatedJob as JJob  # noqa: E402
from repro.api import TaskConfig as JTask  # noqa: E402
from repro.core import stacking as jstack  # noqa: E402
from repro.core.strategies.fedprox import prox_term as j_prox  # noqa: E402
from repro_torch import NotPorted, convert  # noqa: E402
from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.core import stacking as tstack  # noqa: E402
from repro_torch.core.agg_engine import get_engine  # noqa: E402
from repro_torch.core.strategies.base import get_strategy  # noqa: E402
from repro_torch.core.strategies.fedprox import prox_term as t_prox  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TINY = dict(sites=4, batch=1, volume=(8, 8, 8), base_filters=4, num_levels=2)
SEG = dict(kind="seg", in_channels=2, num_classes=3, **TINY)
DOSE = dict(kind="dose", **TINY)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch thread for this module's tiny models: the suite runs in
    several worker processes on one host's cores, and PyTorch's default of
    a thread a core in every worker oversubscribes them many times over."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _two_inits(task_kw):
    init = JTask(**task_kw).build().init_fn
    return [jax.tree.map(np.asarray, init(jax.random.PRNGKey(k))) for k in (0, 1)]


@pytest.mark.parametrize("mu", [0.01, 0.5])
def test_prox_term_and_gradient_match_reference(mu):
    a, b = _two_inits(SEG)
    want, jgrad = jax.value_and_grad(lambda p: j_prox(p, b, mu))(
        jax.tree.map(jnp.asarray, a))
    pa = convert.from_reference(a)
    pb = convert.from_reference(b)
    leaves = [t.requires_grad_() for t in tree_leaves(pa)]
    got = t_prox(pa, pb, mu)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    # the strategy's term on its flat [N] anchor
    flat = torch.cat([t.reshape(-1) for t in tree_leaves(pb)])
    ctx = FederatedJob(task=TaskConfig(**SEG), strategy="fedprox", prox_mu=mu,
                       device="cpu").context()
    extra = get_strategy("fedprox").local_loss_extra(pa, {"global": flat}, ctx)
    np.testing.assert_allclose(extra.item(), float(want), rtol=1e-5)
    grads = torch.autograd.grad(got, leaves)
    for g, w in zip(grads, tree_leaves(convert.from_reference(
            jax.tree.map(np.asarray, jgrad)))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-9)


def test_stacking_row_operations_match_reference():
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(5, 3, 2)).astype(np.float32),
            "b": [rng.normal(size=(5, 4)).astype(np.float32)]}
    flat, layout = get_engine().flatten({k: (torch.from_numpy(v) if k == "a" else
                                             [torch.from_numpy(v[0])])
                                         for k, v in tree.items()})
    perm = np.array([3, 3, 0, 1, 4])
    got = tstack.gather_sites(flat, perm)
    want = jstack.gather_sites(jax.tree.map(jnp.asarray, tree), jnp.asarray(perm))
    for i in range(5):
        for g, w in zip(tree_leaves(tstack.site_slice(got, i, layout)),
                        jax.tree.leaves(jstack.site_slice(want, i))):
            assert np.array_equal(g.numpy(), np.asarray(w))
    mask = np.array([True, False, True, False, False])
    sel = tstack.where_site(torch.from_numpy(mask), got, flat)
    jsel = jstack.where_site(jnp.asarray(mask), want, jax.tree.map(jnp.asarray, tree))
    for i in range(5):
        for g, w in zip(tree_leaves(tstack.site_slice(sel, i, layout)),
                        jax.tree.leaves(jstack.site_slice(jsel, i))):
            assert np.array_equal(g.numpy(), np.asarray(w))


def test_fedprox_anchor_starts_at_the_shared_init():
    job = FederatedJob(task=TaskConfig(**SEG), strategy="fedprox", rounds=1, device="cpu")
    ctx = job.context()
    init = job.task.build().init_fn(0)
    flat, _ = get_engine().flatten(tstack.broadcast_to_sites(init, 4))
    anchor = get_strategy("fedprox").init_state(flat, ctx)["global"]
    np.testing.assert_allclose(anchor.numpy(), flat[0].numpy(), rtol=1e-6)


def _run_both(task_kw, **job_kw):
    job_kw = {**dict(rounds=3, seed=0, max_dropout=1), **job_kw}
    jjob = JJob(task=JTask(**task_kw), **job_kw)
    jres = jjob.run()
    init = jax.tree.map(np.asarray, jjob.task.build().init_fn(jax.random.PRNGKey(jjob.seed)))
    tjob = FederatedJob(task=TaskConfig(**task_kw), device="cpu", **job_kw)
    tres = tjob.run(init_params=convert.from_reference(init))
    assert tres.comm == jres.comm
    assert min(h["active"] for h in jres.history) < task_kw["sites"]    # a masked round ran
    for th, jh in zip(tres.history, jres.history):
        assert th["active"] == jh["active"]
        assert th.get("upload_bytes") == jh.get("upload_bytes")
        assert th.get("download_bytes") == jh.get("download_bytes")
        np.testing.assert_allclose(th["per_site_loss"], jh["per_site_loss"],
                                   rtol=1e-4, atol=1e-5)
    return tjob, tres, jres, init


@pytest.mark.parametrize("task_kw,job_kw", [
    (SEG, dict(prox_mu=0.5, case_counts=(52, 44, 35, 28))),
    (DOSE, dict(prox_mu=0.5, dropout_scenario="shutdown")),
    (SEG, dict(compression="int8", down_compression="int8")),
    (SEG, dict(aggregator="trimmed:1", adversary="sign_flip:1")),
    (SEG, dict(prox_mu=0.5, local_steps=2)),
], ids=["seg", "dose-shutdown", "seg-int8", "seg-trimmed", "seg-two-steps"])
def test_fedprox_trajectory_matches_jax_job(task_kw, job_kw):
    tjob, tres, jres, init = _run_both(task_kw, strategy="fedprox", **job_kw)
    # the anchor the next round would pull toward: the last global
    anchor = tres.state["strategy"]["global"]
    want = convert.from_reference(jax.tree.map(np.asarray, jres.state["strategy"]["global"]))
    want = torch.cat([t.reshape(-1) for t in tree_leaves(want)])
    bound = tjob.lr * tjob.rounds
    if "compression" in job_kw:
        # round 0 uploads the whole model against a zero reference
        bound += max(float(np.abs(x).max()) for x in jax.tree.leaves(init)) / 127
    assert float((anchor - want).abs().max()) <= bound
    assert float((anchor - want).abs().median()) <= 1e-6


def test_fedprox_pull_changes_the_trajectory():
    """With one local step from the broadcast global the Eq. 2 term is 0
    where it is read (the sites start at the anchor), so FedProx's losses
    are FedAvg's; with two local steps the second step reads it, so a large
    mu moves every round's losses."""
    base = FederatedJob(task=TaskConfig(**SEG), rounds=3, device="cpu")
    prox = base.replace(strategy="fedprox", prox_mu=50.0)
    assert prox.run().losses == base.run().losses
    two_avg = base.replace(local_steps=2).run().losses
    two_prox = prox.replace(local_steps=2).run().losses
    assert all(p > a + 1e-3 for a, p in zip(two_avg, two_prox))


# the reference's refused compositions for the strategies this slice ports
@pytest.mark.parametrize("kw,frag", [
    (dict(strategy="gcml", compression="int8"), "fedavg/fedprox only"),
    (dict(strategy="individual", compression="int8"), "fedavg/fedprox only"),
    (dict(strategy="pooled", compression="int8"), "fedavg/fedprox only"),
    (dict(strategy="gcml", down_compression="int8"), "fedavg/fedprox"),
    (dict(strategy="pooled", down_compression="int8"), "fedavg/fedprox"),
    (dict(strategy="gcml", aggregator="median"), "central combine"),
    (dict(strategy="individual", aggregator="trimmed:1"), "central combine"),
    (dict(strategy="fedprox", scheduler="buffered"), "fedavg only"),
    (dict(strategy="gcml", scheduler="buffered"), "fedavg only"),
    (dict(strategy="pooled", sample="uniform:2"), "pooled"),
    (dict(strategy="pooled", adversary="sign_flip:1"), "pooled"),
    (dict(strategy="gcml", topology="pods:2"), "centrally-aggregated"),
])
def test_refused_strategy_compositions_raise_the_reference_value_error(kw, frag):
    with pytest.raises(ValueError, match=frag):
        JJob(task=JTask(**SEG), rounds=1, **kw).run()
    with pytest.raises(ValueError, match=frag):
        FederatedJob(task=TaskConfig(**SEG), rounds=1, device="cpu", **kw).run()


# a case whose seam has since been ported names another seam still
# unported, under the id it always had (the device_data and shard_sites
# cases keep their field; since the token task was ported, they train an
# architecture the port has not got and name the arch seam: since every
# token architecture was ported, sanet-openkbp, the registry's one id
# outside the port's)
TOKENS = TaskConfig(**dict(SEG, kind="tokens", arch="sanet-openkbp"))


@pytest.mark.parametrize("kw,seam", [
    pytest.param(dict(strategy="fedprox", transport="thread", topology="pods:2", dp_clip=1.0,
                      device_data=True, task=TOKENS), "arch", id="kw0-strategy"),
    pytest.param(dict(strategy="gcml", transport="tcp", compression="fp8", dp_clip=1.0,
                      device_data=True, task=TOKENS), "arch", id="kw1-strategy"),
    pytest.param(dict(strategy="fedprox", device_data=True, task=TOKENS), "arch",
                 id="kw2-device_data"),
    pytest.param(dict(strategy="fedprox", topology="pods:2", device_data=True, task=TOKENS),
                 "arch", id="kw3-topology"),
    pytest.param(dict(strategy="fedprox", dp_clip=1.0, shard_sites=True, task=TOKENS), "arch",
                 id="kw4-dp"),
])
def test_unported_seams_of_the_strategies_raise_not_ported(kw, seam):
    with pytest.raises(NotPorted) as err:
        FederatedJob(task=TaskConfig(**SEG), rounds=1, device="cpu").replace(**kw).run()
    assert err.value.seam == seam


def test_krum_global_row_is_a_copy():
    """FedProx keeps the round's global row as its next anchor while the
    local phase writes the sites' rows in place: Krum's pick must not alias
    the buffer."""
    from repro_torch.core.agg_engine import krum_select
    flat = torch.from_numpy(np.random.default_rng(0).normal(size=(5, 7)).astype(np.float32))
    row = krum_select(flat, torch.ones(5), 1)
    before = row.clone()
    flat.add_(1.0)
    assert torch.equal(row, before)
