"""The port's segmentation task, partition, scores and baselines against the
JAX reference.

Inputs are made with numpy from a seed and fed to both packages; the jobs
start from the reference's initial parameters, converted.  Tolerances:

- partition, scores and ``SegTaskGenerator``: bit-equal (the same numpy
  code on the same seeds);
- the segmentation and dose losses: rtol 1e-5, atol 1e-6; ``logits_fn``:
  rtol 1e-5 plus an atol of 1e-5 of the largest logit (fp32 convolutions
  summed in another order, as ``tests/test_torch_sanet.py`` holds
  SA-Net's outputs), labels equal;
- jobs (8^3, 4 filters, 2 levels, 3 rounds): per-site losses rtol 1e-4,
  atol 1e-5, ``comm`` equal, the history's ``active`` equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import metrics as jmetrics  # noqa: E402
from repro.api import FederatedJob as JJob  # noqa: E402
from repro.api import TaskConfig as JTask  # noqa: E402
from repro.configs import sanet_openkbp as jconf  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.data.synthetic import SegTaskGenerator as JSeg  # noqa: E402
from repro.metrics import scores as jscores  # noqa: E402
from repro.models import sanet as jsanet  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import metrics as tmetrics  # noqa: E402
from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.configs import sanet_openkbp as tconf  # noqa: E402
from repro_torch.core.stacking import site_slice  # noqa: E402
from repro_torch.data import partition as tpart  # noqa: E402
from repro_torch.data.synthetic import SegTaskGenerator as TSeg  # noqa: E402
from repro_torch.metrics import scores as tscores  # noqa: E402
from repro_torch.models import sanet as tsanet  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

# a tiny SA-Net: the JAX jobs dominate this file's time
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


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert np.array_equal(a[k], b[k]), k


# -- partition and scores ------------------------------------------------------------


def test_partition_tables_equal_reference():
    for name in ("OPENKBP_IID_TRAIN", "OPENKBP_IID_VAL", "OPENKBP_NONIID_TRAIN",
                 "OPENKBP_NONIID_VAL", "BRATS_SITE_CASES", "PANSEG_SITE_CASES"):
        assert getattr(tpart, name) == getattr(jpart, name), name


@pytest.mark.parametrize("num_cases,counts,seed", [
    (200, jpart.OPENKBP_NONIID_TRAIN, 0), (240, jpart.OPENKBP_IID_TRAIN, 3),
    (227, jpart.BRATS_SITE_CASES, 1), (400, jpart.PANSEG_SITE_CASES, 9)])
def test_partition_indices_bit_equal(num_cases, counts, seed):
    got = tpart.partition_indices(num_cases, counts, seed)
    want = jpart.partition_indices(num_cases, counts, seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("alpha,sites,seed", [(0.5, 4, 0), (0.1, 8, 5), (10.0, 3, 2)])
def test_dirichlet_partition_bit_equal(alpha, sites, seed):
    labels = np.random.default_rng(seed).integers(0, 6, 300)
    got = tpart.dirichlet_label_partition(labels, sites, alpha, seed)
    want = jpart.dirichlet_label_partition(labels, sites, alpha, seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_scores_bit_equal():
    rng = np.random.default_rng(0)
    pred, true = rng.random((12, 10, 8)), rng.random((12, 10, 8))
    mask = rng.random((12, 10, 8)) > 0.4
    rois = [rng.random((12, 10, 8)) > t for t in (0.2, 0.7, 1.1)]   # one empty ROI
    assert tscores.dose_score(pred, true, mask) == jscores.dose_score(pred, true, mask)
    assert tscores.dvh_score(pred, true, rois) == jscores.dvh_score(pred, true, rois)
    assert tscores.dvh_score(pred, true, []) == jscores.dvh_score(pred, true, [])
    pl, tl = rng.integers(0, 4, (9, 9, 9)), rng.integers(0, 4, (9, 9, 9))
    for c, bg in [(4, True), (4, False), (6, True)]:             # class 4, 5 absent
        assert (tscores.dice_coefficient(pl, tl, c, bg)
                == jscores.dice_coefficient(pl, tl, c, bg))
    groups = [rng.normal(m, 1.0, n) for m, n in [(0.0, 12), (0.3, 9), (0.1, 15)]]
    assert tmetrics.one_way_anova(groups) == jmetrics.one_way_anova(groups)
    assert tscores.one_way_anova([np.ones(4), np.ones(3)]) == (0.0, 1.0)
    for a, b, x in [(2.5, 1.5, 0.3), (6.0, 1.0, 0.9), (0.5, 0.5, 0.0), (1.0, 3.0, 1.0)]:
        assert tscores._betainc(a, b, x) == jscores._betainc(a, b, x)


# -- the segmentation task -----------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(volume=(8, 8, 8), in_channels=2, num_classes=3, num_sites=3),
    dict(volume=(8, 12, 10), in_channels=4, num_classes=4, num_sites=4,
         heterogeneity=0.5, seed=7),
    dict(volume=(8, 8, 8), in_channels=1, num_classes=2, num_sites=5, seed=2),
])
def test_seg_generator_bit_equal(kw):
    jg, tg = JSeg(**kw), TSeg(**kw)
    for site, step in [(0, 0), (1, 3), (kw["num_sites"] - 1, 11)]:
        _equal(tg.sample(site, step, 2), jg.sample(site, step, 2))
    _equal(tg.stacked_batches(2, 2, 1), jg.stacked_batches(2, 2, 1))


def test_seg_generator_site_pools_bit_equal_at_32():
    kw = dict(volume=(32, 32, 32), in_channels=4, num_classes=4, num_sites=3,
              site_pools=(1, 2, 5), seed=3)
    jg, tg = JSeg(**kw), TSeg(**kw)
    for site, step in [(0, 4), (1, 7), (2, 5)]:
        _equal(tg.sample(site, step, 1), jg.sample(site, step, 1))


def test_configs_and_parameter_counts_equal_reference():
    for name in ("SANET", "SANET_SEG", "SANET_OAR"):
        assert vars(getattr(tconf, name)) == vars(getattr(jconf, name)), name
    assert vars(tconf.reduced_seg()) == vars(jconf.reduced_seg())
    for tcfg, jcfg in [(tconf.SANET_SEG, jconf.SANET_SEG), (tconf.SANET_OAR, jconf.SANET_OAR)]:
        want = jax.eval_shape(lambda k: jsanet.sanet_init(k, jcfg), jax.random.PRNGKey(0))
        got = tsanet.sanet_init(torch.Generator().manual_seed(0), tcfg)
        assert (sum(t.numel() for t in tree_leaves(got))
                == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(want)))
    for task, cfg in [(tconf.BRATS_TASK, tconf.SANET_SEG), (tconf.PANSEG_TASK, tconf.SANET_OAR)]:
        assert TaskConfig(**task).model_config() == cfg
        assert vars(JTask(**task).model_config()) == vars(cfg)
    assert TaskConfig(**tconf.BRATS_TASK).sites == 4
    assert TaskConfig(**tconf.PANSEG_TASK).sites == 5


def _bundles(task_kw, seed=0):
    jb = JTask(**task_kw).build()
    tb = TaskConfig(**task_kw).build()
    init = jax.tree.map(np.asarray, jb.init_fn(jax.random.PRNGKey(seed)))
    batch = {k: v[0, 0] for k, v in jb.stacked(1, 1).items()}
    return jb, tb, init, batch


@pytest.mark.parametrize("task_kw", [SEG, DOSE, dict(SEG, in_channels=1, num_classes=2)],
                         ids=["seg", "dose", "seg-2class"])
def test_loss_logits_and_forward_match_reference(task_kw):
    jb, tb, init, batch = _bundles(task_kw)
    params = convert.from_reference(init)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tb.loss_fn(params, tbatch)[0].item(),
                               float(jax.jit(jb.loss_fn)(init, jbatch)[0]), **tol)
    jl, jlab = jax.jit(jb.logits_fn)(init, jbatch)
    tl, tlab = tb.logits_fn(params, tbatch)
    # near-zero logits carry the conv stack's absolute round-off
    scale = float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5 * scale)
    assert np.array_equal(tlab.numpy(), np.asarray(jlab))
    f, fl, flab = tb.forward_fn(params, tbatch)
    assert f.item() == tb.loss_fn(params, tbatch)[0].item()
    assert torch.equal(fl, tl) and torch.equal(flab, tlab)


@pytest.mark.parametrize("task_kw", [SEG, dict(SEG, in_channels=1, num_classes=2)],
                         ids=["seg", "seg-2class"])
def test_seg_tree_converts_to_the_port_layout(task_kw):
    jb, tb, init, _ = _bundles(task_kw)
    got = convert.from_reference(init)
    want = tb.init_fn(0)
    assert [tuple(t.shape) for t in tree_leaves(got)] == [tuple(t.shape) for t in
                                                          tree_leaves(want)]
    back = convert.to_reference(got)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(init)):
        assert np.array_equal(a, b)


# -- job trajectories ---------------------------------------------------------------


def _run_both(task_kw, **job_kw):
    job_kw = {**dict(rounds=3, seed=0), **job_kw}
    jjob = JJob(task=JTask(**task_kw), **job_kw)
    jres = jjob.run()
    init = jax.tree.map(np.asarray, jjob.task.build().init_fn(jax.random.PRNGKey(jjob.seed)))
    tjob = FederatedJob(task=TaskConfig(**task_kw), device="cpu", **job_kw)
    tres = tjob.run(init_params=convert.from_reference(init))
    assert tres.comm == jres.comm
    assert [h["active"] for h in tres.history] == [h["active"] for h in jres.history]
    for th, jh in zip(tres.history, jres.history):
        assert len(th["per_site_loss"]) == len(jh["per_site_loss"])
        np.testing.assert_allclose(th["per_site_loss"], jh["per_site_loss"],
                                   rtol=1e-4, atol=1e-5)
    return tjob, tres, jres


@pytest.mark.parametrize("task_kw,job_kw", [
    (SEG, dict(strategy="fedavg", max_dropout=1, case_counts=(52, 44, 35, 28))),
    (SEG, dict(strategy="individual", max_dropout=1)),
    (SEG, dict(strategy="pooled")),
    (DOSE, dict(strategy="pooled")),
    (DOSE, dict(strategy="individual")),
], ids=["seg-fedavg", "seg-individual", "seg-pooled", "dose-pooled", "dose-individual"])
def test_baseline_trajectories_match_jax_job(task_kw, job_kw):
    tjob, tres, jres = _run_both(task_kw, **job_kw)
    s = tres.state["params"].shape[0]
    assert s == (1 if job_kw["strategy"] == "pooled" else task_kw["sites"])
    if job_kw["strategy"] == "pooled":
        assert all(h["active"] == task_kw["sites"] for h in tres.history)
    if job_kw["strategy"] != "fedavg":
        assert tres.comm is None
    # the global model: the case-weighted mean of the final site models
    want = convert.from_reference(jax.tree.map(np.asarray, jres.global_params))
    for a, b in zip(tree_leaves(tres.global_params), tree_leaves(want)):
        assert float((a - b).abs().max()) <= tjob.lr * tjob.rounds
    if job_kw["strategy"] == "individual":
        # the individual baseline is scored site by site
        layout = tres.state["layout"]
        jstate = jax.tree.map(np.asarray, jres.state["params"])
        for i in range(s):
            got = site_slice(tres.state["params"], i, layout)
            ref = convert.from_reference(jax.tree.map(lambda x: x[i], jstate))
            for a, b in zip(tree_leaves(got), tree_leaves(ref)):
                assert float((a - b).abs().max()) <= tjob.lr * tjob.rounds


def test_pooled_batches_are_the_sites_concatenated():
    tb = TaskConfig(**SEG).build()
    jb = JTask(**SEG).build()
    stacked = tb.round_batches(1, 2)
    pooled = tb.round_batches(1, 2, pooled=True)
    want = jb.pooled_view(jb.stacked(1, 2))
    _equal(pooled, want)
    assert pooled["volume"].shape[:3] == (1, 2, SEG["sites"] * SEG["batch"])
    _equal({k: v[0, :, :SEG["batch"]] for k, v in pooled.items()},
           {k: v[0] for k, v in stacked.items()})


def test_pooled_refuses_sampling_and_robust_rules():
    for kw, frag in [(dict(sample="uniform:2"), "pooled"),
                     (dict(aggregator="median"), "pooled")]:
        with pytest.raises(ValueError, match=frag):
            JJob(task=JTask(**SEG), strategy="pooled", rounds=1, **kw).run()
        with pytest.raises(ValueError, match=frag):
            FederatedJob(task=TaskConfig(**SEG), strategy="pooled", rounds=1,
                         device="cpu", **kw).run()


def test_pooled_trains_its_one_site_under_either_scenario():
    """The reference's pooled scan breaks under shutdown churn (its [S] mask
    meets the 1-site carry); the port's pooled site trains every round, and
    its history counts the available sites as the reference's does."""
    kw = dict(task=JTask(**DOSE), strategy="pooled", rounds=2, max_dropout=1,
              dropout_scenario="shutdown")
    with pytest.raises(TypeError):
        JJob(**kw).run()
    job = FederatedJob(**{**kw, "task": TaskConfig(**DOSE)}, device="cpu")
    res = job.run()
    down = job.replace(dropout_scenario="disconnect").run()
    assert res.losses == down.losses
    assert [h["active"] for h in res.history] == job.masks(2).sum(axis=1).tolist()
    assert min(h["active"] for h in res.history) < DOSE["sites"]
