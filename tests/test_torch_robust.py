"""The port's Byzantine-robust rounds against the JAX reference.

Inputs are made with numpy from a seed and fed to both packages.  The
reference's trimmed-mean kernel runs under the Pallas interpreter, as its
own tests run it; the port's wrapper takes its plain version on the CPU.

Tolerances, and why:

- the trimmed mean and the median: rtol 1e-6, atol 1e-7, with identical
  non-finite positions.  Both sides sort the same fp32 values and add the
  kept ranks in fp32; the port adds them one rank at a time in ascending
  order, XLA in an order of its own.  On these inputs the port's plain
  version turned out bit-exact with the reference's kernel and its twin;
- Krum: the same row index, and the row bit for bit (it is returned
  verbatim).  The distances differ by round-off (another matmul);
- ``clip_rows``: rtol 1e-6 (the norm summed in another order);
- malicious sets, sampling masks and the float32 ``1/pi`` scales: bit-equal
  (the same numpy streams).  Scales are compared as float32, never against
  a float64 ``1/pi``;
- jobs: per-site losses rtol 1e-4, atol 1e-5 and ``comm`` equal, with the
  global model held as in ``tests/test_torch_job.py`` (the int8 job as in
  ``tests/test_torch_compression.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import FederatedJob as JJob  # noqa: E402
from repro.api import TaskConfig as JTask  # noqa: E402
from repro.api import _validate_down as j_validate_down  # noqa: E402
from repro.api import _validate_robustness as j_validate_robustness  # noqa: E402
from repro.core import adversary as jadv  # noqa: E402
from repro.core import agg_engine as jagg  # noqa: E402
from repro.core import sampling as jsamp  # noqa: E402
from repro.core.session import availability_masks as j_availability  # noqa: E402
from repro.kernels import robust as jrobust  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.core import adversary as tadv  # noqa: E402
from repro_torch.core import agg_engine as tagg  # noqa: E402
from repro_torch.core import sampling as tsamp  # noqa: E402
from repro_torch.kernels import build, ops, robust  # noqa: E402
from repro_torch.kernels.ref import masked_median_ref, trimmed_mean_ref  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TRIM_TOL = dict(rtol=1e-6, atol=1e-7)
# a tiny SA-Net: the JAX jobs dominate this file's time
TINY = dict(kind="dose", sites=4, batch=1, volume=(8, 8, 8), base_filters=4, num_levels=2)


# -- the trimmed mean and the median ------------------------------------------------


def _active_patterns(s):
    """All active, one inactive, one active (k = 1), none (k = 0)."""
    one_off = np.ones(s, bool)
    one_off[s // 2] = False
    k1 = np.zeros(s, bool)
    k1[s - 1] = True
    return {"all": np.ones(s, bool), "one_inactive": one_off, "k1": k1,
            "k0": np.zeros(s, bool)}


def _buffer(s, n=300, seed=0):
    """[S, N] fp32 with NaN and +-inf in active and inactive rows."""
    x = (np.random.default_rng(seed).normal(size=(s, n)) * 3.0).astype(np.float32)
    x[0, 0] = np.nan
    x[s - 1, 1] = np.inf
    x[0, 2] = -np.inf
    x[s // 2, 3] = np.nan                         # inactive in "one_inactive"
    x[:, 4] = np.inf
    if s > 1:
        x[1, 5] = -np.inf
        x[1, 6] = np.nan
    return x


@pytest.mark.parametrize("s", [1, 2, 3, 4, 5, 8])
def test_trimmed_mean_and_median_plain_versions_match_reference(s):
    x = _buffer(s, seed=s)
    for f in sorted({0, 1, 2, s}):
        for name, mask in _active_patterns(s).items():
            a = mask.astype(np.float32)
            got = trimmed_mean_ref(torch.from_numpy(x), torch.from_numpy(a), f).numpy()
            kern = np.asarray(jrobust.trimmed_mean(jnp.asarray(x), jnp.asarray(a), f,
                                                   interpret=True))
            twin = np.asarray(jrobust.trimmed_mean_ref(jnp.asarray(x), jnp.asarray(a), f))
            for want in (kern, twin):
                np.testing.assert_allclose(got, want, **TRIM_TOL,
                                           err_msg=f"f={f} active={name}")
            if name == "k0":
                assert not got.any()                      # no active row: 0
        med = masked_median_ref(torch.from_numpy(x), torch.from_numpy(a)).numpy()
        np.testing.assert_allclose(
            med, np.asarray(jrobust.masked_median(jnp.asarray(x), jnp.asarray(a),
                                                  interpret=True)), **TRIM_TOL)


def test_median_is_numpy_median_of_active_rows():
    x = _buffer(7, seed=3)[:, 7:]                  # finite columns
    mask = np.array([1, 0, 1, 1, 0, 1, 1], bool)
    got = robust.masked_median(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, np.median(x[mask], axis=0), rtol=1e-6, atol=1e-6)


def test_trimmed_mean_wrapper_takes_plain_version_on_cpu_and_refuses_bad_input():
    x = torch.from_numpy(_buffer(5, seed=1))
    a = torch.ones(5)
    before = dict(build.LAUNCHES)
    torch.testing.assert_close(ops.trimmed_mean(x, a, 1), trimmed_mean_ref(x, a, 1),
                               rtol=0, atol=0, equal_nan=True)
    assert build.LAUNCHES == before                    # CPU: no kernel launched
    with pytest.raises(TypeError):
        ops.trimmed_mean(x.double(), a, 1)
    with pytest.raises(ValueError):
        ops.trimmed_mean(x, torch.ones(4), 1)
    with pytest.raises(ValueError):
        ops.trimmed_mean(x, a, -1)
    # the kernel's site limit is the kernel's: its wrapper checks it before
    # the device, so this runs on the CPU; the plain version has none
    with pytest.raises(ValueError, match="at most 256 sites"):
        robust.trimmed_mean_cuda(torch.zeros(robust.MAX_SITES + 1, 3),
                                 torch.ones(robust.MAX_SITES + 1), 1)
    with pytest.raises(ValueError):
        robust.trimmed_mean_cuda(x, a, 1)                  # not a CUDA tensor


# trimmed:3 over 300 rows keeps 251 ranks, which the port adds one at a time
# in ascending order (as its kernel does) and XLA as a tree; the two fp32
# sums differ by up to 1.21e-6 here (measured), above TRIM_TOL's atol
TRIMMED_300_ATOL = 4e-6


@pytest.mark.parametrize("spec", ["median", "trimmed:3"])
def test_plain_rules_take_more_sites_than_the_kernel(spec):
    """300 rows, more than the kernel's 256: the plain rules on the CPU
    run them through the engine, as the reference does.  The median (one
    or two ranks) holds ``TRIM_TOL``; ``trimmed:3`` its rtol with
    ``TRIMMED_300_ATOL``."""
    s = 300
    x = _buffer(s, n=257, seed=11)
    active = np.ones(s, bool)
    active[::7] = False
    got = tagg.get_engine().reduce_robust_flat(torch.from_numpy(x), active,
                                               tagg.parse_aggregator(spec)).numpy()
    want = np.asarray(jagg.get_engine().reduce_robust_flat(
        jnp.asarray(x), jnp.asarray(active), jagg.parse_aggregator(spec)))
    assert got.shape == (257,)
    atol = TRIM_TOL["atol"] if spec == "median" else TRIMMED_300_ATOL
    np.testing.assert_allclose(got, want, rtol=TRIM_TOL["rtol"], atol=atol)


# -- Krum and the norm clip ---------------------------------------------------------


@pytest.mark.parametrize("s,f,active", [
    (4, 1, [1, 1, 1, 1]), (6, 1, [1, 0, 1, 1, 0, 1]), (5, 2, [1, 1, 1, 1, 0]),
    (4, 1, [0, 0, 1, 0]), (5, 1, [1, 0, 0, 1, 0])])
def test_krum_picks_the_reference_row(s, f, active):
    rng = np.random.default_rng(s * 10 + f)
    x = rng.normal(size=(s, 257)).astype(np.float32)
    x[0] *= 40.0                                       # an outlier
    mask = np.asarray(active, bool)
    jrow = np.asarray(jagg.krum_select(jnp.asarray(x), jnp.asarray(mask), f))
    (jidx,) = [i for i in range(s) if np.array_equal(x[i], jrow)]
    idx = int(tagg.krum_index(torch.from_numpy(x), mask, f))
    assert idx == jidx and mask[idx]
    np.testing.assert_array_equal(tagg.krum_select(torch.from_numpy(x), mask, f).numpy(), jrow)
    assert np.array_equal(
        tagg.get_engine().reduce_robust_flat(torch.from_numpy(x), mask,
                                             tagg.parse_aggregator(f"krum:{f}")).numpy(), jrow)


@pytest.mark.parametrize("c", [0.5, 3.0, 100.0])
def test_clip_rows_matches_reference(c):
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(4, 513)) * np.array([[0.01], [0.1], [1.0], [10.0]])).astype(np.float32)
    x[1] = 0.0                                         # a zero row: the 1e-12 floor
    got = tagg.clip_rows(torch.from_numpy(x), c).numpy()
    np.testing.assert_allclose(got, np.asarray(jagg.clip_rows(jnp.asarray(x), c)), rtol=1e-6)


@pytest.mark.parametrize("spec", ["fedavg", "trimmed:1", "median", "krum:1", "normclip:1"])
def test_engine_aggregate_matches_reference(spec):
    """The tree path and the in-place [S, N] path against the reference's
    ``aggregate``; normclip folds each row's clip factor into its weight,
    and the inactive row keeps its own, unclipped weights."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(4, 300)) * np.array([[0.01], [0.5], [2.0], [1.0]])).astype(np.float32)
    active = np.array([1, 0, 1, 1], bool)
    cw = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    jstacked, jglobal = jagg.get_engine().aggregate(
        {"w": jnp.asarray(x)}, jnp.asarray(cw), jnp.asarray(active),
        aggregator=jagg.parse_aggregator(spec))
    eng, tspec = tagg.get_engine(), tagg.parse_aggregator(spec)
    tstacked, tglobal = eng.aggregate({"w": torch.from_numpy(x)}, torch.from_numpy(cw),
                                      active, aggregator=tspec)
    flat = torch.from_numpy(x.copy())
    g = eng.aggregate_flat(flat, torch.from_numpy(cw), active, aggregator=tspec)
    for got in (tglobal["w"], g):
        np.testing.assert_allclose(got.numpy(), np.asarray(jglobal["w"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tstacked["w"][1].numpy(), x[1])
    np.testing.assert_array_equal(flat[1].numpy(), x[1])          # never clipped
    for i in np.flatnonzero(active):
        assert torch.equal(flat[i], g)
    np.testing.assert_allclose(tstacked["w"].numpy(), np.asarray(jstacked["w"]),
                               rtol=1e-6, atol=1e-7)


# -- the grammars and the adversary --------------------------------------------------


@pytest.mark.parametrize("spec", ["fedavg", None, "trimmed:0", "trimmed:2", "median",
                                  "krum:1", "normclip:0.5", "trimmed", "krum", "normclip:0",
                                  "normclip:-1", "foo", "median:2", "trimmed:-1"])
def test_aggregator_grammar_matches_reference(spec):
    try:
        want = jagg.parse_aggregator(spec)
    except ValueError:
        with pytest.raises(ValueError):
            tagg.parse_aggregator(spec)
        return
    got = tagg.parse_aggregator(spec)
    assert (got.name, got.f, got.c, got.spec) == (want.name, want.f, want.c, want.spec)
    assert (got.robust, got.rank_based) == (want.robust, want.rank_based)
    assert tagg.parse_aggregator(got.spec) == got


@pytest.mark.parametrize("spec", ["sign_flip:2", "label_flip:1", "scale:10:1", "noise:0.5:2",
                                  "none", None, "sign_flip", "scale:1", "noise:1", "what:1",
                                  "sign_flip:0"])
def test_adversary_grammar_matches_reference(spec):
    try:
        want = jadv.parse_adversary(spec, seed=3)
    except ValueError:
        with pytest.raises(ValueError):
            tadv.parse_adversary(spec, seed=3)
        return
    got = tadv.parse_adversary(spec, seed=3)
    if want is None:
        assert got is None
        return
    assert (got.kind, got.f, got.param, got.seed) == (want.kind, want.f, want.param, want.seed)
    assert (got.flips_params, got.flips_labels) == (want.flips_params, want.flips_labels)


def test_malicious_sets_bit_equal_reference():
    for seed in range(5):
        for s in range(1, 9):
            for f in (1, 2, 3):
                want = jadv.AdversaryPlan("sign_flip", f, seed=seed).malicious_mask(s)
                got = tadv.AdversaryPlan("sign_flip", f, seed=seed).malicious_mask(s)
                assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("spec", ["sign_flip:2", "scale:3:2", "label_flip:2"])
def test_perturbations_match_reference(spec):
    rng = np.random.default_rng(1)
    s = 5
    x = rng.normal(size=(s, 40)).astype(np.float32)
    dose = rng.normal(size=(s, 1, 2, 3)).astype(np.float32)
    jplan, tplan = jadv.parse_adversary(spec, seed=2), tadv.parse_adversary(spec, seed=2)
    mask = jplan.malicious_mask(s) & np.array([1, 1, 0, 1, 1], bool)
    flat = torch.from_numpy(x.copy())
    if tplan.flips_params:
        tplan.perturb_rows(flat, mask)
    want = np.asarray(jplan.perturb_stacked({"w": jnp.asarray(x)}, jnp.asarray(mask), 0)["w"])
    np.testing.assert_array_equal(flat.numpy(), want)
    batches = {"dose": torch.from_numpy(dose), "volume": torch.ones(s, 2)}
    got = tplan.perturb_batches(batches, mask) if tplan.flips_labels else batches
    jb = jplan.perturb_batches({"dose": jnp.asarray(dose), "volume": jnp.ones((s, 2))},
                               jnp.asarray(mask))
    np.testing.assert_array_equal(got["dose"].numpy(), np.asarray(jb["dose"]))
    assert torch.equal(got["volume"], torch.ones(s, 2))


def test_noise_attack_is_not_ported():
    """The noise attack, once refused, now perturbs a row as the
    reference's host twin perturbs the same site's upload (within 4 ulp of
    each normal; ``test_torch_dp.py`` holds the stacked rows); an unmasked
    row stays as it was."""
    from repro_torch.core.agg_engine import tree_layout
    plan, jplan = tadv.parse_adversary("noise:1:1", seed=2), jadv.parse_adversary("noise:1:1",
                                                                              seed=2)
    assert plan.flips_params
    flat = torch.zeros(2, 3)
    plan.perturb_rows(flat, np.array([False, True]), 5, tree_layout({"w": torch.zeros(3)}))
    want = jplan.perturb_tree({"w": np.zeros(3, np.float32)}, 1, 5)["w"]
    assert torch.equal(flat[0], torch.zeros(3))
    np.testing.assert_allclose(flat[1].numpy(), want, rtol=4 * 2.0 ** -23, atol=0)


# -- client sampling --------------------------------------------------------------


@pytest.mark.parametrize("spec", ["uniform:1", "uniform:3", "uniform:8", "poisson:0.375",
                                  "poisson:0.75", "poisson:1.0", "none"])
def test_sampling_masks_and_scales_bit_equal_reference(spec):
    jsm, tsm = jsamp.resolve_sampler(spec), tsamp.resolve_sampler(spec)
    assert tsm.spec == jsm.spec
    for s in (2, 4, 7):
        assert tsm.inclusion_probability(s) == jsm.inclusion_probability(s)
        for seed in range(3):
            avail = j_availability(s, min(1, s - 1), seed, 12)
            tp, ts = tsamp.compose_participation(tsm, avail, seed)
            jp, js = jsamp.compose_participation(jsm, avail, seed)
            assert np.array_equal(tp, jp) and tp.any(axis=1).all()
            assert ts.dtype == js.dtype == np.float32 and np.array_equal(ts, js)


@pytest.mark.parametrize("spec", ["uniform:0", "uniform:x", "poisson:0", "poisson:x", "bogus"])
def test_sampler_spec_errors_match_reference(spec):
    with pytest.raises(ValueError):
        jsamp.resolve_sampler(spec)
    with pytest.raises(ValueError):
        tsamp.resolve_sampler(spec)
    with pytest.raises(ValueError):
        FederatedJob(task=TaskConfig(**TINY), rounds=1, device="cpu", sample=spec).run()


def test_job_participation_equals_reference():
    kw = dict(rounds=3, max_dropout=1, seed=4, sample="poisson:0.5")
    jjob, tjob = JJob(task=JTask(**TINY), **kw), FederatedJob(task=TaskConfig(**TINY),
                                                             device="cpu", **kw)
    assert tjob.sampled == jjob.sampled is True
    for got, want in zip(tjob.participation(12), jjob.participation(12)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


# -- composition guards -------------------------------------------------------------


@pytest.mark.parametrize("kw,frag", [
    (dict(aggregator="trimmed:2"), "majority"),
    (dict(aggregator="krum:2"), "krum"),
    (dict(aggregator="median", compression="int8"), "compression='none'"),
    (dict(adversary="sign_flip:1", compression="int8"), "compression='none'"),
    (dict(aggregator="median", secure_agg=True), "secure_agg"),
    (dict(aggregator="median", scheduler="buffered"), "side"),
    (dict(aggregator="median", strategy="gcml"), "central combine"),
    (dict(aggregator="trimmed:1", shard_sites=True), "shard_sites"),
    (dict(adversary="sign_flip:1", shard_sites=True), "shard_sites"),
    (dict(adversary="sign_flip:1", strategy="pooled"), "pooled"),
    (dict(aggregator="normclip:1", strategy="individual"), "normclip"),
    (dict(aggregator="median", down_compression="int8"), "down_compression='none'"),
    (dict(adversary="label_flip:1", down_compression="int8"), "down_compression='none'"),
    (dict(aggregator="trimmed"), "adversary budget"),
    (dict(adversary="what:1"), "unknown adversary"),
])
def test_composition_guards_raise_the_reference_error(kw, frag):
    jjob = JJob(task=JTask(**TINY), rounds=1, **kw)
    with pytest.raises(ValueError, match=frag):
        j_validate_robustness(jjob)
        j_validate_down(jjob)
    with pytest.raises(ValueError, match=frag):
        FederatedJob(task=TaskConfig(**TINY), rounds=1, device="cpu", **kw).run()


# -- job trajectories ---------------------------------------------------------------


def _run_both(kw):
    job_kw = {**dict(strategy="fedavg", rounds=3, max_dropout=1, seed=0), **kw}
    jjob = JJob(task=JTask(**TINY), **job_kw)
    jres = jjob.run()
    init = jax.tree.map(np.asarray, jjob.task.build().init_fn(jax.random.PRNGKey(jjob.seed)))
    tjob = FederatedJob(task=TaskConfig(**TINY), device="cpu", **job_kw)
    tres = tjob.run(init_params=convert.from_reference(init))
    assert tres.comm == jres.comm
    assert [h["active"] for h in tres.history] == [h["active"] for h in jres.history]
    assert min(h["active"] for h in jres.history) < TINY["sites"]     # a masked round ran
    for th, jh in zip(tres.history, jres.history):
        np.testing.assert_allclose(th["per_site_loss"], jh["per_site_loss"],
                                   rtol=1e-4, atol=1e-5)
    want = convert.from_reference(jax.tree.map(np.asarray, jres.global_params))
    diff = torch.cat([(a - b).abs().reshape(-1) for a, b in
                      zip(tree_leaves(tres.global_params), tree_leaves(want))])
    return jjob, init, diff


@pytest.mark.parametrize("kw", [
    dict(aggregator="trimmed:1", adversary="sign_flip:1"),
    dict(aggregator="median", adversary="label_flip:1"),
    dict(aggregator="krum:1", adversary="scale:3:1"),
    dict(aggregator="normclip:10"),          # the init's norm is 15.8: the clip binds
    dict(aggregator="median", sample="uniform:3"),
    # seed 11: the malicious site (3) is offline in rounds 0 and 1, and
    # must neither train nor be perturbed there
    dict(aggregator="trimmed:1", adversary="sign_flip:1", dropout_scenario="shutdown",
         seed=11),
], ids=["trimmed-signflip", "median-labelflip", "krum-scale", "normclip", "median-uniform",
        "trimmed-signflip-shutdown"])
def test_robust_trajectory_matches_jax_job(kw):
    jjob, _, diff = _run_both(kw)
    assert float(diff.max()) <= jjob.lr * jjob.rounds
    assert float(diff.median()) <= 1e-6
    assert float((diff > 1e-4).float().mean()) < 0.01


def test_sampled_int8_trajectory_matches_jax_job():
    jjob, init, diff = _run_both(dict(compression="int8", sample="poisson:0.75"))
    step = max(float(np.abs(x).max()) for x in jax.tree.leaves(init)) / 127
    assert float(diff.max()) <= step + jjob.lr * jjob.rounds
    assert float((diff <= 1e-2 * jjob.lr).float().mean()) >= 0.9
