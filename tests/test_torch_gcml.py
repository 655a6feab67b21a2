"""The port's GCML (gossip pairing, regional DCML, paper Eq. 3) against the
JAX reference.

Inputs are made with numpy from a seed and fed to both packages; models
start from the reference's initial parameters, converted.  Tolerances:

- ``pair_sites`` and ``ring_pairs``: bit-equal, and ``pair_sites``
  leaves the generator in the same state (the same numpy code);
- ``contrastive_kl``, its gradient, ``dcml_losses``,
  ``merge_by_validation``: rtol 1e-5 (fp32 sums in another order);
- ``make_site_dcml`` and a round's ``pre_exchange``: losses rtol 1e-5,
  the merged parameters rtol 1e-5 plus an atol of ``2e-4 * dcml_lr`` (the
  SGD step ``dcml_lr * grad`` carries the gradient's fp32 round-off, up to
  1.5e-4 absolute on these models, onto parameters near zero);
- jobs (8^3, 4 filters, 2 levels, 5 sites, 3 rounds): per-site losses
  rtol 1e-4, atol 1e-5, the history's ``active``, ``partner`` and
  ``is_receiver`` equal, ``comm`` None in both.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import FederatedJob as JJob  # noqa: E402
from repro.api import TaskConfig as JTask  # noqa: E402
from repro.core import dcml as jdcml  # noqa: E402
from repro.core import gossip as jgossip  # noqa: E402
from repro.core.round_engine import _pairings as j_pairings  # noqa: E402
from repro.core.strategies import gcml as jgcml  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.core import dcml as tdcml  # noqa: E402
from repro_torch.core import federation as tfed  # noqa: E402
from repro_torch.core import gossip as tgossip  # noqa: E402
from repro_torch.core.agg_engine import get_engine  # noqa: E402
from repro_torch.core.stacking import broadcast_to_sites  # noqa: E402
from repro_torch.core.strategies import gcml as tgcml  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

# PanSeg-like, tiny: one channel, two classes, 5 sites
PAN = dict(kind="seg", in_channels=1, num_classes=2, sites=5, batch=1, volume=(8, 8, 8),
           base_filters=4, num_levels=2)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def _param_tol(ctx):
    return dict(rtol=1e-5, atol=2e-4 * ctx.dcml_lr)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch thread for this module's tiny models: the suite runs in
    several worker processes on one host's cores, and PyTorch's default of
    a thread a core in every worker oversubscribes them many times over."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- pairing ------------------------------------------------------------------------


def _masks(n, seed):
    """Seeded [?, n] masks with every active count 0..n."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n + 1):
        for _ in range(3):
            m = np.zeros(n, bool)
            m[rng.permutation(n)[:k]] = True
            out.append(m)
    return out


@pytest.mark.parametrize("n", range(1, 9))
def test_pair_sites_bit_equal_reference(n):
    for seed in range(4):
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        for m in _masks(n, seed + 100):
            got, want = tgossip.pair_sites(m, tr), jgossip.pair_sites(m, jr)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w)
            assert not (got[1] & ~m).any()            # receivers are active
        assert tr.bit_generator.state == jr.bit_generator.state


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_ring_pairs_bit_equal_reference(n):
    for m in _masks(n, n):
        for r in range(4):
            for g, w in zip(tgossip.ring_pairs(m, r), jgossip.ring_pairs(m, r)):
                assert g.dtype == w.dtype and np.array_equal(g, w)


def test_round_pairings_equal_reference_and_traced_pairing_is_not_ported():
    """The round loop's pairings: ``make_round_inputs`` on one generator
    seeded by the job's seed, round by round, against the reference
    engine's precomputed ``_pairings``; a non-pairing strategy pairs no
    one."""
    masks = np.stack(_masks(5, 7))
    ctx = FederatedJob(task=TaskConfig(**PAN), strategy="gcml", device="cpu").context()
    rng = np.random.default_rng(3)
    rounds = [tfed.make_round_inputs(ctx, m, rng=rng) for m in masks]
    partner, is_recv = j_pairings(masks, 3)
    assert np.array_equal(np.stack([ri["partner"] for ri in rounds]), partner)
    assert np.array_equal(np.stack([ri["is_receiver"] for ri in rounds]), is_recv)
    fedavg = FederatedJob(task=TaskConfig(**PAN), device="cpu").context()
    ri = tfed.make_round_inputs(fedavg, masks[-1], rng=rng)
    assert np.array_equal(ri["partner"], np.arange(5)) and not ri["is_receiver"].any()
    # the traced pairing, once not ported, is now the reference's bit for bit
    # (tests/test_torch_device_data.py holds it over many keys)
    key = jax.random.PRNGKey(3)
    got = tgossip.pair_sites_traced(torch.as_tensor(np.asarray(key).astype(np.int64)),
                                    torch.as_tensor(masks[0]))
    for g, w in zip(got, jgossip.pair_sites_traced(key, jnp.asarray(masks[0]))):
        assert np.array_equal(g.numpy(), np.asarray(w))


# -- the contrastive KL and the DCML pieces ----------------------------------------------


@pytest.mark.parametrize("beta,v", [(1.0, 3), (0.3, 2)])
def test_contrastive_kl_and_gradient_match_reference(beta, v):
    rng = np.random.default_rng(v)
    s = rng.normal(size=(2, 4, 5, 3, v)).astype(np.float32)
    t = rng.normal(size=(2, 4, 5, 3, v)).astype(np.float32)
    labels = rng.integers(0, v, (2, 4, 5, 3)).astype(np.int32)
    want, (gs, gt) = jax.value_and_grad(jdcml.contrastive_kl, argnums=(0, 1))(
        jnp.asarray(s), jnp.asarray(t), jnp.asarray(labels), beta)
    ts = torch.from_numpy(s).requires_grad_()
    tt = torch.from_numpy(t).requires_grad_()
    got = tdcml.contrastive_kl(ts, tt, torch.from_numpy(labels), beta)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    g_s, g_t = torch.autograd.grad(got, [ts, tt], allow_unused=True)
    np.testing.assert_allclose(g_s.numpy(), np.asarray(gs), rtol=1e-5, atol=1e-9)
    # the teacher is stopped: no gradient reaches it
    assert g_t is None and not np.asarray(gt).any()


def _ctx_pair(**job_kw):
    jjob = JJob(task=JTask(**PAN), strategy="gcml", **job_kw)
    tjob = FederatedJob(task=TaskConfig(**PAN), strategy="gcml", device="cpu", **job_kw)
    jb, tb = jjob.task.build(), tjob.task.build()
    return jjob.context(jb), tjob.context(tb), jb


def _inits(jb, seeds):
    return [jax.tree.map(np.asarray, jb.init_fn(jax.random.PRNGKey(k))) for k in seeds]


def _row(tree):
    flat, layout = get_engine().flatten(broadcast_to_sites(convert.from_reference(tree), 1))
    return flat[0], layout


def _port_row(tree):
    return _row(tree)[0].numpy()


def _site_batches(jb, rnd):
    b = jb.stacked(rnd, 1)
    return {k: v[:, 0] for k, v in b.items()}       # [S, B, ...]


def test_dcml_losses_match_reference():
    jctx, tctx, jb = _ctx_pair(rounds=1)
    a, b = _inits(jb, (0, 1))
    batch = {k: v[0] for k, v in _site_batches(jb, 0).items()}
    want = jax.jit(lambda pa, pb, bb: jdcml.dcml_losses(
        jctx.logits_fn, pa, pb, bb, jctx.scalar_loss_fn, 0.5, 1.0))(a, b, batch)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pa, pb = convert.from_reference(a), convert.from_reference(b)
    # one forward a model (the port's) against the reference's logits and
    # base losses, each from a forward of its own
    got = tdcml.dcml_losses(tctx.forward_fn, pa, pb, tbatch, 0.5, 1.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), **LOSS_TOL)
    # the context's logits and labels are the forward's
    f, logits, labels = tctx.forward_fn(pa, tbatch)
    tl, tlab = tctx.logits_fn(pa, tbatch)
    assert torch.equal(tl, logits) and torch.equal(tlab, labels)
    assert f.item() == tctx.scalar_loss_fn(pa, tbatch).item()


def test_merge_by_validation_inverts_the_weights():
    rng = np.random.default_rng(0)
    x = {"a": rng.normal(size=(7, 3)).astype(np.float32), "b": [rng.normal(size=5)
                                                                .astype(np.float32)]}
    y = jax.tree.map(lambda t: t + 1.0, x)
    v_r, v_s = np.float32(0.3), np.float32(1.7)     # the receiver validates better
    want = jdcml.merge_by_validation(jax.tree.map(jnp.asarray, x), jax.tree.map(jnp.asarray, y),
                                     jnp.float32(v_r), jnp.float32(v_s))
    tx = jax.tree.map(torch.from_numpy, x)
    ty = jax.tree.map(torch.from_numpy, y)
    got = tdcml.merge_by_validation(tx, ty, torch.tensor(v_r), torch.tensor(v_s))
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    # the weight on the receiver is the sender's share: 1.7 / 2.0, not 0.3 / 2.0
    frac = (tree_leaves(got)[0] - tx["a"]) / (ty["a"] - tx["a"])
    np.testing.assert_allclose(frac.numpy(), 0.15, rtol=1e-5)
    plain = tdcml.merge_by_validation(tx, ty, torch.tensor(v_s), torch.tensor(v_r))
    assert not np.allclose(tree_leaves(plain)[0].numpy(), np.asarray(jax.tree.leaves(want)[0]),
                           rtol=1e-2)


@pytest.mark.parametrize("agg", ["fedavg", "normclip:0.05"])
def test_make_site_dcml_matches_reference(agg):
    jctx, tctx, jb = _ctx_pair(rounds=1, aggregator=agg, dcml_lr=0.05)
    a, b = _inits(jb, (0, 1))
    if agg != "fedavg":       # the clip binds: the models lie further apart
        d = sum(float(np.sum((x - y) ** 2)) for x, y in zip(jax.tree.leaves(a),
                                                             jax.tree.leaves(b)))
        assert np.sqrt(d) > 10 * 0.05
    sb = _site_batches(jb, 0)
    vb = _site_batches(jb, 1)
    batch = {k: v[2] for k, v in sb.items()}
    val = {k: v[2] for k, v in vb.items()}
    merged, outs = jax.jit(jgcml.make_site_dcml(jctx))(a, b, batch, val)
    ra, layout = _row(a)
    rb, _ = _row(b)
    got, touts = tgcml.make_site_dcml(tctx)(
        ra, rb, {k: torch.from_numpy(v) for k, v in batch.items()},
        {k: torch.from_numpy(v) for k, v in val.items()}, layout)
    for g, w in zip(touts, outs):
        np.testing.assert_allclose(g.item(), float(w), **LOSS_TOL)
    np.testing.assert_allclose(got.numpy(), _port_row(jax.tree.map(np.asarray, merged)),
                               **_param_tol(tctx))


@pytest.fixture(scope="module")
def ring():
    """Both contexts and the reference's exchange, jitted once for the
    module's calls."""
    jctx, tctx, jb = _ctx_pair(rounds=1)
    return jctx, tctx, jb, jax.jit(lambda st, r: jgcml.GCML().pre_exchange(st, r, jctx))


@pytest.mark.parametrize("active", [[1, 1, 1, 1, 1], [1, 0, 1, 1, 1]], ids=["all", "one-off"])
def test_ring_pre_exchange_reads_the_rounds_entry_snapshot(ring, active):
    """Under ``ring_pairs`` every active site both sends and receives, so a
    port that wrote a merge before a later receiver read its sender would
    differ from the reference's vmapped exchange."""
    jctx, tctx, jb, exchange = ring
    s = PAN["sites"]
    inits = _inits(jb, range(s))
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *inits)
    active = np.asarray(active, bool)
    partner, is_recv, _ = jgossip.ring_pairs(active, 1)
    assert is_recv[active].all() and (partner[active] != np.flatnonzero(active)).all()
    sb, vb = _site_batches(jb, 0), _site_batches(jb, 1)
    ri = {"active": active, "partner": partner, "is_receiver": is_recv,
          "dcml_batch": sb, "val_batch": vb}
    want = exchange({"params": stacked}, ri)
    flat = torch.stack([_row(t)[0] for t in inits])
    layout = _row(inits[0])[1]
    tri = {**ri, "dcml_batch": {k: torch.from_numpy(v) for k, v in sb.items()},
           "val_batch": {k: torch.from_numpy(v) for k, v in vb.items()}}
    got = tgcml.GCML().pre_exchange({"params": flat, "layout": layout}, tri, tctx)
    wp = jax.tree.map(np.asarray, want["params"])
    for i in range(s):
        np.testing.assert_allclose(got["params"][i].numpy(),
                                   _port_row(jax.tree.map(lambda x: x[i], wp)),
                                   **_param_tol(tctx))
        if not active[i]:
            assert torch.equal(got["params"][i], _row(inits[i])[0])
    for name in ("dcml_loss_r", "dcml_loss_s", "dcml_val_r", "dcml_val_s"):
        m = got["metrics"][name].numpy()
        np.testing.assert_allclose(m[active], np.asarray(want["metrics"][name])[active],
                                   **LOSS_TOL)
        assert np.isnan(m[~active]).all()


# -- job trajectories ---------------------------------------------------------------


@pytest.mark.parametrize("job_kw", [
    dict(),
    dict(max_dropout=1),
    dict(max_dropout=1, dropout_scenario="shutdown", seed=3),
    dict(max_dropout=1, aggregator="normclip:0.01"),
], ids=["no-churn", "disconnect", "shutdown", "normclip"])
def test_gcml_trajectory_matches_jax_job(job_kw):
    job_kw = {**dict(strategy="gcml", rounds=3, seed=0), **job_kw}
    jjob = JJob(task=JTask(**PAN), **job_kw)
    jres = jjob.run()
    init = jax.tree.map(np.asarray, jjob.task.build().init_fn(jax.random.PRNGKey(jjob.seed)))
    tjob = FederatedJob(task=TaskConfig(**PAN), device="cpu", **job_kw)
    tres = tjob.run(init_params=convert.from_reference(init))
    assert tres.comm is None and jres.comm is None
    if job_kw.get("max_dropout"):
        assert min(h["active"] for h in jres.history) < PAN["sites"]
    for th, jh in zip(tres.history, jres.history):
        for key in ("active", "partner", "is_receiver"):
            assert th[key] == jh[key], key
        np.testing.assert_allclose(th["per_site_loss"], jh["per_site_loss"],
                                   rtol=1e-4, atol=1e-5)
        recv = np.asarray(th["is_receiver"])
        assert recv.any()
        assert np.isfinite(np.asarray(th["dcml_loss_r"])[recv]).all()
        assert np.isnan(np.asarray(th["dcml_loss_r"])[~recv]).all()
    want = convert.from_reference(jax.tree.map(np.asarray, jres.global_params))
    for a, b in zip(tree_leaves(tres.global_params), tree_leaves(want)):
        assert float((a - b).abs().max()) <= tjob.lr * tjob.rounds
