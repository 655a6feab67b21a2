"""DP-SGD and the ``noise`` attack, the port against the reference.

- One JAX job (FedAvg, per-site DP, sigma 0.8, C 0.5, 3 sites, batch 1,
  3 rounds, churn, its loop engine) against the port's (``"auto"``) from
  the same initial parameters
  (``hold_job_to_jax``): per-site losses rtol 1e-4, atol 1e-5, ``comm``
  equal, the global within ``lr * rounds`` with its median element within
  1e-6; ``privacy`` equal.  The noise is the reference's (the port's
  threefry stream, each leaf drawn at its reference shape), within 4 ulp
  of each normal (``tests/test_torch_prng.py``).
- ``privacy_report`` equals the reference's dict, the same function of
  the job's fields (no job runs): per-site, per-example, clip-only
  (epsilon inf), ``poisson:q`` (the subsampled accountant), ``uniform:K``
  (the dense one), ``secure_agg`` beside DP, a resumed run's full rounds.
- Port only: the ``"auto"`` and ``"loop"`` engines compute the same rounds
  (bit for bit); the thread transport draws its stacked twin's noise by
  global site id (losses rtol 1e-4, the global by ``assert_globals_close``;
  the socket fold differs in order); per-example DP runs and differs from
  per-site; clip-only differs from noisy; DP under ``secure_agg`` on the
  thread transport (masked fixed-point uploads) ends within the fixed
  point's rounding of the plain thread job.
- The noise attack's perturbed rows (``AdversaryPlan.perturb_rows``)
  against the reference's ``perturb_stacked`` on the same rows of SA-Net's
  leaf kinds:
  within 4 ulp of each normal; a thread job under ``noise:0.5:1`` against
  its stacked twin.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from _torch_jax_helpers import assert_globals_close, hold_job_to_jax  # noqa: E402

from repro.api import FederatedJob as JJob  # noqa: E402
from repro.api import TaskConfig as JTask  # noqa: E402
from repro.core import adversary as jadv  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.core import adversary as tadv  # noqa: E402
from repro_torch.core.agg_engine import get_engine  # noqa: E402
from repro_torch.core.stacking import broadcast_to_sites  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TINY = dict(kind="dose", sites=3, batch=2, volume=(8, 8, 8), base_filters=4)
DP = dict(dp_clip=0.5, dp_noise_multiplier=0.8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _job(**kw):
    base = dict(task=TaskConfig(**TINY), rounds=3, device="cpu")
    base.update(kw)
    return FederatedJob(**base)


def _flat(tree):
    return torch.cat([t.reshape(-1) for t in tree_leaves(tree)])


def test_dp_job_matches_the_jax_job():
    # the reference's loop engine: its DP round compiles in less time than
    # the scan's, and the two compute the same rounds
    jjob = JJob(task=JTask(**{**TINY, "batch": 1}), rounds=3, max_dropout=1,
                round_engine="loop", **DP)
    jres = jjob.run()
    tres = hold_job_to_jax(_job(task=TaskConfig(**{**TINY, "batch": 1}), max_dropout=1,
                                round_engine="auto", **DP), jjob, jres)
    assert tres.privacy == jres.privacy
    assert tres.privacy["mechanism"] == "dp-sgd" and tres.privacy["steps"] == 3


@pytest.mark.parametrize("kw", [
    dict(DP), dict(DP, dp_mode="per-example", local_steps=2), dict(dp_clip=0.5),
    dict(DP, sample="poisson:0.5", dropout_scenario="shutdown"),
    dict(DP, sample="uniform:2", dropout_scenario="shutdown"),
    dict(DP, secure_agg=True, transport="thread"), dict(DP, dp_delta=1e-6, seed=3),
    dict(secure_agg=True, transport="thread"), dict(),
], ids=["per-site", "per-example", "clip-only", "poisson", "uniform", "secure_agg", "delta",
        "secure_agg-only", "off"])
def test_privacy_report_equals_the_reference(kw):
    tjob, jjob = _job(**kw), JJob(task=JTask(**TINY), rounds=3, **kw)
    assert tjob.privacy_report() == jjob.privacy_report()
    assert tjob.privacy_report(7) == jjob.privacy_report(7)
    assert tjob.dp_tag() == jjob.dp_tag()


def test_scan_and_loop_draw_the_same_noise():
    scan, loop = _job(**DP, round_engine="scan").run(), _job(**DP, round_engine="loop").run()
    assert scan.losses == loop.losses
    assert torch.equal(_flat(scan.global_params), _flat(loop.global_params))
    assert scan.losses != _job().run().losses


def test_thread_transport_draws_the_stacked_noise():
    stacked = _job(**DP).run()
    threaded = _job(**DP, transport="thread").run()
    np.testing.assert_allclose(threaded.losses, stacked.losses, rtol=1e-4)
    assert_globals_close(convert.to_reference(threaded.global_params),
                         convert.to_reference(stacked.global_params), 1e-3 * 3)


def test_per_example_and_clip_only_are_other_mechanisms():
    noisy = _job(**DP).run()
    per_ex = _job(**DP, dp_mode="per-example").run()
    clip = _job(dp_clip=0.5).run()
    assert np.isfinite(per_ex.losses).all() and per_ex.privacy["mode"] == "per-example"
    assert not np.allclose(per_ex.losses, noisy.losses, rtol=1e-6)
    assert clip.privacy["epsilon"] == float("inf")
    assert not np.allclose(clip.losses, noisy.losses, rtol=1e-6)


def test_dp_under_secure_agg_on_the_thread_transport():
    plain = _job(**DP, transport="thread").run()
    masked = _job(**DP, transport="thread", secure_agg=True).run()
    assert masked.privacy["secure_agg"] is True and masked.privacy["mechanism"] == "dp-sgd"
    np.testing.assert_allclose(masked.losses, plain.losses, rtol=1e-4)
    assert float((_flat(masked.global_params) - _flat(plain.global_params)).abs().max()) \
        <= 1e-3 * 3


@pytest.mark.parametrize("rnd", [0, 4])
def test_noise_rows_match_the_reference(rnd):
    """Rows of 5 sites (a conv leaf, its bias, an SE matrix: SA-Net's leaf
    kinds), the malicious active ones perturbed by ``noise:0.5:2`` in round
    ``rnd``, against ``perturb_stacked`` on the same rows in the
    reference's layout."""
    rng = np.random.default_rng(rnd)
    ref_tree = {"conv": {"w": rng.normal(size=(3, 3, 3, 4, 6)).astype(np.float32),
                         "b": rng.normal(size=6).astype(np.float32)},
                "se": {"w1": rng.normal(size=(6, 3)).astype(np.float32)}}
    flat, layout = get_engine().flatten(broadcast_to_sites(convert.from_reference(ref_tree), 5))
    flat = flat + torch.from_numpy(rng.normal(size=tuple(flat.shape)).astype(np.float32))
    jplan, tplan = jadv.parse_adversary("noise:0.5:2", seed=1), tadv.parse_adversary(
        "noise:0.5:2", seed=1)
    mask = jplan.malicious_mask(5) & np.array([1, 0, 1, 1, 1], bool)
    rows = [convert.to_reference(get_engine().unflatten(flat[i], layout)) for i in range(5)]
    stacked = jax.tree.map(lambda *x: jnp.asarray(np.stack(x)), *rows)
    want = jplan.perturb_stacked(stacked, jnp.asarray(mask), rnd)
    got = flat.clone()
    tplan.perturb_rows(got, mask, rnd, layout)
    assert mask.sum() >= 1
    for i in range(5):
        w = _flat(convert.from_reference(jax.tree.map(lambda x, i=i: np.asarray(x[i]), want)))
        x = flat[i]
        if not mask[i]:
            assert torch.equal(got[i], x)
            continue
        # 4 ulp of each normal, scaled by s, plus the sum's rounding
        bound = 4 * 2.0 ** -23 * (0.5 * (w - x).abs() + x.abs()) + 1e-12
        assert bool(((got[i] - w).abs() <= bound).all())
        assert float((got[i] - x).abs().mean()) > 0.3       # s * E|N(0,1)| = 0.4


def test_noise_attack_on_the_thread_transport_matches_stacked():
    kw = dict(adversary="noise:0.5:1", task=TaskConfig(**{**TINY, "sites": 4}))
    stacked = _job(**kw).run()
    threaded = _job(**kw, transport="thread").run()
    np.testing.assert_allclose(threaded.losses, stacked.losses, rtol=1e-4)
    assert_globals_close(convert.to_reference(threaded.global_params),
                         convert.to_reference(stacked.global_params), 1e-3 * 3)
