"""Federated training of the reference's two recurrent token families
against the JAX reference.

One stacked FedAvg token job of each (reduced rwkv6-7b, reduced
Jamba-1.5-Large: Mamba + dense, attention + MoE), 3 sites, 3 rounds, seq
16, in both packages from the JAX job's initial parameters
(``convert.from_reference``): each round's per-site losses, ``comm``
equal, and the final globals within the reference's thread-vs-stacked
bound (rtol 2e-3, atol 2e-4; ``tests/test_compression.py``).  The port's
scans train through their written-out backward (``rwkv6_scan_bwd_ref``,
``mamba_scan_bwd_ref``, the CPU path of the backward kernels), the
reference's through XLA's differentiation of its jnp scans.

Loss tolerances: rtol 1e-4 for both, the other token jobs' gate
(``_torch_jax_helpers.hold_job_to_jax``).  rwkv6-7b's reduced config at a
random init is ill-conditioned in fp32 (its per-head group norm of the
scan's output: one step's gradient of the port in fp32 lies 2.6e-4 of
the largest value from the port's in float64, so
``test_torch_tokens.py`` gates a single gradient at 1e-3), but a loss is
a mean over every token and site and does not show it: on an 8-core
CPU the losses lay 2.1e-6 (rwkv6-7b) and 3.2e-7 (Jamba) apart, relative,
and the globals at most 1.4e-4 past rtol 2e-3, within its atol 2e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_jax_helpers import assert_globals_close, reference_init  # noqa: E402

from repro.api import FederatedJob as JJob  # noqa: E402
from repro.api import TaskConfig as JTask  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402

ARCHS = ("rwkv6-7b", "jamba-1.5-large-398b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_token_jobs_match_the_reference(arch):
    task = dict(kind="tokens", arch=arch, sites=3, batch=2, seq=16)
    jjob = JJob(task=JTask(**task), rounds=3, seed=0)
    jres = jjob.run()
    tres = FederatedJob(task=TaskConfig(**task), rounds=3, seed=0, device="cpu").run(
        init_params=reference_init(jjob))
    assert [h["active"] for h in tres.history] == [h["active"] for h in jres.history]
    for th, jh in zip(tres.history, jres.history):
        np.testing.assert_allclose(th["per_site_loss"], jh["per_site_loss"],
                                   rtol=1e-4, atol=1e-6)
    assert tres.comm == jres.comm
    assert_globals_close(convert.to_reference(tres.global_params),
                         jax.tree.map(np.asarray, jres.global_params), 0.0)
