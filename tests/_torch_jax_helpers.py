"""Helpers shared by the port's job tests, which run the same job in both
packages (``test_torch_socket.py``, ``test_torch_p2p.py``,
``test_torch_secure_agg.py`` and the codec files)."""
import jax
import numpy as np
import torch

from repro_torch import convert
from repro_torch.tree import tree_leaves


def tree_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def assert_globals_close(got, want, noise_bound):
    """rtol 2e-3, atol 2e-4 everywhere but the GroupNorm-fed conv biases,
    which are held to ``noise_bound`` (see ``test_torch_socket.py``'s
    module docstring)."""
    for (path, a), (_, b) in zip(tree_paths(got), tree_paths(want)):
        a, b = np.asarray(a), np.asarray(b)
        if path.endswith(("/conv1/b", "/conv2/b")):
            assert float(np.abs(a - b).max()) <= noise_bound, path
        else:
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4, err_msg=path)


def reference_init(jjob):
    """The JAX job's initial parameters, converted to the port's layout."""
    return convert.from_reference(jax.tree.map(
        np.asarray, jjob.task.build().init_fn(jax.random.PRNGKey(jjob.seed))))


def hold_job_to_jax(job, jjob, jres):
    """Run the port's ``job`` from the JAX job's initial parameters and hold
    it to the JAX result ``jres``: the same active counts, per-site losses
    rtol 1e-4, atol 1e-5, ``comm`` equal, the global within ``lr * rounds``
    with the median element within 1e-6.  Returns the port's result."""
    tres = job.run(init_params=reference_init(jjob))
    assert [h["active"] for h in tres.history] == [h["active"] for h in jres.history]
    for th, jh in zip(tres.history, jres.history):
        np.testing.assert_allclose(th["per_site_loss"], jh["per_site_loss"],
                                   rtol=1e-4, atol=1e-5)
    assert tres.comm == jres.comm
    want = convert.from_reference(jax.tree.map(np.asarray, jres.global_params))
    diff = torch.cat([(a - b).abs().reshape(-1) for a, b in
                      zip(tree_leaves(tres.global_params), tree_leaves(want))])
    assert float(diff.max()) <= jjob.lr * jjob.rounds
    assert float(diff.median()) <= 1e-6
    return tres
