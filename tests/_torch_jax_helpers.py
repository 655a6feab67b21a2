"""Helpers shared by the port's socket-job tests, which run the same job
in both packages (``test_torch_socket.py``, ``test_torch_p2p.py``,
``test_torch_secure_agg.py``)."""
import jax
import numpy as np

from repro_torch import convert


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
