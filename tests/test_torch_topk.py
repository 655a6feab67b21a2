"""The port's top-k codecs (``topk``/``topk-sparse`` and ``topk-fixed``)
against the JAX reference.

Top-k keeps each leaf's ``max(1, ceil(fraction * n))`` entries of largest
magnitude, exact.  The reference has two engines: its numpy wire codec
(``np.argpartition``) and its stacked engine's ``lax.top_k`` twin
(``_topk_tree``).  Where magnitudes tie at the k-th place they keep
different entries (argpartition's choice is arbitrary); the port keeps
one rule on both paths, ``lax.top_k``'s: the lower index in the
reference's element order wins.  So:

- frames (``repro.comms.codec.encode_message`` against the port's), the
  compressors' payloads, residuals and decodes are bit-equal to the
  reference's wire codec on tie-free inputs;
- the port's on-device twin is bit-equal to ``_topk_tree`` with and
  without ties;
- on a leaf with ties, the port's wire codec and its twin keep the same
  entries, ``lax.top_k``'s;
- the byte counts equal ``_topk_nbytes``.

The stacked ``topk-sparse`` job (3 sites, 3 rounds, Algorithm-2 churn),
which takes the host loop in both packages, is held to the JAX job by
``hold_job_to_jax`` (losses rtol 1e-4, atol 1e-5; ``comm`` equal; the
global within ``lr * rounds``, median within 1e-6).  The ``topk-fixed``
job both ways is in ``test_torch_codec_sockets.py``: one JAX job a file,
as the reference's first job in a process costs about 30 s of its eager
initialization.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_jax_helpers import hold_job_to_jax  # noqa: E402

from repro.api import FederatedJob as JJob  # noqa: E402
from repro.api import TaskConfig as JTask  # noqa: E402
from repro.comms import codec as jcodec  # noqa: E402
from repro.comms import compression as jcomp  # noqa: E402
from repro.core import round_engine as jre  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.comms import codec as tcodec  # noqa: E402
from repro_torch.comms import compression as tcomp  # noqa: E402
from repro_torch.core import round_engine as tre  # noqa: E402
from repro_torch.core.agg_engine import ravel, tree_layout, unravel  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TINY = dict(kind="dose", sites=3, batch=1, volume=(8, 8, 8), base_filters=4)
CPU = torch.device("cpu")
JAX_TOPK = jax.jit(jre._topk_tree, static_argnums=1)     # compiled once a fraction


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch thread for this module's tiny models (the suite runs in
    several worker processes on one host's cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _model(seed=0, ties=False):
    """The tiny model's parameters plus noise, (reference tree, port tree);
    with ``ties`` every value on a grid of 1/64, so magnitudes tie."""
    port = TaskConfig(**TINY).build().init_fn(0)
    flat = ravel(port) + torch.from_numpy(np.random.default_rng(seed).normal(
        size=ravel(port).numel()).astype(np.float32) * np.float32(0.01))
    if ties:
        flat = torch.round(flat * 64) / 64
    port = unravel(flat, tree_layout(port))
    return convert.to_reference(port), port


def _tie_free(x):
    a = np.abs(np.asarray(x)).reshape(-1)
    return np.unique(a).size == a.size


@pytest.mark.parametrize("case", ["leaf-1000", "leaf-3", "leaf-1", "fixed-0.3", "model"])
def test_topk_frames_bit_equal_the_reference_on_tie_free_inputs(case):
    rng = np.random.default_rng(len(case))
    if case == "model":
        jtree, ttree = _model()
        assert all(_tie_free(x) for x in jax.tree.leaves(jtree))
        plan = tcomp.WirePlan.of(tree_layout(ttree), 1024, 1, CPU, port=True)
        tenc, deq = plan.encode_topk(ravel(ttree), 0.1)
        jenc = jcomp.TopKCodec().encode_tree(jtree)
        want = ravel(convert.from_reference(jcomp.decode_tree(jenc)))
        assert torch.equal(deq(), want)
    else:
        n = {"leaf-1000": 1000, "leaf-3": 3, "leaf-1": 1, "fixed-0.3": 777}[case]
        x = rng.normal(size=n).astype(np.float32)
        jc, tc = ((jcomp.TopKFixedCodec(fraction=0.3), tcomp.TopKFixedCodec(fraction=0.3))
                  if case == "fixed-0.3" else (jcomp.TopKCodec(), tcomp.TopKCodec()))
        jenc, tenc = jc.encode_array(x), tc.encode_array(torch.from_numpy(x))
        assert tenc.codec == jenc.codec == "topk"
        assert tenc.data["idx"].dtype == np.uint32 and tenc.data["idx"].size == \
            max(1, int(np.ceil(tc.fraction * n)))
    assert tcodec.encode_message("upload", {"r": 1}, tenc) == \
        jcodec.encode_message("upload", {"r": 1}, jenc)
    got = tcomp.decode_flat(tenc, device=CPU)[0]
    want = np.concatenate([np.asarray(a).reshape(-1)
                           for a in jax.tree.leaves(jcomp.decode_tree(jenc))])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ties", [False, True], ids=["tie-free", "ties"])
def test_topk_twin_bit_equal_the_reference_twin(ties, fraction=0.1):
    """The port's on-device ``topk-fixed`` twin against ``_topk_tree`` on two
    site rows, both in the reference's element order."""
    (j0, t0), (j1, t1) = _model(1, ties), _model(2, ties)
    if ties:
        assert not all(_tie_free(x) for x in jax.tree.leaves(j0))
    stacked = jax.tree.map(lambda a, b: np.stack([a, b]), j0, j1)
    want = JAX_TOPK(stacked, fraction)
    twin = tre.DeviceCodec(tcomp.TopKFixedCodec(fraction=fraction), tree_layout(t0), CPU)
    got = twin.deq(torch.stack([ravel(t0), ravel(t1)]))
    for i in range(2):
        assert torch.equal(got[i], ravel(convert.from_reference(
            jax.tree.map(lambda x: np.asarray(x[i]), want))))


def test_topk_ties_take_one_rule_on_both_paths():
    """A leaf whose magnitudes tie at the k-th place: the wire codec and the
    on-device twin keep the same entries, ``lax.top_k``'s (the lower index
    wins), and both keep exactly k."""
    x = np.random.default_rng(3).integers(-6, 7, size=1000).astype(np.float32) / 4
    k = 100
    lax_idx = np.sort(np.asarray(jax.jit(lambda v: jax.lax.top_k(jnp.abs(v), k)[1])(x)))
    enc = tcomp.TopKCodec().encode_array(torch.from_numpy(x))
    kth = np.sort(np.abs(x))[-k]
    tied = np.flatnonzero(np.abs(x) == kth)
    assert tied.size > np.sum(np.abs(x[enc.data["idx"]]) == kth) > 0   # a real tie
    np.testing.assert_array_equal(enc.data["idx"], lax_idx)
    kept_tied = np.intersect1d(enc.data["idx"], tied)
    np.testing.assert_array_equal(kept_tied, tied[:kept_tied.size])   # lowest indices
    layout = tree_layout({"w": torch.zeros(1000)})
    twin = tre.DeviceCodec(tcomp.TopKFixedCodec(), layout, CPU)
    got = twin.deq(torch.from_numpy(x)[None])[0]
    np.testing.assert_array_equal(np.flatnonzero(got.numpy() != 0),
                                  lax_idx[x[lax_idx] != 0])
    np.testing.assert_array_equal(got.numpy()[lax_idx], x[lax_idx])


@pytest.mark.parametrize("fraction", [0.01, 0.1, 0.25, 1.0])
def test_topk_nbytes_equal_the_reference(fraction):
    jtree, ttree = _model()
    stacked = jax.tree.map(lambda a: a[None], jtree)
    shapes = tree_layout(ttree).shapes
    assert tre.topk_nbytes(shapes, fraction) == jre._topk_nbytes(stacked, fraction)
    twin = tre.DeviceCodec(tcomp.TopKFixedCodec(fraction=fraction), tree_layout(ttree), CPU)
    assert twin.nbytes == jre._topk_nbytes(stacked, fraction)


def test_topk_compressors_match_the_reference_compressors():
    """The bootstrap upload goes dense (meta ``none``, no residual), then a
    delta upload with error feedback and a delta download: frames,
    decodes, the residual and the held copy bit-equal to the reference's."""
    (j0, t0), (j1, t1), (j2, t2) = _model(4), _model(5), _model(6)
    jup, tup = jcomp.UploadCompressor(jcomp.TopKCodec()), tcomp.UploadCompressor(
        tcomp.TopKCodec())
    jenc, jmeta = jup.encode(j0)
    tenc, tmeta = tup.encode(t0)
    assert tmeta == jmeta == {"compression": "none", "delta": False}
    assert tup.residual is None and jup.residual is None
    assert tcodec.encode_message("u", tmeta, tenc) == jcodec.encode_message("u", jmeta, jenc)
    for jp, tp in [(j1, t1), (j2, t2)]:
        jenc, jmeta = jup.encode(jp, j0)
        tenc, tmeta = tup.encode(tp, t0)
        assert tmeta == jmeta == {"compression": "topk", "delta": True}
        assert tcodec.encode_message("u", tmeta, tenc) == jcodec.encode_message("u", jmeta, jenc)
        got = tcomp.decode_upload(tenc, tmeta, jax.tree.map(torch.from_numpy, j0),
                                  plan=tup.plan(tp))
        for a, b in zip(tree_leaves(got), jax.tree.leaves(jcomp.decode_upload(jenc, jmeta, j0))):
            np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(
        tup.plan(t0).to_wire(tup.residual).numpy(),
        np.concatenate([a.reshape(-1) for a in jax.tree.leaves(jup.residual)]))
    assert (tup.encoded_bytes, tup.raw_bytes) == (jup.encoded_bytes, jup.raw_bytes)
    jdown = jcomp.DownlinkCompressor(jcomp.TopKFixedCodec())
    tdown = tcomp.DownlinkCompressor(tcomp.TopKFixedCodec())
    for jg, r in [(j0, 1), (j1, 2), (j2, 3)]:
        jenc, jmeta = jdown.encode(0, jg, r, acked_round=r - 1 if r > 1 else None)
        tenc, tmeta = tdown.encode(0, jax.tree.map(torch.from_numpy, jg), r,
                                   acked_round=r - 1 if r > 1 else None)
        assert tmeta == jmeta
        assert tcodec.encode_message("d", tmeta, tenc) == jcodec.encode_message("d", jmeta, jenc)
    for a, b in zip(tree_leaves(tdown.held_state(0)[0]), jax.tree.leaves(jdown.held_state(0)[0])):
        np.testing.assert_array_equal(a.numpy(), b)


def test_topk_sparse_uploads_through_the_host_loop_match_jax_job():
    """``topk-sparse`` uploads: the port's host loop (per-site
    ``UploadCompressor``s, a device decode of each payload, the
    ``StreamingAccumulator`` fold) against the reference's; round 0's
    uploads go dense."""
    kw = dict(compression="topk-sparse", max_dropout=1)
    jjob = JJob(task=JTask(**TINY), rounds=3, **kw)
    tres = hold_job_to_jax(FederatedJob(task=TaskConfig(**TINY), rounds=3, device="cpu", **kw),
                           jjob, jjob.run())
    dense = 4 * ravel(tres.global_params).numel()
    assert tres.history[0]["upload_bytes"] == tres.history[0]["active"] * dense
    assert tres.history[1]["upload_bytes"] < dense
    assert tres.comm["compression"] == "topk"
