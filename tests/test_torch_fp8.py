"""The port's fp8 codec against the JAX reference.

The reference has two fp8 engines and no fp8 kernel: its numpy wire codec
(``Fp8Codec``) and its jnp twin (``quantize_dequantize_fp8_ref``, which
its stacked engine runs as ``_qdq_tree``).  Both divide in IEEE fp32 and
cast to float8_e4m3fn with round-to-nearest-even, as the port's plain
PyTorch does, so every gate on the codec here is bit-equality: the
frames (``repro.comms.codec.encode_message`` against the port's), the
scales, the e4m3 bits and the dequantized values, for every chunk-width
group of the tiny model (8^3, 4 filters), a leaf shorter than a chunk,
an all-zero chunk (the ``MIN_SCALE`` floor) and a chunk whose absmax
sits at e4m3's subnormal edge.  The port reads fp8 frames without
``ml_dtypes``, which the card's machine does not have.

The stacked fp8 job (3 sites, 3 rounds) runs in both packages from the
same initial parameters, held by ``hold_job_to_jax``: per-site losses
rtol 1e-4, atol 1e-5 (fp32 round-off through a few AdamW steps),
``comm`` equal, the global within ``lr * rounds`` everywhere (AdamW's step
is about ``lr * sign(g)`` and flips where float noise flips the sign of a
near-zero gradient) with the median element within 1e-6.  Its buffered
and pods twins are in ``test_torch_codec_engine.py`` and
``test_torch_codec_pods.py``, one JAX job a file: the reference's first
job in a process costs about 30 s of its eager initialization.
"""
import sys

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
from repro.kernels.quantize import quantize_dequantize_fp8_ref as jax_qdq_fp8  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.comms import codec as tcodec  # noqa: E402
from repro_torch.comms import compression as tcomp  # noqa: E402
from repro_torch.core import round_engine as tre  # noqa: E402
from repro_torch.core.agg_engine import ravel, tree_layout, unravel  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TINY = dict(kind="dose", sites=3, batch=1, volume=(8, 8, 8), base_filters=4)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch thread for this module's tiny models (the suite runs in
    several worker processes on one host's cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _model(seed=0):
    """The tiny model's parameters plus noise: (reference tree, port tree)."""
    port = TaskConfig(**TINY).build().init_fn(0)
    rng = np.random.default_rng(seed)
    flat = ravel(port) + torch.from_numpy(
        rng.normal(size=ravel(port).numel()).astype(np.float32) * np.float32(0.01))
    port = unravel(flat, tree_layout(port))
    return convert.to_reference(port), port


def _edge_cases():
    rng = np.random.default_rng(7)
    short = (rng.normal(size=37) * 0.3).astype(np.float32)
    zero = (rng.normal(size=2500) * 0.05).astype(np.float32)
    zero[:1024] = 0.0                                   # chunk 0: absmax 0
    # absmax 2**-6 * 1e-12: the MIN_SCALE floor puts x / s at 2**-6, e4m3's
    # smallest normal, and the smaller entries on its subnormals
    edge = np.float32(2.0 ** -6 * 1e-12) * np.asarray(
        [1.0, -1.0, 0.5, 0.125, 2.0 ** -3, 3 * 2.0 ** -9, 2.0 ** -9, 2.0 ** -10, 0.0],
        np.float32)
    return {"short-leaf": short, "zero-chunk": zero, "subnormal-edge": edge.astype(np.float32)}


@pytest.mark.parametrize("case", ["model-groups", "short-leaf", "zero-chunk", "subnormal-edge"])
def test_fp8_codec_bit_equal_both_reference_engines(case):
    """Frames, scales, e4m3 bits and qdq bit-equal to ``Fp8Codec`` and to
    ``quantize_dequantize_fp8_ref``; the absmax element is 448's bits."""
    if case == "model-groups":
        jtree, ttree = _model()
        plan = tcomp.WirePlan.of(tree_layout(ttree), 1024, 1, CPU, port=True)
        tenc, deq = plan.encode_fp8(ravel(ttree))
        jenc = jcomp.Fp8Codec().encode_tree(jtree)
        # the stacked engine's twin, group by group (two site rows): the jnp
        # twin run eagerly on each chunk-width group's matrix (jitted, XLA
        # turns the division into a product by 1/448), the numpy codec on
        # each leaf
        u = torch.stack([ravel(ttree), -0.5 * ravel(ttree)])
        got = tre.qdq_fp8(u, tre.ChunkPlan.of(tree_layout(ttree), 1024, 1, CPU))
        assert len(plan.chunks.groups) > 2
        for m in plan.chunks.pack(u):
            np.testing.assert_array_equal(ref.quantize_dequantize_fp8_ref(m).numpy(),
                                          np.asarray(jax_qdq_fp8(jnp.asarray(m.numpy()))))
        for i, scale in enumerate((1.0, -0.5)):
            rows = jcomp.decode_tree(jcomp.Fp8Codec().encode_tree(
                jax.tree.map(lambda x: x * np.float32(scale), jtree)))
            assert torch.equal(got[i], ravel(convert.from_reference(rows)))
        assert torch.equal(deq(), got[0])
    else:
        x = _edge_cases()[case]
        jenc = jcomp.Fp8Codec().encode_array(x)
        tenc = tcomp.Fp8Codec().encode_array(torch.from_numpy(x))
        mat = tcomp._as_chunks(torch.from_numpy(x), 1024)
        np.testing.assert_array_equal(ref.quantize_dequantize_fp8_ref(mat).numpy(),
                                      np.asarray(jax_qdq_fp8(jnp.asarray(mat.numpy()))))
        assert np.array_equal(tenc.data["q"].view(np.uint8),
                              jenc.data["q"].view(np.uint8))
        np.testing.assert_array_equal(tenc.data["scale"], jenc.data["scale"])
        q = tenc.data["q"].view(np.uint8)
        for row, s in zip(q, tenc.data["scale"]):
            if s > tcomp.MIN_SCALE:       # the absmax maps to 448 = 0x7E (0xFE negative)
                assert (row & 0x7F).max() == 0x7E
    assert tcodec.encode_message("upload", {"r": 1}, tenc) == \
        jcodec.encode_message("upload", {"r": 1}, jenc)
    got = tcomp.decode_flat(tenc, device=CPU)[0]
    want = np.concatenate([np.asarray(a).reshape(-1)
                           for a in jax.tree.leaves(jcomp.decode_tree(jenc))])
    np.testing.assert_array_equal(got.numpy(), want)


def test_fp8_frames_decode_without_ml_dtypes(monkeypatch):
    """The reference's fp8 frame decodes on the port with ``ml_dtypes``
    hidden (``import ml_dtypes`` raises), bit-equal to the reference's
    decode; the port's own encode needs it neither."""
    jtree, ttree = _model(seed=1)
    frame = jcodec.encode_message("upload", {"compression": "fp8"},
                                  jcomp.Fp8Codec().encode_tree(jtree))
    want = np.concatenate([np.asarray(a).reshape(-1) for a in jax.tree.leaves(
        jcomp.decode_tree(jcodec.decode_message(frame)[2]))])
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(ImportError):
        import ml_dtypes  # noqa: F401
    kind, meta, tree = tcodec.decode_message(frame)
    assert kind == "upload" and meta == {"compression": "fp8"}
    assert all(isinstance(x.data["q"], tcodec.E4M3Bits) for x in tree_leaves(tree))
    np.testing.assert_array_equal(tcomp.decode_flat(tree, device=CPU)[0].numpy(), want)
    plan = tcomp.WirePlan.of(tree_layout(jtree), 1024, 1, CPU, port=False)
    assert tcodec.encode_message("upload", {"compression": "fp8"}, tree) == frame
    assert torch.equal(plan.decode(tree), torch.from_numpy(want))


def test_fp8_compressors_match_the_reference_compressors():
    """Two error-feedback uploads (the second a delta) and a delta download
    of the tiny model: frames, the server's decode and the residual and
    held copy bit-equal to the reference's compressors."""
    (j0, t0), (j1, t1) = _model(seed=2), _model(seed=3)
    jup, tup = jcomp.UploadCompressor(jcomp.Fp8Codec()), tcomp.UploadCompressor(tcomp.Fp8Codec())
    for jp, tp, jr, tr in [(j0, t0, None, None), (j1, t1, j0, t0)]:
        jenc, jmeta = jup.encode(jp, jr)
        tenc, tmeta = tup.encode(tp, tr)
        assert tmeta == jmeta and jmeta["compression"] == "fp8"
        assert tcodec.encode_message("u", tmeta, tenc) == jcodec.encode_message("u", jmeta, jenc)
        plan = tup.plan(tp)
        got = tcomp.decode_upload(tenc, tmeta, None if jr is None else
                                  jax.tree.map(torch.from_numpy, jr), plan=plan)
        want = jcomp.decode_upload(jenc, jmeta, jr)
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(
            plan.to_wire(tup.residual).numpy(),
            np.concatenate([a.reshape(-1) for a in jax.tree.leaves(jup.residual)]))
    assert tup.encoded_bytes == jup.encoded_bytes and tup.raw_bytes == jup.raw_bytes
    jdown, tdown = jcomp.DownlinkCompressor(jcomp.Fp8Codec()), tcomp.DownlinkCompressor(
        tcomp.Fp8Codec())
    tj0, tj1 = (jax.tree.map(torch.from_numpy, t) for t in (j0, j1))
    for jg, tg, r in [(j0, tj0, 1), (j1, tj1, 2)]:
        jenc, jmeta = jdown.encode(0, jg, r, acked_round=r - 1 if r > 1 else None)
        tenc, tmeta = tdown.encode(0, tg, r, acked_round=r - 1 if r > 1 else None)
        assert tmeta == jmeta
        assert tcodec.encode_message("d", tmeta, tenc) == jcodec.encode_message("d", jmeta, jenc)
    for a, b in zip(tree_leaves(tdown.held_state(0)[0]), jax.tree.leaves(jdown.held_state(0)[0])):
        np.testing.assert_array_equal(a.numpy(), b)


# -- jobs ------------------------------------------------------------------------------

def test_fp8_stacked_job_matches_jax_job():
    """fp8 uploads under Algorithm-2 churn, through the port's twin of the
    reference's compressed scan (``fedagg`` folds the dequantized rows)."""
    kw = dict(compression="fp8", max_dropout=1)
    jjob = JJob(task=JTask(**TINY), rounds=3, **kw)
    hold_job_to_jax(FederatedJob(task=TaskConfig(**TINY), rounds=3, device="cpu", **kw),
                    jjob, jjob.run())
