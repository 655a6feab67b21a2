"""The port's wire codec and message decode against the JAX reference.

Inputs are made with numpy from a seed and fed to both packages.

Tolerances, and why: none.  The frame (JSON header and payload) is the
reference's byte for byte; the grouped decode multiplies each int8 value by
its row's fp32 scale once, as the reference's numpy codec does, so decoded
values are bit-equal; a port model encoded for the wire carries the
reference's shapes, values and scales bit for bit (the encoder is the
reference's numpy rule, read in the reference's element order).
"""
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.comms import codec as jcodec  # noqa: E402
from repro.comms import compression as jcomp  # noqa: E402
from repro.configs.sanet_openkbp import SANET as JSANET  # noqa: E402
from repro.models import sanet as J  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.comms import codec as tcodec  # noqa: E402
from repro_torch.comms import compression as tcomp  # noqa: E402
from repro_torch.core.agg_engine import ravel, tree_layout  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels.quantize import Int8Table  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

CPU = torch.device("cpu")


def _tree(seed):
    """A reference-layout tree: a DHWIO conv leaf, leaves below, at and
    above one 1024 chunk, odd sizes, a list and a 1-element leaf."""
    rng = np.random.default_rng(seed)
    shapes = {"bias": (5,), "conv": (3, 3, 3, 5, 7), "norm": (300,), "one": (1,)}
    tree = {k: (rng.normal(size=sh) * 0.1).astype(np.float32) for k, sh in shapes.items()}
    tree["dense"] = [(rng.normal(size=(50, 50)) * 0.1).astype(np.float32),
                     (rng.normal(size=(2049,)) * 0.1).astype(np.float32)]
    return tree


def _jleaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, jcodec.QuantizedTensor))


def _as_port_qt(tree):
    return jax.tree.map(lambda q: tcodec.QuantizedTensor(q.codec, q.shape, q.data, q.meta)
                        if isinstance(q, jcodec.QuantizedTensor) else q,
                        tree, is_leaf=lambda x: isinstance(x, jcodec.QuantizedTensor))


def _plan_encode(jtree, align):
    """The reference-layout tree encoded by the port's wire plan (no
    reordering: the buffer already holds the wire's order) at ``align``."""
    flat = torch.from_numpy(np.concatenate([x.reshape(-1) for x in jax.tree.leaves(jtree)]))
    layout = tree_layout(jtree)
    plan = tcomp.WirePlan.of(layout, 1024, align, CPU, port=False)
    return plan.encode(flat)[0]


@pytest.mark.parametrize("meta", [{}, {"site": 3, "round": 7, "compression": "int8",
                                       "delta": True, "base_round": 6}])
def test_encode_message_bytes_equal_the_reference(meta):
    tree = _tree(0)
    assert tcodec.encode_message("upload", meta, tree) == jcodec.encode_message(
        "upload", meta, tree)
    enc = jcomp.Int8Codec(use_kernel=False).encode_tree(tree)
    assert tcodec.encode_message("upload", meta, _as_port_qt(enc)) == \
        jcodec.encode_message("upload", meta, enc)
    masked = {"w": tcodec.MaskedTensor((3,), {"v": np.arange(3, dtype=np.int64)})}
    jmasked = {"w": jcodec.MaskedTensor((3,), {"v": np.arange(3, dtype=np.int64)})}
    assert tcodec.encode_message("x", meta, masked) == jcodec.encode_message("x", meta, jmasked)
    assert tcodec.encode_message("ok", meta, None) == jcodec.encode_message("ok", meta, None)


def test_decode_message_round_trips_read_only_and_writable():
    tree = _tree(1)
    data = tcodec.encode_message("model", {"site": 0}, tree)
    kind, meta, ro = tcodec.decode_message(data)
    assert kind == "model" and meta == {"site": 0}
    with pytest.raises(ValueError, match="read-only"):
        ro["bias"] *= 2.0
    _, _, rw = tcodec.decode_message(data, writable=True)
    rw["bias"] *= 2.0
    np.testing.assert_array_equal(rw["bias"], tree["bias"] * 2.0)
    for a, b in zip(jax.tree.leaves(tcodec.decode_message(data)[2]), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
        assert a.shape == b.shape
    with pytest.raises(ValueError):
        tcodec.decode_message(b"XXXX" + data[4:])
    # each package reads the other's frames
    enc = jcomp.Int8Codec(use_kernel=False).encode_tree(tree)
    jdata = jcodec.encode_message("upload", {"site": 1}, enc)
    _, _, t = tcodec.decode_message(jdata)
    for a, b in zip(tree_leaves(t), _jleaves(enc)):
        assert a.shape == b.shape and a.codec == b.codec
        np.testing.assert_array_equal(a.data["q"], b.data["q"])
        np.testing.assert_array_equal(a.data["scale"], b.data["scale"])
    _, _, j = jcodec.decode_message(tcodec.encode_message("upload", {}, _as_port_qt(enc)))
    assert [x.shape for x in _jleaves(j)] == [x.shape for x in _jleaves(enc)]


def test_chunk_spans_frame_and_read_frame():
    assert tcodec.chunk_spans(10, 4) == jcodec.chunk_spans(10, 4) == [(0, 4), (4, 8), (8, 10)]
    assert tcodec.chunk_spans(0, 4) == jcodec.chunk_spans(0, 4) == [(0, 0)]
    with pytest.raises(ValueError):
        tcodec.chunk_spans(5, 0)
    data = tcodec.encode_message("x", {"a": 1}, _tree(2))
    assert tcodec.frame(data) == jcodec.frame(data)
    a, b = socket.socketpair()
    try:
        a.sendall(tcodec.frame(data) + tcodec.frame(b"tail"))
        assert tcodec.read_frame(b) == data
        assert tcodec.read_frame(b) == b"tail"
        a.close()
        with pytest.raises(ConnectionError):
            tcodec.read_frame(b)
    finally:
        b.close()


def test_payload_span_is_the_frame_itself():
    data = tcodec.encode_message("x", {}, _as_port_qt(
        jcomp.Int8Codec(use_kernel=False).encode_tree(_tree(3))))
    header, base = tcodec.read_header(data)
    _, _, t = tcodec.decode_message(data)
    arrays = [a for qt in tree_leaves(t) for a in (qt.data["q"], qt.data["scale"])]
    span, offsets = tcodec.payload_span(arrays)
    assert offsets == [r["offset"] for r in header["records"]]
    assert span.tobytes() == data[base:]
    assert span.base is not None                       # a view, not a copy
    # arrays of separate buffers are packed as a payload would be
    own = [np.ones(3, np.float32), np.arange(5, dtype=np.int8)]
    span, offsets = tcodec.payload_span(own)
    assert offsets == [0, 12] and span.nbytes == 17


@pytest.mark.parametrize("align", [1, 128])
def test_grouped_decode_bit_equal_reference_numpy_decode(align):
    """A whole message decoded by one grouped call (its plain version here)
    equals the reference's numpy ``_decode_int8`` leaf by leaf, on the
    CPU's align=1 layout (odd widths, scales at any byte offset) and the
    card's align=128 one."""
    tree = _tree(4)
    enc = (jcomp.Int8Codec(use_kernel=False).encode_tree(tree) if align == 1
           else _plan_encode(tree, 128))
    data = tcodec.encode_message("upload", {"site": 0}, enc if align == 128 else _as_port_qt(enc))
    _, _, t = tcodec.decode_message(data)
    _, _, j = jcodec.decode_message(data)
    if align == 128:
        assert {qt.data["q"].shape[1] % 128 for qt in tree_leaves(t)} == {0}
    got = tcomp.decode_tree(t, device=CPU)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(jcomp.decode_tree(j))):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    storages = {x.untyped_storage().data_ptr() for x in tree_leaves(got)}
    assert len(storages) == 1                          # views of one buffer
    assert ravel(got).numel() == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))


def test_dense_and_mixed_trees_decode_to_one_buffer():
    tree = _tree(5)
    _, _, t = tcodec.decode_message(tcodec.encode_message("global", {}, tree))
    flat, layout = tcomp.decode_flat(t, device=CPU)
    np.testing.assert_array_equal(flat.numpy(), np.concatenate(
        [x.reshape(-1) for x in jax.tree.leaves(tree)]))
    assert layout.shapes == tuple(x.shape for x in jax.tree.leaves(tree))
    mixed = {"a": np.arange(3, dtype=np.float64), "b": jcomp.Int8Codec(
        use_kernel=False).encode_array(tree["norm"])}
    _, _, m = tcodec.decode_message(tcodec.encode_message("x", {}, _as_port_qt(mixed)))
    flat, _ = tcomp.decode_flat(m, device=CPU)
    np.testing.assert_array_equal(flat[:3].numpy(), [0.0, 1.0, 2.0])
    np.testing.assert_array_equal(flat[3:].numpy(), jcomp.decode_array(mixed["b"]))


def test_grouped_table_checks_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="cannot hold"):
        Int8Table.of([(0, 8, 2, 4, 9, 0)])              # 9 values in 2 x 4
    with pytest.raises(ValueError, match="cannot hold"):
        Int8Table.of([(0, 8, 2, 4, 4, 0)])              # a whole empty row
    t = Int8Table.of([(0, 8, 2, 4, 5, 0), (0, 0, 0, 0, 0, 5)])   # a leaf of no rows drops
    assert t.leaves == 1 and t.total_rows == 2
    assert (t.q_extent, t.s_extent, t.out_extent) == (8, 16, 5)
    buf = torch.zeros(16, dtype=torch.uint8)
    with pytest.raises(ValueError, match="smaller"):
        ops.dequantize_int8_grouped(t, buf, buf[:12], torch.empty(5))
    with pytest.raises(TypeError):
        ops.dequantize_int8_grouped(t, buf.float(), buf, torch.empty(5))
    with pytest.raises(ValueError, match="on CUDA"):
        from repro_torch.kernels import quantize as qk
        qk.dequantize_int8_grouped_cuda(t, buf, buf, torch.empty(5))


def test_grouped_plain_version_equals_per_leaf_plain_version():
    rng = np.random.default_rng(6)
    parts, entries, pos, out = [np.zeros(3, np.uint8)], [], 3, 0
    for rows, width, size in [(1, 5, 5), (3, 128, 300), (2, 1024, 1100), (1, 1, 1)]:
        q = rng.integers(-127, 128, size=(rows, width), dtype=np.int8)
        s = rng.random(rows, dtype=np.float32)
        entries.append((pos, pos + q.nbytes, rows, width, size, out))
        parts += [q.reshape(-1).view(np.uint8), s.view(np.uint8)]
        pos += q.nbytes + s.nbytes
        out += size
    buf = torch.from_numpy(np.concatenate(parts))
    table = Int8Table.of(entries)
    before = dict(build.LAUNCHES)
    got = ops.dequantize_int8_grouped(table, buf, buf, torch.empty(out))
    assert build.LAUNCHES == before                     # the CPU launches nothing
    for q_off, s_off, rows, width, size, o in entries:
        q = buf[q_off: q_off + rows * width].view(torch.int8).view(rows, width)
        s = buf[s_off: s_off + 4 * rows].clone().view(torch.float32)
        want = ref.dequantize_int8_ref(q, s).reshape(-1)[:size]
        assert torch.equal(got[o: o + size], want)


def test_port_model_encodes_the_reference_layout_bit_for_bit():
    """The layout fault's guard: a port SA-Net (conv weights OIDHW) encoded
    for the wire carries the reference codec's shapes, q and scales for the
    same parameters, and decodes back into the port's layout."""
    params = jax.tree.map(np.asarray, J.sanet_init(jax.random.PRNGKey(0), JSANET))
    port = convert.from_reference(params)
    assert any(t.dim() == 5 for t in tree_leaves(port))
    comp = tcomp.UploadCompressor(tcomp.Int8Codec(), error_feedback=True)
    payload, meta = comp.encode(port)
    assert meta == {"compression": "int8", "delta": False}
    want = jcomp.Int8Codec(use_kernel=False).encode_tree(params)
    got = tree_leaves(payload)
    assert len(got) == len(_jleaves(want))
    for g, w in zip(got, _jleaves(want)):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(g.data["q"], w.data["q"])
        np.testing.assert_array_equal(g.data["scale"], w.data["scale"])
    assert comp.encoded_bytes == jcomp.tree_payload_nbytes(want)
    # the site's error-feedback residual is u - deQ(Q(u)) in the port's layout
    plan = comp.plan(port)
    deq = tcomp.decode_tree(payload, device=CPU)
    back = plan.to_port(ravel(deq))
    np.testing.assert_array_equal((ravel(port) - back).numpy(), comp.residual.numpy())
    want_port = convert.from_reference(jax.tree.map(np.asarray, jcomp.decode_tree(want)))
    np.testing.assert_array_equal(back.numpy(), ravel(want_port).numpy())
    # a dense upload is the reference's tree itself
    dense, dmeta = tcomp.UploadCompressor(tcomp.NoneCodec()).encode(port)
    assert dmeta == {"compression": "none", "delta": False}
    for a, b in zip(jax.tree.leaves(dense), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
