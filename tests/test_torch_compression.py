"""The port's int8 compressed rounds against the JAX reference.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
kernels run under the Pallas interpreter, as the reference's own tests
run them; the port's wrappers take their plain versions on the CPU.

Tolerances, and why:

- the int8 codec (scales, values, dequantized values), the fold's
  error-feedback residual and the downlink install are bit-equal to the
  reference's numpy codec and to its jnp twin run eagerly: both sides
  divide in IEEE fp32, round half to even and round each product and sum
  once;
- against the reference's kernels (jitted, then interpreted) the scales
  are within one ulp and the values equal, and the residual and the
  install are within ``2**-21`` of the largest magnitude involved.
  XLA's CPU compiler turns the kernels' ``absmax / 127`` into ``absmax *
  (1/127)``, which is not the IEEE quotient in about 4% of rows, and
  contracts ``u - q * s`` and ``base + q * s`` into one fused
  multiply-add, where the numpy codec rounds twice.  One ulp of a scale
  times ``|q| <= 127`` plus one rounding of the result stays inside that
  bound;
- the fold's ``g = sum_s w_s * deq_s`` is within rtol=atol=1e-6: the
  same fp32 products summed in another order;
- jobs: per-site losses within rtol 1e-4, atol 1e-5 (fp32 round-off
  through a few AdamW steps, as for uncompressed FedAvg), and bytes and
  ``comm`` equal.  The global model is within one int8 step of the
  largest chunk scale plus ``lr * rounds`` everywhere: a value of ``u``
  within an ulp of a rounding tie can flip one q between the frameworks
  (error feedback absorbs it over the following rounds), and AdamW's
  step is about ``lr * sign(g)``, which flips where float noise flips the
  sign of a near-zero gradient (the conv biases ahead of a GroupNorm
  have a zero gradient but for round-off; uncompressed FedAvg shows the
  same spread after 3 rounds).  At least 90% of its elements agree
  within ``lr / 100`` (about 97% do; a global one exchange stale, about
  1%), and with uploads alone the last round's active sites hold it bit
  for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import FederatedJob as JJob  # noqa: E402
from repro.api import TaskConfig as JTask  # noqa: E402
from repro.comms import compression as jcomp  # noqa: E402
from repro.configs.sanet_openkbp import SANET as JSANET  # noqa: E402
from repro.core import round_engine as jre  # noqa: E402
from repro.core.agg_engine import get_engine as jax_engine  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.quantize import quantize_dequantize_ref as jax_qdq  # noqa: E402
from repro.models import sanet as J  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import FederatedJob, TaskConfig  # noqa: E402
from repro_torch.comms import compression as tcomp  # noqa: E402
from repro_torch.configs.sanet_openkbp import SANET  # noqa: E402
from repro_torch.core import round_engine as tre  # noqa: E402
from repro_torch.core.agg_engine import get_engine  # noqa: E402
from repro_torch.core.stacking import broadcast_to_sites  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.models.sanet import sanet_init  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

G_TOL = dict(rtol=1e-6, atol=1e-6)
TASK = dict(kind="dose", sites=3, batch=2)
FULL_WIDTH_NBYTES = {128: 6_900_148, 1: 6_892_415}


def _matrix(rows, c, seed):
    """[rows, c] fp32 with a zero chunk (the MIN_SCALE floor) and, where it
    fits, a row of exact rounding ties (scale 1: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2)."""
    x = (np.random.default_rng(seed).normal(size=(rows, c)) * 0.05).astype(np.float32)
    x[0] = 0.0
    if rows > 1 and c >= 6:
        x[1, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    return x


def _deq_tol(*arrays) -> dict:
    """One ulp of a scale, and one rounding, downstream of it (see the
    module docstring)."""
    return dict(rtol=0, atol=2.0 ** -21 * max(float(np.abs(np.asarray(a)).max())
                                              for a in arrays))


@pytest.mark.parametrize("rows,c", [(1, 1), (7, 127), (5, 640), (3, 1024), (20, 128)])
def test_int8_codec_plain_versions_bit_equal_jax_kernels_and_numpy(rows, c):
    x = _matrix(rows, c, seed=rows * 31 + c)
    before = dict(build.LAUNCHES)
    q, s = ops.quantize_int8(torch.from_numpy(x))
    wire = jcomp.Int8Codec(chunk=c, use_kernel=False).encode_array(x.reshape(-1))
    np.testing.assert_array_equal(q.numpy(), wire.data["q"])
    np.testing.assert_array_equal(s.numpy(), wire.data["scale"])
    if rows > 1 and c >= 6:
        assert q[1, :6].tolist() == [127, 0, 2, 2, 0, -2]
    jq, js = jops.quantize_int8(jnp.asarray(x), interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)
    deq = ops.dequantize_int8(q, s)
    np.testing.assert_array_equal(deq.numpy(), jcomp.decode_array(wire).reshape(rows, c))
    np.testing.assert_array_equal(
        ops.dequantize_int8(torch.tensor(np.asarray(jq)), torch.tensor(np.asarray(js))).numpy(),
        np.asarray(jops.dequantize_int8(jq, js, interpret=True)))
    np.testing.assert_array_equal(
        ref.quantize_dequantize_ref(torch.from_numpy(x)).numpy(),
        np.asarray(jax_qdq(jnp.asarray(x))))
    # the port's wire codec: the same payload, and its decode
    tq = tcomp.Int8Codec(chunk=c).encode_array(torch.from_numpy(x).reshape(-1))
    assert tq.nbytes == wire.nbytes
    np.testing.assert_array_equal(tq.data["q"], wire.data["q"])
    np.testing.assert_array_equal(tq.data["scale"], wire.data["scale"])
    np.testing.assert_array_equal(tcomp.decode_array(tq, device="cpu").numpy(),
                                  jcomp.decode_array(wire))
    assert build.LAUNCHES == before                   # CPU: no kernel launched


@pytest.mark.parametrize("s,rows,c", [(1, 1, 1), (3, 7, 127), (4, 5, 640), (3, 2, 1024)])
def test_fold_and_install_plain_versions_match_jax_kernels(s, rows, c):
    rng = np.random.default_rng(s * 100 + rows + c)
    u = np.stack([_matrix(rows, c, seed=k) for k in range(s)]) * np.float32(0.5)
    base = rng.normal(size=(s, rows, c)).astype(np.float32)
    w = rng.dirichlet(np.ones(s)).astype(np.float32)
    if s > 1:                                  # an inactive site: a zero-weight row
        w[1] = 0.0
        w /= w.sum()
    q, sc = ops.quantize_int8(torch.from_numpy(u.reshape(s * rows, c)))
    q, sc = q.view(s, rows, c), sc.view(s, rows)
    g, r = ops.fedagg_dequant(q, sc, torch.from_numpy(u), torch.from_numpy(w))
    jg, jr = jops.fedagg_dequant(jnp.asarray(q.numpy()), jnp.asarray(sc.numpy()),
                                 jnp.asarray(u), jnp.asarray(w), interpret=True)
    deq = q.numpy().astype(np.float32) * sc.numpy()[..., None]     # the numpy codec
    np.testing.assert_array_equal(r.numpy(), u - deq)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), **_deq_tol(u, jr))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **G_TOL)
    np.testing.assert_allclose(g.numpy(), (w[:, None, None] * deq).sum(0), **G_TOL)
    inst = ops.dequant_install(q, sc, torch.from_numpy(base))
    np.testing.assert_array_equal(inst.numpy(), base + deq)
    jinst = np.asarray(jops.dequant_install(jnp.asarray(q.numpy()), jnp.asarray(sc.numpy()),
                                            jnp.asarray(base), interpret=True))
    np.testing.assert_allclose(inst.numpy(), jinst, **_deq_tol(base, jinst))


def _tree(seed, s):
    """A site-stacked reference tree (a DHWIO conv leaf among others; leaf
    sizes below, at and above one 1024 chunk) and its port twin."""
    rng = np.random.default_rng(seed)
    shapes = {"bias": (5,), "conv": (3, 3, 3, 5, 7), "dense": (50, 50),
              "norm": (300,), "whole": (2048,)}
    jtree = {k: (rng.normal(size=(s,) + sh) * 0.1).astype(np.float32)
             for k, sh in shapes.items()}
    ttree = {k: torch.from_numpy(np.ascontiguousarray(
        v.transpose(0, 5, 4, 1, 2, 3) if v.ndim == 6 else v)) for k, v in jtree.items()}
    return jtree, ttree


def _port_order(jtree) -> np.ndarray:
    """A reference [S, ...] tree (or unstacked, S = 1) as the port's [S, N]."""
    leaves = [np.asarray(x) for x in jax.tree.leaves(jtree)]
    return np.concatenate([
        (x.transpose(0, 5, 4, 1, 2, 3) if x.ndim == 6 else x).reshape(x.shape[0], -1)
        for x in leaves], axis=1)


@pytest.mark.parametrize("align", [1, 128])
def test_compressed_fold_and_down_install_match_jax(align):
    # align 1: the reference's jnp twin, eager (bit-equal); align 128: its
    # Pallas path, jitted and interpreted (scales within one ulp)
    accel = align == 128
    ju, tu = _tree(0, 3)
    jheld, theld = _tree(1, 3)
    jg_full, _ = _tree(2, 1)
    w = np.asarray([0.5, 0.0, 0.5], np.float32)
    flat, layout = get_engine().flatten(tu)
    plan = tre.ChunkPlan.of(layout, 1024, align, torch.device("cpu"))
    g, r = tre.compressed_fold(flat, torch.from_numpy(w), plan)
    jg, jr = jre._compressed_fold(jax.tree.map(jnp.asarray, ju), jnp.asarray(w), "int8",
                                  1024, align, accel, jax_engine())
    jr, jg = _port_order(jr), _port_order(jax.tree.map(lambda x: x[None], jg))[0]
    if accel:
        np.testing.assert_allclose(r.numpy(), jr, **_deq_tol(flat, jr))
    else:
        np.testing.assert_array_equal(r.numpy(), jr)
    np.testing.assert_allclose(g.numpy(), jg, **G_TOL)

    gref = {k: v[0] for k, v in jg_full.items()}
    held = get_engine().flatten(theld)[0]
    inst = tre.down_install(torch.from_numpy(_port_order(jg_full)[0]), held, plan)
    jinst = jre._down_install_tree(jax.tree.map(jnp.asarray, gref),
                                   jax.tree.map(jnp.asarray, jheld), "int8", 1024,
                                   align, accel, 0.1)
    jinst = _port_order(jinst)
    if accel:
        np.testing.assert_allclose(inst.numpy(), jinst, **_deq_tol(held, jinst))
    else:
        np.testing.assert_array_equal(inst.numpy(), jinst)
    assert tre.encoded_nbytes(layout.shapes, 1024, align) == jre._encoded_nbytes(
        ju, 1024, align)


@pytest.fixture(scope="module")
def full_width():
    """The reference's full-width SA-Net leaf shapes (no allocation) and
    the port's full-width layout."""
    shapes = jax.eval_shape(lambda: J.sanet_init(jax.random.PRNGKey(0), JSANET))
    params = sanet_init(torch.Generator().manual_seed(0), SANET)
    return shapes, get_engine().layout_of(broadcast_to_sites(params, 1))


@pytest.mark.parametrize("align", [1, 128])
def test_encoded_nbytes_and_chunk_geom_match_reference_at_full_width(full_width, align):
    shapes, layout = full_width
    jstacked = jax.tree.map(lambda x: jax.ShapeDtypeStruct((1,) + x.shape, x.dtype), shapes)
    assert layout.n == 6_844_323 and len(layout.shapes) == 160
    want = FULL_WIDTH_NBYTES[align]
    assert jre._encoded_nbytes(jstacked, 1024, align) == want
    assert tre.encoded_nbytes(layout.shapes, 1024, align) == want
    plan = tre.ChunkPlan.of(layout, 1024, align, torch.device("cpu"))
    assert sum(rows * w + 4 * rows for w, rows, _ in plan.groups) == want
    for sh, jx in zip(layout.shapes, jax.tree.leaves(shapes)):
        n = int(np.prod(sh))
        assert n == int(np.prod(jx.shape))
        assert tcomp.chunk_geom(n, 1024, align) == jcomp.chunk_geom(n, 1024, align)
    if align == 128:               # the card's layout: four widths, 6,797 rows
        assert {w: rows for w, rows, _ in plan.groups} == {1024: 6693, 640: 7,
                                                           256: 19, 128: 78}


@pytest.mark.parametrize("keep", [1, 3, 16])
def test_bootstrap_masks_bit_equal_reference(keep):
    masks = np.random.default_rng(keep).random((40, 5)) < 0.6
    np.testing.assert_array_equal(tre.bootstrap_masks(masks, keep),
                                  jre._bootstrap_masks(masks, keep))


def test_wire_codec_payload_equals_reference_codec():
    """The port's ``Int8Codec`` on a CPU tree (the reference's layout,
    align 1) gives the numpy codec's payload, bytes and decode."""
    jtree, _ = _tree(3, 1)
    jtree = {k: v[0] for k, v in jtree.items()}
    jenc = jcomp.Int8Codec(use_kernel=False).encode_tree(jtree)
    tenc = tcomp.Int8Codec().encode_tree(tree_map(torch.from_numpy, jtree))
    assert tcomp.tree_payload_nbytes(tenc) == jcomp.tree_payload_nbytes(jenc)
    for tq, jq in zip(tree_leaves(tenc), jax.tree.leaves(
            jenc, is_leaf=lambda x: isinstance(x, jcomp.QuantizedTensor))):
        assert tq.shape == jq.shape
        np.testing.assert_array_equal(tq.data["q"], jq.data["q"])
        np.testing.assert_array_equal(tq.data["scale"], jq.data["scale"])
    for t, j in zip(tree_leaves(tenc), jax.tree.leaves(jcomp.decode_tree(jenc))):
        np.testing.assert_array_equal(tcomp.decode_array(t, device="cpu").numpy(), j)


# ids: the downlink codec under int8 uploads, and dense uploads with int8
# downloads
@pytest.mark.parametrize("compression,down", [
    pytest.param("int8", "none", id="none"), pytest.param("int8", "int8", id="int8"),
    pytest.param("none", "int8", id="down-only")])
def test_compressed_trajectory_matches_jax_job(compression, down):
    job_kw = dict(strategy="fedavg", rounds=3, max_dropout=1, seed=0,
                  compression=compression, down_compression=down)
    jjob = JJob(task=JTask(**TASK), **job_kw)
    jres = jjob.run()
    init = jax.tree.map(np.asarray, jjob.task.build().init_fn(jax.random.PRNGKey(jjob.seed)))
    tjob = FederatedJob(task=TaskConfig(**TASK), device="cpu", **job_kw)
    tres = tjob.run(init_params=convert.from_reference(init))
    assert tres.comm == jres.comm
    assert min(h["active"] for h in jres.history) < 3      # a masked round ran
    for th, jh in zip(tres.history, jres.history):
        assert th["active"] == jh["active"]
        assert th["upload_bytes"] == jh["upload_bytes"]
        assert th.get("download_bytes") == jh.get("download_bytes")
        np.testing.assert_allclose(th["per_site_loss"], jh["per_site_loss"],
                                   rtol=1e-4, atol=1e-5)
    want = _port_order(jax.tree.map(lambda x: np.asarray(x)[None], jres.global_params))[0]
    got = torch.cat([t.reshape(-1) for t in tree_leaves(tres.global_params)]).numpy()
    diff = np.abs(got - want)
    # round 0 uploads the whole model against a zero reference: its largest
    # chunk scale is the largest |init| / 127
    step = max(float(np.abs(x).max()) for x in jax.tree.leaves(init)) / 127
    assert float(diff.max()) <= step + jjob.lr * jjob.rounds
    # the last round's exchange moves nearly every element by about lr, so
    # a global that missed it agrees within lr / 100 on about 1% of the
    # elements; this one must on 90% or more
    assert float(np.mean(diff <= 1e-2 * jjob.lr)) >= 0.9
    if down == "none":     # the last round's active sites hold the global itself
        rows = tres.state["params"].numpy()
        for i in np.flatnonzero(tjob.masks(tjob.rounds)[-1]):
            np.testing.assert_array_equal(rows[i], got)



def test_error_feedback_off_drops_the_residual():
    """With ``error_feedback=False`` the residual never enters an upload:
    rounds 0 and 1 (whose uploads carry no residual yet) are the same as
    with it, the bytes are the same, and the later model differs."""
    tiny = TaskConfig(kind="dose", sites=2, batch=1, volume=(8, 8, 8), base_filters=4)
    job = FederatedJob(task=tiny, rounds=3, seed=0, device="cpu",
                       compression="int8", down_compression="int8")
    on, off = job.run(), job.replace(error_feedback=False).run()
    assert on.losses[:2] == off.losses[:2] and on.comm == off.comm
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(on.global_params),
                                                      tree_leaves(off.global_params)))
