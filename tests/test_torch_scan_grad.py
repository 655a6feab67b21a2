"""The gradients of the port's two scans against the JAX reference.

- ``rwkv6_scan_bwd_ref`` and ``mamba_scan_bwd_ref`` (the backward written
  out: the CPU path of the backward kernels and their oracle on the card)
  against ``torch.autograd`` through ``rwkv6_scan_ref`` / ``mamba_scan_ref``
  and against ``jax.vjp`` of the reference's own jnp scans,
  ``models/rwkv6.py::wkv_scan`` and ``models/mamba.py::selective_scan``,
  on the same numpy inputs: ragged lengths (L 1, none a multiple of the
  16-step checkpoint stage but 32), head dims 32 and 64, d_state 1 to
  32, w near 0 and near 1, dt large enough that exp(dt A) underflows,
  and a non-zero gradient of the final state.
- The ``torch.autograd.Function``s: on CPU tensors ``rwkv6_scan`` and
  ``mamba_scan`` have a ``grad_fn`` wherever autograd needs one and their
  gradients are the plain backward's; ``torch.func.vmap(torch.func.grad(
  ...))`` (per-example DP-SGD) gives each example its own gradient of the
  shared u and log_a, as a loop over the examples does (with u or log_a
  mapped too, ``NotPorted``); no second derivative.
- A CPU model of each kernel's walk, held to the plain backward: the
  forward's checkpoint every C steps (C read from the ``.cu`` sources),
  the stages last to first, each stage's states recomputed from its
  checkpoint (the WKV-6 kernel's in sub-stages), the sums added in the
  kernels' orders (the WKV-6 kernel's 2 x 4 tiles, shuffle trees, warps
  and cluster ranks; the selective scan's states a thread, slices, warps,
  per-block partials of dB and dC, the block's channels read from its
  dispatch, and the second kernel's runs of blocks).
- The C interfaces (argument counts, instances) against the sources.

Tolerances: every gradient within rtol 1e-5 and atol 1e-5 of its largest
value (``chip_smoke.SCAN_RTOL``, the card's gate): fp32 sums of up to D
or d_state terms a step, chained over L steps, in another order than
autograd's or XLA's (the reference's fp32 backward lies 1e-6 to 3e-6 of
the largest value from the port's; the plain backward in fp32 lies under
1e-6 from its float64 self).  The CUDA kernels are held to the plain
backwards on the card by ``chip_smoke.py`` (phase 21a-b).
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import mamba as jmamba  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro_torch import NotPorted  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rs  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
RTOL = 1e-5
W_SHIFT = {"zero": 3.0, "mid": -5.0, "one": -9.0}     # chip_smoke.W_SHIFT
# (batch, heads, L, D, w) and (batch, L, d_inner, d_state, dt's shift): the
# shapes and regimes of chip_smoke's phase 21a-b, at CPU sizes
RWKV_CASES = [(1, 1, 1, 32, "mid"), (2, 3, 13, 32, "zero"), (1, 2, 37, 64, "one"),
              (1, 4, 32, 64, "zero"), (2, 2, 0, 32, "mid")]
MAMBA_CASES = [(1, 1, 5, 1, -3.0), (2, 13, 24, 8, -3.0), (1, 37, 70, 16, 4.0),
               (2, 33, 40, 32, 4.0), (1, 19, 20, 5, -3.0), (2, 0, 8, 16, -3.0)]
JAX_RWKV = RWKV_CASES[1:4]
JAX_MAMBA = MAMBA_CASES[1:4]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rwkv_inputs(case, seed=0):
    b, h, l, d, regime = case
    rng = np.random.default_rng(seed)
    r, k, v, z, dout = (rng.standard_normal((b, h, l, d)).astype(np.float32) for _ in range(5))
    w = np.exp(-np.exp(z + W_SHIFT[regime])).astype(np.float32)
    u = (0.5 * rng.standard_normal((h, d))).astype(np.float32)
    dstate = rng.standard_normal((b, h, d, d)).astype(np.float32)
    return [torch.from_numpy(x) for x in (r, k, v, w, u, dout, dstate)]


def _mamba_inputs(case, seed=0):
    b, l, di, ds, shift = case
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, di)) + shift)).astype(np.float32)
    bm, cm = (rng.standard_normal((b, l, ds)).astype(np.float32) for _ in range(2))
    x, dy = (rng.standard_normal((b, l, di)).astype(np.float32) for _ in range(2))
    # a row of A for each channel, A down to -ds
    log_a = (np.log(np.arange(1, ds + 1, dtype=np.float32))[None]
             + 0.1 * rng.standard_normal((di, ds))).astype(np.float32)
    dstate = rng.standard_normal((b, di, ds)).astype(np.float32)
    return [torch.from_numpy(a) for a in (dt, bm, cm, x, log_a, dy, dstate)]


def _close(got, want, what=""):
    for i, (a, w) in enumerate(zip(got, want)):
        scale = max(float(w.abs().max()) if w.numel() else 0.0, 1.0)
        torch.testing.assert_close(a, w, rtol=RTOL, atol=RTOL * scale,
                                   msg=lambda m, i=i: f"{what} gradient {i}: {m}")


def _autograd(fwd, xs, dgrad, dstate):
    leaves = [t.clone().requires_grad_() for t in xs]
    out, state = fwd(*leaves)
    # 0 x every leaf: at L = 0 the outputs do not depend on the inputs
    tie = sum(0.0 * t.sum() for t in leaves)
    return torch.autograd.grad((out * dgrad).sum() + (state * dstate).sum() + tie, leaves)


def _rid(c):
    return "-".join(map(str, c))


@pytest.mark.parametrize("case", RWKV_CASES, ids=_rid)
def test_rwkv6_plain_backward_is_autograd_of_the_plain_scan(case):
    *xs, dout, dstate = _rwkv_inputs(case)
    got = ref.rwkv6_scan_bwd_ref(*xs, dout, dstate)
    _close(got, _autograd(ref.rwkv6_scan_ref, xs, dout, dstate))
    rows = ref.rwkv6_scan_bwd_ref(*xs, dout, dstate, rows=True)
    assert rows[4].shape == (case[0], case[1], case[3])
    torch.testing.assert_close(rows[4].sum(0), got[4], rtol=1e-6, atol=1e-6)
    # no final-state gradient is a zero one
    for a, b in zip(ref.rwkv6_scan_bwd_ref(*xs, dout),
                    ref.rwkv6_scan_bwd_ref(*xs, dout, torch.zeros_like(dstate))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", MAMBA_CASES, ids=_rid)
def test_mamba_plain_backward_is_autograd_of_the_plain_scan(case):
    *xs, dy, dstate = _mamba_inputs(case)
    got = ref.mamba_scan_bwd_ref(*xs, dy, dstate)
    _close(got, _autograd(ref.mamba_scan_ref, xs, dy, dstate))
    rows = ref.mamba_scan_bwd_ref(*xs, dy, dstate, rows=True)
    assert rows[4].shape == (case[0], case[2], case[3])
    torch.testing.assert_close(rows[4].sum(0), got[4], rtol=1e-6, atol=1e-6)
    if case[4] > 0 and case[1]:                       # some decays are exactly 0
        a = -torch.exp(xs[4])
        assert bool((torch.exp(xs[0][..., None] * a) == 0).any())


@pytest.mark.parametrize("case", JAX_RWKV, ids=_rid)
def test_rwkv6_plain_backward_is_the_vjp_of_the_reference_scan(case):
    *xs, dout, dstate = _rwkv_inputs(case)

    def blhd(t):
        return jnp.asarray(np.ascontiguousarray(np.swapaxes(t.numpy(), 1, 2)))
    args = [blhd(t) for t in xs[:4]] + [jnp.asarray(xs[4].numpy())]
    (out, state), vjp = jax.vjp(jrwkv.wkv_scan, *args)
    want = vjp((blhd(dout), jnp.asarray(dstate.numpy())))
    want = [torch.from_numpy(np.ascontiguousarray(np.swapaxes(np.asarray(g), 1, 2)))
            for g in want[:4]] + [torch.from_numpy(np.array(want[4]))]
    got_out, got_state = ref.rwkv6_scan_ref(*xs)
    _close([got_out, got_state], [torch.from_numpy(np.ascontiguousarray(
        np.swapaxes(np.asarray(out), 1, 2))), torch.from_numpy(np.array(state))])
    _close(ref.rwkv6_scan_bwd_ref(*xs, dout, dstate), want, "rwkv6 vs jax.vjp")


@pytest.mark.parametrize("case", JAX_MAMBA, ids=_rid)
def test_mamba_plain_backward_is_the_vjp_of_the_reference_scan(case):
    *xs, dy, dstate = _mamba_inputs(case)
    (y, state), vjp = jax.vjp(jmamba.selective_scan, *(jnp.asarray(t.numpy()) for t in xs))
    want = [torch.from_numpy(np.array(g)) for g in vjp((jnp.asarray(dy.numpy()),
                                                          jnp.asarray(dstate.numpy())))]
    _close(ref.mamba_scan_ref(*xs), [torch.from_numpy(np.array(y)),
                                     torch.from_numpy(np.array(state))])
    _close(ref.mamba_scan_bwd_ref(*xs, dy, dstate), want, "mamba vs jax.vjp")


@pytest.mark.parametrize("scan,inputs,case", [
    (rs.rwkv6_scan, _rwkv_inputs, RWKV_CASES[2]), (ms.mamba_scan, _mamba_inputs, MAMBA_CASES[2])],
    ids=["rwkv6", "mamba"])
def test_the_functions_differentiate_on_the_cpu(scan, inputs, case):
    *xs, dgrad, dstate = inputs(case)
    leaves = [t.clone().requires_grad_() for t in xs]
    out, state = scan(*leaves)
    assert out.grad_fn is not None and state.grad_fn is not None
    assert type(out.grad_fn).__name__ in ("Rwkv6ScanBackward", "MambaScanBackward")
    plain = ref.rwkv6_scan_bwd_ref if scan is rs.rwkv6_scan else ref.mamba_scan_bwd_ref
    got = torch.autograd.grad((out * dgrad).sum() + (state * dstate).sum(), leaves)
    for a, b in zip(got, plain(*xs, dgrad, dstate)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    # only the output's gradient: the final state's is zero
    out, _ = scan(*leaves)
    for a, b in zip(torch.autograd.grad(out, leaves, dgrad), plain(*xs, dgrad)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        assert scan(*leaves)[0].grad_fn is None
    out, _ = scan(*leaves)
    (g0,) = torch.autograd.grad((out * out).sum(), leaves[0], create_graph=True)
    with pytest.raises(NotImplementedError, match="second derivative"):
        torch.autograd.grad(g0.sum(), leaves[0])


@pytest.mark.parametrize("which", ["rwkv6", "mamba"])
def test_vmap_of_grad_gives_each_example_its_own_shared_gradient(which):
    """Per-example DP-SGD's transform: u and log_a enter unbatched and each
    example gets its own gradient of them (not the batch's), as a loop
    over single examples gives; with them mapped too (a model an example,
    which no path of the port asks for) the rule raises ``NotPorted``."""
    n = 3
    if which == "rwkv6":
        *xs, _, _ = _rwkv_inputs((n, 2, 21, 32, "mid"), seed=4)
        scan, plain = rs.rwkv6_scan, ref.rwkv6_scan_ref
        shared, batched = xs[4], xs[:4]
    else:
        *xs, _, _ = _mamba_inputs((n, 19, 12, 8, -3.0), seed=4)
        scan, plain = ms.mamba_scan, ref.mamba_scan_ref
        shared, batched = xs[4], xs[:4]

    def loss(fn):
        def f(p, *ex):
            out, state = fn(*(t[None] for t in ex), p)
            return torch.tanh(out).sum() + (state * state).sum()
        return f

    got = torch.func.vmap(torch.func.grad(loss(scan), argnums=(0, 1, 2, 3, 4)),
                          in_dims=(None, 0, 0, 0, 0))(shared, *batched)
    with pytest.raises(NotPorted, match="shared parameter") as err:
        torch.func.vmap(torch.func.grad(loss(scan), argnums=(0, 1, 2, 3, 4)))(
            shared.expand(n, *shared.shape).contiguous(), *batched)
    assert err.value.seam == ("rwkv6_scan" if which == "rwkv6" else "mamba_scan")
    total = 0.0
    for i in range(n):
        leaves = [shared.clone().requires_grad_()] + [t[i].clone().requires_grad_()
                                                      for t in batched]
        want = torch.autograd.grad(loss(plain)(*leaves), leaves)
        for a, w in zip(got, want):
            torch.testing.assert_close(a[i], w, rtol=RTOL, atol=RTOL * float(w.abs().max()))
        total = total + want[0]
    # the examples' shared gradients differ, and add up to the batch's
    assert not torch.allclose(got[0][0], got[0][1])
    torch.testing.assert_close(got[0].sum(0), total, rtol=1e-5, atol=1e-5)


# -- the kernels' walks, modelled --------------------------------------------------

def _const(source: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text()).group(1))


def test_checkpoint_stage_and_interfaces_match_the_sources():
    for src in ("rwkv6_scan.cu", "rwkv6_scan_bwd.cu"):
        assert _const(src, "kSteps") == rs.CKPT_STEPS, src
    for src in ("mamba_scan.cu", "mamba_scan_bwd.cu"):
        assert _const(src, "kSteps") == ms.CKPT_STEPS, src
    # the WKV-6 walk: 32 rows a block, 2 x 4 tiles, sub-stages that divide the stage
    assert (_const("rwkv6_scan_bwd.cu", "kRows"), _const("rwkv6_scan_bwd.cu", "kCols")) == (32, 4)
    assert rs.CKPT_STEPS % _const("rwkv6_scan_bwd.cu", "kSub") == 0
    assert _const("mamba_scan_bwd.cu", "kThreadsB") == ms.BWD_THREADS
    assert _const("mamba_scan_bwd.cu", "kPer") == 4
    assert tuple(_mamba_splits()) == ms.BWD_SPLITS
    # the partials' channel blocks: 128 threads, or 32 a thread of a channel
    assert [ms.bwd_block_channels(ds) for ds in (1, 4, 5, 8, 9, 16, 17, 32)] \
        == [128, 128, 64, 64, 32, 32, 32, 32]

    def params(source, symbol):
        m = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', (CSRC / source).read_text())
        return len(m.group(1).split(","))
    assert params("rwkv6_scan.cu", "rwkv6_scan_f32") == len(rs._ARGS)
    assert params("rwkv6_scan.cu", "rwkv6_scan_bf16") == len(rs._ARGS)
    assert params("rwkv6_scan_bwd.cu", "rwkv6_scan_bwd_f32") == len(rs._BWD_ARGS)
    assert params("mamba_scan.cu", "mamba_scan_f32") == len(ms._ARGS)
    for part in ("", "_walk", "_reduce"):
        assert params("mamba_scan_bwd.cu", f"mamba_scan_bwd{part}_f32") == len(ms._BWD_ARGS)
    text = (CSRC / "rwkv6_scan_bwd.cu").read_text()
    entry = text[text.index('extern "C" int rwkv6_scan_bwd_f32'):]
    assert tuple(int(d) for d in re.findall(r"case (\d+): return launch<", entry)) \
        == rs.BWD_HEAD_DIMS
    assert max(ds for ds, _ in _mamba_splits()) == ms.MAX_STATE


def _mamba_splits():
    """(largest d_state, threads a channel) of each instance, from the
    backward's dispatch."""
    text = (CSRC / "mamba_scan_bwd.cu").read_text()
    entry = text[text.index("int dispatch("):]
    entry = entry[:entry.index("\n}\n")]
    splits = [(int(ds), int(g)) for ds, g in
              re.findall(r"if \(ds <= (\d+)\)\s*return launch<(\d+)>", entry)]
    last = re.findall(r"\n  return launch<(\d+)>", entry)
    return splits + [(ms.MAX_STATE, int(last[0]))]


def _forward_ckpts(step, s, l, c_steps):
    """The states before every ``c_steps``-th step of ``step(s, t)``."""
    ckpt = []
    for t in range(l):
        if t % c_steps == 0:
            ckpt.append(s)
        s = step(s, t)
    return ckpt


def _in_order(parts):
    """parts[0] + parts[1] + ...: a fixed order of addition."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def _rwkv_walk(r, k, v, w, u, dout, dstate, c_steps: int, sub: int, rows: int):
    """csrc/rwkv6_scan_bwd.cu's walk in fp32 torch.  Checkpoints every
    ``c_steps`` from the forward; the stages last to first, each in
    sub-stages of ``sub`` steps whose states are recomputed from the
    checkpoint; the D rows split over D / ``rows`` blocks of a cluster.  A
    thread holds a 2 x 4 tile and a warp 16 rows by 16 columns.  A row's
    sums (dr, dk, dw): a tile's 4 columns, the warp's 4 column groups as
    (c0 + c2) + (c1 + c3), the column warps in order.  A column's (dv): a
    tile's 2 rows, a warp's 8 row groups as ((p0 + p4) + (p2 + p6)) + ((p1
    + p5) + (p3 + p7)), the row warps of each block and the blocks in rank
    order, and the bonus term with the ranks' shares of sum_i u_i r_i k_i
    added in rank order (each share, and v . dout, a plain sum here).  du a
    sum over the steps, last first."""
    b, h, l, d = r.shape
    ranks, warps = d // rows, d // 16

    def step(s, t):
        return w[:, :, t, :, None] * s + k[:, :, t, :, None] * v[:, :, t, None, :]

    def row_sums(x):                    # [b, h, D, D] -> [b, h, D], over the columns
        c = x.reshape(b, h, d, warps, 4, 4).sum(-1)     # a tile's 4 columns
        c = (c[..., 0] + c[..., 2]) + (c[..., 1] + c[..., 3])
        return _in_order([c[..., q] for q in range(warps)])

    def col_sums(x):                    # [b, h, D, D] -> [b, h, D], over the rows
        p = x.reshape(b, h, d // 16, 8, 2, d)
        p = p[:, :, :, :, 0] + p[:, :, :, :, 1]        # a tile's 2 rows
        y = p[:, :, :, :4] + p[:, :, :, 4:]
        z = (y[:, :, :, 0] + y[:, :, :, 2]) + (y[:, :, :, 1] + y[:, :, :, 3])
        # a block's row warps in order, then the ranks: 16-row groups in order
        return _in_order([z[:, :, q] for q in range(d // 16)])

    ckpt = _forward_ckpts(step, torch.zeros(b, h, d, d), l, c_steps)
    g = dstate.clone()
    dr, dk, dv, dw = (torch.zeros(b, h, l, d) for _ in range(4))
    du = torch.zeros(b, h, d)
    uu = u[None]
    for c in reversed(range(len(ckpt))):
        t0, nt = c * c_steps, min(c_steps, l - c * c_steps)
        for s0 in reversed(range(0, nt, sub)):
            s = ckpt[c]
            for t in range(t0, t0 + s0):
                s = step(s, t)
            states = []
            for t in range(t0 + s0, t0 + min(s0 + sub, nt)):
                states.append(s)
                s = step(s, t)
            for j in reversed(range(len(states))):
                t, p = t0 + s0 + j, states[j]
                r_t, k_t, v_t, w_t, g_t = (x[:, :, t] for x in (r, k, v, w, dout))
                vd = (v_t * g_t).sum(-1, keepdim=True)
                ruk = (uu * r_t * k_t).reshape(b, h, ranks, rows).sum(-1)
                dr[:, :, t] = row_sums(p * g_t[..., None, :]) + uu * k_t * vd
                dk[:, :, t] = row_sums(g * v_t[..., None, :]) + uu * r_t * vd
                dw[:, :, t] = row_sums(g * p)
                dv[:, :, t] = (col_sums(g * k_t[..., :, None])
                               + _in_order([ruk[..., q, None] for q in range(ranks)]) * g_t)
                du = du + r_t * k_t * vd
                g = w_t[..., :, None] * g + r_t[..., :, None] * g_t[..., None, :]
    return dr, dk, dv, dw, du


def _mamba_walk(dt, bm, cm, x, log_a, dy, dstate, c_steps: int, threads: int, per: int,
                reduce_warps: int):
    """csrc/mamba_scan_bwd.cu's walk in fp32 torch: checkpoints every
    ``c_steps``, the stages last to first with their states recomputed.  A
    channel's states over G threads of ``per`` each (G from the instance's
    split), a block ``threads`` / G channels (``threads`` at least 32 G).
    dx and ddt: each thread's ``per`` states, then the G shares in order.
    dB and dC: a warp's 32 channels, the slice's warps of a block in order,
    then a second kernel over the blocks' partials: ``reduce_warps`` runs of
    consecutive blocks, each added in order, and the runs in order.
    dlog_a a sum over the steps."""
    bsz, l, di = dt.shape
    ds = log_a.shape[1]
    g_threads = next(g for top, g in ms.BWD_SPLITS if ds <= top)
    chan = max(threads, 32 * g_threads) // g_threads
    pad_n = g_threads * per - ds
    a = -torch.exp(log_a)

    def step(s, t):
        return (torch.exp(dt[:, t, :, None] * a) * s
                + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None])

    def over_states(val):               # [bsz, di, ds] -> [bsz, di]: per-thread, then slices
        val = torch.nn.functional.pad(val, (0, pad_n)).reshape(bsz, di, g_threads, per).sum(-1)
        return _in_order([val[..., q] for q in range(g_threads)])

    ckpt = _forward_ckpts(step, torch.zeros(bsz, di, ds), l, c_steps)
    nblk = -(-di // chan)
    pad = nblk * chan - di
    g = dstate.clone()
    ddt, dx = torch.zeros(bsz, l, di), torch.zeros(bsz, l, di)
    part_b, part_c = torch.zeros(nblk, bsz, l, ds), torch.zeros(nblk, bsz, l, ds)
    da = torch.zeros(bsz, di, ds)
    for c in reversed(range(len(ckpt))):
        t0, nt = c * c_steps, min(c_steps, l - c * c_steps)
        st = [ckpt[c]]
        for t in range(t0, t0 + nt):
            st.append(step(st[-1], t))
        for j in reversed(range(nt)):
            t = t0 + j
            dt_t, x_t, dy_t = dt[:, t], x[:, t], dy[:, t]
            g = g + dy_t[..., None] * cm[:, t, None]
            for part, val in ((part_c, dy_t[..., None] * st[j + 1]),
                              (part_b, g * (dt_t * x_t)[..., None])):
                val = torch.nn.functional.pad(val, (0, 0, 0, pad))
                warps = val.reshape(bsz, nblk, chan // 32, 32, ds).sum(3)
                part[:, :, t] = _in_order([warps[:, :, q] for q in range(chan // 32)]
                                          ).transpose(0, 1)
            gb = over_states(g * bm[:, t, None])
            dec = torch.exp(dt_t[..., None] * a)
            gds = g * dec * st[j]
            dx[:, t] = dt_t * gb
            ddt[:, t] = x_t * gb + over_states(gds * a)
            da = da + gds * dt_t[..., None]
            g = g * dec
    run = -(-nblk // reduce_warps)
    runs = [part for part in (range(q, min(nblk, q + run)) for q in range(0, nblk, run))]
    db, dc = (_in_order([_in_order([p[q] for q in blocks]) for blocks in runs])
              for p in (part_b, part_c))
    return ddt, db, dc, dx, da * a


@pytest.mark.parametrize("case", RWKV_CASES + [(1, 2, 70, 64, "one"), (1, 2, 45, 32, "one"),
                                               (2, 1, 27, 64, "mid")], ids=_rid)
def test_the_wkv6_kernels_walk_holds_the_plain_backward(case):
    *xs, dout, dstate = _rwkv_inputs(case, seed=7)
    got = _rwkv_walk(*xs, dout, dstate, _const("rwkv6_scan_bwd.cu", "kSteps"),
                     _const("rwkv6_scan_bwd.cu", "kSub"), _const("rwkv6_scan_bwd.cu", "kRows"))
    _close(got, ref.rwkv6_scan_bwd_ref(*xs, dout, dstate, rows=True), "walk")


@pytest.mark.parametrize("case", MAMBA_CASES + [(2, 50, 150, 32, -3.0), (1, 21, 300, 16, 4.0)],
                         ids=_rid)
def test_the_selective_scan_kernels_walk_holds_the_plain_backward(case):
    *xs, dy, dstate = _mamba_inputs(case, seed=7)
    got = _mamba_walk(*xs, dy, dstate, _const("mamba_scan_bwd.cu", "kSteps"),
                      ms.BWD_THREADS, _const("mamba_scan_bwd.cu", "kPer"),
                      _const("mamba_scan_bwd.cu", "kReduceWarps"))
    _close(got, ref.mamba_scan_bwd_ref(*xs, dy, dstate, rows=True), "walk")
