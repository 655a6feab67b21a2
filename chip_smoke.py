#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it goes wrong:

1. the card's name and power limit, then a build of every hand-written
   kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per source, all
   started together), and the registers, shared memory and blocks an SM
   of each instance of ``flash_attention``, ``rwkv6_scan``, ``mamba_scan``
   and ``quantize_int8``;
2. each kernel against its plain PyTorch version on the card, at the
   paths' shapes and at ragged ones, with stated tolerances, then its
   time beside its bound (fp32 attention's at the TF32 tensor-core rate,
   three products a flop), the plain version's time and, where one exists,
   one library call's time (CUDA events around a CUDA graph of the call
   site, median of 25 replays after a warm-up, so no host time is in
   them; the eager call site's time is kept as ``eager_ms``).
   ``quantize_int8``, ``dequantize_int8``, ``dequant_install`` and the
   residual of ``fedagg_dequant`` must be bit-equal to their plain
   versions, and the quantized values and scales equal to the numpy int8
   rule;
3. the first slice's path through the port's own entry point: a
   full-width SA-Net (11 channels, 24 filters, 4 levels, 128^3 OpenKBP
   volumes) trained by 4-site FedAvg for 2 sync rounds, with random
   weights from a seed, TF32 convolutions (the port's choice, as the
   reference's XLA on this card); then the same job with fp32 convolutions,
   each round's losses, their gap and ``step_s`` printed side by side;
4. this slice's path: the same job with int8 uploads and downloads
   (``compression="int8", down_compression="int8"``), with its exact
   byte counts per round and every kernel of the path launched in every
   round;
5. the wire codec: the full-width global model encoded with ``Int8Codec``
   on the card and decoded there, against the plain encoder and decoder;
6. small jobs run on the card and on the CPU (the plain versions):
   uncompressed, int8 up only, int8 both ways and int8 down only;
   per-round losses must agree, and each side's bytes must be its own
   layout's;
7. the third slice's path: the full-width job under Byzantine-robust
   aggregation (``aggregator="trimmed:1"``, one sign-flipping site,
   ``max_dropout=1``), with ``trimmed_mean`` launched once per round,
   ``fedagg`` once (the final global) and no int8 kernel.  Phase 2 holds
   ``trimmed_mean`` bit for bit to its plain version (NaN where it has
   NaN) over 9 site counts, 4 widths, up to 4 trim depths and 4 active patterns,
   with non-finite values in active and inactive rows, and at full width;
8. small robust jobs on the card and on the CPU (4 sites, ``max_dropout=1``,
   3 rounds, TF32 off): trimmed:1 + sign_flip:1, median + label_flip:1,
   krum:1 + scale:3:1 (the same rows picked on both sides), normclip with
   a binding clip, median + uniform:3 sampling, and int8 uploads +
   poisson:0.75 sampling; per-round losses and participants must agree;
9. the fourth slice's paths: serving the token models at full width
   through ``launch/serve.py`` (prefill, then greedy decode, fp32
   weights from a seed, TF32 off): gemma3-1b (26 layers, 4 x 1024
   prompts, 32 steps) and rwkv6-7b (32 layers, 4 x 512, 32 steps)
   through ``run()``, and Jamba-1.5-Large cut to 2 layers (Mamba +
   dense FFN, Mamba + MoE; 2 x 512, 16 steps) through ``generate()``.
   Each prefill must launch its kernel once a layer (``flash_attention``
   26 times, ``rwkv6_scan`` 32, ``mamba_scan`` 2), each decode none of
   the three, and every logit must be finite.  Phase 2 holds the three
   kernels to their plain versions at ragged shapes and at these paths'
   full-width shapes (the scans' final states too; ``mamba_scan`` with a
   row of A for each channel, at every threads-a-channel instance, its bound
   the larger of bytes and the operations: the fp32 instructions its SASS
   shows with one exp an entry, on the special-function unit or as a
   software exp2 on the fp32 lanes, whichever balances the two);
10. the five reduced token configs served on the card and on the CPU
   (the plain versions) from the same seeded weights and prompts, TF32
   off: the greedy tokens must be equal and the logits within
   rtol=atol=1e-4.

Every kernel's launch count is zeroed just before each of phases 3-5, 7
and each path of 9, and read just after.  The second-to-last line is a
JSON object with one entry per kernel; the last line is ``{"ok": true,
"device": {...}}``.  Without
CUDA, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROUNDS = 2
FULL_N = 6_844_323                       # full-width SA-Net parameter count
INT8_BYTES = 6_900_148                   # one model, int8, the card's layout
DENSE_BYTES = 4 * FULL_N                 # one model, fp32
FP32_TOL = dict(rtol=1e-6, atol=1e-6)    # FMA contraction and sum order differ
BF16_TOL = dict(rtol=2e-2, atol=2e-2)    # one bf16 rounding of the output
JOB_RTOL = 1e-4                          # card vs CPU losses, TF32 off
# Published peaks (NVIDIA data sheets, dense): memory bytes/s, fp32
# (non-tensor-core) FLOP/s and TF32 tensor-core FLOP/s, by the name
# torch.cuda reports.
PEAKS = {"H100 80GB HBM3": (3.35e12, 67e12, 495e12), "H100 PCIe": (2.0e12, 51e12, 378e12),
         "H100 NVL": (3.9e12, 60e12, 417.5e12), "H200": (4.8e12, 67e12, 495e12)}
# ragged shapes for the int8 kernels: sites x chunk rows x chunk width
# (width 4: the narrowest 16-byte row; 1028: wider than the register path's
# 1024), and one row count that takes more than one grid-stride pass
RAGGED = [(s, rows, c) for s in (1, 3, 4) for rows in (1, 7, 6_797)
          for c in (1, 4, 127, 640, 1024, 1028)] + [(2, 20_000, 4), (1, 40_000, 128)]
# the trimmed mean: site counts (every register width and the shared-memory
# path) and widths (one column, odd, a multiple of 128, many blocks)
TRIM_SITES = (1, 2, 3, 4, 5, 8, 17, 33, 64)
TRIM_WIDTHS = (1, 127, 128, 65_537)
INT8_KERNELS = ("quantize_int8", "dequantize_int8", "fedagg_dequant", "dequant_install")
TOKEN_KERNELS = ("flash_attention", "rwkv6_scan", "mamba_scan")
# flash attention: (batch, q heads, kv heads, Lq, Lk, D, causal, window), ragged
# (no Lq a multiple of any tile), GQA groups 1, 2, 3, 4 and 8, windows
# None/17/45/512, both masks; Lq <= 16 against Lk >= 600 (the group's packed
# rows fill one block), a window edge inside a 32-key stage
FLASH_CASES = [(1, 2, 2, 1, 1, 32, True, None), (2, 4, 2, 37, 37, 32, True, 17),
               (1, 6, 2, 45, 70, 64, True, None), (3, 4, 1, 70, 99, 64, False, None),
               (1, 3, 1, 33, 600, 128, True, 512), (2, 8, 2, 129, 129, 128, False, 17),
               (1, 4, 1, 200, 530, 256, True, 17), (1, 4, 4, 531, 531, 256, True, 512),
               (2, 4, 1, 77, 77, 256, False, 512), (1, 9, 3, 50, 50, 64, True, None),
               (2, 16, 2, 77, 90, 128, True, None), (1, 8, 1, 100, 100, 256, True, 64),
               (1, 4, 1, 16, 640, 256, True, None), (2, 8, 1, 9, 700, 64, True, 300),
               (1, 8, 2, 150, 180, 64, True, 45)]
GEMMA_ATTN = (4, 4, 1, 1024, 1024, 256)           # gemma3-1b's prefill, per layer
# the scans: (batch, heads, L, D) and (batch, L, d_inner, d_state), ragged
# the scans' L: 0, 1, and none a multiple of rwkv6_scan's 16-step stage but 0;
# D 32 with many heads
RWKV_CASES = [(1, 1, 1, 32), (1, 2, 0, 64), (2, 3, 13, 32), (1, 5, 77, 64), (3, 2, 300, 64),
              (2, 40, 45, 32), (1, 64, 100, 32)]
RWKV_FULL = (4, 64, 512, 64)                       # rwkv6-7b's prefill, per layer
# mamba: every threads-a-channel instance (d_state 4, 8, 16, 32, and 5, 12, 20
# between them), d_inner a multiple of 4 (16-byte copies) and not (4-byte),
# and not a multiple of any instance's channels a block (32, 64); L not a
# multiple of the 16-step stage, and 0, 1, 16, 48 (exact stages)
MAMBA_CASES = [(1, 1, 5, 4), (2, 13, 24, 8), (1, 77, 300, 16), (3, 40, 1000, 16),
               (2, 33, 130, 32), (2, 0, 64, 16), (1, 16, 100, 4), (2, 48, 36, 8),
               (1, 70, 68, 32), (2, 100, 4100, 16), (1, 45, 77, 5), (2, 19, 200, 12),
               (1, 33, 44, 20)]
MAMBA_FULL = (2, 512, 16384, 16)                   # Jamba-1.5-Large's prefill, per layer
# the fewest fp32 instructions an exp2 costs off the special-function unit:
# round, reduce, a degree-5 polynomial, the exponent's add (the mamba_scan
# bound lets the exps run on either unit)
SOFT_EXP2_INSTRUCTIONS = 8
# flash attention fp32: the softmax over up to 1024 keys runs in tiles with
# rescaling, against one softmax in the plain version (exp and sums differ)
FLASH_TOL = dict(rtol=1e-5, atol=1e-5)
SCAN_RTOL = 1e-5    # fp32 recurrences; atol 1e-5 of the plain version's largest value:
                    # each output sums D or ds terms in another order, with FMA
SERVE_TOL = dict(rtol=1e-4, atol=1e-4)             # card vs CPU logits, TF32 off
SMALL_ARCHS = ("gemma3-1b", "smollm-135m", "qwen3-8b", "rwkv6-7b", "jamba-1.5-large-398b")


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise SystemExit(f"chip_smoke: no published peak rates for {name!r}")


def _median_ms(run, reps: int) -> float:
    import torch
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def time_ms(fn, warmup: int = 3, reps: int = 25):
    """(device ms, eager ms) of one call of ``fn``: the median of ``reps``
    replays of ``fn`` captured as a CUDA graph, so no host time is in it,
    and the median of ``reps`` eager calls, whose launch costs on the host
    are in it where they exceed the device time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _median_ms(graph.replay, reps), _median_ms(fn, reps)


def measure(torch, name, kernel, plain, library, nbytes: int, flops: int,
            tf32_products: int = 0, ops_ms: float | None = None) -> dict:
    """Device times of one call site (``kernel``/``plain``/``library`` take
    no arguments) beside the bound for ``nbytes`` moved and ``flops`` done:
    at the fp32 rate outside the tensor cores, or, with ``tf32_products``,
    as that many TF32 products of each flop at the tensor cores' TF32 rate;
    ``ops_ms``, where given, is the operations bound itself, reckoned by the
    caller for work that is not all fp32 flops.
    ``eager_ms`` is the kernel's call site with the host in it."""
    mem_rate, fp32_rate, tf32_rate = peaks(torch.cuda.get_device_name(0))
    if tf32_products:
        ops_rate, unit = tf32_rate / tf32_products, f"{tf32_products} TF32 products a flop"
    else:
        ops_rate, unit = fp32_rate, "fp32 outside the tensor cores"
    bytes_ms = 1e3 * nbytes / mem_rate
    if ops_ms is None:
        ops_ms = 1e3 * flops / ops_rate
        ops_what = f"{flops / 1e9:.2f} GFLOP at {ops_rate / 1e12:.1f} TFLOP/s ({unit})"
    else:
        ops_what = "the operations reckoned above"
    bounds = {"bytes": bytes_ms, "operations": ops_ms}
    bound_by = max(bounds, key=bounds.get)
    print(f"{name}: bound by {bound_by}: "
          f"{bytes_ms:.4f} ms for {nbytes / 1e6:.1f} MB at {mem_rate / 1e12:.2f} TB/s, "
          f"{ops_ms:.4f} ms for {ops_what}")
    ms, eager_ms = time_ms(kernel)
    out = {"ms": ms, "plain_ms": time_ms(plain)[0],
           "library_ms": time_ms(library)[0] if library is not None else None,
           "bound_ms": bounds[bound_by], "bound_by": bound_by, "eager_ms": eager_ms}
    lib = "none" if out["library_ms"] is None else f"{out['library_ms']:.4f} ms"
    print(f"{name}: kernel {ms:.4f} ms (eager {eager_ms:.4f} ms), bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_by']}), plain {out['plain_ms']:.4f} ms, "
          f"library {lib}")
    return out


def check_fedagg(torch, fedagg, ref, dev) -> dict:
    """fedagg vs its plain version; returns its entry of the kernels line."""
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(4, FULL_N)] + [(s, n) for s in (1, 3, 16) for n in (1, 127, 65_537)]
    err32 = 0.0
    for s, n in cases:
        w = torch.rand(s, device=dev, generator=gen)
        if s > 1:
            w[1] = 0.0                  # an inactive site's zero-weight row
        w = (w / w.sum()).contiguous()
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            x = torch.randn(s, n, device=dev, generator=gen).to(dtype)
            out = fedagg.fedagg_cuda(x, w)
            torch.cuda.synchronize()
            want = ref.fedagg_ref(x, w)
            torch.testing.assert_close(out.float(), want.float(), **tol)
            err = float((out.float() - want.float()).abs().max())
            if dtype == torch.float32:
                err32 = max(err32, err)
            if n == FULL_N:
                print(f"fedagg [{s}, {n}] {dtype}: max |kernel - plain| = {err:.3e}")
    print(f"fedagg: {len(cases)} shapes x 2 dtypes agree with the plain version "
          f"(fp32 rtol=atol=1e-6, bf16 rtol=atol=2e-2)")
    x = torch.randn(4, FULL_N, device=dev, generator=gen)
    w = torch.full((4,), 0.25, device=dev)
    timing = measure(torch, f"fedagg [4, {FULL_N}] fp32", lambda: fedagg.fedagg_cuda(x, w),
                     lambda: ref.fedagg_ref(x, w), lambda: torch.matmul(w, x),
                     nbytes=(x.numel() + w.numel() + FULL_N) * 4, flops=2 * x.numel())
    return {"max_abs_err": err32, **timing}


def _int8_inputs(torch, dev, s, rows, c, gen):
    """u [S, rows, c] like a site delta, with a zero chunk (the MIN_SCALE
    floor); weights [S] with a zero-weight row; base [S, rows, c]."""
    u = torch.randn(s, rows, c, device=dev, generator=gen) * 0.05
    u[0, 0] = 0.0
    w = torch.rand(s, device=dev, generator=gen)
    if s > 1:
        w[1] = 0.0
    w = (w / w.sum()).contiguous()
    return u, w, torch.randn(s, rows, c, device=dev, generator=gen)


def _numpy_int8(x):
    import numpy as np
    s = np.maximum(np.max(np.abs(x), axis=1) / np.float32(127.0),
                   np.float32(1e-12)).astype(np.float32)
    return np.clip(np.rint(x / s[:, None]), -127, 127).astype(np.int8), s


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: {what}")


def check_int8_kernels(torch, plan, layout, dev) -> dict:
    """The four int8 kernels vs their plain versions at the ragged shapes
    and the full-width chunk groups; returns their kernels-line entries."""
    import numpy as np
    from repro_torch.comms.compression import _as_chunks
    from repro_torch.kernels import fedagg as fk
    from repro_torch.kernels import quantize as qk
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(1)
    full = [(4, rows, width) for width, rows, _ in plan.groups]
    err = {"quantize_int8": 0.0, "dequantize_int8": 0.0, "fedagg_dequant": 0.0,
           "dequant_install": 0.0}
    for s, rows, c in RAGGED + full:
        u, w, base = _int8_inputs(torch, dev, s, rows, c, gen)
        x = u.view(s * rows, c)
        q, sc = qk.quantize_int8_cuda(x)
        deq = qk.dequantize_int8_cuda(q, sc)
        q3, sc2 = q.view(s, rows, c), sc.view(s, rows)
        g, r = fk.fedagg_dequant_cuda(q3, sc2, u, w)
        inst = fk.dequant_install_cuda(q3, sc2, base)
        torch.cuda.synchronize()
        q_ref, sc_ref = ref.quantize_int8_ref(x)
        deq_ref = ref.dequantize_int8_ref(q, sc)
        g_ref, r_ref = ref.fedagg_dequant_ref(q3, sc2, u, w)
        inst_ref = ref.dequant_install_ref(q3, sc2, base)
        for name, diffs in (("quantize_int8", (q.int() - q_ref.int(), sc - sc_ref)),
                            ("dequantize_int8", (deq - deq_ref,)),
                            ("fedagg_dequant", (g - g_ref, r - r_ref)),
                            ("dequant_install", (inst - inst_ref,))):
            err[name] = max([err[name]] + [float(d.abs().max()) for d in diffs])
        where = f"[{s}, {rows}, {c}]"
        _require(torch.equal(q, q_ref) and torch.equal(sc, sc_ref),
                 f"quantize_int8 {where} differs from its plain version")
        q_np, sc_np = _numpy_int8(x.cpu().numpy())
        _require(np.array_equal(q.cpu().numpy(), q_np)
                 and np.array_equal(sc.cpu().numpy(), sc_np),
                 f"quantize_int8 {where} differs from the numpy int8 rule")
        _require(float(sc[0]) == float(np.float32(1e-12)), "zero chunk: scale not the floor")
        _require(torch.equal(deq, deq_ref), f"dequantize_int8 {where} differs from its plain version")
        _require(torch.equal(r, r_ref),
                 f"fedagg_dequant residual {where} differs from its plain version")
        torch.testing.assert_close(g, g_ref, **FP32_TOL)
        _require(torch.equal(inst, inst_ref), f"dequant_install {where} differs from its plain version")
    # rows off a 16-byte boundary take the kernel's generic path
    width, rows = full[0][2], full[0][1]
    x = (torch.randn(rows * width + 1, device=dev, generator=gen) * 0.05)[1:].view(rows, width)
    q, sc = qk.quantize_int8_cuda(x)
    q_ref, sc_ref = ref.quantize_int8_ref(x)
    where = f"quantize_int8 [{rows}, {width}] off a 16-byte boundary"
    _require(x.data_ptr() % 16 != 0, f"{where}: the view is on a 16-byte boundary")
    _require(torch.equal(sc, sc_ref), f"{where}: scales differ from its plain version")
    _require(torch.equal(q, q_ref), f"{where}: q differs from its plain version")
    print(f"int8 kernels: {len(RAGGED)} ragged shapes and {len(full)} full-width chunk "
          "groups agree with the plain versions (bit-equal; fedagg_dequant's g "
          f"rtol=atol=1e-6, max |err| {err['fedagg_dequant']:.3e}) and the numpy rule")

    # times at the full-width path's shapes: one call site runs every group
    mats = [_int8_inputs(torch, dev, s, rows, c, gen) for s, rows, c in full]
    xs = [u.view(-1, u.shape[-1]) for u, _, _ in mats]
    qs = [qk.quantize_int8_cuda(x) for x in xs]
    q3s = [(q.view(u.shape), sc.view(u.shape[:2])) for (q, sc), (u, _, _) in zip(qs, mats)]
    elems = sum(x.numel() for x in xs)
    rows_all = sum(x.shape[0] for x in xs)
    n_out = sum(u.shape[1] * u.shape[2] for u, _, _ in mats)
    out = {}
    out["quantize_int8"] = measure(
        torch, f"quantize_int8 x{len(xs)} groups [{elems} elements]",
        lambda: [qk.quantize_int8_cuda(x) for x in xs],
        lambda: [ref.quantize_int8_ref(x) for x in xs], None,
        nbytes=elems * 5 + rows_all * 4, flops=6 * elems)
    out["fedagg_dequant"] = measure(
        torch, f"fedagg_dequant x{len(xs)} groups [{elems} site-elements]",
        lambda: [fk.fedagg_dequant_cuda(q, sc, u, w) for (q, sc), (u, w, _) in zip(q3s, mats)],
        lambda: [ref.fedagg_dequant_ref(q, sc, u, w) for (q, sc), (u, w, _) in zip(q3s, mats)],
        None, nbytes=elems * 9 + rows_all * 4 + n_out * 4 + 16 * len(xs), flops=4 * elems)
    out["dequant_install"] = measure(
        torch, f"dequant_install x{len(xs)} groups [{elems} site-elements]",
        lambda: [fk.dequant_install_cuda(q, sc, b) for (q, sc), (_, _, b) in zip(q3s, mats)],
        lambda: [ref.dequant_install_ref(q, sc, b) for (q, sc), (_, _, b) in zip(q3s, mats)],
        lambda: [torch.addcmul(b, q, sc[..., None]) for (q, sc), (_, _, b) in zip(q3s, mats)],
        nbytes=elems * 9 + rows_all * 4, flops=2 * elems)
    # the codec decodes one model leaf by leaf, in the card's layout
    leaves = [qk.quantize_int8_cuda(_as_chunks(torch.randn(
        int(np.prod(sh)), device=dev, generator=gen) * 0.05, 1024, 128))
        for sh in layout.shapes]
    d_elems = sum(q.numel() for q, _ in leaves)
    d_rows = sum(q.shape[0] for q, _ in leaves)
    out["dequantize_int8"] = measure(
        torch, f"dequantize_int8 x{len(leaves)} leaves [{d_elems} elements]",
        lambda: [qk.dequantize_int8_cuda(q, sc) for q, sc in leaves],
        lambda: [ref.dequantize_int8_ref(q, sc) for q, sc in leaves],
        lambda: [torch.mul(q, sc[:, None]) for q, sc in leaves],
        nbytes=d_elems * 5 + d_rows * 4, flops=d_elems)
    return {name: {"max_abs_err": err[name], **out[name]} for name in out}


def _bits_equal(torch, a, b) -> bool:
    """Bit for bit, with NaN (of any payload) exactly where ``b`` has NaN."""
    nan = b.isnan()
    return (torch.equal(a.isnan(), nan)
            and torch.equal(torch.where(nan, 0.0, a).view(torch.int32),
                            torch.where(nan, 0.0, b).view(torch.int32)))


def _trim_cases(torch, dev, s, n, gen):
    """[S, N] fp32 with NaN and +-inf in active and inactive rows, and the
    active patterns: all, one inactive, one active (k = 1), none (k = 0)."""
    x = torch.randn(s, n, device=dev, generator=gen) * 3.0
    if n >= 8:
        x[0, 0] = float("nan")
        x[s - 1, 1] = float("inf")
        x[0, 2] = -float("inf")
        x[s // 2, 3] = float("nan")        # inactive in the one-inactive pattern
        x[:, 4] = float("inf")
        if s > 1:
            x[1, 5] = -float("inf")
            x[1, 6] = float("nan")
    one = torch.ones(s, device=dev)
    one[s // 2] = 0.0
    k1 = torch.zeros(s, device=dev)
    k1[s - 1] = 1.0
    return x, (torch.ones(s, device=dev), one, k1, torch.zeros(s, device=dev))


def check_trimmed_mean(torch, dev) -> dict:
    """trimmed_mean (and the median, f = S) vs its plain version, bit for
    bit, at ragged shapes and at full width; returns its kernels-line entry."""
    from repro_torch.kernels import ref, robust
    gen = torch.Generator(device=dev).manual_seed(2)
    err, cases = 0.0, 0
    shapes = [(s, n) for s in TRIM_SITES for n in TRIM_WIDTHS] + [(4, FULL_N)]
    for s, n in shapes:
        x, patterns = _trim_cases(torch, dev, s, n, gen)
        depths = sorted({0, 1, 2, s}) if n != FULL_N else [1, s]
        for a in patterns if n != FULL_N else patterns[:2]:
            for f in depths:
                out = robust.trimmed_mean_cuda(x, a, f)
                torch.cuda.synchronize()
                want = ref.trimmed_mean_ref(x, a, f)
                finite = want.isfinite() & out.isfinite()
                err = max(err, float((out - want)[finite].abs().max()) if finite.any() else 0.0)
                _require(_bits_equal(torch, out, want),
                         f"trimmed_mean [{s}, {n}] f={f} active={a.tolist() if s < 9 else int(a.sum())}"
                         " differs from its plain version")
                cases += 1
    print(f"trimmed_mean: {cases} cases ({len(TRIM_SITES)} site counts x {len(TRIM_WIDTHS)} "
          f"widths x trim depths x active patterns, non-finite values, full width "
          f"f=1 and median) bit-equal to the plain version")

    x = torch.randn(4, FULL_N, device=dev, generator=gen)
    a = torch.ones(4, device=dev)
    nbytes = (x.numel() + FULL_N + 4) * 4

    def ops_of(f):    # per column: the sort's compare-swaps, kept adds, a divide
        fe = min(f, 3 // 2)
        return FULL_N * (6 + (4 - 2 * fe) + 1)
    timing = measure(torch, f"trimmed_mean [4, {FULL_N}] f=1",
                     lambda: robust.trimmed_mean_cuda(x, a, 1),
                     lambda: ref.trimmed_mean_ref(x, a, 1), None,
                     nbytes=nbytes, flops=ops_of(1))
    try:
        torch.quantile(x, 0.5, dim=0, interpolation="midpoint")
        library, why = (lambda: torch.quantile(x, 0.5, dim=0, interpolation="midpoint")), None
    except RuntimeError as e:
        library, why = None, str(e).splitlines()[0]
        print(f"masked_median: no library time: torch.quantile refused [4, {FULL_N}]: {why}")
    median = measure(torch, f"masked_median [4, {FULL_N}] (trimmed_mean f=4)",
                     lambda: robust.trimmed_mean_cuda(x, a, 4),
                     lambda: ref.masked_median_ref(x, a), library,
                     nbytes=nbytes, flops=ops_of(4))
    if why is not None:
        median["library_refused"] = why
    return {"max_abs_err": err, **timing, "median": median}


def _history(result) -> None:
    for h in result.history:
        extra = "".join(f" {k} {h[k]}" for k in ("upload_bytes", "download_bytes") if k in h)
        print(f"round {h['round']}: active {h['active']} loss {h['loss']:.6f} per-site "
              f"{[round(v, 6) for v in h['per_site_loss']]} batch_s "
              f"{h['batch_s']:.4f} step_s {h['step_s']:.4f} wall_s {h['wall_s']:.4f}{extra}")


def _check_result(torch, result, what: str) -> None:
    n_params = sum(t.numel() for t in _leaves(result.global_params))
    _require(all(math.isfinite(v) for h in result.history for v in h["per_site_loss"]),
             f"non-finite loss on {what}")
    _require(n_params == FULL_N, f"expected {FULL_N} parameters on {what}, got {n_params}")
    _require(all(bool(torch.isfinite(t).all()) for t in _leaves(result.global_params)),
             f"non-finite global parameters on {what}")


def run_main_path(torch, FederatedJob, TaskConfig, build, task) -> dict:
    """The first slice's path: full-width FedAvg, uncompressed, with TF32
    convolutions (what the reference's XLA does with fp32 convolutions on
    this card; see ``models/sanet.py``); then the same job, from the same
    seeded initial parameters and batches, with fp32 convolutions, to
    record how far the losses lie apart and what fp32 costs a round."""
    torch.backends.cudnn.allow_tf32 = True         # the port's choice, stated
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default, stated
    print("main path: cudnn.allow_tf32=True, matmul.allow_tf32=False")
    job = FederatedJob(task=TaskConfig(**task), strategy="fedavg", rounds=ROUNDS)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    result = job.run()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    _history(result)
    print(f"main path: {ROUNDS} rounds in {wall:.1f} s with set-up, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"kernels launched on the main path: {launches}")
    _check_result(torch, result, "the main path")
    _require(launches.get("fedagg", 0) >= ROUNDS,
             f"fedagg launched {launches.get('fedagg', 0)} times on the main path")

    torch.backends.cudnn.allow_tf32 = False
    fp32 = job.run()
    torch.backends.cudnn.allow_tf32 = True
    _check_result(torch, fp32, "the main path with fp32 convolutions")
    for tf, fp in zip(result.history, fp32.history):
        gap = abs(tf["loss"] - fp["loss"]) / abs(fp["loss"])
        print(f"main path round {tf['round']}: loss TF32 {tf['loss']:.6f} fp32 "
              f"{fp['loss']:.6f} (relative gap {gap:.3e}); step_s TF32 {tf['step_s']:.4f} "
              f"fp32 {fp['step_s']:.4f}")
    return launches


def run_int8_path(torch, FederatedJob, TaskConfig, build, task):
    """This slice's path: full-width FedAvg with int8 uploads and
    downloads; returns (its launches, the result)."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    job = FederatedJob(task=TaskConfig(**task), strategy="fedavg", rounds=ROUNDS,
                       compression="int8", down_compression="int8")
    per_round = []
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    result = job.run(on_round=lambda r: per_round.append(dict(build.LAUNCHES)))
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    _history(result)
    print(f"int8 path: {ROUNDS} rounds in {wall:.1f} s with set-up, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, comm {result.comm}")
    print(f"kernels launched on the int8 path: {launches}; after each round: {per_round}")
    _check_result(torch, result, "the int8 path")
    sites = task["sites"]
    for r, h in enumerate(result.history):
        prev = per_round[r - 1] if r else {}
        for name in ("quantize_int8", "fedagg_dequant", "dequant_install", "fedagg"):
            _require(per_round[r].get(name, 0) > prev.get(name, 0),
                     f"{name} not launched in round {r} of the int8 path")
        _require(h["upload_bytes"] == sites * INT8_BYTES,
                 f"round {r} upload_bytes {h['upload_bytes']} != {sites * INT8_BYTES}")
        want = sites * (DENSE_BYTES if r == 0 else INT8_BYTES)   # round 0 bootstraps
        _require(h["download_bytes"] == want,
                 f"round {r} download_bytes {h['download_bytes']} != {want}")
    return launches, result


def check_codec(torch, build, global_params) -> dict:
    """The wire codec on the card: encode the full-width global with
    ``Int8Codec`` (the kernel), decode it on the card, and hold both to
    the plain encoder and decoder; returns the phase's launches."""
    import numpy as np
    from repro_torch.comms.compression import (Int8Codec, _as_chunks, decode_array,
                                               tree_payload_nbytes)
    from repro_torch.kernels import ref
    params = _leaves(global_params)
    build.reset_launches()
    enc = _leaves(Int8Codec().encode_tree(global_params))
    dec = [decode_array(qt, device="cuda") for qt in enc]
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    nbytes = tree_payload_nbytes(enc)
    print(f"codec: {len(enc)} leaves, {nbytes} payload bytes; launches {launches}")
    _require(nbytes == INT8_BYTES, f"codec payload {nbytes} bytes, expected {INT8_BYTES}")
    for p, qt, d in zip(params, enc, dec):
        q, s = ref.quantize_int8_ref(_as_chunks(p.reshape(-1), 1024, 128))
        _require(np.array_equal(qt.data["q"], q.cpu().numpy())
                 and np.array_equal(qt.data["scale"], s.cpu().numpy()),
                 "codec payload differs from the plain encoder's")
        _require(d.shape == p.shape and torch.equal(d.cpu(), decode_array(qt, device="cpu")),
                 "codec decode on the card differs from the plain decode")
    _require(launches.get("dequantize_int8", 0) == len(enc), "dequantize_int8 not launched")
    return launches


def check_small_jobs(torch, FederatedJob, TaskConfig) -> None:
    """The same small jobs on the card and on the CPU (plain versions);
    the CPU path is held to the JAX reference by tests/test_torch_job.py
    and tests/test_torch_compression.py.  TF32 off so both sides compute
    in fp32; tolerance 1e-4 relative, since sum orders differ and AdamW's
    first step amplifies noise on near-zero gradients.  The int8 jobs'
    bytes are each layout's own: align 128 on the card, align 1 on the
    CPU (the same values, other padding)."""
    from repro_torch.core.round_engine import bootstrap_masks, encoded_nbytes
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    base = FederatedJob(task=TaskConfig(kind="dose", sites=3, batch=2), rounds=3,
                        max_dropout=1)
    for codecs in (("none", "none"), ("int8", "none"), ("int8", "int8"), ("none", "int8")):
        job = base.replace(compression=codecs[0], down_compression=codecs[1])
        gpu, cpu = job.run(), job.replace(device="cpu").run()
        print(f"small job {codecs}: losses cuda {gpu.losses} cpu {cpu.losses}")
        for g, c in zip(gpu.losses, cpu.losses):
            _require(math.isclose(g, c, rel_tol=JOB_RTOL, abs_tol=1e-6),
                     f"small job {codecs}: cuda loss {g} != cpu loss {c}")
        if codecs == ("none", "none"):
            continue
        masks = job.masks(job.rounds)
        boot = bootstrap_masks(masks, 16)
        shapes = [tuple(t.shape) for t in _leaves(cpu.global_params)]
        dense = 4 * sum(math.prod(sh) for sh in shapes)
        for res, align in ((gpu, 128), (cpu, 1)):
            enc = encoded_nbytes(shapes, 1024, align)
            up = enc if codecs[0] == "int8" else dense
            for r, h in enumerate(res.history):
                _require(h["upload_bytes"] == int(masks[r].sum()) * up,
                         f"small job {codecs} align {align}: round {r} upload bytes")
                if codecs[1] == "int8":
                    want = sum(dense if b else enc for a, b in zip(masks[r], boot[r]) if a)
                    _require(h["download_bytes"] == want,
                             f"small job {codecs} align {align}: round {r} download bytes")
        print(f"small job {codecs}: bytes per round cuda "
              f"{[(h['upload_bytes'], h.get('download_bytes')) for h in gpu.history]} cpu "
              f"{[(h['upload_bytes'], h.get('download_bytes')) for h in cpu.history]}")


def run_robust_path(torch, FederatedJob, TaskConfig, build, task) -> dict:
    """This slice's path: full-width FedAvg under trimmed:1 with one
    sign-flipping site and Algorithm-2 churn; returns its launches."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    job = FederatedJob(task=TaskConfig(**task), strategy="fedavg", rounds=ROUNDS,
                       aggregator="trimmed:1", adversary="sign_flip:1", max_dropout=1)
    per_round = []
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    result = job.run(on_round=lambda r: per_round.append(dict(build.LAUNCHES)))
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    _history(result)
    print(f"robust path: {ROUNDS} rounds in {wall:.1f} s with set-up, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, malicious sites "
          f"{job.adversary_plan.malicious_mask(task['sites']).nonzero()[0].tolist()}")
    print(f"kernels launched on the robust path: {launches}; after each round: {per_round}")
    _check_result(torch, result, "the robust path")
    for r in range(ROUNDS):
        _require(per_round[r].get("trimmed_mean", 0) == r + 1,
                 f"trimmed_mean not launched once in round {r} of the robust path")
        _require(per_round[r].get("fedagg", 0) == 0,
                 f"fedagg launched in round {r} of the robust path")
    _require(launches.get("fedagg", 0) == 1,
             f"fedagg launched {launches.get('fedagg', 0)} times, not once (the final global)")
    _require(not any(launches.get(k, 0) for k in INT8_KERNELS),
             "an int8 kernel was launched on the robust path")
    return launches


def check_robust_small_jobs(torch, FederatedJob, TaskConfig, build) -> None:
    """Small robust jobs on the card and on the CPU (plain versions), as
    :func:`check_small_jobs`; the CPU path is held to the JAX reference by
    tests/test_torch_robust.py.  Krum's picks are recorded on both sides."""
    from repro_torch.core import agg_engine
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"robust small jobs: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}; krum's x @ x.T runs in "
          "full fp32 whatever the flag")
    base = FederatedJob(task=TaskConfig(kind="dose", sites=4, batch=2), rounds=3,
                        max_dropout=1)
    picks = []
    krum_index = agg_engine.krum_index

    def recording(flat, active, f):
        idx = krum_index(flat, active, f)
        picks.append(int(idx))
        return idx
    variants = [dict(aggregator="trimmed:1", adversary="sign_flip:1"),
                dict(aggregator="median", adversary="label_flip:1"),
                dict(aggregator="krum:1", adversary="scale:3:1"),
                dict(aggregator="normclip:15"),        # the init's norm is 21.5
                dict(aggregator="median", sample="uniform:3"),
                dict(compression="int8", sample="poisson:0.75")]
    agg_engine.krum_index = recording
    try:
        for kw in variants:
            job = base.replace(**kw)
            picks.clear()
            before = build.LAUNCHES.get("trimmed_mean", 0)
            gpu = job.run()
            launched = build.LAUNCHES.get("trimmed_mean", 0) - before
            cpu = job.replace(device="cpu").run()
            print(f"small robust job {kw}: active {[h['active'] for h in gpu.history]}, "
                  f"losses cuda {gpu.losses} cpu {cpu.losses}"
                  + (f", krum picks cuda {picks[:3]} cpu {picks[3:]}" if picks else ""))
            _require([h["active"] for h in gpu.history] == [h["active"] for h in cpu.history],
                     f"small robust job {kw}: participants differ")
            for g, c in zip(gpu.losses, cpu.losses):
                _require(math.isclose(g, c, rel_tol=JOB_RTOL, abs_tol=1e-6),
                         f"small robust job {kw}: cuda loss {g} != cpu loss {c}")
            rank = job.aggregator_spec.name in ("trimmed", "median")
            _require(launched == (job.rounds if rank else 0),
                     f"small robust job {kw}: trimmed_mean launched {launched} times")
            if job.aggregator_spec.name == "krum":
                _require(len(picks) == 2 * job.rounds and picks[:3] == picks[3:],
                         f"small robust job {kw}: krum picked {picks[:3]} on the card, "
                         f"{picks[3:]} on the CPU")
    finally:
        agg_engine.krum_index = krum_index

# -- the token models' kernels and serving paths ---------------------------------


def _flash_inputs(torch, dev, case, dtype, gen):
    b, hq, hkv, lq, lk, d = case[:6]
    return (torch.randn(b, hq, lq, d, device=dev, generator=gen).to(dtype),
            torch.randn(b, hkv, lk, d, device=dev, generator=gen).to(dtype),
            torch.randn(b, hkv, lk, d, device=dev, generator=gen).to(dtype))


def _attn_mask(torch, dev, lq, lk, causal, window):
    """[Lq, Lk] bool, True where a key is seen (the kernel's mask)."""
    q_pos = torch.arange(lq, device=dev)[:, None] + (lk - lq)
    k_pos = torch.arange(lk, device=dev)[None, :]
    ok = torch.ones((lq, lk), dtype=torch.bool, device=dev)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    return ok


def check_flash_attention(torch, dev) -> dict:
    """flash_attention vs its plain version at ragged shapes (both dtypes)
    and at gemma3-1b's per-layer shape with window 512 and with none;
    returns its kernels-line entry (the global layer, fp32)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    gen = torch.Generator(device=dev).manual_seed(3)
    err = 0.0
    full = [GEMMA_ATTN + (True, 512), GEMMA_ATTN + (True, None)]
    for case in FLASH_CASES + full:
        causal, window = case[6:]
        for dtype, tol in ((torch.float32, FLASH_TOL), (torch.bfloat16, BF16_TOL)):
            q, k, v = _flash_inputs(torch, dev, case, dtype, gen)
            out = flash_attention_cuda(q, k, v, causal, window)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, causal, window)
            torch.testing.assert_close(out.float(), want.float(), **tol)
            if dtype == torch.float32:
                err = max(err, float((out - want).abs().max()))
    print(f"flash_attention: {len(FLASH_CASES) + len(full)} shapes x 2 dtypes agree with "
          f"the plain version (fp32 rtol=atol=1e-5, max |err| {err:.3e}; bf16 2e-2)")
    out = {}
    b, hq, hkv, lq, lk, d = GEMMA_ATTN
    for window in (512, None):
        q, k, v = _flash_inputs(torch, dev, GEMMA_ATTN, torch.float32, gen)
        mask = _attn_mask(torch, dev, lq, lk, True, window)
        pairs = int(mask.sum()) * b * hq                 # the (query, key) pairs seen
        lib = F.scaled_dot_product_attention(q, k.repeat_interleave(hq // hkv, 1),
                                             v.repeat_interleave(hq // hkv, 1),
                                             attn_mask=mask)
        lib_err = float((lib - ref.flash_attention_ref(q, k, v, True, window)).abs().max())
        out[window] = measure(
            torch, f"flash_attention {list(GEMMA_ATTN)} fp32 causal window={window}",
            lambda: flash_attention_cuda(q, k, v, True, window),
            lambda: ref.flash_attention_ref(q, k, v, True, window),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True),
            nbytes=4 * 2 * (q.numel() + k.numel()), flops=4 * d * pairs, tf32_products=3)
        out[window]["library_max_abs_err"] = lib_err
        print(f"  scaled_dot_product_attention vs the plain version: max |err| {lib_err:.3e}")
    return {"max_abs_err": err, **out[None], "window_512": out[512]}


def kernel_resources(build) -> None:
    """Registers, local memory, shared memory and blocks an SM of every
    instance of the four redesigned kernels, as ``cudaFuncGetAttributes`` and
    the occupancy calculator give them (each source's ``*_resources``)."""
    import ctypes
    from repro_torch.kernels import flash_attention, rwkv6_scan
    out = (ctypes.c_int * 5)()

    def report(what, err):
        _require(err == 0, f"{what}: CUDA error {err}")
        regs, local, smem, threads, blocks = out
        print(f"{what}: {regs} registers, local {local} B, shared {smem} B, "
              f"{threads} threads, {blocks} blocks an SM")
    for mod in (flash_attention, rwkv6_scan):
        fn = build.entry(mod.NAME, f"{mod.NAME}_resources",
                         [ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int)])
        for d in mod.HEAD_DIMS:
            for bf16 in (0, 1):
                report(f"{mod.NAME} D={d} {'bf16' if bf16 else 'fp32'}", fn(d, bf16, out))
    one = [ctypes.c_int64, ctypes.POINTER(ctypes.c_int)]
    fn = build.entry("mamba_scan", "mamba_scan_resources", one)
    for ds in (4, 8, 16, 32):          # the instance of each threads-a-channel split
        report(f"mamba_scan d_state<={ds}", fn(ds, out))
    fn = build.entry("quantize_int8", "quantize_int8_resources", one)
    for c in (128, 256, 512, 1024, 1028):  # the register path's width classes, then any
        report(f"quantize_int8 width {c}", fn(c, out))


def _rwkv_inputs(torch, dev, shape, dtype, gen):
    b, h, l, d = shape
    r, k, v = (torch.randn(b, h, l, d, device=dev, generator=gen) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(b, h, l, d, device=dev, generator=gen) - 5.0))
    u = torch.randn(h, d, device=dev, generator=gen) * 0.1
    return [t.to(dtype) for t in (r, k, v, w)] + [u]


def _close_scaled(torch, got, want, what: str) -> float:
    """got vs want within SCAN_RTOL, atol SCAN_RTOL of want's largest value."""
    scale = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got.float(), want.float(), rtol=SCAN_RTOL,
                               atol=SCAN_RTOL * max(scale, 1.0), msg=lambda m: f"{what}: {m}")
    return float((got.float() - want.float()).abs().max()) if want.numel() else 0.0


def check_rwkv6_scan(torch, dev) -> dict:
    """rwkv6_scan (out and final state) vs its plain version at ragged
    shapes and rwkv6-7b's per-layer shape; returns its kernels-line entry."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda
    gen = torch.Generator(device=dev).manual_seed(4)
    err = 0.0
    for shape in RWKV_CASES + [RWKV_FULL]:
        for dtype in (torch.float32, torch.bfloat16):
            xs = _rwkv_inputs(torch, dev, shape, dtype, gen)
            out, state = rwkv6_scan_cuda(*xs)
            torch.cuda.synchronize()
            w_out, w_state = ref.rwkv6_scan_ref(*xs)
            if dtype == torch.float32:
                err = max(err, _close_scaled(torch, out, w_out, f"rwkv6_scan out {shape}"),
                          _close_scaled(torch, state, w_state, f"rwkv6_scan state {shape}"))
            else:        # the state is fp32 either way; out is rounded to bf16 once
                _close_scaled(torch, state, w_state, f"rwkv6_scan bf16 state {shape}")
                torch.testing.assert_close(out.float(), w_out.float(), **BF16_TOL)
    print(f"rwkv6_scan: {len(RWKV_CASES) + 1} shapes x 2 dtypes, out and final state, agree "
          f"with the plain version (rtol {SCAN_RTOL}, atol {SCAN_RTOL} of the largest value; "
          f"max |err| {err:.3e})")
    b, h, l, d = RWKV_FULL
    xs = _rwkv_inputs(torch, dev, RWKV_FULL, torch.float32, gen)
    print("rwkv6_scan: no library time: no one PyTorch call computes the WKV-6 recurrence")
    timing = measure(torch, f"rwkv6_scan {list(RWKV_FULL)} fp32",
                     lambda: rwkv6_scan_cuda(*xs), lambda: ref.rwkv6_scan_ref(*xs), None,
                     nbytes=4 * (5 * b * h * l * d + h * d + b * h * d * d),
                     flops=5 * b * h * l * d * d)   # k v, the S update, r S
    return {"max_abs_err": err, **timing}


def _mamba_inputs(torch, dev, shape, gen):
    import torch.nn.functional as F
    b, l, di, ds = shape
    dt = F.softplus(torch.randn(b, l, di, device=dev, generator=gen) - 3.0)
    bm, cm = (torch.randn(b, l, ds, device=dev, generator=gen) for _ in range(2))
    x = torch.randn(b, l, di, device=dev, generator=gen)
    # a row of A for each channel: log(1..ds) plus N(0, 0.1), so a kernel
    # that reads another channel's row disagrees
    log_a = torch.log(torch.arange(1, ds + 1, device=dev, dtype=torch.float32)).expand(di, ds)
    log_a = log_a + 0.1 * torch.randn(di, ds, device=dev, generator=gen)
    return dt, bm, cm, x, log_a.contiguous()


def check_mamba_scan(torch, dev) -> dict:
    """mamba_scan (y and final state) vs its plain version at ragged shapes
    and Jamba-1.5-Large's per-layer shape, with a row of A for each
    channel; returns its kernels-line entry, with its bound the largest of
    the bytes, the fp32 instructions the SASS shows and the ex2s."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.mamba_scan import mamba_scan_cuda
    gen = torch.Generator(device=dev).manual_seed(5)
    err = 0.0
    for shape in MAMBA_CASES + [MAMBA_FULL]:
        xs = _mamba_inputs(torch, dev, shape, gen)
        y, state = mamba_scan_cuda(*xs)
        torch.cuda.synchronize()
        w_y, w_state = ref.mamba_scan_ref(*xs)
        err = max(err, _close_scaled(torch, y, w_y, f"mamba_scan y {shape}"),
                  _close_scaled(torch, state, w_state, f"mamba_scan state {shape}"))
    print(f"mamba_scan: {len(MAMBA_CASES) + 1} shapes, y and final state, agree with the "
          f"plain version (rtol {SCAN_RTOL}, atol {SCAN_RTOL} of the largest value; "
          f"max |err| {err:.3e})")
    b, l, di, ds = MAMBA_FULL
    xs = _mamba_inputs(torch, dev, MAMBA_FULL, gen)
    entries = b * l * di * ds                     # state entries a step, summed over steps
    fp32_per_entry, ex2 = _mamba_sass_counts(build, ds)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(_smi("clocks.max.sm"))
    clock_ms = 1e3 / (sms * mhz * 1e6)            # one clock of every SM
    sfu_ms = entries / 16 * clock_ms              # every exp a MUFU.EX2, 16 a clock an SM
    frac, per_entry = _issue_sfu_floor(fp32_per_entry)
    ops_ms = entries * per_entry * clock_ms
    print(f"mamba_scan: the SASS of the d_state<={ds} instance has {fp32_per_entry:.2f} fp32 "
          f"instructions (FFMA, FMUL, FADD) per MUFU.EX2 ({ex2} of those); {sms} SMs at "
          f"{mhz:.0f} MHz (clocks.max.sm). Every exp on the special-function unit (16 a "
          f"clock an SM) would take {sfu_ms:.4f} ms, a floor of this design, not of the "
          f"scan: with {frac:.1%} of the exps as a {SOFT_EXP2_INSTRUCTIONS}-instruction "
          f"software exp2 on the fp32 lanes, issue (128 lanes a clock an SM, a MUFU one "
          f"slot) and SFU balance at {per_entry * 128:.2f} slots an entry, {ops_ms:.4f} ms")
    print("mamba_scan: no library time: no one PyTorch call computes the selective scan")
    timing = measure(torch, f"mamba_scan {list(MAMBA_FULL)} fp32",
                     lambda: mamba_scan_cuda(*xs), lambda: ref.mamba_scan_ref(*xs), None,
                     nbytes=4 * (3 * b * l * di + 2 * b * l * ds + di * ds + b * di * ds),
                     flops=0, ops_ms=ops_ms)
    return {"max_abs_err": err, **timing, "fp32_instructions_per_entry": fp32_per_entry,
            "sfu_ms": sfu_ms}


def _issue_sfu_floor(fp32: float, soft: int = SOFT_EXP2_INSTRUCTIONS):
    """(the share of exps taken off the SFU, clocks an SM per state entry)
    for a scan that needs ``fp32`` fp32 instructions and one exp an entry,
    when each exp may be a MUFU.EX2 (one issue slot, and the SFU's 16 lanes
    a clock an SM) or a software exp2 of ``soft`` instructions on the fp32
    lanes (128 slots a clock an SM): the share f that balances issue,
    (fp32 + 1 + f * (soft - 1)) / 128, against the SFU, (1 - f) / 16."""
    f = max(0.0, (7.0 - fp32) / (soft + 7.0))
    return f, max((fp32 + 1 + f * (soft - 1)) / 128, (1 - f) / 16)


def _smi(field: str) -> str:
    return subprocess.run(["nvidia-smi", "-i", "0", f"--query-gpu={field}",
                           "--format=csv,noheader,nounits"], capture_output=True,
                          text=True, check=True).stdout.strip()


def _mamba_sass_counts(build, ds: int):
    """(fp32 instructions per MUFU.EX2, MUFU.EX2 count) in the SASS of the
    mamba_scan instance that takes ``ds`` (its template arguments: threads a
    channel, states a thread), from ``cuobjdump -sass`` on the built library.
    The step loop is unrolled, with one ex2 an entry; the few ex2 of the
    prologue's A count in with them."""
    import re
    threads, per = {4: (2, 2), 8: (2, 4), 16: (2, 8), 32: (4, 8)}[ds]
    cuobjdump = Path(build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.library_path("mamba_scan"))],
                          capture_output=True, text=True, check=True).stdout
    tag = f"mamba_scan_kernelILi{threads}ELi{per}E"
    funcs = [f for f in re.split(r"\n\s*Function : ", sass)[1:] if tag in f.split("\n", 1)[0]]
    _require(len(funcs) == 1, f"mamba_scan: {len(funcs)} SASS functions named {tag}")
    ops = re.findall(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", funcs[0], re.M)
    ex2 = sum(o.startswith("MUFU.EX2") for o in ops)
    fp32 = sum(o.split(".")[0] in ("FFMA", "FMUL", "FADD") for o in ops)
    _require(ex2 > 0, "mamba_scan: no MUFU.EX2 in its SASS")
    return fp32 / ex2, ex2


def _serving_report(torch, name: str, out: dict, kernel: str, layers: int) -> dict:
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"serve {name}: prefill {out['prefill_s']:.4f} s, decode {out['decode_s']:.4f} s, "
          f"{out['tok_per_s']:.1f} tok/s, peak memory {peak:.2f} GiB, continuation "
          f"{out['continuation']}")
    print(f"serve {name}: launches in prefill {out['prefill_launches']}, "
          f"in decode {out['decode_launches']}")
    _require(out["logits_finite"], f"serve {name}: a logit is not finite")
    _require(out["prefill_launches"].get(kernel, 0) == layers,
             f"serve {name}: {kernel} launched {out['prefill_launches'].get(kernel, 0)} "
             f"times in prefill, not {layers}")
    _require(not any(out["decode_launches"].get(k, 0) for k in TOKEN_KERNELS),
             f"serve {name}: a token kernel was launched in decode")
    return {k: out[k] for k in ("prefill_s", "decode_s", "tok_per_s")} | {"peak_gib": peak}


def run_serving_paths(torch, build) -> dict:
    """This slice's paths: the three token families served at full width;
    returns each kernel's launches on its path."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"serving: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, fp32 weights")
    launches = {}
    for arch, batch, prompt, steps, kernel, layers in (
            ("gemma3-1b", 4, 1024, 32, "flash_attention", 26),
            ("rwkv6-7b", 4, 512, 32, "rwkv6_scan", 32)):
        args = serve.make_parser().parse_args(
            ["--arch", arch, "--batch", str(batch), "--prompt-len", str(prompt),
             "--decode-steps", str(steps)])
        args.reduced = False            # the published config (the CLI cannot unset it)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        out = serve.run(args)
        launches[kernel] = dict(build.LAUNCHES)
        _serving_report(torch, f"{arch} {batch}x{prompt}+{steps}", out, kernel, layers)

    cfg = dataclasses.replace(get_arch("jamba-1.5-large-398b").CONFIG, num_layers=2)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init(gen, cfg, "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    prompts = torch.randint(0, cfg.vocab_size, (2, 512), generator=gen, device="cuda")
    build.reset_launches()
    out = serve.generate(params, prompts, cfg, 16)
    launches["mamba_scan"] = dict(build.LAUNCHES)
    out["continuation"] = out["tokens"][0][:16].tolist()
    out["logits_finite"] = bool(torch.isfinite(out["logits"]).all())
    print(f"serve jamba-1.5-large-398b cut to 2 layers ({[s.mixer + '+' + s.ffn for s in cfg.layer_specs()]}, "
          f"{n_params} parameters)")
    _serving_report(torch, "jamba 2 layers 2x512+16", out, "mamba_scan", 2)
    del params, out
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def check_small_serving(torch, build) -> None:
    """The five reduced token configs served on the card and on the CPU
    (the plain versions) from the same seeded weights and prompts; the CPU
    side is held to the JAX reference by tests/test_torch_serve.py."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in SMALL_ARCHS:
        cfg = get_arch(arch).reduced()
        gen = torch.Generator().manual_seed(7)
        params = T.init(gen, cfg, "cpu")
        prompts = torch.randint(0, cfg.vocab_size, (2, 20), generator=gen)
        cpu = serve.generate(params, prompts, cfg, 6)
        before = dict(build.LAUNCHES)
        gpu = serve.generate(tree_map(lambda t: t.cuda(), params), prompts.cuda(), cfg, 6)
        launched = {k: build.LAUNCHES.get(k, 0) - before.get(k, 0) for k in TOKEN_KERNELS}
        gap = float((gpu["logits"].cpu() - cpu["logits"]).abs().max())
        print(f"small serve {arch}: tokens cuda {gpu['tokens'][0].tolist()} cpu "
              f"{cpu['tokens'][0].tolist()}, max |logit gap| {gap:.3e}, launched {launched}")
        _require(torch.equal(gpu["tokens"].cpu(), cpu["tokens"]),
                 f"small serve {arch}: greedy tokens differ between card and CPU")
        torch.testing.assert_close(gpu["logits"].cpu(), cpu["logits"], **SERVE_TOL)
        _require(sum(launched.values()) == cfg.num_layers,
                 f"small serve {arch}: {launched} token-kernel launches for "
                 f"{cfg.num_layers} layers")


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.api import FederatedJob, TaskConfig
    from repro_torch.configs.sanet_openkbp import OPENKBP_TASK, SANET
    from repro_torch.core.agg_engine import get_engine
    from repro_torch.core.round_engine import ChunkPlan
    from repro_torch.core.stacking import broadcast_to_sites
    from repro_torch.kernels import build, fedagg, ops, ref
    from repro_torch.models.sanet import sanet_init

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.build(list(ops.KERNELS))
    print(f"built {sorted(ops.KERNELS)} in {time.perf_counter() - t0:.1f} s")
    kernel_resources(build)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    layout = get_engine().layout_of(broadcast_to_sites(
        sanet_init(torch.Generator().manual_seed(0), SANET), 1))
    plan = ChunkPlan.of(layout, 1024, 128, dev)
    print(f"full-width chunk groups (width, rows per site): "
          f"{[(w, rows) for w, rows, _ in plan.groups]}")
    entries = {"fedagg": check_fedagg(torch, fedagg, ref, dev),
               **check_int8_kernels(torch, plan, layout, dev),
               "trimmed_mean": check_trimmed_mean(torch, dev),
               "flash_attention": check_flash_attention(torch, dev),
               "rwkv6_scan": check_rwkv6_scan(torch, dev),
               "mamba_scan": check_mamba_scan(torch, dev)}

    main_launches = run_main_path(torch, FederatedJob, TaskConfig, build, OPENKBP_TASK)
    int8_launches, int8_result = run_int8_path(torch, FederatedJob, TaskConfig, build,
                                               OPENKBP_TASK)
    codec_launches = check_codec(torch, build, int8_result.global_params)
    check_small_jobs(torch, FederatedJob, TaskConfig)
    robust_launches = run_robust_path(torch, FederatedJob, TaskConfig, build, OPENKBP_TASK)
    check_robust_small_jobs(torch, FederatedJob, TaskConfig, build)
    del int8_result
    serving_launches = run_serving_paths(torch, build)
    check_small_serving(torch, build)

    # each kernel's launches on the path that carries it: fedagg on the
    # first slice's path, the int8 fold and install on the second's, the
    # decode in the codec phase, the trimmed mean on the robust path, each
    # token kernel on the serving path of its family
    path_of = {"fedagg": main_launches, "quantize_int8": int8_launches,
               "fedagg_dequant": int8_launches, "dequant_install": int8_launches,
               "dequantize_int8": codec_launches, "trimmed_mean": robust_launches,
               **serving_launches}
    kernels = []
    for name, (route, source, replaces) in ops.KERNELS.items():
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": path_of[name].get(name, 0),
                        **entries[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
