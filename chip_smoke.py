#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it goes wrong:

1. the card's name and power limit, then a build of every hand-written
   kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per source, all
   started together), and the registers, shared memory and blocks an SM
   of each instance of ``flash_attention``, ``rwkv6_scan``, ``mamba_scan``,
   ``quantize_int8`` and ``dequantize_int8``;
2. each kernel against its plain PyTorch version on the card, at the
   paths' shapes and at ragged ones, with stated tolerances, then its
   time beside its bound (fp32 attention's at the TF32 tensor-core rate,
   three products a flop), the plain version's time and, where one exists,
   one library call's time (CUDA events around a CUDA graph of the call
   site, median of 25 replays after a warm-up, so no host time is in
   them; the eager call site's time is kept as ``eager_ms``).
   ``dequantize_int8`` is timed as one launch over a full-width message
   (its 160 leaves), its library yardstick ``torch.mul`` leaf by leaf, and
   held to its plain version on 32 messages of ragged leaves laid out as
   payloads after headers of every length mod 16.
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
5. the wire codec: the full-width global model encoded for the wire as a
   site uploads it (the reference's layout; one ``quantize_int8`` launch a
   chunk width), held to the plain encoder on the reference's element
   order; its frame decoded three ways, bit-equal: grouped on the card
   (ONE ``dequantize_int8`` launch), leaf by leaf on the card, and the
   plain version (the first two timed eager); and a frame encoded on the
   CPU (align=1: odd widths, rows and scales off any alignment) decoded on
   the card in one launch, bit-equal to the plain version;
5b. this slice's path: the same full-width int8 job on the socket
   deployment (``transport="thread"``: four site threads on the card, real
   TCP round trips to the aggregation server on the card), held to the
   stacked int8 job of phase 4: payload bytes equal, globals within the
   reference's thread-vs-stacked bound (rtol 2e-3, atol 2e-4) but on at
   most 1e-5 of the elements (each within ``lr * rounds``: fold-order
   round-off that AdamW's next step amplifies), losses,
   ``wall_s``/``batch_s``/``step_s`` and peak memory printed, and ONE
   ``dequantize_int8`` launch for every int8 message decoded (uploads,
   downloads and the error-feedback updates at both ends); then the same
   job again, as the witness of that round-off, held the same way;
6. small jobs run on the card and on the CPU (the plain versions):
   uncompressed, int8 up only, int8 both ways and int8 down only;
   per-round losses must agree, and each side's bytes must be its own
   layout's; then a 2-site job on the tcp transport (one process a site),
   uncompressed and int8 both ways, the same way;
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
11. the dose experiment (Figs 7-9) at full width (``OPENKBP_TASK``, TF32
   convolutions, 2 rounds): the pooled baseline (one site whose batch is
   the 4 sites' batches, a batch of 4 at 128^3) and the individual
   baseline (4 sites, ``comm`` None); ``fedagg`` once each (the final
   global, held to the plain fold of the final rows in every job of
   11-13; phase 2 holds ``fedagg``, ``trimmed_mean`` and the int8 kernels
   to their plain versions at these jobs' shapes too);
12. the strategy comparison on BraTS (Figs 11/12; ``BRATS_TASK``: 4 MRI
   channels, 4 classes, 6,840,300 parameters, the sites' case counts):
   fedavg, fedprox (``prox_mu=0.01``), fedprox with int8 both ways and
   fedprox under ``trimmed:1`` at 2 local steps, each with the exact
   launches its code implies (``run_seg_strategies`` states them), the
   FedProx anchor held to the broadcast rows and the global, fedprox's
   ``step_s`` beside fedavg's and its per-site losses equal to fedavg's
   (one local step from the anchor: the Eq. 2 term is 0);
13. gossip on PanSeg (Fig 15; ``PANSEG_TASK``: 1 channel, 2 classes, 5
   sites, 6,838,014 parameters): GCML without churn and with
   ``max_dropout=1`` under shutdown, each round's pairings and DCML
   losses printed, ``fedagg`` once (the final global);
14. small jobs of every strategy above (8^3, 4 filters, TF32 off) on the
   card and on the CPU: losses within ``JOB_RTOL``, masks, pairings and
   ``comm`` equal, the globals (and FedProx's anchors) within ``lr`` a
   local step and ``SMALL_MEDIAN_TOL`` at the median;
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

Phases 11-14 run after phase 8, before 9.  Every kernel's launch count is
zeroed just before each of phases 3-5b, 7, each path of 9 and each
full-width job of 11-13, and read just after; each of 11-14 prints its
seconds.  The second-to-last line is a
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
BRATS_N = 6_840_300                      # SANET_SEG's parameter count (the reference's)
PANSEG_N = 6_838_014                     # SANET_OAR's
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
    """fedagg vs its plain version; returns its entry of the kernels line.
    The full-width cases are the paths' shapes: 4 OpenKBP and 4 BraTS
    sites, the pooled baseline's one row and GCML's 5 PanSeg sites."""
    gen = torch.Generator(device=dev).manual_seed(0)
    full = [(4, FULL_N), (1, FULL_N), (4, BRATS_N), (5, PANSEG_N)]
    cases = full + [(s, n) for s in (1, 3, 16) for n in (1, 127, 65_537)]
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
            if (s, n) in full:
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


def check_int8_kernels(torch, plan, layout, dev, seg_plan) -> dict:
    """The four int8 kernels vs their plain versions at the ragged shapes
    and the full-width chunk groups of OpenKBP's SA-Net (``plan``, also the
    timed shapes) and BraTS's (``seg_plan``); returns their kernels-line
    entries."""
    import numpy as np
    from repro_torch.kernels import fedagg as fk
    from repro_torch.kernels import quantize as qk
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(1)
    full = [(4, rows, width) for width, rows, _ in plan.groups]
    seg = [(4, rows, width) for width, rows, _ in seg_plan.groups]
    err = {"quantize_int8": 0.0, "dequantize_int8": 0.0, "fedagg_dequant": 0.0,
           "dequant_install": 0.0}
    for s, rows, c in RAGGED + full + seg:
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
    print(f"int8 kernels: {len(RAGGED)} ragged shapes and {len(full)} OpenKBP and "
          f"{len(seg)} BraTS full-width chunk groups agree with the plain versions (bit-equal; fedagg_dequant's g "
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
    err["dequantize_int8"] = max(err["dequantize_int8"], check_grouped_dequant(torch, dev))
    # one full-width message in the card's layout: every leaf, one grouped
    # launch; the library yardstick multiplies leaf by leaf (no one PyTorch
    # call decodes leaves of several widths)
    from repro_torch.comms.compression import WirePlan
    wp = WirePlan.of(layout, 1024, 128, dev, port=True)
    _, q_all, s_all = wp.encode(torch.randn(layout.n, device=dev, generator=gen) * 0.05)
    qb, sb = q_all.view(torch.uint8), s_all.view(torch.uint8)
    host_table = torch.from_numpy(wp.table.host)
    leaves = [(q_all[qo: qo + rows * width].view(rows, width), s_all[ro: ro + rows])
              for qo, ro, rows, width in wp._places]
    got = qk.dequantize_int8_grouped_cuda(wp.table, qb, sb, torch.empty(layout.n, device=dev))
    torch.cuda.synchronize()
    want = ref.dequantize_int8_grouped_ref(host_table, qb, sb, torch.empty(layout.n, device=dev))
    per_leaf = torch.cat([qk.dequantize_int8_cuda(q, sc).reshape(-1)[: int(np.prod(sh))]
                          for (q, sc), sh in zip(leaves, wp.wire.shapes)])
    _require(torch.equal(got, want) and torch.equal(got, per_leaf),
             "dequantize_int8 grouped full-width message differs from its plain version "
             "or from the per-leaf launches")
    err["dequantize_int8"] = max(err["dequantize_int8"], float((got - want).abs().max()))
    out["dequantize_int8"] = measure(
        torch, f"dequantize_int8 one message [{wp.table.leaves} leaves, "
        f"{wp.table.total_rows} rows, {layout.n} values]",
        lambda: qk.dequantize_int8_grouped_cuda(wp.table, qb, sb, got),
        lambda: ref.dequantize_int8_grouped_ref(host_table, qb, sb, want),
        lambda: [torch.mul(q, sc[:, None]) for q, sc in leaves],
        nbytes=wp.table.nbytes(), flops=layout.n)
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
    bit, at ragged shapes and at full width (OpenKBP's and BraTS's 4 sites);
    returns its kernels-line entry."""
    from repro_torch.kernels import ref, robust
    gen = torch.Generator(device=dev).manual_seed(2)
    err, cases = 0.0, 0
    full = [(4, FULL_N), (4, BRATS_N)]
    shapes = [(s, n) for s in TRIM_SITES for n in TRIM_WIDTHS] + full
    for s, n in shapes:
        x, patterns = _trim_cases(torch, dev, s, n, gen)
        depths = sorted({0, 1, 2, s}) if (s, n) not in full else [1, s]
        for a in patterns if (s, n) not in full else patterns[:2]:
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
          f"widths x trim depths x active patterns, non-finite values, {full} "
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


def _eager_ms(torch, fn, reps: int = 11) -> float:
    """Median host-clock ms of ``fn`` with the device synchronised around it."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[reps // 2]


def check_codec(torch, build, global_params) -> None:
    """The wire codec on the card: the full-width global, as a site uploads
    it (the reference's layout, one quantize launch per chunk width), held
    to the plain encoder on the reference's element order; its frame then
    decoded three ways, which must be bit-equal: grouped on the card (ONE
    dequantize_int8 launch), leaf by leaf on the card (``decode_array``),
    and the plain version on the CPU; the first two timed eager.  Then a
    frame encoded on the CPU (align=1: odd widths, rows and scales off any
    alignment) decoded on the card, bit-equal to the plain version."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.comms.codec import decode_message, encode_message, payload_span
    from repro_torch.comms.compression import (Int8Codec, UploadCompressor, decode_array,
                                               decode_tree, tree_payload_nbytes)

    def encode(tree):
        payload, meta = UploadCompressor(Int8Codec(), error_feedback=False).encode(tree)
        return payload, encode_message("upload", {"site": 0, "round": 1, **meta}, payload)

    params = [t.float() for t in _leaves(global_params)]
    build.reset_launches()
    payload, frame = encode(global_params)
    torch.cuda.synchronize()
    enc_launches = dict(build.LAUNCHES)
    enc = _leaves(payload)
    nbytes = tree_payload_nbytes(payload)
    print(f"codec: {len(enc)} leaves, {nbytes} payload bytes, frame {len(frame)} bytes; "
          f"encode launches {enc_launches}")
    _require(nbytes == INT8_BYTES, f"codec payload {nbytes} bytes, expected {INT8_BYTES}")
    _require(enc_launches.get("dequantize_int8", 0) == 0
             and enc_launches.get("quantize_int8", 0) == 4,
             "the encode without error feedback launches quantize_int8 once a chunk width")
    for p, qt in zip(params, enc):
        wire = convert.to_reference({"x": p})["x"]
        _require(tuple(qt.shape) == wire.shape, "codec leaf is not in the reference's shape")
        q, sc = _chunks(torch, wire.reshape(-1))
        _require(np.array_equal(qt.data["q"], q.numpy()) and np.array_equal(qt.data["scale"],
                                                                           sc.numpy()),
                 "codec payload differs from the plain encoder's on the reference's order")

    _, _, tree = decode_message(frame)
    leaves = _leaves(tree)
    build.reset_launches()
    grouped = decode_tree(tree, device="cuda")
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    per_leaf = [decode_array(qt, device="cuda") for qt in leaves]
    plain = decode_tree(tree, device="cpu")
    for g, l, c in zip(_leaves(grouped), per_leaf, _leaves(plain)):
        _require(torch.equal(g, l) and torch.equal(g.cpu(), c),
                 "message decode: grouped, per-leaf and plain differ")
    _require(launches.get("dequantize_int8", 0) == 1,
             f"one message decoded with {launches.get('dequantize_int8', 0)} "
             "dequantize_int8 launches, not one")
    grouped_ms = _eager_ms(torch, lambda: decode_tree(tree, device="cuda"))
    leaf_ms = _eager_ms(torch, lambda: [decode_array(qt, device="cuda") for qt in leaves])
    print(f"codec: one upload frame ({len(frame)} bytes) to a device tree, eager: grouped "
          f"{grouped_ms:.4f} ms (1 launch), per leaf {leaf_ms:.4f} ms ({len(leaves)} launches); "
          "bit-equal to each other and to the plain version")

    cpu_payload, cpu_frame = encode(tree_map_cpu(global_params))
    _, _, cpu_tree = decode_message(cpu_frame)
    cpu_leaves = _leaves(cpu_tree)
    _, offsets = payload_span([a for qt in cpu_leaves for a in (qt.data["q"],
                                                                qt.data["scale"])])
    odd_rows = sum(o % 16 != 0 or qt.data["q"].shape[1] % 16 != 0
                   for o, qt in zip(offsets[0::2], cpu_leaves))
    odd_scales = sum(o % 4 != 0 for o in offsets[1::2])
    _require(odd_rows > 0 and odd_scales > 0, "the CPU frame has no misaligned row or scale")
    build.reset_launches()
    on_card = decode_tree(cpu_tree, device="cuda")
    torch.cuda.synchronize()
    _require(build.LAUNCHES.get("dequantize_int8", 0) == 1,
             "the misaligned frame took more than one launch")
    for g, c in zip(_leaves(on_card), _leaves(decode_tree(cpu_tree, device="cpu"))):
        _require(torch.equal(g.cpu(), c), "misaligned frame: card decode differs from plain")
    print(f"codec: a CPU-encoded frame (align=1, {tree_payload_nbytes(cpu_payload)} payload "
          f"bytes; {odd_rows} leaves with rows off 16 bytes or odd widths, {odd_scales} with "
          "scales off 4 bytes) decoded on the card in one launch, bit-equal to the plain version")


def _chunks(torch, flat_np):
    """The plain encoder on one leaf's align-128 chunks, on the CPU."""
    from repro_torch.comms.compression import _as_chunks
    from repro_torch.kernels import ref
    return ref.quantize_int8_ref(_as_chunks(torch.from_numpy(flat_np.copy()), 1024, 128))


def tree_map_cpu(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().cpu(), tree)


def check_grouped_dequant(torch, dev) -> float:
    """The grouped dequantize_int8 against its plain version, bit for bit,
    on messages laid out as a payload (each leaf's q then its scales) after
    a header of every length mod 16: leaves of many sizes at align 1 (odd
    widths, rows and scales at any byte offset) and 128 (the card's),
    output offsets off 16 bytes, a ragged last row, and one leaf of more
    rows than a grid-stride pass.  Returns the largest |difference|."""
    import numpy as np
    from repro_torch.comms.compression import chunk_geom
    from repro_torch.kernels import quantize as qk
    from repro_torch.kernels import ref
    rng = np.random.default_rng(3)
    sizes = [1, 3, 5, 127, 128, 129, 1000, 1024, 1025, 3001, 4103, 65_537]
    err, cases = 0.0, 0
    for align in (1, 128):
        for head in range(16):
            order = rng.permutation(len(sizes)) if head else np.arange(len(sizes))
            parts, entries, pos, out_off = [], [], head, 0
            for i in order:
                n = sizes[i] * (256 if head == 15 else 1)   # past one grid-stride pass
                rows, width = chunk_geom(n, 1024, align)
                q = rng.integers(-127, 128, size=rows * width, dtype=np.int8)
                sc = (rng.random(rows, dtype=np.float32) * 0.01 + 1e-4).astype(np.float32)
                entries.append((pos, pos + q.nbytes, rows, width, n, out_off))
                parts += [q.view(np.uint8), sc.view(np.uint8)]
                pos += q.nbytes + sc.nbytes
                out_off += n
            buf = np.concatenate([np.zeros(head, np.uint8)] + parts)
            table = qk.Int8Table.of(entries)
            b = torch.from_numpy(buf).to(dev)
            got = qk.dequantize_int8_grouped_cuda(table, b, b, torch.full((out_off,), float("nan"),
                                                                          device=dev))
            torch.cuda.synchronize()
            want = ref.dequantize_int8_grouped_ref(torch.from_numpy(table.host), b, b,
                                                   torch.full((out_off,), float("nan"),
                                                              device=dev))
            _require(torch.equal(got, want), f"dequantize_int8 grouped, align {align}, "
                     f"header {head}: differs from its plain version")
            err = max(err, float((got - want).abs().max()))
            cases += 1
    print(f"dequantize_int8 grouped: {cases} messages of {len(sizes)} leaves (align 1 and "
          f"128, headers 0-15 bytes, the last of {table.total_rows} rows) bit-equal to the "
          "plain version")
    return err


def run_socket_path(torch, FederatedJob, TaskConfig, build, task, stacked) -> dict:
    """This slice's path: the full-width 4-site job with int8 both ways on
    the thread transport (real TCP round trips to the AggregationServer on
    the card), held to the stacked int8 job ``stacked``: payload bytes
    equal; globals within the reference's own thread-vs-stacked bound
    (rtol 2e-3, atol 2e-4) but on at most 1e-5 of the elements, which are
    held to ``lr * ROUNDS``: the server folds in arrival order and
    normalizes once (the reference's server), the stacked kernel folds
    normalized weights, and AdamW's next step can turn that round-off into
    a flipped int8 step or ``lr * sign(noise)`` where a gradient is near
    zero.  The witness, in the same run: the socket job run again, whose
    only difference is its fold's arrival order; it is printed against
    the first run and held to the stacked job the same way
    (``probe_fold_order.py`` shows both runs of the socket job exceeding
    the bound against each other on the same conv weight element).  Every
    int8 message decoded (4 uploads at the server, 4 downloads at the
    sites, 8 error-feedback updates a round once the downlink sends
    deltas) takes ONE dequantize_int8 launch.  Returns the first run's
    launches."""
    from repro_torch.core.round_engine import bootstrap_masks
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    job = FederatedJob(task=TaskConfig(**task), strategy="fedavg", rounds=ROUNDS,
                       transport="thread", compression="int8", down_compression="int8")
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    result = job.run()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    _check_result(torch, result, "the socket path")
    for s, t in zip(stacked.history, result.history):
        print(f"socket path round {t['round']}: loss stacked {s['loss']:.6f} thread "
              f"{t['loss']:.6f}; per site stacked {[round(v, 6) for v in s['per_site_loss']]} "
              f"thread {[round(v, 6) for v in t['per_site_loss']]}; wall_s stacked "
              f"{s['wall_s']:.4f} thread {t['wall_s']:.4f}; batch_s {s['batch_s']:.4f} / "
              f"{t['batch_s']:.4f}; step_s {s['step_s']:.4f} / {t['step_s']:.4f}")
    comm, sc = result.comm, stacked.comm
    print(f"socket path: {ROUNDS} rounds in {wall:.1f} s with set-up, peak memory {peak:.2f} "
          f"GiB, comm {comm}")
    _require(comm["site_payload_bytes"] == sc["upload_bytes"],
             f"site_payload_bytes {comm['site_payload_bytes']} != stacked upload_bytes "
             f"{sc['upload_bytes']}")
    _require(comm["download_payload_bytes"] == sc["download_bytes"],
             f"download_payload_bytes {comm['download_payload_bytes']} != stacked "
             f"download_bytes {sc['download_bytes']}")
    worst, outside = _outside(result.global_params, stacked.global_params)
    print(f"socket path: globals max |thread - stacked| {worst:.3e}; leaves with elements "
          f"outside rtol 2e-3, atol 2e-4 (leaf, shape, count, max): {outside}")
    masks = job.masks(ROUNDS)
    boot = bootstrap_masks(masks, 16)
    # per round: each int8 upload is decoded at the server and, for its
    # residual, at the site; each int8 (delta) download at the site and,
    # for the held copy, at the server
    per_round = [2 * int(masks[r].sum()) + 2 * int((masks[r] & ~boot[r]).sum())
                 for r in range(ROUNDS)]
    got = launches.get("dequantize_int8", 0)
    print(f"kernels launched on the socket path: {launches}; dequantize_int8 {got} for "
          f"{sum(per_round)} int8 messages decoded ({per_round} a round)")
    _require(got == sum(per_round),
             f"dequantize_int8 launched {got} times for {sum(per_round)} int8 messages")
    _require(launches.get("quantize_int8", 0) == 4 * sum(
        int(masks[r].sum()) + int((masks[r] & ~boot[r]).sum()) for r in range(ROUNDS)),
        "quantize_int8 not launched once a chunk width an int8 encode")
    # the reference's bound holds but where AdamW's step turns fold-order
    # round-off into a flipped int8 step or about lr * sign(noise): there
    # |difference| <= lr * ROUNDS, on at most 1e-5 of the elements (a
    # wrong fold, a site dropped or counted twice, moves millions)
    _require_fold_noise(job, worst, outside, "the socket path")
    again = job.run()
    _check_result(torch, again, "the socket path run again")
    w_again, o_again = _outside(again.global_params, stacked.global_params)
    w_runs, o_runs = _outside(again.global_params, result.global_params)
    print(f"socket path, witness (the same job again: only the fold's arrival order "
          f"differs): max |again - stacked| {w_again:.3e}, outside {o_again}; max |again - "
          f"first run| {w_runs:.3e}, outside {o_runs}; losses {again.losses}")
    _require_fold_noise(job, w_again, o_again, "the socket path run again")
    return launches


def _outside(got, want):
    """(max |got - want|, [(leaf, shape, count, max)] of the leaves with
    elements outside rtol 2e-3, atol 2e-4 of ``want``)."""
    worst, outside = 0.0, []
    for i, (a, b) in enumerate(zip(_leaves(got), _leaves(want))):
        d = (a - b).abs()
        worst = max(worst, float(d.max()))
        bad = int((d > 2e-4 + 2e-3 * b.abs()).sum())
        if bad:
            outside.append((i, tuple(a.shape), bad, float(d.max())))
    return worst, outside


def _require_fold_noise(job, worst, outside, what: str) -> None:
    n_out = sum(bad for _, _, bad, _ in outside)
    _require(worst <= job.lr * ROUNDS and n_out <= 1e-5 * FULL_N,
             f"{what}: globals differ from the stacked job's by up to {worst:.3e} "
             f"(lr * rounds {job.lr * ROUNDS}), {n_out} elements outside rtol 2e-3, atol 2e-4")


def check_small_tcp_jobs(torch, FederatedJob, TaskConfig) -> None:
    """A 2-site job at the tiny size on the tcp transport (one process a
    site), uncompressed and int8 both ways, on the card and on the CPU, TF32
    off: per-round losses within rtol 1e-4, and each side's payload bytes
    its own layout's (align 128 on the card, 1 on the CPU)."""
    from repro_torch.core.round_engine import bootstrap_masks, encoded_nbytes
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    base = FederatedJob(task=TaskConfig(kind="dose", sites=2, batch=1, volume=(8, 8, 8),
                                        base_filters=4), rounds=3, transport="tcp")
    for codec in ("none", "int8"):
        job = base.replace(compression=codec, down_compression=codec)
        gpu, cpu = job.run(), job.replace(device="cpu").run()
        print(f"small tcp job {codec}: losses cuda {gpu.losses} cpu {cpu.losses}")
        for g, c in zip(gpu.losses, cpu.losses):
            _require(math.isclose(g, c, rel_tol=JOB_RTOL, abs_tol=1e-6),
                     f"small tcp job {codec}: cuda loss {g} != cpu loss {c}")
        if codec == "none":
            continue
        shapes = [tuple(t.shape) for t in _leaves(cpu.global_params)]
        masks = job.masks(job.rounds)
        boot = bootstrap_masks(masks, 16)
        dense = 4 * sum(math.prod(sh) for sh in shapes)
        for res, align in ((gpu, 128), (cpu, 1)):
            enc = encoded_nbytes(shapes, 1024, align)
            want_up = int(masks.sum()) * enc
            want_down = int((masks & boot).sum()) * dense + int((masks & ~boot).sum()) * enc
            _require(res.comm["site_payload_bytes"] == want_up
                     and res.comm["download_payload_bytes"] == want_down,
                     f"small tcp job align {align}: payload bytes {res.comm}")
        print(f"small tcp job int8: payload bytes cuda {gpu.comm['site_payload_bytes']} up "
              f"{gpu.comm['download_payload_bytes']} down; cpu {cpu.comm['site_payload_bytes']}"
              f" / {cpu.comm['download_payload_bytes']}")


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

# -- the paper's strategy set (phases 11-14) -------------------------------------

PROX_MU = 0.01
# FedProx against FedAvg where the Eq. 2 term is exactly 0: the same
# arithmetic but for adding that 0 (and the round-0 anchor, Eq. 1 over
# four identical rows, which may round an element by an ulp)
PROX_ZERO_RTOL = 1e-6
# card vs CPU globals of the small strategy jobs (lr 1e-3): a fault in a
# step moves most elements by about lr; fp32 sum orders moved the median
# by 0 to 1.04e-6 (6 AdamW steps of the seg FedProx job)
SMALL_MEDIAN_TOL = 1e-5


def _strategy_history(result, what: str) -> None:
    """Each round's losses, times, pairings and (GCML) DCML losses."""
    for h in result.history:
        line = (f"{what} round {h['round']}: active {h['active']} loss {h['loss']:.6f} "
                f"per-site {[round(v, 6) for v in h['per_site_loss']]} wall_s "
                f"{h['wall_s']:.4f} batch_s {h['batch_s']:.4f} step_s {h['step_s']:.4f}")
        if "partner" in h:
            line += f" partner {h['partner']} is_receiver {h['is_receiver']}"
        for k in ("dcml_loss_r", "dcml_loss_s", "dcml_val_r", "dcml_val_s"):
            if k in h:
                line += f" {k} {[round(v, 6) for v in h[k]]}"
        for k in ("upload_bytes", "download_bytes"):
            if k in h:
                line += f" {k} {h[k]}"
        print(line)


def run_strategy_job(torch, FederatedJob, TaskConfig, build, task, n_params: int,
                     what: str, expect, **kw):
    """One full-width job of the strategy set, 2 sync rounds, TF32
    convolutions, random weights from seed 0.  Every kernel's launches are
    zeroed just before ``job.run()`` and must equal ``expect[name]`` (0 for
    a kernel not named) just after.

    The final global is ``fedagg``'s last launch on every uncompressed
    path: it is held to the plain version on the final rows and the
    normalized case weights (``FP32_TOL``).  FedProx's anchor, the global
    of the last round, must equal every row it was broadcast to (every
    site is active in these jobs) and lie
    within ``FP32_TOL`` of that plain global; under int8 it must be the
    global itself (the anchor is re-pinned to the exact fold).  Returns the
    result."""
    from repro_torch.kernels import ref
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    job = FederatedJob(task=TaskConfig(**task), rounds=ROUNDS, **kw)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    result = job.run()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    _strategy_history(result, what)
    print(f"{what}: {ROUNDS} rounds in {wall:.1f} s with set-up, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, comm {result.comm}")
    print(f"{what}: kernels launched {launches}, expected {expect}")
    got_n = sum(t.numel() for t in _leaves(result.global_params))
    _require(got_n == n_params, f"{what}: {got_n} parameters, not {n_params}")
    _require(all(math.isfinite(v) for h in result.history for v in h["per_site_loss"]),
             f"non-finite loss on {what}")
    _require(all(bool(torch.isfinite(t).all()) for t in _leaves(result.global_params)),
             f"non-finite global parameters on {what}")
    for name in set(launches) | set(expect):
        _require(launches.get(name, 0) == expect.get(name, 0),
                 f"{what}: {name} launched {launches.get(name, 0)} times, "
                 f"expected {expect.get(name, 0)}")
    rows = result.state["params"]
    flat = torch.cat([t.reshape(-1) for t in _leaves(result.global_params)])
    anchor = result.state["strategy"].get("global")
    if kw.get("compression", "none") == "none":
        cw = torch.as_tensor(job.federation().case_weights(), device=rows.device)
        want = ref.fedagg_ref(rows, cw / cw.sum())
        torch.testing.assert_close(flat, want, **FP32_TOL)
        print(f"{what}: final global [{rows.shape[0]}, {rows.shape[1]}] within fp32 "
              f"rtol=atol=1e-6 of the plain fedagg (max |err| "
              f"{float((flat - want).abs().max()):.3e})")
        if anchor is not None:
            _require(all(torch.equal(r, anchor) for r in rows),
                     f"{what}: a row differs from the FedProx anchor it was broadcast")
            torch.testing.assert_close(anchor, want, **FP32_TOL)
    elif anchor is not None:
        _require(torch.equal(anchor, flat), f"{what}: the anchor is not the final global")
        print(f"{what}: the anchor is the final global, bit for bit")
    return result


def _timed(phase: str, fn, *args) -> None:
    gc.collect()
    t0 = time.perf_counter()
    fn(*args)
    print(f"phase {phase}: {time.perf_counter() - t0:.1f} s")


def run_dose_strategies(torch, FederatedJob, TaskConfig, build, task) -> None:
    """Phase 11, the dose experiment (Figs 7-9): the pooled baseline (ONE
    site whose batch is the 4 sites' batches, a batch of 4 at 128^3) and
    the individual baseline (4 sites, no exchange, ``comm`` None).  Neither
    aggregates in a round: ``fedagg`` runs once, for the final global (the
    case-weighted mean of the site rows; one row when pooled)."""
    sites = task["sites"]
    pooled = run_strategy_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                              "dose pooled", {"fedagg": 1}, strategy="pooled")
    _require(tuple(pooled.state["params"].shape) == (1, FULL_N)
             and all(len(h["per_site_loss"]) == 1 and h["active"] == sites
                     for h in pooled.history) and pooled.comm is None,
             "dose pooled: not one site over the task's sites")
    del pooled
    indiv = run_strategy_job(torch, FederatedJob, TaskConfig, build, task, FULL_N,
                             "dose individual", {"fedagg": 1}, strategy="individual")
    _require(tuple(indiv.state["params"].shape) == (sites, FULL_N) and indiv.comm is None,
             "dose individual: not one row a site, or a comm")


def run_seg_strategies(torch, FederatedJob, TaskConfig, build, task, counts) -> None:
    """Phase 12, the strategy comparison on BraTS (Figs 11/12), 4 sites at
    the paper's case counts.  Launches, worked out from the code:

    - fedavg: ``fedagg`` once a round (``aggregate_round``) and once for
      the final global;
    - fedprox: one more, the round-0 anchor (``FedProx.init_state``, the
      mean of the identical initial rows);
    - fedprox + int8 both ways (``run_compressed`` under ``fedprox-local``):
      ``fedagg`` once for the anchor and once a round (the fold of the
      sites' upload anchors, ``reduce_flat(anchor, w)``), none at the end
      (the global is the fold's); per round and chunk-width group G,
      ``quantize_int8`` twice (the uploads' fold, the installs),
      ``fedagg_dequant`` once and ``dequant_install`` once;
    - fedprox + trimmed:1: ``trimmed_mean`` once a round, ``fedagg`` for
      the anchor and the final global only.

    With one local step and every site active, each site starts its step at
    the anchor, so the Eq. 2 term and its gradient are 0: plain FedProx's
    per-site losses must be FedAvg's (within ``PROX_ZERO_RTOL``), and its
    ``step_s`` times a term that is computed but pulls nothing.  The int8
    job's sites install quantized copies, so the term pulls there; the
    ``trimmed:1`` job takes 2 local steps, so its second step reads the
    term at full width."""
    from repro_torch.comms.compression import align_for
    from repro_torch.core.agg_engine import get_engine
    from repro_torch.core.round_engine import ChunkPlan
    from repro_torch.core.stacking import broadcast_to_sites
    base = dict(case_counts=counts, prox_mu=PROX_MU)
    steps, losses = {}, {}
    for strategy, expect in (("fedavg", {"fedagg": ROUNDS + 1}),
                             ("fedprox", {"fedagg": ROUNDS + 2})):
        res = run_strategy_job(torch, FederatedJob, TaskConfig, build, task, BRATS_N,
                               f"brats {strategy}", expect, strategy=strategy, **base)
        steps[strategy] = [h["step_s"] for h in res.history]
        losses[strategy] = [v for h in res.history for v in h["per_site_loss"]]
        _require(res.comm["upload_count"] == ROUNDS * task["sites"],
                 f"brats {strategy}: comm {res.comm}")
        del res
    print(f"brats step_s a round: fedavg {steps['fedavg']} fedprox {steps['fedprox']} "
          f"(round 1: fedprox / fedavg = {steps['fedprox'][-1] / steps['fedavg'][-1]:.4f})")
    gap = max(abs(p - a) / abs(a) for a, p in zip(losses["fedavg"], losses["fedprox"]))
    print(f"brats fedprox vs fedavg, one local step (the Eq. 2 term is 0): per-site losses "
          f"{'bit-equal' if losses['fedprox'] == losses['fedavg'] else 'differ'}, "
          f"max relative gap {gap:.3e}")
    _require(gap <= PROX_ZERO_RTOL,
             f"brats fedprox: per-site losses {gap:.3e} from fedavg's with a zero Eq. 2 term")
    layout = get_engine().layout_of(broadcast_to_sites(
        TaskConfig(**task).build().init_fn(0), 1))
    dev = torch.device("cuda")
    groups = len(ChunkPlan.of(layout, 1024, align_for(dev), dev).groups)
    print(f"brats chunk-width groups: {groups}")
    res = run_strategy_job(
        torch, FederatedJob, TaskConfig, build, task, BRATS_N, "brats fedprox int8",
        {"fedagg": 1 + ROUNDS, "quantize_int8": 2 * groups * ROUNDS,
         "fedagg_dequant": groups * ROUNDS, "dequant_install": groups * ROUNDS},
        strategy="fedprox", compression="int8", down_compression="int8", **base)
    _require(res.comm["compression"] == "int8" and res.comm["down_compression"] == "int8",
             f"brats fedprox int8: comm {res.comm}")
    del res
    run_strategy_job(torch, FederatedJob, TaskConfig, build, task, BRATS_N,
                     "brats fedprox trimmed:1, 2 local steps",
                     {"fedagg": 2, "trimmed_mean": ROUNDS},
                     strategy="fedprox", aggregator="trimmed:1", local_steps=2, **base)


def run_gossip(torch, FederatedJob, TaskConfig, build, task) -> None:
    """Phase 13, gossip on PanSeg (Fig 15): GCML over 5 sites without churn,
    then with ``max_dropout=1`` under the shutdown scenario.  GCML has no
    server: ``fedagg`` runs once, for the final global, and nothing else.
    Each round pairs floor(active / 2) receivers, each with a finite DCML
    loss; the others run no DCML step (NaN)."""
    for what, kw in (("panseg gcml", {}),
                     ("panseg gcml churn", dict(max_dropout=1, dropout_scenario="shutdown"))):
        res = run_strategy_job(torch, FederatedJob, TaskConfig, build, task, PANSEG_N, what,
                               {"fedagg": 1}, strategy="gcml", **kw)
        _require(res.comm is None, f"{what}: comm {res.comm}")
        for h in res.history:
            recv = [i for i, r in enumerate(h["is_receiver"]) if r]
            _require(len(recv) == h["active"] // 2,
                     f"{what} round {h['round']}: {len(recv)} receivers of {h['active']}")
            _require(all(math.isfinite(h[k][i]) for i in recv
                         for k in ("dcml_loss_r", "dcml_loss_s", "dcml_val_r", "dcml_val_s")),
                     f"{what} round {h['round']}: a receiver's DCML loss is not finite")
            _require(all(math.isnan(v) for i, v in enumerate(h["dcml_loss_r"]) if i not in recv),
                     f"{what} round {h['round']}: a DCML step off the pairing")
        del res


def _close_globals(torch, job, gpu, cpu, what: str) -> None:
    """Card against CPU: the global model and, for FedProx, the anchor.
    Each element within ``lr`` a site's AdamW step (``rounds *
    local_steps`` of them; a step is about ``lr * sign(g)``, and float noise
    flips a near-zero gradient's sign), plus one quantization step under
    int8; the median difference within ``SMALL_MEDIAN_TOL``."""
    got, want = (torch.cat([t.reshape(-1) for t in _leaves(res.global_params)]).cpu()
                 for res in (gpu, cpu))
    pairs = [("global", got, want)]
    if "global" in cpu.state["strategy"]:
        pairs.append(("anchor", gpu.state["strategy"]["global"].cpu(),
                      cpu.state["strategy"]["global"]))
    bound = job.lr * job.rounds * job.local_steps
    if job.compression != "none":
        bound += float(want.abs().max()) / 127
    for name, a, b in pairs:
        d = (a - b).abs()
        print(f"small {what}: {name} card vs CPU max |diff| {float(d.max()):.3e} "
              f"(bound {bound:.3e}), median {float(d.median()):.3e} "
              f"(bound {SMALL_MEDIAN_TOL:.0e})")
        _require(float(d.max()) <= bound and float(d.median()) <= SMALL_MEDIAN_TOL,
                 f"small {what}: the {name} differs between card and CPU")


def check_small_strategy_jobs(torch, FederatedJob, TaskConfig) -> None:
    """Phase 14: small jobs of each strategy (8^3, 4 filters, 2 levels, 3
    rounds, TF32 off) on the card and on the CPU (the plain versions); the
    CPU path is held to the JAX reference by tests/test_torch_seg.py,
    tests/test_torch_strategies.py and tests/test_torch_gcml.py.  Losses
    (and GCML's receivers' DCML losses) within ``JOB_RTOL``; masks,
    pairings and ``comm`` equal (int8: each side's bytes its own layout's,
    as :func:`check_small_jobs` holds them).  The global models (and
    FedProx's anchors) by :func:`_close_globals`.  The seg FedProx job
    takes 2 local steps, so every round's second step reads the Eq. 2 term
    on both sides."""
    from repro_torch.comms.compression import align_for
    from repro_torch.core.round_engine import bootstrap_masks, encoded_nbytes
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tiny = dict(batch=1, volume=(8, 8, 8), base_filters=4, num_levels=2)
    dose = TaskConfig(kind="dose", sites=4, **tiny)
    seg = TaskConfig(kind="seg", sites=4, in_channels=2, num_classes=3, **tiny)
    pan = TaskConfig(kind="seg", sites=5, in_channels=1, num_classes=2, **tiny)
    cases = [("pooled", dose, dict(strategy="pooled")),
             ("individual", dose, dict(strategy="individual", max_dropout=1)),
             ("fedprox dose", dose, dict(strategy="fedprox", max_dropout=1, prox_mu=0.5)),
             ("fedprox seg", seg, dict(strategy="fedprox", max_dropout=1, local_steps=2,
                                       case_counts=(52, 44, 35, 28))),
             ("fedprox int8", seg, dict(strategy="fedprox", max_dropout=1, compression="int8",
                                        down_compression="int8")),
             ("fedprox trimmed:1", seg, dict(strategy="fedprox", max_dropout=1,
                                             aggregator="trimmed:1", adversary="sign_flip:1")),
             ("gcml", pan, dict(strategy="gcml")),
             ("gcml churn", pan, dict(strategy="gcml", max_dropout=1,
                                      dropout_scenario="shutdown", seed=3)),
             ("gcml normclip", pan, dict(strategy="gcml", max_dropout=1,
                                         aggregator="normclip:0.01"))]
    for what, task, kw in cases:
        job = FederatedJob(task=task, rounds=3, **kw)
        gpu, cpu = job.run(), job.replace(device="cpu").run()
        print(f"small {what}: losses cuda {gpu.losses} cpu {cpu.losses}")
        for g, c in zip(gpu.history, cpu.history):
            for key in ("active", "partner", "is_receiver"):
                _require(g.get(key) == c.get(key), f"small {what}: {key} differs")
            for a, b in zip(g["per_site_loss"], c["per_site_loss"]):
                _require(math.isclose(a, b, rel_tol=JOB_RTOL, abs_tol=1e-6),
                         f"small {what}: cuda loss {a} != cpu loss {b}")
            for i, r in enumerate(g.get("is_receiver", [])):
                if r:
                    _require(math.isclose(g["dcml_loss_r"][i], c["dcml_loss_r"][i],
                                          rel_tol=JOB_RTOL, abs_tol=1e-6),
                             f"small {what}: DCML losses differ")
        _close_globals(torch, job, gpu, cpu, what)
        if "compression" not in kw:
            _require(gpu.comm == cpu.comm, f"small {what}: comm {gpu.comm} != {cpu.comm}")
            continue
        masks = job.masks(job.rounds)
        boot = bootstrap_masks(masks, 16)
        shapes = [tuple(t.shape) for t in _leaves(cpu.global_params)]
        dense = 4 * sum(math.prod(sh) for sh in shapes)
        for res, align in ((gpu, align_for(torch.device("cuda"))), (cpu, 1)):
            enc = encoded_nbytes(shapes, 1024, align)
            for r, h in enumerate(res.history):
                want = sum(dense if b else enc for a, b in zip(masks[r], boot[r]) if a)
                _require(h["upload_bytes"] == int(masks[r].sum()) * enc
                         and h["download_bytes"] == want,
                         f"small {what} align {align}: round {r} bytes")


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
    instance of the five redesigned kernels, as ``cudaFuncGetAttributes`` and
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
    fn = build.entry("dequantize_int8", "dequantize_int8_resources",
                     [ctypes.POINTER(ctypes.c_int)])
    report("dequantize_int8 grouped", fn(out))


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
    from repro_torch.configs.sanet_openkbp import (BRATS_TASK, OPENKBP_TASK, PANSEG_TASK,
                                                SANET, SANET_SEG)
    from repro_torch.data.partition import BRATS_SITE_CASES
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
    seg_plan = ChunkPlan.of(get_engine().layout_of(broadcast_to_sites(
        sanet_init(torch.Generator().manual_seed(0), SANET_SEG), 1)), 1024, 128, dev)
    print(f"full-width chunk groups (width, rows per site): OpenKBP "
          f"{[(w, rows) for w, rows, _ in plan.groups]}, BraTS "
          f"{[(w, rows) for w, rows, _ in seg_plan.groups]}")
    entries = {"fedagg": check_fedagg(torch, fedagg, ref, dev),
               **check_int8_kernels(torch, plan, layout, dev, seg_plan),
               "trimmed_mean": check_trimmed_mean(torch, dev),
               "flash_attention": check_flash_attention(torch, dev),
               "rwkv6_scan": check_rwkv6_scan(torch, dev),
               "mamba_scan": check_mamba_scan(torch, dev)}

    main_launches = run_main_path(torch, FederatedJob, TaskConfig, build, OPENKBP_TASK)
    int8_launches, int8_result = run_int8_path(torch, FederatedJob, TaskConfig, build,
                                               OPENKBP_TASK)
    check_codec(torch, build, int8_result.global_params)
    socket_launches = run_socket_path(torch, FederatedJob, TaskConfig, build, OPENKBP_TASK,
                                      int8_result)
    check_small_jobs(torch, FederatedJob, TaskConfig)
    check_small_tcp_jobs(torch, FederatedJob, TaskConfig)
    robust_launches = run_robust_path(torch, FederatedJob, TaskConfig, build, OPENKBP_TASK)
    check_robust_small_jobs(torch, FederatedJob, TaskConfig, build)
    del int8_result
    jobs = (torch, FederatedJob, TaskConfig)
    _timed("11 (dose pooled, individual)", run_dose_strategies, *jobs, build, OPENKBP_TASK)
    _timed("12 (brats fedavg, fedprox, + int8, + trimmed:1)", run_seg_strategies, *jobs,
           build, BRATS_TASK, tuple(BRATS_SITE_CASES[:BRATS_TASK["sites"]]))
    _timed("13 (panseg gcml)", run_gossip, *jobs, build, PANSEG_TASK)
    _timed("14 (small strategy jobs, card and CPU)", check_small_strategy_jobs, *jobs)
    serving_launches = run_serving_paths(torch, build)
    check_small_serving(torch, build)

    # each kernel's launches on the path that carries it: fedagg on the
    # first slice's path, the int8 fold and install on the second's, the
    # decode on the socket path, the trimmed mean on the robust path, each
    # token kernel on the serving path of its family
    path_of = {"fedagg": main_launches, "quantize_int8": int8_launches,
               "fedagg_dequant": int8_launches, "dequant_install": int8_launches,
               "dequantize_int8": socket_launches, "trimmed_mean": robust_launches,
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
