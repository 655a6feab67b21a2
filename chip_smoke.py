#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it goes wrong:

1. the card's name and power limit, then a build of every hand-written
   kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per source, all
   started together);
2. each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged ones, with stated tolerances, then
   its time beside its bound, the plain version's time and one library
   call's time (CUDA events, median of 25 after a warm-up);
3. the main path through the port's own entry point: a full-width SA-Net
   (11 channels, 24 filters, 4 levels, 128^3 OpenKBP volumes) trained by
   4-site FedAvg for 2 sync rounds, with random weights from a seed.
   Every kernel's launch count is zeroed just before and read just after;
4. a small job run on the card and on the CPU (the plain versions),
   whose per-round losses must agree.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or outside
a checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROUNDS = 2
FP32_TOL = dict(rtol=1e-6, atol=1e-6)    # FMA contraction and sum order differ
BF16_TOL = dict(rtol=2e-2, atol=2e-2)    # one bf16 rounding of the output
# Published peaks (NVIDIA data sheets, dense): memory bytes/s and fp32
# (non-tensor-core) FLOP/s, by the name torch.cuda reports.
PEAKS = {"H100 80GB HBM3": (3.35e12, 67e12), "H100 PCIe": (2.0e12, 51e12),
         "H100 NVL": (3.9e12, 60e12), "H200": (4.8e12, 67e12)}


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise SystemExit(f"chip_smoke: no published peak rates for {name!r}")


def time_ms(fn, *args, warmup: int = 3, reps: int = 25) -> float:
    import torch
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def check_fedagg(torch, fedagg, ref, dev):
    """fedagg vs its plain version; returns (fp32 max |err|, timings)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    main_n = 6_844_323                  # full-width SA-Net parameter count
    cases = [(4, main_n)] + [(s, n) for s in (1, 3, 16) for n in (1, 127, 65_537)]
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
            if n == main_n:
                print(f"fedagg [{s}, {n}] {dtype}: max |kernel - plain| = {err:.3e}")
    print(f"fedagg: {len(cases)} shapes x 2 dtypes agree with the plain version "
          f"(fp32 rtol=atol=1e-6, bf16 rtol=atol=2e-2)")
    x = torch.randn(4, main_n, device=dev, generator=gen)
    w = torch.full((4,), 0.25, device=dev)
    timing = {"ms": time_ms(fedagg.fedagg_cuda, x, w),
              "plain_ms": time_ms(ref.fedagg_ref, x, w),
              "library_ms": time_ms(torch.matmul, w, x)}
    mem_rate, fp32_rate = peaks(torch.cuda.get_device_name(0))
    nbytes = (x.numel() + w.numel() + main_n) * 4
    flops = 2 * x.numel()
    bytes_ms, ops_ms = 1e3 * nbytes / mem_rate, 1e3 * flops / fp32_rate
    timing["bound_ms"] = max(bytes_ms, ops_ms)
    timing["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"fedagg [4, {main_n}] fp32: kernel {timing['ms']:.4f} ms, bound "
          f"{timing['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB at "
          f"{mem_rate / 1e12:.2f} TB/s), plain {timing['plain_ms']:.4f} ms, "
          f"w @ x {timing['library_ms']:.4f} ms")
    return err32, timing


def run_main_path(torch, FederatedJob, TaskConfig, build, task):
    torch.backends.cudnn.allow_tf32 = True         # PyTorch's default, stated
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default, stated
    print("main path: cudnn.allow_tf32=True, matmul.allow_tf32=False")
    job = FederatedJob(task=TaskConfig(**task), strategy="fedavg",
                       rounds=ROUNDS)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    result = job.run()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    for h in result.history:
        print(f"round {h['round']}: loss {h['loss']:.6f} per-site "
              f"{[round(v, 6) for v in h['per_site_loss']]} batch_s "
              f"{h['batch_s']:.4f} step_s {h['step_s']:.4f} wall_s {h['wall_s']:.4f}")
    n_params = sum(t.numel() for t in _leaves(result.global_params))
    peak = torch.cuda.max_memory_allocated()
    print(f"main path: {ROUNDS} rounds in {wall:.1f} s with set-up, {n_params} parameters, "
          f"peak memory {peak / 2**30:.2f} GiB")
    print(f"kernels launched on the main path: {launches}")
    if not all(math.isfinite(v) for h in result.history for v in h["per_site_loss"]):
        raise SystemExit("chip_smoke: non-finite loss on the main path")
    if n_params != 6_844_323:
        raise SystemExit(f"chip_smoke: expected 6,844,323 parameters, got {n_params}")
    if not all(bool(torch.isfinite(t).all()) for t in _leaves(result.global_params)):
        raise SystemExit("chip_smoke: non-finite global parameters")
    if launches.get("fedagg", 0) < ROUNDS:
        raise SystemExit(f"chip_smoke: fedagg launched {launches.get('fedagg', 0)} "
                         f"times on the main path, expected >= {ROUNDS}")
    return launches


def check_small_job(torch, FederatedJob, TaskConfig):
    """The same small job on the card and on the CPU (plain versions);
    the CPU path is held to the JAX reference by tests/test_torch_job.py.
    TF32 off so both sides compute in fp32; tolerance 1e-4 relative,
    since sum orders differ and AdamW's first step amplifies noise on
    near-zero gradients."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    job = FederatedJob(task=TaskConfig(kind="dose", sites=3, batch=2),
                       rounds=3, max_dropout=1)
    gpu = job.run().losses
    cpu = job.replace(device="cpu").run().losses
    print(f"small job losses: cuda {gpu} cpu {cpu}")
    for g, c in zip(gpu, cpu):
        if not math.isclose(g, c, rel_tol=1e-4, abs_tol=1e-6):
            raise SystemExit(f"chip_smoke: cuda loss {g} != cpu loss {c}")


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
    from repro_torch.configs.sanet_openkbp import OPENKBP_TASK
    from repro_torch.kernels import build, fedagg, ops, ref

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.build(list(ops.KERNELS))
    print(f"built {sorted(ops.KERNELS)} in {time.perf_counter() - t0:.1f} s")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    err32, timing = check_fedagg(torch, fedagg, ref, torch.device("cuda"))
    launches = run_main_path(torch, FederatedJob, TaskConfig, build, OPENKBP_TASK)
    check_small_job(torch, FederatedJob, TaskConfig)

    kernels = []
    for name, (route, source, replaces) in ops.KERNELS.items():
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": launches.get(name, 0),
                        "max_abs_err": err32, **timing})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
