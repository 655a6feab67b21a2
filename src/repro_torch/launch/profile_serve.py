"""Where one full-width serving call spends its time on the card.

    python -m repro_torch.launch.profile_serve [--arch gemma3-1b] [--batch 4]
        [--prompt-len 1024] [--decode-steps 8] [--layers N] [--trace DIR]

(with ``src`` on ``PYTHONPATH``).  Serves the published config of
``--arch`` (fp32 weights from a seed, TF32 off) through
``launch.serve.generate``: one untraced warm-up call (kernel builds,
cuBLAS set-up), then one traced call of a prefill and ``--decode-steps``
decode steps under ``torch.profiler``.  ``--layers N`` cuts the config to
its first N layers at its published widths (Jamba-1.5-Large does not fit
one card: ``--arch jamba-1.5-large-398b --layers 2 --batch 2 --prompt-len
512`` is the cell ``chip_smoke.py`` serves).  Prints the traced call's
prefill and decode wall times, the device busy time and idle share of
the call, and the device time by group (the port's kernels by name,
GEMMs, norms and elementwise passes, copies) and of the top kernels.
With ``--trace DIR`` the Chrome trace is written there.  Needs a card;
it refuses to run on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
from collections import defaultdict

import torch

from repro_torch.configs.registry import get_token_arch
from repro_torch.kernels.ops import KERNELS, symbol_pattern
from repro_torch.launch import serve
from repro_torch.models import transformer as T

GROUPS = [  # (group, regex over the kernel name), first match wins
    *[(name, symbol_pattern(name)) for name in KERNELS],
    ("gemm", r"gemm|gemv|sm90|xmma|cutlass|splitK|ampere|Kernel2"),
    ("softmax_reduce", r"softmax|reduce|Reduce|argmax|max|sum"),
    ("copy", r"copy|Memcpy|Memset|cat|CatArray|index|gather|scatter|transpose"),
    ("norm_elementwise", r"elementwise|vectorized|unrolled|norm|pow|rsqrt|exp|tanh|gelu"),
]
TOP = 15


def group_of(name: str) -> str:
    for group, pat in GROUPS:
        if re.search(pat, name):
            return group
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024, dest="prompt_len")
    ap.add_argument("--decode-steps", type=int, default=8, dest="decode_steps",
                    help="decode steps after the prefill")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to its first N layers (default: all)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, help="directory for the Chrome trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_token_arch(args.arch).CONFIG
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = T.init(gen, cfg, "cuda")
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device="cuda")
    serve.generate(params, prompts, cfg, 2)                  # warm-up, untraced
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = serve.generate(params, prompts, cfg, args.decode_steps + 1)
    if args.trace:
        prof.export_chrome_trace(f"{args.trace}/serve_trace.json")

    groups = defaultdict(float)
    kernels = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = ev.time_range.elapsed_us()
            groups[group_of(ev.name)] += us
            kernels[ev.name][0] += us
            kernels[ev.name][1] += 1
    if not groups:
        raise SystemExit("profile_serve: torch.profiler recorded no device kernels; "
                         "time the call with CUDA events instead")
    busy_s = sum(groups.values()) / 1e6
    wall_s = out["prefill_s"] + out["decode_s"]
    report = {
        "device": torch.cuda.get_device_name(0), "arch": cfg.name,
        "layers": cfg.num_layers, "batch": args.batch, "prompt_len": args.prompt_len,
        "decode_steps": args.decode_steps, "matmul_allow_tf32": False,
        "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
        "device_busy_s": busy_s, "device_idle_share": 1.0 - busy_s / wall_s,
        "groups_ms": {g: us / 1e3 for g, us in sorted(groups.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": n[:120], "ms": v[0] / 1e3, "calls": v[1]}
                        for n, v in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]],
        "prefill_launches": out["prefill_launches"],
        "decode_launches": out["decode_launches"],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
