"""Where one round of the main path spends its time on the card.

    python -m repro_torch.launch.profile_round [--trace DIR] [--int8]
        [--aggregator SPEC] [--adversary SPEC] [--tokens]

(with ``src`` on ``PYTHONPATH``).  Runs the full-width SA-Net dose FedAvg
job (``configs/sanet_openkbp.OPENKBP_TASK``; with ``--tokens``, the token
task at smollm-135m's published width, ``TOKEN_TASK``: 4 sites, 4 x 2048
tokens a site step) for 2 rounds through
``FederatedJob.run`` (with ``--int8``: int8 uploads and downloads,
``compression="int8", down_compression="int8"``; ``--aggregator`` and
``--adversary`` are the job's robust combine rule and adversary, e.g.
``--aggregator trimmed:1 --adversary sign_flip:1``) and traces round 1
with ``torch.profiler`` (round 0 carries the first-call set-up and is
not traced).  Prints the round's own times from the job's history
(``batch_s``, ``step_s``, ``wall_s``), the device busy time and idle
share, and the device time of each kernel group and of the top kernels.
The idle share of the step leaves out the batches' host-to-device copy,
which ``batch_s`` holds.  With ``--trace DIR`` the Chrome trace is
written there.  Needs a card; it refuses to run on the CPU.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
from collections import defaultdict

import torch

from repro_torch.api import FederatedJob, TaskConfig
from repro_torch.configs.sanet_openkbp import OPENKBP_TASK
from repro_torch.kernels.ops import KERNELS, symbol_pattern

TOKEN_TASK = dict(kind="tokens", arch="smollm-135m", reduced=False, seq=2048, batch=4, sites=4)
GROUPS = [  # (group, regex over the kernel name), first match wins
    ("attention_bwd", symbol_pattern("flash_attention_bwd")),
    ("attention", symbol_pattern("flash_attention")),
    ("int8_codec", r"quantize_int8|fedagg_dequant|dequant_install"),
    ("robust", r"trimmed_mean"),
    ("fedagg", r"fedagg"),
    ("batch_h2d", r"Memcpy HtoD"),      # the round's host batches (in batch_s)
    ("conv", r"conv|cudnn|implicit|wgrad|dgrad|winograd"),
    ("gemm", r"gemm|gemv|sm90|xmma|cutlass|splitK|Kernel2"),
    ("softmax", r"softmax|LogSoftMax|SoftMax"),
    ("embed_gather", r"index|gather|scatter|Indexing|embedding"),
    ("group_norm", r"group_norm|GroupNorm|RowwiseMoments|ComputeFused|Welford"),
    ("resize", r"upsample|interp|nearest"),
    ("reduce", r"reduce|Reduce|sum|mean"),
    ("copy", r"copy|Memcpy|Memset|cat|CatArray"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
]
TOP = 15


def group_of(name: str) -> str:
    for group, pat in GROUPS:
        if re.search(pat, name):
            return group
    return "other"


def port_kernels(kernels) -> dict:
    """Device ms and calls of each of the port's own kernels, found by the
    names of its ``__global__`` functions (``ops.symbol_pattern``)."""
    out = {}
    for name in KERNELS:
        hits = [v for n, v in kernels.items() if re.search(symbol_pattern(name), n)]
        out[name] = {"ms": sum(v[0] for v in hits) / 1e3, "calls": sum(v[1] for v in hits)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", default=None, help="directory for the Chrome trace")
    ap.add_argument("--int8", action="store_true",
                    help="int8 uploads and downloads (the compressed rounds)")
    ap.add_argument("--aggregator", default="fedavg",
                    help="combine rule: fedavg | trimmed:f | median | krum:f | normclip:c")
    ap.add_argument("--adversary", default=None,
                    help="sign_flip:f | scale:c:f | label_flip:f (default: none)")
    ap.add_argument("--tokens", action="store_true",
                    help="the token task at smollm-135m's published width (TOKEN_TASK)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_round: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())

    traced = []

    def on_trace_ready(prof):
        traced.extend(prof.events())
        if args.trace:
            prof.export_chrome_trace(f"{args.trace}/round_trace.json")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    codec = "int8" if args.int8 else "none"
    task = TOKEN_TASK if args.tokens else OPENKBP_TASK
    job = FederatedJob(task=TaskConfig(**task), strategy="fedavg", rounds=2,
                       compression=codec, down_compression=codec,
                       aggregator=args.aggregator, adversary=args.adversary)
    with torch.profiler.profile(
            activities=acts, on_trace_ready=on_trace_ready,
            schedule=torch.profiler.schedule(wait=1, warmup=0, active=1,
                                             repeat=1)) as prof:
        result = job.run(on_round=lambda r: prof.step())

    groups = defaultdict(float)
    kernels = defaultdict(lambda: [0.0, 0])
    for ev in traced:
        # the device track also holds the profiler's own step span
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not ev.name.startswith("ProfilerStep")):
            us = ev.time_range.elapsed_us()
            groups[group_of(ev.name)] += us
            kernels[ev.name][0] += us
            kernels[ev.name][1] += 1
    if not groups:
        raise SystemExit("profile_round: torch.profiler recorded no device "
                         "kernels; time the round with CUDA events instead")
    busy_s = sum(groups.values()) / 1e6
    h = result.history[1]
    report = {
        "device": torch.cuda.get_device_name(0), "task": task,
        "compression": codec, "down_compression": codec,
        "aggregator": args.aggregator, "adversary": args.adversary,
        "round": 1, "batch_s": h["batch_s"], "step_s": h["step_s"],
        "wall_s": h["wall_s"], "device_busy_s": busy_s,
        "device_idle_share_of_round": 1.0 - busy_s / h["wall_s"],
        "device_idle_share_of_step":
            1.0 - (busy_s - groups["batch_h2d"] / 1e6) / h["step_s"],
        "groups_ms": {g: us / 1e3 for g, us in sorted(groups.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": n[:120], "ms": v[0] / 1e3, "calls": v[1]}
                        for n, v in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]],
        "port_kernels": port_kernels(kernels),
        "untraced_round_0": {k: result.history[0][k]
                             for k in ("batch_s", "step_s", "wall_s")},
        "loss": result.losses,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
