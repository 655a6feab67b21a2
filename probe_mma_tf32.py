"""The TF32 rate of ``mma.sync.m16n8k8`` on one card, against its 495 TFLOP/s,
and the bf16 rate of ``wgmma.mma_async.m64nNk16``, against its 989.

``probe_mma_tf32.cu`` runs the instruction from registers with no
memory traffic in the loop, one accumulator chain or several (ILP 1, 2, 4,
8) a warp, at 8, 16 and 64 warps an SM (full occupancy), and once more
with a 3xTF32 step a chain (a split of one accumulator word into TF32 hi
and lo, then the three products), as the attention kernels spend it.
Each configuration is timed over one launch of many rounds with CUDA
events after a warm-up launch, and its rate is printed in TFLOP/s (2048
flops an instruction) beside the card's published dense TF32 peak, with
the card's name and power limit.  The last line is one JSON object of
every rate.

The rate bounds what a kernel built on ``mma.sync`` (the attention
forward and backward) can reach at all: its share of 495 TFLOP/s is the
ceiling of their 3xTF32 bound shares.

Then ``wgmma_bf16_rate`` runs the bf16 warpgroup product at N 64, 128 and
256 with both operands in shared memory (ss) or A in registers (rs), in
the swizzled layout of ``src/repro_torch/csrc/wgmma_bf16.cuh``, at 1, 2
and 3 warpgroups a block (1 and 2 at N 256) and one block an SM, 16
products a commit: the
ceiling of the bf16 attention kernels (``flash_attention_bf16.cu``,
``flash_attention_bwd_bf16.cu``), printed against the 989 TFLOP/s dense
bf16 peak.

Usage, from the repository root on a machine with a card and ``nvcc``::

    python3 probe_mma_tf32.py
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_TF32 = 495e12                      # H100 SXM, dense (NVIDIA's data sheet)
PEAK_BF16 = 989e12
FLOPS = 16 * 8 * 8 * 2                  # one m16n8k8
THREADS = 128                           # 4 warps a block


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_mma_tf32: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    out_dir = build.BUILD_DIR / "probe_mma_tf32"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libprobe_mma_tf32.so"
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                           str(lib_path), str(ROOT / "probe_mma_tf32.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        print(f"probe_mma_tf32: nvcc failed:\n{proc.stdout}{proc.stderr}", file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_tf32_rate.argtypes = [ctypes.c_int64] * 5 + [ctypes.c_void_p] * 2
    lib.mma_tf32_rate.restype = ctypes.c_int
    lib.wgmma_bf16_rate.argtypes = [ctypes.c_int64] * 5 + [ctypes.c_void_p] * 2
    lib.wgmma_bf16_rate.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"{smi}; {sms} SMs; torch {torch.__version__}, CUDA {torch.version.cuda}")

    def rate(ilp: int, split: bool, warps_per_sm: int, iters: int) -> float:
        blocks = sms * warps_per_sm // (THREADS // 32)
        out = torch.empty(blocks * THREADS, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            err = lib.mma_tf32_rate(ilp, int(split), blocks, THREADS, iters, out.data_ptr(),
                                    stream)
            if err:
                raise RuntimeError(f"probe_mma_tf32: launch failed, CUDA error {err}")
        run()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        mmas = blocks * (THREADS // 32) * iters * ilp * (3 if split else 1)
        return mmas * FLOPS / (ms * 1e-3)

    rates = {}
    for split in (False, True):
        for warps in (8, 16, 64):
            for ilp in (1, 2, 4, 8):
                iters = max(1000, 40_000 // (ilp * (3 if split else 1)) // max(1, warps // 16))
                r = rate(ilp, split, warps, iters)
                key = f"{'3xtf32+split' if split else 'tf32'} warps/SM={warps} ILP={ilp}"
                rates[key] = r
                print(f"{key}: {r / 1e12:.1f} TFLOP/s of TF32 products, "
                      f"{100 * r / PEAK_TF32:.1f}% of {PEAK_TF32 / 1e12:.0f}")
    best = max(rates, key=rates.get)
    print(f"best: {best}, {rates[best] / 1e12:.1f} TFLOP/s ({100 * rates[best] / PEAK_TF32:.1f}% "
          f"of {PEAK_TF32 / 1e12:.0f}); {smi}")

    def wgmma_rate(n: int, rs: bool, warpgroups: int, iters: int) -> float:
        out = torch.empty(sms * warpgroups * 128, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            err = lib.wgmma_bf16_rate(n, int(rs), sms, warpgroups, iters, out.data_ptr(),
                                      stream)
            if err:
                raise RuntimeError(f"probe_mma_tf32: wgmma launch failed, CUDA error {err}")
        run()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return sms * warpgroups * iters * 16 * 2 * 64 * n * 16 / (start.elapsed_time(end) * 1e-3)

    bf16 = {}
    for n, rs in ((64, False), (128, False), (64, True), (128, True), (256, True)):
        # three warpgroups of n256's 128 accumulators a thread exceed the SM's registers
        for warpgroups in (1, 2) if n == 256 else (1, 2, 3):
            r = wgmma_rate(n, rs, warpgroups, 20_000 * 64 // n)
            key = f"wgmma m64n{n}k16 {'rs' if rs else 'ss'} warpgroups/SM={warpgroups}"
            bf16[key] = r
            print(f"{key}: {r / 1e12:.1f} TFLOP/s of bf16 products, "
                  f"{100 * r / PEAK_BF16:.1f}% of {PEAK_BF16 / 1e12:.0f}")
    top = max(bf16, key=bf16.get)
    print(f"best bf16: {top}, {bf16[top] / 1e12:.1f} TFLOP/s "
          f"({100 * bf16[top] / PEAK_BF16:.1f}% of {PEAK_BF16 / 1e12:.0f}); {smi}")
    print(json.dumps({"card": smi, "peak_tflops": PEAK_TF32 / 1e12,
                      "tflops": {k: v / 1e12 for k, v in rates.items()},
                      "peak_bf16_tflops": PEAK_BF16 / 1e12,
                      "bf16_tflops": {k: v / 1e12 for k, v in bf16.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
