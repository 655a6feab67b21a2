"""Time the parts of the attention backward's head-dim-256 instance on one card.

For a directory of kernel sources (``--csrc``, by default the committed
``src/repro_torch/csrc``), builds ``flash_attention_bwd.cu`` and variants
made from it by text substitution, and at gemma3-1b's training shape (q [2,
4, 1024, 256], k/v [2, 1, 1024, 256], ``chip_smoke.GEMMA_TRAIN``), causal,
with its 512-key window and without:

- holds each library's call to the plain backward and prints the largest
  excess over ``chip_smoke.py``'s gate (rtol 1e-5, atol 1e-5 of each
  gradient's largest value; at most 0: met);
- times each call as a CUDA-graph median, in the order a b b a;
- splits the source's own call by kernel (``torch.profiler``, device time
  over 10 calls).

The variants, made from the cluster exchange of s and dp (``cluster_sum``;
the probe stops if the text it substitutes is missing): "no exchange"
skips it (each block forms p and ds from its own quarter of the sums:
wrong gradients, the time of everything but the exchange), and "relaxed
barriers" gives its cluster barriers a relaxed arrive in place of the
release one (no ordering of the stores before it: the time of the
release, and gradients the card does not promise).

Usage, from the repository root on a machine with a card and ``nvcc`` (to
probe an older design, unpack its tree and pass its sources)::

    python3 probe_attn_bwd_256.py [--csrc DIR]
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

_SUM_START = "  cg::cluster_group cluster = cg::this_cluster();\n  const int rank"
_SYNC = "  cluster.sync();\n"
_RELAXED = ('  asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: "memory");\n'
            '  asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");\n')


def _params(text: str, symbol: str) -> int:
    m = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text)
    return len(m.group(1).split(",")) if m else 0


def _variants(src: str) -> dict:
    """Library name -> CUDA source; refuses a source whose exchange has moved."""
    if src.count(_SUM_START) != 1 or src.count(_SYNC) != 2:
        raise SystemExit("probe_attn_bwd_256: cluster_sum's start or its two cluster.sync() "
                         "calls are not where the probe looks for them; update _SUM_START "
                         "and _SYNC to the source")
    return {"as committed": src,
            "no exchange": src.replace(_SUM_START, "  return;\n" + _SUM_START),
            "relaxed barriers": src.replace(_SYNC, _RELAXED)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--csrc", type=Path, default=None)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_attn_bwd_256: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa

    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    src = ((args.csrc or build.CSRC) / "flash_attention_bwd.cu").read_text()
    out_dir = build.BUILD_DIR / "probe_attn_bwd_256"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(_variants(src).items()):
        cu, lib = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                                         "-o", str(lib), str(cu)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    nargs = _params(src, "flash_attention_bwd_f32")
    fns = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"probe_attn_bwd_256: nvcc failed for {name}:\n{log}", file=sys.stderr)
            return 1
        print(f"{name}: " + "; ".join(line.strip() for line in log.splitlines()
                                     if "registers" in line or "spill" in line))
        fn = ctypes.CDLL(str(lib)).flash_attention_bwd_f32
        fn.argtypes = fa._BWD_ARGS if nargs == len(fa._BWD_ARGS) else \
            [ctypes.c_void_p] * (nargs - 9) + [ctypes.c_int64] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    with_part = nargs >= 20                     # the q heads' shares of dk and dv
    scale = [0.0] if nargs == len(fa._BWD_ARGS) else []    # 0: the kernel's D^-0.5

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(28)
    b, hq, hkv, lq, lk, d = cs.GEMMA_TRAIN
    for window in (None, 512):
        q, k, v = cs._flash_inputs(torch, dev, cs.GEMMA_TRAIN, torch.float32, gen)
        g = torch.randn(q.shape, device=dev, generator=gen)
        out, lse = fa.flash_attention_cuda(q, k, v, True, window, with_lse=True)
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, g, True, window)
        grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        delta = torch.empty_like(lse)
        part = [torch.empty((2, b, hq, lk, d), device=dev)] if with_part else []

        def call(name):
            ptrs = [t.data_ptr() for t in (q, k, v, out, lse, g, delta, *part, *grads)]
            err = fns[name](*ptrs, b, hq, hkv, lq, lk, d, 1, window or 0, *scale,
                            build.stream())
            if err:
                raise RuntimeError(f"{name}: launch failed, CUDA error {err}")

        what = f"{list(cs.GEMMA_TRAIN)} window={window}"
        for name in fns:
            call(name)
            torch.cuda.synchronize()
            excess = max(float(((a - w).abs() - cs.BWD_RTOL * w.abs()
                                - cs.BWD_RTOL * max(float(w.abs().max()), 1.0)).max())
                         for a, w in zip(grads, want))
            print(f"{what} {name}: largest excess over the gate {excess:.3e}")
        times = {n: [] for n in fns}
        for name in list(fns) + list(fns)[::-1]:
            times[name].append(cs.time_ms(lambda: call(name))[0])
        print(f"{what}: " + "; ".join(f"{n} {t[0]:.4f}, {t[1]:.4f} ms"
                                      for n, t in times.items()))
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call("as committed")
            torch.cuda.synchronize()
        parts = {}
        for e in prof.key_averages():
            m = re.search(r"flash_attention_bwd_(\w+?)_kernel", e.key)
            if m:
                total = getattr(e, "device_time_total", None) or e.cuda_time_total
                parts[m.group(1)] = round(total / 10 / 1e3, 4)
        print(f"{what} as committed, ms a call by kernel: {parts}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
