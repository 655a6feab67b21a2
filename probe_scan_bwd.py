"""Time the parts of the scans' backward kernels on one card.

For a directory of kernel sources (``--csrc``, by default the committed
``src/repro_torch/csrc``), builds ``rwkv6_scan_bwd.cu`` and
``mamba_scan_bwd.cu`` and variants made from them by text substitution,
holds each library's full kernel to the plain backward at the path's
shape (``chip_smoke.py``'s inputs and gate: rtol 1e-5, atol 1e-5 of each
gradient's largest value), and times, as CUDA-graph medians in the order
a b b a:

- ``rwkv6_scan_bwd`` at rwkv6-7b's training shape [2, 64, 1024, 64]; where
  the source keeps a stage's states in a global scratch area (the first
  design), also the same kernel with the scratch stores and loads removed
  (the walk reads the last recomputed state instead: wrong gradients, the
  time of everything but that traffic); where it runs a cluster barrier a
  sub-stage with a relaxed arrive (the second design), also the same
  kernel with the release arrive (right gradients, a GPU-wide memory
  barrier a sub-stage) and with the walk's shuffles replaced by copies
  (wrong gradients, the time of everything but the shuffles);
- ``mamba_scan_bwd`` at Jamba's [2, 512, 16384] x 16: the whole call, the
  walk kernel alone and the kernel that adds the blocks' partials of dB
  and dC alone (from the source's own entry points where it has them,
  else from variants that skip the other launch).

Usage, from the repository root on a machine with a card and ``nvcc``
(to probe an older design, unpack its tree and pass its sources)::

    python3 probe_scan_bwd.py [--csrc DIR]
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the first design's scratch traffic (rwkv6_scan_bwd.cu, an L2 scratch area a stage)
_SCR_STORE = ("scr[(t * 8 + q) * kThreads + tid] = make_float4(s[a][b], s[a][b + 1], "
              "s[a][b + 2],\n                                                        "
              "s[a][b + 3]);")
_SCR_FIRST = "for (int q = 0; q < 8; ++q) cur[q] = scr[((nt - 1) * 8 + q) * kThreads + tid];"
_SCR_NEXT = "for (int q = 0; q < 8; ++q) nxt[q] = scr[((t - 1) * 8 + q) * kThreads + tid];"
# the second design's cluster barrier (rwkv6_scan_bwd.cu, clusters of 32-row blocks)
_RELAXED = 'asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: "memory");'
_RELEASE = 'asm volatile("barrier.cluster.arrive.release.aligned;\\n" ::: "memory");'
# the first design's two launches (mamba_scan_bwd.cu, the forward's channel split)
_WALK_LAUNCH = "  mamba_scan_bwd_kernel<G, NPER><<<grid"
_REDUCE_IF = "  if (n > 0) {"


def _params(text: str, symbol: str) -> int:
    m = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text)
    return len(m.group(1).split(",")) if m else 0


def _variants(rwkv: str, mamba: str) -> dict:
    """Library name -> (kernel file, CUDA source)."""
    out = {"rwkv": ("rwkv6_scan_bwd", rwkv), "mamba": ("mamba_scan_bwd", mamba)}
    if _SCR_STORE in rwkv:
        state = ("make_float4(s[q / 2][4 * (q % 2)], s[q / 2][4 * (q % 2) + 1], "
                 "s[q / 2][4 * (q % 2) + 2], s[q / 2][4 * (q % 2) + 3])")
        out["rwkv no scratch"] = ("rwkv6_scan_bwd", rwkv.replace(_SCR_STORE, "(void)a; (void)b;")
                                  .replace(_SCR_FIRST, "for (int q = 0; q < 8; ++q) cur[q] = "
                                           + state + ";")
                                  .replace(_SCR_NEXT, "for (int q = 0; q < 8; ++q) nxt[q] = "
                                           "cur[q];"))
    if _RELAXED in rwkv:
        out["rwkv release arrive"] = ("rwkv6_scan_bwd", rwkv.replace(_RELAXED, _RELEASE))
        fake = ("__device__ __forceinline__ float fake_shfl(unsigned, float v, int) "
                "{ return v; }\n")
        out["rwkv no shuffles"] = ("rwkv6_scan_bwd", rwkv.replace(
            "namespace {\n", "namespace {\n" + fake, 1).replace("__shfl_xor_sync(", "fake_shfl("))
    if "mamba_scan_bwd_walk_f32" not in mamba:
        for old in (_WALK_LAUNCH, _REDUCE_IF):
            if old not in mamba:
                raise SystemExit(f"probe_scan_bwd: {old!r} not in mamba_scan_bwd.cu")
        out["mamba walk"] = ("mamba_scan_bwd", mamba.replace(_REDUCE_IF, "  if (false && n > 0) {"))
        out["mamba reduce"] = ("mamba_scan_bwd", mamba.replace(_WALK_LAUNCH,
                                                               "  if (false)" + _WALK_LAUNCH))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--csrc", type=Path, default=None)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_scan_bwd: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import rwkv6_scan as rs

    csrc = args.csrc or build.CSRC
    rwkv_src = (csrc / "rwkv6_scan_bwd.cu").read_text()
    mamba_src = (csrc / "mamba_scan_bwd.cu").read_text()
    out_dir = build.BUILD_DIR / "probe_scan_bwd"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (_, text)) in enumerate(_variants(rwkv_src, mamba_src).items()):
        cu, lib = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                                         "-o", str(lib), str(cu)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"probe_scan_bwd: nvcc failed for {name}:\n{log}", file=sys.stderr)
            return 1
        print(f"{name}: " + "; ".join(line.strip() for line in log.splitlines()
                                     if "registers" in line or "spill" in line))
        libs[name] = ctypes.CDLL(str(lib))
    _P, _I = ctypes.c_void_p, ctypes.c_int64
    stream = build.stream
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(27)

    # rwkv6_scan_bwd at 21c's shape
    nargs = _params(rwkv_src, "rwkv6_scan_bwd_f32")
    scratch = nargs == 19                       # the first design's scratch pointer
    for name in (n for n in libs if n.startswith("rwkv")):
        fn = libs[name].rwkv6_scan_bwd_f32
        fn.argtypes = [_P] * (nargs - 5) + [_I] * 4 + [_P]
        fn.restype = ctypes.c_int
    b, h, l, d = cs.RWKV_TRAIN
    xs, dout, dstate = cs._rwkv_bwd_inputs(torch, dev, cs.RWKV_TRAIN, "mid", gen)
    _, _, ckpt = rs.rwkv6_scan_cuda(*xs, with_ckpt=True)
    scr = torch.empty((b * h, rs.CKPT_STEPS, d, d), device=dev) if scratch else None

    def rwkv(name):
        grads = [torch.empty_like(t) for t in xs[:4]] + [torch.zeros(b, h, d, device=dev)]
        ptrs = [t.data_ptr() for t in (*xs, ckpt, dout, dstate)]
        ptrs += [scr.data_ptr()] if scratch else []
        err = libs[name].rwkv6_scan_bwd_f32(*ptrs, *(g.data_ptr() for g in grads), b, h, l, d,
                                            stream())
        if err:
            raise RuntimeError(f"{name}: launch failed, CUDA error {err}")
        return grads

    want = ref.rwkv6_scan_bwd_ref(*xs, dout, dstate, rows=True)
    got = rwkv("rwkv")
    torch.cuda.synchronize()
    err = max(cs._close_scaled(torch, a, w, f"rwkv grad {i}")
              for i, (a, w) in enumerate(zip(got, want)))
    print(f"rwkv6_scan_bwd {list(cs.RWKV_TRAIN)}: max |err| {err:.3e} against the plain backward")
    names = [n for n in libs if n.startswith("rwkv")]
    times = {n: [] for n in names}
    for name in names + names[::-1]:
        times[name].append(cs.time_ms(lambda: rwkv(name))[0])
    print(f"rwkv6_scan_bwd {list(cs.RWKV_TRAIN)}: " + "; ".join(
        f"{n} {t[0]:.4f}, {t[1]:.4f} ms" for n, t in times.items()))
    del xs, dout, dstate, ckpt, scr, want, got

    # mamba_scan_bwd at Jamba's shape
    b, l, di, ds = cs.MAMBA_FULL
    xs, dy, dstate = cs._mamba_bwd_inputs(torch, dev, cs.MAMBA_FULL, -3.0, gen)
    _, _, ckpt = ms.mamba_scan_cuda(*xs, with_ckpt=True)
    nargs = _params(mamba_src, "mamba_scan_bwd_f32")
    parts = (torch.empty((-(-di // 32), b, l, ds), device=dev),
             torch.empty((-(-di // 32), b, l, ds), device=dev))
    outs = [torch.empty_like(xs[0]), torch.empty_like(xs[1]), torch.empty_like(xs[2]),
            torch.empty_like(xs[3]), torch.zeros(b, di, ds, device=dev)]
    ptrs = [t.data_ptr() for t in (*xs, ckpt, dy, dstate, *outs)]
    ptrs += [p.data_ptr() for p in parts][:nargs - 5 - len(ptrs)]
    calls = {}
    for name in (n for n in libs if n.startswith("mamba")):
        fn = libs[name].mamba_scan_bwd_f32
        fn.argtypes = [_P] * (nargs - 5) + [_I] * 4 + [_P]
        fn.restype = ctypes.c_int
        calls[name] = (fn, ptrs)
    if "mamba walk" not in libs:
        for part in ("walk", "reduce"):
            fn = getattr(libs["mamba"], f"mamba_scan_bwd_{part}_f32")
            fn.argtypes = [_P] * (nargs - 5) + [_I] * 4 + [_P]
            fn.restype = ctypes.c_int
            calls[f"mamba {part}"] = (fn, ptrs)

    def mamba(name):
        fn, p = calls[name]
        err = fn(*p, b, l, di, ds, stream())
        if err:
            raise RuntimeError(f"{name}: launch failed, CUDA error {err}")

    mamba("mamba")
    torch.cuda.synchronize()
    want = ref.mamba_scan_bwd_ref(*xs, dy, dstate, rows=True)
    err = max(cs._close_scaled(torch, a, w, f"mamba grad {i}")
              for i, (a, w) in enumerate(zip(outs, want)))
    print(f"mamba_scan_bwd {list(cs.MAMBA_FULL)}: max |err| {err:.3e} against the plain backward")
    names = list(calls)
    times = {n: [] for n in names}
    for name in names + names[::-1]:
        times[name].append(cs.time_ms(lambda: mamba(name))[0])
    print(f"mamba_scan_bwd {list(cs.MAMBA_FULL)}: " + "; ".join(
        f"{n} {t[0]:.4f}, {t[1]:.4f} ms" for n, t in times.items()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
