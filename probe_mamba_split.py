"""Time the design choices of ``src/repro_torch/csrc/mamba_scan.cu`` on one card.

Builds the committed kernel and three variants made from its source by
text substitution, holds each to the plain version (``chip_smoke.py``'s
shapes, inputs and gate: a row of A for each channel, rtol 1e-5 and atol
1e-5 of the largest value, y and the final state), prints each ds-16
instance's registers, shared memory and blocks an SM, and times each at
Jamba-1.5-Large's per-layer prefill shape, [2, 512, 16384] at d_state 8, 16
and 32 (CUDA-graph medians, in the order a b c d d c b a):

- ``warps 2x8``: the committed kernel (ds 16: a channel's state over 2
  warps, 8 states a thread, y's partials summed through shared memory);
- ``warps 4x4``: the same with ds 16 over 4 warps of 4 states;
- ``lanes 4x4``: ds 16 over 4 lanes of one warp, 4 states a lane, y_t
  reduced over the lanes with ``__shfl_xor_sync`` (the other d_state
  instances split over lanes too);
- ``expf``: the committed kernel with the accurate ``expf`` in place of
  ``ex2.approx``.

Everything else (the ``cp.async`` ring, the unpredicated whole stage, the
16-byte copies) is the committed kernel's in every variant.

Usage, from the repository root on a machine with a card and ``nvcc``::

    python3 probe_mamba_split.py
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES = [(2, 512, 16384, ds) for ds in (8, 16, 32)]


def _variants(src: str) -> dict:
    """Variant name -> CUDA source, each made from the committed ``src``."""
    def sub(text: str, old: str, new: str) -> str:
        if old not in text:
            raise SystemExit(f"probe_mamba_split: {old!r} not in mamba_scan.cu")
        return text.replace(old, new)

    ds16 = sub(sub(src, "if (ds <= 16) return launch<2, 8>", "if (ds <= 16) return launch<4, 4>"),
               "if (ds <= 16) return resources<2, 8>", "if (ds <= 16) return resources<4, 4>")
    lanes = sub(ds16, "const int g = w % G, cl = (w / G) * 32 + lane;",
                "constexpr int kPer = 32 / G;             // channels a warp\n"
                "  const int g = lane / kPer, cl = w * kPer + lane % kPer;")
    lanes = sub(lanes, "      sm.part[g][t][cl] = acc;",
                "#pragma unroll\n"
                "      for (int off = kPer; off < 32; off <<= 1)\n"
                "        acc += __shfl_xor_sync(0xffffffffu, acc, off);\n"
                "      if (g == 0) sm.part[0][t][cl] = acc;")
    expf = sub(sub(src, " * kLog2e : 0.0f", " : 0.0f"),
               "ex2_approx(dtv * a2[n])", "expf(dtv * a2[n])")
    return {"warps 2x8": src, "warps 4x4": ds16, "lanes 4x4": lanes, "expf": expf}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_mamba_split: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build, ref

    out_dir = build.BUILD_DIR / "probe_mamba_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = _variants((build.CSRC / "mamba_scan.cu").read_text())
    procs = {}
    for i, (name, text) in enumerate(srcs.items()):
        cu = out_dir / f"v{i}.cu"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o",
                                         str(out_dir / f"libv{i}.so"), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out_dir / f"libv{i}.so")
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"probe_mamba_split: nvcc failed for {name}:\n{log}", file=sys.stderr)
            return 1
        libs[name] = ctypes.CDLL(str(lib))
    _P, _I = ctypes.c_void_p, ctypes.c_int64
    for lib in libs.values():
        lib.mamba_scan_f32.argtypes = [_P] * 8 + [_I] * 4 + [_P]
        lib.mamba_scan_f32.restype = ctypes.c_int
        lib.mamba_scan_resources.argtypes = [_I, ctypes.POINTER(ctypes.c_int)]
        lib.mamba_scan_resources.restype = ctypes.c_int

    def scan(name, dt, bm, cm, x, log_a):
        b, l, di = dt.shape
        ds = log_a.shape[1]
        y = torch.empty_like(dt)
        state = torch.empty(b, di, ds, device=dt.device)
        err = libs[name].mamba_scan_f32(
            dt.data_ptr(), bm.data_ptr(), cm.data_ptr(), x.data_ptr(), log_a.data_ptr(),
            y.data_ptr(), state.data_ptr(), None, b, l, di, ds,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: launch failed, CUDA error {err}")
        return y, state

    res = (ctypes.c_int * 5)()
    for name, lib in libs.items():
        if lib.mamba_scan_resources(16, res):
            raise RuntimeError(f"{name}: mamba_scan_resources failed")
        print(f"{name} d_state<=16: {res[0]} registers, local {res[1]} B, shared {res[2]} B, "
              f"{res[3]} threads, {res[4]} blocks an SM")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    worst = dict.fromkeys(libs, 0.0)
    for shape in cs.MAMBA_CASES + [cs.MAMBA_FULL]:
        xs = cs._mamba_inputs(torch, dev, shape, gen)
        want_y, want_state = ref.mamba_scan_ref(*xs)
        for name in libs:
            y, state = scan(name, *xs)
            torch.cuda.synchronize()
            worst[name] = max(worst[name],
                              cs._close_scaled(torch, y, want_y, f"{name} y {shape}"),
                              cs._close_scaled(torch, state, want_state, f"{name} state {shape}"))
    print(f"every variant agrees with the plain version at {len(cs.MAMBA_CASES) + 1} shapes "
          f"(rtol {cs.SCAN_RTOL}, atol {cs.SCAN_RTOL} of the largest value); max |err|: "
          + ", ".join(f"{n} {e:.3e}" for n, e in worst.items()))

    order = list(libs) + list(libs)[::-1]
    for shape in SHAPES:
        xs = cs._mamba_inputs(torch, dev, shape, gen)
        times = {name: [] for name in libs}
        for name in order:
            times[name].append(cs.time_ms(lambda: scan(name, *xs))[0])
        print(f"{list(shape)}: " + "; ".join(
            f"{n} {t[0]:.4f}, {t[1]:.4f} ms" for n, t in times.items()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
