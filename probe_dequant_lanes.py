"""Time the load width of ``src/repro_torch/csrc/dequantize_int8.cu`` on one card.

Builds the committed kernel and a variant made from its source by text
substitution, holds both to the plain version bit for bit, prints each
one's registers and blocks an SM, and times both on one full-width SA-Net
message in the card's layout (160 leaves at align 128, ``chip_smoke.py``'s
message), as CUDA-graph medians and eager medians, in the order a b b a:

- ``word a lane``: the committed kernel (a warp a row; four int8 a lane
  from one 32-bit load, realigned to the output by a funnel shift, and one
  16-byte store; a warp's store is 512 contiguous bytes);
- ``16 a lane``: where a q row's address and width are multiples of 16
  bytes, sixteen int8 a lane from one 16-byte load (and the next word where
  the output is shifted), realigned the same way, and four 16-byte stores
  (64 contiguous bytes a lane); the rest of each row as committed.

Usage, from the repository root on a machine with a card and ``nvcc``::

    python3 probe_dequant_lanes.py
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

_WORD_PATH = "  if ((reinterpret_cast<uintptr_t>(q) & 3) == 0 && (lf.width & 3) == 0) {\n"
_LANE16 = """\
  if ((reinterpret_cast<uintptr_t>(q) & 15) == 0 && (lf.width & 15) == 0) {
    // sixteen int8 a lane: one 16-byte load, the next word where the output
    // is shifted (inside the row: 16 (t + 1) <= n - a < width), four stores
    const uint4* q128 = reinterpret_cast<const uint4*>(q);
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q);
    const int64_t g16 = groups >> 2;
    for (int64_t t = lane; t < g16; t += 32) {
      const uint4 v = __ldg(q128 + t);
      const uint32_t w[5] = {v.x, v.y, v.z, v.w, a ? __ldg(q32 + 4 * t + 4) : 0u};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        dst4[4 * t + k] = deq4(a ? __funnelshift_r(w[k], w[k + 1], 8 * a) : w[k], s);
    }
    for (int64_t t = 4 * g16 + lane; t < groups; t += 32)
      dst4[t] = deq4(a ? __funnelshift_r(__ldg(q32 + t), __ldg(q32 + t + 1), 8 * a)
                       : __ldg(q32 + t), s);
  } else if ((reinterpret_cast<uintptr_t>(q) & 3) == 0 && (lf.width & 3) == 0) {
"""


def _variants(src: str) -> dict:
    """Variant name -> CUDA source, each made from the committed ``src``."""
    if _WORD_PATH not in src:
        raise SystemExit("probe_dequant_lanes: the word path is not in dequantize_int8.cu")
    return {"word a lane": src, "16 a lane": src.replace(_WORD_PATH, _LANE16)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_dequant_lanes: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.comms.compression import WirePlan
    from repro_torch.configs.sanet_openkbp import SANET
    from repro_torch.core.agg_engine import get_engine
    from repro_torch.core.stacking import broadcast_to_sites
    from repro_torch.kernels import build, ref
    from repro_torch.models.sanet import sanet_init

    out_dir = build.BUILD_DIR / "probe_dequant_lanes"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = _variants((build.CSRC / "dequantize_int8.cu").read_text())
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
            print(f"probe_dequant_lanes: nvcc failed for {name}:\n{log}", file=sys.stderr)
            return 1
        libs[name] = ctypes.CDLL(str(lib))
    _P, _I = ctypes.c_void_p, ctypes.c_int64
    for lib in libs.values():
        lib.dequantize_int8_grouped.argtypes = [_P, _I, _I, _P, _P, _P, _P]
        lib.dequantize_int8_grouped.restype = ctypes.c_int
        lib.dequantize_int8_resources.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.dequantize_int8_resources.restype = ctypes.c_int

    def decode(name, table, dev_table, q_base, s_base, out):
        err = libs[name].dequantize_int8_grouped(
            dev_table.data_ptr(), table.leaves, table.total_rows, q_base.data_ptr(),
            s_base.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: launch failed, CUDA error {err}")
        return out

    res = (ctypes.c_int * 5)()
    for name, lib in libs.items():
        if lib.dequantize_int8_resources(res):
            raise RuntimeError(f"{name}: dequantize_int8_resources failed")
        print(f"{name}: {res[0]} registers, local {res[1]} B, shared {res[2]} B, "
              f"{res[3]} threads, {res[4]} blocks an SM")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    layout = get_engine().layout_of(broadcast_to_sites(
        sanet_init(torch.Generator().manual_seed(0), SANET), 1))
    wp = WirePlan.of(layout, 1024, 128, dev, port=True)
    _, q_all, s_all = wp.encode(torch.randn(layout.n, device=dev, generator=gen) * 0.05)
    qb, sb = q_all.view(torch.uint8), s_all.view(torch.uint8)
    table, dev_table = wp.table, wp.table.on(dev)
    want = ref.dequantize_int8_grouped_ref(torch.from_numpy(table.host), qb, sb,
                                           torch.empty(layout.n, device=dev))
    outs = {}
    for name in libs:
        outs[name] = decode(name, table, dev_table, qb, sb,
                            torch.full((layout.n,), float("nan"), device=dev))
        torch.cuda.synchronize()
        if not torch.equal(outs[name], want):
            raise SystemExit(f"probe_dequant_lanes: {name} differs from the plain version")
    # the ragged messages of chip_smoke (align 1 and 128, headers 0-15 bytes)
    # through the same variants: the wrapper's launch is swapped for each
    launch = build.launch
    for name in libs:
        def swapped(kernel, entry, argtypes, *args, _n=name):
            if entry != "dequantize_int8_grouped":
                return launch(kernel, entry, argtypes, *args)
            err = libs[_n].dequantize_int8_grouped(*args)
            if err:
                raise RuntimeError(f"{_n}: launch failed, CUDA error {err}")
        build.launch = swapped
        try:
            cs.check_grouped_dequant(torch, dev)
        finally:
            build.launch = launch
        print(f"{name}: the ragged messages bit-equal to the plain version")
    print(f"one full-width message: {table.leaves} leaves, {table.total_rows} rows, "
          f"{layout.n} values, {table.nbytes()} bytes moved; every variant bit-equal to the "
          "plain version")

    order = list(libs) + list(libs)[::-1]
    graph = {name: [] for name in libs}
    eager = {name: [] for name in libs}
    for name in order:
        g, e = cs.time_ms(lambda: decode(name, table, dev_table, qb, sb, outs[name]))
        graph[name].append(g)
        eager[name].append(e)
    mem_rate = cs.peaks(torch.cuda.get_device_name(0))[0]
    bound = 1e3 * table.nbytes() / mem_rate
    print(f"bound {bound:.4f} ms (bytes at {mem_rate / 1e12:.2f} TB/s)")
    for name in libs:
        print(f"{name}: graph {graph[name][0]:.4f}, {graph[name][1]:.4f} ms; eager "
              f"{eager[name][0]:.4f}, {eager[name][1]:.4f} ms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
