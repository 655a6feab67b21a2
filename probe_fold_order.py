"""How far round-off in the fold alone moves the full-width int8 job, on one card.

Runs the full-width SA-Net job with int8 both ways (4 sites, 2 rounds,
TF32 convolutions, as ``chip_smoke.py``'s socket phase) five times:

- ``stacked`` and ``stacked again``: the stacked transport twice (is it
  deterministic run to run?);
- ``stacked, fold reversed``: the stacked transport with each
  ``fedagg_dequant`` call given its sites in reverse order (the same sum
  in another order; the residuals are put back in site order);
- ``thread`` and ``thread again``: the socket deployment on
  ``transport="thread"`` twice (its server folds in arrival order).

For each pair it prints the largest |difference| of the globals, the
elements identical, the elements beyond 1e-6 ... 2e-4, and the leaves
with elements outside the reference's thread-against-stacked bound
(rtol 2e-3, atol 2e-4: leaf, shape, count, largest difference, largest
|value|).  Pairs that differ only in the fold's order show how far
round-off alone moves an element after AdamW's second round.

Usage, from the repository root on a machine with a card and ``nvcc``::

    python3 probe_fold_order.py
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PAIRS = [("stacked", "stacked again"), ("stacked", "stacked, fold reversed"),
         ("stacked", "thread"), ("stacked", "thread again"), ("thread", "thread again"),
         ("stacked, fold reversed", "thread")]


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_fold_order: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import FederatedJob, TaskConfig
    from repro_torch.configs.sanet_openkbp import OPENKBP_TASK
    from repro_torch.kernels import build, ops

    build.build(list(ops.KERNELS))
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    job = FederatedJob(task=TaskConfig(**OPENKBP_TASK), strategy="fedavg", rounds=2,
                       compression="int8", down_compression="int8")
    fold = ops.fedagg_dequant

    def reversed_fold(q, sc, u, w):
        g, r = fold(q.flip(0).contiguous(), sc.flip(0).contiguous(),
                    u.flip(0).contiguous(), w.flip(0).contiguous())
        return g, r.flip(0).contiguous()

    globals_ = {}
    for name, run, fold_fn in (("stacked", job, fold), ("stacked again", job, fold),
                               ("stacked, fold reversed", job, reversed_fold),
                               ("thread", job.replace(transport="thread"), fold),
                               ("thread again", job.replace(transport="thread"), fold)):
        ops.fedagg_dequant = fold_fn
        try:
            t0 = time.perf_counter()
            result = run.run()
        finally:
            ops.fedagg_dequant = fold
        globals_[name] = dict(_paths(result.global_params))
        print(f"{name}: {time.perf_counter() - t0:.1f} s; per-site losses "
              f"{[h['per_site_loss'] for h in result.history]}", flush=True)

    thresholds = (1e-6, 1e-5, 3e-5, 1e-4, 2e-4)
    for a, b in PAIRS:
        worst, same, total, beyond, outside = 0.0, 0, 0, dict.fromkeys(thresholds, 0), []
        for path, x in globals_[a].items():
            y = globals_[b][path]
            d = (x - y).abs()
            worst = max(worst, float(d.max()))
            same += int((d == 0).sum())
            total += d.numel()
            for t in thresholds:
                beyond[t] += int((d > t).sum())
            bad = int((d > 2e-4 + 2e-3 * y.abs()).sum())
            if bad:
                outside.append((path, tuple(x.shape), bad, float(d.max()),
                                float(y.abs().max())))
        print(f"{a} vs {b}: max |difference| {worst:.3e}; identical {same} of {total}; "
              f"beyond {beyond}; outside rtol 2e-3, atol 2e-4 {outside}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
