"""Serving entry point: batched prefill, then greedy autoregressive decode.

Serves a token model (the aggregated global model of a federation) with
random weights from a seed, as the reference's ``launch/serve.py`` does:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
      --batch 4 --prompt-len 64 --decode-steps 32 [--device cpu]

It runs on CUDA unless ``--device cpu`` is given, and raises where CUDA
is missing.  As in the reference, ``--reduced`` is on and cannot be
turned off from the command line: the CLI serves the reduced configs.
:func:`run` serves a published config when its ``args.reduced`` is
False, and :func:`generate` serves any parameters and config.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import torch

from repro_torch.configs.registry import get_token_arch
from repro_torch.kernels import build
from repro_torch.models import transformer as T


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve runs on CUDA by default, and CUDA is not available "
                           "here; pass --device cpu to serve on the CPU")
    return dev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launched_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: n - before.get(k, 0) for k, n in build.LAUNCHES.items()
            if n - before.get(k, 0)}


def generate(params, prompts: torch.Tensor, cfg, decode_steps: int,
             moe_impl: str = "dense") -> dict:
    """Prefill ``prompts`` [B, L] (or [B, L, K]), then ``decode_steps``
    greedy tokens (the first from the prefill's logits).

    Returns ``tokens`` [B, decode_steps] (or [B, decode_steps, K]), the
    fp32 ``logits`` each token was taken from ([B, decode_steps, Vp]),
    ``prefill_s``, ``decode_s`` and ``tok_per_s`` (wall clock, the device
    synchronised), and the kernel launches of each phase
    (``prefill_launches``, ``decode_launches``)."""
    device = prompts.device
    capacity = prompts.shape[1] + decode_steps
    before = dict(build.LAUNCHES)
    _sync(device)
    t0 = time.perf_counter()
    logits, caches = T.prefill(params, prompts, cfg, cache_capacity=capacity,
                               moe_impl=moe_impl)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    prefill_launches = _launched_since(before)

    def sample(lg):
        return torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)

    toks = sample(logits)
    out_tokens, out_logits = [toks], [logits[:, -1:]]
    before = dict(build.LAUNCHES)
    t0 = time.perf_counter()
    for _ in range(decode_steps - 1):
        logits, caches = T.decode_step(params, toks, caches, cfg, moe_impl=moe_impl)
        toks = sample(logits)
        out_tokens.append(toks)
        out_logits.append(logits[:, -1:])
    _sync(device)
    t_decode = time.perf_counter() - t0
    total_new = prompts.shape[0] * decode_steps
    return {"tokens": torch.cat(out_tokens, dim=1), "logits": torch.cat(out_logits, dim=1),
            "prefill_s": t_prefill, "decode_s": t_decode,
            "tok_per_s": total_new / max(t_decode, 1e-9),
            "prefill_launches": prefill_launches,
            "decode_launches": _launched_since(before)}


def run(args) -> dict:
    """Serve ``args.arch`` with random weights from ``args.seed``; returns
    the reference's keys (``prefill_s``, ``decode_s``, ``tok_per_s``), the
    first 16 continuation ids of prompt 0, whether every logit was finite,
    and each phase's kernel launches."""
    arch = get_token_arch(args.arch)
    cfg = arch.reduced() if args.reduced else arch.CONFIG
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init(gen, cfg, device)
    b, lp = args.batch, args.prompt_len
    shape = (b, lp) if cfg.num_codebooks == 1 else (b, lp, cfg.num_codebooks)
    prompts = torch.randint(0, cfg.vocab_size, shape, generator=gen, device=device)
    out = generate(params, prompts, cfg, args.decode_steps, moe_impl="dense")
    print(f"[serve] {cfg.name} on {device}: prefill {b}x{lp} in {out['prefill_s']:.2f}s; "
          f"decode {args.decode_steps} steps in {out['decode_s']:.2f}s "
          f"({out['tok_per_s']:.1f} tok/s)")
    continuation = out["tokens"][0].reshape(-1)[:16].tolist()
    print("[serve] sample continuation ids:", continuation)
    return {"prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
            "tok_per_s": out["tok_per_s"], "continuation": continuation,
            "logits_finite": bool(torch.isfinite(out["logits"]).all()),
            "prefill_launches": out["prefill_launches"],
            "decode_launches": out["decode_launches"]}


def make_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64, dest="prompt_len")
    ap.add_argument("--decode-steps", type=int, default=32, dest="decode_steps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


if __name__ == "__main__":
    run(make_parser().parse_args())
