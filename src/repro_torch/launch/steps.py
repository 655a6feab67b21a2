"""Per-(architecture x input shape) step builders, ported from
``repro/launch/steps.py``, on one card.

For any token architecture and workload shape:

  * ``abstract_inputs`` — ``meta``-device tensors with the reference's
    shapes and dtypes for every input of the step (the site-stacked
    parameters and optimizer state, the batches, the round inputs, the
    caches): nothing is allocated;
  * ``make_inputs(seed, ...)`` — the concrete inputs, drawn from ``seed``
    on the step's device;
  * ``step_fn`` — the step:
        train_4k              -> one federated round (local steps + exchange)
        prefill_32k           -> prefill (logits of the last position + caches)
        decode_32k/long_500k  -> one decode step against a cache of seq_len

Each step runs in its architecture's ``precision_for(shape)``: training
keeps the parameters in ``param_dtype`` (bf16 for every token model: the
``mixed`` policy, or ``bf16_train`` for DeepSeek-V2 and Jamba), AdamW at
1e-4 with weight decay 0.01 and moments in ``opt_state_dtype``, gradient
accumulation over ``TRAIN_MICROBATCH`` in that dtype, the layer groups
checkpointed (``remat=True``), the gradient clipped at 1.0 and the
reference's ``moe_impl="dispatch"``; serving runs bf16 parameters against
a bf16 cache.

On one card there is no mesh and no sharding: ``mesh_for`` gives the
site count only, and every site is a row of one stacked buffer on the
device (``core/federation.py``).  The reference's sharding arguments
(``fsdp_params``, ``hints``) and ``in_shardings`` / ``out_shardings`` are
not ported.  One argument is added: ``cfg``, the model config to build
for (default ``arch.CONFIG``), so that a caller can cut depth (a config
at the published widths with fewer layers) or run a reduced config;
``TRAIN_MICROBATCH`` is looked up by its name.

The steps run on CUDA unless ``device`` names the CPU, and raise where
CUDA is missing; on the card the token kernels are built before the
builder returns.

    from repro_torch.launch.steps import build
    art = build("smollm-135m", "train_4k")                  # on the card
    state, batches, round_inputs = art.make_inputs(seed=0, per_site_batch=16)
    state, metrics = art.step_fn(state, batches, round_inputs)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import (INPUT_SHAPES, FederationConfig, InputShape, MeshConfig,
                                      ModelConfig, PrecisionConfig)
from repro_torch.configs.registry import get_token_arch
from repro_torch.core import federation as F
from repro_torch.core.topology import FLAT, Topology
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.tree import tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def resolve_device(device=None) -> torch.device:
    """``device``, or CUDA by default; raises where CUDA is missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the steps run on CUDA by default, and CUDA is not available "
                           "here; pass device='cpu' to run on the CPU")
    return dev


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@dataclasses.dataclass
class StepArtifacts:
    name: str
    mesh: MeshConfig               # the reference's site layout (its site count is read)
    step_fn: Callable
    abstract_inputs: tuple         # meta tensors, the reference's shapes and dtypes
    make_inputs: Callable          # (seed=0, ...) -> the concrete inputs on the device
    precision: PrecisionConfig     # the arch's precision_for(shape)
    notes: str = ""


# ---------------------------------------------------------------------------
# Train (federated round)
# ---------------------------------------------------------------------------

# per-arch microbatch (per site), the reference's table
TRAIN_MICROBATCH = {
    "deepseek-v2-236b": 4,
    "jamba-1.5-large-398b": 2,
    "chameleon-34b": 4,
    "qwen3-moe-30b-a3b": 4,
    "qwen3-8b": 4,
    "rwkv6-7b": 8,
    "granite-3-2b": 8,
    "gemma3-1b": 8,
    "smollm-135m": 8,
    "musicgen-medium": 8,
}


def _token_shape(cfg: ModelConfig, lead) -> tuple:
    return tuple(lead) + ((cfg.num_codebooks,) if cfg.num_codebooks > 1 else ())


def build_train(arch_id: str, shape_name: str = "train_4k", multi_pod: bool = False,
                strategy: str = "fedavg", local_steps: int = 1, moe_impl: str = "dispatch",
                override_mesh: Optional[MeshConfig] = None, hierarchical: bool = True,
                microbatch: Optional[int] = None, cfg: Optional[ModelConfig] = None,
                device=None) -> StepArtifacts:
    """One federated round of ``arch_id`` at ``shape_name`` (a train shape).

    ``override_mesh`` replaces ``mesh_for``'s layout (its site count is
    the stacked rows); ``microbatch`` replaces ``TRAIN_MICROBATCH``'s;
    ``cfg`` the model config.  ``make_inputs(seed=0, per_site_batch=None,
    params=None)`` draws the parameters (the same on every site; or takes
    ``params``, one tree in the policy's dtypes), the zero optimizer state
    and every site's tokens; ``per_site_batch`` cuts the reference's
    ``global_batch // sites`` sequences a site.  ``step_fn(state, batches,
    round_inputs)`` returns the new state and each metric averaged over
    the sites."""
    arch = get_token_arch(arch_id)
    cfg = cfg or arch.CONFIG
    shape: InputShape = INPUT_SHAPES[shape_name]
    if shape.kind != "train":
        raise ValueError(f"{shape_name} is a {shape.kind} shape; build_serve builds it")
    mesh_cfg = override_mesh or arch.mesh_for(shape, multi_pod)
    prec: PrecisionConfig = arch.precision_for(shape)
    dev = resolve_device(device)

    s_total = mesh_cfg.total_sites
    per_site_batch = max(shape.global_batch // s_total, 1)
    if microbatch is None:
        microbatch = TRAIN_MICROBATCH.get(cfg.name)
    pdt, sdt = _dtype(prec.param_dtype), _dtype(prec.opt_state_dtype)
    fed = FederationConfig(num_sites=s_total, strategy=strategy, local_steps=local_steps)

    def loss_fn(params, batch):
        return T.next_token_loss(params, batch, cfg, remat=True, moe_impl=moe_impl)

    # a multi-pod layout aggregates in two tiers, a pod a tier-1 group
    topo = (Topology.pods(mesh_cfg.num_pods) if (mesh_cfg.multi_pod and hierarchical)
            else FLAT)
    ctx = F.FLContext(
        fed=fed, case_weights=torch.as_tensor(fed.case_weights(), device=dev),
        loss_fn=loss_fn, optimizer=adamw(1e-4, weight_decay=0.01, state_dtype=sdt),
        grad_clip=1.0, device=dev, dcml_lr=1e-4, topology=topo, microbatch=microbatch,
        accum_dtype=torch.bfloat16 if prec.opt_state_dtype == "bfloat16" else torch.float32)
    fl_round = F.build_fl_round(ctx)
    if dev.type == "cuda":
        kbuild.prepare(dev, ops.job_kernels("tokens"))

    # the reference's state: site-stacked trees
    params_abs = T.init(None, cfg, "meta", dtype=pdt)
    stacked = tree_map(lambda p: _meta((s_total,) + tuple(p.shape), p.dtype), params_abs)
    state_abs = {
        "params": stacked,
        "opt": {"step": _meta((s_total,), torch.int32),
                "mu": tree_map(lambda p: _meta(p.shape, sdt), stacked),
                "nu": tree_map(lambda p: _meta(p.shape, sdt), stacked)},
        "strategy": {"global": params_abs} if strategy == "fedprox" else {},
        "round": _meta((), torch.int32),
    }
    tok_shape = _token_shape(cfg, (s_total, local_steps, per_site_batch, shape.seq_len))
    batches_abs = {"tokens": _meta(tok_shape, torch.int32)}
    round_inputs_abs = {"active": _meta((s_total,), torch.bool),
                        "partner": _meta((s_total,), torch.int32),
                        "is_receiver": _meta((s_total,), torch.bool)}

    def make_inputs(seed: int = 0, per_site_batch: Optional[int] = None, params=None):
        gen = torch.Generator(device=dev).manual_seed(seed)
        if params is None:
            params = T.init(gen, cfg, dev, dtype=pdt)
        state = F.init_fl_state(ctx, params)
        del params
        b = per_site_batch or tok_shape[2]
        tokens = torch.randint(0, cfg.vocab_size,
                               _token_shape(cfg, (s_total, local_steps, b, shape.seq_len)),
                               generator=gen, device=dev, dtype=torch.int32)
        return state, {"tokens": tokens}, F.make_round_inputs(ctx, np.ones(s_total, bool))

    def step_fn(fl_state, batches, round_inputs):
        new_state, metrics = fl_round(fl_state, batches, round_inputs)
        return new_state, {k: torch.mean(v.float()) for k, v in metrics.items()}

    return StepArtifacts(
        name=f"{arch_id}:{shape_name}:{'2pod' if multi_pod else '1pod'}",
        mesh=mesh_cfg, step_fn=step_fn,
        abstract_inputs=(state_abs, batches_abs, round_inputs_abs),
        make_inputs=make_inputs, precision=prec,
        notes=f"sites={s_total} per_site_batch={per_site_batch} micro={microbatch} "
              f"strategy={strategy}")


# ---------------------------------------------------------------------------
# Serve (prefill / decode)
# ---------------------------------------------------------------------------


def build_serve(arch_id: str, shape_name: str, multi_pod: bool = False,
                moe_impl: str = "dispatch", cfg: Optional[ModelConfig] = None,
                device=None) -> StepArtifacts:
    """Prefill of ``seq_len`` tokens, or one decode step against a bf16
    cache of ``seq_len`` positions, of ``arch_id`` in its serving dtype.

    ``make_inputs(seed=0, batch=None, seq_len=None)`` draws the parameters
    and the tokens (and, for decode, the cache: a prefill of ``seq_len -
    1`` random tokens, or ``prompt_len``, into a cache of ``seq_len``
    positions, so the step fills its last slot; with bf16 parameters its
    leaves are bf16 where ``init_caches(dtype=bfloat16)`` makes them so);
    ``batch`` and ``seq_len`` cut the shape's."""
    arch = get_token_arch(arch_id)
    cfg = cfg or arch.CONFIG
    shape: InputShape = INPUT_SHAPES[shape_name]
    if shape.kind == "train":
        raise ValueError(f"{shape_name} is a train shape; build_train builds it")
    mesh_cfg = arch.mesh_for(shape, multi_pod)
    prec: PrecisionConfig = arch.precision_for(shape)
    dev = resolve_device(device)
    pdt = _dtype(prec.param_dtype)
    if dev.type == "cuda":
        kbuild.prepare(dev, ops.TOKEN_KERNELS)

    params_abs = T.init(None, cfg, "meta", dtype=pdt)
    b = shape.global_batch
    name = f"{arch_id}:{shape_name}:{'2pod' if multi_pod else '1pod'}"

    def draw(seed, lead):
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = T.init(gen, cfg, dev, dtype=pdt)
        tokens = torch.randint(0, cfg.vocab_size, _token_shape(cfg, lead), generator=gen,
                               device=dev, dtype=torch.int32)
        return gen, params, tokens

    if shape.kind == "prefill":
        toks_abs = _meta(_token_shape(cfg, (b, shape.seq_len)), torch.int32)

        def make_inputs(seed: int = 0, batch: Optional[int] = None,
                        seq_len: Optional[int] = None):
            _, params, tokens = draw(seed, (batch or b, seq_len or shape.seq_len))
            return params, tokens

        def step_fn(params, tokens):
            return T.prefill(params, tokens, cfg, cache_capacity=tokens.shape[1],
                             moe_impl=moe_impl)

        return StepArtifacts(name=name, mesh=mesh_cfg, step_fn=step_fn,
                             abstract_inputs=(params_abs, toks_abs), make_inputs=make_inputs,
                             precision=prec,
                             notes=f"prefill batch={b} seq={shape.seq_len}")

    # decode: ONE new token against a seq_len cache
    toks_abs = _meta(_token_shape(cfg, (b, 1)), torch.int32)
    caches_abs = T.init_caches(b, shape.seq_len, cfg, dtype=torch.bfloat16, device="meta")

    def make_inputs(seed: int = 0, batch: Optional[int] = None, seq_len: Optional[int] = None,
                    prompt_len: Optional[int] = None):
        n, cap = batch or b, seq_len or shape.seq_len
        gen, params, tokens = draw(seed, (n, 1))
        prompt = torch.randint(0, cfg.vocab_size,
                               _token_shape(cfg, (n, cap - 1 if prompt_len is None
                                                  else prompt_len)),
                               generator=gen, device=dev, dtype=torch.int32)
        with torch.no_grad():
            _, caches = T.prefill(params, prompt, cfg, cache_capacity=cap, moe_impl=moe_impl)
        return params, tokens, caches

    def step_fn(params, tokens, caches):
        return T.decode_step(params, tokens, caches, cfg, moe_impl=moe_impl)

    return StepArtifacts(name=name, mesh=mesh_cfg, step_fn=step_fn,
                         abstract_inputs=(params_abs, toks_abs, caches_abs),
                         make_inputs=make_inputs, precision=prec,
                         notes=f"decode batch={b} cache={shape.seq_len}")


def build(arch_id: str, shape_name: str, multi_pod: bool = False, **kw) -> StepArtifacts:
    shape = INPUT_SHAPES[shape_name]
    if shape.kind == "train":
        return build_train(arch_id, shape_name, multi_pod, **kw)
    return build_serve(arch_id, shape_name, multi_pod, **kw)
