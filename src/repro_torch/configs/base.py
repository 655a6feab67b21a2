"""Configuration dataclasses, ported from ``repro/configs/base.py``.

The parts the port's paths read: :class:`FederationConfig` (the paper's
FL hyper-parameters) and its Eq. 1 case weights, and the token models'
:class:`ModelConfig` with its sub-configs (MoE, MLA, RWKV-6, Mamba) and
per-layer :class:`LayerSpec`.  The mesh, job and precision configs of
the reference are TPU-mesh settings and are not ported.

All configs are frozen dataclasses, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class FederationConfig:
    """Paper §II hyper-parameters.

    ``strategy`` in {fedavg, fedprox, gcml, individual, pooled};
    ``site_case_counts`` are the m_i of Eq. 1 (default: uniform);
    ``max_dropout_sites`` is N_max of Algorithm 2.
    """

    num_sites: int = 8
    strategy: str = "fedavg"
    local_steps: int = 1
    rounds: int = 100
    # FedProx (Eq. 2)
    prox_mu: float = 0.01
    # GCML (Eq. 3)
    gcml_lambda: float = 0.5
    gcml_contrast_beta: float = 1.0
    # Algorithm 2
    max_dropout_sites: int = 0
    dropout_scenario: str = "disconnect"   # disconnect | shutdown
    site_case_counts: Optional[Tuple[int, ...]] = None

    def case_weights(self) -> np.ndarray:
        if self.site_case_counts is None:
            w = np.ones((self.num_sites,), dtype=np.float32)
        else:
            if len(self.site_case_counts) != self.num_sites:
                raise ValueError(f"{len(self.site_case_counts)} case counts "
                                 f"for {self.num_sites} sites")
            w = np.asarray(self.site_case_counts, dtype=np.float32)
        return w / w.sum()


# ---------------------------------------------------------------------------
# Sub-configs for specific mixer / ffn families
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration (DeepSeek-V2 / Qwen3-MoE / Jamba)."""

    num_experts: int
    top_k: int
    d_expert: int                      # hidden size of each routed expert
    num_shared_experts: int = 0        # DeepSeek-V2 style always-on experts
    d_shared: int = 0                  # hidden size of the shared expert(s)
    router_aux_coef: float = 0.01      # load-balance auxiliary loss weight
    router_jitter: float = 0.0
    normalize_router_weights: bool = True

    @property
    def d_shared_total(self) -> int:
        return self.num_shared_experts * self.d_shared


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention configuration."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class Rwkv6Config:
    """RWKV-6 "Finch" mixer configuration (data-dependent decay)."""

    head_dim: int = 64
    decay_lora_rank: int = 64
    tokenshift_lora_rank: int = 32
    gate_lora_rank: int = 64
    chunk_size: int = 128              # the reference's scan chunk


@dataclass(frozen=True)
class MambaConfig:
    """Mamba (S6) selective-scan mixer configuration (Jamba layers)."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None      # default: ceil(d_model / 16)
    chunk_size: int = 128


# ---------------------------------------------------------------------------
# The model config
# ---------------------------------------------------------------------------

MIXER_KINDS = ("attn", "mla", "rwkv6", "mamba")
FFN_KINDS = ("dense", "moe")


@dataclass(frozen=True)
class LayerSpec:
    """Resolved per-layer block structure."""

    mixer: str                         # one of MIXER_KINDS
    ffn: str                           # one of FFN_KINDS
    sliding_window: Optional[int] = None   # None = global attention

    def __post_init__(self):
        if self.mixer not in MIXER_KINDS:
            raise ValueError(f"unknown mixer {self.mixer!r}")
        if self.ffn not in FFN_KINDS:
            raise ValueError(f"unknown ffn {self.ffn!r}")


@dataclass(frozen=True)
class ModelConfig:
    """A decoder-only token model.

    The layer-pattern fields express hybrids declaratively: Jamba's 1:7
    attention:Mamba interleave, Gemma-3's 5:1 local:global windows,
    DeepSeek-V2's dense first layer.
    """

    name: str
    arch_type: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None     # default: d_model // num_heads
    # --- attention options -------------------------------------------------
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None        # window size for local layers
    global_attn_every: Optional[int] = None     # e.g. 6 => layers 5,11,.. global
    mla: Optional[MLAConfig] = None
    # --- mixer family ------------------------------------------------------
    mixer: str = "attn"                # default mixer for all layers
    attn_layer_period: Optional[int] = None     # hybrid: 1 attn layer per period
    attn_layer_offset: int = 0
    rwkv: Optional[Rwkv6Config] = None
    mamba: Optional[MambaConfig] = None
    # --- FFN family ---------------------------------------------------------
    moe: Optional[MoEConfig] = None
    moe_layer_period: int = 1          # MoE on layers where i % period == offset
    moe_layer_offset: int = 0
    first_layer_dense_ff: Optional[int] = None  # DeepSeek-V2 dense layer 0
    ffn_activation: str = "swiglu"     # swiglu | geglu | gelu | relu_sq
    # --- embeddings / heads --------------------------------------------------
    tie_embeddings: bool = True
    num_codebooks: int = 1             # musicgen: parallel EnCodec streams
    pos_embedding: str = "rope"        # rope | sinusoidal | none
    norm_eps: float = 1e-6
    pad_vocab_multiple: int = 128      # padded embedding/logit rows
    # --- citations -----------------------------------------------------------
    source: str = ""

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_multiple
        if m <= 1 or self.vocab_size == 0:
            return self.vocab_size
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def resolved_head_dim(self) -> int:
        if self.mla is not None:
            return self.mla.v_head_dim
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    def layer_spec(self, i: int) -> LayerSpec:
        """Resolve the block structure of layer ``i``."""
        if self.attn_layer_period is not None:
            mixer = "attn" if (i % self.attn_layer_period == self.attn_layer_offset) else self.mixer
        else:
            mixer = self.mixer
        if mixer == "attn" and self.mla is not None:
            mixer = "mla"
        ffn = "dense"
        if self.moe is not None and (i % self.moe_layer_period == self.moe_layer_offset):
            ffn = "moe"
        if i == 0 and self.first_layer_dense_ff is not None:
            ffn = "dense"
        window = None          # gemma3: 5 local layers, then 1 global
        if mixer == "attn" and self.sliding_window is not None:
            if self.global_attn_every is None or (i + 1) % self.global_attn_every != 0:
                window = self.sliding_window
        return LayerSpec(mixer=mixer, ffn=ffn, sliding_window=window)

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        return tuple(self.layer_spec(i) for i in range(self.num_layers))

    def dense_ff_for_layer(self, i: int) -> int:
        if i == 0 and self.first_layer_dense_ff is not None:
            return self.first_layer_dense_ff
        return self.d_ff
