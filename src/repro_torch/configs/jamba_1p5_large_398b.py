"""Jamba-1.5-Large 398B [arXiv:2403.19887].

72L, d_model 8192, hybrid Mamba+attention with a 1:7 attention:Mamba
interleave (one attention layer per 8-layer period), GQA 64 heads / 8 KV,
MoE 16 experts top-2 on every other layer, FFN/expert hidden 24576,
vocab 65536.
"""
from repro_torch.configs.base import MambaConfig, MoEConfig, ModelConfig, PrecisionConfig
from repro_torch.configs.common import simple_mesh_for, simple_precision_for

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    mixer="mamba",                 # default mixer; attention every 8th layer
    attn_layer_period=8,
    attn_layer_offset=4,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=24576),
    moe_layer_period=2,
    moe_layer_offset=1,
    tie_embeddings=False,
    source="arXiv:2403.19887",
)


mesh_for = simple_mesh_for(sites_per_pod=1, fsdp=16)
precision_for = simple_precision_for(PrecisionConfig.bf16_train())

def reduced() -> ModelConfig:
    """2-layer smoke: one Mamba+dense layer, one attention+MoE layer."""
    return ModelConfig(
        name="jamba-smoke", arch_type="hybrid",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=256,
        mixer="mamba", attn_layer_period=2, attn_layer_offset=1,
        mamba=MambaConfig(d_state=8, d_conv=4, expand=2, chunk_size=8),
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=256),
        moe_layer_period=2, moe_layer_offset=1,
        tie_embeddings=False,
        source="arXiv:2403.19887",
    )
