"""Qwen3-30B-A3B MoE [hf:Qwen/Qwen3-30B-A3B].

48L, d_model 2048, GQA 32 heads / 4 KV (head_dim 128), qk-norm,
MoE 128 experts top-8 with expert hidden 768, vocab 151936.
"""
from repro_torch.configs.base import MoEConfig, ModelConfig, PrecisionConfig
from repro_torch.configs.common import simple_mesh_for, simple_precision_for

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=768),
    tie_embeddings=False,
    source="hf:Qwen/Qwen3-30B-A3B",
)


mesh_for = simple_mesh_for(sites_per_pod=8, fsdp=2)
precision_for = simple_precision_for(PrecisionConfig.mixed())

def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", arch_type="moe",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=64, vocab_size=256, qk_norm=True,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=64),
        tie_embeddings=False,
        source="hf:Qwen/Qwen3-30B-A3B",
    )
