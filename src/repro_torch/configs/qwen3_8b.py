"""Qwen3-8B [hf:Qwen/Qwen3-8B].

36L, d_model 4096, GQA 32 heads / 8 KV (head_dim 128), qk-norm,
SwiGLU d_ff 12288, vocab 151936.
"""
from repro_torch.configs.base import ModelConfig, PrecisionConfig
from repro_torch.configs.common import simple_mesh_for, simple_precision_for

CONFIG = ModelConfig(
    name="qwen3-8b",
    arch_type="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="hf:Qwen/Qwen3-8B",
)


mesh_for = simple_mesh_for(sites_per_pod=16, fsdp=1)
precision_for = simple_precision_for(PrecisionConfig.mixed())

def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke", arch_type="dense",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=256, qk_norm=True, tie_embeddings=False,
        source="hf:Qwen/Qwen3-8B",
    )
