"""Gemma-3 1B [hf:google/gemma-3-1b-pt].

26L, d_model 1152, GQA 4 heads / 1 KV (head_dim 256), GeGLU d_ff 6912,
vocab 262144, 5:1 local:global attention (sliding window 512, every 6th
layer global), qk-norm.  Local layers keep a ring-buffer KV cache of the
window's size.
"""
from repro_torch.configs.base import ModelConfig, PrecisionConfig
from repro_torch.configs.common import simple_mesh_for, simple_precision_for

CONFIG = ModelConfig(
    name="gemma3-1b",
    arch_type="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    qk_norm=True,
    sliding_window=512,
    global_attn_every=6,
    rope_theta=1_000_000.0,
    ffn_activation="geglu",
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)


mesh_for = simple_mesh_for(sites_per_pod=16, fsdp=1)
precision_for = simple_precision_for(PrecisionConfig.mixed())

def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", arch_type="dense",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=1, head_dim=32,
        d_ff=256, vocab_size=256, qk_norm=True,
        sliding_window=16, global_attn_every=2,
        ffn_activation="geglu", tie_embeddings=True,
        source="hf:google/gemma-3-1b-pt",
    )
