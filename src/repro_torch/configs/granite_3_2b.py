"""Granite-3.0 2B base [hf:ibm-granite/granite-3.0-2b-base].

40L, d_model 2048, GQA 32 heads / 8 KV, SwiGLU d_ff 8192, vocab 49155
(padded to 49280 logit rows, the padding masked).
"""
from repro_torch.configs.base import ModelConfig, PrecisionConfig
from repro_torch.configs.common import simple_mesh_for, simple_precision_for

CONFIG = ModelConfig(
    name="granite-3-2b",
    arch_type="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base",
)


mesh_for = simple_mesh_for(sites_per_pod=16, fsdp=1)
precision_for = simple_precision_for(PrecisionConfig.mixed())

def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke", arch_type="dense",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=256, tie_embeddings=True,
        source="hf:ibm-granite/granite-3.0-2b-base",
    )
