"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M].

30L, d_model 576, GQA 9 heads / 3 KV, SwiGLU d_ff 1536, vocab 49152.
Llama-architecture small model.
"""
from repro_torch.configs.base import ModelConfig, PrecisionConfig
from repro_torch.configs.common import simple_mesh_for, simple_precision_for

CONFIG = ModelConfig(
    name="smollm-135m",
    arch_type="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)


mesh_for = simple_mesh_for(sites_per_pod=16, fsdp=1)
precision_for = simple_precision_for(PrecisionConfig.mixed())

def reduced() -> ModelConfig:
    return ModelConfig(
        name="smollm-smoke", arch_type="dense",
        num_layers=2, d_model=96, num_heads=3, num_kv_heads=1,
        d_ff=256, vocab_size=256, tie_embeddings=True,
        source="hf:HuggingFaceTB/SmolLM-135M",
    )
