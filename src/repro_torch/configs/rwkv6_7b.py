"""RWKV-6 "Finch" 7B [arXiv:2404.05892].

32L, d_model 4096 (attention-free: data-dependent-decay linear recurrence),
channel-mix hidden 14336, vocab 65536.
"""
from repro_torch.configs.base import ModelConfig, PrecisionConfig, Rwkv6Config
from repro_torch.configs.common import simple_mesh_for, simple_precision_for

CONFIG = ModelConfig(
    name="rwkv6-7b",
    arch_type="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,              # d_model / head_dim(64)
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    mixer="rwkv6",
    rwkv=Rwkv6Config(head_dim=64),
    pos_embedding="none",
    tie_embeddings=False,
    source="arXiv:2404.05892",
)


mesh_for = simple_mesh_for(sites_per_pod=16, fsdp=1)
precision_for = simple_precision_for(PrecisionConfig.mixed())

def reduced() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke", arch_type="ssm",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=256,
        mixer="rwkv6", rwkv=Rwkv6Config(head_dim=32, decay_lora_rank=16,
                                        tokenshift_lora_rank=8, gate_lora_rank=16,
                                        chunk_size=8),
        pos_embedding="none", tie_embeddings=False,
        source="arXiv:2404.05892",
    )
