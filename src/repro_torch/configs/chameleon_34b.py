"""Chameleon-34B [arXiv:2405.09818].

48L, d_model 8192, GQA 64 heads / 8 KV, d_ff 22016, vocab 65536 (joint
text + VQ image tokens: early fusion), qk-norm.  As in the reference,
the VQ-VAE image tokenizer is not modelled: image patches are token ids
of the joint vocabulary, which is all the decoder sees.
"""
from repro_torch.configs.base import ModelConfig, PrecisionConfig
from repro_torch.configs.common import simple_mesh_for, simple_precision_for

CONFIG = ModelConfig(
    name="chameleon-34b",
    arch_type="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    tie_embeddings=False,
    source="arXiv:2405.09818",
)


mesh_for = simple_mesh_for(sites_per_pod=4, fsdp=4)
precision_for = simple_precision_for(PrecisionConfig.mixed())

def reduced() -> ModelConfig:
    return ModelConfig(
        name="chameleon-smoke", arch_type="vlm",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=256, qk_norm=True, tie_embeddings=False,
        source="arXiv:2405.09818",
    )
