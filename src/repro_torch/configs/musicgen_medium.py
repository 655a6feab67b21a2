"""MusicGen-medium [arXiv:2306.05284].

48L, d_model 1536, MHA 24 heads (kv 24), GELU d_ff 6144, decoder-only over
4 parallel EnCodec codebooks of vocab 2048 each (embeddings summed, one
output head per codebook), sinusoidal positions.  As in the reference,
the EnCodec audio codec is not modelled: the decoder takes the [B, L, 4]
token streams.
"""
from repro_torch.configs.base import ModelConfig, PrecisionConfig
from repro_torch.configs.common import simple_mesh_for, simple_precision_for

CONFIG = ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    num_codebooks=4,
    pos_embedding="sinusoidal",
    ffn_activation="gelu",
    tie_embeddings=False,
    source="arXiv:2306.05284",
)


mesh_for = simple_mesh_for(sites_per_pod=16, fsdp=1)
precision_for = simple_precision_for(PrecisionConfig.mixed())

def reduced() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke", arch_type="audio",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=64, num_codebooks=2,
        pos_embedding="sinusoidal", ffn_activation="gelu",
        tie_embeddings=False,
        source="arXiv:2306.05284",
    )
