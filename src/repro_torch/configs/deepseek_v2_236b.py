"""DeepSeek-V2 236B [arXiv:2405.04434].

60L, d_model 5120, 128 heads (MLA: kv_lora_rank 512), MoE: 2 shared + 160
routed experts top-6, expert hidden 1536, first layer dense FFN (12288),
vocab 102400.
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig, PrecisionConfig
from repro_torch.configs.common import simple_mesh_for, simple_precision_for

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=1536,
    vocab_size=102400,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, d_expert=1536,
                  num_shared_experts=2, d_shared=1536),
    first_layer_dense_ff=12288,
    tie_embeddings=False,
    rope_theta=10000.0,
    source="arXiv:2405.04434",
)


mesh_for = simple_mesh_for(sites_per_pod=1, fsdp=16)
precision_for = simple_precision_for(PrecisionConfig.bf16_train())

def reduced() -> ModelConfig:
    """2-layer smoke: MLA + dense FFN, then MLA + shared/routed MoE."""
    return ModelConfig(
        name="deepseek-v2-smoke", arch_type="moe",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=64, vocab_size=256,
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                      qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=64,
                      num_shared_experts=1, d_shared=64),
        first_layer_dense_ff=128,
        tie_embeddings=False,
        source="arXiv:2405.04434",
    )
