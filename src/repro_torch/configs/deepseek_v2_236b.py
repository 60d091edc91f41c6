"""deepseek-v2-236b [moe] — MLA (kv_lora=512) + 2 shared + 160 routed
top-6 [arXiv:2405.04434].

60L d_model=5120 128H MLA, routed-expert d_ff=1536, vocab=102400.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", d_model=5120, n_layers=60, vocab=102400,
    n_heads=128, n_kv_heads=128, head_dim=128,
    use_mla=True, kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
    pattern=("attn",), d_ff=0,
    n_experts=160, n_experts_per_tok=6, n_shared_experts=2, moe_d_ff=1536,
    tie_embeddings=False)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-smoke", d_model=64, n_layers=2, vocab=128,
        n_heads=4, n_kv_heads=4, head_dim=16,
        use_mla=True, kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8,
        pattern=("attn",), d_ff=0,
        n_experts=8, n_experts_per_tok=2, n_shared_experts=1, moe_d_ff=48,
        capacity_factor=4.0,     # E/k: dropless at smoke scale (exactness tests)
        tie_embeddings=False)
