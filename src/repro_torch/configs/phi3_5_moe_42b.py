"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (GQA kv=8) expert d_ff=6400 vocab=32064.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b", d_model=4096, n_layers=32, vocab=32064,
    n_heads=32, n_kv_heads=8, head_dim=128,
    pattern=("attn",), d_ff=0,
    n_experts=16, n_experts_per_tok=2, moe_d_ff=6400,
    tie_embeddings=False)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-smoke", d_model=64, n_layers=2, vocab=128,
        n_heads=4, n_kv_heads=2, head_dim=16,
        pattern=("attn",), d_ff=0,
        n_experts=4, n_experts_per_tok=2, moe_d_ff=96,
        capacity_factor=2.0,     # E/k: dropless at smoke scale (exactness tests)
        tie_embeddings=False)
