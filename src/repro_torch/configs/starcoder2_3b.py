"""starcoder2-3b [dense] — GQA kv=2, RoPE [arXiv:2402.19173].

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.  (Upstream mixes
LN + learned positions in places; we keep the shared pre-RMSNorm + RoPE
stack — deviation noted in DESIGN.md.)
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", d_model=3072, n_layers=30, vocab=49152,
    n_heads=24, n_kv_heads=2, head_dim=128,
    pattern=("attn",), d_ff=12288, mlp_gated=False,
    tie_embeddings=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-smoke", d_model=64, n_layers=2, vocab=128,
        n_heads=4, n_kv_heads=2, head_dim=16,
        pattern=("attn",), d_ff=128, mlp_gated=False,
        tie_embeddings=True)
