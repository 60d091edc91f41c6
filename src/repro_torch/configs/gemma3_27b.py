"""gemma3-27b [dense] — 5:1 local:global, qk-norm, 128k context
[hf:google/gemma-3-*].

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144; window 1024.
62 = 10 x (5 local + 1 global) + 2 tail locals.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", d_model=5376, n_layers=62, vocab=262144,
    n_heads=32, n_kv_heads=16, head_dim=128, qk_norm=True,
    pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024, d_ff=21504, mlp_act="gelu",
    tie_embeddings=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", d_model=64, n_layers=8, vocab=128,
        n_heads=4, n_kv_heads=2, head_dim=16, qk_norm=True,
        pattern=("local", "local", "local", "local", "local", "attn"),
        window=16, d_ff=128, mlp_act="gelu",
        tie_embeddings=True)
