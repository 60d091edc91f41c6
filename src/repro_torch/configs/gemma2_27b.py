"""gemma2-27b [dense] — 1:1 local:global alternation + logit softcaps
[arXiv:2408.00118].

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000; window 4096;
attention softcap 50, final-logit softcap 30.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", d_model=4608, n_layers=46, vocab=256000,
    n_heads=32, n_kv_heads=16, head_dim=128,
    pattern=("local", "attn"), window=4096,
    attn_softcap=50.0, logit_softcap=30.0,
    d_ff=36864, mlp_act="gelu",
    tie_embeddings=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke", d_model=64, n_layers=4, vocab=128,
        n_heads=4, n_kv_heads=2, head_dim=16,
        pattern=("local", "attn"), window=16,
        attn_softcap=50.0, logit_softcap=30.0,
        d_ff=128, mlp_act="gelu",
        tie_embeddings=True)
