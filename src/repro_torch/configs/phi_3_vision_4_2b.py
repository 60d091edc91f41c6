"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend stub
[hf:microsoft/Phi-3-vision-128k-instruct].

32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064.  input_specs()
provides precomputed patch embeddings (256 x d_model) — the CLIP tower
is a stub per the assignment brief.
"""
from ..models.config import ModelConfig

N_PATCHES = 256

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", d_model=3072, n_layers=32, vocab=32064,
    n_heads=32, n_kv_heads=32, head_dim=96,
    pattern=("attn",), d_ff=8192,
    frontend="vision", tie_embeddings=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-smoke", d_model=64, n_layers=2, vocab=128,
        n_heads=4, n_kv_heads=4, head_dim=16,
        pattern=("attn",), d_ff=128,
        frontend="vision", tie_embeddings=True)
