"""qwen2-72b [dense] — GQA with QKV bias [arXiv:2407.10671].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", d_model=8192, n_layers=80, vocab=152064,
    n_heads=64, n_kv_heads=8, head_dim=128, qkv_bias=True,
    pattern=("attn",), d_ff=29568,
    rope_theta=1e6, tie_embeddings=False)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-smoke", d_model=64, n_layers=2, vocab=128,
        n_heads=4, n_kv_heads=2, head_dim=16, qkv_bias=True,
        pattern=("attn",), d_ff=128,
        tie_embeddings=False)
