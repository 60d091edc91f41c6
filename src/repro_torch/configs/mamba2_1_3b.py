"""mamba2-1.3b [ssm] — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=2048 attention-free, d_ff=0, vocab=50280, ssm_state=128.
d_inner = 2*d_model = 4096, head_dim 64 -> 64 heads (Mamba2 defaults).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", d_model=2048, n_layers=48, vocab=50280,
    pattern=("ssm",), d_ff=0,
    ssm_state=128, ssm_heads=64, ssm_head_dim=64, ssm_chunk=256,
    tie_embeddings=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", d_model=64, n_layers=2, vocab=128,
        pattern=("ssm",), d_ff=0,
        ssm_state=16, ssm_heads=4, ssm_head_dim=8, ssm_chunk=8,
        tie_embeddings=True)
