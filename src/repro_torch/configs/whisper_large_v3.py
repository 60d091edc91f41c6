"""whisper-large-v3 [audio] — encoder-decoder, conv frontend stubbed
[arXiv:2212.04356].

32 encoder + 32 decoder layers, d_model=1280, 20H (kv=20), d_ff=5120,
vocab=51866.  input_specs() provides precomputed frame embeddings
(enc_len = seq/4 for decode shapes) — the conv frontend is a stub.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", d_model=1280, n_layers=32, vocab=51866,
    n_heads=20, n_kv_heads=20, head_dim=64,
    pattern=("xdec",), d_ff=5120, mlp_act="gelu", mlp_gated=False,
    enc_layers=32, is_enc_dec=True, frontend="audio",
    tie_embeddings=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", d_model=64, n_layers=2, vocab=128,
        n_heads=4, n_kv_heads=4, head_dim=16,
        pattern=("xdec",), d_ff=128, mlp_act="gelu", mlp_gated=False,
        enc_layers=2, is_enc_dec=True, frontend="audio",
        tie_embeddings=True)
