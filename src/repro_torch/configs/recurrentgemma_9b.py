"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2:1
[arXiv:2402.19427].

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000; window 2048;
lru_width = d_model; pattern (rglru, rglru, local) -> 12 units + 2 tail.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", d_model=4096, n_layers=38, vocab=256000,
    n_heads=16, n_kv_heads=1, head_dim=256,
    pattern=("rglru", "rglru", "local"), window=2048,
    d_ff=12288, mlp_act="gelu", lru_width=4096,
    tie_embeddings=True)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke", d_model=64, n_layers=5, vocab=128,
        n_heads=4, n_kv_heads=1, head_dim=16,
        pattern=("rglru", "rglru", "local"), window=16,
        d_ff=128, mlp_act="gelu", lru_width=64,
        tie_embeddings=True)
