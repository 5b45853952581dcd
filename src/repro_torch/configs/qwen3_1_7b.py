"""qwen3-1.7b [dense]: qk_norm, GQA kv=8, head_dim 128. [hf:Qwen/Qwen3-8B]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=6144, vocab=151936,
    head_dim=128, qk_norm=True, rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B",
)

SMOKE = CONFIG.with_overrides(
    name="qwen3-smoke", n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab=512, head_dim=64, max_seq=128)
