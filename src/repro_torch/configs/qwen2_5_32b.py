"""qwen2.5-32b [dense]: GQA kv=8, QKV bias. [hf:Qwen/Qwen2.5-0.5B]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab=152064,
    qkv_bias=True, rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-0.5B",
)

SMOKE = CONFIG.with_overrides(
    name="qwen25-smoke", n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab=512, max_seq=128)
