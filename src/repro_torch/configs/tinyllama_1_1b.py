"""tinyllama-1.1b [dense]: llama2-arch small, GQA kv=4. [arXiv:2401.02385]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=5632, vocab=32000,
    rope_theta=1e4,
    source="arXiv:2401.02385",
)

SMOKE = CONFIG.with_overrides(
    name="tinyllama-smoke", n_layers=2, d_model=256, n_heads=8,
    n_kv_heads=2, d_ff=512, vocab=512, max_seq=128)
