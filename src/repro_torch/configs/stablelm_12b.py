"""stablelm-12b [dense]: GQA kv=8, head_dim 160. [hf:stabilityai/stablelm-2-1_6b]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab=100352,
    rope_theta=1e4,
    source="hf:stabilityai/stablelm-2-1_6b",
)

SMOKE = CONFIG.with_overrides(
    name="stablelm-smoke", n_layers=2, d_model=256, n_heads=4,
    n_kv_heads=2, d_ff=512, vocab=512, max_seq=128)
