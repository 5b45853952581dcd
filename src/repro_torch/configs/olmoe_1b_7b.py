"""olmoe-1b-7b [moe]: 64 experts, top-8, fine-grained experts (d_ff 1024).
[arXiv:2409.02060]
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab=50304,
    n_experts=64, top_k=8, moe_d_ff=1024,
    qk_norm=True, rope_theta=1e4,
    source="arXiv:2409.02060",
)

SMOKE = CONFIG.with_overrides(
    name="olmoe-smoke", n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
    d_ff=128, moe_d_ff=128, n_experts=4, top_k=2, vocab=512, max_seq=128)
