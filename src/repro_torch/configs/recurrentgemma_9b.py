"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, pattern
(rec, rec, attn), MQA kv=1, window 2048. [arXiv:2402.19427]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000,
    rglru_pattern=("rec", "rec", "attn"), rglru_width=4096,
    attention="sliding", window=2048, mlp="gelu", conv1d_width=4,
    source="arXiv:2402.19427",
)

SMOKE = CONFIG.with_overrides(
    name="rgemma-smoke", n_layers=3, d_model=256, n_heads=4, n_kv_heads=1,
    d_ff=512, vocab=512, rglru_width=256, window=32, max_seq=128)
