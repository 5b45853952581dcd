"""llama4-scout-17b-a16e [moe]: MoE 16 experts top-1 + shared expert,
iRoPE (every 4th layer NoPE), chunked attention for long context.
[hf:meta-llama/Llama-4-Scout-17B-16E]
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048,
    n_experts=16, top_k=1, moe_d_ff=8192, n_shared_experts=1,
    nope_every=4, attention="chunked", window=8192, rope_theta=5e5,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

SMOKE = CONFIG.with_overrides(
    name="llama4-smoke", n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, moe_d_ff=512, n_experts=4, vocab=512, window=64,
    nope_every=2, max_seq=128)
