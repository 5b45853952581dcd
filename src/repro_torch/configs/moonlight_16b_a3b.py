"""moonlight-16b-a3b [moe]: the DeepSeek-V3 block. Multi-head latent
attention (kv_lora_rank 512, no query LoRA, q/k 128 + 64 rope dims, v
128), 64 routed experts of width 1408, top-6 by sigmoid scores plus a
selection bias, gates normalised and scaled by 2.446, 2 shared experts,
one leading dense layer of width 11264.  The config holds every expert;
a deployment's chip holds a share (``n_experts_held``, ``expert_shard``).
[hf:moonshotai/Moonlight-16B-A3B config.json]
"""

from ..models.config import LatentMoEConfig

CONFIG = LatentMoEConfig(
    name="moonlight-16b-a3b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=11264, vocab=163840,
    n_experts=64, top_k=6, moe_d_ff=1408, n_shared_experts=2,
    shared_d_ff=2816, first_k_dense=1, rope_theta=5e4, rms_eps=1e-5,
    kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    routed_scale=2.446, bias_rate=1e-3, router_aux_coef=1e-4,
    max_seq=8192,
    source="hf:moonshotai/Moonlight-16B-A3B",
)

SMOKE = CONFIG.with_overrides(
    name="moonlight-smoke", n_layers=3, d_model=128, n_heads=4,
    n_kv_heads=4, d_ff=256, vocab=512, n_experts=16, top_k=4, moe_d_ff=64,
    shared_d_ff=128, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
    v_head_dim=16, n_experts_held=4, max_seq=128)
