"""whisper-large-v3 [audio]: enc-dec, conv frontend STUB (input_specs
provides precomputed mel-frame embeddings (B, 1500, d_model)), GELU MLP,
LayerNorm, no rope (learned absolute positions). [arXiv:2212.04356]

long_500k: SKIPPED (448-token decoder context by construction; see
DESIGN.md §4).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866,
    n_enc_layers=32, n_audio_frames=1500,
    norm="layernorm", mlp="gelu",
    source="arXiv:2212.04356",
)

SMOKE = CONFIG.with_overrides(
    name="whisper-smoke", n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
    d_ff=512, vocab=512, n_enc_layers=2, n_audio_frames=32, max_seq=128)
