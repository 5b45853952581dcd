"""llava-next-mistral-7b [vlm]: Mistral-7B backbone + anyres vision stub.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]

The ViT/SigLIP encoder + projector are a STUB per the brief: input_specs
provides precomputed patch embeddings of the right shape (anyres tiling:
up to 2880 patch tokens); the framework implements the language decoder
that consumes them.  Mistral backbone: native sliding-window 4096.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000,
    attention="sliding", window=4096, rope_theta=1e6,
    n_patch_tokens=2880,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)

SMOKE = CONFIG.with_overrides(
    name="llava-smoke", n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab=512, window=64, n_patch_tokens=16, max_seq=128)
