"""xlstm-1.3b [ssm]: mLSTM (matrix memory, chunkwise-parallel training)
with sLSTM every 8th layer.  d_ff=0: the mLSTM block carries its own 2x
up-projection. [arXiv:2405.04517]
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    slstm_every=8,
    source="arXiv:2405.04517",
)

SMOKE = CONFIG.with_overrides(
    name="xlstm-smoke", n_layers=2, d_model=256, n_heads=2, n_kv_heads=2,
    vocab=512, slstm_every=2, max_seq=128)
