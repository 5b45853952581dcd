"""Model zoo: unified decoder LMs, MoE, SSM (xLSTM), hybrid (RG-LRU),
encoder-decoder (Whisper) and VLM (LLaVA) — the port of ``repro.models``,
plain functions on a parameter tree of tensors, with every collective of
the model axis routed through the policy dispatcher; ``LM`` holds the
tree as an ``nn.Module``.
"""

from .config import ModelConfig
from .lm import LM
from .transformer import (decode_step, forward_logits, init_params,
                          loss_fn, prefill)

__all__ = ["LM", "ModelConfig", "decode_step", "forward_logits",
           "init_params", "loss_fn", "prefill"]
