"""Feed-forward blocks: SwiGLU / GeLU, tensor-parallel (the port of
``repro/models/mlp.py``)."""

from __future__ import annotations

import torch.nn.functional as F

from .config import ModelConfig
from .layers import MeshAxes, col_linear, row_linear


def mlp_block(p, x, cfg: ModelConfig, ax: MeshAxes):
    if cfg.mlp == "swiglu":
        g = col_linear(x, p["w_gate"], ax, fsdp_dim=0)
        u = col_linear(x, p["w_up"], ax, fsdp_dim=0)
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = col_linear(x, p["w_up"], ax, bias=p.get("b_up"), fsdp_dim=0)
        # jax.nn.gelu defaults to the tanh approximation; F.gelu to erf
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return row_linear(h, p["w_down"], ax, bias=p.get("b_down"), fsdp_dim=1)
