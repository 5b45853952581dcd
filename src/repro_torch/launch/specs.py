"""Meta-tensor stand-ins for every model input and state — the dry run's
no-allocation input builder (the port of ``repro/launch/specs.py``).

Where the reference returns ``jax.ShapeDtypeStruct`` trees, these return
tensors on the ``meta`` device: the shapes and dtypes are real, no
storage is allocated, and every op on them computes only the shapes of
its outputs.  The spec trees are the port's (a tuple per leaf naming the
mesh axis each dimension is split over), as ``train/step.py``'s
``shard_tree`` takes them.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..models import init_params
from ..models.config import ModelConfig
from ..models.layers import MeshAxes
from ..train.optimizer import adamw_init

META = torch.device("meta")


def param_shapes_and_specs(cfg: ModelConfig, ax: MeshAxes):
    """(params meta tree, spec tree) without allocating anything: the
    port's own ``init_params`` on the meta device (a CPU generator draws
    nothing there)."""
    return init_params(torch.Generator().manual_seed(0), cfg, ax,
                       device=META)


def opt_shapes(params_meta):
    return adamw_init(params_meta)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_shapes(cfg: ModelConfig, B: int, S: int, *, kind: str
                 ) -> Dict[str, torch.Tensor]:
    """Global batch stand-ins.  For VLM, patch tokens come out of the seq
    budget (patches + text = S)."""
    if cfg.family == "vlm":
        s_text = max(S - cfg.n_patch_tokens, 1)
        return {"tokens": _meta((B, s_text), torch.int32),
                "labels": _meta((B, s_text), torch.int32),
                "patches": _meta((B, cfg.n_patch_tokens, cfg.d_model),
                                 torch.float32)}
    out = {"tokens": _meta((B, S), torch.int32),
           "labels": _meta((B, S), torch.int32)}
    if cfg.family == "audio":
        out["frames"] = _meta((B, cfg.n_audio_frames, cfg.d_model),
                              torch.float32)
    return out


def cache_shapes_and_specs(cfg: ModelConfig, B: int, ctx: int,
                           ax: MeshAxes, dp_axes):
    """GLOBAL cache shapes + specs (the per-rank view is
    ``models.transformer.init_caches``).  dp_axes: batch sharding axes or
    None (replicated small-batch decode).  A recurrent layer's specs sit
    in a list where its states sit in a tuple: a tuple of specs would
    read as one spec (``train.step.spec_leaves``)."""
    from ..models.attention import _local_heads, kv_split
    dt = cfg.torch_dtype
    shapes, specs = [], []
    for k in cfg.block_kinds():
        if k == "attn":
            _, kv_loc = _local_heads(cfg, ax)
            kv_total = kv_loc * ax.tp if kv_split(cfg, ax) else kv_loc
            kv_axis = "model" if kv_split(cfg, ax) else None
            window = cfg.window if cfg.attention in ("sliding", "chunked") \
                else 0
            C = min(ctx, window) if window else ctx
            shapes.append(dict(
                k=_meta((B, C, kv_total, cfg.hd), dt),
                v=_meta((B, C, kv_total, cfg.hd), dt),
                pos=_meta((B, C), torch.int32),
                idx=_meta((), torch.int32)))
            specs.append(dict(
                k=(dp_axes, None, kv_axis, None),
                v=(dp_axes, None, kv_axis, None),
                pos=(dp_axes, None), idx=()))
        elif k == "mlstm":
            H = cfg.n_heads
            inner = 2 * cfg.d_model
            dk = inner // H
            dv_total = inner // H          # per-head v dim, TP-sharded
            shapes.append((_meta((B, H, dv_total, dk), torch.float32),
                           _meta((B, H, dk), torch.float32),
                           _meta((B, H), torch.float32)))
            specs.append([(dp_axes, None, "model", None),
                          (dp_axes, None, None),
                          (dp_axes, None)])
        elif k == "slstm":
            U = cfg.d_model
            shapes.append(tuple(_meta((B, U), torch.float32)
                                for _ in range(4)))
            specs.append([(dp_axes, "model") for _ in range(4)])
        elif k == "rglru":
            W = cfg.rglru_width or cfg.d_model
            K = cfg.conv1d_width
            shapes.append({"h": _meta((B, W), torch.float32),
                           "conv": _meta((B, K - 1, W), torch.float32)})
            specs.append({"h": (dp_axes, "model"),
                          "conv": (dp_axes, None, "model")})
    return shapes, specs
