"""Unified model configuration covering all six assigned families, and
``LatentMoEConfig``, the DeepSeek-V3 block (latent attention, a
sigmoid-routed expert layer that holds a share of the experts, leading
dense layers), which the port has and the reference has not."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # attention
    head_dim: Optional[int] = None           # default d_model // n_heads
    qkv_bias: bool = False                   # qwen2.5
    qk_norm: bool = False                    # qwen3
    rope_theta: float = 10_000.0
    attention: str = "full"                  # full | sliding | chunked
    window: int = 4096                       # sliding/chunked width
    nope_every: int = 0                      # llama4 iRoPE: every k-th layer no rope

    # norm / mlp
    norm: str = "rmsnorm"                    # rmsnorm | layernorm
    mlp: str = "swiglu"                      # swiglu | gelu
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                        # expert hidden dim
    n_shared_experts: int = 0                # llama4 shared expert
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM / hybrid
    slstm_every: int = 0                     # xlstm: every k-th layer sLSTM
    rglru_pattern: Tuple[str, ...] = ()      # e.g. ("rec","rec","attn")
    rglru_width: int = 0                     # RG-LRU feature dim (=d_model)
    conv1d_width: int = 4

    # encoder-decoder (audio)
    n_enc_layers: int = 0
    n_audio_frames: int = 1500               # whisper frontend output length

    # VLM
    n_patch_tokens: int = 0                  # stub vision tokens per sample

    # numerics / misc
    dtype: str = "bfloat16"
    max_seq: int = 8192
    remat: bool = False                      # activation checkpoint per period
    remat_policy: str = "none"               # none | save_psum (keep fwd
                                             # collective results; no comm
                                             # in the rematerialized pass)
    mlstm_chunk: int = 128                   # xLSTM chunkwise-parallel width
    source: str = ""                         # citation

    # The DeepSeek-V3 block's settings are fields of ``LatentMoEConfig``
    # alone, so that every other config's fields stay the reference's;
    # here they are class constants that keep each model on its own path.
    rms_eps = 1e-6                           # every RMSNorm's epsilon
    first_k_dense = 0                        # leading dense layers
    kv_lora_rank = 0                         # > 0: latent attention (MLA)
    router = "softmax"                       # softmax (capacity) | sigmoid
    shared_d_ff = 0                          # 0: moe_d_ff * n_shared_experts

    # ---- derived -----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def shared_width(self) -> int:
        return self.shared_d_ff or self.moe_d_ff * self.n_shared_experts

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    def padded_heads(self, tp: int) -> int:
        """q heads padded to a multiple of tp (zero-weight pad heads)."""
        return math.ceil(self.n_heads / tp) * tp

    def padded_vocab(self, tp: int) -> int:
        return math.ceil(self.vocab / tp) * tp

    def block_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind sequence for the decoder stack."""
        kinds = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                if self.slstm_every and (i + 1) % self.slstm_every == 0:
                    kinds.append("slstm")
                else:
                    kinds.append("mlstm")
            elif self.family == "hybrid" and self.rglru_pattern:
                kinds.append(
                    "rglru" if self.rglru_pattern[i % len(self.rglru_pattern)]
                    == "rec" else "attn")
            else:
                kinds.append("attn")
        return tuple(kinds)

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # parameter count (for 6·N·D model flops)
    def param_count(self, *, active_only: bool = False) -> int:
        D, H, KV, hd, F, V, L = (self.d_model, self.n_heads,
                                 self.n_kv_heads, self.hd, self.d_ff,
                                 self.vocab, self.n_layers)
        emb = V * D * (1 if self.tie_embeddings else 2)
        per_attn = D * (H * hd) + 2 * D * (KV * hd) + (H * hd) * D
        if self.mlp == "swiglu":
            per_mlp = 3 * D * F
        else:
            per_mlp = 2 * D * F
        total = emb
        kinds = self.block_kinds()
        for i, k in enumerate(kinds):
            if k == "attn":
                total += per_attn
                if self.is_moe:
                    e = (self.top_k if active_only else self.n_experts)
                    total += 3 * D * self.moe_d_ff * e
                    total += D * self.n_experts  # router
                    if self.n_shared_experts:
                        total += 3 * D * self.moe_d_ff * self.n_shared_experts
                elif F:
                    total += per_mlp
            elif k == "mlstm":
                total += 2 * D * 2 * D + 2 * D * D + 4 * D  # up/qkv-ish/down
            elif k == "slstm":
                total += 4 * D * D * 2
            elif k == "rglru":
                w = self.rglru_width or D
                total += 2 * D * w + w * D + 3 * w + self.conv1d_width * w
                total += per_mlp if F else 0
        if self.family == "audio":
            total += self.n_enc_layers * (per_attn + per_mlp)
            total += L * per_attn  # cross-attention
        if self.family == "hybrid" and F:
            # rglru blocks above added mlp only on rglru kind; attn adds too
            pass
        return int(total)


@dataclasses.dataclass(frozen=True)
class LatentMoEConfig(ModelConfig):
    """The DeepSeek-V3 block (arXiv:2412.19437), as Moonlight and Kimi-K2
    publish it: multi-head latent attention without a query LoRA, and an
    expert layer routed by ``sigmoid`` scores, selected by the top-k of
    the scores plus a per-expert bias that training moves by a sign rule,
    gated by the selected scores normalised and scaled, with no token
    dropped; shared experts of their own width; ``first_k_dense`` dense
    layers (width ``d_ff``) before the expert layers.

    This chip holds experts ``[expert_shard * n_experts_held, ...)`` of
    ``n_experts`` (all of them where ``n_experts_held`` is 0): the router
    scores all ``n_experts`` and the layer computes its own experts'
    part of the result (expert parallelism without its exchange)."""
    rms_eps: float = 1e-6
    first_k_dense: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0                     # per-head q/k dims without rope
    qk_rope_dim: int = 0                     # per-head q dims, shared k, rope
    v_head_dim: int = 0
    routed_scale: float = 1.0                # gates' scale after normalising
    bias_rate: float = 0.0                   # the bias's step (gamma)
    n_experts_held: int = 0
    expert_shard: int = 0
    shared_d_ff: int = 0
    router = "sigmoid"

    @property
    def held_experts(self) -> Tuple[int, int]:
        """(first expert held, experts held)."""
        n = self.n_experts_held or self.n_experts
        return self.expert_shard * n, n

    def param_count(self, *, active_only: bool = False) -> int:
        """Parameters this chip holds (or, ``active_only``, uses for one
        token: its top-k experts as if all were held), bias included."""
        D, H, V = self.d_model, self.n_heads, self.vocab
        dn, dr, dv, R = (self.qk_nope_dim, self.qk_rope_dim,
                         self.v_head_dim, self.kv_lora_rank)
        attn = D * H * (dn + dr) + D * (R + dr) + R + R * H * (dn + dv) \
            + H * dv * D
        norms = 2 * D
        dense = attn + norms + 3 * D * self.d_ff
        e = self.top_k if active_only else self.held_experts[1]
        moe = attn + norms + 3 * D * self.moe_d_ff * e \
            + 3 * D * self.shared_width + D * self.n_experts + self.n_experts
        emb = V * D * (1 if self.tie_embeddings else 2)
        return int(emb + D + self.first_k_dense * dense
                   + (self.n_layers - self.first_k_dense) * moe)
