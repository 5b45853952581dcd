"""Expert-parallel Mixture-of-Experts with capacity-based token dispatch.

The port of ``repro/models/moe.py``.  Layout:
  router w: (D, E)                      — replicated (tiny)
  expert w1/w3: (E/tp, D, Fe), w2: (E/tp, Fe, D)   — expert-parallel
  dispatch buffer: (E, C, D) per rank -> all_to_all(model) ->
  (E_loc, tp*C, D) per rank -> expert FFN -> reverse

Capacity C = ceil(T·k / E · capacity_factor); overflow tokens are dropped
(standard top-k capacity routing).  Aux losses: load-balance (Switch) +
router z-loss.  The expert FFN is einsum in the reference, not its
grouped-matmul kernel (ROADMAP C6), so it is ``torch.einsum`` here too.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import (MeshAxes, col_linear, fsdp_gather, model_rank,
                     row_linear, tp_all_gather, tp_all_to_all)


def router_topk(logits, k: int):
    """logits (T, E) -> (gates (T,k), idx (T,k), probs).

    ``lax.top_k`` breaks ties to the lowest index and ``torch.topk``
    promises no order, so the choice is a stable descending sort's first
    k (bf16 router logits tie often)."""
    probs = torch.softmax(logits.float(), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    gates = gates / torch.clamp(torch.sum(gates, -1, keepdim=True), min=1e-9)
    return gates, idx, probs


def _positions_in_expert(idx, E: int, k: int):
    """Priority-ordered position of each (token, choice) in its expert."""
    pos = []
    counts = torch.zeros((E,), dtype=torch.int64, device=idx.device)
    for c in range(k):
        oh = F.one_hot(idx[:, c], E)                              # (T, E)
        pic = torch.cumsum(oh, dim=0) - 1 + counts[None, :]
        counts = counts + torch.sum(oh, dim=0)
        pos.append(torch.sum(pic * oh, dim=-1))                   # (T,)
    return torch.stack(pos, dim=1)                                # (T, k)


def moe_block(p, x, cfg: ModelConfig, ax: MeshAxes
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    xt_full = x.reshape(B * S, D)

    # Activations are replicated across the model axis, so each
    # expert-parallel rank routes a disjoint 1/tp slice of the tokens;
    # outputs are all-gathered back afterwards.
    tp = ax.tp
    token_split = tp > 1 and xt_full.shape[0] % tp == 0 \
        and xt_full.shape[0] >= tp
    if token_split:
        Tl = xt_full.shape[0] // tp
        xt = xt_full[model_rank(ax) * Tl:(model_rank(ax) + 1) * Tl]
    else:
        # tiny token counts (decode): all ranks route identical copies
        xt = xt_full
    T = xt.shape[0]

    logits = xt @ p["router"].to(xt.dtype)                        # (T, E)
    gates, idx, probs = router_topk(logits, k)

    # --- aux losses ----------------------------------------------------------
    me = torch.mean(probs, dim=0)                                  # (E,)
    ce = torch.mean(torch.sum(F.one_hot(idx, E).float(), dim=1), dim=0)
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)
    zloss = 1e-3 * torch.mean(
        torch.square(torch.logsumexp(logits.float(), dim=-1)))
    aux = aux + zloss

    # --- capacity + dispatch ---------------------------------------------------
    C = max(1, math.ceil(T * k / E * cfg.capacity_factor))
    pos = _positions_in_expert(idx, E, k)                          # (T, k)
    keep = pos < C
    e_flat = idx.reshape(-1)                                       # (T*k,)
    p_flat = torch.clamp(pos.reshape(-1), 0, C - 1)
    w_flat = (gates * keep).reshape(-1)

    # each kept (e, p) receives one token and dropped ones add exact
    # zeros, so the accumulate is deterministic on the card too
    src = xt.repeat_interleave(k, dim=0) * keep.reshape(-1, 1).to(xt.dtype)
    buf = torch.zeros((E, C, D), dtype=xt.dtype, device=xt.device
                      ).index_put((e_flat, p_flat), src, accumulate=True)

    # --- all_to_all over the model axis (expert parallel) ----------------------
    if tp > 1:
        e_loc = E // tp
        buf = buf.reshape(tp * e_loc, C, D)
        buf = tp_all_to_all(buf.contiguous(), ax)
        # now buf[s, e] = tokens from source rank s for local expert e
        buf = buf.reshape(tp, e_loc, C, D).transpose(0, 1).reshape(
            e_loc, tp * C, D)

    # --- expert FFN ------------------------------------------------------------
    w1 = fsdp_gather(p["w1"], ax, 1).to(buf.dtype)   # (e_loc, D, Fe)
    w3 = fsdp_gather(p["w3"], ax, 1).to(buf.dtype)
    w2 = fsdp_gather(p["w2"], ax, 2).to(buf.dtype)   # (e_loc, Fe, D)
    h = torch.einsum("ecd,edf->ecf", buf, w1)
    u = torch.einsum("ecd,edf->ecf", buf, w3)
    h = F.silu(h.float()).to(buf.dtype) * u
    out = torch.einsum("ecf,efd->ecd", h, w2)

    # --- reverse all_to_all -----------------------------------------------------
    if tp > 1:
        e_loc = E // tp
        out = out.reshape(e_loc, tp, C, D).transpose(0, 1).reshape(
            tp * e_loc, C, D)
        out = tp_all_to_all(out.contiguous(), ax)
        out = out.reshape(E, C, D)

    # --- combine -----------------------------------------------------------------
    gathered = out[e_flat, p_flat]                                  # (T*k, D)
    y = torch.sum((gathered * w_flat[:, None].to(gathered.dtype)
                   ).reshape(T, k, D), dim=1)

    # restore replication across the model axis
    if token_split:
        y = tp_all_gather(y, ax)

    # --- shared experts (llama4): dense TP path over the FULL token set --------
    if cfg.n_shared_experts:
        hs = col_linear(xt_full, p["shared_w1"], ax, fsdp_dim=0)
        us = col_linear(xt_full, p["shared_w3"], ax, fsdp_dim=0)
        hs = F.silu(hs.float()).to(xt_full.dtype) * us
        y = y + row_linear(hs, p["shared_w2"], ax, fsdp_dim=1)

    return y.reshape(B, S, D), aux
