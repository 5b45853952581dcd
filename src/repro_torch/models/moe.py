"""Expert-parallel Mixture-of-Experts with capacity-based token dispatch;
and DeepSeek-V3's dropless sigmoid-routed layer on a share of the experts
(``held_moe_block``), which the reference has not.

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

from ..obs import trace as _trace
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
        y = y + _shared(p, xt_full, ax)

    return y.reshape(B, S, D), aux


def _shared(p, xt, ax: MeshAxes):
    """The shared experts, one SwiGLU of their summed width, on every
    token."""
    hs = col_linear(xt, p["shared_w1"], ax, fsdp_dim=0)
    us = col_linear(xt, p["shared_w3"], ax, fsdp_dim=0)
    hs = F.silu(hs.float()).to(xt.dtype) * us
    return row_linear(hs, p["shared_w2"], ax, fsdp_dim=1)


# ===========================================================================
# DeepSeek-V3's expert layer on a share of the experts (LatentMoEConfig)
# ===========================================================================

def sigmoid_route(logits, bias, k: int, scale: float):
    """DeepSeek-V3's router (``noaux_tc`` with one group): f32 scores
    ``s = sigmoid(logits)``; the experts of the top-k of ``s + bias``
    (the bias selects and never weights; ties to the lowest index, as in
    ``router_topk``); the gates ``s`` of those experts over their sum
    (plus 1e-20, as the published code adds) times ``scale``.  Returns
    (gates (T,k) f32, idx (T,k), s (T,E) f32)."""
    s = torch.sigmoid(logits.float())
    _, idx = torch.sort(s.detach() + bias, dim=-1, descending=True,
                        stable=True)
    idx = idx[:, :k]
    g = torch.gather(s, 1, idx)
    g = g / (torch.sum(g, -1, keepdim=True) + 1e-20) * scale
    return g, idx, s


def sequence_balance(s, idx, B: int, E: int, k: int):
    """DeepSeek-V3's sequence-wise balance loss (report, eqs. 17-20) before
    its factor alpha, averaged over the batch's sequences: for each
    sequence, sum over experts of ``f_i * P_i``, ``f_i`` the share of the
    sequence's k-choices that picked expert i times ``E / k`` and ``P_i``
    the mean over the sequence of its scores normalised to sum 1.  Also
    returns each expert's (token, choice) count over the batch, (E,)."""
    S = s.shape[0] // B
    cnt = torch.zeros((B, E), dtype=torch.float32, device=s.device
                      ).scatter_add_(1, idx.reshape(B, S * k),
                                     torch.ones((B, S * k), device=s.device))
    P = (s / torch.sum(s, -1, keepdim=True)).reshape(B, S, E).mean(1)
    f = cnt * (E / (k * S))
    return torch.mean(torch.sum(f * P, -1)), cnt.sum(0)


def held_moe_block(p, x, cfg, ax: MeshAxes, loads=None):
    """x: (B, S, D) -> (out, aux_loss).  The router scores every expert;
    the layer computes its held experts' part of the result for every
    (token, choice) routed to them, none dropped, plus the shared
    experts.  Pairs are grouped by held expert with a stable sort; the
    group sizes are read on the host once (``moe.host_syncs``) and each
    held expert runs its SwiGLU on its rows; each pair's output goes back
    to its own slot, so the combine sums in a fixed order.  The
    (token, choice) counts over all experts are appended to ``loads``
    where it is a list (the bias update reads them)."""
    if ax.tp > 1:
        raise NotImplementedError("the held-expert layer runs at tp == 1")
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    lo, n_held = cfg.held_experts
    xt = x.reshape(B * S, D)
    T, dt = xt.shape[0], xt.dtype

    with _trace.span(_trace.MOE_DISPATCH):
        logits = xt.float() @ p["router"].float()                 # (T, E)
        gates, idx, s = sigmoid_route(logits, p["router_bias"], k,
                                      cfg.routed_scale)
        local = (idx - lo).reshape(-1)                             # (T*k,)
        e = torch.where((local >= 0) & (local < n_held), local, n_held)
        rows = torch.argsort(e, stable=True)
        sizes = torch.bincount(e, minlength=n_held + 1)[:n_held].tolist()
        _trace.bump(_trace.MOE_HOST_SYNCS)
        rows = rows[:sum(sizes)]
        xs = xt.repeat_interleave(k, dim=0).index_select(0, rows)

    bal, load = sequence_balance(s, idx, B, E, k)
    if loads is not None:
        loads.append(load)
    w1 = fsdp_gather(p["w1"], ax, 1).to(dt)          # (held, D, Fe)
    w3 = fsdp_gather(p["w3"], ax, 1).to(dt)
    w2 = fsdp_gather(p["w2"], ax, 2).to(dt)          # (held, Fe, D)
    outs = []
    for j, xj in enumerate(torch.split(xs, sizes)):
        h = F.silu((xj @ w1[j]).float()).to(dt) * (xj @ w3[j])
        outs.append(h @ w2[j])
    ys = torch.zeros((T * k, D), dtype=dt, device=xt.device
                     ).index_copy(0, rows, torch.cat(outs))
    y = torch.sum(ys.reshape(T, k, D) * gates[..., None].to(dt), dim=1)
    if cfg.n_shared_experts:
        y = y + _shared(p, xt, ax)
    return y.reshape(B, S, D), cfg.router_aux_coef * bal


def update_router_bias(biases, loads, cfg, tokens: int) -> None:
    """DeepSeek-V3's bias update after an optimizer step (report,
    section 2.1.2): each expert's bias moves by ``cfg.bias_rate`` toward
    the mean load, ``b_i += rate * sign(mean - load_i)``, from this
    rank's (token, choice) counts of the step over every expert, one
    (E,) count per layer in ``loads`` for each (E,) bias in ``biases``.  The held experts' counts
    go to the ``moe.pairs_held`` counter."""
    mean = tokens * cfg.top_k / cfg.n_experts
    lo, n_held = cfg.held_experts
    for b, load in zip(biases, loads):
        b.add_(torch.sign(mean - load), alpha=cfg.bias_rate)
    _trace.accumulate(_trace.MOE_PAIRS_HELD,
                      lambda: torch.stack(loads)[:, lo:lo + n_held].sum(0))
