"""Moonlight-16B-A3B's DeepSeek-V3 block, one chip's share of it, trained
in plain PyTorch, float32 with TF32 off: RMSNorm (eps ``rms_norm_eps``);
multi-head latent attention without a query LoRA (``q = x W_q`` split per
head into 128 dims without and 64 with rope; ``[c, k_pe] = x W_kva``,
``c`` RMS-normed; ``[k_nope, v] = c W_kvb``; RoPE, theta ``rope_theta``,
on ``q_pe`` and on ``k_pe``, one head shared by all; causal softmax
scaled by 192^-0.5; ``o = attn v``, then ``W_o``); a dense SwiGLU layer
first, then expert layers: f32 scores ``s = sigmoid(h W_r)`` over all 64
experts, the top-6 of ``s + b`` chosen, gates ``s`` of those over their
sum (plus 1e-20) times ``routed_scaling_factor``, each held expert's
SwiGLU on the tokens that chose it, plus the shared experts' SwiGLU;
the final norm and an untied head; mean next-token cross-entropy plus
alpha times the sequence-wise balance loss of every expert layer; AdamW
as ``qwen3.py`` states it, with the bias ``b`` left out of it and moved
after each step by ``b_i += gamma * sign(mean load - load_i)``.

Departures from the published model, each the configuration's (the
model file's ``reduced`` and ``assumed``):

- the share: the layer holds experts ``[first, first + held)`` of the 64
  and computes their part of the result alone; the parts of the absent
  experts, which other chips of the deployment would add, are left out.
  The router keeps its 64 outputs and its top-6, and the balance loss and
  the bias update see every expert's count from this chip's tokens;
- the vocabulary is the slice the model file gives (ids 0-20,479);
- RoPE rotates the two halves of the 64 rope dims (``rotate_half``).
  The published code de-interleaves them first: with seeded weights the
  two differ by a fixed permutation of the rope columns of ``W_q`` and
  ``W_kva``;
- the bias's step gamma (0.001) and alpha (1e-4) are the DeepSeek-V3
  report's; the model's config states neither.

It runs a sequence at a time, each layer under activation checkpointing,
so that it fits on the card beside its optimizer state.  ``quantize`` is
the control of ``qwen3.py``: every matrix product's operands rounded to
float8 e4m3.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .qwen3 import _mm, lr_at, rms, rope


def held(model: dict):
    """(first expert held, experts held)."""
    d = model["deployment"]
    return d["first_expert"], model["n_routed_experts"]


def mla(h, W: Dict[str, torch.Tensor], p: str, i: int, model: dict,
        quantize: bool):
    B, S, _ = h.shape
    H = model["num_attention_heads"]
    dn, dr = model["qk_nope_head_dim"], model["qk_rope_head_dim"]
    dv, R = model["v_head_dim"], model["kv_lora_rank"]
    eps, theta = model["rms_norm_eps"], model["rope_theta"]
    q = _mm(h, W[p + "attn.wq"][i], quantize).view(B, S, H, dn + dr)
    kv = _mm(h, W[p + "attn.wkv_a"][i], quantize)
    c, k_pe = kv[..., :R], kv[..., R:]
    c = rms(c, W[p + "attn.kv_norm"][i], eps)
    kvb = _mm(c, W[p + "attn.wkv_b"][i], quantize).view(B, S, H, dn + dv)
    k_nope, v = kvb[..., :dn], kvb[..., dn:]
    q = torch.cat([q[..., :dn], rope(q[..., dn:], theta)], dim=-1)
    k_pe = rope(k_pe[:, :, None, :], theta).expand(B, S, H, dr)
    k = torch.cat([k_nope, k_pe], dim=-1)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # (B, H, S, .)
    att = _mm(q, k.transpose(-1, -2), quantize) / math.sqrt(dn + dr)
    mask = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    att = att.masked_fill(~mask, float("-inf")).softmax(-1)
    o = _mm(att, v, quantize).transpose(1, 2).reshape(B, S, H * dv)
    return _mm(o, W[p + "attn.wo"][i], quantize)


def swiglu(h, w_gate, w_up, w_down, quantize: bool):
    return _mm(F.silu(_mm(h, w_gate, quantize)) * _mm(h, w_up, quantize),
               w_down, quantize)


def experts(h, W, i: int, model: dict, quantize: bool):
    """The expert layer on (1, S, D): (out, balance loss, (E,) counts)."""
    _, S, D = h.shape
    E, k = model["deployment"]["router_experts"], model["num_experts_per_tok"]
    first, n = held(model)
    p = "blocks.0.moe."
    x = h.reshape(S, D)
    s = torch.sigmoid(_mm(x, W[p + "router"][i], quantize))   # (S, E)
    idx = torch.topk(s.detach() + W[p + "router_bias"][i], k, dim=-1).indices
    g = s.gather(1, idx)
    g = g / (g.sum(-1, keepdim=True) + 1e-20) \
        * model["routed_scaling_factor"]
    y = torch.zeros_like(x)
    for j in range(n):
        chose = idx == first + j                                # (S, k)
        rows = chose.any(-1)
        gate = (g * chose).sum(-1)[rows, None]
        y[rows] += gate * swiglu(x[rows], W[p + "w1"][i, j],
                                 W[p + "w3"][i, j], W[p + "w2"][i, j],
                                 quantize)
    y = y + swiglu(x, W[p + "shared_w1"][i], W[p + "shared_w3"][i],
                   W[p + "shared_w2"][i], quantize)
    count = torch.zeros(E, device=x.device).index_add_(
        0, idx.reshape(-1), torch.ones(S * k, device=x.device))
    f = count * E / (k * S)
    P = (s / s.sum(-1, keepdim=True)).mean(0)
    return y.view(1, S, D), (f * P).sum(), count


def moe_layer(x, W, i: int, model: dict, quantize: bool):
    eps, p = model["rms_norm_eps"], "blocks.0."
    x = x + mla(rms(x, W[p + "ln1.scale"][i], eps), W, p, i, model,
                quantize)
    y, bal, count = experts(rms(x, W[p + "ln2.scale"][i], eps), W, i,
                            model, quantize)
    return x + y, bal, count


def dense_layer(x, W, i: int, model: dict, quantize: bool):
    eps, p = model["rms_norm_eps"], "dense."
    x = x + mla(rms(x, W[p + "ln1.scale"][i], eps), W, p, i, model,
                quantize)
    return x + swiglu(rms(x, W[p + "ln2.scale"][i], eps),
                      W[p + "mlp.w_gate"][i], W[p + "mlp.w_up"][i],
                      W[p + "mlp.w_down"][i], quantize)


def loss(W, tokens, labels, model: dict, quantize: bool = False):
    """(mean next-token cross-entropy plus alpha times the balance loss
    summed over the expert layers, the expert layers' (n, E) counts) for
    one sequence, ``tokens`` (1, S)."""
    x = W["embed"][tokens]
    for i in range(model["first_k_dense_replace"]):
        x = checkpoint(dense_layer, x, W, i, model, quantize,
                       use_reentrant=False)
    bal, counts = 0.0, []
    for i in range(W["blocks.0.moe.router"].shape[0]):
        x, b, c = checkpoint(moe_layer, x, W, i, model, quantize,
                             use_reentrant=False)
        bal, counts = bal + b, counts + [c]
    h = rms(x, W["final_norm.scale"][0], model["rms_norm_eps"])
    logits = _mm(h, W["lm_head"].t(), quantize)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         labels.reshape(-1))
    return ce + model["seq_aux_alpha"] * bal, torch.stack(counts)


def train_readings(W: Dict[str, torch.Tensor], batches: List[dict],
                   model: dict, mix: dict, quantize: bool = False) -> dict:
    """Each step's loss, each leaf's norm of the first step's clipped
    gradient, each leaf's norm of the change after all the steps, and
    the biases after them.  ``W`` is updated in place."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt = mix["opt"]
    names = list(W)
    bias = "blocks.0.moe.router_bias"
    trained = [n for n in names if n != bias]
    p0 = {n: W[n].detach().clone() for n in names}
    m = {n: torch.zeros_like(W[n]) for n in trained}
    v = {n: torch.zeros_like(W[n]) for n in trained}
    for n in trained:
        W[n].requires_grad_(True)
    losses, first_grad = [], None
    E, k = model["deployment"]["router_experts"], model["num_experts_per_tok"]
    for step, b in enumerate(batches):
        dev = W["embed"].device
        tok = torch.as_tensor(b["tokens"]).to(dev).long()
        lab = torch.as_tensor(b["labels"]).to(dev).long()
        total, load = 0.0, 0.0
        for r in range(tok.shape[0]):
            lr_, c = loss(W, tok[r:r + 1], lab[r:r + 1], model, quantize)
            (lr_ / tok.shape[0]).backward()
            total += float(lr_.detach()) / tok.shape[0]
            load = load + c
        losses.append(total)
        with torch.no_grad():
            gnorm = math.sqrt(sum(float(W[n].grad.double().pow(2).sum())
                                  for n in trained))
            clip = min(1.0, opt["grad_clip"] / max(gnorm, 1e-9))
            t = step + 1
            lr = lr_at(step, opt, mix["total_steps"], mix["warmup_steps"])
            bc1, bc2 = 1 - opt["b1"] ** t, 1 - opt["b2"] ** t
            if first_grad is None:
                first_grad = [0.0 if n == bias else
                              float(W[n].grad.norm()) * clip for n in names]
            for n in trained:
                g = W[n].grad * clip
                m[n].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                v[n].mul_(opt["b2"]).addcmul_(g, g, value=1 - opt["b2"])
                upd = (m[n] / bc1) / ((v[n] / bc2).sqrt() + opt["eps"]) \
                    + opt["weight_decay"] * W[n]
                W[n].sub_(lr * upd)
                W[n].grad = None
            mean = tok.numel() * k / E
            W[bias].add_(torch.sign(mean - load),
                         alpha=model["bias_update_gamma"])
    with torch.no_grad():
        change = [float((W[n] - p0[n]).norm()) for n in names]
    for n in trained:
        W[n].requires_grad_(False)
    return {"losses": losses, "grad_norms": first_grad,
            "change_norms": change, "names": names,
            "bias": W[bias].detach().clone()}
