"""Qwen3 training in plain PyTorch, float32 with TF32 off: the layer
equations of the published model (RMSNorm, q/k/v projections, per-head
RMSNorm of q and k, RoPE on the two halves of each head, causal
grouped-query attention, SwiGLU, a tied output head, mean next-token
cross-entropy) and AdamW as the training recipe states it (the gradient
clipped by its global norm, bias-corrected moments, decoupled weight
decay, linear warm-up then cosine to a tenth of the rate).

It runs a sequence at a time, each layer under activation checkpointing,
so that it fits on the card beside its optimizer state; the gradient of
the batch's mean loss is the sum of the sequences' gradients, each scaled
by the share of the batch's tokens it holds.

``quantize`` is the control: every matrix product's two operands rounded
to float8 e4m3 (each tensor scaled to the format's largest value first),
the nearest precision below the bfloat16 the configuration computes in;
the gradient passes the rounding unchanged.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        s = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
        return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s

    @staticmethod
    def backward(ctx, g):
        return g


def _mm(a, b, quantize: bool):
    if quantize:
        a, b = _Fp8.apply(a), _Fp8.apply(b)
    return a @ b


def rms(x, scale, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """x (B, S, heads, hd): the two halves of each head rotated by
    position times 1 / theta^(2i / hd)."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = (torch.arange(S, dtype=torch.float64, device=x.device)[:, None]
           * inv).to(x.dtype)[None, :, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    c, s = torch.cos(ang), torch.sin(ang)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def layer(x, W: Dict[str, torch.Tensor], i: int, model: dict,
          quantize: bool):
    B, S, D = x.shape
    H, KV = model["num_attention_heads"], model["num_key_value_heads"]
    hd, eps = model["head_dim"], model["rms_norm_eps"]
    p = "blocks.0."
    h = rms(x, W[p + "ln1.scale"][i], eps)
    q = _mm(h, W[p + "attn.wq"][i], quantize).view(B, S, H, hd)
    k = _mm(h, W[p + "attn.wk"][i], quantize).view(B, S, KV, hd)
    v = _mm(h, W[p + "attn.wv"][i], quantize).view(B, S, KV, hd)
    q = rope(rms(q, W[p + "attn.q_norm"][i], eps), model["rope_theta"])
    k = rope(rms(k, W[p + "attn.k_norm"][i], eps), model["rope_theta"])
    g = H // KV
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # (B, H, S, hd)
    att = _mm(q, k.transpose(-1, -2), quantize) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    att = att.masked_fill(~mask, float("-inf")).softmax(-1)
    o = _mm(att, v, quantize).transpose(1, 2).reshape(B, S, H * hd)
    x = x + _mm(o, W[p + "attn.wo"][i], quantize)
    h = rms(x, W[p + "ln2.scale"][i], eps)
    u = F.silu(_mm(h, W[p + "mlp.w_gate"][i], quantize)) \
        * _mm(h, W[p + "mlp.w_up"][i], quantize)
    return x + _mm(u, W[p + "mlp.w_down"][i], quantize)


def loss(W, tokens, labels, model: dict, quantize: bool = False):
    """Mean next-token cross-entropy over ``tokens`` (B, S)."""
    x = W["embed"][tokens]
    for i in range(model["num_hidden_layers"]):
        x = checkpoint(layer, x, W, i, model, quantize, use_reentrant=False)
    h = rms(x, W["final_norm.scale"][0], model["rms_norm_eps"])
    logits = _mm(h, W["embed"].t(), quantize)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def lr_at(step: int, opt: dict, total: int, warmup: int) -> float:
    """The rate of 0-based ``step``: linear warm-up, then cosine to 0.1."""
    w = min((step + 1) / max(warmup, 1), 1.0)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return opt["lr"] * w * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


def train_readings(W: Dict[str, torch.Tensor], batches: List[dict],
                   model: dict, mix: dict, quantize: bool = False) -> dict:
    """Each step's loss, each leaf's norm of the first step's clipped
    gradient, and each leaf's norm of the change after all the steps.
    ``W`` is updated in place."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt = mix["opt"]
    names = list(W)
    p0 = {n: W[n].detach().clone() for n in names}
    m = {n: torch.zeros_like(W[n]) for n in names}
    v = {n: torch.zeros_like(W[n]) for n in names}
    for t in W.values():
        t.requires_grad_(True)
    losses, first_grad = [], None
    for step, b in enumerate(batches):
        tok = torch.as_tensor(b["tokens"]).to(W["embed"].device).long()
        lab = torch.as_tensor(b["labels"]).to(W["embed"].device).long()
        total = 0.0
        for r in range(tok.shape[0]):
            lr_ = loss(W, tok[r:r + 1], lab[r:r + 1], model, quantize)
            (lr_ / tok.shape[0]).backward()
            total += float(lr_.detach()) / tok.shape[0]
        losses.append(total)
        with torch.no_grad():
            gnorm = math.sqrt(sum(float(W[n].grad.double().pow(2).sum())
                                  for n in names))
            clip = min(1.0, opt["grad_clip"] / max(gnorm, 1e-9))
            t = step + 1
            lr = lr_at(step, opt, mix["total_steps"], mix["warmup_steps"])
            bc1, bc2 = 1 - opt["b1"] ** t, 1 - opt["b2"] ** t
            if first_grad is None:
                first_grad = [float(W[n].grad.norm()) * clip for n in names]
            for n in names:
                g = W[n].grad * clip
                m[n].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                v[n].mul_(opt["b2"]).addcmul_(g, g, value=1 - opt["b2"])
                upd = (m[n] / bc1) / ((v[n] / bc2).sqrt() + opt["eps"]) \
                    + opt["weight_decay"] * W[n]
                W[n].sub_(lr * upd)
                W[n].grad = None
    with torch.no_grad():
        change = [float((W[n] - p0[n]).norm()) for n in names]
    for t in W.values():
        t.requires_grad_(False)
    return {"losses": losses, "grad_norms": first_grad,
            "change_norms": change, "names": names}


def leaf_gaps(got: List[float], want: List[float],
              keep: Optional[List[bool]] = None) -> List[float]:
    """Each kept leaf's gap between two norms, over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    idx = [i for i in range(len(want)) if keep is None or keep[i]]
    med = sorted(want[i] for i in idx)[len(idx) // 2]
    return [abs(got[i] - want[i]) / max(want[i], med, 1e-30) for i in idx]


def moving(grad_norms: List[float]) -> List[bool]:
    """Leaves whose first gradient is more than a thousandth of the median
    leaf's: the others move under Adam by round-off alone."""
    med = sorted(grad_norms)[len(grad_norms) // 2]
    return [g > 1e-3 * med for g in grad_norms]


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers ``correct`` compares: the worst step's relative loss
    gap, the median leaf's first-gradient norm gap (the worst leaf's, the
    query or key projection's as a rule, swings from seed to seed with the
    bfloat16 rounding of the attention's gradient) and the worst moving
    leaf's change norm gap."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                       ref["losses"]))
    grad = sorted(leaf_gaps(prog["grad_norms"], ref["grad_norms"]))
    return {"loss_gap": loss_gap,
            "grad_norm_gap_median_leaf": grad[len(grad) // 2],
            "update_norm_gap": max(leaf_gaps(prog["change_norms"],
                                             ref["change_norms"],
                                             moving(ref["grad_norms"])))}
