"""Sharded layer primitives (explicit Megatron-style tensor parallelism).

The port of ``repro/models/layers.py``.  Every function takes this rank's
tensors.  The ``model`` axis carries tensor parallelism over a
``torch.distributed`` process group (``MeshAxes.model_group``; ``None``
is the default group), and every collective on it goes through the
policy dispatcher.  The ``data`` axis (FSDP gathers, ``dp > 1``) comes
with the training slice: those paths raise ``NotImplementedError``.

The ``tp > 1`` collectives are forward-only here: the dispatcher's
algorithms run over ``torch.distributed`` outside autograd, so a
``tp > 1`` collective on a tensor that needs a gradient raises instead of
returning a gradient that skips the reduction.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..collectives.dispatch import dispatcher
from ..core.context import AxisKind

_TRAIN_SLICE = "ROADMAP A5.5, the training slice"


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Which mesh axes exist for this step and how params are laid out."""
    data: str = "data"
    model: str = "model"
    pod: Optional[str] = None
    fsdp: bool = True          # params sharded over `data` (gathered on use)
    gather_bf16: bool = False  # FSDP gathers on the bf16 wire (halves bytes)
    tp: int = 1                # static size of the model axis
    dp: int = 1                # static size of the data axis (per pod)
    n_pods: int = 1
    # process group of the model axis (None: the default group); the
    # dispatcher's entry points take it as ``group=``
    model_group: Any = dataclasses.field(default=None, compare=False)

    @property
    def world(self) -> int:
        return self.tp * self.dp * self.n_pods


def model_rank(ax: MeshAxes) -> int:
    """This rank's index on the model axis (``lax.axis_index``)."""
    return dist.get_rank(ax.model_group) if ax.tp > 1 else 0


def _forward_only(x: torch.Tensor, what: str) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            f"{what} over tp > 1 is forward-only in the port: gradients "
            f"through the dispatcher's collectives come with {_TRAIN_SLICE}")


# ---------------------------------------------------------------------------
# collectives (policy-dispatched)
# ---------------------------------------------------------------------------

def tp_psum(x, ax: MeshAxes):
    """Row-parallel reduction over the model axis."""
    if ax.tp == 1:
        return x
    _forward_only(x, "tp_psum")
    return dispatcher().all_reduce(x, ax.model, group=ax.model_group,
                                   axis_kind=AxisKind.MODEL)


def tp_all_gather(x, ax: MeshAxes):
    """Tiled all-gather over the model axis along dim 0."""
    _forward_only(x, "the model-axis all-gather")
    return dispatcher().all_gather(x, ax.model, group=ax.model_group,
                                   axis_kind=AxisKind.MODEL)


def tp_psum_max(x, ax: MeshAxes):
    """``lax.pmax`` over the model axis (a stabiliser: never
    differentiated, and not a dispatched collective in the reference)."""
    if ax.tp == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=ax.model_group)
    return y


def fsdp_gather(w, ax: MeshAxes, dim: int):
    """Gather an FSDP-sharded parameter along ``dim`` over the data axis;
    with ``dp == 1`` (or FSDP off) the parameter is whole already."""
    if not ax.fsdp or ax.dp == 1:
        return w
    raise NotImplementedError(
        f"FSDP gathers (dp={ax.dp}) come with {_TRAIN_SLICE}")


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    # y is rounded to x's dtype before the scale multiply, as the
    # reference does (and B3, its kernel)
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * scale.to(dt) + bias.to(dt)


def apply_norm(kind: str, x, p):
    if kind == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, positions):
    """positions: (...,) int -> (..., head_dim//2) f32 angles."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim))
    return positions[..., None].float() * inv


def apply_rope(x, angles):
    """x: (B, S, H, head_dim); angles: (S, hd//2) or (B, S, hd//2).
    Rotates in f32 and casts back once."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    if angles.ndim == 2:          # (S, hd//2)
        angles = angles[None]     # (1, S, hd//2)
    angles = angles[:, :, None, :]  # (B|1, S, 1, hd//2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# linear helpers (TP-aware)
# ---------------------------------------------------------------------------

def col_linear(x, w, ax: MeshAxes, *, bias=None, fsdp_dim: int = 0):
    """Column-parallel: w per-rank (D, out/tp); x replicated in D.  The
    weight is cast to x's dtype on every call (a no-op on weights cast
    once beforehand, see ``convert.compute_params``)."""
    w = fsdp_gather(w, ax, fsdp_dim)
    y = torch.matmul(x, w.to(x.dtype))
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def row_linear(x, w, ax: MeshAxes, *, bias=None, fsdp_dim: int = 1,
               reduce: bool = True):
    """Row-parallel: w per-rank (in/tp, D); all-reduce over model after."""
    w = fsdp_gather(w, ax, fsdp_dim)
    y = torch.matmul(x, w.to(x.dtype))
    if reduce:
        y = tp_psum(y, ax)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# vocab-parallel embedding + distributed cross-entropy
# ---------------------------------------------------------------------------

def vp_embed(ids, emb, ax: MeshAxes, vocab_padded: int):
    """emb per-rank (Vp/tp, D) -> (..., D) via masked lookup + all-reduce."""
    emb = fsdp_gather(emb, ax, 1)
    vloc = vocab_padded // ax.tp if ax.tp > 1 else vocab_padded
    if ax.tp > 1:
        lo = model_rank(ax) * vloc
        local = torch.clamp(ids - lo, 0, vloc - 1)
        hit = (ids >= lo) & (ids < lo + vloc)
        out = emb[local.long()] * hit[..., None].to(emb.dtype)
        return tp_psum(out, ax)
    return emb[ids.long()]


def vp_logits_loss(x, emb_or_head, labels, ax: MeshAxes, vocab: int,
                   vocab_padded: int, *, fsdp_dim: int = 1):
    """Distributed cross-entropy over a vocab-parallel head.

    Never materialises the full (T, V) logits on one rank: the softmax
    normaliser comes from a max and a sum over the model axis.
    x: (..., D); head per-rank (Vp/tp, D); labels (...,) int.
    Returns the mean loss (scalar, f32).
    """
    head = fsdp_gather(emb_or_head, ax, fsdp_dim)
    logits = torch.matmul(x, head.to(x.dtype).t()).float()
    vloc = logits.shape[-1]
    lo = model_rank(ax) * vloc if ax.tp > 1 else 0
    # mask padded vocab entries
    col = lo + torch.arange(vloc, device=logits.device)
    logits = torch.where(col < vocab, logits,
                         torch.full_like(logits, -1e30))

    # stabiliser only, gradient-free (subtracting any constant leaves the
    # softmax loss unchanged)
    m_loc = torch.amax(logits.detach(), dim=-1)
    m = tp_psum_max(m_loc, ax)
    se = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
    se = tp_psum(se, ax)
    lse = torch.log(se) + m

    local_lab = torch.clamp(labels - lo, 0, vloc - 1)
    hit = (labels >= lo) & (labels < lo + vloc)
    lab_logit = torch.gather(logits, -1, local_lab[..., None].long())[..., 0]
    lab_logit = tp_psum(lab_logit * hit.float(), ax)
    return torch.mean(lse - lab_logit)


def vp_logits(x, head, ax: MeshAxes, vocab: int):
    """Full logits (gathered over model), in x's dtype — serving-time only,
    small T."""
    logits = torch.matmul(x, head.to(x.dtype).t())
    if ax.tp > 1:
        logits = tp_all_gather(torch.movedim(logits, -1, 0).contiguous(), ax)
        logits = torch.movedim(logits, 0, -1)
    return logits[..., :vocab]
