"""Sharded layer primitives (explicit Megatron-style SPMD).

The port of ``repro/models/layers.py``.  Every function takes this rank's
tensors.  The ``model`` axis carries tensor parallelism, the ``data``
axis batch + FSDP parameter sharding, the optional ``pod`` axis cross-pod
data parallelism; each runs over a ``torch.distributed`` process group
(``MeshAxes.model_group``, ``data_group``, ``pod_group``; ``None`` is the
default group), and every collective on them goes through the policy
dispatcher.

Gradients.  Each collective is a ``torch.autograd.Function`` whose
backward is the reference's transpose, issued through the dispatcher on
the same axis: an all-reduce's cotangent is all-reduced, an all-gather's
reduce-scattered, an all-to-all's sent back by another all-to-all.  Under
that rule the cotangent of an activation replicated over the model axis
is held in parts, one per rank, summing to the whole.  So the loss,
replicated over the model axis, is seeded with ``1/tp`` on every rank
(``train/step.py``), and the gradient of a parameter replicated over the
model axis is the sum over the axis, which ``sync_grads`` takes.  The
reference seeds 1 on every rank and so returns ``tp`` times these
gradients (ROADMAP C8).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..collectives.dispatch import dispatcher
from ..core.context import AxisKind


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
    # process groups of the axes (None: the default group); the
    # dispatcher's entry points take them as ``group=``
    model_group: Any = dataclasses.field(default=None, compare=False)
    data_group: Any = dataclasses.field(default=None, compare=False)
    pod_group: Any = dataclasses.field(default=None, compare=False)

    @property
    def world(self) -> int:
        return self.tp * self.dp * self.n_pods


def model_rank(ax: MeshAxes) -> int:
    """This rank's index on the model axis (``lax.axis_index``)."""
    return dist.get_rank(ax.model_group) if ax.tp > 1 else 0


def data_rank(ax: MeshAxes) -> int:
    """This rank's index on the data axis."""
    return dist.get_rank(ax.data_group) if ax.dp > 1 else 0


def pod_rank(ax: MeshAxes) -> int:
    """This rank's index on the pod axis."""
    return dist.get_rank(ax.pod_group) if ax.n_pods > 1 else 0


# ---------------------------------------------------------------------------
# collectives (policy-dispatched, differentiable)
# ---------------------------------------------------------------------------

_TRANSPOSE = {"all_reduce": "all_reduce", "all_gather": "reduce_scatter",
              "reduce_scatter": "all_gather", "all_to_all": "all_to_all"}


class _Collective(torch.autograd.Function):
    """``dispatcher().<op>`` over one axis; backward runs the op's
    transpose (``_TRANSPOSE``) through the dispatcher on the same axis."""

    @staticmethod
    def forward(ctx, x, op: str, axis: str, group, kind: int):
        ctx.args = (op, axis, group, kind)
        return getattr(dispatcher(), op)(x, axis, group=group,
                                         axis_kind=kind)

    @staticmethod
    def backward(ctx, ct):
        op, axis, group, kind = ctx.args
        g = getattr(dispatcher(), _TRANSPOSE[op])(
            ct.contiguous(), axis, group=group, axis_kind=kind)
        return g, None, None, None, None


def _collective(x, op: str, axis: str, group, kind: int):
    return _Collective.apply(x, op, axis, group, kind)


class _PsumTape(threading.local):
    """The ``save_psum`` remat policy: inside a checkpointed period the
    forward records each ``tp_psum`` output and the recompute replays
    them in order, so the recompute issues no model-axis collective
    (``jax.checkpoint_policies.save_only_these_names("tp_psum")``)."""
    mode: Optional[str] = None
    outs: Optional[list] = None


_TAPE = _PsumTape()


class _Replay(torch.autograd.Function):
    """A recorded ``tp_psum`` output standing in for the collective in a
    recompute; its backward is the collective's (an all-reduce)."""

    @staticmethod
    def forward(ctx, x, out, ax):
        ctx.ax = ax
        return out.clone()

    @staticmethod
    def backward(ctx, ct):
        ax = ctx.ax
        g = dispatcher().all_reduce(ct.contiguous(), ax.model,
                                    group=ax.model_group,
                                    axis_kind=AxisKind.MODEL)
        return g, None, None


def tp_psum(x, ax: MeshAxes):
    """Row-parallel reduction over the model axis.  Under the
    ``save_psum`` remat policy the result is kept for the recompute."""
    if ax.tp == 1:
        return x
    if _TAPE.mode == "replay":
        return _Replay.apply(x, _TAPE.outs.pop(0), ax)
    out = _collective(x, "all_reduce", ax.model, ax.model_group,
                      AxisKind.MODEL)
    if _TAPE.mode == "record":
        _TAPE.outs.append(out.detach())
    return out


class _TapeMode:
    def __init__(self, mode: str, outs: list):
        self.mode, self.outs = mode, outs

    def __enter__(self):
        self.saved = (_TAPE.mode, _TAPE.outs)
        _TAPE.mode, _TAPE.outs = self.mode, self.outs

    def __exit__(self, *exc):
        _TAPE.mode, _TAPE.outs = self.saved


def save_psum_contexts():
    """``context_fn`` for ``torch.utils.checkpoint.checkpoint``: a fresh
    tape, recorded by the forward and replayed by the recompute."""
    outs: list = []
    return _TapeMode("record", outs), _TapeMode("replay", outs)


def tp_all_gather(x, ax: MeshAxes):
    """Tiled all-gather over the model axis along dim 0."""
    return _collective(x, "all_gather", ax.model, ax.model_group,
                       AxisKind.MODEL)


def tp_all_to_all(x, ax: MeshAxes):
    """Tiled all-to-all over the model axis along dim 0 (the MoE
    dispatch); its own transpose."""
    return _collective(x, "all_to_all", ax.model, ax.model_group,
                       AxisKind.EXPERT)


def tp_psum_max(x, ax: MeshAxes):
    """``lax.pmax`` over the model axis (a stabiliser: never
    differentiated, and not a dispatched collective in the reference)."""
    if ax.tp == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=ax.model_group)
    return y


class _AgBf16Wire(torch.autograd.Function):
    """All-gather on a guaranteed 16-bit wire: the f32 shard is rounded
    to bf16 and gathered over the data axis; the backward reduce-scatters
    the bf16 cotangent and widens it to f32.  The reference bitcasts the
    bf16 to u16 for the gather, to keep XLA's float normalisation from
    widening the wire; torch rewrites nothing, and ``gloo`` has no 16-bit
    integer collectives, so the port gathers the bf16 tensor itself: the
    same bytes and the same decision (2-byte elements)."""

    @staticmethod
    def forward(ctx, w, ax):
        ctx.ax = ax
        return dispatcher().all_gather(w.to(torch.bfloat16), ax.data,
                                       group=ax.data_group,
                                       axis_kind=AxisKind.DATA)

    @staticmethod
    def backward(ctx, ct):
        ax = ctx.ax
        g = dispatcher().reduce_scatter(ct.to(torch.bfloat16).contiguous(),
                                        ax.data, group=ax.data_group,
                                        axis_kind=AxisKind.DATA)
        return g.float(), None


def fsdp_gather(w, ax: MeshAxes, dim: int):
    """Gather an FSDP-sharded parameter along ``dim`` over the data axis.

    The backward reduce-scatters the gradient back to the shards
    (ZeRO-3).  With ``ax.gather_bf16`` the gather rides a bf16 wire (half
    the bytes)."""
    if not ax.fsdp or ax.dp == 1:
        return w
    if dim != 0:
        w = torch.movedim(w, dim, 0)
    w = w.contiguous()
    if ax.gather_bf16 and w.dtype == torch.float32:
        w = _AgBf16Wire.apply(w, ax)
    else:
        w = _collective(w, "all_gather", ax.data, ax.data_group,
                        AxisKind.DATA)
    if dim != 0:
        w = torch.movedim(w, 0, dim)
    return w


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
