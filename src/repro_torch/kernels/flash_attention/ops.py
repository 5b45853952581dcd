"""Public flash-attention op: GQA heads + backend selection.

The port of ``repro/kernels/flash_attention/ops.py``.  Backends:
``"cuda"`` (default) the hand-written kernels, which index the kv heads
themselves (query head ``h`` reads kv head ``h // (H / KV)``, the order
of the reference's ``jnp.repeat(k, rep, axis=1)``), so nothing is
expanded, raising :class:`~repro_torch.device.DeviceError` without a
CUDA device or on tensors elsewhere; ``"torch"`` the plain version and
``"ref"`` the oracle, both on the inputs' device after the reference's
expansion, each head repeated in place (``[k0, k0, k1, k1, ...]``:
``torch.repeat_interleave``).

:func:`flash_attention_train` is the differentiable op training calls:
:class:`FlashAttention` runs the kernel's forward, which also writes each
row's log-sum-exp, and the hand-written backward on CUDA tensors, and
their plain versions on CPU tensors; no S x S tensor is saved for the
backward, and under ``torch.utils.checkpoint`` the recompute reruns the
fused forward.  The forward and the backward are operators of their own
(``torch.ops.repro_torch.flash_attention_fwd`` / ``_bwd``) with a FLOP
formula and a fake version, so ``FlopCounterMode`` on the card and the
dry run's trace on meta tensors count the same attention.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from .._build import on_card
from .kernel import (KERNEL, _compute_dtype, flash_attention_bwd_cuda,
                     flash_attention_bwd_plain, flash_attention_cuda,
                     flash_attention_plain)
from .ref import flash_attention_ref

BACKENDS = ("cuda", "torch", "ref")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    backend: str = "cuda", bq: int = 128, bk: int = 128):
    """q: (B, H, S, d); k/v: (B, KV, T, d) with H % KV == 0."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "cuda":
        on_card("flash_attention", q, k, v)
    B, H, S, d = q.shape
    KV, T = k.shape[1], k.shape[2]
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: the {H} query heads are not a "
                         f"multiple of the {KV} kv heads")
    if backend == "cuda":
        out = flash_attention_cuda(
            q.reshape(B * H, S, d).contiguous(),
            k.reshape(B * KV, T, d).contiguous(),
            v.reshape(B * KV, T, d).contiguous(), group=H // KV,
            causal=causal, window=window, bq=bq, bk=bk)
        return out.reshape(B, H, S, d)
    if H != KV:
        k = torch.repeat_interleave(k, H // KV, dim=1)
        v = torch.repeat_interleave(v, H // KV, dim=1)
    if backend == "ref":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    out = flash_attention_plain(
        q.reshape(B * H, S, d).contiguous(),
        k.reshape(B * H, T, d).contiguous(),
        v.reshape(B * H, T, d).contiguous(), causal=causal, window=window,
        bq=bq, bk=bk)
    return out.reshape(B, H, S, d)


def _plain_bk(T: int) -> int:
    """The plain forward's kv tile: the widest of 128, 64, 32, 16 keys
    that divides T, else T."""
    return next((b for b in (128, 64, 32, 16) if T % b == 0), T)


# B5's training forward and backward as operators of their own, so that a
# dispatch mode sees each call as one op: its FLOP formula below is what
# ``torch.utils.flop_counter`` (and so the dry run's roofline trace)
# counts for it, and its fake version gives meta tensors the output
# shapes.  The count is the products ``_sdpa`` computes for the same
# attention, every key included: the forward's S T (d + dv) pairs of
# Q K^T and P V, the backward's four products, so that a step counts the
# same FLOPs whichever route its attention takes (the kernels skip the
# tiles the mask closes and do less).

@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  group: int, causal: bool, window: int,
                  scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(output, each row's log-sum-exp): the kernel on CUDA tensors, the
    plain version elsewhere.  Operands as :class:`FlashAttention`'s."""
    if q.is_cuda:
        n = KERNEL.launches
        out = flash_attention_cuda(
            q, k, v, group=group, causal=causal, window=window, scale=scale,
            bq=q.shape[1], bk=k.shape[1], with_lse=True)
        FlashAttention.launches += KERNEL.launches - n
        return out
    kx, vx = (t.repeat_interleave(group, dim=0) for t in (k, v))
    return flash_attention_plain(
        q, kx, vx, causal=causal, window=window, scale=scale, bq=q.shape[1],
        bk=_plain_bk(k.shape[1]), with_lse=True)


@attention_fwd.register_fake
def _(q, k, v, group, causal, window, scale):
    BH, S, _ = q.shape
    return (q.new_empty((BH, S, v.shape[-1])),
            q.new_empty((BH, S), dtype=_compute_dtype(q)))


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                  group: int, causal: bool, window: int, scale: float
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): the backward kernels on CUDA tensors, the plain
    version elsewhere."""
    kw = dict(group=group, causal=causal, window=window, scale=scale)
    if q.is_cuda:
        n = KERNEL.launches
        grads = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
        FlashAttention.launches += KERNEL.launches - n
        return grads
    return flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)


@attention_bwd.register_fake
def _(q, k, v, o, do, lse, group, causal, window, scale):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _dense_flops(q, k, v) -> int:
    """2 (d + dv) FLOPs for each of the BH S T query-key pairs: Q K^T and
    P V over every key.  Shapes as the ops take them."""
    return 2 * q[0] * q[1] * k[1] * (q[2] + v[2])


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _fwd_flops(q, k, v, *_, out_shape=None) -> int:
    return _dense_flops(q, k, v)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_flops(q, k, v, *_, out_shape=None) -> int:
    # dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q
    return 2 * _dense_flops(q, k, v)


class FlashAttention(torch.autograd.Function):
    """Attention with B5's forward and backward (the two operators above).
    q: (BH, S, d); k: (BH / group, T, d), v: (BH / group, T, dv),
    contiguous.  Saves q, k, v, the output and the (BH, S) log-sum-exp.
    ``launches`` counts the kernel launches it made (the forward's one, or
    two split-KV; the backward's two)."""

    launches = 0

    @staticmethod
    def forward(ctx, q, k, v, group: int, causal: bool, window: int,
                scale: float):
        o, lse = attention_fwd(q, k, v, group, causal, window, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (group, causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        grads = attention_bwd(q, k, v, o, do.contiguous(), lse, *ctx.args)
        return (*grads, None, None, None, None)


def flash_attention_train(q, k, v, *, causal: bool = True, window: int = 0,
                          scale=None):
    """q: (B, H, S, d); k: (B, KV, T, d), v: (B, KV, T, dv) with H % KV ==
    0, query head ``h`` reading kv head ``h // (H / KV)``.  Returns (B, H,
    S, dv), differentiable in q, k and v (:class:`FlashAttention`)."""
    B, H, S, d = q.shape
    KV, T, dv = k.shape[1], k.shape[2], v.shape[-1]
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: the {H} query heads are not a "
                         f"multiple of the {KV} kv heads")
    scale = scale if scale is not None else d ** -0.5
    out = FlashAttention.apply(
        q.reshape(B * H, S, d).contiguous(),
        k.reshape(B * KV, T, d).contiguous(),
        v.reshape(B * KV, T, dv).contiguous(), H // KV, causal, window,
        float(scale))
    return out.reshape(B, H, S, dv)
