"""Model assembly: init, forward, loss, prefill, decode — all families.

The port of ``repro/models/transformer.py``.  Layer stacks are grouped by
a *period* of block kinds (e.g. RG-LRU's (rec, rec, attn)); parameters
are stacked (n_periods, ...) per position-in-period, as in the reference,
and the stack is a loop over the periods plus the unrolled tail.  With
``cfg.remat`` each period runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` of its scan step).

Parameters are the global logical tensors at ``tp == 1`` (or this rank's
slices of them, cut by the specs); ``init_params`` also returns the spec
tree: for each leaf a tuple naming the mesh axis each dimension is split
over (``None``: not split).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint, noop_context_fn

from ..device import resolve_device
from . import attention as att
from . import recurrent as rec
from .config import ModelConfig
from .layers import (MeshAxes, apply_norm, save_psum_contexts, vp_embed,
                     vp_logits, vp_logits_loss)
from .mlp import mlp_block
from .moe import moe_block


def tree_map(fn, tree):
    """``fn`` on every tensor leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_flatten(tree):
    """(leaves, rebuild) in ``jax.tree.flatten``'s order: dict keys
    sorted, lists and tuples in order; ``rebuild(leaves)`` puts a list of
    the same length back into the tree's structure."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            keys = sorted(t)
            subs = [walk(t[k]) for k in keys]
            return lambda it: {k: s(it) for k, s in zip(keys, subs)}
        if isinstance(t, (list, tuple)):
            subs = [walk(v) for v in t]
            kind = type(t)
            return lambda it: kind(s(it) for s in subs)
        leaves.append(t)
        return lambda it: next(it)

    build = walk(tree)
    return leaves, lambda new: build(iter(new))


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def _layer(tree, i: int):
    return tree_map(lambda a: a[i], tree)


# ===========================================================================
# init
# ===========================================================================

class _Init:
    """Draws the initial tensors from one generator, on one device."""

    def __init__(self, gen: torch.Generator, device: torch.device):
        self.gen, self.device = gen, device

    def normal(self, shape, scale: float):
        return torch.randn(shape, generator=self.gen,
                           device=self.device) * scale

    def dense(self, shape, scale: Optional[float] = None):
        return self.normal(shape, scale or (1.0 / math.sqrt(shape[-2])))

    def uniform(self, shape, lo: float, hi: float):
        return torch.rand(shape, generator=self.gen,
                          device=self.device) * (hi - lo) + lo

    def zeros(self, shape):
        return torch.zeros(shape, device=self.device)

    def full(self, shape, value: float):
        return torch.full(shape, value, device=self.device)


def _norm_params(init: _Init, cfg, n, with_bias=None):
    wb = cfg.norm == "layernorm" if with_bias is None else with_bias
    p = {"scale": init.full((n, cfg.d_model), 1.0)}
    if wb:
        p["bias"] = init.zeros((n, cfg.d_model))
    return p, {"scale": (None, None), **({"bias": (None, None)} if wb else {})}


def _attn_params(init: _Init, cfg: ModelConfig, ax: MeshAxes, n: int,
                 *, cross: bool = False):
    hp = cfg.padded_heads(ax.tp)
    hd = cfg.hd
    kvw = cfg.n_kv_heads * hd
    qdim = hp * hd
    p = {
        "wq": init.dense((n, cfg.d_model, qdim)),
        "wk": init.dense((n, cfg.d_model, kvw)),
        "wv": init.dense((n, cfg.d_model, kvw)),
        "wo": init.dense((n, qdim, cfg.d_model)),
    }
    kv_spec = "model" if (ax.tp > 1 and cfg.n_kv_heads % ax.tp == 0) else None
    s = {
        "wq": (None, "data", "model"),
        "wk": (None, "data", kv_spec),
        "wv": (None, "data", kv_spec),
        "wo": (None, "model", "data"),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = init.zeros((n, qdim))
        p["bk"] = init.zeros((n, kvw))
        p["bv"] = init.zeros((n, kvw))
        s["bq"] = (None, "model")
        s["bk"] = (None, kv_spec)
        s["bv"] = (None, kv_spec)
    if cfg.qk_norm and not cross:
        p["q_norm"] = init.full((n, hd), 1.0)
        p["k_norm"] = init.full((n, hd), 1.0)
        s["q_norm"] = (None, None)
        s["k_norm"] = (None, None)
    return p, s


def _mlp_params(init: _Init, cfg: ModelConfig, n: int,
                *, d_ff: Optional[int] = None):
    F = d_ff or cfg.d_ff
    if cfg.mlp == "swiglu":
        p = {"w_gate": init.dense((n, cfg.d_model, F)),
             "w_up": init.dense((n, cfg.d_model, F)),
             "w_down": init.dense((n, F, cfg.d_model))}
        s = {"w_gate": (None, "data", "model"),
             "w_up": (None, "data", "model"),
             "w_down": (None, "model", "data")}
    else:
        p = {"w_up": init.dense((n, cfg.d_model, F)),
             "b_up": init.zeros((n, F)),
             "w_down": init.dense((n, F, cfg.d_model)),
             "b_down": init.zeros((n, cfg.d_model))}
        s = {"w_up": (None, "data", "model"), "b_up": (None, "model"),
             "w_down": (None, "model", "data"), "b_down": (None, None)}
    return p, s


def _moe_params(init: _Init, cfg: ModelConfig, n: int):
    E, Fe, D = cfg.n_experts, cfg.moe_d_ff, cfg.d_model
    p = {"router": init.dense((n, D, E), scale=0.02),
         "w1": init.dense((n, E, D, Fe)),
         "w3": init.dense((n, E, D, Fe)),
         "w2": init.dense((n, E, Fe, D))}
    s = {"router": (None, None, None),
         "w1": (None, "model", "data", None),
         "w3": (None, "model", "data", None),
         "w2": (None, "model", None, "data")}
    if cfg.n_shared_experts:
        Fs = Fe * cfg.n_shared_experts
        p["shared_w1"] = init.dense((n, D, Fs))
        p["shared_w3"] = init.dense((n, D, Fs))
        p["shared_w2"] = init.dense((n, Fs, D))
        s["shared_w1"] = (None, "data", "model")
        s["shared_w3"] = (None, "data", "model")
        s["shared_w2"] = (None, "model", "data")
    return p, s


def _mlstm_params(init: _Init, cfg: ModelConfig, n: int):
    D, H = cfg.d_model, cfg.n_heads
    inner = 2 * D
    p = {"w_q": init.dense((n, D, inner)),
         "w_k": init.dense((n, D, inner)),
         "w_v": init.dense((n, D, inner)),
         "w_og": init.dense((n, D, inner)),
         "w_down": init.dense((n, inner, D)),
         "w_i": init.dense((n, D, H), scale=0.02),
         "w_f": init.dense((n, D, H), scale=0.02),
         "b_i": init.zeros((n, H)),
         "b_f": init.full((n, H), 3.0)}
    s = {"w_q": (None, "data", None), "w_k": (None, "data", None),
         "w_v": (None, "data", "model"), "w_og": (None, "data", "model"),
         "w_down": (None, "model", "data"),
         "w_i": (None, "data", None), "w_f": (None, "data", None),
         "b_i": (None, None), "b_f": (None, None)}
    return p, s


def _slstm_params(init: _Init, cfg: ModelConfig, n: int):
    D = cfg.d_model
    p = {f"w_{g}": init.dense((n, D, D)) for g in ["z", "i", "f", "o"]}
    s = {f"w_{g}": (None, "data", "model") for g in ["z", "i", "f", "o"]}
    for g in ["z", "i", "f", "o"]:
        p[f"r_{g}"] = init.zeros((n, D))
        s[f"r_{g}"] = (None, "model")
    p["w_down"] = init.dense((n, D, D))
    s["w_down"] = (None, "model", "data")
    return p, s


def _rglru_params(init: _Init, cfg: ModelConfig, n: int):
    D = cfg.d_model
    W = cfg.rglru_width or D
    K = cfg.conv1d_width
    p = {"w_in": init.dense((n, D, 2 * W)),
         "conv_w": init.dense((n, K, W), scale=0.3),
         "conv_b": init.zeros((n, W)),
         "w_a": init.dense((n, D, W), scale=0.02),
         "w_x": init.dense((n, D, W), scale=0.02),
         "lam": init.uniform((n, W), 0.3, 0.8),
         "w_out": init.dense((n, W, D))}
    s = {"w_in": (None, "data", "model"), "conv_w": (None, None, "model"),
         "conv_b": (None, "model"), "w_a": (None, "data", "model"),
         "w_x": (None, "data", "model"), "lam": (None, "model"),
         "w_out": (None, "model", "data")}
    return p, s


def _block_params(init: _Init, kind: str, cfg: ModelConfig, ax: MeshAxes,
                  n: int, *, with_cross: bool = False):
    p, s = {}, {}
    p["ln1"], s["ln1"] = _norm_params(init, cfg, n)
    if kind == "attn":
        p["attn"], s["attn"] = _attn_params(init, cfg, ax, n)
        p["ln2"], s["ln2"] = _norm_params(init, cfg, n)
        if cfg.is_moe:
            p["moe"], s["moe"] = _moe_params(init, cfg, n)
        elif cfg.d_ff:
            p["mlp"], s["mlp"] = _mlp_params(init, cfg, n)
        if with_cross:
            p["xattn"], s["xattn"] = _attn_params(init, cfg, ax, n,
                                                  cross=True)
            p["ln_x"], s["ln_x"] = _norm_params(init, cfg, n)
    elif kind == "mlstm":
        p["mlstm"], s["mlstm"] = _mlstm_params(init, cfg, n)
    elif kind == "slstm":
        p["slstm"], s["slstm"] = _slstm_params(init, cfg, n)
    elif kind == "rglru":
        p["rglru"], s["rglru"] = _rglru_params(init, cfg, n)
        p["ln2"], s["ln2"] = _norm_params(init, cfg, n)
        if cfg.d_ff:
            p["mlp"], s["mlp"] = _mlp_params(init, cfg, n)
    else:
        raise ValueError(kind)
    return p, s


def _period(cfg: ModelConfig) -> Tuple[Tuple[str, ...], int, int]:
    kinds = cfg.block_kinds()
    if cfg.family == "ssm" and cfg.slstm_every:
        plen = cfg.slstm_every
    elif cfg.family == "hybrid" and cfg.rglru_pattern:
        plen = len(cfg.rglru_pattern)
    else:
        plen = 1
    if cfg.nope_every:
        plen = plen * cfg.nope_every // math.gcd(plen, cfg.nope_every)
    plen = min(plen, cfg.n_layers)
    n_full = cfg.n_layers // plen
    rem = cfg.n_layers - n_full * plen
    return kinds, plen, rem


def init_params(key, cfg: ModelConfig, ax: MeshAxes, *, device=None
                ) -> Tuple[Dict, Dict]:
    """Returns (params, specs): f32 global logical tensors with the
    reference's keys, shapes and distributions, drawn from ``key`` (a
    ``torch.Generator`` on ``device``, or an int seed for one), on the
    card unless ``device`` names another."""
    dev = resolve_device(device, "init_params")
    gen = key if isinstance(key, torch.Generator) else \
        torch.Generator(device=dev).manual_seed(int(key))
    init = _Init(gen, dev)
    kinds, plen, rem = _period(cfg)
    n_full = cfg.n_layers // plen

    params: Dict[str, Any] = {}
    specs: Dict[str, Any] = {}

    vp = cfg.padded_vocab(ax.tp)
    params["embed"] = init.normal((vp, cfg.d_model), 0.02)
    specs["embed"] = ("model", "data")
    if not cfg.tie_embeddings:
        params["lm_head"] = init.normal((vp, cfg.d_model), 0.02)
        specs["lm_head"] = ("model", "data")
    params["final_norm"], specs["final_norm"] = _norm_params(init, cfg, 1)

    with_cross = cfg.family == "audio"
    params["blocks"], specs["blocks"] = [], []
    for j in range(plen):
        p, s = _block_params(init, kinds[j], cfg, ax, n_full,
                             with_cross=with_cross)
        params["blocks"].append(p)
        specs["blocks"].append(s)
    params["tail"], specs["tail"] = [], []
    for j in range(rem):
        p, s = _block_params(init, kinds[n_full * plen + j], cfg, ax, 1,
                             with_cross=with_cross)
        params["tail"].append(p)
        specs["tail"].append(s)

    if cfg.family == "audio":
        enc_cfg = dataclasses.replace(cfg, qk_norm=False, qkv_bias=False,
                                      n_experts=0)
        p, s = _block_params(init, "attn", enc_cfg, ax, cfg.n_enc_layers)
        params["enc_blocks"], specs["enc_blocks"] = p, s
        params["enc_norm"], specs["enc_norm"] = _norm_params(init, cfg, 1)
        params["enc_pos"] = init.zeros((cfg.n_audio_frames, cfg.d_model))
        specs["enc_pos"] = (None, None)

    if cfg.family == "vlm":
        params["proj"] = init.normal((cfg.d_model, cfg.d_model), 0.02)
        specs["proj"] = (None, None)

    if not ax.fsdp:
        specs = _without_data(specs)
    return params, specs


def _without_data(specs):
    """The spec tree with the ``data`` axis dropped (FSDP off)."""
    if isinstance(specs, dict):
        return {k: _without_data(v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_without_data(v) for v in specs]
    return tuple(None if a == "data" else a for a in specs)


# ===========================================================================
# block application
# ===========================================================================

def _apply_block(p, kind: str, x, cfg: ModelConfig, ax: MeshAxes, *,
                 use_rope: bool = True, causal: bool = True,
                 enc_kv=None, aux_acc=None):
    h = apply_norm(cfg.norm, x, p["ln1"])
    if kind == "attn":
        y = att.attention_train(p["attn"], h, cfg, ax, use_rope=use_rope,
                                causal=causal)
        x = x + y
        if enc_kv is not None:
            hx = apply_norm(cfg.norm, x, p["ln_x"])
            x = x + att.cross_attention(p["xattn"], hx, enc_kv, cfg, ax)
        h2 = apply_norm(cfg.norm, x, p["ln2"])
        if cfg.is_moe:
            y2, aux = moe_block(p["moe"], h2, cfg, ax)
            if aux_acc is not None:
                aux_acc = aux_acc + aux
        elif cfg.d_ff:
            y2 = mlp_block(p["mlp"], h2, cfg, ax)
        else:
            y2 = 0.0
        x = x + y2
    elif kind == "mlstm":
        x = x + rec.mlstm_block(p["mlstm"], h, cfg, ax)
    elif kind == "slstm":
        x = x + rec.slstm_block(p["slstm"], h, cfg, ax)
    elif kind == "rglru":
        x = x + rec.rglru_block(p["rglru"], h, cfg, ax)
        h2 = apply_norm(cfg.norm, x, p["ln2"])
        if cfg.d_ff:
            x = x + mlp_block(p["mlp"], h2, cfg, ax)
    return x, aux_acc


def _use_rope(cfg: ModelConfig, layer_idx: int) -> bool:
    """llama4 iRoPE: every nope_every-th layer skips rope; whisper uses
    learned absolute positions, never rope."""
    if cfg.family == "audio":
        return False
    if cfg.nope_every and (layer_idx + 1) % cfg.nope_every == 0:
        return False
    return True


def _stack_forward(params, x, cfg: ModelConfig, ax: MeshAxes, *,
                   causal: bool = True, enc_kv=None):
    """Run the period-grouped stack.  Returns (x, aux_loss)."""
    kinds, plen, rem = _period(cfg)
    n_full = cfg.n_layers // plen
    aux = torch.zeros((), device=x.device)

    def period(x, aux, i: int):
        for j in range(plen):
            x, aux = _apply_block(_layer(params["blocks"][j], i), kinds[j],
                                  x, cfg, ax, use_rope=_use_rope(cfg, j),
                                  causal=causal, enc_kv=enc_kv, aux_acc=aux)
        return x, aux

    # remat: each period's activations are recomputed in the backward;
    # under "save_psum" the recompute replays the period's tp_psum outputs
    # instead of issuing the collectives again (layers.save_psum_contexts)
    remat = cfg.remat and torch.is_grad_enabled()
    ctx_fn = save_psum_contexts if cfg.remat_policy == "save_psum" \
        else noop_context_fn
    for i in range(n_full):
        if remat:
            x, aux = checkpoint(period, x, aux, i, use_reentrant=False,
                                context_fn=ctx_fn, preserve_rng_state=False)
        else:
            x, aux = period(x, aux, i)
    for j, p in enumerate(params["tail"]):
        li = n_full * plen + j
        x, aux = _apply_block(_layer(p, 0), kinds[li], x, cfg, ax,
                              use_rope=_use_rope(cfg, li),
                              causal=causal, enc_kv=enc_kv, aux_acc=aux)
    return x, aux


def _encode_audio(params, frames, cfg: ModelConfig, ax: MeshAxes):
    """frames: (B, T, D) stub conv-frontend output."""
    x = frames + params["enc_pos"][None, :frames.shape[1]].to(frames.dtype)
    enc_cfg = dataclasses.replace(cfg, n_experts=0, qk_norm=False,
                                  qkv_bias=False, attention="full")
    for i in range(cfg.n_enc_layers):
        x, _ = _apply_block(_layer(params["enc_blocks"], i), "attn", x,
                            enc_cfg, ax, use_rope=False, causal=False)
    return apply_norm(cfg.norm, x, _layer(params["enc_norm"], 0))


def embed_tokens(params, tokens, cfg: ModelConfig, ax: MeshAxes, dtype):
    vp = cfg.padded_vocab(ax.tp)
    x = vp_embed(tokens, params["embed"], ax, vp).to(dtype)
    return x * (cfg.d_model ** 0.5) if cfg.family == "hybrid" else x


def forward_hidden(params, batch, cfg: ModelConfig, ax: MeshAxes):
    """batch: dict with 'tokens' (B,S) [+ 'frames' | 'patches'].
    Returns (hidden (B,S',D), aux)."""
    dtype = cfg.torch_dtype
    x = embed_tokens(params, batch["tokens"], cfg, ax, dtype)

    enc_out = None
    if cfg.family == "audio":
        enc_out = _encode_audio(params, batch["frames"].to(dtype), cfg, ax)
    if cfg.family == "vlm" and "patches" in batch:
        proj = params["proj"].to(dtype)
        pat = batch["patches"].to(dtype) @ proj
        x = torch.cat([pat, x], dim=1)

    x, aux = _stack_forward_dispatch(params, x, cfg, ax, enc_out=enc_out)
    return apply_norm(cfg.norm, x, _layer(params["final_norm"], 0)), aux


def _stack_forward_dispatch(params, x, cfg, ax, *, enc_out=None):
    if cfg.family == "audio":
        # per-layer cross-attention: K/V from the shared encoder output
        # with each decoder layer's own projections
        aux = torch.zeros((), device=x.device)
        for i in range(cfg.n_layers):
            p = _layer(params["blocks"][0], i)
            kv = att.encode_kv(p["xattn"], enc_out, cfg, ax)
            x, aux = _apply_block(p, "attn", x, cfg, ax, enc_kv=kv,
                                  use_rope=False, aux_acc=aux)
        return x, aux
    return _stack_forward(params, x, cfg, ax)


def _head(params):
    return params.get("lm_head", params["embed"])


def forward_logits(params, batch, cfg: ModelConfig, ax: MeshAxes):
    h, aux = forward_hidden(params, batch, cfg, ax)
    return vp_logits(h, _head(params), ax, cfg.vocab), aux


def loss_fn(params, batch, cfg: ModelConfig, ax: MeshAxes):
    """Mean next-token CE (+ MoE aux).  batch['labels'] aligned to tokens."""
    h, aux = forward_hidden(params, batch, cfg, ax)
    labels = batch["labels"]
    if h.shape[1] != labels.shape[1]:      # vlm: drop patch positions
        h = h[:, -labels.shape[1]:]
    vpad = cfg.padded_vocab(ax.tp)
    ce = vp_logits_loss(h, _head(params), labels, ax, cfg.vocab, vpad)
    return ce + aux


# ===========================================================================
# serving: prefill + decode
# ===========================================================================

def init_caches(params, cfg: ModelConfig, B: int, ctx: int, ax: MeshAxes):
    """Per-layer decode state, on the device of ``params``."""
    dev = params["embed"].device
    caches = []
    for k in cfg.block_kinds():
        if k == "attn":
            caches.append(att.init_cache(cfg, B, ctx, ax, cfg.torch_dtype,
                                         dev))
        elif k == "mlstm":
            caches.append(rec.mlstm_init_state(cfg, B, ax, dev))
        elif k == "slstm":
            caches.append(rec.slstm_init_state(cfg, B, ax, dev))
        elif k == "rglru":
            caches.append(rec.rglru_init_state(cfg, B, ax, dev))
    return caches


def _decode_logits(params, token, caches, pos, cfg: ModelConfig,
                   ax: MeshAxes, *, enc_out=None):
    """The decode step up to its logits: (logits (B,1,V), new_caches)."""
    dtype = cfg.torch_dtype
    kinds, plen, rem = _period(cfg)
    n_full = cfg.n_layers // plen
    x = embed_tokens(params, token, cfg, ax, dtype)

    new_caches = []
    for li in range(cfg.n_layers):
        kind = kinds[li]
        if li < n_full * plen:
            grp, pos_in = divmod(li, plen)
            p = _layer(params["blocks"][pos_in], grp)
        else:
            p = _layer(params["tail"][li - n_full * plen], 0)
        c = caches[li]
        h = apply_norm(cfg.norm, x, p["ln1"])
        if kind == "attn":
            y, c = att.attention_decode(p["attn"], h, c, cfg, ax, pos,
                                        use_rope=_use_rope(cfg, li))
            x = x + y
            if cfg.family == "audio" and enc_out is not None:
                hx = apply_norm(cfg.norm, x, p["ln_x"])
                kv = att.encode_kv(p["xattn"], enc_out, cfg, ax)
                x = x + att.cross_attention(p["xattn"], hx, kv, cfg, ax)
            h2 = apply_norm(cfg.norm, x, p["ln2"])
            if cfg.is_moe:
                y2, _ = moe_block(p["moe"], h2, cfg, ax)
            elif cfg.d_ff:
                y2 = mlp_block(p["mlp"], h2, cfg, ax)
            else:
                y2 = 0.0
            x = x + y2
        elif kind == "mlstm":
            y, c = rec.mlstm_decode(p["mlstm"], h, c, cfg, ax)
            x = x + y
        elif kind == "slstm":
            y, c = rec.slstm_block(p["slstm"], h, cfg, ax, state=c,
                                   return_state=True)
            x = x + y
        elif kind == "rglru":
            y, c = rec.rglru_block(p["rglru"], h, cfg, ax, state=c,
                                   return_state=True)
            x = x + y
            h2 = apply_norm(cfg.norm, x, p["ln2"])
            if cfg.d_ff:
                x = x + mlp_block(p["mlp"], h2, cfg, ax)
        new_caches.append(c)

    x = apply_norm(cfg.norm, x, _layer(params["final_norm"], 0))
    return vp_logits(x, _head(params), ax, cfg.vocab), new_caches


def decode_step(params, token, caches, pos, cfg: ModelConfig, ax: MeshAxes,
                *, enc_out=None):
    """token (B,1) int; pos (B,) absolute positions; caches per layer.
    Returns (next_token (B,1) int32, new_caches); the argmax takes the
    first maximum, as ``jnp.argmax`` does."""
    logits, new_caches = _decode_logits(params, token, caches, pos, cfg, ax,
                                        enc_out=enc_out)
    nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    return nxt, new_caches


def prefill(params, batch, cfg: ModelConfig, ax: MeshAxes):
    """Prefill pass: full forward returning last-position logits."""
    h, _ = forward_hidden(params, batch, cfg, ax)
    return vp_logits(h[:, -1:], _head(params), ax, cfg.vocab)
