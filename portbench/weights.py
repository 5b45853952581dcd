"""A model's weights made from the seed, on the card, in one generator's
order: the harness fills the trainer's parameters with them, and the
reference makes the same ones again after the window.

``plan(model)`` lists the leaves in the port's parameter tree order (dict
keys sorted, layers stacked on a leading axis) with their shapes: every
matrix normal with std ``initializer_range``, every norm scale 1.
"""

from __future__ import annotations

import hashlib
from typing import List, Tuple


def plan(model: dict) -> List[Tuple[str, tuple, str]]:
    """(path, shape, kind) of every leaf; kind ``normal`` or ``ones``."""
    L = model["num_hidden_layers"]
    D = model["hidden_size"]
    H, KV = model["num_attention_heads"], model["num_key_value_heads"]
    hd = model["head_dim"]
    F = model["intermediate_size"]
    V = model["vocab_size"]
    if not model["tie_word_embeddings"]:
        raise ValueError("plan() covers tied embeddings only")
    return [("blocks.0.attn.k_norm", (L, hd), "ones"),
            ("blocks.0.attn.q_norm", (L, hd), "ones"),
            ("blocks.0.attn.wk", (L, D, KV * hd), "normal"),
            ("blocks.0.attn.wo", (L, H * hd, D), "normal"),
            ("blocks.0.attn.wq", (L, D, H * hd), "normal"),
            ("blocks.0.attn.wv", (L, D, KV * hd), "normal"),
            ("blocks.0.ln1.scale", (L, D), "ones"),
            ("blocks.0.ln2.scale", (L, D), "ones"),
            ("blocks.0.mlp.w_down", (L, F, D), "normal"),
            ("blocks.0.mlp.w_gate", (L, D, F), "normal"),
            ("blocks.0.mlp.w_up", (L, D, F), "normal"),
            ("embed", (V, D), "normal"),
            ("final_norm.scale", (1, D), "ones")]


def weight_seed(seed: int) -> int:
    h = hashlib.sha256(f"weights:{seed}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def generate(model: dict, seed: int, device):
    """Each leaf's initial values, ``(path, float32 tensor)`` in plan
    order, made one at a time by one generator on ``device``."""
    import torch
    g = torch.Generator(device=device).manual_seed(weight_seed(seed))
    std = float(model["initializer_range"])
    for path, shape, kind in plan(model):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        if kind == "ones":
            t.fill_(1.0)
        else:
            t.normal_(0.0, std, generator=g)
        yield path, t


def fill(tensors, model: dict, seed: int, device) -> None:
    """Copy the weights into ``tensors`` (the trainer's leaves, in plan
    order)."""
    import torch
    with torch.no_grad():
        for t, (path, w) in zip(tensors, generate(model, seed, device)):
            if t.shape != w.shape:
                raise ValueError(f"{path}: {tuple(t.shape)} against the "
                                 f"plan's {tuple(w.shape)}")
            t.copy_(w)


def make(model: dict, seed: int, device) -> dict:
    """The weights as ``{path: tensor}``, float32 on ``device``."""
    return dict(generate(model, seed, device))
